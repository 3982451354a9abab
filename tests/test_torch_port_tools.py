"""The port's data tools (simple3dformer_tpu_torch/tools) against the JAX
package's, on the CPU: the mesh voxelizer, the voxel viewer, the fixed-view
renderer, the S3DIS collector and the S3DIS block, sample and export helpers.

Every case writes its own meshes, grids and rooms under ``tmp_path`` from a
seeded ``np.random.RandomState``; each side runs on its own copy where a tool
writes next to its input. The tolerance is bit-equality throughout: the same
arrays, the same file bytes (the renderer: the same decoded pixels), and
where a function draws, the same draws from equal ``RandomState``s. The C++
voxelizer and viewer are built with g++ from each package's own copy of the
source with the same flags.
"""

import os
import shutil
import sys

import numpy as np
import pytest

from simple3dformer_tpu.data import binvox as jbv
from simple3dformer_tpu.tools import collect_s3dis as jcs
from simple3dformer_tpu.tools import indoor3d_blocks as jib
from simple3dformer_tpu.tools import save_render as jsr
from simple3dformer_tpu.tools import view_voxels as jvv
from simple3dformer_tpu.tools import voxelize as jvx
from simple3dformer_tpu_torch.tools import collect_s3dis as pcs
from simple3dformer_tpu_torch.tools import indoor3d_blocks as pib
from simple3dformer_tpu_torch.tools import save_render as psr
from simple3dformer_tpu_torch.tools import view_voxels as pvv
from simple3dformer_tpu_torch.tools import voxelize as pvx

CUBE_VERTS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                       [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
CUBE_TRIS = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                      [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]],
                     np.int32)
OCTA_TRIS = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


@pytest.fixture(scope="module")
def libs():
    """The four libraries built once (the port's build raises if g++ fails)."""
    pvx.build_library()
    jvx.build_library()
    pvv.hollow(np.ones((2, 2, 2), np.uint8))
    jvv.hollow(np.ones((2, 2, 2), np.uint8))


def octahedron(rs):
    """A randomly scaled and rotated octahedron: (verts [6,3] f32, tris)."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float64) * rs.uniform(0.5, 1.5, 3)
    q, _ = np.linalg.qr(rs.randn(3, 3))
    return (verts @ q.T + rs.randn(3)).astype(np.float32), OCTA_TRIS


def off_text(verts, tris, header):
    lines = [header] + [" ".join(f"{v:.6f}" for v in row) for row in verts]
    lines += [f"{len(t)} " + " ".join(map(str, t)) for t in tris]
    return "\n".join(lines) + "\n"


# --- the voxelizer -----------------------------------------------------------


@pytest.mark.parametrize("mesh", ["cube", "octahedron", "triangle"])
@pytest.mark.parametrize("solid", [True, False])
def test_voxelize(libs, mesh, solid):
    rs = np.random.RandomState(21)
    if mesh == "cube":
        verts, tris, dim = CUBE_VERTS * 0.5 + 0.25, CUBE_TRIS, 16
        verts = np.vstack([verts, [[0, 0, 0], [1, 1, 1]]]).astype(np.float32)
    elif mesh == "octahedron":
        (verts, tris), dim = octahedron(rs), 24
    else:
        verts, tris, dim = rs.randn(3, 3).astype(np.float32), np.array([[0, 1, 2]], np.int32), 20
    got = pvx.voxelize(verts, tris, dim=dim, solid=solid)
    same(got, jvx.voxelize(verts, tris, dim=dim, solid=solid))
    assert got.any()


@pytest.mark.parametrize("kind", ["off_malformed_header", "off", "obj"])
def test_mesh_to_binvox(libs, tmp_path, kind):
    """read_off / read_obj, fix_off_header and the written binvox bytes."""
    verts, tris = octahedron(np.random.RandomState(23))
    if kind == "obj":
        text = "\n".join([f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
                         + [f"f {a + 1}/{a + 1} {b + 1}//{b + 1} {c + 1}" for a, b, c in tris])
    else:
        quads = [[0, 2, 1, 3]]  # a quad, fan-triangulated
        header = f"OFF{len(verts)} {len(tris) + 1} 0" if kind == "off_malformed_header" \
            else f"OFF\n{len(verts)} {len(tris) + 1} 0"
        text = off_text(verts, list(tris.tolist()) + quads, header)
        assert pvx.fix_off_header(text) == jvx.fix_off_header(text)
    outs = []
    for side, mod in (("jax", jvx), ("port", pvx)):
        d = tmp_path / side
        d.mkdir()
        mesh = d / f"shape.{'obj' if kind == 'obj' else 'off'}"
        mesh.write_text(text)
        reader = "read_obj" if kind == "obj" else "read_off"
        outs.append((getattr(mod, reader)(str(mesh)), mod.mesh_to_binvox(str(mesh), dim=20)))
    (want_mesh, want), (got_mesh, got) = outs
    for a, b in zip(want_mesh, got_mesh):
        same(b, a)
    assert os.path.basename(got) == "shape.binvox"
    same_files(got, want)
    with open(got, "rb") as f:
        assert jbv.read_as_3d_array(f).data.any()


def test_convert_tree_and_cli(libs, tmp_path, capsys):
    """convert_tree over a ModelNet-style tree with a bad mesh in it, and the
    command line on a single mesh."""
    rs = np.random.RandomState(29)
    src = tmp_path / "src"
    for cls, ext in (("cone", "off"), ("cup", "obj")):
        d = src / cls / "train"
        d.mkdir(parents=True)
        for i in range(2):
            verts, tris = octahedron(rs)
            path = d / f"{cls}_{i:04d}.{ext}"
            if ext == "off":
                path.write_text(off_text(verts, tris.tolist(), f"OFF\n{len(verts)} {len(tris)} 0"))
            else:
                path.write_text("\n".join([f"v {x} {y} {z}" for x, y, z in verts]
                                          + [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris]))
    (src / "cone" / "train" / "cone_0009.off").write_text("OFF\n3 1 0\n0 0 0\n")
    outs = {}
    for side, mod in (("jax", jvx), ("port", pvx)):
        shutil.copytree(src, tmp_path / side)
        outs[side] = sorted(os.path.relpath(p, tmp_path / side)
                            for p in mod.convert_tree(str(tmp_path / side), dim=16))
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 4
    assert capsys.readouterr().out.count("skip ") == 2  # the bad mesh, once a side
    for rel in outs["port"]:
        same_files(tmp_path / "port" / rel, tmp_path / "jax" / rel)
    mesh = tmp_path / "port" / "cone" / "train" / "cone_0000.off"
    pvx.main([str(mesh), "-d", "12", "--surface"])
    assert capsys.readouterr().out.strip() == str(mesh.with_suffix(".binvox"))
    jvx.mesh_to_binvox(str(mesh), out_path=str(tmp_path / "j.binvox"), dim=12, solid=False)
    same_files(mesh.with_suffix(".binvox"), tmp_path / "j.binvox")


# --- the viewer ----------------------------------------------------------------


@pytest.fixture(scope="module")
def grid():
    """A random blob: a solid ball with random voxels around it, 20 x 18 x 16."""
    rs = np.random.RandomState(31)
    x, y, z = np.meshgrid(*(np.arange(n) for n in (20, 18, 16)), indexing="ij")
    ball = (x - 10) ** 2 + (y - 9) ** 2 + (z - 8) ** 2 < 36
    return (ball | (rs.rand(20, 18, 16) < 0.05)).astype(np.uint8)


def test_hollow(libs, grid):
    got = pvv.hollow(grid)
    same(got, jvv.hollow(grid))
    assert 0 < got.sum() < grid.sum()


@pytest.mark.parametrize("kwargs", [
    dict(), dict(perspective=True), dict(perspective=True, dist=3.0, azim=10.0, elev=-30.0),
    dict(alt_colors=True), dict(keep_internal=True),
    dict(slice_axis=2, slice_index=6, neighbours=2, keep_internal=True),
    dict(slice_axis=0, slice_index=9, alt_colors=True),
] + [dict(azim=a, elev=e) for a, e in pvv._AXIS_VIEWS.values()],
    ids=["ortho", "persp", "persp_camera", "alt_colors", "keep_internal", "slice_neighbours",
         "slice_alt"] + [f"view_{v}" for v in pvv._AXIS_VIEWS])
def test_render(libs, grid, kwargs):
    assert pvv._AXIS_VIEWS == jvv._AXIS_VIEWS
    got = pvv.render(grid, width=48, height=40, **kwargs)
    same(got, jvv.render(grid, width=48, height=40, **kwargs))
    assert (got != 255).any(-1).mean() > 0.01  # not blank


def test_render_refuses_a_slice_outside(libs, grid):
    for mod in (jvv, pvv):
        with pytest.raises(ValueError):
            mod.render(grid, slice_axis=2, slice_index=99)


def write_grid(path, g):
    with open(path, "wb") as f:
        jbv.write(jbv.Voxels(g.astype(bool), list(g.shape), [0.0] * 3, 1.0, "xyz"), f)


@pytest.mark.parametrize("argv", [
    ["--view", "z", "--alt-colors"],
    ["--slice", "z:8", "--neighbours", "1", "--ki", "--perspective"],
    ["--azim", "30", "--elev", "10", "--dist", "2.5"],
])
def test_view_voxels_main_writes_ppm(libs, tmp_path, grid, monkeypatch, argv):
    """main on a binvox file, PIL absent (as on the card's machine): the PPM
    bytes of both sides, and the PNG path when PIL is there."""
    model = tmp_path / "blob.binvox"
    write_grid(model, grid)
    size = ["--width", "40", "--height", "32"]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises ImportError
        jvv.main([str(model), "-o", str(tmp_path / "j.ppm"), *size, *argv])
        out = pvv.main([str(model), "-o", str(tmp_path / "p.ppm"), *size, *argv])
    assert out == str(tmp_path / "p.ppm")
    same_files(tmp_path / "p.ppm", tmp_path / "j.ppm")
    with open(out, "rb") as f:
        assert f.read(12) == b"P6\n40 32\n255"
    pytest.importorskip("PIL")
    assert pvv.main([str(model), *size, *argv]) == str(model.with_suffix(".png"))


# --- the fixed-view renderer -------------------------------------------------------


def read_png(path):
    import matplotlib.image

    return matplotlib.image.imread(path)


def test_render_voxels_to_png(tmp_path):
    g = np.random.RandomState(37).rand(12, 12, 12) > 0.8
    for view in (None, dict(elev=30.0, azim=45.0)):
        a = jsr.render_voxels_to_png(g, str(tmp_path / "j" / "a.png"), view)
        b = psr.render_voxels_to_png(g, str(tmp_path / "p" / "a.png"), view)
        same(read_png(b), read_png(a))
    assert read_png(b).shape[:2] == (psr.IMG_SIZE, psr.IMG_SIZE)


def test_generate_fixed_view_rendering(tmp_path):
    """A two-model ShapeNet tree: the port's process pool (2 workers) against
    the JAX package's loop, and a model that cannot be read is skipped."""
    rs = np.random.RandomState(41)
    root = tmp_path / "shapenet"
    for synset, model in (("02691156", "model_a"), ("03001627", "model_b")):
        d = root / synset / model / "models"
        d.mkdir(parents=True)
        write_grid(d / "model_normalized.solid.binvox", rs.rand(10, 10, 10) > 0.7)
    bad = root / "03001627" / "model_c" / "models"
    bad.mkdir(parents=True)
    (bad / "model_normalized.solid.binvox").write_bytes(b"not a binvox")
    want = jsr.generate_fixed_view_rendering(str(root), out_root=str(tmp_path / "j"))
    got = psr.generate_fixed_view_rendering(str(root), out_root=str(tmp_path / "p"), workers=2)
    rel = [os.path.relpath(p, tmp_path / "p") for p in got]
    assert rel == [os.path.relpath(p, tmp_path / "j") for p in want]
    assert rel == [os.path.join("02691156", "model_a.png"), os.path.join("03001627", "model_b.png")]
    for a, b in zip(want, got):
        same(read_png(b), read_png(a))


# --- S3DIS ---------------------------------------------------------------------------


def write_annotations(root, rs):
    """Area_1/<room>/Annotations with a chair, a wall and the 'staris' typo."""
    for room in ("office_1", "hallway_2"):
        anno = root / "Area_1" / room / "Annotations"
        anno.mkdir(parents=True)
        for name in ("chair_1.txt", "wall_3.txt", "staris_1.txt"):
            pts = np.hstack([rs.rand(20, 3) * 5 + 1, rs.randint(0, 255, (20, 3))])
            np.savetxt(anno / name, pts)


@pytest.mark.parametrize("file_format", ["numpy", "txt"])
def test_collect_s3dis(tmp_path, file_format):
    write_annotations(tmp_path, np.random.RandomState(43))
    anno = str(tmp_path / "Area_1" / "office_1" / "Annotations")
    ext = ".npy" if file_format == "numpy" else ".txt"
    want = jcs.collect_point_label(anno, str(tmp_path / f"j{ext}"), file_format)
    got = pcs.collect_point_label(anno, str(tmp_path / f"p{ext}"), file_format)
    same(got, want)
    same_files(tmp_path / f"p{ext}", tmp_path / f"j{ext}")
    assert set(got[:, 6].astype(int)) == {8, 2, 12}  # chair, wall, staris -> clutter
    outs = [m.collect_dataset(str(tmp_path), str(tmp_path / side))
            for side, m in (("jo", jcs), ("po", pcs))]
    assert [os.path.basename(p) for p in outs[1]] == [os.path.basename(p) for p in outs[0]] \
        == ["Area_1_hallway_2.npy", "Area_1_office_1.npy"]
    for a, b in zip(*outs):
        same_files(b, a)


def fake_room(rs, n=2000, extent=(3.0, 2.5, 2.0)):
    """[N,7] XYZRGBL with the minimum corner at the origin (the collector's output)."""
    xyz = rs.rand(n, 3) * np.asarray(extent)
    xyz -= xyz.min(0)
    rgb = rs.randint(0, 256, size=(n, 3)).astype(float)
    lab = rs.randint(0, 13, size=(n, 1)).astype(float)
    return np.concatenate([xyz, rgb, lab], axis=1)


def sampler_call(mod, name, path, room, rng):
    if name == "blocks_wrapper_normalized":
        return mod.room2blocks_wrapper_normalized(path, 64, block_size=1.0, stride=0.5, rng=rng)
    if name == "blocks_wrapper_normalized_random":
        return mod.room2blocks_wrapper_normalized(path, 64, random_sample=True, sample_aug=2,
                                                  rng=rng)
    if name == "samples_wrapper_normalized":
        return mod.room2samples_wrapper_normalized(path, 300, rng=rng)
    if name == "blocks_plus_random":
        return mod.room2blocks_plus(room, 128, 1.0, 1.0, True, None, 1, rng=rng)
    return mod.room2blocks_wrapper(path, 256, block_size=1.5, stride=1.0, rng=rng)


@pytest.mark.parametrize("name", ["blocks_wrapper_normalized", "blocks_wrapper_normalized_random",
                                  "samples_wrapper_normalized", "blocks_plus_random",
                                  "blocks_wrapper"])
@pytest.mark.parametrize("rng", ["RandomState", "global"])
def test_indoor3d_samplers(tmp_path, name, rng):
    """Equal RandomStates (or the global state seeded alike) give equal arrays."""
    room = fake_room(np.random.RandomState(47))
    path = str(tmp_path / "room.npy")
    np.save(path, room)
    out = []
    for mod in (jib, pib):
        if rng == "global":
            np.random.seed(53)
        out.append(sampler_call(mod, name, path, room.copy(),
                                np.random.RandomState(53) if rng == "RandomState" else None))
    for a, b in zip(*out):
        same(b, a)
    assert out[1][0].shape[0] > 0


def test_indoor3d_exporters(tmp_path):
    """The OBJ and bounding-box exporters: the same file bytes and arrays."""
    rs = np.random.RandomState(59)
    room = fake_room(rs, n=300)
    np.savetxt(tmp_path / "room.txt", room)
    write_annotations(tmp_path, rs)
    anno = str(tmp_path / "Area_1" / "office_1" / "Annotations")
    for side, mod in (("j", jib), ("p", pib)):
        d = tmp_path / side
        d.mkdir()
        mod.data_to_obj(room, name=str(d / "room.obj"), no_wall=True)
        for i, kw in enumerate((dict(), dict(label_color=False), dict(easy_view=True),
                                dict(no_wall=True))):
            mod.point_label_to_obj(str(tmp_path / "room.txt"), str(d / f"label{i}.obj"), **kw)
        mod.collect_bounding_box(anno, str(d / "bbox.txt"))
        for fmt, ext in (("txt", ".txt"), ("numpy", ".npy")):
            mod.collect_point_bounding_box(anno, str(d / f"point_bbox{ext}"), fmt)
        for easy in (False, True):
            mod.bbox_label_to_obj(str(d / "bbox.txt"), str(d / f"box{int(easy)}"), easy_view=easy)
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) > 12
    for name in names:
        same_files(tmp_path / "p" / name, tmp_path / "j" / name)
    assert pib.CLASS2COLOR == jib.CLASS2COLOR and pib.LABEL2COLOR == jib.LABEL2COLOR
    assert pib.EASY_VIEW_LABELS == jib.EASY_VIEW_LABELS
