"""The port's remaining host data code against the JAX package's, on the CPU:
the binvox codec, the voxel affine augmentation, the two contrastive voxel
datasets, S3DIS whole-scene blocks, every host augmentation, the h5 readers
and epoch samplers, BatchPointCloudLoader, the PLY and raw-bin point-cloud
helpers, the CAD-drawing dataset, host batching and the divergence guard.

Each function gets the same files (written under ``tmp_path``) and a
``np.random.RandomState`` of the same seed on both sides, and must return the
JAX function's arrays bit for bit (it draws in the JAX function's order). The
two on-device augmentations draw from a torch generator, so they are held to
their definition instead.
"""

import io
import os
import pickle

import numpy as np
import pytest
import torch

from simple3dformer_tpu.data import augment as jaug
from simple3dformer_tpu.data import binvox as jbv
from simple3dformer_tpu.data import cad as jcad
from simple3dformer_tpu.data import datasets as jds
from simple3dformer_tpu.data import pipeline as jpipe
from simple3dformer_tpu.data import voxel_augment as jva
from simple3dformer_tpu.train import health as jhealth
from simple3dformer_tpu_torch.data import augment as paug
from simple3dformer_tpu_torch.data import binvox as pbv
from simple3dformer_tpu_torch.data import cad as pcad
from simple3dformer_tpu_torch.data import datasets as pds
from simple3dformer_tpu_torch.data import pipeline as ppipe
from simple3dformer_tpu_torch.data import voxel_augment as pva
from simple3dformer_tpu_torch.train import health as phealth


def assert_same(a, b):
    """Equal structure and bit-equal arrays (dicts, tuples, lists, scalars)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, (str, int, float, bool)) or a is None:
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def both(fn_name, module_j, module_p, *args, seed=5, **kwargs):
    """fn(*args, rng=RandomState(seed)) on both sides -> (jax result, port result)."""
    out = []
    for mod in (module_j, module_p):
        out.append(getattr(mod, fn_name)(*[np.copy(a) if isinstance(a, np.ndarray) else a
                                           for a in args],
                                         rng=np.random.RandomState(seed), **kwargs))
    return out


def solid(size=16, seed=0):
    rs = np.random.RandomState(seed)
    data = np.zeros((size, size, size), bool)
    lo = size // 4
    data[lo:3 * lo, lo:3 * lo, lo:3 * lo] = True
    data |= rs.rand(size, size, size) < 0.05
    return data


def binvox_bytes(data, translate=(0.1, -0.2, 0.3), scale=1.5) -> bytes:
    buf = io.BytesIO()
    jbv.write(jbv.Voxels(data, list(data.shape), list(translate), scale, "xyz"), buf)
    return buf.getvalue()


# --- binvox and the voxel augmentation -------------------------------------

@pytest.mark.parametrize("fix_coords", [True, False])
def test_binvox_codec_matches_jax(fix_coords):
    data = solid(12, 1)
    raw = binvox_bytes(data)
    a = jbv.read_as_coord_array(io.BytesIO(raw), fix_coords)
    b = pbv.read_as_coord_array(io.BytesIO(raw), fix_coords)
    assert_same(a.__dict__, b.__dict__)
    assert_same(jbv.dense_to_sparse(data), pbv.dense_to_sparse(data))
    coords = np.concatenate([jbv.dense_to_sparse(data), [[-1], [3], [20]]], axis=1)
    assert_same(jbv.sparse_to_dense(coords, 12), pbv.sparse_to_dense(coords, 12))
    for order in ("xyz", "xzy"):
        vox = pbv.Voxels(data, [12, 12, 12], [0.0, 1.0, 2.0], 0.5, order)
        buf_p, buf_j = io.BytesIO(), io.BytesIO()
        pbv.write(vox, buf_p)
        jbv.write(jbv.Voxels(data, [12, 12, 12], [0.0, 1.0, 2.0], 0.5, order), buf_j)
        assert buf_p.getvalue() == buf_j.getvalue()
        assert_same(pbv.roundtrip_bytes(vox).data, data)
        assert_same(pbv.roundtrip_bytes(vox.clone()).__dict__,
                    jbv.roundtrip_bytes(jbv.Voxels(data, [12, 12, 12], [0.0, 1.0, 2.0], 0.5,
                                                   order)).__dict__)


def test_voxel_augmentation_matches_jax():
    for rotvec in ([0.0, 0.0, 0.0], [0.3, -0.2, 0.9]):
        assert_same(jva.rotvec_to_matrix(np.array(rotvec)), pva.rotvec_to_matrix(np.array(rotvec)))
    raw = binvox_bytes(solid(16, 2))
    for seed in range(3):
        a = jva.add_affine_transformation_to_voxel(io.BytesIO(raw),
                                                   rng=np.random.RandomState(seed))
        b = pva.add_affine_transformation_to_voxel(io.BytesIO(raw),
                                                   rng=np.random.RandomState(seed))
        assert_same(a.__dict__, b.__dict__)


# --- the contrastive voxel datasets and S3DIS whole scenes ----------------

def test_modelnet_contrastive_matches_jax(tmp_path):
    idx2cls = {0: "chair", 1: "desk"}
    for i, name in enumerate(idx2cls.values()):
        d = tmp_path / name / "train"
        d.mkdir(parents=True)
        for n in range(2):
            (d / f"{name}_{n + 1:04d}.binvox").write_bytes(binvox_bytes(solid(16, 3 + 2 * i + n)))
    (tmp_path / "chair" / "train" / "chair_0003.binvox").write_bytes(b"not a binvox")
    j = jds.ModelNetVoxelContrastive(str(tmp_path), idx2cls, rng=np.random.RandomState(4))
    p = pds.ModelNetVoxelContrastive(str(tmp_path), idx2cls, rng=np.random.RandomState(4))
    assert p.samples == j.samples and len(p) == 5
    for i in list(range(len(j))) + [1, 0]:  # a repeat draws anew on both sides
        if "0003" in j.samples[i]:
            with pytest.raises(IOError):
                p[i]
            continue
        assert_same(j[i], p[i])


def test_shapenet_contrastive_matches_jax(tmp_path):
    idx2cls = {0: "02691156", 1: "02958343"}
    roots = []
    for side in ("jax", "port"):
        root = tmp_path / side
        for i, synset in enumerate(idx2cls.values()):
            for m in range(2):
                d = root / synset / f"model{m}" / "models"
                d.mkdir(parents=True)
                (d / "model.solid.binvox").write_bytes(binvox_bytes(solid(16, 10 + 2 * i + m)))
        roots.append(str(root))
    # a cached pair is kept as it is, on both sides
    for root in roots:
        np.save(os.path.join(root, "02958343", "model1", "models", "model.solid.binvox.npy"),
                np.full((4, 4, 4), 7, np.int32))
    j = jds.ShapeNetV2Contrastive(roots[0], idx2cls, rng=np.random.RandomState(6))
    p = pds.ShapeNetV2Contrastive(roots[1], idx2cls, rng=np.random.RandomState(6))
    assert p.created == j.created == 3
    for i in range(len(j)):
        assert_same(j[i], p[i])
    x = np.random.RandomState(0).rand(9, 10, 11)
    assert_same(jds._maxpool3d_np(x, 4), pds._maxpool3d_np(x, 4))


def test_s3dis_whole_scene_matches_jax(tmp_path):
    rs = np.random.RandomState(7)
    for name in ["Area_5_office_1.npy", "Area_5_hallway_2.npy", "Area_1_office_2.npy"]:
        n = rs.randint(1500, 2500)
        pts = np.zeros((n, 7))
        pts[:, 0:2] = rs.rand(n, 2) * 2.6
        pts[:, 2] = rs.rand(n) * 2
        pts[:, 3:6] = rs.randint(0, 255, size=(n, 3))
        pts[:, 6] = rs.randint(0, 13, size=n)
        np.save(tmp_path / name, pts)
    for split in ("test", "train"):
        j = jds.S3DISWholeScene(str(tmp_path), block_points=256, split=split,
                                rng=np.random.RandomState(8))
        p = pds.S3DISWholeScene(str(tmp_path), block_points=256, split=split,
                                rng=np.random.RandomState(8))
        assert len(p) == len(j) == (2 if split == "test" else 1)
        assert_same(j.labelweights, p.labelweights)
        for i in range(len(j)):
            assert_same(j[i], p[i])


# --- host augmentations ----------------------------------------------------

CLOUD = np.random.RandomState(9).randn(4, 64, 6).astype(np.float32)
HOST_CASES = {
    "normalize_data": lambda m, r: m.normalize_data(CLOUD[..., :3].copy()),
    "shuffle_data": lambda m, r: m.shuffle_data(CLOUD.copy(), np.arange(4), rng=r),
    "shuffle_points": lambda m, r: m.shuffle_points(CLOUD.copy(), rng=r),
    "rotate_point_cloud": lambda m, r: m.rotate_point_cloud(CLOUD[..., :3].copy(), rng=r),
    "rotate_point_cloud_z": lambda m, r: m.rotate_point_cloud_z(CLOUD[..., :3].copy(), rng=r),
    "rotate_point_cloud_with_normal": lambda m, r: m.rotate_point_cloud_with_normal(
        CLOUD.copy(), rng=r),
    "rotate_point_cloud_by_angle": lambda m, r: m.rotate_point_cloud_by_angle(
        CLOUD[..., :3].copy(), 0.7),
    "rotate_perturbation_point_cloud": lambda m, r: m.rotate_perturbation_point_cloud(
        CLOUD[..., :3].copy(), rng=r),
    "jitter_point_cloud": lambda m, r: m.jitter_point_cloud(CLOUD.copy(), rng=r),
    "shift_point_cloud": lambda m, r: m.shift_point_cloud(CLOUD[..., :3].copy(), rng=r),
    "random_scale_point_cloud": lambda m, r: m.random_scale_point_cloud(CLOUD[..., :3].copy(),
                                                                        rng=r),
    "random_point_dropout": lambda m, r: m.random_point_dropout(CLOUD.copy(), rng=r),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_augmentation_matches_jax(name):
    case = HOST_CASES[name]
    a = case(jaug, np.random.RandomState(10))
    b = case(paug, np.random.RandomState(10))
    assert_same(a, b)


def test_device_rotate_y_and_jitter():
    """Each sample turned about Y by 2 pi u, u from the generator (the host
    rotation by that angle); the jitter clipped and drawn from the generator."""
    xyz = torch.from_numpy(CLOUD[..., :3].copy())
    got = paug.device_rotate_y(torch.Generator().manual_seed(1), xyz)
    angles = 2 * np.pi * torch.rand(4, generator=torch.Generator().manual_seed(1)).numpy()
    for b in range(4):
        want = jaug.rotate_point_cloud_by_angle(CLOUD[b:b + 1, :, :3].astype(np.float64),
                                                float(angles[b]))
        np.testing.assert_allclose(got[b].numpy(), want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[..., 1], xyz[..., 1], rtol=0, atol=0)
    a = paug.device_jitter(torch.Generator().manual_seed(2), xyz, sigma=0.05, clip=0.06)
    b = paug.device_jitter(torch.Generator().manual_seed(2), xyz, sigma=0.05, clip=0.06)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    noise = (a - xyz).abs()
    assert float(noise.max()) <= 0.06 + 1e-6 and float(noise.mean()) > 0.02


# --- h5 readers, epoch samplers and BatchPointCloudLoader -------------------

def test_h5_readers_and_samplers_match_jax(tmp_path):
    import h5py

    rs = np.random.RandomState(11)
    pcs = rs.randn(6, 40, 3).astype(np.float32)
    labels = rs.randint(0, 15, 6)
    mask = rs.randint(-1, 3, (6, 40))
    parts = rs.randint(0, 4, (6, 40))
    types = rs.randint(0, 2, 6)
    path = str(tmp_path / "split.h5")
    with h5py.File(path, "w") as f:
        for k, v in dict(data=pcs, label=labels, mask=mask, parts=parts, type=types).items():
            f[k] = v
    for fn in ("load_withmask_h5", "load_parts_h5", "load_discriminator_h5"):
        assert_same(getattr(jds, fn)(path), getattr(pds, fn)(path))
    assert_same(*both("get_current_data_h5", jds, pds, pcs, labels, 32))
    for shuffle in (True, False):
        assert_same(*both("get_current_data_withmask_h5", jds, pds, pcs, labels, mask, 32,
                          shuffle=shuffle))
    assert_same(*both("get_current_data_parts_h5", jds, pds, pcs, labels, parts, 32))
    assert_same(*both("get_current_data_discriminator_h5", jds, pds, pcs, labels, types, 32))
    assert_same(jds.convert_to_binary_mask(mask), pds.convert_to_binary_mask(mask))
    assert_same(jds.flip_types(types), pds.flip_types(types))


@pytest.mark.parametrize("normal_channel", [False, True])
def test_batch_point_cloud_loader_matches_jax(normal_channel):
    points = np.random.RandomState(12).randn(10, 32, 6).astype(np.float32)
    labels = np.arange(10)
    loaders = [m.BatchPointCloudLoader(points, labels, batch_size=4,
                                       normal_channel=normal_channel,
                                       rng=np.random.RandomState(13)) for m in (jds, pds)]
    for epoch in range(2):
        assert loaders[1].num_batches() == loaders[0].num_batches() == 3
        while loaders[0].has_next_batch():
            assert loaders[1].has_next_batch()
            assert_same(*(ld.next_batch(augment=epoch == 0) for ld in loaders))
        assert not loaders[1].has_next_batch()
        for ld in loaders:
            ld.reset()


# --- PLY and the raw-bin point clouds ---------------------------------------

def test_ply_and_pc_helpers_match_jax(tmp_path):
    rs = np.random.RandomState(14)
    pts, normals, colors = rs.randn(20, 3), rs.randn(20, 3), rs.rand(20, 3)
    for kw in ({}, {"normals": normals}, {"colors": colors, "normals": normals}):
        jds.save_ply(pts, str(tmp_path / "j.ply"), **kw)
        pds.save_ply(pts, str(tmp_path / "p.ply"), **kw)
        assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "p.ply").read_bytes()
        assert_same(jds.read_ply(str(tmp_path / "j.ply")), pds.read_ply(str(tmp_path / "j.ply")))
    bin_dir = tmp_path / "objects"
    bin_dir.mkdir()
    entries = []
    for i, n in enumerate((50, 20, 70)):
        rows = rs.randn(n, 11).astype(np.float32)
        rows[:, -1] = rs.randint(0, 6, n)
        np.concatenate([[np.float32(n)], rows.reshape(-1)]).astype(np.float32).tofile(
            bin_dir / f"obj{i}.bin")
        entries.append({"filename": f"objects_bin/obj{i}.bin", "label": i})
    with open(tmp_path / "index.pkl", "wb") as f:
        pickle.dump(entries, f)
    for with_bg in (True, False):
        assert_same(jds.load_pc_file(str(bin_dir / "obj0.bin"), with_bg=with_bg),
                    pds.load_pc_file(str(bin_dir / "obj0.bin"), with_bg=with_bg))
    got = [m.load_pc_data(str(tmp_path / "index.pkl"), str(bin_dir), num_points=32)
           for m in (jds, pds)]
    assert_same(*got)
    assert len(got[1][0]) == 2  # the 20-point object is dropped
    assert_same(*both("get_current_data", jds, pds, got[0][0], got[0][1], 16))
    for fn in ("normalize_pcs", "center_pcs"):
        clouds = [c.copy() for c in got[0][0]]
        assert_same(getattr(jds, fn)([c.copy() for c in clouds]),
                    getattr(pds, fn)([c.copy() for c in clouds]))
    views = rs.randn(2, 6, 10, 3)
    assert_same(jds.normalize_pcs_multiview(views), pds.normalize_pcs_multiview(views))


# --- the CAD-drawing dataset ------------------------------------------------

def _cad_tree(root, split, rs, sizes):
    from PIL import Image

    img_dir = root / "images" / split / "images"
    ann_dir = root / "annotations" / split / "constructed_graphs_withdeg"
    img_dir.mkdir(parents=True)
    ann_dir.mkdir(parents=True)
    for i, n in enumerate(sizes):
        Image.fromarray(rs.randint(0, 256, (40, 30, 3)).astype(np.uint8)).save(
            img_dir / f"d{i:02d}.png")
        anno = {"class": rs.randint(0, 30, n), "centers_normed": rs.uniform(-1, 1, (n, 2)),
                "node": rs.randint(0, 9, (n, 4)), "degrees": rs.randint(0, 200, n)}
        np.save(ann_dir / f"d{i:02d}.npy", anno, allow_pickle=True)


class _Cfg:
    clus_num_per_batch, nn, img_size = 6, 8, 32


@pytest.mark.parametrize("split,do_clus", [("training", True), ("test", True),
                                           ("training", False)])
def test_cad_dataset_matches_jax(tmp_path, split, do_clus):
    _cad_tree(tmp_path, split, np.random.RandomState(15), (60, 5, 1200, 40))
    sets = [m.CADDrawingDataset(str(tmp_path), split=split, do_clus=do_clus, cfg=_Cfg(),
                                rng=np.random.RandomState(16)) for m in (jcad, pcad)]
    assert len(sets[1]) == len(sets[0]) == (3 if do_clus else 4)  # under nn nodes: dropped
    for i in list(range(len(sets[0]))) * 2:
        assert_same(sets[0][i], sets[1][i])
    if split == "training" and do_clus:
        item = sets[0][0]
        assert_same(item, sets[1][0])  # both states stay in step
        nodes = np.load(sets[1].anno_path_list[0], allow_pickle=True).item()["centers_normed"]
        for m, m_set in zip((jcad, pcad), sets):
            m_set.draw_pts(nodes, str(tmp_path / f"{m.__name__}.png"))
            m_set.plot_indexes(nodes, item[5], "d.svg", str(tmp_path / m.__name__))
        assert (tmp_path / f"{jcad.__name__}.png").read_bytes() == \
            (tmp_path / f"{pcad.__name__}.png").read_bytes()
        assert (tmp_path / jcad.__name__ / "d.png").read_bytes() == \
            (tmp_path / pcad.__name__ / "d.png").read_bytes()


def test_cad_helpers_match_jax():
    rs = np.random.RandomState(17)
    xyz = rs.uniform(-1, 1, (50, 2))
    arrays = (rs.randint(0, 5, 50), rs.randint(0, 9, (50, 3)), rs.randint(0, 9, (50, 1)))
    for rand_prob in (0.0, 0.999):
        assert_same(*both("sample_and_group", jcad, pcad, 5, 7, xyz, *arrays,
                          rand_prob=rand_prob))
    assert_same(*both("random_point_sample", jcad, pcad, xyz, 9))
    img = rs.rand(4, 4, 3).astype(np.float32)
    assert_same(jcad.imagenet_preprocess(img), pcad.imagenet_preprocess(img))
    for n in (1, 1000, 1001, 5000, 20000, 20001):
        assert jcad._eval_divisor(n) == pcad._eval_divisor(n)


# --- host batching and the divergence guard ---------------------------------

def test_host_batches_and_collate_match_jax():
    data = [{"x": np.full((2,), i, np.float32), "y": i} for i in range(7)]
    for shuffle, drop_last in ((True, False), (False, True)):
        got = [list(m.host_batches(data, 3, np.random.RandomState(18), shuffle, drop_last))
               for m in (jpipe, ppipe)]
        assert_same(*got)
        assert_same(jpipe.collate(got[0][0]), ppipe.collate(got[1][0]))
    tuples = [(np.ones(2) * i, np.int32(i)) for i in range(3)]
    assert_same(jpipe.collate(tuples), ppipe.collate(tuples))
    assert_same(jpipe.collate(data[:2], keys=("x",)), ppipe.collate(data[:2], keys=("x",)))


def test_divergence_guard_matches_jax():
    guards = [jhealth.DivergenceGuard(max_rollbacks=1), phealth.DivergenceGuard(max_rollbacks=1)]
    bad = {"loss": np.array([1.0, np.nan])}
    for g in guards:
        assert g.check("new", {"loss": np.array([1.0, 2.0])}, 0, good_state="old") == "new"
        assert g.check("new", bad, 1, good_state="old") == "old"
    with pytest.raises(jhealth.TrainingDiverged):
        guards[0].check("new", bad, 2, good_state="old")
    with pytest.raises(phealth.TrainingDiverged, match="non-finite 'loss' at epoch 2, step 1"):
        guards[1].check("new", bad, 2, good_state="old")
    assert guards[1].rollbacks == guards[0].rollbacks == 2
