"""The port's native binvox ingest (data/native_ingest) and the voxel datasets'
``materialize`` against the JAX package's, on the CPU.

Every case writes its binvox files under ``tmp_path`` at the raw-format level
(a hand-built header and RLE payload, runs capped at 255) from a seeded
``np.random.RandomState``, and the port must return the JAX package's arrays
bit for bit and raise its errors with its messages. Both libraries are built
with g++ from their own copies of ingest.cpp with the same flags.
"""

import io
import os

import numpy as np
import pytest

from simple3dformer_tpu.data import binvox as jbv
from simple3dformer_tpu.data import datasets as jds
from simple3dformer_tpu.data import native_ingest as jni
from simple3dformer_tpu.data.classmaps import CLASSES_ModelNet10
from simple3dformer_tpu_torch.data import datasets as pds
from simple3dformer_tpu_torch.data import native_ingest as pni

SYNSETS = {0: "02691156", 1: "03001627"}


def raw_binvox_bytes(flat: np.ndarray, dims) -> bytes:
    """A binvox file: the dims header, then (value, count) pairs over ``flat``
    (file order), runs capped at 255 as the format has them."""
    out = bytearray(b"#binvox 1\n")
    out += ("dim " + " ".join(str(d) for d in dims) + "\n").encode()
    out += b"translate 0 0 0\nscale 1.0\ndata\n"
    flat = np.asarray(flat, np.uint8)
    i = 0
    while i < flat.size:
        v, run = int(flat[i]), 1
        while i + run < flat.size and flat[i + run] == v and run < 255:
            run += 1
        out += bytes((v, run))
        i += run
    return bytes(out)


def write_grids(directory, rs, n, dims, fill=0.5, prefix="g"):
    """n random grids as binvox files -> their paths (sorted)."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(directory, f"{prefix}{i:03d}.binvox")
        with open(p, "wb") as f:
            f.write(raw_binvox_bytes(rs.rand(int(np.prod(dims))) < fill, dims))
        paths.append(p)
    return paths


def numpy_codec(paths, fix_coords=True):
    grids = []
    for p in paths:
        with open(p, "rb") as f:
            grids.append(jbv.read_as_3d_array(f, fix_coords).data.astype(np.uint8))
    return np.stack(grids)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def libs():
    """Both libraries built and loaded once (the port's build raises if g++ fails)."""
    assert pni.available()
    assert jni.available()


@pytest.mark.parametrize("dims", [(16, 16, 16), (6, 4, 5), (1, 7, 3)])
@pytest.mark.parametrize("fix_coords", [True, False])
def test_decode_bytes(libs, dims, fix_coords):
    raw = raw_binvox_bytes(np.random.RandomState(3).rand(int(np.prod(dims))) > 0.6, dims)
    got = pni.decode_bytes(raw, dims, fix_coords=fix_coords)
    same(got, jni.decode_bytes(raw, dims, fix_coords=fix_coords))
    same(got, jbv.read_as_3d_array(io.BytesIO(raw), fix_coords).data.astype(np.uint8))


@pytest.mark.parametrize("pattern", ["ones", "long_runs"])
def test_decode_runs_longer_than_255(libs, pattern):
    dims = (8, 9, 10)  # 720 voxels: 255 + 255 + 210 when all one
    flat = np.ones(720, np.uint8)
    if pattern == "long_runs":
        flat[300:650] = 0  # runs of 300, 350 and 70, each split at 255
    raw = raw_binvox_bytes(flat, dims)
    got = pni.decode_bytes(raw, dims)
    assert got.shape == (8, 10, 9)  # transpose(0, 2, 1) of the header dims
    same(got, jni.decode_bytes(raw, dims))
    same(got, jbv.read_as_3d_array(io.BytesIO(raw)).data.astype(np.uint8))


@pytest.mark.parametrize("threads", [1, 4])
def test_read_dims_and_materialize(libs, tmp_path, threads):
    dims = (12, 10, 11)
    paths = write_grids(tmp_path, np.random.RandomState(11), 23, dims, fill=0.4)
    assert pni.read_dims(paths[0]) == jni.read_dims(paths[0]) == dims
    got = pni.materialize(paths, threads=threads)
    same(got, jni.materialize(paths, threads=threads))
    same(got, numpy_codec(paths))
    same(pni.materialize(paths, dims=dims, fix_coords=False, threads=threads),
         jni.materialize(paths, dims=dims, fix_coords=False, threads=threads))


def error_case(tmp_path, case):
    """(paths, dims) of a split that fails in ``case``."""
    dims = (4, 4, 4)
    good = str(tmp_path / "good.binvox")
    with open(good, "wb") as f:
        f.write(raw_binvox_bytes(np.random.RandomState(5).rand(64) > 0.5, dims))
    bad = str(tmp_path / "bad.binvox")
    payloads = {"truncated": b"#binvox 1\ndim 4 4 4\ndata\n" + bytes([1, 70, 0, 30]),
                "odd": b"#binvox 1\ndim 4 4 4\ndata\n" + bytes([1, 64, 0]),
                "header": b"not a binvox",
                "mixed_dims": raw_binvox_bytes(np.zeros(5 * 4 * 4), (5, 4, 4))}
    if case in payloads:
        with open(bad, "wb") as f:
            f.write(payloads[case])
        return [good, bad], dims
    if case == "wrong_dims":
        return [good], (5, 4, 4)
    if case == "missing":
        return [good, str(tmp_path / "missing.binvox")], dims
    return [], None  # "empty"


@pytest.mark.parametrize("case", ["truncated", "odd", "header", "mixed_dims", "wrong_dims",
                                  "missing", "empty"])
def test_materialize_errors(libs, tmp_path, case):
    """The same exception with the same message: the failing file and the
    error code's text (or the empty list's ValueError)."""
    paths, dims = error_case(tmp_path, case)
    if case == "mixed_dims":
        dims = None  # discovered from the first file, as the datasets call it
    raised = []
    for mod in (jni, pni):
        with pytest.raises((IOError, ValueError)) as info:
            mod.materialize(paths, dims=dims, threads=2)
        raised.append((type(info.value), str(info.value)))
    assert raised[0] == raised[1], raised
    if case == "mixed_dims":
        assert raised[1] == (OSError, f"{paths[1]}: grid dims do not match the expected dims")
    if case == "empty":
        assert raised[1] == (ValueError, "materialize: empty path list")


def test_numpy_codec_under_env(libs, tmp_path, monkeypatch):
    """S3F_NATIVE_INGEST=0 chooses the numpy codec on both sides: the same
    arrays as the libraries', the same dims error."""
    paths = write_grids(tmp_path, np.random.RandomState(7), 4, (8, 6, 5))
    native = pni.materialize(paths)
    monkeypatch.setenv("S3F_NATIVE_INGEST", "0")
    monkeypatch.setattr(jni, "_lib", None)  # the JAX module reads the variable once
    monkeypatch.setattr(jni, "_lib_error", None)
    assert not pni.available() and not jni.available()
    got = pni.materialize(paths)
    same(got, jni.materialize(paths))
    same(got, native)
    assert pni.read_dims(paths[0]) == jni.read_dims(paths[0]) == (8, 6, 5)
    with open(paths[1], "rb") as f:
        raw = f.read()
    same(pni.decode_bytes(raw, (8, 6, 5), False), jni.decode_bytes(raw, (8, 6, 5), False))
    errors = []
    for mod in (jni, pni):
        with pytest.raises(IOError) as info:
            mod.materialize(paths, dims=(8, 5, 6))
        errors.append(str(info.value))
    assert errors[0] == errors[1] == f"{paths[0]}: grid dims do not match the expected dims"


def modelnet_tree(root, rs, dims=(16, 16, 16)):
    for cls_name, n in [("bathtub", 3), ("chair", 2), ("desk", 2)]:
        write_grids(os.path.join(root, cls_name, "train"), rs, n, dims, fill=0.2,
                    prefix=f"{cls_name}_")


def shapenet_tree(root, rs, dims=(16, 16, 16)):
    for synset, n in [(SYNSETS[0], 3), (SYNSETS[1], 3)]:
        for i in range(n):
            d = os.path.join(root, synset, f"m{i}", "models")
            os.makedirs(d)
            with open(os.path.join(d, "model_normalized.solid.binvox"), "wb") as f:
                f.write(raw_binvox_bytes(rs.rand(int(np.prod(dims))) < 0.2, dims))


def datasets_of(kind, root):
    if kind == "modelnet":
        return (jds.ModelNetVoxelDataset(str(root), CLASSES_ModelNet10, "train"),
                pds.ModelNetVoxelDataset(str(root), CLASSES_ModelNet10, "train"))
    return (jds.ShapeNetV2VoxelDataset(str(root), SYNSETS),
            pds.ShapeNetV2VoxelDataset(str(root), SYNSETS))


@pytest.mark.parametrize("kind", ["modelnet", "shapenet"])
@pytest.mark.parametrize("indices,threads", [(None, None), ([5, 1, 3], 1), ([0, 2, 4, 6], 4)])
def test_dataset_materialize(libs, tmp_path, kind, indices, threads):
    (modelnet_tree if kind == "modelnet" else shapenet_tree)(tmp_path, np.random.RandomState(13))
    jax_ds, port_ds = datasets_of(kind, tmp_path)
    if indices is not None and kind == "shapenet":
        indices = [i % len(port_ds) for i in indices]
    want = jax_ds.materialize(indices=indices, threads=threads)
    got = port_ds.materialize(indices=indices, threads=threads)
    for a, b in zip(want, got):
        same(b, a)
    for i, k in enumerate(range(len(port_ds)) if indices is None else indices):
        same(got[0][i], port_ds[k]["voxel"].astype(np.uint8))  # the per-item reader's grid


@pytest.mark.parametrize("kind", ["modelnet", "shapenet"])
def test_dataset_materialize_raises_as_jax(libs, tmp_path, kind):
    """A file of other dims in the split raises IOError naming it, an empty
    split ValueError, on both sides."""
    (modelnet_tree if kind == "modelnet" else shapenet_tree)(tmp_path, np.random.RandomState(17))
    odd = datasets_of(kind, tmp_path)[1].samples[-1]
    with open(odd, "wb") as f:
        f.write(raw_binvox_bytes(np.zeros(8 ** 3), (8, 8, 8)))
    (tmp_path / "empty").mkdir()
    for root, exc in ((tmp_path, IOError), (tmp_path / "empty", ValueError)):
        messages = []
        for ds in datasets_of(kind, root):
            with pytest.raises(exc) as info:
                ds.materialize()
            messages.append(str(info.value))
        assert messages[0] == messages[1], messages
    assert messages[1] == "materialize: empty path list"
