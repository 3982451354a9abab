"""Dataset readers (port of ModelNetVoxelDataset, ShapeNetV2VoxelDataset,
ModelNetPointCloud, PartNormalDataset, S3DISDataset, load_h5,
load_scanobjectnn_h5 and synthetic_points from
simple3dformer_tpu/data/datasets.py, numpy path).

Python classes with __len__/__getitem__ mirroring the reference's torch
Datasets (data/modelnet40.py, modelnet10.py, shapenet_v2.py); samples come
back as numpy. Training does not read per item: ``materialize`` decodes a
split into one uint8 array, which data/pipeline.DeviceResidentDataset puts
on the device once.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np

from . import binvox


def _materialize_binvox(samples, labels, indices=None):
    """Decode ``indices`` of (samples, labels) into (x uint8 [n, X, Y, Z], y int32)."""
    idx = np.arange(len(samples)) if indices is None else np.asarray(list(map(int, indices)))
    grids = []
    for i in idx:
        with open(samples[i], "rb") as f:
            grids.append(binvox.read_as_3d_array(f).data.astype(np.uint8))
    x = np.stack(grids) if grids else np.zeros((0, 0, 0, 0), np.uint8)
    return x, np.asarray(labels[idx], np.int32)


def _class_weight(labels, n_classes: int) -> np.ndarray:
    """1/log1p class-frequency weights (the reference's modelnet40.py:50-57)."""
    freq = np.bincount(labels, minlength=n_classes)
    w = 1.0 / np.log1p(1.0 + freq)
    return (len(w) * w / w.sum()).astype(np.float32)


class ModelNetVoxelDataset:
    """ModelNet10/40 binvox grids: data_root/<class>/<split>/<class>_<n>.binvox."""

    def __init__(self, data_root: str, idx2cls: dict[int, str], split: str = "train"):
        self.data_root = data_root
        self.cls2idx = {v: k for k, v in idx2cls.items()}
        self.samples: list[str] = []
        for name in idx2cls.values():
            for path in sorted(glob.glob(os.path.join(data_root, name, split, "*.binvox"))):
                if re.match(r"[a-zA-Z_]+_\d+\.binvox", os.path.basename(path)):
                    self.samples.append(path)

    def __len__(self):
        return len(self.samples)

    def _cls_name(self, path: str) -> str:
        return re.split(r"_\d+\.binvox", os.path.basename(path))[0]

    def __getitem__(self, idx: int):
        path = self.samples[idx]
        with open(path, "rb") as f:
            vox = binvox.read_as_3d_array(f).data.astype(np.int32)
        return {"voxel": vox, "cls_idx": self.cls2idx[self._cls_name(path)]}

    def labels(self) -> np.ndarray:
        return np.asarray([self.cls2idx[self._cls_name(p)] for p in self.samples], np.int32)

    def class_weight(self) -> np.ndarray:
        return _class_weight(self.labels(), len(self.cls2idx))

    def materialize(self, indices=None):
        """Decode (a subset of) the split into ``(x uint8, y int32)``."""
        return _materialize_binvox(self.samples, self.labels(), indices)


class ShapeNetV2VoxelDataset:
    """ShapeNetCore.v2 solid binvox: root/<synset>/<model>/models/*.solid.binvox."""

    def __init__(self, data_root: str, idx2cls: dict[int, str]):
        self.cls2idx = {v: k for k, v in idx2cls.items()}
        self.samples: list[str] = []
        for synset in idx2cls.values():
            self.samples.extend(sorted(glob.glob(
                os.path.join(data_root, synset, "*/models/*.solid.binvox"))))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        path = self.samples[idx]
        parts = path.split(os.sep)
        with open(path, "rb") as f:
            vox = binvox.read_as_3d_array(f).data.astype(np.int32)
        return {"voxel": vox, "cls_idx": self.cls2idx[parts[-4]], "model_id": parts[-3]}

    def labels(self) -> np.ndarray:
        return np.asarray([self.cls2idx[p.split(os.sep)[-4]] for p in self.samples], np.int32)

    def class_weight(self) -> np.ndarray:
        return _class_weight(self.labels(), len(self.cls2idx))

    def materialize(self, indices=None):
        """Decode into ``(x uint8, y int32)``; see ModelNetVoxelDataset.materialize."""
        return _materialize_binvox(self.samples, self.labels(), indices)

    def split_train_test(self, frac: float = 0.8, seed: int = 9):
        """The 80/20 random split of the reference's train_cls_voxel.py:112-114."""
        idx = np.random.RandomState(seed).permutation(len(self.samples))
        cut = int(frac * len(self.samples))
        return idx[:cut], idx[cut:]


def _pc_normalize_np(pc: np.ndarray) -> np.ndarray:
    centroid = np.mean(pc, axis=0)
    pc = pc - centroid
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
    return pc / m


def _fps_numpy(xyz: np.ndarray, npoint: int, rng: np.random.RandomState) -> np.ndarray:
    """Host-side farthest-point sampling. xyz [N, 3] -> indices [npoint]: a random
    start point, the running min distance, argmax (the reference's
    data/pointnet_util.py:53-73), in float64."""
    n = xyz.shape[0]
    idx = np.empty(npoint, dtype=np.int64)
    dist = np.full(n, np.inf, dtype=np.float64)
    farthest = int(rng.randint(0, n))
    for i in range(npoint):
        idx[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, axis=1)
        np.minimum(dist, d, out=dist)
        farthest = int(np.argmax(dist))
    return idx


class ModelNetPointCloud:
    """ModelNet40 resampled-txt point clouds with an in-RAM cache (the
    reference's data/modelnet40_point_cloud.py:8-60).

    root holds ``modelnet40_shape_names.txt``, ``modelnet40_{split}.txt`` and
    ``<shape>/<shape>_<id>.txt`` files of comma-separated rows of 6 floats (xyz,
    normal). ``uniform=True`` takes npoint points by farthest-point sampling
    over xyz (the JAX package's repair of the reference's branch, which could
    not run) instead of the first npoint rows. xyz is centred and scaled to the
    unit sphere; ``normal_channel=False`` keeps xyz only. Items are (points
    [npoint, 6 or 3] f32, class [1] int32).
    """

    def __init__(self, root: str, npoint: int = 1024, split: str = "train",
                 uniform: bool = False, normal_channel: bool = True,
                 rng: np.random.RandomState | None = None):
        self.root = root
        self.npoints = npoint
        self.uniform = uniform
        self.normal_channel = normal_channel
        self.rng = rng if rng is not None else np.random.RandomState()
        with open(os.path.join(root, "modelnet40_shape_names.txt")) as f:
            self.classes = {line.rstrip(): i for i, line in enumerate(f)}
        with open(os.path.join(root, f"modelnet40_{split}.txt")) as f:
            ids = [line.rstrip() for line in f]
        names = ["_".join(x.split("_")[0:-1]) for x in ids]
        self.datapath = [(names[i], os.path.join(root, names[i], ids[i]) + ".txt")
                         for i in range(len(ids))]
        self.cache: dict[int, tuple] = {}

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index: int):
        if index in self.cache:
            return self.cache[index]
        name, path = self.datapath[index]
        cls = np.array([self.classes[name]], dtype=np.int32)
        with open(path) as f:  # the fast parse of the JAX reader (np.loadtxt is ~20x slower)
            pts = np.fromstring(f.read().replace("\n", ","), sep=",", dtype=np.float32)
        pts = pts.reshape(-1, 6)
        if self.uniform:
            pts = pts[_fps_numpy(pts[:, 0:3], self.npoints, self.rng)]
        else:
            pts = pts[: self.npoints]
        pts[:, 0:3] = _pc_normalize_np(pts[:, 0:3])
        if not self.normal_channel:
            pts = pts[:, 0:3]
        item = (pts, cls)
        self.cache[index] = item
        return item


class PartNormalDataset:
    """ShapeNetPart with a random resample per item (the reference's
    shapenet_part_seg.py:14-114; port of the JAX package's reader).

    root holds ``synsetoffset2category.txt``, ``train_test_split/`` and one
    directory per synset of ``<id>.txt`` files (x y z nx ny nz part).
    """

    def __init__(self, root: str, npoints: int = 2500, split: str = "train",
                 class_choice=None, normal_channel: bool = False,
                 rng: np.random.RandomState | None = None):
        self.npoints = npoints
        self.root = root
        self.normal_channel = normal_channel
        self.rng = rng if rng is not None else np.random.RandomState()

        self.cat: dict[str, str] = {}
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            for line in f:
                name, synset = line.strip().split()
                self.cat[name] = synset
        self.classes_original = {n: i for i, n in enumerate(self.cat)}
        if class_choice is not None:
            self.cat = {k: v for k, v in self.cat.items() if k in class_choice}

        def ids(fname):
            with open(os.path.join(root, "train_test_split", fname)) as f:
                return set(str(d.split("/")[2]) for d in json.load(f))

        train_ids = ids("shuffled_train_file_list.json")
        val_ids = ids("shuffled_val_file_list.json")
        test_ids = ids("shuffled_test_file_list.json")
        want = {"train": train_ids, "val": val_ids, "test": test_ids,
                "trainval": train_ids | val_ids}[split]

        self.datapath: list[tuple[str, str]] = []
        for item, synset in self.cat.items():
            d = os.path.join(root, synset)
            for fn in sorted(os.listdir(d)):
                if fn[0:-4] in want:
                    self.datapath.append((item, os.path.join(d, fn)))
        self.classes = {k: self.classes_original[k] for k in self.cat}
        self.cache: dict[int, tuple] = {}

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index: int):
        if index in self.cache:
            pts, cls, seg = self.cache[index]
        else:
            cat, path = self.datapath[index]
            cls = np.array([self.classes[cat]], dtype=np.int32)
            data = np.loadtxt(path).astype(np.float32)
            pts = data[:, 0:6] if self.normal_channel else data[:, 0:3]
            seg = data[:, -1].astype(np.int32)
            self.cache[index] = (pts, cls, seg)
        pts = pts.copy()
        pts[:, 0:3] = _pc_normalize_np(pts[:, 0:3])
        choice = self.rng.choice(len(seg), self.npoints, replace=True)
        return pts[choice], cls, seg[choice]


class S3DISDataset:
    """Room-block sampler over per-room ``Area_*.npy`` files (the reference's
    s3dis.py:8-83; port of the JAX package's reader).

    Each room file is [points, 7]: x y z r g b label. A sample is a block of
    ``block_size`` metres around a random point, resampled to ``num_point``
    rows of 9 columns: xyz centred on the block (z kept), rgb / 255, and xyz
    over the room's maximum. ``labelweights`` are the reference's
    (max share / share)^(1/3) class weights.
    """

    def __init__(self, data_root: str, split: str = "train", num_point: int = 4096,
                 test_area: int = 5, block_size: float = 1.0, sample_rate: float = 1.0,
                 rng: np.random.RandomState | None = None):
        self.num_point = num_point
        self.block_size = block_size
        self.rng = rng if rng is not None else np.random.RandomState()
        rooms = sorted(r for r in os.listdir(data_root) if "Area_" in r)
        tag = f"Area_{test_area}"
        rooms = [r for r in rooms if (tag not in r) == (split == "train")]

        self.room_points, self.room_labels = [], []
        self.room_coord_max = []
        counts = []
        labelweights = np.zeros(13)
        for room in rooms:
            data = np.load(os.path.join(data_root, room))
            pts, lbl = data[:, 0:6], data[:, 6]
            hist, _ = np.histogram(lbl, range(14))
            labelweights += hist
            self.room_points.append(pts)
            self.room_labels.append(lbl)
            self.room_coord_max.append(np.amax(pts, axis=0)[:3])
            counts.append(lbl.size)
        labelweights = labelweights / labelweights.sum()
        self.labelweights = np.power(
            np.amax(labelweights) / np.maximum(labelweights, 1e-12), 1 / 3.0).astype(np.float32)
        prob = np.array(counts) / np.sum(counts)
        num_iter = int(np.sum(counts) * sample_rate / num_point)
        idxs = []
        for i in range(len(rooms)):
            idxs.extend([i] * int(round(prob[i] * num_iter)))
        self.room_idxs = np.array(idxs)

    def __len__(self):
        return len(self.room_idxs)

    def __getitem__(self, idx: int):
        room = self.room_idxs[idx]
        pts, lbl = self.room_points[room], self.room_labels[room]
        n = pts.shape[0]
        # The reference retries without bound until a block holds more than
        # 1024 points (s3dis.py:54-60), which never ends on a sparse room: at
        # most 64 tries here, then the densest block found.
        best_sel, best_center = None, None
        for _ in range(64):
            center = pts[self.rng.choice(n)][:3]
            lo = center - [self.block_size / 2, self.block_size / 2, 0]
            hi = center + [self.block_size / 2, self.block_size / 2, 0]
            sel = np.where((pts[:, 0] >= lo[0]) & (pts[:, 0] <= hi[0])
                           & (pts[:, 1] >= lo[1]) & (pts[:, 1] <= hi[1]))[0]
            if best_sel is None or sel.size > best_sel.size:
                best_sel, best_center = sel, center
            if sel.size > 1024:
                break
        sel, center = best_sel, best_center
        if sel.size == 0:
            raise ValueError(f"room {room} yielded an empty block")
        chosen = self.rng.choice(sel, self.num_point, replace=sel.size < self.num_point)
        p = pts[chosen].copy()
        out = np.zeros((self.num_point, 9), dtype=np.float32)
        out[:, 6] = p[:, 0] / self.room_coord_max[room][0]
        out[:, 7] = p[:, 1] / self.room_coord_max[room][1]
        out[:, 8] = p[:, 2] / self.room_coord_max[room][2]
        p[:, 0] -= center[0]
        p[:, 1] -= center[1]
        p[:, 3:6] /= 255.0
        out[:, 0:6] = p
        return out, lbl[chosen].astype(np.int32)


def synthetic_points(n: int, npoint: int, channels: int, n_classes: int, seed: int = 9):
    """The JAX package's synthetic point stream: n clouds of standard-normal
    [npoint, channels] f32 and a uniform label per cloud."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, npoint, channels).astype(np.float32)
    return x, rng.randint(0, n_classes, size=(n,)).astype(np.int32)


def load_h5(path: str, keys: tuple = ("data", "label")):
    """The arrays under ``keys`` of an h5 file (the reference's
    utils/provider.py load_h5). h5py is imported here only, so that nothing
    else in the port needs it."""
    import h5py

    with h5py.File(path, "r") as f:
        return tuple(f[k][:] for k in keys)


def load_scanobjectnn_h5(path: str):
    """A ScanObjectNN h5 split: (data [B, N, 3] f32, label int32 in the file's shape)."""
    data, label = load_h5(path)
    return data.astype(np.float32), label.astype(np.int32)
