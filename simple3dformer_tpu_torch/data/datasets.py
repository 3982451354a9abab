"""Dataset readers (port of simple3dformer_tpu/data/datasets.py, numpy path:
every reader and helper of that module but its synthetic_voxels, which is
data/synthetic.py here, and the native ingest library, which the port does
not keep).

Python classes with __len__/__getitem__ mirroring the reference's torch
Datasets (data/modelnet40.py, modelnet10.py, shapenet_v2.py); samples come
back as numpy. Training does not read per item: ``materialize`` decodes a
split into one uint8 array, which data/pipeline.DeviceResidentDataset puts
on the device once.

Every reader that draws (the contrastive augmentations, the resampling
readers, the whole-scene blocks, the h5 epoch samplers, BatchPointCloudLoader)
draws from the caller's ``np.random.RandomState`` in the JAX reader's order,
so the same state and the same files give the same arrays.
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


class ModelNetVoxelContrastive(ModelNetVoxelDataset):
    """ModelNet voxels + an affine-augmented positive pair
    (modelnet40.py:60-88 ModelNet40_Constrastive): each sample carries a
    'contrastive' grid produced by the random affine re-voxelization; falls
    back to the clean grid if augmentation fails, like the reference."""

    def __init__(self, data_root, idx2cls, split="train",
                 rng: np.random.RandomState | None = None):
        super().__init__(data_root, idx2cls, split)
        self.rng = rng if rng is not None else np.random.RandomState()

    def __getitem__(self, idx: int):
        from . import voxel_augment

        sample = super().__getitem__(idx)
        path = self.samples[idx]
        try:
            with open(path, "rb") as f:
                aug = voxel_augment.add_affine_transformation_to_voxel(
                    f, rng=self.rng
                )
            sample["contrastive"] = aug.data.astype(np.int32)
        except Exception:
            sample["contrastive"] = sample["voxel"]
        return sample


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


def _maxpool3d_np(x: np.ndarray, k: int) -> np.ndarray:
    """torch MaxPool3d(k) semantics on a dense [X,Y,Z] grid: non-overlapping
    k-cubes, remainder voxels dropped (floor division, like torch's default
    stride=kernel)."""
    a, b, c = (s // k for s in x.shape)
    x = x[: a * k, : b * k, : c * k]
    return x.reshape(a, k, b, k, c, k).max(axis=(1, 3, 5))


class ShapeNetV2Contrastive(ShapeNetV2VoxelDataset):
    """ShapeNetV2 voxels + a pre-materialized augmented low-res pair
    (shapenet_v2.py:58-104 ShapeNetV2_Contrastive).

    Reference semantics mirrored: at construction, every sample that lacks a
    sibling `<name>.npy` gets one — the binvox grid is affine-augmented
    (falling back to the clean grid when augmentation fails), then 4x
    max-pooled (128^3 -> 32^3) and saved as int. __getitem__ then returns the
    clean full-res 'voxel' plus the cached low-res 'contrastive'. Files are
    only ever *created* (existing .npy are kept, like the reference's
    os.path.exists skip), so the expensive augmentation runs once per tree.
    """

    def __init__(self, data_root: str, idx2cls: dict[int, str],
                 pool: int = 4, rng: np.random.RandomState | None = None):
        from . import voxel_augment

        super().__init__(data_root, idx2cls)
        self.rng = rng if rng is not None else np.random.RandomState()
        created = 0
        for path in self.samples:
            if os.path.exists(path + ".npy"):
                continue
            try:
                with open(path, "rb") as f:
                    vox = voxel_augment.add_affine_transformation_to_voxel(
                        f, rng=self.rng
                    ).data
                created += 1
            except Exception:
                with open(path, "rb") as f:
                    vox = binvox.read_as_3d_array(f).data
            small = _maxpool3d_np(vox.astype(np.float32), pool).astype(np.int32)
            with open(path + ".npy", "wb") as out:
                np.save(out, small)
        self.created = created

    def __getitem__(self, idx: int):
        sample = super().__getitem__(idx)
        del sample["model_id"]  # reference's contrastive dict omits it (:100)
        sample["contrastive"] = np.load(self.samples[idx] + ".npy")
        return sample


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


class S3DISWholeScene:
    """Sliding-window whole-scene eval blocks (s3dis.py:85-171,
    ScannetDatasetWholeScene): per room, overlapping block_size windows at
    `stride`, each padded/shuffled to multiples of block_points; returns
    (data [M, block_points, 9], labels, sample_weight, point indices) so
    predictions can be scattered back onto the full room cloud."""

    def __init__(self, root: str, block_points: int = 4096, split: str = "test",
                 test_area: int = 5, stride: float = 0.5, block_size: float = 1.0,
                 padding: float = 0.001,
                 rng: np.random.RandomState | None = None):
        self.block_points = block_points
        self.block_size = block_size
        self.stride = stride
        self.padding = padding
        self.rng = rng if rng is not None else np.random.RandomState()
        tag = f"Area_{test_area}"
        files = sorted(f for f in os.listdir(root) if f.endswith(".npy"))
        files = [f for f in files if (tag in f) == (split == "test")]
        self.scene_points_list, self.semantic_labels_list = [], []
        labelweights = np.zeros(13)
        for f in files:
            data = np.load(os.path.join(root, f))
            self.scene_points_list.append(data[:, :6])
            self.semantic_labels_list.append(data[:, 6])
            hist, _ = np.histogram(data[:, 6], range(14))
            labelweights += hist
        labelweights = labelweights / labelweights.sum()
        self.labelweights = np.power(
            np.amax(labelweights) / np.maximum(labelweights, 1e-12), 1 / 3.0
        ).astype(np.float32)

    def __len__(self):
        return len(self.scene_points_list)

    def __getitem__(self, index: int):
        points = self.scene_points_list[index]
        labels = self.semantic_labels_list[index]
        cmin = np.amin(points[:, :3], axis=0)
        cmax = np.amax(points[:, :3], axis=0)
        bs, st = self.block_size, self.stride
        gx = int(np.ceil((cmax[0] - cmin[0] - bs) / st) + 1)
        gy = int(np.ceil((cmax[1] - cmin[1] - bs) / st) + 1)
        datas, lbls, weights, idxs = [], [], [], []
        for iy in range(gy):
            for ix in range(gx):
                e_x = min(cmin[0] + ix * st + bs, cmax[0])
                s_x = e_x - bs
                e_y = min(cmin[1] + iy * st + bs, cmax[1])
                s_y = e_y - bs
                sel = np.where(
                    (points[:, 0] >= s_x - self.padding)
                    & (points[:, 0] <= e_x + self.padding)
                    & (points[:, 1] >= s_y - self.padding)
                    & (points[:, 1] <= e_y + self.padding)
                )[0]
                if sel.size == 0:
                    continue
                n_batch = int(np.ceil(sel.size / self.block_points))
                size = n_batch * self.block_points
                extra = self.rng.choice(
                    sel, size - sel.size, replace=size - sel.size > sel.size
                )
                sel = np.concatenate([sel, extra])
                self.rng.shuffle(sel)
                block = points[sel].copy()
                norm = np.zeros((size, 3))
                norm[:, 0] = block[:, 0] / cmax[0]
                norm[:, 1] = block[:, 1] / cmax[1]
                norm[:, 2] = block[:, 2] / cmax[2]
                block[:, 0] -= s_x + bs / 2.0
                block[:, 1] -= s_y + bs / 2.0
                block[:, 3:6] /= 255.0
                datas.append(np.concatenate([block, norm], axis=1))
                lab = labels[sel].astype(int)
                lbls.append(lab)
                weights.append(self.labelweights[lab])
                idxs.append(sel)
        data_room = np.concatenate(datas).reshape(-1, self.block_points, 9)
        label_room = np.concatenate(lbls).reshape(-1, self.block_points)
        weight_room = np.concatenate(weights).reshape(-1, self.block_points)
        index_room = np.concatenate(idxs).reshape(-1, self.block_points)
        return data_room, label_room, weight_room, index_room


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


# --- ScanObjectNN h5 variants (reference data/__init__.py:185-275) ---------
# Epoch-wise samplers: one shared point-subset permutation for the whole
# split, then a cloud-order shuffle. Randomness is injectable (rng=None uses
# the global numpy state, matching the reference).


def _np_rng(rng):
    return np.random if rng is None else rng


def load_withmask_h5(path: str):
    """(data, label, mask) from an h5 with part masks (:252-259)."""
    return load_h5(path, keys=("data", "label", "mask"))


def load_parts_h5(path: str):
    """(data, label, parts) (:268-275)."""
    return load_h5(path, keys=("data", "label", "parts"))


def load_discriminator_h5(path: str):
    """(data, label, model_type) (:261-266)."""
    return load_h5(path, keys=("data", "label", "type"))


def get_current_data_h5(pcs, labels, num_points: int, rng=None):
    """Sample num_points per cloud (one shared permutation) + shuffle clouds
    (:169-184)."""
    r = _np_rng(rng)
    idx_pts = np.arange(pcs.shape[1])
    r.shuffle(idx_pts)
    sampled = pcs[:, idx_pts[:num_points], :]
    idx = np.arange(len(labels))
    r.shuffle(idx)
    return sampled[idx], labels[idx]


def get_current_data_withmask_h5(pcs, labels, masks, num_points: int,
                                 shuffle: bool = True, rng=None):
    """Like get_current_data_h5 but carries per-point masks; shuffle=False
    gives the deterministic eval order (:186-209)."""
    r = _np_rng(rng)
    idx_pts = np.arange(pcs.shape[1])
    if shuffle:
        r.shuffle(idx_pts)
    sampled = pcs[:, idx_pts[:num_points], :]
    sampled_mask = masks[:, idx_pts[:num_points]]
    idx = np.arange(len(labels))
    if shuffle:
        r.shuffle(idx)
    return sampled[idx], labels[idx], sampled_mask[idx]


def get_current_data_parts_h5(pcs, labels, parts, num_points: int, rng=None):
    """Carries per-point part ids (:211-228)."""
    r = _np_rng(rng)
    idx_pts = np.arange(pcs.shape[1])
    r.shuffle(idx_pts)
    sampled = pcs[:, idx_pts[:num_points], :]
    sampled_parts = parts[:, idx_pts[:num_points]]
    idx = np.arange(len(labels))
    r.shuffle(idx)
    return sampled[idx], labels[idx], sampled_parts[idx]


def get_current_data_discriminator_h5(pcs, labels, types, num_points: int,
                                      rng=None):
    """Carries per-cloud real/synthetic type tags. NOTE the reference indexes
    `types[idx]` with the cloud shuffle but does NOT point-subsample it
    (types are per-cloud, :230-246) — same here."""
    r = _np_rng(rng)
    idx_pts = np.arange(pcs.shape[1])
    r.shuffle(idx_pts)
    sampled = pcs[:, idx_pts[:num_points], :]
    idx = np.arange(len(labels))
    r.shuffle(idx)
    return sampled[idx], labels[idx], types[idx]


def convert_to_binary_mask(masks):
    """Background (-1) -> 0, everything else -> 1 (:278-288)."""
    return (np.asarray(masks) != -1).astype(np.float64)


def flip_types(types):
    """Invert the real/synthetic tag (:290-292)."""
    return np.asarray(types) == 0


class BatchPointCloudLoader:
    """Epoch/batch-oriented point-cloud loader with built-in augmentation.

    The reference's data/modelnet_pointcloud.py (ModelNetDataset's
    next_batch/_augment_batch_data surface, used by older training scripts).
    Wraps any (points [N,P,C], labels [N]) arrays; `next_batch(augment=True)`
    applies the rotate/scale/shift/jitter/dropout pipeline from data.augment.
    """

    def __init__(self, points: np.ndarray, labels: np.ndarray,
                 batch_size: int = 32, shuffle: bool = True,
                 normal_channel: bool = False,
                 rng: np.random.RandomState | None = None):
        self.points = points
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.normal_channel = normal_channel
        self.rng = rng if rng is not None else np.random.RandomState()
        self.reset()

    def reset(self):
        self.idx = 0
        self.order = (self.rng.permutation(len(self.points)) if self.shuffle
                      else np.arange(len(self.points)))

    def has_next_batch(self) -> bool:
        return self.idx < len(self.points)

    def num_batches(self) -> int:
        return int(np.ceil(len(self.points) / self.batch_size))

    def _augment_batch_data(self, batch: np.ndarray) -> np.ndarray:
        from . import augment

        if self.normal_channel:
            rotated = augment.rotate_point_cloud_with_normal(batch, rng=self.rng)
        else:
            rotated = augment.rotate_point_cloud(batch[:, :, :3], rng=self.rng)
            rotated = np.concatenate([rotated, batch[:, :, 3:]], axis=-1)
        xyz = rotated[:, :, :3]
        xyz = augment.random_scale_point_cloud(xyz, rng=self.rng)
        xyz = augment.shift_point_cloud(xyz, rng=self.rng)
        xyz = augment.jitter_point_cloud(xyz, rng=self.rng)
        rotated[:, :, :3] = xyz
        return augment.random_point_dropout(rotated, rng=self.rng)

    def next_batch(self, augment: bool = False):
        sel = self.order[self.idx : self.idx + self.batch_size]
        self.idx += self.batch_size
        batch = self.points[sel].copy()
        if augment:
            batch = self._augment_batch_data(batch)
        return batch, self.labels[sel]


# --- ScanObjectNN raw-bin utilities (reference data/__init__.py:14-161) ----
# The reference vendors these from the ScanObjectNN repo; plyfile / pc_util
# are not importable there (latent module-level breakage this rebuild does
# not replicate). save_ply here writes binary-little-endian PLY with the
# same vertex property layout without the plyfile dependency.


def save_ply(points, filename, colors=None, normals=None):
    """Write [N,3] points (+optional [N,3] normals / [N,3] colors in [0,1])
    as a binary PLY (reference data/__init__.py:14-46)."""
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    cols = [np.asarray(points, dtype=np.float32)]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        cols.append(np.asarray(normals, dtype=np.float32))
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols.append((np.asarray(colors) * 255).astype(np.uint8))
    rec = np.empty(n, dtype=fields)
    for arr, names in zip(cols, (fields[0:3], fields[3:6], fields[-3:])):
        for j, (name, _) in enumerate(names):
            rec[name] = arr[:, j]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property {'uchar' if f == 'u1' else 'float'} {name}"
               for name, f in fields]
    header.append("end_header\n")
    with open(filename, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def read_ply(filename):
    """Read back a save_ply file -> dict of property -> [N] array."""
    with open(filename, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(x for x in header if x.startswith("element vertex")
                     ).split()[-1])
        fields = [(x.split()[2], "<f4" if x.split()[1] == "float" else "u1")
                  for x in header if x.startswith("property")]
        rec = np.frombuffer(f.read(), dtype=fields, count=n)
    return {name: rec[name] for name, _ in fields}


def load_pc_file(path, suncg: bool = False, with_bg: bool = True):
    """Raw ScanObjectNN .bin object -> [N,3] xyz
    (reference data/__init__.py:48-73: float32 stream = count then rows of
    x,y,z,nx,ny,nz,r,g,b,label,nyu_label; with_bg=False keeps the largest
    non-{0,1,2} nyu class)."""
    pc = np.fromfile(path, dtype=np.float32)
    pc = pc[1:].reshape(-1, 3 if suncg else 11)
    if with_bg or suncg:
        return np.array(pc[:, 0:3])
    keep = pc[:, -1] > 2
    values, counts = np.unique(pc[keep, -1], return_counts=True)
    major = values[np.argmax(counts)]
    return np.array(pc[pc[:, -1] == major, 0:3])


def load_pc_data(index_pickle, bin_dir, num_points: int = 1024,
                 suncg: bool = False, with_bg: bool = True):
    """Pickle-index variant of the h5 loaders (data/__init__.py:75-99):
    each entry names a .bin file; objects with < num_points are dropped."""
    import pickle

    with open(index_pickle, "rb") as handle:
        entries = pickle.load(handle)
    pcs, labels = [], []
    for entry in entries:
        name = entry["filename"].replace("objects_bin/", "")
        pc = load_pc_file(os.path.join(bin_dir, name), suncg=suncg,
                          with_bg=with_bg)
        if pc.shape[0] < num_points:
            continue
        pcs.append(pc)
        labels.append(entry["label"])
    return pcs, labels


def get_current_data(pcs, labels, num_points: int, rng=None):
    """Per-epoch resample of VARIABLE-SIZE clouds (data/__init__.py:106-129);
    unlike the h5 variant each cloud gets its own subset permutation."""
    r = _np_rng(rng)
    sampled = []
    for pc in pcs:
        if pc.shape[0] < num_points:
            raise ValueError(f"cloud has {pc.shape[0]} < {num_points} points")
        idx = np.arange(pc.shape[0])
        r.shuffle(idx)
        sampled.append(pc[idx[:num_points], :])
    sampled = np.array(sampled)
    labels = np.array(labels)
    order = np.arange(len(labels))
    r.shuffle(order)
    return sampled[order], labels[order]


def normalize_pcs(pcs):
    """In-place unit-sphere scale per cloud (data/__init__.py:131-141)."""
    for pc in pcs:
        pc /= np.max(np.sqrt(np.sum(pc ** 2, axis=-1)))
    return pcs


def center_pcs(pcs):
    """In-place centroid centering (data/__init__.py:159-166, SUNCG)."""
    for pc in pcs:
        pc -= np.mean(pc, axis=0)
    return pcs


def normalize_pcs_multiview(pcs, num_view: int = 5):
    """Per-view unit-sphere scale for [B, V, N, 3] multiview clouds
    (data/__init__.py:144-157)."""
    out = np.array([[view / np.max(np.sqrt(np.sum(view ** 2, axis=-1)))
                     for view in pc[:num_view]] for pc in pcs])
    return out
