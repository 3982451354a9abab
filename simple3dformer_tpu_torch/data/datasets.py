"""Voxel dataset readers (port of ModelNetVoxelDataset and ShapeNetV2VoxelDataset
from simple3dformer_tpu/data/datasets.py, numpy path).

Python classes with __len__/__getitem__ mirroring the reference's torch
Datasets (data/modelnet40.py, modelnet10.py, shapenet_v2.py); samples come
back as numpy. Training does not read per item: ``materialize`` decodes a
split into one uint8 array, which data/pipeline.DeviceResidentDataset puts
on the device once.
"""

from __future__ import annotations

import glob
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
