"""Synthetic voxel grids (the same stream as simple3dformer_tpu.data.datasets.synthetic_voxels).

Kept in the port so that its serving path and chip_smoke.py import nothing of
the JAX package; a test holds the two functions to equal outputs.
"""

from __future__ import annotations

import numpy as np


def synthetic_voxels(n: int, voxel_size: int, n_classes: int, seed: int = 9):
    """n random occupancy grids (uint8, ~15% filled) and labels (int32)."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, voxel_size, voxel_size, voxel_size) > 0.85).astype(np.uint8)
    y = rng.randint(0, n_classes, size=(n,)).astype(np.int32)
    return x, y
