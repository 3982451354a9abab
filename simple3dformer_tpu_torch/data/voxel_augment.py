"""Voxel affine augmentation (port of simple3dformer_tpu/data/voxel_augment.py;
the reference's utils/data_augmentation.py).

Coords -> world space, random rotation (angle <= 0.2*pi about a random axis),
uniform scale in [0.9, 1.1], translation of +-0.1*scale, three jittered copies
(+-0.01*scale), re-voxelize with boundary clipping after shifting the index
range back into the grid: vectorised numpy on the host (the axis-angle
rotation matrix by the Rodrigues formula). The draws come from the caller's
``np.random.RandomState`` in the JAX function's order, so the same state and
the same file give the same grid.
"""

from __future__ import annotations

import numpy as np

from . import binvox


def rotvec_to_matrix(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues formula: axis-angle vector -> rotation matrix."""
    theta = np.linalg.norm(rotvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rotvec / theta
    K = np.array([
        [0, -k[2], k[1]],
        [k[2], 0, -k[0]],
        [-k[1], k[0], 0],
    ])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def add_affine_transformation_to_voxel(
    fp, fix_coords: bool = True, rng: np.random.RandomState | None = None
) -> binvox.Voxels:
    """Read a binvox stream and return an affine-augmented Voxels model."""
    rng = rng if rng is not None else np.random
    vox = binvox.read_as_coord_array(fp, fix_coords=fix_coords)
    dims = np.array(vox.dims)
    coords = (vox.data.astype(np.float64) + 0.5) / dims[:, None]
    coords = vox.scale * coords + np.array(vox.translate)[:, None]

    translation = rng.uniform(-0.1, 0.1, 3) * vox.scale
    omega = np.pi * rng.uniform(0, 0.2)
    rotvec = rng.rand(3)
    rotvec = rotvec / np.linalg.norm(rotvec)
    rotation = rotvec_to_matrix(omega * rotvec)
    scaling = rng.uniform(0.9, 1.1)

    copies = [coords]
    for _ in range(2):  # two jittered copies (reference makes 3 total)
        jitter = rng.uniform(-0.01, 0.01, 3)[:, None] * vox.scale
        copies.append(coords + jitter)
    new_coords = np.hstack([
        scaling * rotation @ c + translation[:, None] for c in copies
    ])

    convert = (new_coords - np.array(vox.translate)[:, None]) / vox.scale
    indices = convert * dims[:, None] - 0.5
    min_idx = indices.min()
    if min_idx < 0:
        indices = indices - min_idx
    max_idx = indices.max()
    if max_idx >= vox.dims[0]:
        indices = indices + vox.dims[0] - max_idx

    idx = indices.astype(int)
    valid = np.all((idx >= 0) & (idx < dims[:, None]), axis=0)
    idx = idx[:, valid]
    new_vox = np.zeros(vox.dims, dtype=int)
    new_vox[idx[0], idx[1], idx[2]] = 1
    vox.data = new_vox
    return vox
