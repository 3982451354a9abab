"""Point-cloud batch augmentations (port of simple3dformer_tpu/data/augment.py;
the reference's provider.py).

Host (numpy) versions keep provider.py's semantics exactly, random
conventions included: per-sample uniform angles and scales, dropped points
replaced by the sample's first point, jitter clipped. Each draws from the
caller's ``np.random.RandomState`` (or numpy's global state) in the JAX
function's order, so the same state gives the same arrays.

On-device versions (``device_*``) run inside the train step on the data's
device. Each draws from an explicit ``torch.Generator``, so the numbers
differ from the JAX package's keys; the distributions are the same. The
draws are the global batch's, cut to this rank's rows (core/rng.rand).
The host functions' ``rng`` argument is a numpy state, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng as core_rng

# --------------------------------------------------------------------------
# numpy (host) versions: provider.py parity
# --------------------------------------------------------------------------


def normalize_data(batch: np.ndarray) -> np.ndarray:
    """Center each cloud and scale to the unit sphere (provider.py:3-19)."""
    out = np.zeros_like(batch)
    for b in range(batch.shape[0]):
        pc = batch[b]
        pc = pc - np.mean(pc, axis=0)
        m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
        out[b] = pc / m
    return out


def shuffle_data(data: np.ndarray, labels: np.ndarray, rng=np.random):
    idx = np.arange(len(labels))
    rng.shuffle(idx)
    return data[idx], labels[idx], idx


def shuffle_points(batch: np.ndarray, rng=np.random) -> np.ndarray:
    idx = np.arange(batch.shape[1])
    rng.shuffle(idx)
    return batch[:, idx, :]


def _roty(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rotz(angle: float) -> np.ndarray:
    # reference layout (provider.py:79-81): [[c, s, 0], [-s, c, 0], [0, 0, 1]]
    # — applied as points @ R, this rotates by -angle; distributionally
    # identical for angle ~ U[0, 2pi) but kept exact for parity.
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def rotate_point_cloud(batch: np.ndarray, rng=np.random) -> np.ndarray:
    """Random rotation about the (up) Y axis, per sample (provider.py:46-63)."""
    out = np.zeros_like(batch)
    for b in range(batch.shape[0]):
        R = _roty(rng.uniform() * 2 * np.pi)
        out[b] = batch[b].reshape(-1, 3) @ R
    return out


def rotate_point_cloud_z(batch: np.ndarray, rng=np.random) -> np.ndarray:
    out = np.zeros_like(batch)
    for b in range(batch.shape[0]):
        R = _rotz(rng.uniform() * 2 * np.pi)
        out[b] = batch[b].reshape(-1, 3) @ R
    return out


def rotate_point_cloud_with_normal(batch: np.ndarray, rng=np.random) -> np.ndarray:
    """xyz + normal channels both rotated (provider.py:65-85)."""
    out = np.zeros_like(batch)
    for b in range(batch.shape[0]):
        R = _roty(rng.uniform() * 2 * np.pi)
        out[b, :, 0:3] = batch[b, :, 0:3] @ R
        out[b, :, 3:6] = batch[b, :, 3:6] @ R
    return out


def rotate_point_cloud_by_angle(batch: np.ndarray, angle: float) -> np.ndarray:
    out = np.zeros_like(batch)
    R = _roty(angle)
    for b in range(batch.shape[0]):
        out[b] = batch[b].reshape(-1, 3) @ R
    return out


def rotate_perturbation_point_cloud(
    batch: np.ndarray, angle_sigma=0.06, angle_clip=0.18, rng=np.random
) -> np.ndarray:
    """Small random rotations about all three axes (provider.py:176-198)."""
    out = np.zeros_like(batch)
    for b in range(batch.shape[0]):
        a = np.clip(angle_sigma * rng.randn(3), -angle_clip, angle_clip)
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                       [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]])
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                       [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]])
        # reference applies pc @ (Rz Ry Rx) with NO transpose (provider.py:195-197)
        out[b] = batch[b].reshape(-1, 3) @ (Rz @ Ry @ Rx)
    return out


def jitter_point_cloud(batch, sigma=0.01, clip=0.05, rng=np.random):
    jitter = np.clip(sigma * rng.randn(*batch.shape), -clip, clip)
    return batch + jitter


def shift_point_cloud(batch, shift_range=0.1, rng=np.random):
    B = batch.shape[0]
    shifts = rng.uniform(-shift_range, shift_range, (B, 3))
    return batch + shifts[:, None, :]


def random_scale_point_cloud(batch, scale_low=0.8, scale_high=1.25, rng=np.random):
    B = batch.shape[0]
    scales = rng.uniform(scale_low, scale_high, B)
    return batch * scales[:, None, None]


def random_point_dropout(batch, max_dropout_ratio=0.875, rng=np.random):
    """Per sample: drop a random fraction of points, replacing them with the
    first point (provider.py:241-250)."""
    out = batch.copy()
    for b in range(batch.shape[0]):
        ratio = rng.random() * max_dropout_ratio
        drop = np.where(rng.random(batch.shape[1]) <= ratio)[0]
        if len(drop) > 0:
            out[b, drop, :] = out[b, 0, :]
    return out


# --------------------------------------------------------------------------
# torch (device) versions
# --------------------------------------------------------------------------


def _uniform(generator: torch.Generator, shape, low: float, high: float,
             like: torch.Tensor) -> torch.Tensor:
    u = core_rng.rand(shape, generator)
    return (low + (high - low) * u).to(like.device, like.dtype)


def device_random_scale(generator: torch.Generator, xyz: torch.Tensor, scale_low: float = 0.8,
                        scale_high: float = 1.25) -> torch.Tensor:
    """One uniform scale in [scale_low, scale_high) per sample. xyz [B, N, 3]."""
    return xyz * _uniform(generator, (xyz.shape[0], 1, 1), scale_low, scale_high, xyz)


def device_shift(generator: torch.Generator, xyz: torch.Tensor,
                 shift_range: float = 0.1) -> torch.Tensor:
    """One uniform shift in [-shift_range, shift_range) per sample and axis."""
    return xyz + _uniform(generator, (xyz.shape[0], 1, 3), -shift_range, shift_range, xyz)


def device_jitter(generator: torch.Generator, xyz: torch.Tensor, sigma: float = 0.01,
                  clip: float = 0.05) -> torch.Tensor:
    """Gaussian noise of std ``sigma``, clipped to [-clip, clip], per coordinate."""
    noise = core_rng.randn(tuple(xyz.shape), generator).to(xyz.device, xyz.dtype)
    return xyz + torch.clamp(sigma * noise, -clip, clip)


def device_rotate_y(generator: torch.Generator, xyz: torch.Tensor) -> torch.Tensor:
    """A uniform rotation angle in [0, 2 pi) about the up (Y) axis a sample,
    applied as points @ R with provider.py's R. xyz [B, N, 3]."""
    ang = _uniform(generator, (xyz.shape[0],), 0.0, 2 * torch.pi, xyz)
    c, s = torch.cos(ang), torch.sin(ang)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], dim=-1)
    return torch.einsum("bnc,bcd->bnd", xyz, rot.reshape(-1, 3, 3))


def device_random_point_dropout(generator: torch.Generator, batch: torch.Tensor,
                                max_dropout_ratio: float = 0.875) -> torch.Tensor:
    """Per sample a ratio in [0, max_dropout_ratio); each point whose uniform
    draw is <= that ratio is replaced by the sample's first point. [B, N, C]."""
    b, n = batch.shape[:2]
    ratio = _uniform(generator, (b, 1), 0.0, max_dropout_ratio, batch)
    drop = _uniform(generator, (b, n), 0.0, 1.0, batch) <= ratio
    return torch.where(drop[..., None], batch[:, :1, :], batch)


def device_cls_augment(generator: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """The train_cls recipe (the reference's train_cls.py:110-112): point
    dropout, then a scale and a shift of xyz; the other channels (normals) are
    dropped with their points and otherwise kept. points [B, N, C >= 3]."""
    points = device_random_point_dropout(generator, points)
    xyz = device_shift(generator, device_random_scale(generator, points[..., :3]))
    return torch.cat([xyz, points[..., 3:]], dim=-1)
