"""On-device point-cloud augmentations (port of device_random_point_dropout,
device_random_scale, device_shift and device_cls_augment from
simple3dformer_tpu/data/augment.py:149-199; the reference's provider.py).

Each draws from an explicit ``torch.Generator`` on the data's device, so the
numbers differ from the JAX package's keys; the distributions are the same.
The draws are the global batch's, cut to this rank's rows (core/rng.rand).
"""

from __future__ import annotations

import torch

from ..core import rng


def _uniform(generator: torch.Generator, shape, low: float, high: float,
             like: torch.Tensor) -> torch.Tensor:
    u = rng.rand(shape, generator)
    return (low + (high - low) * u).to(like.device, like.dtype)


def device_random_scale(generator: torch.Generator, xyz: torch.Tensor, scale_low: float = 0.8,
                        scale_high: float = 1.25) -> torch.Tensor:
    """One uniform scale in [scale_low, scale_high) per sample. xyz [B, N, 3]."""
    return xyz * _uniform(generator, (xyz.shape[0], 1, 1), scale_low, scale_high, xyz)


def device_shift(generator: torch.Generator, xyz: torch.Tensor,
                 shift_range: float = 0.1) -> torch.Tensor:
    """One uniform shift in [-shift_range, shift_range) per sample and axis."""
    return xyz + _uniform(generator, (xyz.shape[0], 1, 3), -shift_range, shift_range, xyz)


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
