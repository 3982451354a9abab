"""On-device point-cloud augmentations (port of device_random_scale and
device_shift from simple3dformer_tpu/data/augment.py:158-169; the reference's
provider.py).

Each draws from an explicit ``torch.Generator`` on the data's device, so the
numbers differ from the JAX package's keys; the distributions are the same.
"""

from __future__ import annotations

import torch


def _uniform(generator: torch.Generator, shape, low: float, high: float,
             like: torch.Tensor) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (low + (high - low) * u).to(like.device, like.dtype)


def device_random_scale(generator: torch.Generator, xyz: torch.Tensor, scale_low: float = 0.8,
                        scale_high: float = 1.25) -> torch.Tensor:
    """One uniform scale in [scale_low, scale_high) per sample. xyz [B, N, 3]."""
    return xyz * _uniform(generator, (xyz.shape[0], 1, 1), scale_low, scale_high, xyz)


def device_shift(generator: torch.Generator, xyz: torch.Tensor,
                 shift_range: float = 0.1) -> torch.Tensor:
    """One uniform shift in [-shift_range, shift_range) per sample and axis."""
    return xyz + _uniform(generator, (xyz.shape[0], 1, 3), -shift_range, shift_range, xyz)
