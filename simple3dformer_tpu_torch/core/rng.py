"""Deterministic RNG plumbing (port of simple3dformer_tpu/core/rng.py).

The reference pins ``manualSeed = 9`` (its train_cls_voxel.py:383).
Init draws from an explicit CPU ``torch.Generator``, so one integer gives the
same weights on any device. torch and jax give different numbers from one
seed: tests that compare the two make their inputs with numpy.

Draws for the global batch: every random draw of a training step (the
augmentations, dropout and drop-path masks, the FPS start points, the LwF
crop boxes and flips) goes through ``rand`` / ``randint``, which under a
data-parallel split (parallel/mesh.data_split) draw the global batch's
numbers on every rank, from the same generator state, and keep this rank's
rows. So a run at world size n draws what a run at world size 1 draws.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import current_split

DEFAULT_SEED = 9


def generator(seed: int = DEFAULT_SEED) -> torch.Generator:
    """A CPU generator seeded with ``seed``, for parameter init."""
    return torch.Generator().manual_seed(seed)


def step_seed(seed: int, step: int) -> int:
    """The seed of optimizer step ``step``'s draws in a run seeded with ``seed``,
    as the JAX step folds ``state.step`` into its key: a function of the two
    only, so a run resumed from a checkpoint (which restores the step) draws
    what an unbroken run draws at the same step."""
    return (seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)


class DeviceGenerators(dict):
    """One ``torch.Generator`` a device (keyed by name), each seeded with
    ``seed`` on first use there: dropout masks drawn on the card from it copy
    nothing from the host."""

    def __init__(self, seed: int):
        super().__init__()
        self.seed = seed

    def __call__(self, device: torch.device) -> torch.Generator:
        key = str(device)
        if key not in self:
            self[key] = torch.Generator(device=device).manual_seed(self.seed)
        return self[key]


def _rank_part(draw, shape, axis: int) -> torch.Tensor:
    parts, index = current_split()
    if parts == 1:
        return draw(tuple(shape))
    shape = list(shape)
    local = shape[axis]
    shape[axis] = local * parts
    return draw(tuple(shape)).narrow(axis, index * local, local)


def rand(shape, generator: torch.Generator, device=None, axis: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` whose ``axis`` runs over this rank's rows of the
    global batch: the global draw, cut to this rank's part. Rows are samples
    batch-major (a [B * groups] axis holds sample b's groups at b * groups ..).
    ``device`` defaults to the generator's."""
    device = generator.device if device is None else device
    return _rank_part(lambda s: torch.rand(s, generator=generator, device=device), shape, axis)


def randint(low: int, high: int, shape, generator: torch.Generator, device=None,
            axis: int = 0) -> torch.Tensor:
    """``torch.randint(low, high, shape)`` for this rank's rows, as ``rand``."""
    device = generator.device if device is None else device
    return _rank_part(lambda s: torch.randint(low, high, s, generator=generator, device=device),
                      shape, axis)


def randn(shape, generator: torch.Generator, device=None, axis: int = 0) -> torch.Tensor:
    """``torch.randn(shape)`` for this rank's rows, as ``rand``."""
    device = generator.device if device is None else device
    return _rank_part(lambda s: torch.randn(s, generator=generator, device=device), shape, axis)
