"""Deterministic RNG plumbing (port of simple3dformer_tpu/core/rng.py).

The reference pins ``manualSeed = 9`` (its train_cls_voxel.py:383).
Init draws from an explicit CPU ``torch.Generator``, so one integer gives the
same weights on any device. torch and jax give different numbers from one
seed: tests that compare the two make their inputs with numpy.
"""

from __future__ import annotations

import torch

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
