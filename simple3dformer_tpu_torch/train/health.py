"""Training health checks (port of simple3dformer_tpu/train/health.py).

Explicit non-finite-loss detection over an epoch's per-step metrics, with a
diagnosis, instead of training on silently; ``DivergenceGuard`` hands back the
last good state when an epoch diverges, a bounded number of times.
"""

from __future__ import annotations

import numpy as np


class TrainingDiverged(RuntimeError):
    pass


def check_finite(metrics: dict, epoch: int | None = None) -> None:
    """Raise TrainingDiverged if any metric holds non-finite values.

    Call on the host copy of an epoch's per-step metrics; reports which metric
    and which step within the epoch went bad.
    """
    for name, values in metrics.items():
        arr = np.asarray(values)
        bad = ~np.isfinite(arr)
        if bad.any():
            step = int(np.argmax(bad.reshape(arr.shape[0], -1).any(axis=-1)))
            where = f"epoch {epoch}, " if epoch is not None else ""
            raise TrainingDiverged(
                f"non-finite {name!r} at {where}step {step} "
                f"(first bad value: {arr.reshape(arr.shape[0], -1)[step][0]!r}). "
                "Common causes: learning rate too high for from-scratch ViT "
                "training (use ~3e-4), fp16/bf16 overflow in a custom loss."
            )


class DivergenceGuard:
    """Roll back to the last good state when an epoch diverges.

    Usage:
        guard = DivergenceGuard(max_rollbacks=2)
        state = guard.check(state, metrics, epoch, good_state=prev_state)
    """

    def __init__(self, max_rollbacks: int = 2):
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0

    def check(self, state, metrics: dict, epoch: int, good_state):
        try:
            check_finite(metrics, epoch)
            return state
        except TrainingDiverged:
            self.rollbacks += 1
            if self.rollbacks > self.max_rollbacks:
                raise
            print(f"[health] epoch {epoch} diverged; rolling back "
                  f"({self.rollbacks}/{self.max_rollbacks})")
            return good_state
