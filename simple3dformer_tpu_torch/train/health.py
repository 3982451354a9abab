"""Training health check (port of check_finite from simple3dformer_tpu/train/health.py).

Explicit non-finite-loss detection over an epoch's per-step metrics, with a
diagnosis, instead of training on silently.
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
