"""Classification metrics with the reference's conventions (port of
ClassificationMeter from simple3dformer_tpu/train/eval_metrics.py).

Overall and mean-class accuracy as the reference's train_cls_voxel.py:300-329
computes them: small host-side reductions over predictions fetched from the
device.
"""

from __future__ import annotations

import numpy as np


class ClassificationMeter:
    """Overall accuracy + mean per-class accuracy."""

    def __init__(self, num_classes: int):
        self.correct = np.zeros(num_classes, dtype=np.int64)
        self.total = np.zeros(num_classes, dtype=np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray) -> None:
        pred = np.asarray(pred).reshape(-1)
        label = np.asarray(label).reshape(-1)
        for c in np.unique(label):
            sel = label == c
            self.correct[c] += int((pred[sel] == c).sum())
            self.total[c] += int(sel.sum())

    @property
    def overall_accuracy(self) -> float:
        tot = self.total.sum()
        return float(self.correct.sum() / tot) if tot else 0.0

    @property
    def mean_class_accuracy(self) -> float:
        with np.errstate(invalid="ignore", divide="ignore"):
            per = self.correct / self.total
        return float(np.nansum(per) / len(self.total))
