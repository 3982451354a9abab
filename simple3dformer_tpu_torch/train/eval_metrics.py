"""Evaluation metrics with the reference's conventions (port of
ClassificationMeter and the ShapeNetPart pieces of
simple3dformer_tpu/train/eval_metrics.py).

  * Overall and mean-class accuracy (the reference's train_cls_voxel.py:300-329).
  * ShapeNetPart: category-restricted argmax (train_partseg.py:181-184),
    per-shape part IoU with "absent part counts as IoU 1.0"
    (train_partseg.py:194-206), class-avg and instance-avg mIoU.

Small host-side reductions over predictions fetched from the device.
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


# ShapeNetPart taxonomy (the reference's train_partseg.py seg_classes; the
# same map is in its data/shapenet_part_seg.py:74-78).
SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3], "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}
SEG_LABEL_TO_CAT = {label: cat for cat, labels in SEG_CLASSES.items() for label in labels}


def category_restricted_argmax(logits: np.ndarray, category: str) -> np.ndarray:
    """Argmax over only the parts of the shape's category (train_partseg.py:181-184)."""
    parts = SEG_CLASSES[category]
    return np.asarray(parts)[np.argmax(logits[..., parts], axis=-1)]


class PartSegMeter:
    """ShapeNetPart accuracy, class-avg mIoU and instance-avg mIoU."""

    def __init__(self):
        self.correct = 0
        self.seen = 0
        self.shape_ious: dict[str, list[float]] = {c: [] for c in SEG_CLASSES}

    def update(self, logits: np.ndarray, target: np.ndarray) -> None:
        """logits: [B, N, 50]; target: [B, N] ground-truth part labels."""
        B, N, _ = logits.shape
        for b in range(B):
            cat = SEG_LABEL_TO_CAT[int(target[b, 0])]
            pred = category_restricted_argmax(logits[b], cat)
            self.correct += int((pred == target[b]).sum())
            self.seen += N
            part_ious = []
            for part in SEG_CLASSES[cat]:
                gt = target[b] == part
                pd = pred == part
                union = np.sum(gt | pd)
                if union == 0:
                    part_ious.append(1.0)  # absent part counts as IoU 1.0
                else:
                    part_ious.append(float(np.sum(gt & pd) / union))
            self.shape_ious[cat].append(float(np.mean(part_ious)))

    @property
    def accuracy(self) -> float:
        return self.correct / self.seen if self.seen else 0.0

    @property
    def class_avg_iou(self) -> float:
        cat_means = [np.mean(v) for v in self.shape_ious.values() if v]
        return float(np.mean(cat_means)) if cat_means else 0.0

    @property
    def instance_avg_iou(self) -> float:
        all_ious = [x for v in self.shape_ious.values() for x in v]
        return float(np.mean(all_ious)) if all_ious else 0.0
