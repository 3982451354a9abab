"""Evaluation metrics with the reference's conventions (port of
ClassificationMeter, InstanceClassMeter, the ShapeNetPart pieces and
SemSegMeter of simple3dformer_tpu/train/eval_metrics.py).

  * Overall and mean-class accuracy (the reference's train_cls_voxel.py:300-329).
  * train_cls's instance accuracy (the mean of per-batch accuracies) and class
    accuracy (the mean over classes of per-batch class accuracies).
  * ShapeNetPart: category-restricted argmax (train_partseg.py:181-184),
    per-shape part IoU with "absent part counts as IoU 1.0"
    (train_partseg.py:194-206), class-avg and instance-avg mIoU.
  * S3DIS: point accuracy, mean class accuracy, global mIoU, and the
    reference's first-point class-avg / instance-avg IoU
    (train_s3dis_semseg.py:181-231).

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


class InstanceClassMeter:
    """train_cls.py's: per-batch instance accuracy, averaged, and per-class
    accuracy summed per batch and averaged over the batches that held the class."""

    def __init__(self, num_classes: int):
        self.class_acc = np.zeros((num_classes, 2), dtype=np.float64)
        self.mean_correct: list[float] = []

    def update(self, pred: np.ndarray, label: np.ndarray) -> None:
        pred = np.asarray(pred).reshape(-1)
        label = np.asarray(label).reshape(-1)
        for c in np.unique(label):
            sel = label == c
            self.class_acc[c, 0] += (pred[sel] == c).mean()
            self.class_acc[c, 1] += 1
        self.mean_correct.append(float((pred == label).mean()))

    @property
    def instance_accuracy(self) -> float:
        return float(np.mean(self.mean_correct)) if self.mean_correct else 0.0

    @property
    def class_accuracy(self) -> float:
        with np.errstate(invalid="ignore", divide="ignore"):
            per = self.class_acc[:, 0] / self.class_acc[:, 1]
        return float(np.nanmean(per))


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


class SemSegMeter:
    """S3DIS point accuracy / mean class accuracy / mIoU (13 classes).

    Two IoU conventions, both kept:
      * ``miou``: the global per-class IoU mean (what most S3DIS papers report);
      * ``class_avg_iou`` / ``instance_avg_iou``: the reference's own
        bookkeeping (train_s3dis_semseg.py:181,201-231). Every class is its own
        single-label category, a sample's category is its first point's label
        (:208), and the sample's IoU is that one class's; instance-avg averages
        over samples, class-avg over per-category means. The reference saves
        its best checkpoint on instance_avg_iou (:237). Per-sample tracking
        needs 2-D [B, N] updates; flat 1-D updates feed only the global counters.
    """

    def __init__(self, num_classes: int = 13):
        self.num_classes = num_classes
        self.total_seen = np.zeros(num_classes, dtype=np.int64)
        self.total_correct = np.zeros(num_classes, dtype=np.int64)
        self.total_union = np.zeros(num_classes, dtype=np.int64)
        self.shape_ious: dict[int, list[float]] = {c: [] for c in range(num_classes)}

    def update(self, pred: np.ndarray, label: np.ndarray) -> None:
        pred = np.asarray(pred)
        label = np.asarray(label)
        if pred.ndim >= 2:
            p2 = pred.reshape(-1, pred.shape[-1])
            l2 = label.reshape(-1, label.shape[-1])
            for i in range(p2.shape[0]):
                c = int(l2[i, 0])  # category := the first point's label (:208)
                gt = l2[i] == c
                pd = p2[i] == c
                union = int((gt | pd).sum())
                # the reference's absent-part branch (:210-212): IoU 1.0
                iou = 1.0 if union == 0 else float((gt & pd).sum()) / union
                self.shape_ious[c].append(iou)
        pred = pred.reshape(-1)
        label = label.reshape(-1)
        for c in range(self.num_classes):
            gt = label == c
            pd = pred == c
            self.total_seen[c] += int(gt.sum())
            self.total_correct[c] += int((gt & pd).sum())
            self.total_union[c] += int((gt | pd).sum())

    @property
    def class_avg_iou(self) -> float:
        means = [np.mean(v) for v in self.shape_ious.values() if v]
        return float(np.mean(means)) if means else 0.0

    @property
    def instance_avg_iou(self) -> float:
        alls = [i for v in self.shape_ious.values() for i in v]
        return float(np.mean(alls)) if alls else 0.0

    @property
    def accuracy(self) -> float:
        seen = self.total_seen.sum()
        return float(self.total_correct.sum() / seen) if seen else 0.0

    @property
    def mean_class_accuracy(self) -> float:
        with np.errstate(invalid="ignore", divide="ignore"):
            per = self.total_correct / self.total_seen
        return float(np.nanmean(per))

    @property
    def miou(self) -> float:
        with np.errstate(invalid="ignore", divide="ignore"):
            per = self.total_correct / self.total_union
        return float(np.nanmean(per))
