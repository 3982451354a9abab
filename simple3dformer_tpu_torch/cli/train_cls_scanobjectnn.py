"""ScanObjectNN classification trainer (port of
simple3dformer_tpu/cli/train_cls_scanobjectnn.py; the reference's
train_cls_scanobjectnn.py).

    python -m simple3dformer_tpu_torch.cli.train_cls_scanobjectnn synthetic=1024
    python -m simple3dformer_tpu_torch.cli.train_cls_scanobjectnn device=cpu synthetic=64 \\
        num_point=64 epoch=2 batch_size=16

The same ``key=value`` overrides over configs/cls_scanobjectnn.yaml (+
configs/model/<name>.yaml) and the same printed lines: the h5 main split
(``training_objectdataset_augmentedrot_scale75.h5`` and
``test_objectdataset_augmentedrot_scale75.h5`` under ``data_path``, 15
classes, each cloud cut to its first ``num_point`` points), xyz only
(``input_dim`` 3), and cli/train_cls.py's recipe (``ClsTrainer``: the model,
the optimizer block, the augmentation, StepLR, instance and class accuracy),
with a checkpoint at each best instance accuracy. ``synthetic=N`` (or
``--synthetic``, 512) trains on the JAX trainer's synthetic streams from
seeds ``seed`` and ``seed + 1``; reading the h5 files needs ``h5py``, which
the synthetic path does not. ``dtype=bf16`` is train_cls's.

It runs on the card (``device=cuda``, the default) and on the CPU only when
asked (``device=cpu``).
"""

from __future__ import annotations

import os

import torch

from ..core import checkpoint as ckpt_lib
from ..data import datasets
from ..parallel.mesh import print0
from . import _common as C
from .train_cls import ClsTrainer

NUM_CLASS = 15
TRAIN_H5 = "training_objectdataset_augmentedrot_scale75.h5"
TEST_H5 = "test_objectdataset_augmentedrot_scale75.h5"


def load_arrays(cfg):
    """((train x, y), (test x, y)) as numpy, synthetic or read from the h5 split."""
    npoint = int(cfg.num_point)
    if cfg.synthetic:
        tr = datasets.synthetic_points(int(cfg.synthetic), npoint, 3, NUM_CLASS,
                                       seed=int(cfg.seed))
        te = datasets.synthetic_points(max(int(cfg.synthetic) // 5, 64), npoint, 3, NUM_CLASS,
                                       seed=int(cfg.seed) + 1)
        return tr, te
    tr_x, tr_y = datasets.load_scanobjectnn_h5(os.path.join(cfg.data_path, TRAIN_H5))
    te_x, te_y = datasets.load_scanobjectnn_h5(os.path.join(cfg.data_path, TEST_H5))
    return (tr_x[:, :npoint], tr_y), (te_x[:, :npoint], te_y)


def main(argv=None):
    cfg, device = C.setup("cls_scanobjectnn", argv)
    cfg.num_class = NUM_CLASS
    cfg.input_dim = 3  # real scans: xyz only
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    train, test = load_arrays(cfg)
    print0(f"train {len(train[0])} / test {len(test[0])}")
    run = ClsTrainer(cfg, device, train, test, NUM_CLASS)
    ckpt = ckpt_lib.Checkpointer(f"{C.run_dir(cfg, 'cls_scanobjectnn')}/ckpt")

    best = 0.0
    for epoch in range(int(cfg.epoch)):
        _, rate = run.train_epoch(epoch)
        inst, cls_acc = run.evaluate()
        if inst >= best:
            best = inst
            ckpt.save(epoch, run.state.state_dict(), {"instance_acc": inst, "class_acc": cls_acc})
        print(f"Epoch {epoch + 1} Test Instance Accuracy: {inst:f}, "
              f"Class Accuracy: {cls_acc:f} ({rate})")
    print(f"Best Instance Accuracy: {best:f}")
    return best


if __name__ == "__main__":
    main()
