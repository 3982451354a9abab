"""ModelNet40 point-cloud classification trainer (port of
simple3dformer_tpu/cli/train_cls.py; the reference's train_cls.py).

    python -m simple3dformer_tpu_torch.cli.train_cls model=Hengshuang synthetic=1024
    python -m simple3dformer_tpu_torch.cli.train_cls device=cpu synthetic=64 num_point=64 \\
        epoch=2 batch_size=16

The same ``key=value`` overrides over configs/cls.yaml (+ configs/model/<name>.yaml)
and the same recipe and printed lines: ``model=3DViT`` (the default, PointViT
cls) or ``model=Hengshuang`` (PointTransformerCls: transformer_dim 512, 4
blocks, 16 neighbours), 1024 points with normals (``normal`` picks input 6 or
3), 40 classes, batch 64; per-step point dropout, then a random scale and shift
of xyz, on the device, drawn from the seed and the optimizer step (a resumed
run draws what an unbroken one draws at the same step); the reference's
optimizer block (SGD momentum 0.9 at the hard-coded lr 0.01, or Adam with the
config's lr and weight decay) and StepLR(50, 0.3) per epoch; instance and
class accuracy on the test split, a checkpoint at each best instance accuracy,
and the resume from the latest ("Use pretrain model"). The corpus sits on the
device and each epoch runs from one index matrix; its metrics are fetched once.
The trainer sets ``torch.backends.cuda.matmul.allow_tf32 = False``: the Linear
layers run in full f32, as the kernels do and as the JAX trainer computes.

It runs on the card (``device=cuda``, the default) and on the CPU only when
asked (``device=cpu``). Without the ``modelnet40_normal_resampled`` corpus,
``synthetic=N`` (or ``--synthetic``, 512) trains on the JAX trainer's
synthetic stream: standard-normal clouds and uniform labels. ``dtype=bf16``
computes every Linear in bf16 with the parameters in f32, as the JAX
trainer's ``compute_dtype`` does; the vector-attention blocks take the bf16
kernels (``S3F_VA_RESID=0`` picks their recompute backward), the ViT blocks
the bf16 fused kernels; the loss is taken on the logits in f32 and the
checkpoints keep the f32 parameters.

``ClsTrainer`` is the recipe (model, optimizer, augmentation, lr schedule,
one epoch, the eval), shared with cli/train_cls_scanobjectnn.py.

    python -m simple3dformer_tpu_torch.cli.train_cls model=Hengshuang dtype=bf16 synthetic=1024
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import checkpoint as ckpt_lib
from ..core.rng import generator, step_seed
from ..data import augment, datasets
from ..data.pipeline import DeviceResidentDataset
from ..models.registry import make_point_model
from ..parallel.mesh import print0
from ..train import health
from ..train.eval_metrics import InstanceClassMeter
from ..train.loop import TrainState, make_scanned_eval, make_scanned_train_steps
from . import _common as C

NUM_CLASS = 40


def load_arrays(cfg):
    """((train x, y), (test x, y)) as numpy, synthetic or read from the corpus."""
    npoint = int(cfg.num_point)
    channels = 6 if cfg.normal else 3
    if cfg.synthetic:
        tr = datasets.synthetic_points(int(cfg.synthetic), npoint, channels, NUM_CLASS,
                                       seed=int(cfg.seed))
        te = datasets.synthetic_points(max(int(cfg.synthetic) // 5, 64), npoint, channels,
                                       NUM_CLASS, seed=int(cfg.seed) + 1)
        return tr, te

    def stack(split):
        ds = datasets.ModelNetPointCloud(cfg.data_path, npoint=npoint, split=split,
                                         normal_channel=bool(cfg.normal))
        xs, ys = zip(*(ds[i] for i in range(len(ds))))
        return np.stack(xs), np.concatenate(ys).astype(np.int32)

    return stack("train"), stack("test")


class ClsTrainer:
    """The classification recipe on a corpus held on the device: the registry's
    model at the config's compute dtype, the reference optimizer block, the
    augmentation drawn from the seed and the optimizer step, StepLR by epoch,
    and instance and class accuracy on the test split."""

    def __init__(self, cfg, device: torch.device, train, test, num_class: int):
        self.num_class, self.te_y = num_class, test[1]
        self.train_ds = DeviceResidentDataset({"x": train[0], "y": train[1]}, device)
        test_ds = DeviceResidentDataset({"x": test[0], "y": test[1]}, device)
        model = make_point_model(cfg, task="cls", dtype=C.compute_dtype(cfg),
                                 generator=generator(int(cfg.seed))).to(device)
        print0(f"Number of parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
        optimizer, base_lr = C.reference_optimizer(cfg, dict(model.named_parameters()))
        self.state = state = TrainState(model, optimizer)
        aug_gen = torch.Generator(device=device)

        def augment_fn(x):
            aug_gen.manual_seed(step_seed(int(cfg.seed), state.step))
            return augment.device_cls_augment(aug_gen, x)

        self.train_run = make_scanned_train_steps(state, self.train_ds, augment_fn=augment_fn)
        self.eval_run = make_scanned_eval(model, test_ds)
        self.sched = C.lr_schedule(cfg, base_lr)
        self.host_rng = np.random.RandomState(int(cfg.seed))
        self.batch = int(cfg.batch_size)
        self.eval_idx = test_ds.put_indices(test_ds.epoch_indices(
            self.batch, self.host_rng, shuffle=False, drop_last=False))

    def train_epoch(self, epoch: int) -> tuple[float, str]:
        """One epoch at its lr -> (mean train accuracy, samples/s text)."""
        idx = self.train_ds.put_indices(self.train_ds.epoch_indices(self.batch, self.host_rng))
        timer = C.EpochTimer()
        metrics = self.train_run(idx, self.sched(epoch))
        losses = metrics["loss"].cpu().numpy()  # the epoch's one wait for the device
        health.check_finite({"loss": losses}, epoch)
        train_acc = float(metrics["accuracy"].mean())
        return train_acc, timer.lap(idx.shape[0] * idx.shape[1])

    def evaluate(self) -> tuple[float, float]:
        """(instance accuracy, class accuracy) on the test split."""
        logits = self.eval_run(self.eval_idx).reshape(-1, self.num_class).float().cpu().numpy()
        meter = InstanceClassMeter(self.num_class)
        n = len(self.te_y)
        for s in range(0, n, self.batch):
            sl = slice(s, min(s + self.batch, n))
            meter.update(np.argmax(logits[sl], -1), self.te_y[sl])
        return meter.instance_accuracy, meter.class_accuracy


def main(argv=None):
    cfg, device = C.setup("cls", argv)
    cfg.num_class = NUM_CLASS
    cfg.input_dim = 6 if cfg.normal else 3
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    train, test = load_arrays(cfg)
    print0(f"The size of train data is {len(train[0])}; test {len(test[0])}")
    run = ClsTrainer(cfg, device, train, test, NUM_CLASS)

    ckpt = ckpt_lib.Checkpointer(f"{C.run_dir(cfg, 'cls')}/ckpt")
    restored, best = ckpt.restore_into(run.state)
    start_epoch, best_instance_acc, best_class_acc = 0, 0.0, 0.0
    if restored is not None:
        start_epoch = int(ckpt.latest_step()) + 1
        best_instance_acc = (best or {}).get("instance_acc", 0.0)
        print0("Use pretrain model")

    for epoch in range(start_epoch, int(cfg.epoch)):
        train_acc, rate = run.train_epoch(epoch)
        print(f"Epoch {epoch + 1}: Train Instance Accuracy: {train_acc:f} ({rate})")
        inst, cls_acc = run.evaluate()
        if inst >= best_instance_acc:
            best_instance_acc = inst
            ckpt.save(epoch, run.state.state_dict(),
                      {"instance_acc": inst, "class_acc": cls_acc})
            print0("Save model...")
        best_class_acc = max(best_class_acc, cls_acc)
        print(f"Test Instance Accuracy: {inst:f}, Class Accuracy: {cls_acc:f}")
        print(f"Best Instance Accuracy: {best_instance_acc:f}, "
              f"Class Accuracy: {best_class_acc:f}")
    print0("End of training...")
    return best_instance_acc


if __name__ == "__main__":
    main()
