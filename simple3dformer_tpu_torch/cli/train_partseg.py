"""ShapeNetPart part segmentation trainer (port of
simple3dformer_tpu/cli/train_partseg.py; the reference's train_partseg.py).

    python -m simple3dformer_tpu_torch.cli.train_partseg model=3DViT synthetic=1024 \\
        epoch=2 batch_size=16

The same ``key=value`` overrides over configs/partseg.yaml and the same
recipe and printed lines: per-point 50-way CE with the shape's 16-way
category one-hot concatenated to every point, SGD momentum 0.9, lr
max(lr * decay^(epoch // step), 1e-5), the BatchNorm momentum schedule
0.9 * 0.5^(epoch // step) clipped at 0.01 (torch's convention; the modules
take flax's 1 - that, set on the live modules), random scale and shift of xyz
in each step, category-restricted eval with class-avg and instance-avg mIoU,
and a checkpoint at each best instance mIoU. The corpus sits on the device
and each epoch runs from one index matrix; its losses are fetched once.

Models: ``model=3DViT`` (the default: deit_tiny, 257 tokens, the fused
block kernels on the card) or ``model=Hengshuang`` (PointTransformerSeg:
transformer_dim 512, 4 blocks, 16 neighbours; ten vector-attention blocks a
step, kNN, FPS and the gathers on the card). ``dtype=bf16`` computes every
Linear in bf16 with the parameters in f32, as the JAX trainer's
``compute_dtype`` does (the fused block kernels and the vector-attention
kernels in bf16); the loss is taken on f32 logits.

    python -m simple3dformer_tpu_torch.cli.train_partseg model=Hengshuang dtype=bf16 \
        synthetic=1024 batch_size=16

It runs on the card (``device=cuda``, the default) and on the CPU only when
asked (``device=cpu``). Without the corpus on disk, ``synthetic=N`` trains
on generated clouds. ``model.pretrained`` names the run directory only, as
in the JAX trainer, which loads no 2D weights for this task. The JAX trainer
rebuilds its model when the BatchNorm momentum changes; here the momentum is
set on the live modules, the same function. The LwF recipe, which trains
the image variants' 2D pathway too, is ``cli/train_partseg_lwf.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import checkpoint as ckpt_lib
from ..core.rng import generator
from ..data import augment, datasets
from ..data.pipeline import DeviceResidentDataset
from ..models.registry import make_point_model
from ..nn.layers import set_bn_momentum
from ..train import health
from ..train.eval_metrics import SEG_CLASSES, PartSegMeter
from ..train.loop import TrainState, make_scanned_eval, make_scanned_train_steps, seg_cross_entropy
from . import _common as C

NUM_PART = 50
NUM_CATEGORY = 16


def make_prepare_fn(num_category: int = NUM_CATEGORY):
    def prepare(batch):
        pts = batch["x"]  # [..., N, C]
        onehot = F.one_hot(batch["cls"].long(), num_category).to(pts.dtype)
        onehot = onehot[..., None, :].expand(*pts.shape[:-1], num_category)
        return torch.cat([pts, onehot], dim=-1), batch["y"]

    return prepare


def seg_augment(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """The reference's train_partseg.py:141-144: random scale and shift of xyz only."""
    xyz = augment.device_shift(gen, augment.device_random_scale(gen, x[..., :3]))
    return torch.cat([xyz, x[..., 3:]], dim=-1)


def load_arrays(cfg):
    """((train x, cats, segs), (test x, cats, segs)) as numpy, synthetic or read."""
    npoint = int(cfg.num_point)
    base = 6 if cfg.normal else 3
    if cfg.synthetic:
        def synth(n, seed):
            rng = np.random.RandomState(seed)
            cats = rng.randint(0, NUM_CATEGORY, size=(n,)).astype(np.int32)
            pts = rng.randn(n, npoint, base).astype(np.float32)
            segs = np.stack([
                rng.choice(SEG_CLASSES[list(SEG_CLASSES)[c % 16]], size=npoint)
                for c in cats
            ]).astype(np.int32)
            return pts, cats, segs

        return synth(int(cfg.synthetic), int(cfg.seed)), synth(
            max(int(cfg.synthetic) // 5, 32), int(cfg.seed) + 1)

    def stack(split):
        rng = np.random.RandomState(int(cfg.seed))
        ds = datasets.PartNormalDataset(cfg.data_path, npoints=npoint, split=split,
                                        normal_channel=bool(cfg.normal), rng=rng)
        xs, cs, ss = [], [], []
        for i in range(len(ds)):
            p, c, s = ds[i]
            xs.append(p)
            cs.append(c[0])
            ss.append(s)
        return np.stack(xs), np.asarray(cs, np.int32), np.stack(ss)

    return stack("trainval"), stack("test")


def main(argv=None):
    cfg, device = C.setup("partseg", argv)
    cfg.num_class = NUM_PART
    cfg.input_dim = (6 if cfg.normal else 3) + NUM_CATEGORY

    (tr_x, tr_c, tr_s), (te_x, te_c, te_s) = load_arrays(cfg)
    print(f"train {len(tr_x)} / test {len(te_x)}")
    train_ds = DeviceResidentDataset({"x": tr_x, "cls": tr_c, "y": tr_s}, device)
    test_ds = DeviceResidentDataset({"x": te_x, "cls": te_c, "y": te_s}, device)

    model = make_point_model(cfg, task="seg", dtype=C.compute_dtype(cfg),
                             generator=generator(int(cfg.seed))).to(device)
    print(f"Number of parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    optimizer, _ = C.reference_optimizer(cfg, dict(model.named_parameters()))
    state = TrainState(model, optimizer)
    aug_gen = torch.Generator(device=device).manual_seed(int(cfg.seed))
    prepare = make_prepare_fn()
    train_run = make_scanned_train_steps(state, train_ds, loss_fn=seg_cross_entropy,
                                         augment_fn=lambda x: seg_augment(aug_gen, x),
                                         prepare_fn=prepare)
    eval_run = make_scanned_eval(model, test_ds, prepare_fn=prepare)

    base_lr = float(cfg.learning_rate)
    batch = int(cfg.batch_size)
    host_rng = np.random.RandomState(int(cfg.seed))
    eval_idx = test_ds.put_indices(test_ds.epoch_indices(batch, host_rng, shuffle=False,
                                                         drop_last=False))
    ckpt = ckpt_lib.Checkpointer(f"{C.run_dir(cfg, 'partseg')}/ckpt")
    best_inst_iou, cur_momentum = 0.0, None

    for epoch in range(int(cfg.epoch)):
        lr = max(base_lr * (float(cfg.lr_decay) ** (epoch // int(cfg.step_size))), 1e-5)
        torch_mom = max(0.9 * (0.5 ** (epoch // int(cfg.step_size))), 0.01)
        if torch_mom != cur_momentum:
            cur_momentum = torch_mom
            set_bn_momentum(model, 1.0 - torch_mom)
            print(f"BN momentum updated to: {torch_mom:f}")

        idx = train_ds.put_indices(train_ds.epoch_indices(batch, host_rng))
        timer = C.EpochTimer()
        metrics = train_run(idx, lr)
        losses = metrics["loss"].cpu().numpy()  # the epoch's one wait for the device
        health.check_finite({"loss": losses}, epoch)
        loss = float(np.mean(losses))
        rate = timer.lap(idx.shape[0] * idx.shape[1])
        print(f"Epoch {epoch + 1} lr {lr:f} train loss {loss:.4f} ({rate})")

        logits = eval_run(eval_idx).reshape(-1, int(cfg.num_point), NUM_PART)[: len(te_s)]
        meter = PartSegMeter()
        meter.update(logits.float().cpu().numpy(), te_s)
        acc, c_iou, i_iou = meter.accuracy, meter.class_avg_iou, meter.instance_avg_iou
        print(f"Epoch {epoch + 1} test Accuracy: {acc:f}  Class avg mIOU: "
              f"{c_iou:f}  Inctance avg mIOU: {i_iou:f}")
        if i_iou >= best_inst_iou:
            best_inst_iou = i_iou
            ckpt.save(epoch, state.state_dict(), {
                "accuracy": acc, "class_avg_iou": c_iou, "instance_avg_iou": i_iou})
    print(f"Best inctance avg mIOU is: {best_inst_iou:f}")
    return best_inst_iou


if __name__ == "__main__":
    main()
