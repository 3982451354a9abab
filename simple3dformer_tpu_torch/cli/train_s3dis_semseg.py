"""S3DIS semantic segmentation trainer (port of
simple3dformer_tpu/cli/train_s3dis_semseg.py; the reference's
train_s3dis_semseg.py).

    python -m simple3dformer_tpu_torch.cli.train_s3dis_semseg --synthetic
    python -m simple3dformer_tpu_torch.cli.train_s3dis_semseg device=cpu synthetic=16 \\
        num_point=256 epoch=1

The same ``key=value`` overrides over configs/semseg.yaml and the same recipe
and printed lines: 13 classes, blocks of ``num_point`` (4096) points of 9
features, the 3DViT_s3dis model (3DViT on deit_base, 3 heads), plain
per-point CE, SGD momentum 0.9 at the config's lr (the JAX trainer takes
``learning_rate``, not the reference optimizer block's 0.01, and like it uses
no weight decay), lr max(lr * decay^(epoch // step), 1e-5), the BatchNorm
momentum schedule 0.9 * 0.5^(epoch // step) clipped at 0.01 (torch's
convention; the modules take flax's 1 - that, set on the live modules), no
augmentation; eval point accuracy, mAcc, global mIoU and the reference's
class-avg and instance-avg IoU, and a checkpoint at each best instance-avg
IoU. The corpus sits on the device and each epoch runs from one index
matrix; its losses are fetched once.

At 4096 points the ViT blocks see 1025 tokens, beyond the fused block
kernels (512), so on the card each block runs its layered route with
attention as the ``mhsa`` kernels (nn/layers.Block.route). The trainer sets
``torch.backends.cuda.matmul.allow_tf32 = False``: the Linear layers run in
full f32, as the kernels do. ``model=Hengshuang`` trains PointTransformerSeg
(transformer_dim 512, 4 blocks, 16 neighbours) on the vector-attention,
kNN, FPS and gather kernels. ``dtype=bf16`` computes every Linear in bf16
with the parameters in f32, as the JAX trainer's ``compute_dtype`` does (the
``mhsa`` kernels on bf16 q, k, v; the bf16 vector-attention kernels).

    python -m simple3dformer_tpu_torch.cli.train_s3dis_semseg --synthetic dtype=bf16
    python -m simple3dformer_tpu_torch.cli.train_s3dis_semseg --synthetic model=Hengshuang

It runs on the card (``device=cuda``, the default) and on the CPU only when
asked (``device=cpu``). Without the room files, ``synthetic=N`` (or
``--synthetic``, 512) trains on the JAX trainer's synthetic stream: uniform
features and uniform random labels. The JAX trainer rebuilds its model when
the BatchNorm momentum changes; here the momentum is set on the live modules,
the same function. ``S3DISWholeScene`` (sliding-window whole-room eval, which
no JAX CLI uses) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import checkpoint as ckpt_lib
from ..core.rng import generator
from ..data import datasets
from ..data.pipeline import DeviceResidentDataset
from ..models.registry import make_point_model
from ..nn.layers import set_bn_momentum
from ..parallel.mesh import print0
from ..train import health
from ..train.eval_metrics import SemSegMeter
from ..train.loop import TrainState, make_scanned_eval, make_scanned_train_steps, seg_cross_entropy
from . import _common as C

NUM_CLASS = 13
INPUT_DIM = 9


def load_arrays(cfg):
    """((train x, y), (test x, y)) as numpy, synthetic or read from the rooms."""
    npoint = int(cfg.num_point)
    if cfg.synthetic:
        def synth(n, seed):
            rng = np.random.RandomState(seed)
            return (rng.rand(n, npoint, INPUT_DIM).astype(np.float32),
                    rng.randint(0, NUM_CLASS, size=(n, npoint)).astype(np.int32))

        return synth(int(cfg.synthetic), int(cfg.seed)), synth(
            max(int(cfg.synthetic) // 5, 16), int(cfg.seed) + 1)

    def stack(split):
        rng = np.random.RandomState(int(cfg.seed))
        ds = datasets.S3DISDataset(cfg.data_path, split=split, num_point=npoint, rng=rng)
        xs, ys = zip(*(ds[i] for i in range(len(ds))))
        return np.stack(xs).astype(np.float32), np.stack(ys)

    return stack("train"), stack("test")


def main(argv=None):
    cfg, device = C.setup("semseg", argv)
    cfg.num_class = NUM_CLASS
    cfg.input_dim = INPUT_DIM
    npoint = int(cfg.num_point)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    (tr_x, tr_y), (te_x, te_y) = load_arrays(cfg)
    print0(f"train {len(tr_x)} / test {len(te_x)} blocks")
    train_ds = DeviceResidentDataset({"x": tr_x, "y": tr_y}, device)
    test_ds = DeviceResidentDataset({"x": te_x, "y": te_y}, device)

    model = make_point_model(cfg, task="seg", dtype=C.compute_dtype(cfg),
                             generator=generator(int(cfg.seed))).to(device)
    print0(f"Number of parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    optimizer, _ = C.reference_optimizer(cfg, dict(model.named_parameters()))
    state = TrainState(model, optimizer)
    train_run = make_scanned_train_steps(state, train_ds, loss_fn=seg_cross_entropy)
    eval_run = make_scanned_eval(model, test_ds)

    base_lr = float(cfg.learning_rate)
    batch = int(cfg.batch_size)
    host_rng = np.random.RandomState(int(cfg.seed))
    eval_idx = test_ds.put_indices(test_ds.epoch_indices(batch, host_rng, shuffle=False,
                                                         drop_last=False))
    ckpt = ckpt_lib.Checkpointer(f"{C.run_dir(cfg, 'semseg')}/ckpt")
    best_miou, cur_momentum = 0.0, None

    for epoch in range(int(cfg.epoch)):
        lr = max(base_lr * (float(cfg.lr_decay) ** (epoch // int(cfg.step_size))), 1e-5)
        torch_mom = max(0.9 * (0.5 ** (epoch // int(cfg.step_size))), 0.01)
        if torch_mom != cur_momentum:
            cur_momentum = torch_mom
            set_bn_momentum(model, 1.0 - torch_mom)
            print0(f"BN momentum updated to: {torch_mom:f}")

        idx = train_ds.put_indices(train_ds.epoch_indices(batch, host_rng))
        timer = C.EpochTimer()
        metrics = train_run(idx, lr)
        losses = metrics["loss"].cpu().numpy()  # the epoch's one wait for the device
        health.check_finite({"loss": losses}, epoch)
        loss = float(np.mean(losses))
        rate = timer.lap(idx.shape[0] * idx.shape[1])
        print(f"Epoch {epoch + 1} lr {lr:f} loss {loss:.4f} ({rate})")

        logits = eval_run(eval_idx).reshape(-1, npoint, NUM_CLASS)[: len(te_y)]
        meter = SemSegMeter(NUM_CLASS)
        meter.update(logits.argmax(-1).cpu().numpy(), te_y)
        acc, macc, miou = meter.accuracy, meter.mean_class_accuracy, meter.miou
        inst_iou = meter.instance_avg_iou
        # the reference logs class-avg and "Inctance avg" IoU and saves its best
        # checkpoint on the latter (train_s3dis_semseg.py:231-237); the global
        # mIoU is printed beside them
        print(f"eval accuracy: {acc:f}  mAcc: {macc:f}  mIoU: {miou:f}  "
              f"Class avg mIOU: {meter.class_avg_iou:f}  "
              f"Inctance avg mIOU: {inst_iou:f}")
        if inst_iou >= best_miou:
            best_miou = inst_iou
            ckpt.save(epoch, state.state_dict(), {"accuracy": acc, "mAcc": macc, "mIoU": miou,
                                                  "instance_avg_iou": inst_iou})
    print(f"Best Inctance avg mIOU: {best_miou:f}")
    return best_miou


if __name__ == "__main__":
    main()
