"""Voxel classification trainer (port of simple3dformer_tpu/cli/train_cls_voxel.py,
which mirrors the reference's train_cls_voxel.py).

The same argparse surface and recipe: Adam + StepLR + untuned linear warmup
dampened per epoch, CE with optional class weights, overall and mean-class
accuracy eval, best-checkpoint save, and the same printed lines. The whole
corpus is held on the device (uint8) and each epoch runs from one index
matrix sent once; the epoch's losses are fetched once at its end.

    python -m simple3dformer_tpu_torch.cli.train_cls_voxel --dataset ModelNet40 \\
        --synthetic 2048 --transformer-name deit_small_patch16_224 \\
        --cell-size 6 --patch-size 5

It runs on the card (``--device cuda``, the default) and on the CPU only when
asked (``--device cpu``). Without the corpora on disk, ``--synthetic N``
trains on generated occupancy grids.

Ported: the default route (``--pos-embedding default`` or ``no_embed``),
``--reweighted``, ``--head``, ``--embed-layer``, ``--model`` restore,
``--dtype bf16`` (the tokenizer, the blocks and the head compute in bf16, the
fused block kernels in bf16 on the card; the parameters stay f32),
``--bf16-nu`` (Adam's second moment in bf16, the plain
``scale_by_adam_bf16_nu``; ``auto`` turns it on iff ``--dtype bf16``, as the
JAX trainer does), ``--pretrained`` (``maybe_load_deit`` reads
``<transformer-name>.pth`` from ``$DEIT_CKPT_DIR``, default ``./weights``, or
warns and keeps the random init; either way Adam freezes the 2D head, pos
embed and patch embed) and ``--lwf`` (the reference's LwF branch: a frozen
deit_base teacher with 12 heads, also loaded through ``maybe_load_deit``, and a
batch of images a step, ImageNet val under ./data or with ``--synthetic``
random images, cropped and flipped on the device; the loss CE + 0.1 CE(the 2D
head's logits, the teacher's labels), without class weights as in the JAX
trainer). Not yet: ``--zero1`` and the other positional-embedding routes,
which raise.

    python -m simple3dformer_tpu_torch.cli.train_cls_voxel --dataset ModelNet40 \
        --synthetic 2048 --transformer-name deit_small_patch16_224 \
        --cell-size 6 --patch-size 5 --lwf --pretrained

    python -m simple3dformer_tpu_torch.cli.train_cls_voxel --dataset ModelNet40 \
        --synthetic 2048 --transformer-name deit_small_patch16_224 \
        --cell-size 6 --patch-size 5 --dtype bf16
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core import checkpoint as ckpt_lib
from ..core.rng import DEFAULT_SEED, generator
from ..data import datasets
from ..data.classmaps import CLASSES_ModelNet10, CLASSES_ModelNet40, CLASSES_SHAPENET
from ..data.image_augment import device_random_resized_crop_flip
from ..data.pipeline import DeviceResidentDataset
from ..data.synthetic import synthetic_voxels
from ..models.voxel_vit import VoxelViT, frozen_mask
from ..nn.vit import EMBED_DIM, make_teacher
from ..nn.voxel_embed import make_embed_layer
from ..train import health
from ..train.eval_metrics import ClassificationMeter
from ..train.loop import TrainState, make_scanned_eval, make_scanned_train_steps
from ..train.lwf import TEACHER_SEED, load_images, make_scanned_lwf_train_steps
from ..train.optim import epoch_lr, make_optimizer
from ..utils.torch_convert import maybe_load_deit

LWF_TEACHER = "deit_base_patch16_224"  # hard-coded, as in the reference (:174, :180)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", type=str, default="./data/ShapeNetCore_v2")
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--outf", type=str, default="./cls")
    p.add_argument("--model", type=str, default="", help="checkpoint path to load")
    p.add_argument("--dataset", type=str, default="ShapeNetV2",
                   choices=["ModelNet10", "ModelNet40", "ShapeNetV2"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--model-name", type=str, default="Voxel3D_2DPretrain")
    p.add_argument("--transformer-name", type=str, default="deit_base_patch16_224")
    p.add_argument("--pretrained", action="store_true")
    p.add_argument("--lwf", action="store_true")
    p.add_argument("--reweighted", action="store_true")
    p.add_argument("--head", default="default", type=str)
    p.add_argument("--embed-layer", type=str, default="VoxelEmbed")
    p.add_argument("--cell-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, default=8)
    p.add_argument("--pos-embedding", type=str, default="default")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--lr-step-size", type=float, default=20)
    p.add_argument("--lr-gamma", type=float, default=0.5)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic samples instead of reading data")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"],
                   help="compute dtype (params stay f32)")
    p.add_argument("--bf16-nu", type=str, default="auto", choices=["auto", "0", "1"],
                   help="store Adam's second moment in bfloat16; auto = on iff --dtype bf16")
    p.add_argument("--zero1", action="store_true",
                   help="shard Adam moments over data-parallel ranks (ZeRO-1)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu; the trainer never moves to the CPU by itself")
    return p


def load_voxel_arrays(dataset, data_root, synthetic=0, *, reweighted=False, min_test=32,
                      seed=DEFAULT_SEED):
    """Return (train_x, train_y, test_x, test_y, n_classes, voxel_size, weights).

    ``min_test`` floors the synthetic test-set size (the CLI passes its batch size).
    """
    if dataset == "ModelNet10":
        idx2cls, voxel_size = CLASSES_ModelNet10, 30
    elif dataset == "ModelNet40":
        idx2cls, voxel_size = CLASSES_ModelNet40, 30
    else:
        idx2cls, voxel_size = CLASSES_SHAPENET, 128
    n_classes = len(idx2cls)

    if synthetic:
        tr_x, tr_y = synthetic_voxels(synthetic, voxel_size, n_classes, seed=seed)
        te_x, te_y = synthetic_voxels(max(synthetic // 5, min_test), voxel_size, n_classes,
                                      seed=seed + 1)
        return tr_x, tr_y, te_x, te_y, n_classes, voxel_size, None

    weights = None
    if dataset == "ShapeNetV2":
        ds = datasets.ShapeNetV2VoxelDataset(data_root, idx2cls)
        tr_idx, te_idx = ds.split_train_test(0.8, seed=seed)
        if reweighted:
            weights = ds.class_weight()
        tr_x, tr_y = ds.materialize(tr_idx)
        te_x, te_y = ds.materialize(te_idx)
    else:
        tr = datasets.ModelNetVoxelDataset(data_root, idx2cls, "train")
        te = datasets.ModelNetVoxelDataset(data_root, idx2cls, "test")
        if reweighted:
            weights = tr.class_weight()
        tr_x, tr_y = tr.materialize()
        te_x, te_y = te.materialize()
    return tr_x, tr_y, te_x, te_y, n_classes, voxel_size, weights


def _refuse_unported(args) -> None:
    if args.zero1:
        raise NotImplementedError("--zero1 is not ported yet: it comes with the parallelism slice")
    if args.pos_embedding not in ("default", "no_embed"):
        raise NotImplementedError(f"--pos-embedding {args.pos_embedding} is not ported yet: it "
                                  "comes with the slice of the other voxel routes")


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass --device cpu to train on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, not {name}")
    return device


def main(argv=None):
    args = build_argparser().parse_args(argv)
    _refuse_unported(args)
    if args.model_name != "Voxel3D_2DPretrain":
        raise ValueError("Unknown model name!")
    device = _device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"devices: 1 | {device} ({kind})")

    tr_x, tr_y, te_x, te_y, n_classes, voxel_size, weights = load_voxel_arrays(
        args.dataset, args.data_root, args.synthetic, reweighted=args.reweighted,
        min_test=args.batchSize, seed=args.seed)
    print(f"train {len(tr_x)} / test {len(te_x)} samples, {n_classes} classes")
    train_ds = DeviceResidentDataset({"x": tr_x, "y": tr_y}, device)
    test_ds = DeviceResidentDataset({"x": te_x, "y": te_y}, device)

    g = generator(args.seed)
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    embedding = make_embed_layer(args.embed_layer, voxel_size=voxel_size,
                                 cell_size=args.cell_size, patch_size=args.patch_size,
                                 embed_dim=EMBED_DIM[args.transformer_name], generator=g,
                                 dtype=dtype)
    model = VoxelViT(embedding, n_classes=n_classes, transformer_backbone=args.transformer_name,
                     pos_embedding=args.pos_embedding, head=args.head, generator=g,
                     dtype=dtype).to(device)
    if args.pretrained:
        maybe_load_deit(model, args.transformer_name)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Number of parameters: {n_params / 1e6:.2f}M")

    bf16_nu = dtype is not None if args.bf16_nu == "auto" else args.bf16_nu == "1"
    optimizer = make_optimizer(dict(model.named_parameters()), "Adam",
                               trainable_mask=frozen_mask(model, args.pretrained),
                               bf16_nu=bf16_nu)
    state = TrainState(model, optimizer)
    cw = torch.as_tensor(weights, device=device) if weights is not None else None
    if args.lwf:
        # the reference's LwF branch (train_cls_voxel.py:238-268), its paths hard-coded
        images = load_images("./data/ImageNet/ILSVRC/Data/CLS-LOC",
                             synthetic=args.synthetic or 256, seed=args.seed)
        image_ds = DeviceResidentDataset({"images": images}, device)
        teacher = make_teacher(LWF_TEACHER, generator=generator(TEACHER_SEED)).to(device)
        maybe_load_deit(teacher, LWF_TEACHER)
        lwf_run = make_scanned_lwf_train_steps(
            state, teacher, train_ds, image_ds, lambda_weight=0.1,
            image_augment_fn=device_random_resized_crop_flip, seed=args.seed)
        img_rng = np.random.RandomState(args.seed)

        def train_run(idx, lr):
            img_idx = img_rng.randint(0, len(image_ds), size=tuple(idx.shape))
            return lwf_run(idx, image_ds.put_indices(img_idx), lr)
    else:
        train_run = make_scanned_train_steps(state, train_ds, class_weights=cw)
    eval_run = make_scanned_eval(model, test_ds)

    out_dir = os.path.join(args.outf, args.model_name,
                           f"{args.embed_layer}_{args.pos_embedding}", args.transformer_name)
    ckpt = ckpt_lib.Checkpointer(os.path.join(out_dir, "ckpt"))
    if args.model:
        ckpt_lib.Checkpointer(args.model).restore_into(state)

    host_rng = np.random.RandomState(args.seed)
    eval_idx = test_ds.put_indices(test_ds.epoch_indices(args.batchSize, host_rng,
                                                         shuffle=False, drop_last=False))

    best_acc, best_epoch = 0.0, 0
    for epoch in range(args.epochs):
        lr = epoch_lr(args.lr, epoch, args.lr_step_size, args.lr_gamma, warmup=True)
        idx = train_ds.put_indices(train_ds.epoch_indices(args.batchSize, host_rng))
        t0 = time.time()
        metrics = train_run(idx, lr)
        losses = metrics["loss"].cpu().numpy()  # the epoch's one wait for the device
        health.check_finite({"loss": losses}, epoch)
        loss = float(np.mean(losses))
        dt = time.time() - t0
        sps = idx.shape[0] * idx.shape[1] / dt

        logits = eval_run(eval_idx).reshape(-1, n_classes).float().cpu().numpy()
        meter = ClassificationMeter(n_classes)
        meter.update(np.argmax(logits[: len(te_y)], -1), te_y)
        oa, mca = meter.overall_accuracy, meter.mean_class_accuracy
        print(f"Epoch {epoch} loss {loss:.4f} test accuracy {oa:f}, "
              f"mean class accuracy {mca:f} ({sps:.1f} samples/sec)")
        if oa >= best_acc:
            best_acc, best_epoch = oa, epoch
            ckpt.save(epoch, state.state_dict(), {"accuracy": oa, "mean_class_accuracy": mca})
    print(f"Best test accuracy: epoch {best_epoch} test accuracy {best_acc:f}")
    return best_acc


if __name__ == "__main__":
    main()
