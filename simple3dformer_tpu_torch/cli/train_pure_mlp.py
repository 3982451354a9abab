"""ViP-3D voxel classification (port of simple3dformer_tpu/cli/train_pure_mlp.py,
which mirrors the reference's train_pure_mlp.py).

The same argparse surface (``--model-name vip3d_{s7,s14,m7,l7}``,
``--embed-layer VoxelEmbed_{m40_,}vip_*``, ``--pos-embedding PEG``,
``--drop-path 0.1``, ``--dtype {f32,bf16}``) and recipe: Adam at ``--lr``
with StepLR and the untuned linear warmup stepped per epoch, as
train_cls_voxel; the same epoch and eval lines and a best-accuracy checkpoint.
The corpus is held on the card and each epoch runs from one index matrix,
each step ending in one launch of the Adam kernel.

    python -m simple3dformer_tpu_torch.cli.train_pure_mlp --dataset ModelNet40 --synthetic 2048
    python -m simple3dformer_tpu_torch.cli.train_pure_mlp --dataset ShapeNetV2 --synthetic 64 \\
        --embed-layer VoxelEmbed_vip_s7 --batchSize 16 --dtype bf16
    python -m simple3dformer_tpu_torch.cli.train_pure_mlp --dataset ModelNet40 --synthetic 32 \\
        --batchSize 8 --epochs 2 --device cpu

It runs on the card (``--device cuda``, the default) and on the CPU only when
asked (``--device cpu``). ModelNet40's 30^3 grids are zero-padded to the m40
embed configs' 32^3 (the reference's configs declare 32 while its grids are
30^3). ``--pretrained`` and ``--checkpoint-path-2d`` are parsed and unused, as
in the JAX CLI.

Data parallel over N cards, one process each, as cli/train_cls_voxel.py
(parallel/mesh.py): ``torchrun --nproc_per_node=N -m
simple3dformer_tpu_torch.cli.train_pure_mlp ...``, each rank on its part of
every global batch; ``--device cpu`` under the launcher meets over gloo.
Every rank prints the same epoch lines; rank 0 writes the checkpoints.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core import checkpoint as ckpt_lib
from ..core.rng import DEFAULT_SEED, generator
from ..data.classmaps import CLASSES_ModelNet40, CLASSES_SHAPENET
from ..data.pipeline import DeviceResidentDataset
from ..data.synthetic import synthetic_voxels
from ..models.vip3d import VisionPermutator3D
from ..nn.voxel_embed import VoxelEmbedNoAverage
from ..train import health
from ..train.eval_metrics import ClassificationMeter
from ..train.loop import TrainState, make_scanned_eval, make_scanned_train_steps
from ..train.optim import epoch_lr, make_optimizer
from ..parallel.mesh import print0
from ._common import init_devices
from .train_cls_voxel import load_voxel_arrays

# VALID_EMBED_LAYER (the reference's train_pure_mlp.py:34-44)
EMBED_CONFIGS = {
    "VoxelEmbed_m40_vip_s7": dict(embed_dim=192, voxel_size=32, cell_size=4),
    "VoxelEmbed_m40_vip_s14": dict(embed_dim=384, voxel_size=32, cell_size=4),
    "VoxelEmbed_m40_vip_m7": dict(embed_dim=256, voxel_size=32, cell_size=4),
    "VoxelEmbed_m40_vip_l7": dict(embed_dim=256, voxel_size=32, cell_size=4),
    "VoxelEmbed_vip_s7": dict(embed_dim=192, voxel_size=128, cell_size=16),
    "VoxelEmbed_vip_s14": dict(embed_dim=384, voxel_size=128, cell_size=16),
    "VoxelEmbed_vip_m7": dict(embed_dim=256, voxel_size=128, cell_size=16),
    "VoxelEmbed_vip_l7": dict(embed_dim=256, voxel_size=128, cell_size=16),
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", type=str, default="./data/ShapeNetCore_v2")
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--dataset", type=str, default="ModelNet40",
                   choices=["ModelNet40", "ShapeNetV2"])
    p.add_argument("--model-name", type=str, default="vip3d_s7")
    p.add_argument("--embed-layer", type=str, default="VoxelEmbed_m40_vip_s7")
    p.add_argument("--pos-embedding", type=str, default="default",
                   help="'PEG' enables the positional conv")
    p.add_argument("--pretrained", action="store_true")
    p.add_argument("--checkpoint-path-2d", type=str, default="")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-step-size", type=float, default=20)
    p.add_argument("--lr-gamma", type=float, default=0.5)
    p.add_argument("--drop-path", type=float, default=0.1)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--outf", type=str, default="./cls")
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"],
                   help="compute dtype (params stay f32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu; the trainer never moves to the CPU by itself")
    return p


def load_arrays(args, voxel_size: int):
    """(train x, train y, test x, test y, n_classes): the synthetic corpus
    (raw 30^3 for ModelNet40) or the dataset read from ``--data-root``, grids
    smaller than ``voxel_size`` zero-padded to it."""
    n_classes = len(CLASSES_ModelNet40 if args.dataset == "ModelNet40" else CLASSES_SHAPENET)
    if args.synthetic:
        raw = voxel_size if args.dataset != "ModelNet40" else 30
        tr_x, tr_y = synthetic_voxels(args.synthetic, raw, n_classes, seed=args.seed)
        te_x, te_y = synthetic_voxels(max(args.synthetic // 5, args.batchSize), raw, n_classes,
                                      seed=args.seed + 1)
    else:
        tr_x, tr_y, te_x, te_y, n_classes, _, _ = load_voxel_arrays(
            args.dataset, args.data_root, min_test=args.batchSize, seed=args.seed)
    if tr_x.shape[1] < voxel_size:  # zero-pad ModelNet 30^3 -> 32^3
        pad = voxel_size - tr_x.shape[1]
        padding = [(0, 0), (0, pad), (0, pad), (0, pad)]
        tr_x, te_x = np.pad(tr_x, padding), np.pad(te_x, padding)
    return tr_x, tr_y, te_x, te_y, n_classes


def build_model(args, n_classes: int, dtype: torch.dtype | None) -> VisionPermutator3D:
    emb_cfg = EMBED_CONFIGS[args.embed_layer]
    v, cell = emb_cfg["voxel_size"], emb_cfg["cell_size"]
    g = generator(args.seed)
    emb = VoxelEmbedNoAverage(voxel_size=v, cell_size=cell, patch_size=v // cell,
                              embed_dim=emb_cfg["embed_dim"], generator=g, dtype=dtype)
    return VisionPermutator3D.from_name(
        args.model_name, emb, n_classes, drop_path_rate=args.drop_path,
        pos_embedding="PEG" if args.pos_embedding == "PEG" else None,
        drop_path_seed=args.seed, generator=g, dtype=dtype)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = init_devices(args.device, "--device cpu")

    tr_x, tr_y, te_x, te_y, n_classes = load_arrays(
        args, EMBED_CONFIGS[args.embed_layer]["voxel_size"])
    train_ds = DeviceResidentDataset({"x": tr_x, "y": tr_y}, device)
    test_ds = DeviceResidentDataset({"x": te_x, "y": te_y}, device)
    print0(f"train {len(tr_x)} / test {len(te_x)}")

    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    model = build_model(args, n_classes, dtype).to(device)
    print0(f"Number of parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")

    state = TrainState(model, make_optimizer(dict(model.named_parameters()), "Adam"))
    train_run = make_scanned_train_steps(state, train_ds)
    eval_run = make_scanned_eval(model, test_ds)

    host_rng = np.random.RandomState(args.seed)
    eval_idx = test_ds.put_indices(test_ds.epoch_indices(args.batchSize, host_rng,
                                                         shuffle=False, drop_last=False))
    ckpt = ckpt_lib.Checkpointer(os.path.join(args.outf, args.model_name, "ckpt"))

    best_acc, best_epoch = 0.0, 0
    for epoch in range(args.epochs):
        lr = epoch_lr(args.lr, epoch, args.lr_step_size, args.lr_gamma, warmup=True)
        idx = train_ds.put_indices(train_ds.epoch_indices(args.batchSize, host_rng))
        t0 = time.time()
        losses = train_run(idx, lr)["loss"].cpu().numpy()  # the epoch's one wait for the device
        health.check_finite({"loss": losses}, epoch)
        loss = float(np.mean(losses))
        sps = idx.shape[0] * idx.shape[1] / (time.time() - t0)

        logits = eval_run(eval_idx).reshape(-1, n_classes).float().cpu().numpy()
        meter = ClassificationMeter(n_classes)
        meter.update(np.argmax(logits[: len(te_y)], -1), te_y)
        oa = meter.overall_accuracy
        print(f"Epoch {epoch} loss {loss:.4f} test accuracy {oa:f}, mean class "
              f"accuracy {meter.mean_class_accuracy:f} ({sps:.1f} samples/sec)")
        if oa >= best_acc:
            best_acc, best_epoch = oa, epoch
            ckpt.save(epoch, state.state_dict(), {"accuracy": oa})
    print(f"Best test accuracy: epoch {best_epoch} test accuracy {best_acc:f}")
    return best_acc


if __name__ == "__main__":
    main()
