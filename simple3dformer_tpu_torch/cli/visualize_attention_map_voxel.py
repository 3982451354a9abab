"""Attention-map visualization for the voxel ViT (port of
simple3dformer_tpu/cli/visualize_attention_map_voxel.py, which mirrors the
reference's visualize_attention_map_voxel.py).

Runs voxels through the model, captures every block's attention
(utils/attention_rollout.capture_attention: the blocks' layered route and the
plain attention products, no kernel), computes the rollout mask, and saves
the final and per-layer 2D attention maps and a 3D scatter of the voxels
coloured by attention. ``--model`` restores a checkpoint directory that the
port's train_cls_voxel wrote (its latest step).

    python -m simple3dformer_tpu_torch.cli.visualize_attention_map_voxel \\
        --dataset ModelNet40 --synthetic 4 --outf ./attn_vis [--model <ckpt dir>]
    python -m simple3dformer_tpu_torch.cli.visualize_attention_map_voxel \\
        --dataset ModelNet40 --synthetic 4 --device cpu

It runs on the card (``--device cuda``, the default) and on the CPU only when
asked (``--device cpu``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core import checkpoint as ckpt_lib
from ..core.rng import DEFAULT_SEED, generator
from ..models.voxel_vit import VoxelViT
from ..nn.vit import EMBED_DIM
from ..nn.voxel_embed import make_embed_layer
from ..serve.server import default_class_names
from ..utils.attention_rollout import capture_attention, rollout
from ._common import resolve_device
from .train_cls_voxel import load_voxel_arrays


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", type=str, default="./data/ModelNet40")
    p.add_argument("--dataset", type=str, default="ModelNet40")
    p.add_argument("--model", type=str, default="", help="checkpoint dir")
    p.add_argument("--transformer-name", type=str, default="deit_small_patch16_224")
    p.add_argument("--embed-layer", type=str, default="VoxelEmbed")
    p.add_argument("--cell-size", type=int, default=6)
    p.add_argument("--patch-size", type=int, default=5)
    p.add_argument("--pos-embedding", type=str, default="default")
    p.add_argument("--outf", type=str, default="./attn_vis")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--n-samples", type=int, default=4)
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu; it never moves to the CPU by itself")
    return p


def save_plots(voxel, mask, joint, grid, out_dir):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    plt.figure()
    plt.imshow(mask)
    plt.colorbar()
    plt.title("Final Attention Map")
    plt.savefig(f"{out_dir}/attn_final.png")
    plt.close()

    for layer in range(joint.shape[0]):
        m = joint[layer][0, 1:].reshape(grid, grid)
        plt.figure()
        plt.imshow(m)
        plt.colorbar()
        plt.title(f"Layer {layer + 1}th Attention Map")
        plt.savefig(f"{out_dir}/attn_{layer + 1}.png")
        plt.close()

    # 3D scatter of occupied voxels colored by the (upsampled) mask
    occ = np.argwhere(voxel > 0)
    if len(occ):
        V = voxel.shape[0]
        cell = max(V // grid, 1)
        weights = mask[
            np.clip(occ[:, 0] // cell, 0, grid - 1),
            np.clip(occ[:, 1] // cell, 0, grid - 1),
        ]
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        ax.scatter(occ[:, 0], occ[:, 1], occ[:, 2], c=weights, cmap="viridis",
                   marker="s")
        plt.savefig(f"{out_dir}/attn_voxels_3d.png")
        plt.close()


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    tr_x, tr_y, _, _, n_classes, voxel_size, _ = load_voxel_arrays(
        args.dataset, args.data_root, args.synthetic, min_test=1, seed=args.seed)

    g = generator(args.seed)
    emb = make_embed_layer(args.embed_layer, voxel_size=voxel_size, cell_size=args.cell_size,
                           patch_size=args.patch_size,
                           embed_dim=EMBED_DIM[args.transformer_name], generator=g)
    model = VoxelViT(emb, n_classes=n_classes, transformer_backbone=args.transformer_name,
                     pos_embedding=args.pos_embedding, generator=g).to(device)
    if args.model:
        state, _ = ckpt_lib.Checkpointer(args.model).restore()
        if state is not None:
            model.load_state_dict(state["params"])
            print(f"loaded checkpoint from {args.model}")

    names = default_class_names(n_classes) or {}
    results = []
    for i in range(min(args.n_samples, len(tr_x))):
        voxel = tr_x[i].astype(np.float32)
        logits, att = capture_attention(model, torch.from_numpy(voxel[None]).to(device))
        mask, joint, grid = rollout(att[:, 0].float().cpu().numpy())
        out_dir = os.path.join(args.outf, f"sample_{i}_cls{int(tr_y[i])}")
        save_plots(voxel, mask, joint, grid, out_dir)
        results.append((out_dir, mask))
        pred = int(logits.argmax())
        print(f"sample {i}: pred {pred} ({names.get(pred, pred)}) label {int(tr_y[i])} "
              f"-> {out_dir}")
    return results


if __name__ == "__main__":
    main()
