"""DeiT checkpoints -> the port's models (port of the loading half of
simple3dformer_tpu/utils/torch_convert.py).

The reference downloads Facebook's DeiT ``.pth`` files by URL and loads them
into timm modules (its models/vit_3d_2d_pretrain.py:399-432). Here, as in the
JAX package, nothing is downloaded: ``maybe_load_deit`` reads
``<backbone>.pth`` (or ``.pt``) from ``$DEIT_CKPT_DIR`` (default ``./weights``)
and, without one, warns and keeps the random init.

The port's parameters carry timm's names, so a load is a copy of the entries
that the JAX converter knows (``cls_token``, ``dist_token``, ``pos_embed``,
``patch_embed.proj``, each block's ``norm1``/``norm2``/``attn.qkv``/
``attn.proj``/``mlp.fc1``/``mlp.fc2``, ``norm``, ``head``, ``head_dist``) into the
parameters of the same name and shape: the JAX ``merge_into``'s rule, so both
packages apply the same entries. One name differs: the plain 3DViT calls its
point head ``head`` where the JAX package says ``new_head``, so the DeiT head
is not applied there, as the JAX package does not apply it. A ViT-21k layout is
fitted first, and a position embedding of another grid is resampled (bicubic,
timm's recipe) before the shapes are compared.

The reference-checkpoint importers of the JAX module are not ported.
"""

from __future__ import annotations

import os
import re
import warnings

import torch
import torch.nn.functional as F
from torch import nn

CKPT_DIR_ENV = "DEIT_CKPT_DIR"
DEFAULT_CKPT_DIR = "./weights"

# the entries of a timm state dict that the JAX converter (torch_to_jax_tree) maps
_TOP = ("cls_token", "dist_token", "pos_embed", "patch_embed.proj.weight",
        "patch_embed.proj.bias", "norm.weight", "norm.bias", "head.weight", "head.bias",
        "head_dist.weight", "head_dist.bias")
_BLOCK = re.compile(r"blocks\.\d+\.(norm[12]\.[^.]+|(attn|mlp)\.[^.]+\.[^.]+)")


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A state dict from a ``.pth`` file, unwrapped from ``{"model": ...}``; only
    tensors and containers are unpickled."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def fit_21k_state_dict(sd: dict) -> dict:
    """ViT-21k checkpoints in timm's layout (the reference's fit_dict,
    vit_3d_2d_pretrain.py:16-36): the ``transformer.`` prefix stripped, ``pwff``
    renamed ``mlp``, and separate proj_q/proj_k/proj_v stacked into qkv."""
    out = {}
    for k, v in sd.items():
        if "pwff" in k:
            k = k.replace("pwff", "mlp")
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        out[k] = v
    blocks = sorted({int(m.group(1)) for k in out
                     if (m := re.match(r"blocks\.(\d+)\.attn\.proj_q\.weight", k))})
    for i in blocks:
        for suffix in ("weight", "bias"):
            parts = [out.pop(f"blocks.{i}.attn.proj_{w}.{suffix}") for w in ("q", "k", "v")]
            out[f"blocks.{i}.attn.qkv.{suffix}"] = torch.cat(parts, dim=0)
    return out


def interpolate_pos_embed(pos: torch.Tensor, n_extra_src: int, n_patches_tgt: int,
                          n_extra_tgt: int) -> torch.Tensor:
    """A [1, N, D] position embedding resized to another square patch grid
    (timm's resize_pos_embed): the cls/dist slots split off, the grid resized
    bicubically (align_corners=False), the slots put back; a plain checkpoint
    into a distilled model seeds the dist slot from the cls slot."""
    extra, grid = pos[:, :n_extra_src], pos[:, n_extra_src:]
    gs_src = round(grid.shape[1] ** 0.5)
    gs_tgt = round(n_patches_tgt ** 0.5)
    if gs_src * gs_src != grid.shape[1] or gs_tgt * gs_tgt != n_patches_tgt:
        raise ValueError("non-square patch grid")
    if gs_src != gs_tgt:
        g = grid.reshape(1, gs_src, gs_src, -1).permute(0, 3, 1, 2)
        g = F.interpolate(g, size=(gs_tgt, gs_tgt), mode="bicubic", align_corners=False)
        grid = g.permute(0, 2, 3, 1).reshape(1, gs_tgt * gs_tgt, -1)
    if n_extra_tgt <= n_extra_src:
        extra = extra[:, :n_extra_tgt]
    else:
        extra = torch.cat([extra, extra[:, -1:].repeat(1, n_extra_tgt - n_extra_src, 1)], dim=1)
    return torch.cat([extra, grid], dim=1).to(pos.dtype)


def find_checkpoint(backbone: str) -> str | None:
    d = os.environ.get(CKPT_DIR_ENV, DEFAULT_CKPT_DIR)
    for name in (f"{backbone}.pth", f"{backbone}.pt"):
        path = os.path.join(d, name)
        if os.path.exists(path):
            return path
    return None


def maybe_load_deit(model: nn.Module, backbone: str) -> list[str]:
    """Load the 2D-pretrained weights of ``backbone`` into ``model`` in place if
    a local checkpoint exists; returns the names loaded (none, with a warning,
    when there is no file: the model keeps its random init)."""
    path = find_checkpoint(backbone)
    if path is None:
        warnings.warn(f"No local checkpoint for {backbone} (set ${CKPT_DIR_ENV}); "
                      "continuing with random init.")
        return []
    sd = load_torch_state_dict(path)
    if any("proj_q" in k or k.startswith("transformer.") for k in sd):
        sd = fit_21k_state_dict(sd)
    sd = {k: v for k, v in sd.items() if k in _TOP or _BLOCK.fullmatch(k)}
    params = dict(model.named_parameters())
    if getattr(model, "head_name", None) == "head":  # the plain 3DViT's point head
        sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
    if "pos_embed" in sd and "pos_embed" in params:
        src, tgt = sd["pos_embed"], params["pos_embed"]
        if src.shape != tgt.shape and src.shape[-1] == tgt.shape[-1]:
            n_extra_src = 2 if "dist_token" in sd else 1
            n_extra_tgt = 2 if "dist_token" in params else 1
            sd["pos_embed"] = interpolate_pos_embed(src.float(), n_extra_src,
                                                    tgt.shape[1] - n_extra_tgt, n_extra_tgt)
    applied = [k for k, v in sd.items() if k in params and v.shape == params[k].shape]
    with torch.no_grad():
        for k in applied:
            params[k].copy_(sd[k].float())
    print(f"loaded {len(applied)} tensors from {path}")
    return applied
