"""DeiT and reference checkpoints -> the port's models (port of
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

The reference's own trained checkpoints come in two schemes: a bare state
dict, perhaps with DDP's ``module.`` prefix (its train_cls_voxel.py), and the
Hydra scripts' ``{"epoch", <metrics>, "model_state_dict",
"optimizer_state_dict"}``. ``load_reference_checkpoint`` unwraps either. The
four family maps (``reference_{voxelvit,hengshuang,pointvit,vip3d}_to_state_dict``)
take a reference state dict to the port's: the port's parameters and buffers
carry the reference's names and layouts (utils/convert.py), so each entry is a
copy, checked for its shape; each family drops the entries its reference
model builds and never reads (``REFERENCE_DEAD``) and warns of any other it
has no place for. ``import_reference_state`` loads the result and, as the
JAX ``import_reference_state(require_full=True)``, raises unless every
parameter and buffer of the port model was filled, naming the first that
were not.
"""

from __future__ import annotations

import os
import re
import warnings

import numpy as np
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


# Entries of the reference's models that their forwards never read, by family
# (the JAX importers ignore them too; scripts/refbridge.py writes them as
# zeros): each set abstraction's ``last_pos_embed`` MLP
# (pointnet_util.py:212-216), the plain 3DViT's 2D ``pos_embed`` and its
# PointEmbed ``patch_embed`` (3DViT/model.py:227), ViP-3D's ``mlp_z``
# (vip_3d.py:52; the z mix reuses mlp_w).
REFERENCE_DEAD = {
    "voxelvit": (),
    "hengshuang": (r"\.sa\.last_pos_embed\.",),
    "pointvit": (r"\.sa\.last_pos_embed\.", r"^pos_embed$",
                 r"^patch_embed\.(conv\d|bn\d|gather_local_\d)\."),
    "vip3d": (r"\.attn\.mlp_z\.",),
}


def _numpy_scalar_globals() -> list:
    """What a pickled numpy scalar needs: the Hydra scripts store their metrics
    as numpy floats beside the tensors."""
    try:
        from numpy._core.multiarray import scalar
    except ImportError:  # numpy 1
        from numpy.core.multiarray import scalar
    kinds = {type(np.dtype(t)) for t in (np.float64, np.float32, np.int64, np.int32, np.bool_)}
    return [scalar, np.dtype, *kinds]


def load_reference_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    """A reference checkpoint file -> (state dict, metadata). Either scheme;
    DDP's ``module.`` prefixes are stripped; the metadata are the Hydra
    scheme's other entries but the optimizer's (empty for a bare state dict).
    Only tensors, containers, plain numbers and numpy scalars are unpickled."""
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    if isinstance(obj, dict) and "model_state_dict" in obj:
        meta = {k: v for k, v in obj.items()
                if k not in ("model_state_dict", "optimizer_state_dict")}
        obj = obj["model_state_dict"]
    return {k.removeprefix("module."): torch.as_tensor(v) for k, v in obj.items()}, meta


def _reference_to_state_dict(sd: dict, like: dict, family: str) -> dict[str, torch.Tensor]:
    """The entries of ``like`` (a port state dict) found in ``sd``, each of
    ``like``'s shape and dtype; warns of reference entries neither taken nor
    dead in ``family``."""
    out = {}
    for k, t in like.items():
        if k in sd:
            v = torch.as_tensor(sd[k])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"reference entry {k} has shape {tuple(v.shape)}, "
                                 f"the port's {tuple(t.shape)}")
            out[k] = v.to(t.dtype)
    dead = re.compile("|".join(REFERENCE_DEAD[family])) if REFERENCE_DEAD[family] else None
    unused = [k for k in sd if k not in out and not (dead and dead.search(k))]
    if unused:
        warnings.warn(f"{len(unused)} entries of the {family} reference checkpoint have no "
                      f"place in the port model, first {unused[:6]}")
    return out


def reference_voxelvit_to_state_dict(sd: dict, like: dict) -> dict[str, torch.Tensor]:
    """The reference's Feature3D_ViT2D_V2 -> the port's VoxelViT: the backbone
    in timm's names, the tokenizer's ``voxel_embed.proj.conv3d_1``,
    ``voxel_pos_embed``, ``voxel_head`` and the group_embed route's encoder."""
    return _reference_to_state_dict(sd, like, "voxelvit")


def reference_hengshuang_to_state_dict(sd: dict, like: dict) -> dict[str, torch.Tensor]:
    """The reference's Hengshuang PointTransformerCls / Seg -> the port's, the
    BatchNorm running statistics with them."""
    return _reference_to_state_dict(sd, like, "hengshuang")


def reference_pointvit_to_state_dict(sd: dict, like: dict) -> dict[str, torch.Tensor]:
    """The reference's 3DViT family -> the port's PointViT, the BatchNorm
    running statistics with it; the image variants' 2D pathway is live."""
    return _reference_to_state_dict(sd, like, "pointvit")


def reference_vip3d_to_state_dict(sd: dict, like: dict) -> dict[str, torch.Tensor]:
    """The reference's VisionPermutator3D -> the port's: stage s, block b at
    ``network.{ni}.{bj}`` in both (utils/convert.py)."""
    return _reference_to_state_dict(sd, like, "vip3d")


def import_reference_state(model: nn.Module, state: dict,
                           require_full: bool = True) -> list[str]:
    """Load ``state`` (a family map's output) into ``model``; -> the names of the
    model's entries it did not fill. With ``require_full`` every parameter and
    buffer must be filled, or this raises and names the first that were not."""
    like = model.state_dict()
    missing = [k for k in like if k not in state]
    if require_full and missing:
        raise ValueError(f"incomplete reference import: {len(like) - len(missing)}/{len(like)} "
                         f"entries matched, first unmatched {missing[:6]}")
    model.load_state_dict(state, strict=False)
    return missing
