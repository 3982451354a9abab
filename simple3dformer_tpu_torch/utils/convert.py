"""JAX parameter trees -> the port's state dicts.

The JAX package keeps parameters as a nested dict (flax layout: Dense
``kernel`` [in, out], LayerNorm ``scale``, blocks under ``core/blocks_{i}``).
The port names its parameters as timm and the reference do, the names
``scripts/refbridge.export_voxelvit_state_dict`` produces: Linear ``weight``
[out, in], ``blocks.{i}.attn.qkv.weight``, ``norm.weight``,
``voxel_embed.proj.conv3d_1.weight`` [D, 1, c, c, c], ``voxel_head.weight``.
Point models take the reference's names as well (the ones
``simple3dformer_tpu/utils/torch_convert.reference_pointvit_to_jax_tree``
reads): ``fc1.0`` / ``fc1.2``, ``transition_downs.{i}.sa.mlp_convs.{j}.weight``
[out, in, 1, 1] and ``mlp_bns.{j}``, ``transition_ups.{i}.fc1.0`` (Linear) and
``fc1.2`` (BatchNorm), the point head ``head`` or ``new_head``. flax BatchNorm
``scale`` / ``bias`` become ``weight`` / ``bias``, and the ``batch_stats``
tree's ``mean`` / ``var`` the ``running_mean`` / ``running_var`` buffers.
Leaves may be numpy or jax arrays; nothing here imports jax.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

# 2D-pathway parameters: absent from a tree made by model.init (they appear
# only when init_all touches forward_images)
TWO_D_PREFIXES = ("patch_embed.", "pos_embed", "head.")


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.array(v, dtype=np.float32)  # a writable copy


def _point_parts(parts: list[str], like: Mapping[str, torch.Tensor]) -> list[str]:
    """The point models' module names, JAX -> the reference's."""
    out = []
    for i, p in enumerate(parts):
        prev = parts[i - 1] if i else ""
        nxt = parts[i + 1] if i + 1 < len(parts) else ""
        p = re.sub(r"^(transition_downs|transition_ups)_(\d+)$", r"\1.\2", p)
        m = re.match(r"^mlp_(\d+)$", p)
        if m and nxt in ("conv", "bn"):  # a shared MLP layer: the conv and BN lists
            p = f"mlp_{'convs' if nxt == 'conv' else 'bns'}.{m.group(1)}"
        elif p in ("conv", "bn") and prev.startswith("mlp_"):
            continue
        elif p in ("fc", "bn") and prev in ("fc1", "fc2"):  # LinearBNReLU: Sequential 0, 2
            p = "0" if p == "fc" else "2"
        elif p in ("fc1", "fc2") and prev in ("fc1", "fc_pos_embed"):  # StemMLP
            p = "0" if p == "fc1" else "2"
        elif i == 0 and p == "new_head" and not any(k.startswith("new_head.") for k in like):
            p = "head"  # the plain 3DViT's point head
        out.append(p)
    leaf = {"mean": "running_mean", "var": "running_var"}.get(out[-1])
    return out[:-1] + [leaf] if leaf else out


def _name_and_value(path: tuple, v: np.ndarray, like: Mapping[str, torch.Tensor]):
    """One JAX leaf -> (state-dict key, array in the port's layout)."""
    if path[0] == "core":
        path = path[1:]
    parts = [re.sub(r"^blocks_(\d+)$", r"blocks.\1", p) for p in path]
    parts = _point_parts(parts, like)
    leaf = parts[-1]
    if parts[0] == "voxel_embed":
        conv = next(c for c in ("conv3d_1", "conv2d_1")
                    if f"voxel_embed.proj.{c}.weight" in like)
        key = f"voxel_embed.proj.{conv}.{'weight' if leaf == 'kernel' else leaf}"
        if leaf == "kernel":  # [(cells), D] -> [D, 1, c, c(, c)]
            v = v.T.reshape(tuple(like[key].shape))
        return key, v
    if parts[0] == "patch_embed":
        if leaf == "bias":
            return "patch_embed.proj.bias", v
        key = "patch_embed.proj.weight"
        d, c, p, _ = like[key].shape  # [(P P C), D] -> [D, C, P, P]
        return key, v.reshape(p, p, c, d).transpose(3, 2, 0, 1)
    if leaf == "kernel":  # [in, out] -> [out, in] (a 1x1 conv's [out, in, 1, ...])
        key = ".".join(parts[:-1] + ["weight"])
        return key, v.T.reshape(like[key].shape) if key in like else v.T
    if leaf == "scale":
        return ".".join(parts[:-1] + ["weight"]), v
    return ".".join(parts), v


def jax_to_state_dict(params: Mapping, like: Mapping[str, torch.Tensor],
                      batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """Convert a JAX parameter tree (and its ``batch_stats`` tree) to state-dict
    entries of the model whose state dict is ``like``; every key and shape is
    checked against it."""
    out = {}
    for path, v in [*_leaves(params), *_leaves(batch_stats or {})]:
        key, v = _name_and_value(path, v, like)
        if key not in like:
            raise KeyError(f"JAX parameter {'/'.join(path)} -> {key}: no such parameter")
        if tuple(v.shape) != tuple(like[key].shape):
            raise ValueError(f"{key}: shape {tuple(v.shape)} from JAX, "
                             f"{tuple(like[key].shape)} in the model")
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Mapping | None = None) -> list[str]:
    """Load a JAX parameter tree (and its ``batch_stats``) into ``model``;
    returns the keys left as they were, which may only be the 2D pathway's (a
    ``model.init`` tree has none) and BatchNorm step counters."""
    sd = jax_to_state_dict(params, model.state_dict(), batch_stats)
    missing = model.load_state_dict(sd, strict=False).missing_keys
    stray = [k for k in missing
             if not k.startswith(TWO_D_PREFIXES) and not k.endswith("num_batches_tracked")]
    if stray:
        raise KeyError(f"JAX tree lacks parameters of the model: {stray}")
    return missing
