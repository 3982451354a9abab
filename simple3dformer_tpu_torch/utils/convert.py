"""JAX parameter trees -> the port's state dicts.

The JAX package keeps parameters as a nested dict (flax layout: Dense
``kernel`` [in, out], LayerNorm ``scale``, blocks under ``core/blocks_{i}``).
The port names its parameters as timm and the reference do, the names
``scripts/refbridge.export_voxelvit_state_dict`` produces: Linear ``weight``
[out, in], ``blocks.{i}.attn.qkv.weight``, ``norm.weight``,
``voxel_embed.proj.conv3d_1.weight`` [D, 1, c, c, c], ``voxel_head.weight``.
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


def _name_and_value(path: tuple, v: np.ndarray, like: Mapping[str, torch.Tensor]):
    """One JAX leaf -> (state-dict key, array in the port's layout)."""
    if path[0] == "core":
        path = path[1:]
    parts = [re.sub(r"^blocks_(\d+)$", r"blocks.\1", p) for p in path]
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
    if leaf == "kernel":
        return ".".join(parts[:-1] + ["weight"]), v.T
    if leaf == "scale":
        return ".".join(parts[:-1] + ["weight"]), v
    return ".".join(parts), v


def jax_to_state_dict(params: Mapping, like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Convert a JAX parameter tree to state-dict entries of the model whose
    state dict is ``like``; every key and shape is checked against it."""
    out = {}
    for path, v in _leaves(params):
        key, v = _name_and_value(path, v, like)
        if key not in like:
            raise KeyError(f"JAX parameter {'/'.join(path)} -> {key}: no such parameter")
        if tuple(v.shape) != tuple(like[key].shape):
            raise ValueError(f"{key}: shape {tuple(v.shape)} from JAX, "
                             f"{tuple(like[key].shape)} in the model")
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def load_jax_params(model: nn.Module, params: Mapping) -> list[str]:
    """Load a JAX parameter tree into ``model``; returns the keys left as they
    were, which may only be the 2D pathway's (a ``model.init`` tree has none)."""
    sd = jax_to_state_dict(params, model.state_dict())
    missing = model.load_state_dict(sd, strict=False).missing_keys
    stray = [k for k in missing if not k.startswith(TWO_D_PREFIXES)]
    if stray:
        raise KeyError(f"JAX tree lacks parameters of the model: {stray}")
    return missing
