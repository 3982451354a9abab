"""JAX parameter trees -> the port's state dicts.

The JAX package keeps parameters as a nested dict (flax layout: Dense
``kernel`` [in, out], LayerNorm ``scale``, blocks under ``core/blocks_{i}``).
The port names its parameters as timm and the reference do, the names
``scripts/refbridge.export_voxelvit_state_dict`` produces: Linear ``weight``
[out, in], ``blocks.{i}.attn.qkv.weight``, ``norm.weight``,
``voxel_embed.proj.conv3d_1.weight`` [D, 1, c, c, c], ``voxel_head.weight``;
the group_embed route's encoder as torch's TransformerEncoderLayer names it
(``group_embed.self_attn.in_proj_weight``, ``.self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``), and VoxelEmbedHybrid's
``conv1_kernel`` etc. (DHWIO) as ``voxel_embed.conv1.weight`` [out, in, k, k, k].
Point models take the reference's names as well (the ones
``simple3dformer_tpu/utils/torch_convert.reference_pointvit_to_jax_tree``
reads): ``fc1.0`` / ``fc1.2``, ``transition_downs.{i}.sa.mlp_convs.{j}.weight``
[out, in, 1, 1] and ``mlp_bns.{j}``, ``transition_ups.{i}.fc1.0`` (Linear) and
``fc1.2`` (BatchNorm), the point head ``head`` or ``new_head``; the Hengshuang
models' the names ``reference_hengshuang_to_jax_tree`` reads:
``backbone.fc1.{0,2}`` (JAX ``fc1_1`` / ``fc1_2``), ``fc_delta.{0,2}`` and
``fc_gamma.{0,2}`` (an MLP2's ``fc1`` / ``fc2``), ``transformers.{i}`` (JAX
``transformers_i`` and, in the seg model, ``up_transformers_i``) and the heads
``fc2.{0,2,4}`` / ``fc3.{0,2,4}`` (JAX ``fc1..fc3``). ViP-3D takes the names
``scripts/refbridge.export_vip3d_state_dict`` writes: JAX ``embed_layer`` is
``patch_embed.proj.conv3d_1``, ``stage{i}_block{b}`` is ``network.{ni}.{bj}``
(``ni`` counts the stages and the downsamples before them, ``bj`` skips the
PEG after block 0), ``stage{i}_peg`` is ``network.{ni}.1.proj.0`` (DHWIO ->
[C, 1, 3, 3, 3]) and ``downsample{i}/proj/kernel`` [p^3 Ci, Co] is
``network.{ni + 1}.proj.weight`` [Co, Ci, p, p, p]. The other set
abstractions: RelPos's ``pos_embed_{i}`` is ``pos_embeds.{i}`` (its ``fc1`` /
``fc2`` Linears), MSG's ``branch{i}_mlp{j}/conv`` and ``/bn`` are
``conv_blocks.{i}.{j}`` and ``bn_blocks.{i}.{j}``; ``PointEmbed`` keeps the
JAX names (``conv1.conv.weight`` [64, C, 1], ``conv1.bn``). The legacy voxel
model (``FeatureVoxel2DViT``) keeps the JAX names too: ``conv3d_{i}_kernel``
(DHWIO) is ``conv3d_{i}.weight`` [out, in, k, k, k], the decoder's flax Conv
kernels (HWIO) Conv2d weights [out, in, 3, 3], its ConvTranspose kernel
[2, 2, in, out] the ConvTranspose2d weight [in, out, 2, 2] with both spatial
axes flipped, and ``transformer/...`` a ViT2D's leaves under ``transformer.``.
flax BatchNorm
``scale`` / ``bias`` become ``weight`` / ``bias``, and the ``batch_stats``
tree's ``mean`` / ``var`` the ``running_mean`` / ``running_var`` buffers.
Leaves may be numpy or jax arrays; nothing here imports jax.

``jax_opt_state_to_port`` converts a JAX ``opt_state`` (the optax state of
``simple3dformer_tpu/train/optim.make_optimizer``, numpy leaves, as a
Checkpointer step restores it) into the state of the port's
``train/optim`` optimizer: Adam's ``count``, ``mu`` and ``nu`` (``nu`` in
bfloat16 under ``scale_by_adam_bf16_nu``) or SGD's momentum ``trace``, each
moment leaf named and laid out as its parameter. A trainable mask
(``optax.multi_transform``) leaves masked nodes where frozen leaves are: they
carry no state, as in the port.
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
        p = re.sub(r"^(transition_downs|transition_ups|transformers)_(\d+)$", r"\1.\2", p)
        p = re.sub(r"^up_transformers_(\d+)$", r"transformers.\1", p)  # Hengshuang seg
        p = {"fc1_1": "fc1.0", "fc1_2": "fc1.2"}.get(p, p)  # the Hengshuang stem
        p = re.sub(r"^pos_embed_(\d+)$", r"pos_embeds.\1", p)  # RelPos set abstraction
        m = re.match(r"^mlp_(\d+)$", p)
        msg = re.match(r"^branch(\d+)_mlp(\d+)$", p)  # MSG set abstraction
        head = re.match(r"^fc(\d+)$", p) if i == 1 and prev in ("fc2", "fc3") else None
        if m and nxt in ("conv", "bn"):  # a shared MLP layer: the conv and BN lists
            p = f"mlp_{'convs' if nxt == 'conv' else 'bns'}.{m.group(1)}"
        elif msg and nxt in ("conv", "bn"):
            p = f"{nxt}_blocks.{msg.group(1)}.{msg.group(2)}"
        elif p in ("conv", "bn") and re.match(r"^(mlp_\d+|branch\d+_mlp\d+)$", prev):
            continue
        elif p in ("fc", "bn") and prev in ("fc1", "fc2"):  # LinearBNReLU: Sequential 0, 2
            p = "0" if p == "fc" else "2"
        elif p in ("fc1", "fc2") and prev in ("fc1", "fc_pos_embed", "fc_delta", "fc_gamma"):
            p = "0" if p == "fc1" else "2"  # StemMLP, MLP2: Sequential 0, 2
        elif head:  # a Hengshuang head, Sequential(Linear, ReLU, ...): Linears at 0, 2, 4
            p = str(2 * (int(head.group(1)) - 1))
        elif i == 0 and p == "new_head" and not any(k.startswith("new_head.") for k in like):
            p = "head"  # the plain 3DViT's point head
        out.append(p)
    leaf = {"mean": "running_mean", "var": "running_var"}.get(out[-1])
    return out[:-1] + [leaf] if leaf else out


def _vip3d_stages(like: Mapping[str, torch.Tensor]) -> list[int]:
    """ViP-3D: the ``network`` index of each stage, in order (an entry holding
    ``proj.weight`` is a downsample)."""
    entries = sorted({int(m.group(1)) for k in like
                      for m in [re.match(r"network\.(\d+)\.", k)] if m})
    return [n for n in entries if f"network.{n}.proj.weight" not in like]


def _vip3d_name_and_value(path: tuple, v: np.ndarray, like: Mapping[str, torch.Tensor]):
    """A ViP-3D leaf -> (key, array), or None for a leaf of another model."""
    if path[0] == "embed_layer":
        key = f"patch_embed.proj.conv3d_1.{'weight' if path[-1] == 'kernel' else 'bias'}"
        return key, v.T.reshape(tuple(like[key].shape)) if path[-1] == "kernel" else v
    m = re.fullmatch(r"stage(\d+)_(?:block(\d+)|(peg))|downsample(\d+)", path[0])
    if m is None or not any(k.startswith("network.") for k in like):
        return None
    stages = _vip3d_stages(like)
    if m.group(4) is not None:  # downsample: [p^3 Ci, Co] -> Conv3d [Co, Ci, p, p, p]
        key = f"network.{stages[int(m.group(4))] + 1}.proj.weight"
        co, ci, p = like[key].shape[:3]
        return key, v.reshape(p, p, p, ci, co).transpose(4, 3, 0, 1, 2)
    ni = stages[int(m.group(1))]
    if m.group(3):  # the PEG's depthwise conv: DHWIO -> [C, 1, 3, 3, 3]
        if path[-1] == "kernel":
            return f"network.{ni}.1.proj.0.weight", v.transpose(4, 3, 0, 1, 2)
        return f"network.{ni}.1.proj.0.bias", v
    b = int(m.group(2))
    peg = f"network.{ni}.1.proj.0.weight" in like
    parts = [f"network.{ni}.{b + (1 if peg and b >= 1 else 0)}", *path[1:-1]]
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join([*parts, leaf]), v.T if path[-1] == "kernel" else v


def _legacy_name_and_value(path: tuple, v: np.ndarray, like: Mapping[str, torch.Tensor]):
    """A FeatureVoxel2DViT leaf that the shared rules do not cover -> (key,
    array), else None: the 3D convs (DHWIO -> Conv3d [out, in, k, k, k]) and
    the ViT, whose leaves are converted as a ViT2D's under ``transformer.``."""
    m = re.fullmatch(r"(conv3d_\d+)_(kernel|bias)", path[0])
    if m:
        if m.group(2) == "bias":
            return f"{m.group(1)}.bias", v
        return f"{m.group(1)}.weight", v.transpose(4, 3, 0, 1, 2)
    if path[0] == "transformer":
        sub = {k[len("transformer."):]: t for k, t in like.items()
               if k.startswith("transformer.")}
        key, v = _name_and_value(path[1:], v, sub)
        return f"transformer.{key}", v
    return None


def _conv2d_name_and_value(path: tuple, v: np.ndarray):
    """A flax 2D conv kernel (the legacy model's decoder): HWIO -> Conv2d
    [out, in, 3, 3]; the ConvTranspose's [2, 2, in, out] -> ConvTranspose2d
    [in, out, 2, 2] with both spatial axes flipped, since flax puts x[i] K[1 - a]
    at output 2i + a and torch x[i] w[a]."""
    key = ".".join([*path[:-1], "weight"])
    if path[-2] == "deconv":
        return key, v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return key, v.transpose(3, 2, 0, 1)


def _name_and_value(path: tuple, v: np.ndarray, like: Mapping[str, torch.Tensor]):
    """One JAX leaf -> (state-dict key, array in the port's layout)."""
    if "fc_bn.running_mean" in like:  # the legacy voxel model
        legacy = _legacy_name_and_value(path, v, like)
        if legacy is not None:
            return legacy
    if path[-1] == "kernel" and v.ndim == 4:
        return _conv2d_name_and_value(path, v)
    vip = _vip3d_name_and_value(path, v, like)
    if vip is not None:
        return vip
    if path[0] == "core":
        path = path[1:]
    parts = [re.sub(r"^blocks_(\d+)$", r"blocks.\1", p) for p in path]
    parts = _point_parts(parts, like)
    leaf = parts[-1]
    hybrid = re.fullmatch(r"(conv1|conv2|proj)_(kernel|bias)", leaf)
    if parts[0] == "voxel_embed" and hybrid:  # VoxelEmbedHybrid: DHWIO -> [out, in, k, k, k]
        key = f"voxel_embed.{hybrid.group(1)}.{'weight' if hybrid.group(2) == 'kernel' else 'bias'}"
        return key, v.transpose(4, 3, 0, 1, 2) if v.ndim == 5 else v
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
    if parts[:2] == ["group_embed", "qkv"]:  # TransformerEncoderLayer's packed in_proj
        name = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
        return f"group_embed.self_attn.{name}", v.T if leaf == "kernel" else v
    if parts[:2] == ["group_embed", "out_proj"]:
        parts = ["group_embed", "self_attn"] + parts[1:]
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


def _as_dict(node):
    """A mapping, or a NamedTuple's fields, or None."""
    if isinstance(node, Mapping):
        return node
    return node._asdict() if hasattr(node, "_asdict") else None


def _optimizer_states(node) -> list[Mapping]:
    """Every node of ``node`` that holds Adam's (count, mu, nu) or SGD's trace."""
    d = _as_dict(node)
    if d is not None:
        if {"count", "mu", "nu"} <= set(d) or set(d) == {"trace"}:
            return [d]
        return [s for v in d.values() for s in _optimizer_states(v)]
    if isinstance(node, (list, tuple)):
        return [s for v in node for s in _optimizer_states(v)]
    return []


def find_optimizer_state(opt_state) -> tuple[str, Mapping]:
    """("Adam", {count, mu, nu}) or ("SGD", {trace}): the one moment-holding
    node of a JAX ``opt_state``, whatever chain or ``multi_transform`` wraps it
    (the JAX package's optimizers hold exactly one)."""
    states = _optimizer_states(opt_state)
    if len(states) != 1:
        raise ValueError(f"expected one Adam or SGD state in the JAX opt_state, found "
                         f"{len(states)}")
    return ("Adam" if "mu" in states[0] else "SGD"), states[0]


def _is_array(v) -> bool:
    return hasattr(v, "shape") and hasattr(v, "dtype")


def _unmasked(tree: Mapping) -> dict:
    """The tree without masked nodes (a frozen leaf's None, ``MaskedNode()`` or
    empty node); subtrees left empty are dropped."""
    out = {}
    for k, v in tree.items():
        sub = _as_dict(v)
        if sub is not None and not _is_array(v):
            sub = _unmasked(sub)
            if sub:
                out[k] = sub
        elif _is_array(v):
            out[k] = v
    return out


def _moments(tree: Mapping, like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A moment tree (the parameters' structure) -> {parameter name: f32 tensor}."""
    return jax_to_state_dict(_unmasked(tree), like)


def _is_bf16(tree) -> bool:
    d = _as_dict(tree)
    if d is None:
        return _is_array(tree) and str(tree.dtype) == "bfloat16"
    return any(_is_bf16(v) for v in d.values())


def jax_opt_state_to_port(opt_state, like: Mapping[str, torch.Tensor], names: list[str],
                          step: int) -> dict:
    """A JAX ``opt_state`` -> the state dict of the port optimizer whose
    trainable leaves are ``names`` (``opt.names``), for the model whose state
    dict is ``like``. ``step`` is the JAX TrainState's step: SGD's count (optax's
    trace keeps none). Adam's moments come out as {"count", "mu", "nu"} (nu in
    bfloat16 where the JAX state keeps it so), SGD's as {"count", "trace"}.

    A trainable leaf of the port that the JAX state does not hold is refused,
    unless it is a 2D-pathway leaf that a ``model.init`` tree lacks
    (``TWO_D_PREFIXES``): its gradient is zero there, so its moments are zeros.
    A JAX leaf that is not among ``names`` is refused (the masks differ)."""
    kind, state = find_optimizer_state(opt_state)
    out = {"count": int(np.asarray(state["count"])) if "count" in state else int(step)}
    for moment in ("mu", "nu") if kind == "Adam" else ("trace",):
        leaves = _moments(state[moment], like)
        extra = sorted(set(leaves) - set(names))
        lacking = sorted(set(names) - set(leaves))
        stray = [k for k in lacking if not k.startswith(TWO_D_PREFIXES)]
        if extra or stray:
            raise ValueError(
                f"the JAX optimizer state's trainable leaves differ from the port optimizer's "
                f"(a different mask): state for leaves frozen here {extra[:6]}, none for "
                f"trainable leaves {stray[:6]}")
        dtype = torch.bfloat16 if _is_bf16(state[moment]) else torch.float32
        out[moment] = {k: (leaves[k] if k in leaves else torch.zeros(like[k].shape)).to(dtype)
                       for k in names}
    return out


def load_jax_opt_state(optimizer, model: nn.Module, opt_state, step: int) -> dict:
    """Load a JAX ``opt_state`` into the port's ``optimizer`` (train/optim
    Adam or SGD, or parallel/zero.Zero1Adam, which keeps this rank's part) of
    ``model``; returns the converted state. Adam moments going into an SGD
    optimizer, or the reverse, and a second moment of another dtype than the
    optimizer keeps are refused."""
    state = jax_opt_state_to_port(opt_state, model.state_dict(), list(optimizer.names), step)
    theirs = "Adam" if "mu" in state else "SGD"
    ours = "Adam" if hasattr(optimizer, "mu") else "SGD"
    if theirs != ours:
        raise ValueError(f"the JAX optimizer state is {theirs}'s "
                         f"({'mu, nu' if theirs == 'Adam' else 'trace'}), the port optimizer "
                         f"is {ours}")
    if ours == "Adam":
        bf16 = any(v.dtype == torch.bfloat16 for v in state["nu"].values())
        if state["nu"] and bf16 != optimizer.bf16_nu:
            raise ValueError(f"the JAX state keeps Adam's nu in {'bf16' if bf16 else 'f32'}, "
                             f"the port optimizer in {'bf16' if optimizer.bf16_nu else 'f32'}")
    optimizer.load_state_dict(state)
    return state
