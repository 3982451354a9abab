"""Tensor parallelism of the ViT blocks (port of simple3dformer_tpu/parallel/tp.py).

Megatron-style, as the JAX package's sharding rules (its ``COL_PARALLEL`` and
``ROW_PARALLEL``): ``qkv`` and ``fc1`` are split on their outputs, ``proj``
and ``fc2`` on their inputs, so each half of a block ends in one sum over the
``model`` ranks of a layout (parallel/mesh.make_layout(n_data, n_model,
"model")). The JAX package marks the leaves and XLA places the all-reduces;
here each rank keeps only its shards and the block runs its own halves:

  * heads are dealt out whole, in contiguous groups, as evenly as they go (6
    heads over 4 ranks: 2, 2, 1, 1; 3 over 4: 1, 1, 1, 0); ``qkv`` keeps the
    rows of q, k and v of the rank's heads, so the local projection keeps
    timm's [3, H_loc, dh] layout, and ``proj`` the matching input columns. A
    rank with no heads adds a zero partial sum (the plain route; the card's
    kernels need a head a rank). The JAX package splits qkv's last axis in
    equal chunks instead: a different layout of the same sums, so the two are
    compared through full parameters;
  * ``fc1`` keeps a contiguous 1/n of its outputs, ``fc2`` the matching
    inputs; where n does not divide fc1's width the MLP stays whole on every
    rank and takes no sum, as ``_spec_for`` leaves such a leaf replicated;
  * ``bqkv`` and ``b1`` are split; ``bproj``, ``b2`` and both LayerNorms are
    whole, and their gradients come out equal on every model rank.

A block runs one of its two routes (``Block.route``, by shape):

  * fused (N <= 512): ``_TPBlock``, the training chains of
    kernels/vit_block.py cut at their two reductions: the attention half
    (LN1, the qkv GEMM over the local columns, the local heads' attention, the
    proj GEMM over the local inputs: a partial [M, D] without bias or
    residual), the all-reduce, h1 = x + (sum + bproj), the MLP half, the
    all-reduce, y = h1 + (sum + b2). Its backward mirrors it: the MLP half's
    partial g_z2, the all-reduce, the LayerNorm backward with its residual
    (g_h1 = g_y + LN2'(g_z2)), the attention half's partial g_z1, the
    all-reduce, g_x = g_h1 + LN1'(g_z1). Weight gradients stay local;
  * layered: LN, the local products and attention (the ``mhsa`` kernels where
    their gate takes the call) with Megatron's f/g pair
    (mesh.copy_to_group / mesh.reduce_from_group) around each half.

The gradients are averaged over the ``data`` group only (train/loop.py under
``mesh.using_layout``). ``TPTrainState`` writes checkpoints with the full
parameters and moments, gathered over the model ranks, so a run resumes at
any degree; ``shard_state`` / ``gather_state`` are the counterparts of
``vit_tp_shardings`` / ``device_put_tp``, and the optimizer's state follows
the local shards (``shard_like_params``) because the optimizer is made over
the sharded parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from ..kernels import mhsa as mhsa_kernel
from ..kernels import vit_block as vb
from ..nn.layers import Attention, Block, gelu_tanh, linear, softmax_last
from ..train.loop import TrainState
from .mesh import Layout, copy_to_group, group_size, reduce_from_group

def head_split(heads: int, n: int) -> list[tuple[int, int]]:
    """Each rank's [first, last) heads: contiguous, as even as they go."""
    base, extra = divmod(heads, n)
    bounds, h = [], 0
    for r in range(n):
        count = base + (r < extra)
        bounds.append((h, h + count))
        h += count
    return bounds


def mlp_splits(hidden: int, n: int) -> bool:
    """Whether fc1's outputs split over n ranks (``_spec_for``'s rule)."""
    return hidden % n == 0


def block_prefixes(state_dict: dict) -> list[str]:
    """The prefixes of the ViT blocks in a state dict (``...blocks.3.``)."""
    suffix = "attn.qkv.weight"
    return [k[:-len(suffix)] for k in state_dict
            if k.endswith(suffix) and k[:-len(suffix)] + "mlp.fc1.weight" in state_dict]


def _qkv_rows(d: int, lo: int, hi: int, head_dim: int) -> torch.Tensor:
    return torch.cat([torch.arange(t * d + lo * head_dim, t * d + hi * head_dim)
                      for t in range(3)])


SPLIT_SUFFIXES = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                  "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")


def _leaf_slice(suffix: str, d: int, hidden: int, heads: int, n: int, r: int):
    """(axis, indices, full length) of rank r's part of a block leaf, or None
    where the leaf stays whole."""
    if suffix.startswith("attn"):
        head_dim = d // heads
        lo, hi = head_split(heads, n)[r]
        if suffix == "attn.proj.weight":
            return 1, torch.arange(lo * head_dim, hi * head_dim), d
        return 0, _qkv_rows(d, lo, hi, head_dim), 3 * d
    if n == 1 or not mlp_splits(hidden, n):
        return None
    cols = torch.arange(r * hidden // n, (r + 1) * hidden // n)
    return (1 if suffix == "mlp.fc2.weight" else 0), cols, hidden


def _heads_of(heads, prefix: str) -> int:
    return heads[prefix] if isinstance(heads, dict) else int(heads)


def shard_state(state_dict: dict, n: int, r: int, heads) -> dict:
    """Model rank r's part of a full state dict (``heads``: every block's head
    count, or {block prefix: heads}); other leaves are returned as they are."""
    out = dict(state_dict)
    for prefix in block_prefixes(state_dict):
        d = state_dict[prefix + "norm1.weight"].shape[0]
        hidden = state_dict[prefix + "mlp.fc1.weight"].shape[0]
        for suffix in SPLIT_SUFFIXES:
            cut = _leaf_slice(suffix, d, hidden, _heads_of(heads, prefix), n, r)
            if cut is not None:
                t = state_dict[prefix + suffix]
                out[prefix + suffix] = t.index_select(cut[0], cut[1].to(t.device)).contiguous()
    return out


def gather_state(local: dict, n: int, r: int, heads, group, full_shapes: dict) -> dict:
    """The full state dict from every model rank's ``local`` part (every rank
    of ``group`` calls it): each split leaf is laid into zeros at its rank's
    place and summed over the group, exact since each element has one
    nonzero addend. ``full_shapes``: {block prefix: (width, fc1 width)}."""
    out = dict(local)
    for prefix, (d, hidden) in full_shapes.items():
        for suffix in SPLIT_SUFFIXES:
            cut = _leaf_slice(suffix, d, hidden, _heads_of(heads, prefix), n, r)
            if prefix + suffix not in local or cut is None:
                continue
            t = local[prefix + suffix]
            axis, index, length = cut
            shape = list(t.shape)
            shape[axis] = length
            full = t.new_zeros(shape).index_copy_(axis, index.to(t.device), t)
            if group_size(group) > 1:
                dist.all_reduce(full, group=group)
            out[prefix + suffix] = full
    return out


@dataclass
class TPBlock:
    """What a ``Block`` needs to run its tensor-parallel routes."""

    group: object
    n: int
    rank: int
    heads: int  # this rank's
    head_dim: int
    mlp_split: bool

    def __call__(self, block: Block, x: torch.Tensor, seg_len: int | None = None):
        if block.route(x, seg_len) == "fused":
            weights = block.fused_weights()
            return _TPBlock.apply(x, self, block.compute_dtype or x.dtype,
                                  *(weights[k] for k in vb.WNAMES))
        return self.layered(block, x, seg_len)

    def sum_attn(self, t: torch.Tensor) -> torch.Tensor:
        if self.n > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def sum_mlp(self, t: torch.Tensor) -> torch.Tensor:
        return self.sum_attn(t) if self.mlp_split else t

    def layered(self, block: Block, x: torch.Tensor, seg_len: int | None):
        """The layered route on this rank's shards, Megatron's f/g around each half."""
        attn, mlp, cdt = block.attn, block.mlp, block.compute_dtype
        b, n, _ = x.shape
        h = copy_to_group(block.norm1(x), self.group)
        qkv = linear(h, attn.qkv.weight, attn.qkv.bias, cdt)
        q, k, v = qkv.reshape(b, n, 3, self.heads, self.head_dim).unbind(2)  # [B, N, H, dh]
        if x.is_cuda and self.heads and not attn.kernel_unsupported(h, seg_len):
            out = mhsa_kernel.mhsa(q, k, v, attn.scale)
        else:
            if x.is_cuda:
                Attention.plain_calls += 1
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            s = (q * attn.scale) @ k.transpose(-1, -2)
            if seg_len is not None and 0 < seg_len < n:
                seg = torch.arange(n, device=x.device) // seg_len
                s = s.masked_fill(seg[:, None] != seg[None, :], float("-inf"))
            out = (attn.attn_drop(softmax_last(s)) @ v).transpose(1, 2)
        part = linear(out.reshape(b, n, self.heads * self.head_dim), attn.proj.weight, None, cdt)
        a = reduce_from_group(part, self.group)
        a = a + (attn.proj.bias if cdt is None else attn.proj.bias.to(cdt))
        x = x + block.drop_path(attn.proj_drop(a))
        h2 = block.norm2(x)
        h2 = copy_to_group(h2, self.group) if self.mlp_split else h2
        g1 = mlp.drop(gelu_tanh(linear(h2, mlp.fc1.weight, mlp.fc1.bias, cdt)))
        part = linear(g1, mlp.fc2.weight, None, cdt)
        m = reduce_from_group(part, self.group) if self.mlp_split else part
        m = m + (mlp.fc2.bias if cdt is None else mlp.fc2.bias.to(cdt))
        return x + block.drop_path(mlp.drop(m))


class _TPBlock(torch.autograd.Function):
    """The fused route of a tensor-parallel block: the four halves and the two
    reductions a way (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, spec: TPBlock, cdt, *ws):
        w = dict(zip(vb.WNAMES, ws))
        part, res = vb.vit_block_tp_attn_fwd(x, w, spec.heads, spec.head_dim, cdt)
        h1 = x.float() + (spec.sum_attn(part) + w["bproj"])
        part, a1 = vb.vit_block_tp_mlp_fwd(h1, w, cdt)
        y = (h1 + (spec.sum_mlp(part) + w["b2"])).to(x.dtype)
        ctx.spec, ctx.cdt = spec, cdt
        ctx.save_for_backward(x, h1, a1, *(res[k] for k in vb.TP_ATTN_RES), *ws)
        return y

    @staticmethod
    def backward(ctx, g):
        spec, cdt = ctx.spec, ctx.cdt
        x, h1, a1, qkv, o, probs, *ws = ctx.saved_tensors
        w = dict(zip(vb.WNAMES, ws))
        g_y = g.float().contiguous()
        part, gm = vb.vit_block_tp_mlp_bwd(g_y, h1, a1, w, cdt)
        g_h1, g2 = vb.vit_block_tp_ln_bwd(spec.sum_mlp(part), h1, w["ln2_s"], g_y)
        part, ga = vb.vit_block_tp_attn_bwd(x, g_h1, dict(qkv=qkv, o=o, probs=probs), w,
                                            spec.heads, spec.head_dim, cdt)
        g_x, g1 = vb.vit_block_tp_ln_bwd(spec.sum_attn(part), x, w["ln1_s"], g_h1)
        grads = dict(ln1_s=g1["s"], ln1_b=g1["b"], ln2_s=g2["s"], ln2_b=g2["b"], **gm, **ga)
        return (g_x.to(x.dtype), None, None, *(grads[k] for k in vb.WNAMES))


class TensorParallel:
    """A model's blocks split over a layout's ``model`` ranks.

    ``TensorParallel(model, layout)`` replaces each ``Block``'s split leaves
    by this rank's shards (new parameters: make the optimizer afterwards, so
    its state follows them) and sets the block's ``tp`` route."""

    def __init__(self, model: nn.Module, layout: Layout):
        if layout.inner != "model":
            raise ValueError(f"tensor parallelism needs a 'model' layout, got {layout.inner!r}")
        self.model, self.layout = model, layout
        self.n, self.rank, self.group = layout.n_inner, layout.inner_rank, layout.inner_group
        self.blocks = {name + ".": m for name, m in model.named_modules() if isinstance(m, Block)}
        if not self.blocks:
            raise ValueError("the model has no ViT block to split")
        self.heads = {p: blk.num_heads for p, blk in self.blocks.items()}
        self.dims = {p: (blk.norm1.weight.shape[0], blk.mlp.fc1.weight.shape[0])
                     for p, blk in self.blocks.items()}
        local = self.shard(model.state_dict())
        with torch.no_grad():
            for p, blk in self.blocks.items():
                d, hidden = self.dims[p]
                for suffix in SPLIT_SUFFIXES:
                    if _leaf_slice(suffix, d, hidden, blk.num_heads, self.n, self.rank) is None:
                        continue
                    sub, leaf = suffix.rsplit(".", 1)
                    mod = blk.get_submodule(sub)
                    new = nn.Parameter(local[p + suffix].clone(),
                                       requires_grad=getattr(mod, leaf).requires_grad)
                    new.tp_split = True  # mesh.average_gradients buckets it apart
                    setattr(mod, leaf, new)
                lo, hi = head_split(blk.num_heads, self.n)[self.rank]
                blk.tp = TPBlock(self.group, self.n, self.rank, hi - lo, d // blk.num_heads,
                                 self.n > 1 and mlp_splits(hidden, self.n))

    def shard(self, full: dict) -> dict:
        """This rank's part of a full state dict (parameters or moments by name)."""
        return shard_state(full, self.n, self.rank, self.heads)

    def gather(self, local: dict) -> dict:
        """The full state dict from every model rank's part (all of them call it)."""
        return gather_state(local, self.n, self.rank, self.heads, self.group, self.dims)

    def load_full(self, full: dict) -> None:
        """Load a full (unsplit) state dict into the split model."""
        self.model.load_state_dict(self.shard(full))

    def full_state_dict(self) -> dict:
        return self.gather(self.model.state_dict())


def _map_moments(state: dict, fn) -> dict:
    """An optimizer state dict with ``fn`` applied to each of its name -> leaf dicts."""
    return {k: fn(v) if isinstance(v, dict) else v for k, v in state.items()}


class TPTrainState(TrainState):
    """A ``TrainState`` whose checkpoints hold the full parameters and
    moments (gathered over the model ranks; every rank calls ``state_dict``),
    and which loads a full state at any degree."""

    def __init__(self, model: nn.Module, optimizer, tp: TensorParallel):
        super().__init__(model, optimizer)
        self.tp = tp

    def state_dict(self) -> dict:
        return {"params": self.tp.full_state_dict(),
                "opt_state": _map_moments(self.optimizer.state_dict(), self.tp.gather),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.tp.load_full(state["params"])
        self.optimizer.load_state_dict(_map_moments(state["opt_state"], self.tp.shard))
