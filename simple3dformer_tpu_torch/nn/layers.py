"""Shared NN building blocks (port of simple3dformer_tpu/nn/layers.py).

timm's Mlp / Attention / Block / DropPath with timm parameter names, so a
timm or reference state dict loads as it is. Parameters are f32. Every module
takes an optional ``torch.Generator`` (init draws on the CPU from it, so one
seed gives the same weights on any device) and a ``device``.

``Block`` on a CUDA tensor runs the whole block as the port's fused CUDA
kernels (kernels/vit_block.py) up to N = 512 tokens, and otherwise the
layered modules, attention as the port's ``mhsa`` kernels (kernels/mhsa.py)
where their gate takes the call and as plain PyTorch products where it does
not (the JAX package's XLA attention); on a CPU tensor it runs the plain
modules below.

``dense(..., dtype=torch.bfloat16)`` computes as flax ``Dense(dtype=bf16)``:
input, weight and bias cast to bf16, the product and the bias added in bf16;
the parameters stay f32 and their gradients come back f32 through the cast.
``Mlp``, ``Attention``, ``Block`` and ``MlpHead`` take that compute dtype for
every Linear, as the JAX modules' ``dtype`` does; ``LayerNorm`` and
``BatchNorm`` return f32 from a bf16 input, as flax's do (the promoted dtype
of the input and the f32 parameters), so a block's residual stream keeps the
dtype it enters with.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import rng
from ..core.rng import DeviceGenerators
from ..parallel.mesh import all_reduce_sum, batch_stats_reduction
from ..kernels import mhsa as mhsa_kernel
from ..kernels.vit_block import (fused_vit_block, fused_vit_block_train, records_grad,
                                 unsupported)


def trunc_normal(shape, std: float = 0.02, generator: torch.Generator | None = None) -> torch.Tensor:
    """CPU tensor drawn from N(0, std) truncated at two standard deviations."""
    t = torch.empty(shape)
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """F.linear, or with a compute dtype flax ``Dense(dtype=...)``: the input,
    weight and bias cast to it, the product and the bias added in it."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class Dense(nn.Linear):
    """nn.Linear with an optional compute dtype (``linear``); the parameters
    keep their own dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.compute_dtype)


def dense(in_features: int, out_features: int, bias: bool = True,
          generator: torch.Generator | None = None, device=None,
          dtype: torch.dtype | None = None) -> Dense:
    """``Dense`` with timm's init: trunc_normal(0.02) weight, zero bias."""
    layer = Dense(in_features, out_features, bias=bias, device=device, dtype=dtype)
    with torch.no_grad():
        layer.weight.copy_(trunc_normal((out_features, in_features), 0.02, generator))
        if bias:
            layer.bias.zero_()
    return layer


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh form, as flax's ``nn.gelu``: in f32 PyTorch's one op (JAX's
    function within rounding); in bf16 JAX's steps, each rounded to bf16 with
    its constants (``jax.nn.gelu``), where one f32 evaluation rounded once
    would differ from it in a third of the elements."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    # the constants as 0-dim host tensors in x's dtype: rounded as JAX rounds
    # them, and read as scalars by a CUDA op (no copy to the card, no wait)
    c, a = (torch.tensor(v, dtype=x.dtype) for v in (math.sqrt(2.0 / math.pi), 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * x ** 3))))


def softmax_last(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax``: in f32 PyTorch's one op;
    in bf16 its steps (shift by the max, exp, divide by the sum), each rounded."""
    if s.dtype == torch.float32:
        return s.softmax(-1)
    e = (s - s.amax(-1, keepdim=True)).exp()
    return e / e.sum(-1, keepdim=True)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm in the promoted dtype of its input and its parameters, as
    flax's LayerNorm returns: f32 from a bf16 input and f32 parameters."""

    def forward(self, x):
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """Set every BatchNorm's (flax) momentum, as the segmentation schedules do."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = momentum


class Mlp(nn.Module):
    """fc1 -> GELU (tanh form, as flax nn.gelu) -> drop -> fc2 -> drop."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.fc1 = dense(in_features, hidden_features, **kw)
        self.fc2 = dense(hidden_features, out_features, **kw)
        self.drop = nn.Dropout(drop)

    def forward(self, x):
        x = self.drop(gelu_tanh(self.fc1(x)))
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Multi-head self-attention with one packed qkv projection.

    The qkv weight's rows order as (q, k, v), each [heads, head_dim], as in
    timm. ``seg_len`` packs several length-seg_len sequences into one row and
    masks attention to within each segment (block-diagonal).

    q, k and v come out of the qkv projection in the compute dtype ``dtype``
    (None: the input's). On a CUDA tensor the attention is the ``mhsa`` kernels
    where their gate takes the call (``kernel_unsupported``: 256 <= N <= 2048, a
    head_dim and q's dtype the kernels take, no live attention dropout, no
    ``seg_len``), and the
    plain products below everywhere else, as the JAX package takes XLA
    attention wherever its kernel cannot run (simple3dformer_tpu/nn/layers.py:
    162-191). The route is chosen by shape before any launch: a kernel that
    fails still raises. ``Attention.plain_calls`` counts the plain attention
    calls on the card. On a CPU tensor it is the plain products.

    Inside ``recording_attention()`` every call takes the plain products and
    the first call of each module keeps its post-softmax, pre-dropout map
    [B, H, N, N], as the JAX Attention sows it (its ``intermediates``).
    """

    plain_calls = 0
    recorder: dict | None = None  # module -> map while recording_attention() is open

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.qkv = dense(dim, 3 * dim, bias=qkv_bias, **kw)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = dense(dim, dim, **kw)
        self.proj_drop = nn.Dropout(proj_drop)

    def kernel_unsupported(self, x: torch.Tensor, seg_len: int | None = None) -> str | None:
        """Why the ``mhsa`` kernels cannot run this call, or None when they can."""
        n, c = x.shape[-2:]
        if not mhsa_kernel.MIN_N <= n <= mhsa_kernel.MAX_N:
            return f"sequence length {n} outside {mhsa_kernel.MIN_N}..{mhsa_kernel.MAX_N}"
        if self.training and self.attn_drop.p:
            return "attention dropout is live (training mode with a nonzero rate)"
        if seg_len is not None:
            return "the kernel takes no seg_len mask"
        if Attention.recorder is not None:
            return "attention maps are being recorded"
        return mhsa_kernel.unsupported(n, c // self.num_heads, self.qkv.compute_dtype or x.dtype)

    def forward_kernel(self, x):
        """The kernel route: q, k, v as views of the qkv projection, ``mhsa``,
        then proj (on a CPU tensor ``mhsa`` runs its plain versions)."""
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads).unbind(2)
        out = mhsa_kernel.mhsa(q, k, v, self.scale).reshape(b, n, c)
        return self.proj_drop(self.proj(out))

    def forward(self, x, seg_len: int | None = None):
        b, n, c = x.shape
        h = self.num_heads
        if x.is_cuda:
            if not self.kernel_unsupported(x, seg_len):
                return self.forward_kernel(x)
            Attention.plain_calls += 1
        q, k, v = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-1, -2)  # [B, H, N, N]
        if seg_len is not None and 0 < seg_len < n:
            seg = torch.arange(n, device=x.device) // seg_len
            attn = attn.masked_fill(seg[:, None] != seg[None, :], float("-inf"))
        attn = softmax_last(attn)
        if Attention.recorder is not None:
            Attention.recorder.setdefault(self, attn.detach())
        out = (self.attn_drop(attn) @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj_drop(self.proj(out))


@contextlib.contextmanager
def recording_attention():
    """Within the block, every ``Attention`` takes the plain products (every
    ``Block`` its layered route: no fused block and no ``mhsa`` launch) and
    the first call of each keeps its attention map; yields the dict
    module -> map [B, H, N, N], in the order of the first calls. The kernels
    are back once the block is left."""
    before = Attention.recorder
    Attention.recorder = {}
    try:
        yield Attention.recorder
    finally:
        Attention.recorder = before


class DropPath(nn.Module):
    """Stochastic depth: drop the residual branch per sample while training.

    As the JAX module: one Bernoulli(1 - rate) draw a sample, kept samples
    divided by 1 - rate. The mask is drawn on the input's device, from a
    generator there seeded with ``seed`` on first use, so a step on the card
    copies nothing from the host.
    """

    def __init__(self, rate: float = 0.0, seed: int = 0):
        super().__init__()
        self.rate = rate
        self.generators = DeviceGenerators(seed)

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = rng.rand(shape, self.generators(x.device)) < keep
        return torch.where(mask, x / keep, 0.0)


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(ln(x)); x + mlp(ln(x)).

    On a CUDA tensor ``route`` picks one of two routes, as the JAX package's
    Block and Attention dispatch (simple3dformer_tpu/nn/layers.py:155-177,
    268-318):

    - ``"fused"`` (N <= 512): the whole block is one call of the fused
      kernels. A gradient to record in train mode runs
      ``fused_vit_block_train`` (the residual-saving forward and the
      residual backward), in eval mode ``fused_vit_block`` (its backward
      recomputes the forward); with nothing to record
      (``torch.inference_mode()``, serving) the forward kernel alone runs.
      The kernels take no dropout, drop-path or ``seg_len`` mask. Their
      matmul operands are in the compute dtype (the JAX block passes its
      ``dtype`` to the kernels), the output in the input's dtype.
    - ``"layered"`` (wherever the fused kernels cannot run): the modules one
      by one; LayerNorm, the Linear layers and GELU are PyTorch's, attention
      is the ``mhsa`` kernels where their gate takes the call and the plain
      products elsewhere (see ``Attention``).

    On a CPU tensor the block runs the plain modules. A block split over
    model ranks (parallel/tp.py sets ``tp``) runs the same two routes on its
    shards, on either device (the fused route's plain versions on the CPU).
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, norm_eps: float = 1e-6, drop_path_seed: int = 0,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.qkv_bias = qkv_bias
        self.compute_dtype = dtype
        self.rates = (drop, attn_drop, drop_path)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, eps=norm_eps, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop, **kw)
        self.drop_path = DropPath(drop_path, drop_path_seed)
        self.norm2 = LayerNorm(dim, eps=norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop, **kw)
        self.tp = None  # parallel/tp.TPBlock once the block is split over model ranks

    def fused_weights(self) -> dict[str, torch.Tensor]:
        """The kernel's twelve weights (kernels/vit_block.WNAMES), no copies."""
        return dict(
            ln1_s=self.norm1.weight, ln1_b=self.norm1.bias,
            wqkv=self.attn.qkv.weight, bqkv=self.attn.qkv.bias,
            wproj=self.attn.proj.weight, bproj=self.attn.proj.bias,
            ln2_s=self.norm2.weight, ln2_b=self.norm2.bias,
            w1=self.mlp.fc1.weight, b1=self.mlp.fc1.bias,
            w2=self.mlp.fc2.weight, b2=self.mlp.fc2.bias,
        )

    def fused_unsupported(self, x: torch.Tensor, seg_len: int | None = None) -> str | None:
        """Why the fused kernel cannot run this call, or None when it can."""
        if x.ndim != 3:
            return f"input must be [B, N, D], got {tuple(x.shape)}"
        if self.mlp_ratio != 4.0 or not self.qkv_bias:
            return "the kernel needs mlp_ratio 4 and a qkv bias"
        if self.norm1.eps != 1e-6 or self.norm2.eps != 1e-6:
            return "the kernel's LayerNorm eps is 1e-6"
        if self.training and any(self.rates):
            return "dropout or drop-path is live (training mode with a nonzero rate)"
        if seg_len is not None:
            return "the kernel takes no seg_len mask"
        if Attention.recorder is not None:
            return "attention maps are being recorded"
        return unsupported(x.shape[1], x.shape[2], self.num_heads)

    def route(self, x: torch.Tensor, seg_len: int | None = None) -> str:
        """``"fused"`` or ``"layered"``: how this call runs on CUDA, by shape."""
        return "layered" if self.fused_unsupported(x, seg_len) else "fused"

    def forward(self, x, seg_len: int | None = None):
        if self.tp is not None:
            return self.tp(self, x, seg_len)
        if x.is_cuda and self.route(x, seg_len) == "fused":
            weights = self.fused_weights()
            if self.training and records_grad(x, weights):
                return fused_vit_block_train(x, weights, self.num_heads, self.compute_dtype)
            return fused_vit_block(x, weights, self.num_heads, self.compute_dtype)
        x = x + self.drop_path(self.attn(self.norm1(x), seg_len=seg_len))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class MlpHead(nn.Module):
    """Stack of Linear+ReLU layers ending in a linear classifier (fc1..fcK)."""

    def __init__(self, in_features: int, widths: tuple, n_out: int,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        dims = (in_features, *widths, n_out)
        for i in range(len(dims) - 1):
            self.add_module(f"fc{i + 1}", dense(dims[i], dims[i + 1], generator=generator,
                                                device=device, dtype=dtype))
        self.depth = len(dims) - 1

    def forward(self, x):
        for i in range(1, self.depth + 1):
            x = getattr(self, f"fc{i}")(x)
            if i < self.depth:
                x = F.relu(x)
        return x


class AMSoftmaxLayer(nn.Module):
    """Additive-margin softmax head: s * cos(theta) logits.

    W is [in_features, n_classes], as in the JAX package and the reference.
    Features and weight columns are L2-normalised (norms clamped at 1e-12);
    the product is in the features' dtype, as the JAX layer's.
    """

    def __init__(self, in_features: int, n_classes: int, s: float = 30.0,
                 generator=None, device=None):
        super().__init__()
        self.s = s
        w = torch.empty(in_features, n_classes)
        nn.init.xavier_normal_(w, generator=generator)
        self.W = nn.Parameter(w.to(device))

    def forward(self, x):
        x_norm = x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        w_norm = self.W.norm(dim=0, keepdim=True).clamp_min(1e-12)
        return (x / x_norm) @ (self.W / w_norm).to(x.dtype) * self.s


def _global_moments(rows: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and flax's fast variance over the [rows, C] f32 of every rank of ``group``."""
    c = rows.shape[-1]
    stats = all_reduce_sum(torch.cat([rows.sum(0), (rows * rows).sum(0),
                                      rows.new_full((1,), rows.shape[0])]), group)
    mean = stats[:c] / stats[-1]
    return mean, torch.clamp_min(stats[c:2 * c] / stats[-1] - mean * mean, 0.0)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis, channel-last input [..., C].

    Not torch's BatchNorm: the batch variance is flax's fast form
    max(E[x^2] - E[x]^2, 0), biased, and the running statistics move as
    ``ra = momentum * ra + (1 - momentum) * batch`` with flax's momentum (0.9
    is torch's 0.1), the running variance taking that same biased variance.
    Statistics run over every axis but the last, in f32; eps 1e-5. In train
    mode the batch statistics normalise and the running ones are updated; in
    eval mode the running ones normalise. The output takes the promoted dtype
    of the input and the f32 parameters, as flax's does: f32 from a bf16
    input. The state-dict
    names are torch's (``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``num_batches_tracked``), so a reference BatchNorm's
    state dict loads as it is.

    In a data-parallel step whose batch is split over the ranks
    (parallel/mesh.data_split), the statistics are the global batch's, as
    flax computes them on a sharded array: the f32 sum, the sum of squares
    and the count go through one differentiable all-reduce, then the same
    fast variance. Every rank gets the same numbers, so the running
    statistics stay bit-equal across ranks. Under a ``seq`` layout
    (parallel/sp.py) the sums run over data x seq: each rank holds part of
    every cloud's points.
    """

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long,
                                                                device=device))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            group, ranks = batch_stats_reduction()
            if ranks > 1:
                mean, var = _global_moments(xf.reshape(-1, xf.shape[-1]), group)
            else:
                axes = tuple(range(x.ndim - 1))
                mean = xf.mean(axes)
                var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
                self.num_batches_tracked += 1
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return y + self.bias
