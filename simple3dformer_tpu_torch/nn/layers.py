"""Shared NN building blocks (port of simple3dformer_tpu/nn/layers.py).

timm's Mlp / Attention / Block / DropPath with timm parameter names, so a
timm or reference state dict loads as it is. Parameters are f32. Every module
takes an optional ``torch.Generator`` (init draws on the CPU from it, so one
seed gives the same weights on any device) and a ``device``.

``Block`` on a CUDA tensor runs the whole block as the port's CUDA kernels
(kernels/vit_block.py), forward and backward; on a CPU tensor it runs the
plain modules below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.vit_block import (fused_vit_block, fused_vit_block_train, records_grad,
                                 unsupported)


def trunc_normal(shape, std: float = 0.02, generator: torch.Generator | None = None) -> torch.Tensor:
    """CPU tensor drawn from N(0, std) truncated at two standard deviations."""
    t = torch.empty(shape)
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def dense(in_features: int, out_features: int, bias: bool = True,
          generator: torch.Generator | None = None, device=None) -> nn.Linear:
    """nn.Linear with timm's init: trunc_normal(0.02) weight, zero bias."""
    layer = nn.Linear(in_features, out_features, bias=bias, device=device)
    with torch.no_grad():
        layer.weight.copy_(trunc_normal((out_features, in_features), 0.02, generator))
        if bias:
            layer.bias.zero_()
    return layer


class Mlp(nn.Module):
    """fc1 -> GELU (tanh form, as flax nn.gelu) -> drop -> fc2 -> drop."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0, generator=None, device=None):
        super().__init__()
        self.fc1 = dense(in_features, hidden_features, generator=generator, device=device)
        self.fc2 = dense(hidden_features, out_features, generator=generator, device=device)
        self.drop = nn.Dropout(drop)

    def forward(self, x):
        x = self.drop(F.gelu(self.fc1(x), approximate="tanh"))
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Multi-head self-attention with one packed qkv projection.

    The qkv weight's rows order as (q, k, v), each [heads, head_dim], as in
    timm. ``seg_len`` packs several length-seg_len sequences into one row and
    masks attention to within each segment (block-diagonal).
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 generator=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = dense(dim, 3 * dim, bias=qkv_bias, generator=generator, device=device)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = dense(dim, dim, generator=generator, device=device)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x, seg_len: int | None = None):
        b, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-1, -2)  # [B, H, N, N]
        if seg_len is not None and 0 < seg_len < n:
            seg = torch.arange(n, device=x.device) // seg_len
            attn = attn.masked_fill(seg[:, None] != seg[None, :], float("-inf"))
        attn = self.attn_drop(attn.softmax(-1))
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj_drop(self.proj(out))


class DropPath(nn.Module):
    """Stochastic depth: drop the residual branch per sample while training."""

    def __init__(self, rate: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=self.generator).to(x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(ln(x)); x + mlp(ln(x)).

    On a CUDA tensor the block is one call of the fused kernels, dispatched
    as the JAX package's Block dispatches (simple3dformer_tpu/nn/layers.py:307):
    a gradient to record in train mode runs ``fused_vit_block_train`` (the
    residual-saving forward and the residual backward), in eval mode
    ``fused_vit_block`` (its backward recomputes the forward); with nothing
    to record (``torch.inference_mode()``, serving) the forward kernel alone
    runs. The kernels take no dropout, so on CUDA a block with live dropout
    or drop-path, a ``seg_len`` mask, or a shape beyond the kernels' limits
    raises instead of falling back.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, norm_eps: float = 1e-6,
                 generator=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.qkv_bias = qkv_bias
        self.rates = (drop, attn_drop, drop_path)
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop,
                              generator=generator, device=device)
        self.drop_path = DropPath(drop_path, generator=generator)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop,
                       generator=generator, device=device)

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
        return unsupported(x.shape[1], x.shape[2], self.num_heads)

    def forward(self, x, seg_len: int | None = None):
        if x.is_cuda:
            why = self.fused_unsupported(x, seg_len)
            if why:
                raise NotImplementedError(f"Block on CUDA runs the fused kernel: {why}")
            weights = self.fused_weights()
            if self.training and records_grad(x, weights):
                return fused_vit_block_train(x, weights, self.num_heads)
            return fused_vit_block(x, weights, self.num_heads)
        x = x + self.drop_path(self.attn(self.norm1(x), seg_len=seg_len))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class MlpHead(nn.Module):
    """Stack of Linear+ReLU layers ending in a linear classifier (fc1..fcK)."""

    def __init__(self, in_features: int, widths: tuple, n_out: int,
                 generator=None, device=None):
        super().__init__()
        dims = (in_features, *widths, n_out)
        for i in range(len(dims) - 1):
            self.add_module(f"fc{i + 1}", dense(dims[i], dims[i + 1],
                                                generator=generator, device=device))
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
    Features and weight columns are L2-normalised (norms clamped at 1e-12).
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
        return (x / x_norm) @ (self.W / w_norm) * self.s
