"""PCT-style neighbour-embedding point tokenizer (port of
simple3dformer_tpu/nn/point_embed.py; the reference's
models/3DViT/model.py:75-121, Local_op and PointEmbed).

A per-point MLP, FPS and kNN grouping centred on the sampled point's own
feature (ops/pointops.sample_and_group_with_center), then a shared MLP with a
max over each neighbourhood (``LocalOp``). The reference builds it as the
3DViT's ``patch_embed`` and never calls it; the JAX package keeps it as a
usable tokenizer, and so does the port. FPS, kNN and the gathers are the
port's kernels on CUDA tensors (kernels/fps.py, knn.py, gather.py).

The 1x1 convolutions have no bias, as the reference's. Parameters keep the
JAX modules' names: ``conv1.conv.weight`` [64, C, 1] (a Conv1d's layout),
``conv1.bn``, ``gather_local_0.conv1`` and so on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pointops
from .layers import BatchNorm
from .set_abstraction import Conv1x1


class ConvBNReLU1d(nn.Module):
    """A bias-free 1x1 convolution over the last axis, BatchNorm and ReLU."""

    def __init__(self, in_features: int, features: int, bn_momentum: float = 0.9,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv1x1(in_features, features, 1, generator, device, dtype, bias=False)
        self.bn = BatchNorm(features, bn_momentum, device=device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class LocalOp(nn.Module):
    """A shared two-layer MLP and the max over each kNN group
    (3DViT/model.py:75-94). [B, S, K, D] -> [B, S, out]."""

    def __init__(self, in_features: int, out_channels: int, bn_momentum: float = 0.9,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.conv1 = ConvBNReLU1d(in_features, out_channels, bn_momentum, **kw)
        self.conv2 = ConvBNReLU1d(out_channels, out_channels, bn_momentum, **kw)

    def forward(self, x):
        return self.conv2(self.conv1(x)).amax(2)


class PointEmbed(nn.Module):
    """Per-point MLP -> sample_and_group_with_center -> LocalOp.

    x [B, N, C >= 3] (xyz first) -> (new_xyz [B, S, 3], features [B, S,
    embed_dim // 4]) with S = min(npoint, N). ``sample_generator`` draws the
    FPS start points (the JAX module's "sample" rng); without one FPS starts
    at index 0.
    """

    def __init__(self, embed_dim: int, in_channels: int = 3, npoint: int = 1024,
                 nsample: int = 32, bn_momentum: float = 0.9, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.npoint, self.nsample = npoint, nsample
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.conv1 = ConvBNReLU1d(in_channels, 64, bn_momentum, **kw)
        self.conv2 = ConvBNReLU1d(64, 64, bn_momentum, **kw)
        self.gather_local_0 = LocalOp(128, embed_dim // 4, bn_momentum, **kw)

    def forward(self, x, sample_generator: torch.Generator | None = None):
        h = self.conv2(self.conv1(x))
        new_xyz, grouped = pointops.sample_and_group_with_center(
            min(self.npoint, x.shape[1]), self.nsample, x[..., :3], h, sample_generator)
        return new_xyz, self.gather_local_0(grouped)
