"""PointNet++ set abstraction and feature propagation (port of
simple3dformer_tpu/nn/set_abstraction.py; the reference's
data/pointnet_util.py:191-420).

The shared "1x1 conv + BatchNorm + ReLU" MLPs run over the channel axis of
channel-last tensors ([B, S, K, C]), as the JAX package's ``BNReLUDense``
layers do. The parameters carry the reference's state-dict names and shapes:
``mlp_convs.{i}.weight`` [out, in, 1, 1] (Conv2d) or [out, in, 1] (Conv1d),
``mlp_bns.{i}`` (the flax-exact ``nn.layers.BatchNorm``). Max-pooling over
the neighbours uses ``amax``, which splits the gradient among equal maxima
as JAX's ``max`` does. With ``dtype=torch.bfloat16`` the 1x1 convolutions
compute in bf16 (flax ``Dense(dtype=bf16)``), the BatchNorm after each
returns f32 (flax's promotion), and ReLU and the max run in f32. The port's
gather backward sums in f32 where the JAX package's CPU gather VJP sums bf16
rows in bf16.

Every module of the JAX file: ``BNReLUDense``, ``PosEmbedMLP``,
``PointNetSetAbstraction``, ``PointNetSetAbstractionRelPos``,
``PointNetSetAbstractionMsg`` and ``PointNetFeaturePropagation``. The set
abstractions keep their MLPs as the reference's lists (``mlp_convs`` /
``mlp_bns``; RelPos adds ``pos_embeds.{i}``, MSG has PointNet++'s
``conv_blocks.{i}.{j}`` / ``bn_blocks.{i}.{j}``); ``BNReLUDense`` is the one
layer on its own, ``conv`` and ``bn``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pointops
from .layers import BatchNorm, dense, linear, trunc_normal


class Conv1x1(nn.Module):
    """A 1x1 convolution kept in torch's Conv layout [out, in, 1, ...] and
    applied to the last axis of a channel-last tensor (a Linear layer)."""

    def __init__(self, in_features: int, out_features: int, spatial_dims: int = 2,
                 generator=None, device=None, dtype: torch.dtype | None = None,
                 bias: bool = True):
        super().__init__()
        self.compute_dtype = dtype
        w = trunc_normal((out_features, in_features), 0.02, generator)
        self.weight = nn.Parameter(w.reshape(out_features, in_features, *(1,) * spatial_dims)
                                   .to(device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None

    def forward(self, x):
        return linear(x, self.weight.flatten(1), self.bias, self.compute_dtype)


class BNReLUDense(nn.Module):
    """A 1x1 convolution, BatchNorm and ReLU (the reference's conv/bn/relu trio)."""

    def __init__(self, in_features: int, features: int, momentum: float = 0.9,
                 spatial_dims: int = 2, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv1x1(in_features, features, spatial_dims, generator, device, dtype)
        self.bn = BatchNorm(features, momentum, device=device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class PosEmbedMLP(nn.Module):
    """Linear(3, d) -> ReLU -> Linear(d, d): the relative-position encoder."""

    def __init__(self, features: int, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.fc1 = dense(3, features, **kw)
        self.fc2 = dense(features, features, **kw)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


def _shared_mlp(in_features: int, widths, spatial_dims: int, momentum: float,
                generator, device, dtype=None):
    dims = [in_features, *widths]
    convs = nn.ModuleList(Conv1x1(dims[i], dims[i + 1], spatial_dims, generator, device, dtype)
                          for i in range(len(widths)))
    bns = nn.ModuleList(BatchNorm(w, momentum, device=device) for w in widths)
    return convs, bns


class PointNetSetAbstraction(nn.Module):
    """Sample and group, then the shared MLP and a max over the neighbours
    (pointnet_util.py:191-244). ``in_channel`` counts the grouped features'
    width (3 + the point features' width)."""

    def __init__(self, npoint: int, radius: float, nsample: int, in_channel: int, mlp,
                 group_all: bool = False, knn: bool = False, bn_momentum: float = 0.9,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all, self.knn = group_all, knn
        self.mlp_convs, self.mlp_bns = _shared_mlp(in_channel, mlp, 2, bn_momentum, generator,
                                                   device, dtype)

    def _group(self, xyz, points, sample_generator):
        if self.group_all:
            return pointops.sample_and_group_all(xyz, points)
        return pointops.sample_and_group(self.npoint, self.radius, self.nsample, xyz, points,
                                         knn=self.knn, generator=sample_generator)

    def forward(self, xyz, points, sample_generator: torch.Generator | None = None):
        """xyz [B, N, 3], points [B, N, D] -> new_xyz [B, S, 3], feats [B, S, mlp[-1]].

        ``sample_generator`` draws FPS start points (the JAX module's "sample"
        rng); without one FPS starts at index 0.
        """
        new_xyz, new_points = self._group(xyz, points, sample_generator)
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            new_points = F.relu(bn(conv(new_points)))
        return new_xyz, new_points.amax(2)


class PointNetSetAbstractionRelPos(PointNetSetAbstraction):
    """Set abstraction with a relative-position MLP before each MLP layer
    (pointnet_util.py:246-303): layer i adds ``pos_embeds[i](new_xyz -
    knn_xyz)`` to its input, where knn_xyz are the ``nsample`` nearest of the
    sampled centres themselves (a second kNN, over ``new_xyz``)."""

    def __init__(self, npoint: int, radius: float, nsample: int, in_channel: int, mlp,
                 group_all: bool = False, knn: bool = False, bn_momentum: float = 0.9,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__(npoint, radius, nsample, in_channel, mlp, group_all, knn, bn_momentum,
                         generator, device, dtype)
        widths = [in_channel, *mlp[:-1]]
        self.pos_embeds = nn.ModuleList(PosEmbedMLP(w, generator=generator, device=device,
                                                    dtype=dtype) for w in widths)

    def forward(self, xyz, points, sample_generator: torch.Generator | None = None):
        new_xyz, new_points = self._group(xyz, points, sample_generator)
        knn_idx = pointops.knn_indices(new_xyz, new_xyz, self.nsample)
        rel = new_xyz[:, :, None, :] - pointops.index_points(new_xyz, knn_idx)  # [B, S, K, 3]
        for conv, bn, pe in zip(self.mlp_convs, self.mlp_bns, self.pos_embeds):
            new_points = F.relu(bn(conv(new_points + pe(rel))))
        return new_xyz, new_points.amax(2)


class PointNetSetAbstractionMsg(nn.Module):
    """Multi-scale grouping (pointnet_util.py:308-366): per radius a ball (or
    kNN) group of its own size and its own MLP, the scales' maxima
    concatenated. ``in_channel`` is the point features' width (0 for none);
    each branch's input is those features and the centred xyz, in that order."""

    def __init__(self, npoint: int, radius_list, nsample_list, in_channel: int, mlp_list,
                 knn: bool = False, bn_momentum: float = 0.9, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.npoint, self.knn = npoint, knn
        self.radius_list, self.nsample_list = list(radius_list), list(nsample_list)
        self.conv_blocks, self.bn_blocks = nn.ModuleList(), nn.ModuleList()
        for widths in mlp_list:
            convs, bns = _shared_mlp(in_channel + 3, widths, 2, bn_momentum, generator, device,
                                     dtype)
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)

    def forward(self, xyz, points, sample_generator: torch.Generator | None = None,
                seed_idx: torch.Tensor | None = None):
        """xyz [B, N, 3], points [B, N, D] or None -> new_xyz [B, S, 3], feats
        [B, S, sum of the branches' last widths]. ``seed_idx`` [B, S] gives the
        centres; without it FPS picks them (from ``sample_generator``'s starts)."""
        if seed_idx is None:
            seed_idx = pointops.farthest_point_sample(xyz, self.npoint, sample_generator)
        new_xyz = pointops.index_points(xyz, seed_idx)
        outs = []
        for radius, k, convs, bns in zip(self.radius_list, self.nsample_list, self.conv_blocks,
                                         self.bn_blocks):
            if self.knn:
                idx = pointops.knn_indices(new_xyz, xyz, k)
            else:
                idx = pointops.query_ball_point(radius, k, xyz, new_xyz)
            grouped = pointops.index_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([pointops.index_points(points, idx), grouped], dim=-1)
            for conv, bn in zip(convs, bns):
                grouped = F.relu(bn(conv(grouped)))
            outs.append(grouped.amax(2))
        return new_xyz, torch.cat(outs, dim=-1)


class PointNetFeaturePropagation(nn.Module):
    """3-NN inverse-distance upsampling and a pointwise MLP (pointnet_util.py:370-420).

    xyz1 [B, N, 3], xyz2 [B, S, 3], points1 [B, N, D1] or None, points2
    [B, S, D2] -> [B, N, mlp[-1]] (or the concatenated width when mlp is empty).
    """

    def __init__(self, in_channel: int = 0, mlp=(), bn_momentum: float = 0.9,
                 generator=None, device=None):
        super().__init__()
        self.mlp_convs, self.mlp_bns = _shared_mlp(in_channel, mlp, 1, bn_momentum, generator,
                                                   device)

    def forward(self, xyz1, xyz2, points1, points2):
        new_points = pointops.three_nn_interpolate(xyz1, xyz2, points2)
        if points1 is not None:
            new_points = torch.cat([points1, new_points], dim=-1)
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            new_points = F.relu(bn(conv(new_points)))
        return new_points
