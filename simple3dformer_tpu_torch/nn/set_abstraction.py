"""PointNet++ set abstraction and feature propagation (port of
simple3dformer_tpu/nn/set_abstraction.py; the reference's
data/pointnet_util.py:191-420).

The shared "1x1 conv + BatchNorm + ReLU" MLPs run over the channel axis of
channel-last tensors ([B, S, K, C]), as the JAX package's ``BNReLUDense``
layers do. The parameters carry the reference's state-dict names and shapes:
``mlp_convs.{i}.weight`` [out, in, 1, 1] (Conv2d) or [out, in, 1] (Conv1d),
``mlp_bns.{i}`` (the flax-exact ``nn.layers.BatchNorm``). Max-pooling over
the neighbours uses ``amax``, which splits the gradient among equal maxima
as JAX's ``max`` does.

Ported: ``PointNetSetAbstraction`` and ``PointNetFeaturePropagation``. Not
yet: ``PointNetSetAbstractionRelPos``, ``PointNetSetAbstractionMsg`` and
``PosEmbedMLP`` (no model of a ported slice uses them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pointops
from .layers import BatchNorm, trunc_normal


class Conv1x1(nn.Module):
    """A 1x1 convolution kept in torch's Conv layout [out, in, 1, ...] and
    applied to the last axis of a channel-last tensor (a Linear layer)."""

    def __init__(self, in_features: int, out_features: int, spatial_dims: int = 2,
                 generator=None, device=None):
        super().__init__()
        w = trunc_normal((out_features, in_features), 0.02, generator)
        self.weight = nn.Parameter(w.reshape(out_features, in_features, *(1,) * spatial_dims)
                                   .to(device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return F.linear(x, self.weight.flatten(1), self.bias)


def _shared_mlp(in_features: int, widths, spatial_dims: int, momentum: float,
                generator, device):
    dims = [in_features, *widths]
    convs = nn.ModuleList(Conv1x1(dims[i], dims[i + 1], spatial_dims, generator, device)
                          for i in range(len(widths)))
    bns = nn.ModuleList(BatchNorm(w, momentum, device=device) for w in widths)
    return convs, bns


class PointNetSetAbstraction(nn.Module):
    """Sample and group, then the shared MLP and a max over the neighbours
    (pointnet_util.py:191-244). ``in_channel`` counts the grouped features'
    width (3 + the point features' width)."""

    def __init__(self, npoint: int, radius: float, nsample: int, in_channel: int, mlp,
                 group_all: bool = False, knn: bool = False, bn_momentum: float = 0.9,
                 generator=None, device=None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all, self.knn = group_all, knn
        self.mlp_convs, self.mlp_bns = _shared_mlp(in_channel, mlp, 2, bn_momentum, generator,
                                                   device)

    def forward(self, xyz, points, sample_generator: torch.Generator | None = None):
        """xyz [B, N, 3], points [B, N, D] -> new_xyz [B, S, 3], feats [B, S, mlp[-1]].

        ``sample_generator`` draws FPS start points (the JAX module's "sample"
        rng); without one FPS starts at index 0.
        """
        if self.group_all:
            new_xyz, new_points = pointops.sample_and_group_all(xyz, points)
        else:
            new_xyz, new_points = pointops.sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points, knn=self.knn,
                generator=sample_generator)
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            new_points = F.relu(bn(conv(new_points)))
        return new_xyz, new_points.amax(2)


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
