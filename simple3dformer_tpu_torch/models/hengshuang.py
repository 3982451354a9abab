"""Hengshuang Point Transformer building blocks (port of the transitions of
simple3dformer_tpu/models/hengshuang.py:25-90; the reference's
models/Hengshuang/model.py).

Ported: ``TransitionDown``, ``LinearBNReLU`` and ``TransitionUp``, which the
3DViT point models use. The ``Backbone`` and the two ``PointTransformer*``
models come with the Hengshuang slice (their vector attention is a kernel of
its own).

State-dict names are the reference's: ``sa.mlp_convs.{i}`` / ``sa.mlp_bns.{i}``,
and ``fc1`` / ``fc2`` of a TransitionUp as Sequential(Linear, Swap, BN, Swap,
ReLU), so the Linear is ``fc1.0`` and the BatchNorm ``fc1.2``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm, dense
from ..nn.set_abstraction import PointNetFeaturePropagation, PointNetSetAbstraction


class TransitionDown(nn.Module):
    """Set abstraction with kNN grouping (Hengshuang/model.py:7-13).
    ``channels`` = (in, mid, out), ``in`` counting the 3 centred coordinates."""

    def __init__(self, k: int, nneighbor: int, channels, bn_momentum: float = 0.9,
                 generator=None, device=None):
        super().__init__()
        self.sa = PointNetSetAbstraction(k, 0.0, nneighbor, channels[0], list(channels[1:]),
                                         group_all=False, knn=True, bn_momentum=bn_momentum,
                                         generator=generator, device=device)

    def forward(self, xyz, points, sample_generator=None):
        return self.sa(xyz, points, sample_generator)


class LinearBNReLU(nn.Module):
    """Linear -> BatchNorm (flax-exact) -> ReLU; children named ``0`` and ``2``
    as in the reference's Sequential."""

    def __init__(self, in_features: int, features: int, bn_momentum: float = 0.9,
                 generator=None, device=None):
        super().__init__()
        self.add_module("0", dense(in_features, features, generator=generator, device=device))
        self.add_module("2", BatchNorm(features, bn_momentum, device=device))

    def forward(self, x):
        return F.relu(self._modules["2"](self._modules["0"](x)))


class TransitionUp(nn.Module):
    """Upsample coarse features onto the fine level and fuse
    (Hengshuang/model.py:16-46): interp(fc1(coarse)) + fc2(fine)."""

    def __init__(self, dim_in_coarse: int, dim_in_fine: int, dim_out: int,
                 bn_momentum: float = 0.9, generator=None, device=None):
        super().__init__()
        self.fc1 = LinearBNReLU(dim_in_coarse, dim_out, bn_momentum, generator, device)
        self.fc2 = LinearBNReLU(dim_in_fine, dim_out, bn_momentum, generator, device)
        self.fp = PointNetFeaturePropagation(0, ())

    def forward(self, xyz1, points1, xyz2, points2):
        """xyz1/points1: the coarse level; xyz2/points2: the fine level (the
        reference's order)."""
        return self.fp(xyz2, xyz1, None, self.fc1(points1)) + self.fc2(points2)
