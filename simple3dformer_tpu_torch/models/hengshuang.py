"""Hengshuang Point Transformer, cls and seg (port of
simple3dformer_tpu/models/hengshuang.py; the reference's
models/Hengshuang/model.py).

Backbone: fc1 -> VectorAttentionBlock, then nblocks x (TransitionDown ->
VectorAttentionBlock), each stage a quarter of the points and twice the
channels. ``PointTransformerCls`` mean-pools into an MLP head;
``PointTransformerSeg`` is U-shaped, TransitionUps feeding 3-NN
interpolation. The transitions are also the 3DViT point models' (they came
with the partseg slice). On the card every vector-attention block runs the
vector-attention kernels, every kNN, FPS and gather the point kernels.

``dtype=torch.bfloat16`` is the JAX package's ``compute_dtype`` (its
``cli/_common.py:56``): every Linear computes in bf16, the parameters stay
f32, the BatchNorms return f32. So the stem and ``transformer1`` run in
bf16 (its residual ``fc2(res) + pre`` is bf16), every stage after a
transition-down adds into f32, ``xyz`` stays f32 and the heads return bf16
logits.

Config surface as configs/model/Hengshuang.yaml + configs/cls.yaml:
num_point, input_dim, num_class, model.nblocks, model.nneighbor,
model.transformer_dim.

State-dict names are the reference's: ``backbone.fc1.{0,2}``,
``backbone.transformer1``, ``backbone.transition_downs.{i}.sa.mlp_convs.{j}`` /
``mlp_bns.{j}``, ``backbone.transformers.{i}``, the heads ``fc2.{0,2,4}`` (and
``fc3.{0,2,4}``), and in the seg model ``transformer2``, ``transition_ups.{i}``
(``fc1`` / ``fc2`` of a TransitionUp as Sequential(Linear, Swap, BN, Swap,
ReLU), so the Linear is ``fc1.0`` and the BatchNorm ``fc1.2``) and
``transformers.{i}``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm, dense
from ..nn.set_abstraction import PointNetFeaturePropagation, PointNetSetAbstraction
from ..nn.vector_attention import VectorAttentionBlock


class TransitionDown(nn.Module):
    """Set abstraction with kNN grouping (Hengshuang/model.py:7-13).
    ``channels`` = (in, mid, out), ``in`` counting the 3 centred coordinates."""

    def __init__(self, k: int, nneighbor: int, channels, bn_momentum: float = 0.9,
                 generator=None, device=None, dtype=None):
        super().__init__()
        self.sa = PointNetSetAbstraction(k, 0.0, nneighbor, channels[0], list(channels[1:]),
                                         group_all=False, knn=True, bn_momentum=bn_momentum,
                                         generator=generator, device=device, dtype=dtype)

    def forward(self, xyz, points, sample_generator=None):
        return self.sa(xyz, points, sample_generator)


class LinearBNReLU(nn.Module):
    """Linear -> BatchNorm (flax-exact) -> ReLU; children named ``0`` and ``2``
    as in the reference's Sequential."""

    def __init__(self, in_features: int, features: int, bn_momentum: float = 0.9,
                 generator=None, device=None, dtype=None):
        super().__init__()
        self.add_module("0", dense(in_features, features, generator=generator, device=device,
                                   dtype=dtype))
        self.add_module("2", BatchNorm(features, bn_momentum, device=device))

    def forward(self, x):
        return F.relu(self._modules["2"](self._modules["0"](x)))


class TransitionUp(nn.Module):
    """Upsample coarse features onto the fine level and fuse
    (Hengshuang/model.py:16-46): interp(fc1(coarse)) + fc2(fine)."""

    def __init__(self, dim_in_coarse: int, dim_in_fine: int, dim_out: int,
                 bn_momentum: float = 0.9, generator=None, device=None, dtype=None):
        super().__init__()
        self.fc1 = LinearBNReLU(dim_in_coarse, dim_out, bn_momentum, generator, device, dtype)
        self.fc2 = LinearBNReLU(dim_in_fine, dim_out, bn_momentum, generator, device, dtype)
        self.fp = PointNetFeaturePropagation(0, ())

    def forward(self, xyz1, points1, xyz2, points2):
        """xyz1/points1: the coarse level; xyz2/points2: the fine level (the
        reference's order)."""
        return self.fp(xyz2, xyz1, None, self.fc1(points1)) + self.fc2(points2)


def mlp_head(in_features: int, widths: tuple, n_out: int, generator=None, device=None,
             dtype=None):
    """Sequential(Linear, ReLU, ..., Linear): the reference's head, Linears at 0, 2, 4."""
    dims = (in_features, *widths, n_out)
    layers = []
    for i in range(len(dims) - 1):
        if i:
            layers.append(nn.ReLU())
        layers.append(dense(dims[i], dims[i + 1], generator=generator, device=device,
                            dtype=dtype))
    return nn.Sequential(*layers)


class Backbone(nn.Module):
    def __init__(self, num_point: int, nblocks: int = 4, nneighbor: int = 16, input_dim: int = 3,
                 transformer_dim: int = 512, bn_momentum: float = 0.9, generator=None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.fc1 = nn.Sequential(dense(input_dim, 32, **kw), nn.ReLU(), dense(32, 32, **kw))
        self.transformer1 = VectorAttentionBlock(32, transformer_dim, nneighbor, **kw)
        self.transition_downs = nn.ModuleList()
        self.transformers = nn.ModuleList()
        for i in range(nblocks):
            channel = 32 * 2 ** (i + 1)
            self.transition_downs.append(TransitionDown(
                num_point // 4 ** (i + 1), nneighbor, (channel // 2 + 3, channel, channel),
                bn_momentum, **kw))
            self.transformers.append(VectorAttentionBlock(channel, transformer_dim, nneighbor,
                                                          **kw))

    def forward(self, x):
        """x [B, N, input_dim] -> (points [B, N / 4^nblocks, C], per-stage (xyz, feats))."""
        xyz = x[..., :3]
        points, _ = self.transformer1(xyz, self.fc1(x))
        xyz_and_feats = [(xyz, points)]
        for down, block in zip(self.transition_downs, self.transformers):
            xyz, points = down(xyz, points)
            points, _ = block(xyz, points)
            xyz_and_feats.append((xyz, points))
        return points, xyz_and_feats


class PointTransformerCls(nn.Module):
    """Mean-pool + MLP head (Hengshuang/model.py:79-96). x [B, N, input_dim] ->
    [B, num_class] (bf16 under ``dtype=torch.bfloat16``)."""

    def __init__(self, num_point: int, num_class: int, input_dim: int = 3, nblocks: int = 4,
                 nneighbor: int = 16, transformer_dim: int = 512, bn_momentum: float = 0.9,
                 generator=None, device=None, dtype=None):
        super().__init__()
        self.backbone = Backbone(num_point, nblocks, nneighbor, input_dim, transformer_dim,
                                 bn_momentum, generator, device, dtype)
        self.fc2 = mlp_head(32 * 2 ** nblocks, (256, 64), num_class, generator, device, dtype)

    @classmethod
    def from_config(cls, cfg, **kw):
        return cls(num_point=int(cfg.num_point), num_class=int(cfg.num_class),
                   input_dim=int(cfg.input_dim), nblocks=int(cfg.model.nblocks),
                   nneighbor=int(cfg.model.nneighbor),
                   transformer_dim=int(cfg.model.transformer_dim), **kw)

    def forward(self, x):
        points, _ = self.backbone(x)
        return self.fc2(points.mean(1))


class PointTransformerSeg(nn.Module):
    """U-shaped segmentation variant (Hengshuang/model.py:99-137). x [B, N,
    input_dim] -> [B, N, num_class]."""

    def __init__(self, num_point: int, num_class: int, input_dim: int = 3, nblocks: int = 4,
                 nneighbor: int = 16, transformer_dim: int = 512, bn_momentum: float = 0.9,
                 generator=None, device=None, dtype=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        c = 32 * 2 ** nblocks
        self.backbone = Backbone(num_point, nblocks, nneighbor, input_dim, transformer_dim,
                                 bn_momentum, **kw)
        self.fc2 = mlp_head(c, (512, 512), c, **kw)
        self.transformer2 = VectorAttentionBlock(c, transformer_dim, nneighbor, **kw)
        self.transition_ups = nn.ModuleList()
        self.transformers = nn.ModuleList()
        for i in range(nblocks):
            channel = 32 * 2 ** (nblocks - i - 1)
            self.transition_ups.append(TransitionUp(channel * 2, channel, channel, bn_momentum,
                                                    **kw))
            self.transformers.append(VectorAttentionBlock(channel, transformer_dim, nneighbor,
                                                          **kw))
        self.fc3 = mlp_head(32, (64, 64), num_class, **kw)

    from_config = classmethod(PointTransformerCls.from_config.__func__)

    def forward(self, x):
        points, xyz_and_feats = self.backbone(x)
        xyz = xyz_and_feats[-1][0]
        points, _ = self.transformer2(xyz, self.fc2(points))
        for i, (up, block) in enumerate(zip(self.transition_ups, self.transformers)):
            fine_xyz, fine_points = xyz_and_feats[-i - 2]
            points = up(xyz, points, fine_xyz, fine_points)
            xyz = fine_xyz
            points, _ = block(xyz, points)
        return self.fc3(points)

