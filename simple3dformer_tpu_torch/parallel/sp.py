"""Sequence parallelism: the point axis of ``models/hengshuang.PointTransformerCls``
split over a layout's ``seq`` ranks (the port of the JAX package's
sequence-parallel step, tests/test_parallel.py:190, where GSPMD shards the
point axis over a ``seq`` mesh axis and places the collectives itself).

Each rank holds a contiguous N/n of every cloud's points and runs the
per-point layers (the stem, the qkv products, fc2, the 1x1 convolutions) on
them alone. What needs other points is gathered:

  * each neighbourhood op takes the all-gathered coordinates (and features)
    and computes only the rank's query rows: kNN of the local points (or
    centroids) against all points (``knn(query, points, k)``), the gathers
    from the gathered rows (``gather_rows(points, idx)``);
  * FPS runs on the gathered xyz, so it picks the same points on every rank
    (from index 0, or from the batch's draw), and each rank keeps its
    contiguous share of them: n must divide every level's npoint;
  * BatchNorm's moments are summed over data x seq (the global sums of
    nn/layers._global_moments), the final mean over points is a sum over the
    ranks' points divided by N, and the gradients are averaged over data x
    seq (parallel/mesh.batch_reduction under a ``seq`` layout).

Vector attention keeps its kernels: in f32 the pre-gathered kernels on the
local queries; in bf16 the in-kernel-gather kernels, which take q and k_all
of one length, on the all-gathered q (every query's neighbours), of which
the rank keeps its rows. The differentiable gathers (mesh.all_gather) sum
their gradients over the ranks, so the step equals the replicated one to
within the order of the sums. Training and eval run the same forward.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import vector_attention as va
from ..models.hengshuang import PointTransformerCls
from ..ops import pointops
from .mesh import Layout, all_gather, all_reduce_sum, gather_along


class SequenceParallel(nn.Module):
    """``model`` with the point axis split over ``layout``'s seq ranks: called
    on [B, N, C] clouds (the data rank's), it runs this rank's N/n points."""

    def __init__(self, model: PointTransformerCls, layout: Layout):
        super().__init__()
        if not isinstance(model, PointTransformerCls):
            raise TypeError("sequence parallelism runs PointTransformerCls")
        if layout.inner != "seq":
            raise ValueError(f"sequence parallelism needs a 'seq' layout, got {layout.inner!r}")
        self.model, self.layout = model, layout
        self.n, self.rank, self.group = layout.n_inner, layout.inner_rank, layout.inner_group
        for down in model.backbone.transition_downs:
            if down.sa.npoint % self.n:
                raise ValueError(f"npoint {down.sa.npoint} does not divide over {self.n} "
                                 "seq ranks")

    def shard(self, t: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """This rank's contiguous part of ``t`` along the point axis."""
        if t.shape[axis] % self.n:
            raise ValueError(f"{t.shape[axis]} points do not divide over {self.n} seq ranks")
        local = t.shape[axis] // self.n
        return t.narrow(axis, self.rank * local, local)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, C] (every point of the data rank's clouds) -> logits [B, classes]."""
        return self.forward_local(self.shard(x))

    def forward_local(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N/n, C], this rank's points -> logits [B, classes]."""
        bb = self.model.backbone
        xyz = x[..., :3]
        xyz_all = gather_along(xyz, 1, self.group)
        points = self.attention(bb.transformer1, xyz, xyz_all, bb.fc1(x))
        for down, block in zip(bb.transition_downs, bb.transformers):
            xyz, xyz_all, points = self.transition_down(down, xyz_all, points)
            points = self.attention(block, xyz, xyz_all, points)
        total = points.shape[1] * self.n
        pooled = (all_reduce_sum(points.float().sum(1), self.group) / total).to(points.dtype)
        return self.model.fc2(pooled)

    def attention(self, block, xyz: torch.Tensor, xyz_all: torch.Tensor,
                  features: torch.Tensor) -> torch.Tensor:
        """``VectorAttentionBlock.forward`` for this rank's query points."""
        knn_idx = pointops.knn_indices(xyz, xyz_all, block.k)  # into all points
        rel = xyz[:, :, None, :] - pointops.index_points(xyz_all, knn_idx)
        x = block.fc1(features)
        q = block.w_qs(x)
        k_all = all_gather(block.w_ks(x), 1, self.group)
        v_all = all_gather(block.w_vs(x), 1, self.group)
        if q.dtype == torch.bfloat16:
            # the in-kernel-gather kernels take q and k_all of one length:
            # every rank's queries, of which this rank keeps its own rows
            q_all = all_gather(q, 1, self.group)
            idx_all = gather_along(knn_idx, 1, self.group)
            rel_all = gather_along(rel, 1, self.group).to(q.dtype)
            res = va.gather_attention(q_all, k_all, v_all, idx_all, rel_all,
                                      block.chain_weights(), block.takes_resid(idx_all, q_all))
            res = self.shard(res)
        else:
            k = pointops.index_points(k_all, knn_idx)
            v = pointops.index_points(v_all, knn_idx)
            res = va.vector_attention(q, k, v, rel, block.chain_weights())
        return block.fc2(res) + features

    def transition_down(self, down, xyz_all: torch.Tensor, points: torch.Tensor):
        """``TransitionDown`` (kNN set abstraction) for this rank's share of the
        sampled points: (its new xyz, every rank's new xyz, its features)."""
        sa = down.sa
        npoint = sa.npoint
        if npoint == xyz_all.shape[1]:
            fps_idx = torch.arange(npoint, dtype=torch.int32, device=xyz_all.device)
            fps_idx = fps_idx.expand(xyz_all.shape[0], npoint)
        else:
            fps_idx = pointops.farthest_point_sample(xyz_all, npoint)
        new_xyz_all = pointops.index_points(xyz_all, fps_idx)
        new_xyz = self.shard(new_xyz_all)
        idx = pointops.knn_indices(new_xyz, xyz_all, sa.nsample)
        grouped = pointops.index_points(xyz_all, idx) - new_xyz[:, :, None, :]
        points_all = all_gather(points, 1, self.group)
        new_points = torch.cat([grouped, pointops.index_points(points_all, idx)], dim=-1)
        for conv, bn in zip(sa.mlp_convs, sa.mlp_bns):
            new_points = torch.relu(bn(conv(new_points)))
        return new_xyz, new_xyz_all, new_points.amax(2)
