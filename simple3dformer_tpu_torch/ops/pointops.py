"""Point-cloud primitives (port of simple3dformer_tpu/ops/pointops.py; the
reference's data/pointnet_util.py).

The same functions and semantics as the JAX module:
  * square_distance: the |a|^2 + |b|^2 - 2ab matmul form, clamped at 0, or the
    ``exact`` subtraction form.
  * farthest_point_sample: start at index 0, or at a random index per batch
    element when a generator is given; distance 1e10 at first, min update,
    argmax taking the first maximum.
  * knn_indices: the k nearest (k clamped to N, as torch argsort()[..., :k]
    does in the reference), equal distances in index order.
  * index_points: batched gather, indices [B, ...] flattened to [B, R].
  * query_ball_point: the nsample in-radius points of smallest index, missing
    slots filled with the first hit.
  * sample_and_group (with the npoint == N identity shortcut),
    sample_and_group_all, sample_and_group_with_center, three_nn_interpolate,
    pc_normalize.

FPS, kNN and every gather go through the port's kernels (kernels/fps.py,
knn.py, gather.py): on CUDA tensors they launch the CUDA kernels, whatever the
dtype and size, and on CPU tensors they run the kernels' plain versions. FPS
and kNN are called as their torch ops, and so is a gather where autograd
records nothing, so ``torch.export`` keeps each kernel as a node. The
JAX package gated its Pallas kernels by backend, dtype and size for TPU
reasons only. Out-of-range gather indices clamp (kernels/gather.py says how
the JAX package differs).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..kernels.fps import fps_op
from ..kernels.gather import gather_rows
from ..kernels.knn import knn_op, square_distance_matmul


def square_distance(src: torch.Tensor, dst: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Pairwise squared euclidean distance. src [B, N, C], dst [B, M, C] -> [B, N, M]."""
    if exact:
        return ((src[:, :, None, :] - dst[:, None, :, :]) ** 2).sum(-1)
    return square_distance_matmul(src, dst)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather. points [B, N, C], idx [B, ...] int -> [B, ..., C]."""
    b, c = points.shape[0], points.shape[-1]
    out = gather_rows(points.contiguous(), idx.reshape(b, -1))
    return out.reshape(*idx.shape, c)


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """Iterative FPS. xyz [B, N, 3] -> indices [B, npoint] int32. A generator
    draws the start indices (on the CPU), as the JAX function's key does, for
    the global batch (core/rng.randint)."""
    b, n, _ = xyz.shape
    start = None
    if generator is not None:
        start = rng.randint(0, n, (b,), generator).to(xyz.device, torch.int32)
    return fps_op(xyz.float().contiguous(), npoint, start)


def knn_indices(query: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k nearest points for each query. [B, S, 3], [B, N, 3] -> [B, S, k]."""
    k = min(k, points.shape[1])
    idx, _ = knn_op(query.float().contiguous(), points.float().contiguous(), k)
    return idx


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Reference-exact ball grouping (pointnet_util.py:76-96)."""
    n = xyz.shape[1]
    d = square_distance(new_xyz, xyz)
    arange = torch.arange(n, dtype=torch.int32, device=xyz.device)
    scores = torch.where(d <= radius ** 2, arange, torch.full_like(arange, n))
    group_idx = scores.sort(-1).values[..., :min(nsample, n)]
    return torch.where(group_idx == n, group_idx[..., :1], group_idx)


def sample_and_group(npoint: int, radius: float, nsample: int, xyz: torch.Tensor,
                     points: torch.Tensor | None, knn: bool = False,
                     generator: torch.Generator | None = None, return_fps: bool = False):
    """FPS -> group (kNN or ball) -> center (pointnet_util.py:99-138).

    Returns new_xyz [B, S, 3] and grouped features [B, S, K, 3+D] (centred xyz
    concatenated with the gathered point features). npoint == N skips FPS:
    identity indices, as the JAX function does (every consumer is invariant to
    the order of the rows).
    """
    b, n, _ = xyz.shape
    if npoint == n:
        fps_idx = torch.arange(n, dtype=torch.int32, device=xyz.device).expand(b, n)
    else:
        fps_idx = farthest_point_sample(xyz, npoint, generator)
    new_xyz = index_points(xyz, fps_idx)
    if knn:
        idx = knn_indices(new_xyz, xyz, nsample)
    else:
        idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx)  # [B, S, K, 3]
    grouped_norm = grouped_xyz - new_xyz[:, :, None, :]
    if points is not None:
        new_points = torch.cat([grouped_norm, index_points(points, idx)], dim=-1)
    else:
        new_points = grouped_norm
    if return_fps:
        return new_xyz, new_points, grouped_xyz, fps_idx
    return new_xyz, new_points


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None):
    """A single group covering every point (pointnet_util.py:171-188)."""
    b, _, c = xyz.shape
    new_xyz = torch.zeros(b, 1, c, dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if points is not None:
        return new_xyz, torch.cat([grouped, points[:, None]], dim=-1)
    return new_xyz, grouped


def sample_and_group_with_center(npoint: int, nsample: int, xyz: torch.Tensor,
                                 points: torch.Tensor,
                                 generator: torch.Generator | None = None):
    """PCT-style grouping (the reference's models/3DViT/model.py:14-29):
    features centred on the sampled point's own feature, concatenated with
    that feature repeated."""
    fps_idx = farthest_point_sample(xyz, npoint, generator)
    new_xyz = index_points(xyz, fps_idx)
    new_points = index_points(points, fps_idx)  # [B, S, D]
    idx = knn_indices(new_xyz, xyz, nsample)
    grouped = index_points(points, idx)  # [B, S, K, D]
    centered = grouped - new_points[:, :, None, :]
    return new_xyz, torch.cat([centered, new_points[:, :, None, :].expand_as(centered)], dim=-1)


def three_nn_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points2: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted 3-NN interpolation of points2 (at xyz2) onto
    xyz1 (pointnet_util.py:398-408). [B, N, 3], [B, S, 3], [B, S, D] -> [B, N, D].
    When S == 1 the single feature is tiled (pointnet_util.py:399)."""
    b, n, _ = xyz1.shape
    s = xyz2.shape[1]
    if s == 1:
        return points2.expand(b, n, points2.shape[-1])
    idx, dists = knn_op(xyz1.float().contiguous(), xyz2.float().contiguous(), min(3, s))
    recip = 1.0 / (dists + 1e-8)
    weight = recip / recip.sum(-1, keepdim=True)
    gathered = index_points(points2, idx)  # [B, N, 3, D]
    return (gathered * weight[..., None]).sum(2)


def pc_normalize(pc: torch.Tensor) -> torch.Tensor:
    """Centre and scale to the unit sphere (pointnet_util.py:15-20). [N, 3] -> [N, 3]."""
    pc = pc - pc.mean(0)
    return pc / torch.sqrt((pc ** 2).sum(1)).max()
