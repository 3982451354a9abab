"""k nearest neighbours: a CUDA kernel for Hopper and its plain version.

Replaces the TPU kernel ``simple3dformer_tpu/kernels/knn.py`` (``_knn_kernel``
:26, ``pallas_call`` :74 in ``knn_pallas``) and the XLA path of
``simple3dformer_tpu/ops/pointops.knn_indices`` / ``three_nn_interpolate``:
for each query, the k points of the same batch element with the smallest

    d = max(|q|^2 + |p|^2 - 2 q.p, 0)

(the matmul form of ``square_distance``), ascending, equal distances in index
order, with those distances. The plain version sorts each row with a stable
sort (``torch.topk`` is not stable on ties).

What bounds it on the card, and the design (``csrc/knn.cu``): the TPU kernel
computes a distance block on the MXU and runs k rounds of masked argmin.
Here f32 issue slots and the selection's latency bound it (B*S*N distance
evaluations, few bytes). One warp owns a query and holds its sorted k-list
across its lanes; the block's queries share a batch element whose points
pass through shared memory once per block; lanes take 32 candidates at a
time, a ballot finds those nearer than the list's last entry, and each is
inserted at a popcount, the tail shifted up a lane, or, where 8 or more
enter at once and k is at least 8, they are sorted and merged with the list
by a bitonic network. No [B, S, N] distance tensor is written. Past k = 32
(PointNet++'s MSG groups 128) a second kernel takes the call, one block a
query: every candidate's (distance, index) pair sorted by a bitonic network
in shared memory, in rounds of at most 4096 pairs that keep the list at the
front, up to k = 1024.

The kernel rounds every operation in a fixed order, (|q|^2 + |p|^2) - 2 q.p
with q.p = (qx px + qy py) + qz pz, and ``knn_reference_exact`` repeats that
order elementwise, so on the card the two agree bit for bit. The plain
version ``knn_reference`` takes q.p from a matmul (cuBLAS on the card), summed
in another order, so where two distances differ by a rounding the two may
rank them differently; ``near_ties`` counts such ranks for the card check.

On a CPU tensor ``knn`` runs ``knn_reference``; on a CUDA tensor it launches
the kernel or raises. ``knn.launches`` counts kernel launches. ``knn`` is
also the registered torch op ``torch.ops.s3f.knn`` (``knn_op``, which
``ops/pointops`` calls; CUDA: the kernel, counted;
CPU: ``knn_reference``; fake: the shapes), so ``torch.export`` keeps the
kernel as one node of an exported program.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def square_distance_matmul(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """max(|a|^2 + |b|^2 - 2 a.b, 0): src [B, N, C], dst [B, M, C] -> [B, N, M] f32."""
    src, dst = src.float(), dst.float()
    s2 = (src * src).sum(-1, keepdim=True)
    d2 = (dst * dst).sum(-1)[:, None, :]
    return torch.clamp_min(s2 + d2 - 2.0 * torch.matmul(src, dst.transpose(1, 2)), 0.0)


def knn_reference(query: torch.Tensor, points: torch.Tensor, k: int):
    """Plain version: (idx [B, S, k] int32, dist [B, S, k] f32)."""
    d = square_distance_matmul(query, points)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return idx[..., :k].to(torch.int32), dist[..., :k].contiguous()


def knn_reference_exact(query: torch.Tensor, points: torch.Tensor, k: int):
    """The kernel's function in its rounding order: (idx [B, S, k] int32, dist
    [B, S, k] f32). Each product and sum is a tensor operation of its own (no
    FMA), then a stable sort. Materialises [B, S, N]; the card check's oracle."""
    qx, qy, qz = query.float()[..., None].unbind(-2)  # [B, S, 1]
    px, py, pz = points.float()[:, None].unbind(-1)  # [B, 1, N]
    qq = (qx * qx + qy * qy) + qz * qz
    pp = (px * px + py * py) + pz * pz
    cross = (qx * px + qy * py) + qz * pz
    d = torch.clamp_min((qq + pp) - 2.0 * cross, 0.0)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return idx[..., :k].to(torch.int32), dist[..., :k].contiguous()


def near_ties(idx: torch.Tensor, dist: torch.Tensor, ref_idx: torch.Tensor,
              ref_dist: torch.Tensor, rel: float = 1e-6) -> tuple[int, int]:
    """(ranks where idx differs from ref_idx, of those how many are near-ties).

    A differing rank is a near-tie when the two distances there agree within
    ``rel`` of the larger of the distance and 1 (the matmul form's rounding
    is relative to |q|^2 + |p|^2, about 1 for normalised clouds): the two
    picked different points at the same distance up to a rounding.
    """
    diff = idx != ref_idx
    near = (dist - ref_dist).abs() <= rel * ref_dist.abs().clamp_min(1.0)
    return int(diff.sum()), int((diff & near).sum())


@functools.cache
def _lib():
    from .build import load

    lib = load("knn")
    lib.s3f_knn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.s3f_knn.restype = ctypes.c_int
    lib.s3f_knn_max_k.restype = ctypes.c_int
    return lib


def _check_shapes(query: torch.Tensor, points: torch.Tensor, k: int) -> None:
    if query.ndim != 3 or points.ndim != 3 or query.shape[0] != points.shape[0] \
            or query.shape[-1] != 3 or points.shape[-1] != 3:
        raise ValueError(f"knn takes [B, S, 3] and [B, N, 3], got {tuple(query.shape)} and "
                         f"{tuple(points.shape)}")
    if not 1 <= k <= points.shape[1]:
        raise ValueError(f"k = {k} outside 1..N = {points.shape[1]}")


def knn(query: torch.Tensor, points: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """query [B, S, 3], points [B, N, 3] -> (idx [B, S, k] int32, dist [B, S, k] f32):
    the kernel on CUDA tensors (counted in ``knn.launches``), ``knn_reference``
    on CPU tensors. k must be at most N (callers clamp it, as
    ``ops.pointops.knn_indices`` does)."""
    _check_shapes(query, points, k)
    if query.device.type == "cpu" and points.device.type == "cpu":
        return knn_reference(query, points, k)
    if query.device.type != "cuda" or points.device != query.device:
        raise ValueError(f"knn runs on cpu or cuda, got {query.device} and {points.device}")
    b, s, _ = query.shape
    n = points.shape[1]
    lib = _lib()
    if k > lib.s3f_knn_max_k():
        raise ValueError(f"knn kernel: k = {k} above {lib.s3f_knn_max_k()}")
    for name, t in (("query", query), ("points", points)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"knn kernel takes contiguous float32 {name}, got {t.dtype}")
    idx = torch.empty(b, s, k, dtype=torch.int32, device=query.device)
    dist = torch.empty(b, s, k, dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = lib.s3f_knn(query.data_ptr(), points.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                          b, s, n, k, torch.cuda.current_stream(query.device).cuda_stream)
    if err:
        raise RuntimeError(f"knn kernel launch failed: CUDA error {err}")
    knn.launches += 1
    return idx, dist


@torch.library.custom_op("s3f::knn", mutates_args=())
def knn_op(query: torch.Tensor, points: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``knn`` as a torch op (meta tensors take the fake, which ``knn`` refuses)."""
    return knn(query, points, k)


@knn_op.register_fake
def _(query, points, k):
    _check_shapes(query, points, k)
    b, s, _ = query.shape
    return (query.new_empty(b, s, k, dtype=torch.int32),
            query.new_empty(b, s, k, dtype=torch.float32))


knn.launches = 0
