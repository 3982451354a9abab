"""Batched row gather, forward and backward: CUDA kernels for Hopper and their
plain versions.

Replaces the TPU kernels of ``simple3dformer_tpu/kernels/gather.py``:
``gather_fwd`` the forward (``_fwd_kernel`` :42, ``pallas_call`` :82) and
``gather_bwd`` the backward (``_bwd_kernel`` :51, ``pallas_call`` :109) of
``gather_rows``:

    forward:  out[b, r] = points[b, idx[b, r]]                  ([B, R, C], points' dtype)
    backward: gp[b, n]  = sum of g[b, r] over r with idx[b, r] == n   (summed in f32,
                                                                 then cast to points' dtype)

Out-of-range indices CLAMP to [0, N-1], in both directions (the backward
adds their gradient rows to row 0 or N-1). The JAX package has two other
behaviours: its one-hot TPU kernel gives zero rows, and its XLA path
(``take_along_axis``) wraps negative indices and fills rows beyond N with
NaN, although ``simple3dformer_tpu/ops/pointops.py:76-81`` says it clamps.
The port does what that comment promises. No caller in either package makes
such indices.

What bounds them on the card, and the design (``csrc/gather.cu``): both move
bytes and do no arithmetic worth counting, so the least time is the bytes
over the memory rate (the forward reads and writes each output row once, the
backward reads each gradient row once and writes each point row once). The
TPU's one-hot matmul is not carried over.

- Forward: one flat copy over the output's vectors, thread t on vector j of
  output row r with (r, j) = divmod(t, vectors a row), so every lane works
  whatever C is; a vector is the widest of 16, 8, 4 or 2 bytes that divides
  the row and both pointers (16 at C = 48 f32 or C = 96 bf16, 4 at C = 3).
- Backward: an inverse index, then one ordered sum per point row, with no
  float atomics. A stable counting sort of the clamped indices, parallel over
  R (chunk histograms, a prefix and a scan, in-order placement; one
  cooperative launch), lists the rows of each point in ascending r; a group
  of lanes sized to the row owns one point row, reads its gradient rows in
  that order as wide vectors and adds them in f32 from 0. The sums therefore
  run in the order of ``index_add_`` on the CPU: the kernel equals
  ``gather_bwd_reference`` on CPU tensors bit for bit, and two runs give the
  same bits. Its scratch (the permutation, each point's first slot, the
  count matrix) is allocated here.

``gather_rows`` is the autograd-aware entry: a ``torch.autograd.Function``
whose forward is ``gather_fwd`` and whose backward is ``gather_bwd`` (only
when ``points`` needs a gradient). On CPU tensors both run their plain
versions; on CUDA tensors they launch their kernels or raise. Launches are
counted in ``gather_fwd.launches`` and ``gather_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import refuse_export

_BWD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _clamped(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.long().clamp(0, n - 1)


def gather_fwd_reference(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain forward: points [B, N, C], idx [B, R] -> [B, R, C]."""
    c = points.shape[-1]
    return torch.gather(points, 1, _clamped(idx, points.shape[1])[..., None].expand(-1, -1, c))


def gather_bwd_reference(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """Plain backward: idx [B, R], g [B, R, C] -> [B, N, C] f32, sums in f32."""
    b, _, c = g.shape
    out = torch.zeros(b, n, c, dtype=torch.float32, device=g.device)
    for i in range(b):
        out[i].index_add_(0, _clamped(idx[i], n), g[i].float())
    return out


@functools.cache
def _lib():
    from .build import load

    lib = load("gather")
    lib.s3f_gather_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.s3f_gather_bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.s3f_gather_bwd_scratch.argtypes = [ctypes.c_int] * 3
    lib.s3f_gather_fwd.restype = ctypes.c_int
    lib.s3f_gather_bwd.restype = ctypes.c_int
    lib.s3f_gather_bwd_scratch.restype = ctypes.c_longlong
    return lib


def _check_idx(idx: torch.Tensor, b: int, device: torch.device) -> torch.Tensor:
    if idx.ndim != 2 or idx.shape[0] != b or idx.device != device:
        raise ValueError(f"idx must be [{b}, R] on {device}, got {tuple(idx.shape)} on "
                         f"{idx.device}")
    return idx.to(torch.int32).contiguous()


def gather_fwd(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, R] -> [B, R, C] (no autograd; see gather_rows)."""
    refuse_export("gather_fwd")
    if points.ndim != 3:
        raise ValueError(f"points must be [B, N, C], got {tuple(points.shape)}")
    if points.device.type == "cpu":
        return gather_fwd_reference(points, idx)
    if points.device.type != "cuda":
        raise ValueError(f"gather_fwd runs on cpu or cuda, not {points.device}")
    b, n, c = points.shape
    idx = _check_idx(idx, b, points.device)
    if points.element_size() not in (2, 4) or not points.is_floating_point() \
            or not points.is_contiguous():
        raise ValueError(f"gather kernel takes contiguous 2- or 4-byte floats, got {points.dtype}")
    r = idx.shape[1]
    out = torch.empty(b, r, c, dtype=points.dtype, device=points.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(points.device):
        err = _lib().s3f_gather_fwd(points.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, r, c,
                                    points.element_size(),
                                    torch.cuda.current_stream(points.device).cuda_stream)
    if err:
        raise RuntimeError(f"gather_fwd kernel launch failed: CUDA error {err}")
    gather_fwd.launches += 1
    return out


def gather_bwd(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """idx [B, R], g [B, R, C] -> the points' gradient [B, N, C] in f32."""
    if g.ndim != 3:
        raise ValueError(f"g must be [B, R, C], got {tuple(g.shape)}")
    if g.device.type == "cpu":
        return gather_bwd_reference(idx, g, n)
    if g.device.type != "cuda":
        raise ValueError(f"gather_bwd runs on cpu or cuda, not {g.device}")
    b, r, c = g.shape
    idx = _check_idx(idx, b, g.device)
    if idx.shape[1] != r or g.dtype not in _BWD_DTYPES:
        raise ValueError(f"gather_bwd kernel: g {tuple(g.shape)} {g.dtype} against idx "
                         f"{tuple(idx.shape)}")
    g = g.contiguous()
    out = torch.empty(b, n, c, dtype=torch.float32, device=g.device)
    if out.numel() == 0 or r == 0:
        return out.zero_()
    lib = _lib()
    scratch = torch.empty(lib.s3f_gather_bwd_scratch(b, n, r), dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.s3f_gather_bwd(idx.data_ptr(), g.data_ptr(), out.data_ptr(),
                                 scratch.data_ptr(), b, n, r, c, _BWD_DTYPES[g.dtype],
                                 torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"gather_bwd kernel launch failed: CUDA error {err}")
    gather_bwd.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = points.shape[1], points.dtype
        return gather_fwd(points, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return gather_bwd(idx, g, ctx.n).to(ctx.dtype), None


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, R] int -> [B, R, C] (= take_along_axis), with
    its backward under autograd."""
    return _GatherRows.apply(points, idx)


gather_fwd.launches = 0
gather_bwd.launches = 0
