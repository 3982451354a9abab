"""Multi-head self-attention for mid-size N, forward and backward: CUDA
kernels for Hopper and their plain versions.

Replaces the TPU kernels of ``simple3dformer_tpu/kernels/mhsa.py``: the
forward (``_fwd_kernel`` :69 over ``_probs`` :57, ``pallas_call`` :120 in
``_fwd_impl``) and the backward (``_bwd_kernel`` :74, ``pallas_call`` :144
in ``_bwd``). On q, k, v [B, N, H, dh]:

    s = (q k^T) * scale;  p = exp(s - max) / sum    f32
    o = round(p) v                                   round() = to the input dtype
    dv = round(p)^T g;  dp = g v^T;  ds = p (dp - rowsum(dp p)) scale
    dq = round(ds) k;  dk = round(ds)^T q            every product summed in f32

and o, dq, dk, dv leave in the input dtype (dk and dv summed in f32 first,
as the TPU kernel's ``unpack`` casts them).

The kernels (``csrc/mhsa.cu``) run every product on the tensor cores with
``mma.sync``: f32 as 3-pass TF32 (each operand split into two TF32 values,
three products summed in f32; one pass keeps about 10 bits and misses 1e-4
at dh = 256, which ``tests/test_torch_port_mhsa.py`` pins on the CPU), bf16
as one bf16 pass with f32 sums. The products bound them, at 165 TFLOP/s (the
3-pass rate, 495 / 3) in f32 and 989 in bf16. k, v, q and g stream through
shared memory in tiles with ``cp.async``: a Hopper block has 227 KB, not the
1 MB a (sample, head) row of k holds at N = 1025, dh = 256 in f32, and blocks
run in no order, so the TPU kernel's dk/dv sum across a sequential grid axis
becomes one block per key tile that loops over the query tiles (no float
atomics: two runs give the same bits). That block also writes round(ds) to
a scratch [B*H, N, N rounded up to 32] of the input dtype, and dq = round(ds)
k is a kernel of its own: five products in the backward, as the TPU kernel's.
The f32 forward is one pass with an online softmax (rounding p to f32 is the
identity); the bf16 forward keeps a first pass for each row's max and sum,
so p is normalised before it is rounded as the TPU kernel rounds it. The row
(max, sum) pairs are kept for the backward. delta is rowsum(g o) in f32
(equal to the TPU kernel's rowsum(dp p) in real arithmetic, O(dh) a row; so
the autograd Function keeps o) and rowsum(dp p) in bf16, where o is rounded
(two more products). q, k and v are read through their strides (views of
the packed qkv projection need no copies; a view whose pointer or strides
are not 16-byte aligned is copied first); o, dq, dk and dv are written
contiguous [B, N, H, dh]. Against the plain version on the card: f32 within
1e-4 of the largest value (sums in another order, one exp, the split's last
bits), bf16 within 3e-2 (an f32 last bit can flip a rounded p or ds).

On a CPU tensor ``mhsa`` runs the plain versions; on a CUDA tensor it
launches the kernels or raises. ``mhsa_fwd.launches`` and
``mhsa_bwd.launches`` count calls that launched (the backward is three
kernels a call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import refuse_export

# Attention's gate for this kernel, as the JAX package's (simple3dformer_tpu/nn/layers.py:169-171)
MIN_N, MAX_N = 256, 2048
HEAD_DIMS = (64, 128, 192, 256)
DTYPES = (torch.float32, torch.bfloat16)


def unsupported(n: int, dh: int, dtype: torch.dtype) -> str | None:
    """Why the kernels cannot take this shape and dtype, or None when they can."""
    if not 1 <= n <= MAX_N:
        return f"sequence length {n} outside 1..{MAX_N}"
    if dh not in HEAD_DIMS:
        return f"head_dim {dh} not in {HEAD_DIMS}"
    if dtype not in DTYPES:
        return f"dtype {dtype} is not float32 or bfloat16"
    return None


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, N, H, dh] -> [B, H, N, dh] in f32 (the values of the input dtype)."""
    return t.permute(0, 2, 1, 3).float()


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, H, N, N] f32 probabilities, as ``_probs``: exact max, exp, / sum."""
    s = torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def mhsa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of the forward: [B, N, H, dh] each -> o [B, N, H, dh] in q.dtype."""
    pc = _probs(q, k, scale).to(q.dtype).float()
    return torch.matmul(pc, _heads_first(v)).permute(0, 2, 1, 3).to(q.dtype)


def mhsa_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                            scale: float):
    """Plain version of the backward: (dq, dk, dv), each [B, N, H, dh] in q.dtype."""
    dtype = q.dtype
    p = _probs(q, k, scale)
    gf = _heads_first(g.to(dtype))
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, _heads_first(v).transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dsc = ds.to(dtype).float()
    dq = torch.matmul(dsc, _heads_first(k))
    dk = torch.matmul(dsc.transpose(-1, -2), _heads_first(q))
    return tuple(t.permute(0, 2, 1, 3).to(dtype) for t in (dq, dk, dv))


@functools.cache
def _lib():
    from .build import load

    lib = load("mhsa")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.s3f_mhsa_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [ctypes.c_float, ptr]
    lib.s3f_mhsa_fwd.restype = i32
    lib.s3f_mhsa_bwd.argtypes = [ptr] * 12 + [i32] * 5 + [ctypes.c_float, ptr]
    lib.s3f_mhsa_bwd.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"mhsa kernel: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"not {tuple(like.shape)} {like.dtype} on {like.device}")
    if t.stride(3) != 1:
        raise ValueError(f"mhsa kernel: {name}'s head_dim must be contiguous")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy where its pointer or a stride is not 16-byte
    aligned (the kernels copy 16 bytes at a time)."""
    size = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(i) * size % 16 for i in range(3)):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _strides(*tensors: torch.Tensor):
    """(sample, token, head) element strides of each tensor, as a C array."""
    vals = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _shape(q: torch.Tensor) -> tuple[int, int, int, int]:
    if q.ndim != 4:
        raise ValueError(f"mhsa takes [B, N, H, dh] tensors, got {tuple(q.shape)}")
    b, n, h, dh = q.shape
    why = unsupported(n, dh, q.dtype)
    if why:
        raise ValueError(f"mhsa kernel: {why}")
    return b, n, h, dh


def mhsa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """(o [B, N, H, dh] in q.dtype, row statistics [B*H, N, 2] f32 or None on the CPU)."""
    refuse_export("mhsa_fwd")
    if q.device.type == "cpu":
        return mhsa_reference(q, k, v, scale), None
    if q.device.type != "cuda":
        raise ValueError(f"mhsa runs on cpu or cuda, not {q.device}")
    b, n, h, dh = _shape(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty(b, n, h, dh, dtype=q.dtype, device=q.device)
    stats = torch.empty(b * h, n, 2, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().s3f_mhsa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
                                  o.data_ptr(), stats.data_ptr(), b, n, h, dh,
                                  int(q.dtype == torch.bfloat16), float(scale),
                                  torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mhsa forward kernel launch failed: CUDA error {err}")
    mhsa_fwd.launches += 1
    return o, stats


def mhsa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, scale: float,
             stats: torch.Tensor | None, o: torch.Tensor):
    """(dq, dk, dv), each [B, N, H, dh] in q.dtype; ``o`` and ``stats`` are
    what ``mhsa_fwd`` returned for q, k, v (stats None on the CPU)."""
    if q.device.type == "cpu":
        return mhsa_backward_reference(q, k, v, g, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mhsa runs on cpu or cuda, not {q.device}")
    b, n, h, dh = _shape(q)
    g = g.to(q.dtype)
    if g.stride(3) != 1:
        g = g.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g), ("o", o)):
        _check(name, t, q)
    if not o.is_contiguous():
        raise ValueError("mhsa kernel: o must be contiguous, as mhsa_fwd returns it")
    q, k, v, g = (_aligned(t) for t in (q, k, v, g))
    if (stats is None or stats.shape != (b * h, n, 2) or stats.dtype != torch.float32
            or not stats.is_contiguous()):
        raise ValueError(f"mhsa kernel: stats must be contiguous f32 [{b * h}, {n}, 2]")
    dq, dk, dv = (torch.empty(b, n, h, dh, dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty(b * h, n, dtype=torch.float32, device=q.device)
    ds = torch.empty(b * h, n, -(-n // 32) * 32, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().s3f_mhsa_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                  o.data_ptr(), _strides(q, k, v, g), stats.data_ptr(),
                                  delta.data_ptr(), ds.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(), b, n, h, dh,
                                  int(q.dtype == torch.bfloat16), float(scale),
                                  torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mhsa backward kernel launch failed: CUDA error {err}")
    mhsa_bwd.launches += 1
    return dq, dk, dv


mhsa_fwd.launches = 0
mhsa_bwd.launches = 0


class _MHSA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, stats = mhsa_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, stats, o)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, stats, o = ctx.saved_tensors
        return (*mhsa_bwd(q, k, v, g, ctx.scale, stats, o), None)


def mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, N, H, dh] tensors -> [B, N, H, dh], with
    its backward under autograd; the forward alone when nothing records a
    gradient (``torch.inference_mode()``, ``torch.no_grad()``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _MHSA.apply(q, k, v, scale)
    return mhsa_fwd(q, k, v, scale)[0]
