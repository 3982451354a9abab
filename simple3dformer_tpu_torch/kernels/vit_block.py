"""Fused pre-norm ViT block forward: CUDA kernel for Hopper and its plain version.

Replaces the TPU kernel ``simple3dformer_tpu/kernels/vit_block.py``
(``_fwd_kernel`` :145 over ``_fwd_math`` :110, launched by the
``pallas_call`` at :264). One call computes a whole timm block on x [B, N, D]:

    h = x + proj(heads(softmax(q k^T / sqrt(dh)) v))   with qkv = LN1(x) Wqkv^T + bqkv
    y = h + fc2(gelu_tanh(fc1(LN2(h))))

Numerics are the TPU kernel's: LayerNorm (centred two-pass, eps 1e-6),
softmax, GELU (tanh form), residuals and every sum in f32; matmul operands in
the compute dtype ``cdt`` (f32, or bf16 rounded to nearest even); the output
in x.dtype.

What bounds it on the card, and the design. The TPU kernel packs several
samples into one [T, D] tile under a block-diagonal mask and keeps all twelve
weights in VMEM (7 MB at deit_small in f32), far beyond the 227 KB of shared
memory a Hopper block has. Here the block is a chain of five launches of the
repository's own kernels (``csrc/vit_block.cu``): a tiled GEMM with a
LayerNorm prologue (qkv, fc1, the latter with a GELU epilogue), an attention
kernel per (query tile, head, sample) that holds the whole score row in
shared memory (N <= 512), and a GEMM with bias and residual epilogues (proj,
fc2). No sample attends to another, so there is no mask and no padded fake
sample. Intermediates go through device memory: at the flagship shape
(B=32, N=26, D=384) they are 11.5 MB of f32 and stay in the 50 MB L2. With
M = B*N = 832 token rows the GEMMs are small, so the chain is bound by f32
FMA issue (no tensor cores yet) and by launch latency, not by bytes; making
it fast (wgmma, TMA, one persistent launch) is later work.

On a CPU tensor ``fused_vit_block`` runs ``vit_block_reference``; on a CUDA
tensor it launches the kernel or raises. ``fused_vit_block.launches`` counts
kernel launches (one per call, for the whole chain).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# weight order of the TPU kernel (simple3dformer_tpu/kernels/vit_block.py:61)
WNAMES = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj",
          "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
EPS = 1e-6
MAX_N = 512
HEAD_DIMS = (64, 128, 256)
_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715


def weight_shapes(d: int) -> dict[str, tuple[int, ...]]:
    """Shapes of the twelve weights for width d (Linear weights are [out, in])."""
    return dict(ln1_s=(d,), ln1_b=(d,), wqkv=(3 * d, d), bqkv=(3 * d,),
                wproj=(d, d), bproj=(d,), ln2_s=(d,), ln2_b=(d,),
                w1=(4 * d, d), b1=(4 * d,), w2=(d, 4 * d), b2=(d,))


def unsupported(n: int, d: int, heads: int) -> str | None:
    """Why the kernel cannot take this shape, or None when it can."""
    if not 1 <= n <= MAX_N:
        return f"sequence length {n} outside 1..{MAX_N}"
    if d % heads:
        return f"width {d} not divisible by {heads} heads"
    if d // heads not in HEAD_DIMS:
        return f"head_dim {d // heads} not in {HEAD_DIMS}"
    return None


def _operand(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """A matmul operand as the kernel sees it: rounded to cdt, held in f32."""
    return t.to(cdt).float()


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    return xc * rstd * scale + bias


def _gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * a * (1.0 + torch.tanh(_GELU_C * (a + _GELU_A * a * a * a)))


def vit_block_reference(x: torch.Tensor, weights: dict, heads: int,
                        cdt: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the same math in the same dtypes."""
    cdt = cdt or x.dtype
    b, n, d = x.shape
    dh = d // heads
    w = {k: weights[k].float() for k in WNAMES}

    def dot(a, wt):  # a [.., K] times a Linear weight [out, K], f32 sums
        return torch.matmul(_operand(a, cdt), _operand(wt, cdt).transpose(-1, -2))

    xf = x.float()
    qkv = dot(_layer_norm(xf, w["ln1_s"], w["ln1_b"]), w["wqkv"]) + w["bqkv"]
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)  # [B, H, N, dh]
    s = torch.matmul(_operand(q, cdt), _operand(k, cdt).transpose(-1, -2)) * dh ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    o = torch.matmul(_operand(p, cdt), _operand(v, cdt))
    o = o.transpose(1, 2).reshape(b, n, d)
    h1 = xf + (dot(o, w["wproj"]) + w["bproj"])
    g1 = _gelu_tanh(dot(_layer_norm(h1, w["ln2_s"], w["ln2_b"]), w["w1"]) + w["b1"])
    y = h1 + (dot(g1, w["w2"]) + w["b2"])
    return y.to(x.dtype)


def _check_cuda_args(x: torch.Tensor, weights: dict, heads: int, cdt: torch.dtype) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _, n, d = x.shape
    why = unsupported(n, d, heads)
    if why:
        raise ValueError(f"fused_vit_block kernel: {why}")
    for name, shape in weight_shapes(d).items():
        t = weights[name]
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"weight {name} must be contiguous float32 on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"weight {name} has shape {tuple(t.shape)}, want {shape}")


@functools.cache
def _entry():
    from .build import load

    fn = load("vit_block").s3f_vit_block_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * (len(WNAMES) + 4) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_vit_block(x: torch.Tensor, weights: dict, heads: int,
                    cdt: torch.dtype | None = None) -> torch.Tensor:
    """timm pre-norm Block on x [B, N, D]; weights keyed by WNAMES.

    cdt: matmul compute dtype (None: x.dtype). Returns [B, N, D] in x.dtype.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    and raises on anything the kernel does not take.
    """
    cdt = cdt or x.dtype
    if x.device.type == "cpu":
        return vit_block_reference(x, weights, heads, cdt)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_block runs on cpu or cuda, not {x.device}")
    _check_cuda_args(x, weights, heads, cdt)
    b, n, d = x.shape
    m = b * n
    y = torch.empty_like(x)
    # Dropped on return while the kernels may still run: the caching allocator
    # hands the block out again only to work queued later on this stream.
    scratch = torch.empty(m * 9 * d, device=x.device, dtype=torch.float32)
    qkv, o, h1, g1 = torch.split(scratch, [3 * m * d, m * d, m * d, 4 * m * d])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
                       int(cdt == torch.bfloat16), b, n, d, heads,
                       *(weights[k].data_ptr() for k in WNAMES),
                       qkv.data_ptr(), o.data_ptr(), h1.data_ptr(), g1.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fused_vit_block kernel launch failed: CUDA error {err}")
    fused_vit_block.launches += 1
    return y


fused_vit_block.launches = 0
