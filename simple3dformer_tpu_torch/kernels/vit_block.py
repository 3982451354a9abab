"""Fused pre-norm ViT block, forward and backward: CUDA kernels for Hopper and
their plain versions.

Replaces the TPU kernels of ``simple3dformer_tpu/kernels/vit_block.py``:

- ``fused_vit_block``: the forward (``_fwd_kernel`` :145 over ``_fwd_math``
  :110, ``pallas_call`` :264). Under autograd its backward is
  ``fused_vit_block_bwd``, the recompute backward (``_bwd_kernel`` :153,
  ``pallas_call`` :290): only x and the weights are kept from the forward.
- ``fused_vit_block_train``: the training block. Its forward
  ``fused_vit_block_train_fwd`` (``_fwd_kernel_res`` :336, ``pallas_call``
  :366) also keeps qkv, the probabilities, o, h1 and a1 (fc1 before GELU);
  its backward ``fused_vit_block_train_bwd`` (``_bwd_kernel_res`` :394,
  ``pallas_call`` :477) runs only the gradient products from them.

One call computes a whole timm block on x [B, N, D]:

    h = x + proj(heads(softmax(q k^T / sqrt(dh)) v))   with qkv = LN1(x) Wqkv^T + bqkv
    y = h + fc2(gelu_tanh(fc1(LN2(h))))

Numerics are the TPU kernels': LayerNorm (centred two-pass, eps 1e-6),
softmax, GELU (tanh form), residuals and every sum in f32; matmul operands in
the compute dtype ``cdt`` (f32, or bf16 rounded to nearest even), rounded at
the same places in forward and backward; the output and gx in x.dtype, the
weight gradients in f32.

What bounds it on the card, and the design. The TPU kernels pack several
samples into one [T, D] tile under a block-diagonal mask and keep all twelve
weights and the weight gradients in VMEM across a sequential grid; a Hopper
block has 227 KB of shared memory and blocks run in no order. So each call is
a chain of the repository's own kernels (``csrc/vit_block.cu``). Every GEMM
runs on the tensor-core core shared with the vector attention
(``csrc/tc_gemm.cuh``, 64 x 64 output tiles here): 3-pass TF32 ``mma.sync``
for an f32 compute dtype, bf16 ``mma.sync`` for bf16. Forward: each
LayerNorm's row statistics once, GEMMs that apply the LayerNorm to the staged
operand (qkv, fc1, the latter with a GELU epilogue keeping a1), an attention
kernel per (64 query rows, head, sample; 32 at head_dim 256) that holds the
whole score row in shared memory (N <= 512), so the softmax is the exact
one, and GEMMs with bias and residual epilogues (proj, fc2). Backward: each
input gradient one GEMM (dX = dY W), each weight gradient one GEMM over the
M = B*N token rows in fixed chunks with its bias gradient summed in the same
pass (dW = dY^T X, in [out, in] layout; the chunks' partials added in order),
LayerNorm weight gradients column sums in a fixed order, the LayerNorm input
gradient a row kernel, and the attention backward two kernels: one over query
rows (g_p = g_o v^T, g_s, g_q = g_s k; g_s passed on in the compute dtype)
and one over key rows (g_k = g_s^T q and g_v = p^T g_o, summed over the query
tiles in order in registers). The attention's products run on the tensor
cores as the GEMMs' do (``mma.sync``, 3-pass TF32 or bf16), their tiles
staged with cp.async, double-buffered. Where a GEMM's output tiles do not
fill the card's 132 SMs its contraction is split in fixed chunks too. No
float atomics, so two runs give the same bits. At the flagship shape (B=32,
N=26, D=384) the products bound a call (2.98 GFLOP a forward), and M = 832
rows make the GEMMs small, so launch latency weighs too. ``wgmma``, TMA and
one persistent launch are later work.

On a CPU tensor every wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Each wrapper counts its kernel launches in
``<wrapper>.launches`` (one per call, for the whole chain).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# weight order of the TPU kernel (simple3dformer_tpu/kernels/vit_block.py:61)
WNAMES = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj",
          "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
# what the training forward keeps, in the kernel's buffer order (the [M, *]
# buffers first, so each starts 16-byte aligned for the GEMMs' copies)
RNAMES = ("qkv", "o", "h1", "a1", "probs")
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


def residual_shapes(b: int, n: int, d: int, heads: int) -> dict[str, tuple[int, ...]]:
    """Shapes of the training forward's residuals (all f32)."""
    return dict(qkv=(b, n, 3 * d), probs=(b, heads, n, n), o=(b, n, d), h1=(b, n, d),
                a1=(b, n, 4 * d))


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


def _ln_parts(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """LayerNorm over the last dim: (normed*scale+bias, xhat, rstd)."""
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    xh = xc * rstd
    return xh * scale + bias, xh, rstd


def _ln_bwd(g_z, xh, rstd, scale):
    """Gradient of xh*scale+bias with respect to the LayerNorm input."""
    g_xh = g_z * scale
    m1 = g_xh.mean(-1, keepdim=True)
    m2 = (g_xh * xh).mean(-1, keepdim=True)
    return rstd * (g_xh - m1 - xh * m2)


def _gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * a * (1.0 + torch.tanh(_GELU_C * (a + _GELU_A * a * a * a)))


def _gelu_tanh_grad(a: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_GELU_C * (a + _GELU_A * a * a * a))
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * _GELU_C * (1.0 + 3.0 * _GELU_A * a * a)


def vit_block_train_reference(x: torch.Tensor, weights: dict, heads: int,
                              cdt: torch.dtype | None = None):
    """Plain version of the training forward: (y, residuals keyed by RNAMES)."""
    cdt = cdt or x.dtype
    b, n, d = x.shape
    dh = d // heads
    w = {k: weights[k].float() for k in WNAMES}

    def dot(a, wt):  # a [.., K] times a Linear weight [out, K], f32 sums
        return torch.matmul(_operand(a, cdt), _operand(wt, cdt).transpose(-1, -2))

    xf = x.float()
    qkv = dot(_ln_parts(xf, w["ln1_s"], w["ln1_b"])[0], w["wqkv"]) + w["bqkv"]
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)  # [B, H, N, dh]
    s = torch.matmul(_operand(q, cdt), _operand(k, cdt).transpose(-1, -2)) * dh ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    o = torch.matmul(_operand(p, cdt), _operand(v, cdt))
    o = o.transpose(1, 2).reshape(b, n, d)
    h1 = xf + (dot(o, w["wproj"]) + w["bproj"])
    a1 = dot(_ln_parts(h1, w["ln2_s"], w["ln2_b"])[0], w["w1"]) + w["b1"]
    y = h1 + (dot(_gelu_tanh(a1), w["w2"]) + w["b2"])
    return y.to(x.dtype), dict(qkv=qkv, probs=p, o=o, h1=h1, a1=a1)


def vit_block_reference(x: torch.Tensor, weights: dict, heads: int,
                        cdt: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, the same math in the same dtypes."""
    return vit_block_train_reference(x, weights, heads, cdt)[0]


def vit_block_backward_reference(x: torch.Tensor, g: torch.Tensor, weights: dict, heads: int,
                                 cdt: torch.dtype | None = None, residuals: dict | None = None):
    """Plain version of both backwards: (gx in x.dtype, f32 gradients keyed by WNAMES).

    With ``residuals`` (the training forward's) it is the residual backward
    (``_bwd_kernel_res``); without, the forward runs first, as the recompute
    backward (``_bwd_kernel``) does. The formulas and rounding points are the
    TPU kernels' (simple3dformer_tpu/kernels/vit_block.py:172-211, :428-463).
    """
    cdt = cdt or x.dtype
    if residuals is None:
        residuals = vit_block_train_reference(x, weights, heads, cdt)[1]
    b, n, d = x.shape
    dh = d // heads
    scale = dh ** -0.5
    w = {k: weights[k].float() for k in WNAMES}

    def op(t):
        return _operand(t, cdt)

    def tdot(a, c):  # sum over the token rows: a^T c, [a cols, c cols]
        return torch.matmul(op(a).reshape(-1, a.shape[-1]).T, op(c).reshape(-1, c.shape[-1]))

    def rows(t):  # sum over the token rows
        return t.reshape(-1, t.shape[-1]).sum(0)

    xf, g_y = x.float(), g.float()
    qkv, o, h1, a1, p = (residuals[k].float() for k in RNAMES)
    z1, xh1, rstd1 = _ln_parts(xf, w["ln1_s"], w["ln1_b"])
    z2, xh2, rstd2 = _ln_parts(h1, w["ln2_s"], w["ln2_b"])
    gw = {}
    # MLP branch
    g_a1 = torch.matmul(op(g_y), op(w["w2"])) * _gelu_tanh_grad(a1)
    gw["w2"] = tdot(g_y, _gelu_tanh(a1))
    gw["b2"] = rows(g_y)
    g_z2 = torch.matmul(op(g_a1), op(w["w1"]))
    gw["w1"] = tdot(g_a1, z2)
    gw["b1"] = rows(g_a1)
    gw["ln2_s"] = rows(g_z2 * xh2)
    gw["ln2_b"] = rows(g_z2)
    g_h1 = g_y + _ln_bwd(g_z2, xh2, rstd2, w["ln2_s"])
    # attention branch
    g_o = torch.matmul(op(g_h1), op(w["wproj"]))
    gw["wproj"] = tdot(g_h1, o)
    gw["bproj"] = rows(g_h1)
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)  # [B, H, N, dh]
    g_oh = g_o.reshape(b, n, heads, dh).transpose(1, 2)
    g_p = torch.matmul(op(g_oh), op(v).transpose(-1, -2))
    g_v = torch.matmul(op(p).transpose(-1, -2), op(g_oh))
    g_s = p * (g_p - (g_p * p).sum(-1, keepdim=True)) * scale
    g_q = torch.matmul(op(g_s), op(k))
    g_k = torch.matmul(op(g_s).transpose(-1, -2), op(q))
    g_qkv = torch.stack([g_q, g_k, g_v]).permute(1, 3, 0, 2, 4).reshape(b, n, 3 * d)
    g_z1 = torch.matmul(op(g_qkv), op(w["wqkv"]))
    gw["wqkv"] = tdot(g_qkv, z1)
    gw["bqkv"] = rows(g_qkv)
    gw["ln1_s"] = rows(g_z1 * xh1)
    gw["ln1_b"] = rows(g_z1)
    g_x = g_h1 + _ln_bwd(g_z1, xh1, rstd1, w["ln1_s"])
    return g_x.to(x.dtype), {k: gw[k] for k in WNAMES}


def _check_cuda_args(x: torch.Tensor, weights: dict, heads: int, cdt: torch.dtype,
                     name: str = "fused_vit_block") -> None:
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
        raise ValueError(f"{name} kernel: {why}")
    for wname, shape in weight_shapes(d).items():
        t = weights[wname]
        if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"weight {wname} must be contiguous 16-byte aligned float32 on "
                             f"{x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"weight {wname} has shape {tuple(t.shape)}, want {shape}")


def _check_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"gradient {tuple(g.shape)} {g.dtype} on {g.device} does not match "
                         f"x {tuple(x.shape)} {x.dtype} on {x.device}")
    return _aligned(g.contiguous())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 16-byte aligned (the kernels'
    cp.async copies read 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _device_of(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return x.device.type


@functools.cache
def _lib():
    from .build import load

    lib = load("vit_block")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.s3f_vit_block_fwd.argtypes = [ptr, ptr] + [i32] * 6 + [ptr] * 3
    lib.s3f_vit_block_fwd_res.argtypes = [ptr, ptr] + [i32] * 6 + [ptr] * 4
    lib.s3f_vit_block_bwd_res.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr] * 5
    lib.s3f_vit_block_bwd.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr] * 4
    for fn in (lib.s3f_vit_block_fwd, lib.s3f_vit_block_fwd_res, lib.s3f_vit_block_bwd_res,
               lib.s3f_vit_block_bwd):
        fn.restype = ctypes.c_int
    lib.s3f_vit_block_residual_floats.argtypes = [i32] * 4
    lib.s3f_vit_block_fwd_scratch_floats.argtypes = [i32] * 5
    lib.s3f_vit_block_bwd_scratch_floats.argtypes = [i32] * 6
    for fn in (lib.s3f_vit_block_residual_floats, lib.s3f_vit_block_fwd_scratch_floats,
               lib.s3f_vit_block_bwd_scratch_floats):
        fn.restype = ctypes.c_longlong
    lib.s3f_vit_block_gemm_grids.argtypes = [i32] * 3 + [ptr]
    lib.s3f_vit_block_gemm_grids.restype = None
    return lib


def gemm_shapes(b: int, n: int, d: int) -> dict[str, tuple[int, int, int]]:
    """(rows, columns, contraction) of each GEMM of the chain at [b, n, d], in
    the order of s3f_vit_block_gemm_grids."""
    m = b * n
    return {"qkv": (m, 3 * d, d), "proj": (m, d, d), "fc1": (m, 4 * d, d), "fc2": (m, d, 4 * d),
            "g_a1": (m, 4 * d, d), "g_z2": (m, d, 4 * d), "g_o": (m, d, d), "g_z1": (m, d, 3 * d),
            "dW2": (d, 4 * d, m), "dW1": (4 * d, d, m), "dWproj": (d, d, m), "dWqkv": (3 * d, d, m)}


def gemm_grids(b: int, n: int, d: int) -> dict[str, tuple[int, int]]:
    """(output tiles, contraction chunks) of each GEMM of the CUDA chain at
    [b, n, d], as the kernels launch them (needs the built library)."""
    names = list(gemm_shapes(b, n, d))
    out = (ctypes.c_int * (2 * len(names)))()
    _lib().s3f_vit_block_gemm_grids(b, n, d, out)
    return {k: (out[2 * i], out[2 * i + 1]) for i, k in enumerate(names)}


def _pointers(tensors) -> ctypes.Array:
    ptrs = [t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _launch(name: str, x: torch.Tensor, fn, *args) -> None:
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _flags(x: torch.Tensor, cdt: torch.dtype) -> tuple[int, int]:
    return int(x.dtype == torch.bfloat16), int(cdt == torch.bfloat16)


def _split_residuals(buf: torch.Tensor, b: int, n: int, d: int, heads: int) -> dict:
    shapes = residual_shapes(b, n, d, heads)
    sizes = [int(torch.Size(shapes[k]).numel()) for k in RNAMES]
    return {k: t.view(shapes[k]) for k, t in zip(RNAMES, torch.split(buf, sizes))}


def _residual_buffer(residuals: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """The residuals as one f32 buffer in RNAMES order (no copy when they are
    the views fused_vit_block_train_fwd returned)."""
    b, n, d = x.shape
    shapes = residual_shapes(b, n, d, heads)
    ts = [residuals[k] for k in RNAMES]
    for k, t in zip(RNAMES, ts):
        if tuple(t.shape) != shapes[k] or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"residual {k} must be float32 {shapes[k]} on {x.device}")
    packed = ts[0].data_ptr() % 16 == 0 and all(t.is_contiguous() for t in ts) and all(
        a.data_ptr() + a.numel() * 4 == c.data_ptr() for a, c in zip(ts, ts[1:]))
    if packed:
        return ts[0].as_strided((sum(t.numel() for t in ts),), (1,))
    return torch.cat([t.reshape(-1) for t in ts])


def _forward(x: torch.Tensor, weights: dict, heads: int, cdt: torch.dtype) -> torch.Tensor:
    """The forward kernel alone (or its plain version on the CPU)."""
    if _device_of(x, "fused_vit_block") == "cpu":
        return vit_block_reference(x, weights, heads, cdt)
    _check_cuda_args(x, weights, heads, cdt)
    x = _aligned(x)
    b, n, d = x.shape
    lib = _lib()
    y = torch.empty_like(x)
    # Dropped on return while the kernels may still run: the caching allocator
    # hands the block out again only to work queued later on this stream.
    scratch = torch.empty(lib.s3f_vit_block_fwd_scratch_floats(b, n, d, heads, 1),
                          device=x.device, dtype=torch.float32)
    _launch("fused_vit_block", x, lib.s3f_vit_block_fwd, x.data_ptr(), y.data_ptr(),
            *_flags(x, cdt), b, n, d, heads, _pointers(weights[k] for k in WNAMES),
            scratch.data_ptr())
    fused_vit_block.launches += 1
    return y


def _grad_buffers(x: torch.Tensor) -> dict:
    d = x.shape[-1]
    shapes = weight_shapes(d)
    sizes = [int(torch.Size(shapes[k]).numel()) for k in WNAMES]
    flat = torch.empty(sum(sizes), device=x.device, dtype=torch.float32)
    return {k: t.view(shapes[k]) for k, t in zip(WNAMES, torch.split(flat, sizes))}


def fused_vit_block_train_fwd(x: torch.Tensor, weights: dict, heads: int,
                              cdt: torch.dtype | None = None):
    """Training forward: (y [B, N, D] in x.dtype, residuals keyed by RNAMES, f32)."""
    cdt = cdt or x.dtype
    if _device_of(x, "fused_vit_block_train_fwd") == "cpu":
        return vit_block_train_reference(x, weights, heads, cdt)
    _check_cuda_args(x, weights, heads, cdt, "fused_vit_block_train_fwd")
    x = _aligned(x)
    b, n, d = x.shape
    lib = _lib()
    y = torch.empty_like(x)
    res = torch.empty(lib.s3f_vit_block_residual_floats(b, n, d, heads), device=x.device,
                      dtype=torch.float32)
    scratch = torch.empty(lib.s3f_vit_block_fwd_scratch_floats(b, n, d, heads, 0),
                          device=x.device, dtype=torch.float32)
    _launch("fused_vit_block_train_fwd", x, lib.s3f_vit_block_fwd_res, x.data_ptr(),
            y.data_ptr(), *_flags(x, cdt), b, n, d, heads,
            _pointers(weights[k] for k in WNAMES), res.data_ptr(), scratch.data_ptr())
    fused_vit_block_train_fwd.launches += 1
    return y, _split_residuals(res, b, n, d, heads)


def fused_vit_block_train_bwd(x: torch.Tensor, g: torch.Tensor, weights: dict, heads: int,
                              cdt: torch.dtype | None = None, residuals: dict | None = None):
    """Residual backward: (gx in x.dtype, f32 weight gradients keyed by WNAMES)."""
    cdt = cdt or x.dtype
    if residuals is None:
        raise ValueError("the residual backward needs the training forward's residuals")
    if _device_of(x, "fused_vit_block_train_bwd") == "cpu":
        return vit_block_backward_reference(x, g, weights, heads, cdt, residuals)
    _check_cuda_args(x, weights, heads, cdt, "fused_vit_block_train_bwd")
    x, g = _aligned(x), _check_grad(x, g)
    b, n, d = x.shape
    lib = _lib()
    res = _residual_buffer(residuals, x, heads)
    gx = torch.empty_like(x)
    grads = _grad_buffers(x)
    scratch = torch.empty(lib.s3f_vit_block_bwd_scratch_floats(b, n, d, heads, 0,
                                                                    _flags(x, cdt)[1]),
                          device=x.device, dtype=torch.float32)
    _launch("fused_vit_block_train_bwd", x, lib.s3f_vit_block_bwd_res, x.data_ptr(),
            g.data_ptr(), gx.data_ptr(), *_flags(x, cdt), b, n, d, heads,
            _pointers(weights[k] for k in WNAMES), res.data_ptr(),
            _pointers(grads[k] for k in WNAMES), scratch.data_ptr())
    fused_vit_block_train_bwd.launches += 1
    return gx, grads


def fused_vit_block_bwd(x: torch.Tensor, g: torch.Tensor, weights: dict, heads: int,
                        cdt: torch.dtype | None = None):
    """Recompute backward: (gx in x.dtype, f32 weight gradients keyed by WNAMES)
    from x and the weights alone."""
    cdt = cdt or x.dtype
    if _device_of(x, "fused_vit_block_bwd") == "cpu":
        return vit_block_backward_reference(x, g, weights, heads, cdt)
    _check_cuda_args(x, weights, heads, cdt, "fused_vit_block_bwd")
    x, g = _aligned(x), _check_grad(x, g)
    b, n, d = x.shape
    lib = _lib()
    gx = torch.empty_like(x)
    grads = _grad_buffers(x)
    scratch = torch.empty(lib.s3f_vit_block_bwd_scratch_floats(b, n, d, heads, 1,
                                                                    _flags(x, cdt)[1]),
                          device=x.device, dtype=torch.float32)
    _launch("fused_vit_block_bwd", x, lib.s3f_vit_block_bwd, x.data_ptr(), g.data_ptr(),
            gx.data_ptr(), *_flags(x, cdt), b, n, d, heads,
            _pointers(weights[k] for k in WNAMES), _pointers(grads[k] for k in WNAMES),
            scratch.data_ptr())
    fused_vit_block_bwd.launches += 1
    return gx, grads


def records_grad(x: torch.Tensor, weights: dict) -> bool:
    """Whether autograd records this call (and so needs a backward)."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(weights[k].requires_grad for k in WNAMES))


class _RecomputeBlock(torch.autograd.Function):
    """fused_vit_block under autograd: the forward kernel, then the recompute backward."""

    @staticmethod
    def forward(ctx, x, heads, cdt, *ws):
        weights = dict(zip(WNAMES, ws))
        ctx.heads, ctx.cdt = heads, cdt
        ctx.save_for_backward(x, *ws)
        return _forward(x, weights, heads, cdt)

    @staticmethod
    def backward(ctx, g):
        x, *ws = ctx.saved_tensors
        gx, gw = fused_vit_block_bwd(x, g, dict(zip(WNAMES, ws)), ctx.heads, ctx.cdt)
        return (gx, None, None, *(gw[k] for k in WNAMES))


class _TrainBlock(torch.autograd.Function):
    """fused_vit_block_train: the residual-saving forward, then the residual backward."""

    @staticmethod
    def forward(ctx, x, heads, cdt, *ws):
        weights = dict(zip(WNAMES, ws))
        y, res = fused_vit_block_train_fwd(x, weights, heads, cdt)
        ctx.heads, ctx.cdt = heads, cdt
        ctx.save_for_backward(x, *ws, *(res[k] for k in RNAMES))
        return y

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        ws, rs = rest[:len(WNAMES)], rest[len(WNAMES):]
        gx, gw = fused_vit_block_train_bwd(x, g, dict(zip(WNAMES, ws)), ctx.heads, ctx.cdt,
                                           dict(zip(RNAMES, rs)))
        return (gx, None, None, *(gw[k] for k in WNAMES))


def fused_vit_block(x: torch.Tensor, weights: dict, heads: int,
                    cdt: torch.dtype | None = None) -> torch.Tensor:
    """timm pre-norm Block on x [B, N, D]; weights keyed by WNAMES.

    cdt: matmul compute dtype (None: x.dtype). Returns [B, N, D] in x.dtype.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    and raises on anything the kernel does not take. When autograd records,
    the backward is the recompute backward ``fused_vit_block_bwd``.
    """
    cdt = cdt or x.dtype
    if records_grad(x, weights):
        return _RecomputeBlock.apply(x, heads, cdt, *(weights[k] for k in WNAMES))
    return _forward(x, weights, heads, cdt)


def fused_vit_block_train(x: torch.Tensor, weights: dict, heads: int,
                          cdt: torch.dtype | None = None) -> torch.Tensor:
    """The training block: fused_vit_block_train_fwd, with fused_vit_block_train_bwd
    as its backward under autograd. Returns [B, N, D] in x.dtype."""
    return _TrainBlock.apply(x, heads, cdt or x.dtype, *(weights[k] for k in WNAMES))


fused_vit_block.launches = 0
fused_vit_block_bwd.launches = 0
fused_vit_block_train_fwd.launches = 0
fused_vit_block_train_bwd.launches = 0
