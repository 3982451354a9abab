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

Tensor parallelism (parallel/tp.py) cuts the training chains where the sums
over the model ranks fall: ``vit_block_tp_attn_fwd`` (LN1, the qkv GEMM over
the rank's heads, their attention, the proj GEMM over their inputs: a partial
sum without bias or residual), ``vit_block_tp_mlp_fwd`` (LN2, fc1 over the
rank's columns with the GELU epilogue, fc2 over them), their backwards
``vit_block_tp_mlp_bwd`` and ``vit_block_tp_attn_bwd`` (the partial input
gradient of the LayerNorm's output, the local weight gradients and the whole
bias's), and ``vit_block_tp_ln_bwd``, the LayerNorm backward with its
residual once a partial is summed. The same kernels as the whole block's,
with the model width D apart from a rank's H * dh and F.

On a CPU tensor every wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Each wrapper counts its kernel launches in
``<wrapper>.launches`` (one per call, for the whole chain).

The forward is also a registered torch op, ``torch.ops.s3f.vit_block_fwd``
(registered when this module is imported; nothing is built until its first
launch): its CUDA implementation launches the kernel and counts the launch in
``fused_vit_block.launches``, its CPU implementation is ``vit_block_reference``,
and its fake implementation gives the output's shape and dtype after the
checks that need no data. ``fused_vit_block`` calls the op where autograd
records nothing (serving), so ``torch.export`` keeps the kernel as one node
of an exported program, and a run of that program counts its launches as
eager calls do. The autograd Functions call the implementations directly.
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


def _check_args(x: torch.Tensor, weights: dict, heads: int, cdt: torch.dtype,
                name: str = "fused_vit_block") -> None:
    """The checks that need no data: shapes, dtypes, devices and the kernel's gate."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    _, n, d = x.shape
    why = unsupported(n, d, heads)
    if why:
        raise ValueError(f"{name} kernel: {why}")
    for wname, shape in weight_shapes(d).items():
        t = weights[wname]
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"weight {wname} must be float32 on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"weight {wname} has shape {tuple(t.shape)}, want {shape}")


def _check_cuda_args(x: torch.Tensor, weights: dict, heads: int, cdt: torch.dtype,
                     name: str = "fused_vit_block") -> None:
    _check_args(x, weights, heads, cdt, name)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for wname in WNAMES:
        t = weights[wname]
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"weight {wname} must be contiguous and 16-byte aligned")


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
    lib.s3f_vit_block_tp_attn_fwd.argtypes = [ptr, ptr] + [i32] * 6 + [ptr] * 6
    lib.s3f_vit_block_tp_mlp_fwd.argtypes = [ptr, ptr] + [i32] * 5 + [ptr] * 4
    lib.s3f_vit_block_tp_mlp_bwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr] * 4
    lib.s3f_vit_block_tp_attn_bwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr] * 4
    lib.s3f_vit_block_tp_ln_bwd.argtypes = [ptr] * 7 + [i32] * 2 + [ptr] * 2
    for fn in (lib.s3f_vit_block_tp_attn_fwd, lib.s3f_vit_block_tp_mlp_fwd,
               lib.s3f_vit_block_tp_mlp_bwd, lib.s3f_vit_block_tp_attn_bwd,
               lib.s3f_vit_block_tp_ln_bwd):
        fn.restype = ctypes.c_int
    lib.s3f_vit_block_tp_scratch_floats.argtypes = [i32] * 7
    lib.s3f_vit_block_tp_scratch_floats.restype = ctypes.c_longlong
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


@torch.library.custom_op("s3f::vit_block_fwd", mutates_args=())
def vit_block_fwd(x: torch.Tensor, weights: list[torch.Tensor], heads: int,
                  cdt: torch.dtype) -> torch.Tensor:
    """The forward as a torch op: ``weights`` in WNAMES order. On a CUDA tensor
    it launches the kernel (counted in ``fused_vit_block.launches``), on a
    CPU tensor it runs ``vit_block_reference``."""
    return _forward(x, dict(zip(WNAMES, weights)), heads, cdt)


@vit_block_fwd.register_fake
def _(x, weights, heads, cdt):
    _check_args(x, dict(zip(WNAMES, weights)), heads, cdt)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


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
    the backward is the recompute backward ``fused_vit_block_bwd``; when it
    records nothing, the call is the op ``torch.ops.s3f.vit_block_fwd``.
    """
    cdt = cdt or x.dtype
    if records_grad(x, weights):
        return _RecomputeBlock.apply(x, heads, cdt, *(weights[k] for k in WNAMES))
    return vit_block_fwd(x, [weights[k] for k in WNAMES], heads, cdt)


def fused_vit_block_train(x: torch.Tensor, weights: dict, heads: int,
                          cdt: torch.dtype | None = None) -> torch.Tensor:
    """The training block: fused_vit_block_train_fwd, with fused_vit_block_train_bwd
    as its backward under autograd. Returns [B, N, D] in x.dtype."""
    return _TrainBlock.apply(x, heads, cdt or x.dtype, *(weights[k] for k in WNAMES))


# ---------------------------------------------------------------------------
# Tensor-parallel halves (parallel/tp.py): the training chains cut at their
# two reductions. A model rank holds ``heads`` of the heads (the rows of q, k
# and v of those heads in wqkv / bqkv, the matching input columns of wproj)
# and F of fc1's outputs (w1 / b1's rows, w2's columns); the LayerNorms,
# bproj and b2 are whole. The halves return f32 partial sums without bias or
# residual; the caller sums them over the model ranks and adds those.
# ---------------------------------------------------------------------------

TP_ATTN = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj")
TP_MLP = ("ln2_s", "ln2_b", "w1", "b1", "w2")
TP_ATTN_RES = ("qkv", "o", "probs")


def _ln_hat(x: torch.Tensor):
    """(xhat, rstd) of the LayerNorm of x over its last dim."""
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    return xc * rstd, rstd


def _dot(a, wt, cdt):
    return torch.matmul(_operand(a, cdt), _operand(wt, cdt).transpose(-1, -2))


def _flat(t):
    """t as [rows, last] (explicit: a rank with no heads has a last dim of 0)."""
    return t.reshape(t.numel() // t.shape[-1] if t.shape[-1] else t.shape[:-1].numel(),
                     t.shape[-1])


def _tdot(a, c, cdt):
    return torch.matmul(_flat(_operand(a, cdt)).T, _flat(_operand(c, cdt)))


def _rows(t):
    return _flat(t).sum(0)


def vit_block_tp_attn_fwd_reference(x: torch.Tensor, weights: dict, heads: int, head_dim: int,
                                    cdt: torch.dtype | None = None):
    """Plain attention half: (partial [B, N, D] f32 = o Wproj^T over this rank's
    heads, residuals {qkv, o, probs}). A rank with no heads gives zeros."""
    cdt = cdt or x.dtype
    b, n, _ = x.shape
    w = {k: weights[k].float() for k in TP_ATTN}
    dl = heads * head_dim
    qkv = _dot(_ln_parts(x.float(), w["ln1_s"], w["ln1_b"])[0], w["wqkv"], cdt) + w["bqkv"]
    q, k, v = qkv.reshape(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    s = torch.matmul(_operand(q, cdt), _operand(k, cdt).transpose(-1, -2)) * head_dim ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    o = torch.matmul(_operand(p, cdt), _operand(v, cdt)).transpose(1, 2).reshape(b, n, dl)
    return _dot(o, w["wproj"], cdt), dict(qkv=qkv, o=o, probs=p)


def vit_block_tp_mlp_fwd_reference(h1: torch.Tensor, weights: dict,
                                   cdt: torch.dtype | None = None):
    """Plain MLP half: (partial [B, N, D] f32 = gelu(a1) W2^T over this rank's
    F columns, a1 [B, N, F] f32)."""
    cdt = cdt or torch.float32
    w = {k: weights[k].float() for k in TP_MLP}
    a1 = _dot(_ln_parts(h1, w["ln2_s"], w["ln2_b"])[0], w["w1"], cdt) + w["b1"]
    return _dot(_gelu_tanh(a1), w["w2"], cdt), a1


def vit_block_tp_mlp_bwd_reference(g_y: torch.Tensor, h1: torch.Tensor, a1: torch.Tensor,
                                   weights: dict, cdt: torch.dtype | None = None):
    """Plain backward of the MLP half: (partial g_z2 [B, N, D] f32, gradients of
    w1, b1, w2 and b2; b2's is the whole one, equal on every rank)."""
    cdt = cdt or torch.float32
    w = {k: weights[k].float() for k in TP_MLP}
    g_y = g_y.float()
    g_a1 = torch.matmul(_operand(g_y, cdt), _operand(w["w2"], cdt)) * _gelu_tanh_grad(a1)
    z2 = _ln_parts(h1, w["ln2_s"], w["ln2_b"])[0]
    gw = dict(w1=_tdot(g_a1, z2, cdt), b1=_rows(g_a1), w2=_tdot(g_y, _gelu_tanh(a1), cdt),
              b2=_rows(g_y))
    return torch.matmul(_operand(g_a1, cdt), _operand(w["w1"], cdt)), gw


def vit_block_tp_attn_bwd_reference(x: torch.Tensor, g_h1: torch.Tensor, residuals: dict,
                                    weights: dict, heads: int, head_dim: int,
                                    cdt: torch.dtype | None = None):
    """Plain backward of the attention half: (partial g_z1 [B, N, D] f32,
    gradients of wqkv, bqkv, wproj and bproj; bproj's is the whole one)."""
    cdt = cdt or x.dtype
    b, n, _ = x.shape
    dl = heads * head_dim
    w = {k: weights[k].float() for k in TP_ATTN}
    g_h1 = g_h1.float()
    qkv, o, p = (residuals[k].float() for k in TP_ATTN_RES)
    z1 = _ln_parts(x.float(), w["ln1_s"], w["ln1_b"])[0]
    g_o = torch.matmul(_operand(g_h1, cdt), _operand(w["wproj"], cdt))
    gw = dict(wproj=_tdot(g_h1, o, cdt), bproj=_rows(g_h1))
    q, k, v = qkv.reshape(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    g_oh = g_o.reshape(b, n, heads, head_dim).transpose(1, 2)
    op = functools.partial(_operand, cdt=cdt)
    g_p = torch.matmul(op(g_oh), op(v).transpose(-1, -2))
    g_v = torch.matmul(op(p).transpose(-1, -2), op(g_oh))
    g_s = p * (g_p - (g_p * p).sum(-1, keepdim=True)) * head_dim ** -0.5
    g_q = torch.matmul(op(g_s), op(k))
    g_k = torch.matmul(op(g_s).transpose(-1, -2), op(q))
    g_qkv = torch.stack([g_q, g_k, g_v]).permute(1, 3, 0, 2, 4).reshape(b, n, 3 * dl)
    gw.update(wqkv=_tdot(g_qkv, z1, cdt), bqkv=_rows(g_qkv))
    return torch.matmul(op(g_qkv), op(w["wqkv"])), gw


def vit_block_tp_ln_bwd_reference(g_z: torch.Tensor, x: torch.Tensor, ln_s: torch.Tensor,
                                  res: torch.Tensor):
    """Plain LayerNorm backward once a partial is summed: (res + LN'(g_z) f32,
    {"s", "b"}: the LayerNorm's scale and bias gradients)."""
    xh, rstd = _ln_hat(x.float())
    g_z = g_z.float()
    return (res.float() + _ln_bwd(g_z, xh, rstd, ln_s.float()),
            {"s": _rows(g_z * xh), "b": _rows(g_z)})


def _tp_check(name: str, x: torch.Tensor, shapes: dict, weights: dict) -> None:
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"{name}: activations must be float32 [B, N, D], got {x.dtype} "
                         f"{tuple(x.shape)}")
    for k, shape in shapes.items():
        t = weights[k]
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: weight {k} must be float32 {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _tp_gate(name: str, n: int, heads: int, head_dim: int) -> None:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name} kernel: sequence length {n} outside 1..{MAX_N}")
    if heads < 1:
        raise ValueError(f"{name} kernel: a model rank needs at least one head on the card "
                         "(take a model degree no larger than the heads)")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name} kernel: head_dim {head_dim} not in {HEAD_DIMS}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return _aligned(t.float().contiguous())


def _tp_scratch(which: int, b: int, n: int, d: int, heads: int, width: int, cdt, device):
    floats = _lib().s3f_vit_block_tp_scratch_floats(which, b, n, d, heads, width,
                                                    int(cdt == torch.bfloat16))
    return torch.empty(floats, device=device, dtype=torch.float32)


def vit_block_tp_attn_fwd(x: torch.Tensor, weights: dict, heads: int, head_dim: int,
                          cdt: torch.dtype | None = None):
    """Attention half of a tensor-parallel block: (partial f32 [B, N, D],
    residuals {qkv, o, probs}); ``heads`` of ``head_dim`` on this rank."""
    cdt = cdt or x.dtype
    if _device_of(x, "vit_block_tp_attn_fwd") == "cpu":
        return vit_block_tp_attn_fwd_reference(x, weights, heads, head_dim, cdt)
    b, n, d = x.shape
    dl = heads * head_dim
    _tp_gate("vit_block_tp_attn_fwd", n, heads, head_dim)
    x = _f32(x)
    _tp_check("vit_block_tp_attn_fwd", x, dict(ln1_s=(d,), ln1_b=(d,), wqkv=(3 * dl, d),
                                              bqkv=(3 * dl,), wproj=(d, dl)), weights)
    ws = [_f32(weights[k]) for k in TP_ATTN]
    out = torch.empty(b, n, d, device=x.device, dtype=torch.float32)
    res = dict(qkv=x.new_empty(b, n, 3 * dl), o=x.new_empty(b, n, dl),
               probs=x.new_empty(b, heads, n, n))
    scratch = _tp_scratch(0, b, n, d, heads, dl, cdt, x.device)
    _launch("vit_block_tp_attn_fwd", x, _lib().s3f_vit_block_tp_attn_fwd, x.data_ptr(),
            out.data_ptr(), _flags(x, cdt)[1], b, n, d, heads, head_dim, _pointers(ws),
            res["qkv"].data_ptr(), res["o"].data_ptr(), res["probs"].data_ptr(),
            scratch.data_ptr())
    vit_block_tp_attn_fwd.launches += 1
    return out, res


def vit_block_tp_mlp_fwd(h1: torch.Tensor, weights: dict, cdt: torch.dtype | None = None):
    """MLP half of a tensor-parallel block: (partial f32 [B, N, D], a1 f32
    [B, N, F]); h1 f32, F = this rank's fc1 outputs."""
    cdt = cdt or torch.float32
    if _device_of(h1, "vit_block_tp_mlp_fwd") == "cpu":
        return vit_block_tp_mlp_fwd_reference(h1, weights, cdt)
    b, n, d = h1.shape
    f = weights["w1"].shape[0]
    h1 = _f32(h1)
    _tp_check("vit_block_tp_mlp_fwd", h1, dict(ln2_s=(d,), ln2_b=(d,), w1=(f, d), b1=(f,),
                                               w2=(d, f)), weights)
    ws = [_f32(weights[k]) for k in TP_MLP]
    out = torch.empty(b, n, d, device=h1.device, dtype=torch.float32)
    a1 = h1.new_empty(b, n, f)
    scratch = _tp_scratch(1, b, n, d, 0, f, cdt, h1.device)
    _launch("vit_block_tp_mlp_fwd", h1, _lib().s3f_vit_block_tp_mlp_fwd, h1.data_ptr(),
            out.data_ptr(), _flags(h1, cdt)[1], b, n, d, f, _pointers(ws), a1.data_ptr(),
            scratch.data_ptr())
    vit_block_tp_mlp_fwd.launches += 1
    return out, a1


def vit_block_tp_mlp_bwd(g_y: torch.Tensor, h1: torch.Tensor, a1: torch.Tensor, weights: dict,
                         cdt: torch.dtype | None = None):
    """Backward of the MLP half: (partial g_z2 f32 [B, N, D], f32 gradients of
    w1, b1, w2, b2)."""
    cdt = cdt or torch.float32
    if _device_of(h1, "vit_block_tp_mlp_bwd") == "cpu":
        return vit_block_tp_mlp_bwd_reference(g_y, h1, a1, weights, cdt)
    b, n, d = h1.shape
    f = weights["w1"].shape[0]
    g_y, h1, a1 = _f32(g_y), _f32(h1), _f32(a1)
    _tp_check("vit_block_tp_mlp_bwd", h1, dict(ln2_s=(d,), ln2_b=(d,), w1=(f, d), w2=(d, f)),
              weights)
    if g_y.shape != h1.shape or a1.shape != (b, n, f):
        raise ValueError(f"vit_block_tp_mlp_bwd: g {tuple(g_y.shape)} and a1 {tuple(a1.shape)} "
                         f"do not match h1 {tuple(h1.shape)} and F={f}")
    ws = [_f32(weights[k]) for k in ("ln2_s", "ln2_b", "w1", "w2")]
    g_z2 = torch.empty_like(h1)
    flat = h1.new_empty(2 * f * d + f + d)
    grads = dict(zip(("w1", "w2", "b1", "b2"), flat.split([f * d, d * f, f, d])))
    grads["w1"], grads["w2"] = grads["w1"].view(f, d), grads["w2"].view(d, f)
    scratch = _tp_scratch(2, b, n, d, 0, f, cdt, h1.device)
    _launch("vit_block_tp_mlp_bwd", h1, _lib().s3f_vit_block_tp_mlp_bwd, g_y.data_ptr(),
            h1.data_ptr(), a1.data_ptr(), g_z2.data_ptr(), _flags(h1, cdt)[1], b, n, d, f,
            _pointers(ws), _pointers(grads[k] for k in ("w1", "b1", "w2", "b2")),
            scratch.data_ptr())
    vit_block_tp_mlp_bwd.launches += 1
    return g_z2, grads


def vit_block_tp_attn_bwd(x: torch.Tensor, g_h1: torch.Tensor, residuals: dict, weights: dict,
                          heads: int, head_dim: int, cdt: torch.dtype | None = None):
    """Backward of the attention half: (partial g_z1 f32 [B, N, D], f32
    gradients of wqkv, bqkv, wproj, bproj)."""
    cdt = cdt or x.dtype
    if _device_of(x, "vit_block_tp_attn_bwd") == "cpu":
        return vit_block_tp_attn_bwd_reference(x, g_h1, residuals, weights, heads, head_dim, cdt)
    b, n, d = x.shape
    dl = heads * head_dim
    _tp_gate("vit_block_tp_attn_bwd", n, heads, head_dim)
    x, g_h1 = _f32(x), _f32(g_h1)
    _tp_check("vit_block_tp_attn_bwd", x, dict(ln1_s=(d,), ln1_b=(d,), wqkv=(3 * dl, d),
                                              wproj=(d, dl)), weights)
    res = [_f32(residuals[k]) for k in TP_ATTN_RES]
    want = dict(qkv=(b, n, 3 * dl), o=(b, n, dl), probs=(b, heads, n, n))
    for k, t in zip(TP_ATTN_RES, res):
        if tuple(t.shape) != want[k] or t.device != x.device:
            raise ValueError(f"vit_block_tp_attn_bwd: residual {k} must be {want[k]} on {x.device}")
    ws = [_f32(weights[k]) for k in ("ln1_s", "ln1_b", "wqkv", "wproj")]
    g_z1 = torch.empty_like(x)
    sizes = [3 * dl * d, 3 * dl, d * dl, d]
    grads = dict(zip(("wqkv", "bqkv", "wproj", "bproj"), x.new_empty(sum(sizes)).split(sizes)))
    grads["wqkv"], grads["wproj"] = grads["wqkv"].view(3 * dl, d), grads["wproj"].view(d, dl)
    scratch = _tp_scratch(3, b, n, d, heads, dl, cdt, x.device)
    _launch("vit_block_tp_attn_bwd", x, _lib().s3f_vit_block_tp_attn_bwd, x.data_ptr(),
            g_h1.data_ptr(), *(t.data_ptr() for t in res), g_z1.data_ptr(),
            _flags(x, cdt)[1], b, n, d, heads, head_dim, _pointers(ws),
            _pointers(grads[k] for k in ("wqkv", "bqkv", "wproj", "bproj")), scratch.data_ptr())
    vit_block_tp_attn_bwd.launches += 1
    return g_z1, grads


def vit_block_tp_ln_bwd(g_z: torch.Tensor, x: torch.Tensor, ln_s: torch.Tensor,
                        res: torch.Tensor):
    """res + LN'(g_z) for the LayerNorm of x, f32, and the LayerNorm's weight
    gradients {"s", "b"}: the row kernel after a summed partial."""
    if _device_of(x, "vit_block_tp_ln_bwd") == "cpu":
        return vit_block_tp_ln_bwd_reference(g_z, x, ln_s, res)
    g_z, x, ln_s, res = _f32(g_z), _f32(x), _f32(ln_s), _f32(res)
    d = x.shape[-1]
    m = x.numel() // d
    if g_z.shape != x.shape or res.shape != x.shape or tuple(ln_s.shape) != (d,):
        raise ValueError(f"vit_block_tp_ln_bwd: shapes {tuple(g_z.shape)}, {tuple(x.shape)}, "
                         f"{tuple(res.shape)}, {tuple(ln_s.shape)} do not match")
    out = torch.empty_like(x)
    gs, gb = x.new_empty(2 * d).split([d, d])
    scratch = _tp_scratch(4, m, 1, d, 0, 0, torch.float32, x.device)
    _launch("vit_block_tp_ln_bwd", x, _lib().s3f_vit_block_tp_ln_bwd, g_z.data_ptr(),
            x.data_ptr(), ln_s.data_ptr(), res.data_ptr(), out.data_ptr(), gs.data_ptr(),
            gb.data_ptr(), m, d, scratch.data_ptr())
    vit_block_tp_ln_bwd.launches += 1
    return out, {"s": gs, "b": gb}


TP_HALVES = (vit_block_tp_attn_fwd, vit_block_tp_mlp_fwd, vit_block_tp_mlp_bwd,
             vit_block_tp_attn_bwd, vit_block_tp_ln_bwd)

fused_vit_block.launches = 0
fused_vit_block_bwd.launches = 0
fused_vit_block_train_fwd.launches = 0
fused_vit_block_train_bwd.launches = 0
for _half in TP_HALVES:
    _half.launches = 0
