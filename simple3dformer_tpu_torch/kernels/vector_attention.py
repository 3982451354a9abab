"""Point-Transformer vector attention, forward and backward: CUDA kernels for
Hopper and their plain versions, on two routes.

The f32 route, on pre-gathered neighbours, replaces the TPU kernels of
``simple3dformer_tpu/kernels/vector_attention.py``'s
``fused_vector_attention_pregathered``: the forward (``_fwd_kernel_pg`` :374
over ``_chain_fwd`` :80, ``pallas_call`` :473) and the backward
(``_bwd_kernel_pg`` :387, ``pallas_call`` :506). The bf16 route (the section
"The bf16 route" below) replaces ``fused_vector_attention`` (:254, :290) and
``fused_vector_attention_resid`` (:689, :722). Per query point with
K neighbours, on q [B, N, D], k, v [B, N, K, D] and rel [B, N, K, 3]:

    pos = relu(rel wd1^T + bd1) wd2^T + bd2            fc_delta
    x   = q - k + pos
    a   = softmax over K of (relu(x wg1^T + bg1) wg2^T + bg2) / sqrt(D)
    out = sum over K of a * (v + pos)                   [B, N, D]

every product of f32 operands summed in f32. The weights are in the Linear
layout [out, in] (``wd1`` [D, 3], the others [D, D], biases [D]). The
backward gives gq = sum_K g_x, gk = -g_x, gv = a g, grel and the eight weight
and bias gradients summed over all B*N*K rows (``_bwd_kernel_pg``'s math).

The kernels (``csrc/vector_attention.cu``) cannot hold the chain per tile in
shared memory as the TPU kernel holds it in VMEM: at D = 512 each weight is
1 MB in f32, a Hopper block has 227 KB. So the forward is three tiled GEMM
launches over the [B*N*K, D] rows with f32 intermediates in device memory
(fc_delta's first layer formed while the pos GEMM stages its operand, the
softmax over K and the sum over K in the epilogue of the logits GEMM), and it
writes x, u = v + pos, relu(hg) and a, which the backward reads in place of a
recompute (the TPU ``_resid`` variant's four tensors). Every GEMM, the
forward's three and the backward's six, runs on the tensor cores in 3-pass
TF32 (about 21 bits of each operand; one pass keeps about 10). The weight
gradients sum over all rows in fixed chunks of rows, one partial per chunk,
and a second pass adds the partials in chunk order: no float atomics, two
runs give the same bits. Against the plain versions on the card: the
forward's output and residuals, and the backward from those residuals
(``vector_attention_resid_backward_reference``), within 1e-4 of each
output's largest value (sums in another order). A backward through a chain
recomputed in plain PyTorch can differ by more: where an hg_pre lies within
rounding of zero, the two sums can put its ReLU on opposite sides.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernels or raise. ``vector_attention_fwd.launches`` and
``vector_attention_bwd.launches`` count calls that launched (three GEMMs a
forward; a backward is six GEMMs and their reductions).

The bf16 route takes q, k_all, v_all [B, N, D] and idx [B, N, K] and reads the
neighbours' k and v rows by index inside the kernels, under the TPU kernel's
precision policy: every product takes operands rounded to bf16 and sums in
f32 (on bf16 tensor cores); biases, ReLU, softmax, x and u are
f32; out, gq, gk_all, gv_all and grel are rounded to bf16 once; the weight and
bias gradients are f32. The
residual-saving forward keeps x, u, hg_pre and a as [B, N*K, D] bf16 and its
backward reads them (u and a rounded: gradients O(bf16 eps) from the
recompute backward's, as in the JAX package); the recompute backward runs the
forward again keeping u and a in f32. gk_all and gv_all sum in f32, in row
order, through an inverse index of idx: no float atomics, reruns bit-equal.
Against the plain versions on the card: within 2e-2 of each output's largest
value (bf16 rounding steps where f32 sums in another order cross a
boundary). Counters: ``gather_attention_fwd``, ``gather_attention_bwd``,
``gather_attention_resid_fwd``, ``gather_attention_resid_bwd``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import refuse_export

WNAMES = ("wd1", "bd1", "wd2", "bd2", "wg1", "bg1", "wg2", "bg2")
MAX_K = 128  # a GEMM row tile (128 rows) holds whole groups of K neighbours
RESIDUALS = ("x", "u", "hg", "a")
WGRAD_CHUNKS = 64  # the weight gradients' row sums split into at most this many chunks
WGRAD_STEP = 32  # rows a stage of the tensor-core GEMM core: a chunk is a multiple of it


def weight_shapes(d: int) -> dict[str, tuple]:
    """The eight weights in the Linear layout."""
    return {"wd1": (d, 3), "bd1": (d,), "wd2": (d, d), "bd2": (d,),
            "wg1": (d, d), "bg1": (d,), "wg2": (d, d), "bg2": (d,)}


def unsupported(b: int, n: int, kk: int, d: int, dtype: torch.dtype) -> str | None:
    """Why the kernels cannot take this shape and dtype, or None when they can."""
    if dtype != torch.float32:
        return f"dtype {dtype} is not float32 (the bf16 route has kernels of its own)"
    if not 1 <= kk <= MAX_K:
        return f"{kk} neighbours outside 1..{MAX_K}"
    if d < 8 or d % 8:
        return f"d_model {d} is not a positive multiple of 8"
    if b * n * kk >= 2 ** 31:
        return f"{b * n * kk} neighbour rows exceed 2**31 - 1"
    return None


def _chain(q, k, v, rel, w):
    """The forward chain in f32: (hd_pre, hd, pos, x, hg_pre, hg, a, u, out)."""
    d = q.shape[-1]
    hd_pre = F.linear(rel, w["wd1"], w["bd1"])
    hd = torch.relu(hd_pre)
    pos = F.linear(hd, w["wd2"], w["bd2"])
    x = q[:, :, None, :] - k + pos
    hg_pre = F.linear(x, w["wg1"], w["bg1"])
    hg = torch.relu(hg_pre)
    z = F.linear(hg, w["wg2"], w["bg2"]) / d ** 0.5
    e = torch.exp(z - z.amax(2, keepdim=True))
    a = e / e.sum(2, keepdim=True)
    u = v + pos
    return hd_pre, hd, pos, x, hg_pre, hg, a, u, (a * u).sum(2)


def vector_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               rel: torch.Tensor, weights: dict) -> torch.Tensor:
    """Plain version of the forward (``vector_attention_reference`` of the JAX
    module): [B, N, D], [B, N, K, D] x2, [B, N, K, 3] -> out [B, N, D] f32."""
    return _chain(q, k, v, rel, weights)[-1]


def vector_attention_resid_reference(q, k, v, rel, weights):
    """Plain version of the forward that keeps its residuals
    (``vector_attention_fwd(..., save=True)`` on the card): (out, {"x", "u",
    "hg" (relu(hg_pre)), "a"}, each [B*N*K, D] f32)."""
    _, _, _, x, _, hg, a, u, out = _chain(q, k, v, rel, weights)
    d = q.shape[-1]
    return out, {name: t.reshape(-1, d) for name, t in (("x", x), ("u", u), ("hg", hg), ("a", a))}


def _rows_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over every row of a[row, o] b[row, i] -> [O, I] (a weight gradient)."""
    return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])


def _backward(rel, w, hd_pre, x, hg, a, u, g, need_rel_grad):
    """``_bwd_kernel_pg``'s steps in order from the forward's x, hg = relu(hg_pre),
    a and u: (gq, gk, gv, grel or None, {name: grad})."""
    d = g.shape[-1]
    hd = torch.relu(hd_pre)
    g3 = g.float()[:, :, None, :]
    g_a = g3 * u
    g_u = a * g3
    g_z = a * (g_a - (a * g_a).sum(2, keepdim=True))
    g_logits = g_z * (1.0 / d ** 0.5)
    g_hg = (g_logits @ w["wg2"]) * (hg > 0)
    gw = {"wg2": _rows_t(g_logits, hg), "bg2": g_logits.sum((0, 1, 2))}
    g_x = g_hg @ w["wg1"]
    gw.update(wg1=_rows_t(g_hg, x), bg1=g_hg.sum((0, 1, 2)))
    g_pos = g_x + g_u
    g_hd = (g_pos @ w["wd2"]) * (hd_pre > 0)
    gw.update(wd2=_rows_t(g_pos, hd), bd2=g_pos.sum((0, 1, 2)))
    grel = g_hd @ w["wd1"] if need_rel_grad else None
    gw.update(wd1=_rows_t(g_hd, rel), bd1=g_hd.sum((0, 1, 2)))
    return g_x.sum(2), -g_x, g_u, grel, {name: gw[name] for name in WNAMES}


def vector_attention_backward_reference(q, k, v, rel, weights, g, need_rel_grad=True):
    """Plain version of the backward, ``_bwd_kernel_pg``'s steps in order on a
    recomputed chain: (gq, gk, gv, grel or None, {name: grad})."""
    hd_pre, _, _, x, _, hg, a, u, _ = _chain(q, k, v, rel, weights)
    return _backward(rel, weights, hd_pre, x, hg, a, u, g, need_rel_grad)


def vector_attention_resid_backward_reference(rel, weights, residuals, g, need_rel_grad=True):
    """Plain version of the kernel's backward (``vector_attention_bwd`` on the
    card): the same steps from the forward's kept x, u, relu(hg) and a ([B*N*K,
    D] each), fc_delta's hidden layer recomputed. Each ReLU of hg then takes
    the kernel forward's side of zero, which a recomputed chain, summed in
    another order, can leave for an hg_pre within rounding of it."""
    b, n, kk, _ = rel.shape
    d = g.shape[-1]
    x, u, hg, a = (residuals[name].reshape(b, n, kk, d) for name in RESIDUALS)
    hd_pre = F.linear(rel, weights["wd1"], weights["bd1"])
    return _backward(rel, weights, hd_pre, x, hg, a, u, g, need_rel_grad)


@functools.cache
def _lib():
    from .build import load

    lib = load("vector_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.s3f_va_fwd.argtypes = [ptr] * 10 + [i32] * 3 + [ptr]
    lib.s3f_va_fwd.restype = i32
    lib.s3f_va_bwd.argtypes = [ptr] * 15 + [i32] * 4 + [ptr]
    lib.s3f_va_bwd.restype = i32
    lib.s3f_vag_fwd.argtypes = [ptr] * 13 + [i32] * 4 + [ptr]
    lib.s3f_vag_fwd.restype = i32
    lib.s3f_vag_bwd.argtypes = [ptr] * 22 + [i32] * 5 + [ptr]
    lib.s3f_vag_bwd.restype = i32
    lib.s3f_vag_bwd_res.argtypes = [ptr] * 19 + [i32] * 5 + [ptr]
    lib.s3f_vag_bwd_res.restype = i32
    return lib


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"vector attention kernel: {name} is {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} (contiguous {t.is_contiguous()}, address "
                         f"{t.data_ptr():#x}), not contiguous {tuple(shape)} "
                         f"{str(dtype).removeprefix('torch.')} on {device} at a 16-byte boundary")


def _shapes(q: torch.Tensor, k: torch.Tensor) -> tuple[int, int, int, int]:
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"vector attention takes q [B, N, D] and k [B, N, K, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, n, kk, d = k.shape
    why = unsupported(b, n, kk, d, q.dtype)
    if why:
        raise ValueError(f"vector attention kernel: {why}")
    return b, n, kk, d


def _check_weights(weights: dict, d: int, device: torch.device) -> list[torch.Tensor]:
    for name, shape in weight_shapes(d).items():
        _check(name, weights[name], shape, device)
    return [weights[name] for name in WNAMES]


def wgrad_chunk(rows: int) -> int:
    """Rows per chunk of the weight gradients' sums: a multiple of WGRAD_STEP
    (no stage of the GEMM core straddles two chunks), at least 256, at most
    WGRAD_CHUNKS chunks. A function of the row count alone, so a rerun sums in
    the same order."""
    per_chunk = -(-rows // WGRAD_CHUNKS)
    return max(256, -(-per_chunk // WGRAD_STEP) * WGRAD_STEP)


def vector_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel: torch.Tensor,
                         weights: dict, save: bool = False):
    """(out [B, N, D] f32, residuals for ``vector_attention_bwd`` or None).

    With ``save`` the residuals are, on the card, the kernel's x, u, relu(hg)
    and a ([B*N*K, D] f32 each); on the CPU, q, k and v themselves (its plain
    backward recomputes the chain)."""
    refuse_export("vector_attention_fwd")
    if q.device.type == "cpu":
        return vector_attention_reference(q, k, v, rel, weights), (
            {"q": q, "k": k, "v": v} if save else None)
    if q.device.type != "cuda":
        raise ValueError(f"vector attention runs on cpu or cuda, not {q.device}")
    b, n, kk, d = _shapes(q, k)
    dev = q.device
    for name, t, shape in (("q", q, (b, n, d)), ("k", k, (b, n, kk, d)), ("v", v, (b, n, kk, d)),
                           ("rel", rel, (b, n, kk, 3))):
        _check(name, t, shape, dev)
    ws = _check_weights(weights, d, dev)
    rows = b * n * kk
    res = {name: torch.empty(rows, d, device=dev) for name in RESIDUALS[:3]}
    res["a"] = torch.empty(rows, d, device=dev) if save else None
    out = torch.empty(b, n, d, device=dev)
    a_ptr = res["a"].data_ptr() if save else None
    with torch.cuda.device(dev):
        err = _lib().s3f_va_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(),
                                _pointers(ws), res["x"].data_ptr(), res["u"].data_ptr(),
                                res["hg"].data_ptr(), a_ptr, out.data_ptr(), b * n, kk, d,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"vector attention forward kernel launch failed: CUDA error {err}")
    vector_attention_fwd.launches += 1
    return out, (res if save else None)


def vector_attention_bwd(g: torch.Tensor, rel: torch.Tensor, weights: dict, residuals: dict,
                         need_rel_grad: bool = True):
    """(gq [B, N, D], gk and gv [B, N, K, D], grel [B, N, K, 3] or None, {name:
    weight grad}), all f32, from what ``vector_attention_fwd(..., save=True)``
    returned for the same inputs."""
    if g.device.type == "cpu":
        return vector_attention_backward_reference(residuals["q"], residuals["k"],
                                                   residuals["v"], rel, weights, g,
                                                   need_rel_grad)
    if g.device.type != "cuda":
        raise ValueError(f"vector attention runs on cpu or cuda, not {g.device}")
    b, n, kk, _ = rel.shape
    d = g.shape[-1]
    why = unsupported(b, n, kk, d, torch.float32)
    if why:
        raise ValueError(f"vector attention kernel: {why}")
    dev = g.device
    g = g.float().contiguous()
    _check("g", g, (b, n, d), dev)
    _check("rel", rel, (b, n, kk, 3), dev)
    ws = _check_weights(weights, d, dev)
    rows = b * n * kk
    for name in RESIDUALS:
        if residuals.get(name) is None:
            raise ValueError(f"vector attention backward: residual {name!r} missing (run the "
                             "forward with save=True)")
        _check(name, residuals[name], (rows, d), dev)
    gq = torch.empty(b, n, d, device=dev)
    gk = torch.empty(b, n, kk, d, device=dev)
    gv = torch.empty(b, n, kk, d, device=dev)
    grel = torch.empty(b, n, kk, 3, device=dev) if need_rel_grad else None
    gw = {name: torch.empty(shape, device=dev) for name, shape in weight_shapes(d).items()}
    chunk = wgrad_chunk(rows)
    scratch = [torch.empty(rows, d, device=dev) for _ in range(2)]
    partials = torch.empty(max(-(-rows // chunk) * (d * d + d), -(-rows // (chunk // 8)) * d * 4),
                           device=dev)
    with torch.cuda.device(dev):
        err = _lib().s3f_va_bwd(
            rel.data_ptr(), _pointers(ws), residuals["x"].data_ptr(), residuals["u"].data_ptr(),
            residuals["hg"].data_ptr(), residuals["a"].data_ptr(), g.data_ptr(), gq.data_ptr(),
            gk.data_ptr(), gv.data_ptr(), grel.data_ptr() if need_rel_grad else None,
            _pointers([gw[name] for name in WNAMES]), scratch[0].data_ptr(),
            scratch[1].data_ptr(), partials.data_ptr(), b * n, kk, d, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"vector attention backward kernel launch failed: CUDA error {err}")
    vector_attention_bwd.launches += 1
    return gq, gk, gv, grel, gw


vector_attention_fwd.launches = 0
vector_attention_bwd.launches = 0


class _VectorAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel, *ws):
        out, res = vector_attention_fwd(q, k, v, rel, dict(zip(WNAMES, ws)), save=True)
        ctx.names = tuple(res)
        ctx.save_for_backward(rel, *ws, *res.values())
        return out

    @staticmethod
    def backward(ctx, g):
        rel, *rest = ctx.saved_tensors
        ws, res = rest[:len(WNAMES)], rest[len(WNAMES):]
        gq, gk, gv, grel, gw = vector_attention_bwd(
            g, rel, dict(zip(WNAMES, ws)), dict(zip(ctx.names, res)), ctx.needs_input_grad[3])
        return (gq, gk, gv, grel, *[gw[name] for name in WNAMES])


def vector_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel: torch.Tensor,
                     weights: dict) -> torch.Tensor:
    """The chain on [B, N, D] q, [B, N, K, D] k and v, [B, N, K, 3] rel -> [B, N, D],
    with its backward under autograd; the forward alone, keeping nothing, when
    nothing records a gradient."""
    ws = [weights[name] for name in WNAMES]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rel, *ws)):
        return _VectorAttention.apply(q, k, v, rel, *ws)
    return vector_attention_fwd(q, k, v, rel, weights)[0]


# ---------------------------------------------------------------------------
# The bf16 route: the chain on q, k_all, v_all [B, N, D] and the neighbour
# indices idx [B, N, K], k and v rows read by index inside the kernels
# (``fused_vector_attention`` and ``fused_vector_attention_resid``).
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
MATRICES = ("wd1", "wd2", "wg1", "wg2")
BIASES = ("bd1", "bd2", "bg1", "bg2")


def gather_unsupported(b: int, n: int, kk: int, d: int, dtype: torch.dtype) -> str | None:
    """Why the bf16 kernels cannot take this shape and dtype, or None when they can."""
    if dtype != BF16:
        return f"dtype {dtype} is not bfloat16 (the f32 route runs the pre-gathered kernels)"
    return unsupported(b, n, kk, d, torch.float32)


def _r(t: torch.Tensor) -> torch.Tensor:
    """A product's operand: rounded to bf16, computed in f32."""
    return t.to(BF16).float()


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., I] times the Linear weight w [O, I]: bf16 operands, f32 sums
    (a bf16 F.linear would round its output as well)."""
    return F.linear(_r(a), _r(w))


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, D], [B, N, K] -> [B, N, K, D] f32; an index outside [0, N) reads a
    zero row, as the TPU kernel's one-hot product does."""
    n = t.shape[1]
    inside = (idx >= 0) & (idx < n)
    rows = torch.arange(t.shape[0], device=t.device)[:, None, None]
    return t[rows, idx.long().clamp(0, n - 1)].float() * inside[..., None]


def _scatter_rows(rows: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """[B, N, K, D] -> [B, n, D]: each point the f32 sum of the rows naming it."""
    b, d = rows.shape[0], rows.shape[-1]
    inside = (idx >= 0) & (idx < n)
    target = (torch.arange(b, device=idx.device)[:, None, None] * n
              + idx.long().clamp(0, n - 1)).reshape(-1)
    out = torch.zeros(b * n, d, device=rows.device)
    out.index_add_(0, target, (rows * inside[..., None]).reshape(-1, d))
    return out.reshape(b, n, d)


def _chain_bf16(q, k_all, v_all, idx, rel, w, state=None):
    """The forward chain under the TPU kernel's bf16 policy: (hd_pre, x, hg_pre,
    a, u, out), all f32 but out (bf16). With ``state`` (a residual-saving
    forward's saves), x and hg_pre are its bf16 values and the chain goes on
    from them."""
    b, n, kk = idx.shape
    d = q.shape[-1]
    hd_pre = _mm(rel, w["wd1"]) + w["bd1"]
    pos = _mm(torch.relu(hd_pre), w["wd2"]) + w["bd2"]
    if state is None:
        x = q.float()[:, :, None, :] - _gather_rows(k_all, idx) + pos
        hg_pre = _mm(x, w["wg1"]) + w["bg1"]
    else:
        x, hg_pre = (state[name].float().reshape(b, n, kk, d) for name in ("x", "hg"))
    z = (_mm(torch.relu(hg_pre), w["wg2"]) + w["bg2"]) * (1.0 / d ** 0.5)
    e = torch.exp(z - z.amax(2, keepdim=True))
    a = e / e.sum(2, keepdim=True)
    u = _gather_rows(v_all, idx) + pos
    return hd_pre, x, hg_pre, a, u, (a * u).sum(2).to(BF16)


def gather_attention_reference(q, k_all, v_all, idx, rel, weights) -> torch.Tensor:
    """Plain version of the bf16 forward (``_fwd_kernel``): q, k_all, v_all [B,
    N, D] bf16, idx [B, N, K], rel [B, N, K, 3] bf16, f32 weights -> out [B, N, D] bf16."""
    return _chain_bf16(q, k_all, v_all, idx, rel, weights)[-1]


def gather_attention_resid_reference(q, k_all, v_all, idx, rel, weights):
    """Plain version of the residual-saving forward (``_fwd_kernel_res``): (out,
    the saves {"x", "u", "hg" (hg_pre), "a"}, each [B, N*K, D] bf16)."""
    _, x, hg_pre, a, u, out = _chain_bf16(q, k_all, v_all, idx, rel, weights)
    b, n, kk, d = x.shape
    return out, {name: t.reshape(b, n * kk, d).to(BF16)
                 for name, t in (("x", x), ("u", u), ("hg", hg_pre), ("a", a))}


def _gather_backward(hd_pre, x, hg_pre, a, u, idx, rel, w, g, need_rel_grad):
    """``_bwd_kernel``'s steps in order: (gq, gk_all, gv_all [B, N, D] bf16, grel
    bf16 or None, {name: f32 gradient})."""
    n, d = g.shape[1], g.shape[-1]
    g3 = g.float()[:, :, None, :]
    g_a = g3 * u
    g_u = a * g3
    g_z = a * (g_a - (a * g_a).sum(2, keepdim=True))
    g_logits = g_z * (1.0 / d ** 0.5)
    g_hg = (_r(g_logits) @ _r(w["wg2"])) * (hg_pre > 0)
    gw = {"wg2": _rows_t(_r(g_logits), _r(torch.relu(hg_pre))), "bg2": g_logits.sum((0, 1, 2))}
    g_x = _r(g_hg) @ _r(w["wg1"])
    gw.update(wg1=_rows_t(_r(g_hg), _r(x)), bg1=g_hg.sum((0, 1, 2)))
    g_pos = g_x + g_u
    g_hd = (_r(g_pos) @ _r(w["wd2"])) * (hd_pre > 0)
    gw.update(wd2=_rows_t(_r(g_pos), _r(torch.relu(hd_pre))), bd2=g_pos.sum((0, 1, 2)))
    grel = (_r(g_hd) @ _r(w["wd1"])).to(BF16) if need_rel_grad else None
    gw.update(wd1=_rows_t(_r(g_hd), _r(rel)), bd1=g_hd.sum((0, 1, 2)))
    return (g_x.sum(2).to(BF16), _scatter_rows(_r(-g_x), idx, n).to(BF16),
            _scatter_rows(_r(g_u), idx, n).to(BF16), grel, {name: gw[name] for name in WNAMES})


def gather_attention_backward_reference(q, k_all, v_all, idx, rel, weights, g,
                                        need_rel_grad=True, state=None):
    """Plain version of the recompute backward (``_bwd_kernel``): u and a in f32.
    With ``state``, the saves of ``gather_attention_resid_fwd`` on the same
    inputs, x and hg_pre are the kernel forward's bf16 values (the recompute
    backward's own forward computes them bit for bit), so each ReLU of hg_pre
    takes the kernel's side of zero, which a chain summed in another order can
    leave where a bf16 rounding of x or hg_pre falls the other way."""
    hd_pre, x, hg_pre, a, u, _ = _chain_bf16(q, k_all, v_all, idx, rel, weights, state)
    return _gather_backward(hd_pre, x, hg_pre, a, u, idx, rel, weights, g, need_rel_grad)


def gather_attention_resid_backward_reference(idx, rel, weights, saves, g, need_rel_grad=True):
    """Plain version of the backward from the saves (``_bwd_kernel_res``): only
    fc_delta's hidden layer is recomputed; u and a are their bf16 saves."""
    b, n, kk = idx.shape
    d = g.shape[-1]
    x, u, hg_pre, a = (saves[name].float().reshape(b, n, kk, d) for name in RESIDUALS)
    hd_pre = _mm(rel, weights["wd1"]) + weights["bd1"]
    return _gather_backward(hd_pre, x, hg_pre, a, u, idx, rel, weights, g, need_rel_grad)


def _gather_args(q, k_all, v_all, idx, rel, weights):
    """Checks the bf16 kernels' inputs; (b, n, kk, d, bf16 matrices, f32 biases)."""
    if q.device.type != "cuda":
        raise ValueError(f"vector attention runs on cpu or cuda, not {q.device}")
    if q.ndim != 3 or idx.ndim != 3:
        raise ValueError(f"vector attention takes q [B, N, D] and idx [B, N, K], got "
                         f"{tuple(q.shape)} and {tuple(idx.shape)}")
    b, n, kk = idx.shape
    d = q.shape[-1]
    why = gather_unsupported(b, n, kk, d, q.dtype)
    if why:
        raise ValueError(f"vector attention kernel: {why}")
    dev = q.device
    for name, t in (("q", q), ("k_all", k_all), ("v_all", v_all)):
        if t is not None:
            _check(name, t, (b, n, d), dev, BF16)
    _check("idx", idx, (b, n, kk), dev, torch.int32)
    _check("rel", rel, (b, n, kk, 3), dev, BF16)
    _check_weights(weights, d, dev)
    return (b, n, kk, d, [weights[name].to(BF16).contiguous() for name in MATRICES],
            [weights[name] for name in BIASES])


def _grad_outputs(b, n, kk, d, dev, need_rel_grad):
    """gq, gk_all, gv_all, grel and the weight gradients, and the backward's scratch."""
    rows = b * n * kk
    chunk = wgrad_chunk(rows)
    out = dict(gq=torch.empty(b, n, d, device=dev, dtype=BF16),
               gk=torch.empty(b, n, d, device=dev, dtype=BF16),
               gv=torch.empty(b, n, d, device=dev, dtype=BF16),
               grel=torch.empty(b, n, kk, 3, device=dev, dtype=BF16) if need_rel_grad else None,
               gw={name: torch.empty(shape, device=dev)
                   for name, shape in weight_shapes(d).items()})
    scratch = dict(s1=torch.empty(rows, d, device=dev), s2=torch.empty(rows, d, device=dev),
                   gkr=torch.empty(rows, d, device=dev, dtype=BF16),
                   partial=torch.empty(max(-(-rows // chunk) * (d * d + d),
                                           -(-rows // (chunk // 8)) * d * 4), device=dev),
                   ints=torch.empty(b * (2 * n + 1) + rows, device=dev, dtype=torch.int32))
    return out, scratch, chunk


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _run_forward(q, k_all, v_all, idx, rel, weights, save):
    b, n, kk, d, wh, bias = _gather_args(q, k_all, v_all, idx, rel, weights)
    dev, rows = q.device, b * n * kk
    saves = {name: torch.empty(b, n * kk, d, device=dev, dtype=BF16)
             for name in (RESIDUALS if save else ("x", "hg"))}
    u32 = torch.empty(rows, d, device=dev)
    out = torch.empty(b, n, d, device=dev, dtype=BF16)
    with torch.cuda.device(dev):
        err = _lib().s3f_vag_fwd(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), idx.data_ptr(), rel.data_ptr(),
            _pointers(wh), _pointers(bias), saves["x"].data_ptr(), saves["hg"].data_ptr(),
            u32.data_ptr(), _ptr(saves.get("u")), _ptr(saves.get("a")), out.data_ptr(), b * n, n,
            kk, d, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"vector attention bf16 forward kernel launch failed: CUDA error {err}")
    return out, (saves if save else None)


def gather_attention_fwd(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                         idx: torch.Tensor, rel: torch.Tensor, weights: dict) -> torch.Tensor:
    """The bf16 forward (``fused_vector_attention``, pallas_call :254): out [B, N,
    D] bf16, keeping nothing."""
    refuse_export("gather_attention_fwd")
    if q.device.type == "cpu":
        return gather_attention_reference(q, k_all, v_all, idx, rel, weights)
    out, _ = _run_forward(q, k_all, v_all, idx, rel, weights, save=False)
    gather_attention_fwd.launches += 1
    return out


def gather_attention_resid_fwd(q, k_all, v_all, idx, rel, weights):
    """The residual-saving forward (``_fused_fwd_res``, pallas_call :689): (out,
    the saves {"x", "u", "hg", "a"} [B, N*K, D] bf16)."""
    refuse_export("gather_attention_resid_fwd")
    if q.device.type == "cpu":
        return gather_attention_resid_reference(q, k_all, v_all, idx, rel, weights)
    out, saves = _run_forward(q, k_all, v_all, idx, rel, weights, save=True)
    gather_attention_resid_fwd.launches += 1
    return out, saves


def gather_attention_bwd(q, k_all, v_all, idx, rel, weights, g, need_rel_grad=True):
    """The recompute backward (``_fused_bwd``, pallas_call :290): (gq, gk_all,
    gv_all [B, N, D] bf16, grel [B, N, K, 3] bf16 or None, {name: f32 gradient})."""
    if q.device.type == "cpu":
        return gather_attention_backward_reference(q, k_all, v_all, idx, rel, weights, g,
                                                   need_rel_grad)
    b, n, kk, d, wh, bias = _gather_args(q, k_all, v_all, idx, rel, weights)
    dev, rows = q.device, b * n * kk
    g = g.to(BF16).contiguous()
    _check("g", g, (b, n, d), dev, BF16)
    out, scratch, chunk = _grad_outputs(b, n, kk, d, dev, need_rel_grad)
    fwd = [torch.empty(rows, d, device=dev, dtype=BF16) for _ in range(2)]
    fwd += [torch.empty(rows, d, device=dev) for _ in range(2)]
    with torch.cuda.device(dev):
        err = _lib().s3f_vag_bwd(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), idx.data_ptr(), rel.data_ptr(),
            _pointers(wh), _pointers(bias), g.data_ptr(), out["gq"].data_ptr(),
            out["gk"].data_ptr(), out["gv"].data_ptr(), _ptr(out["grel"]),
            _pointers([out["gw"][name] for name in WNAMES]), *[t.data_ptr() for t in fwd],
            *[scratch[k].data_ptr() for k in ("s1", "s2", "gkr", "partial", "ints")], b * n, n,
            kk, d, chunk, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"vector attention bf16 backward kernel launch failed: CUDA error {err}")
    gather_attention_bwd.launches += 1
    return out["gq"], out["gk"], out["gv"], out["grel"], out["gw"]


def gather_attention_resid_bwd(idx, rel, weights, saves, g, need_rel_grad=True):
    """The backward from the saves (``_fused_bwd_res``, pallas_call :722): as
    ``gather_attention_bwd``'s, from what ``gather_attention_resid_fwd`` kept."""
    if g.device.type == "cpu":
        return gather_attention_resid_backward_reference(idx, rel, weights, saves, g,
                                                         need_rel_grad)
    g = g.to(BF16).contiguous()
    b, n, kk, d, wh, bias = _gather_args(g, None, None, idx, rel, weights)
    dev = g.device
    for name in RESIDUALS:
        _check(name, saves[name], (b, n * kk, d), dev, BF16)
    out, scratch, chunk = _grad_outputs(b, n, kk, d, dev, need_rel_grad)
    with torch.cuda.device(dev):
        err = _lib().s3f_vag_bwd_res(
            idx.data_ptr(), rel.data_ptr(), _pointers(wh), _pointers(bias),
            *[saves[name].data_ptr() for name in RESIDUALS], g.data_ptr(),
            out["gq"].data_ptr(), out["gk"].data_ptr(), out["gv"].data_ptr(), _ptr(out["grel"]),
            _pointers([out["gw"][name] for name in WNAMES]),
            *[scratch[k].data_ptr() for k in ("s1", "s2", "gkr", "partial", "ints")], b * n, n,
            kk, d, chunk, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"vector attention bf16 backward kernel launch failed: CUDA error {err}")
    gather_attention_resid_bwd.launches += 1
    return out["gq"], out["gk"], out["gv"], out["grel"], out["gw"]


gather_attention_fwd.launches = 0
gather_attention_resid_fwd.launches = 0
gather_attention_bwd.launches = 0
gather_attention_resid_bwd.launches = 0


class _GatherAttention(torch.autograd.Function):
    """The recompute pair: the forward keeps its inputs only."""

    @staticmethod
    def forward(ctx, q, k_all, v_all, idx, rel, *ws):
        ctx.save_for_backward(q, k_all, v_all, idx, rel, *ws)
        return gather_attention_fwd(q, k_all, v_all, idx, rel, dict(zip(WNAMES, ws)))

    @staticmethod
    def backward(ctx, g):
        q, k_all, v_all, idx, rel, *ws = ctx.saved_tensors
        gq, gk, gv, grel, gw = gather_attention_bwd(q, k_all, v_all, idx, rel,
                                                    dict(zip(WNAMES, ws)), g,
                                                    ctx.needs_input_grad[4])
        return (gq, gk, gv, None, grel, *[gw[name] for name in WNAMES])


class _GatherAttentionResid(torch.autograd.Function):
    """The residual-saving pair: the forward keeps x, u, hg_pre and a."""

    @staticmethod
    def forward(ctx, q, k_all, v_all, idx, rel, *ws):
        out, saves = gather_attention_resid_fwd(q, k_all, v_all, idx, rel, dict(zip(WNAMES, ws)))
        ctx.save_for_backward(idx, rel, *ws, *[saves[name] for name in RESIDUALS])
        return out

    @staticmethod
    def backward(ctx, g):
        idx, rel, *rest = ctx.saved_tensors
        ws, saves = rest[:len(WNAMES)], rest[len(WNAMES):]
        gq, gk, gv, grel, gw = gather_attention_resid_bwd(
            idx, rel, dict(zip(WNAMES, ws)), dict(zip(RESIDUALS, saves)), g,
            ctx.needs_input_grad[4])
        return (gq, gk, gv, None, grel, *[gw[name] for name in WNAMES])


def gather_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     idx: torch.Tensor, rel: torch.Tensor, weights: dict,
                     resid: bool = True) -> torch.Tensor:
    """The bf16 chain with its backward under autograd: the residual-saving pair
    (``resid``) or the recompute pair; the forward alone, keeping nothing, when
    nothing records a gradient (as the TPU ``_resid`` primal runs ``_fwd_kernel``)."""
    ws = [weights[name] for name in WNAMES]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_all, v_all, rel, *ws)):
        fn = _GatherAttentionResid if resid else _GatherAttention
        return fn.apply(q, k_all, v_all, idx, rel, *ws)
    return gather_attention_fwd(q, k_all, v_all, idx, rel, weights)


def flops(b: int, n: int, kk: int, d: int) -> int:
    """Operations of one forward counted as the chain needs them: the three
    D x D products and fc_delta's first layer, 2 per multiply-add."""
    return 2 * b * n * kk * d * (3 * d + 3)

