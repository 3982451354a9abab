"""The port's mhsa plain versions against the JAX package's Pallas kernel (in
interpret mode, as tests/test_pallas_kernels.py runs it) on the CPU, the
autograd wrapper, the attention's kernel route, the block's route choice, and
the precision of the kernels' f32 products (3-pass TF32, emulated). Inputs are
made with numpy."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import MHSA_REL, rel_err
from simple3dformer_tpu.kernels.mhsa import mhsa as jax_mhsa
from simple3dformer_tpu_torch.kernels import mhsa as mk
from simple3dformer_tpu_torch.nn.layers import Attention, Block


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, N, H, dh, dtype). N=300 and 260 pad to 384 on the TPU side (masked key
# columns); the port takes them as they are.
CASES = [(2, 300, 2, 64, "float32"), (1, 260, 1, 256, "float32"), (2, 200, 2, 64, "bfloat16")]
# error relative to the largest value of each output. f32: the same f32 math,
# sums in another order; bf16: an f32 last-bit difference can round p, ds or an
# output to the neighbouring bf16 value (2**-8 relative), as on the card.
REL = {"float32": 1e-5, "bfloat16": 3e-2}


def inputs(b, n, h, dh, dtype, seed):
    rs = np.random.RandomState(seed)
    qkv_g = [rs.randn(b, n, h, dh).astype(np.float32) for _ in range(4)]
    if dtype == "bfloat16":  # values both sides hold exactly
        qkv_g = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in qkv_g]
    return qkv_g


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,n,h,dh,dtype", CASES, ids=[f"{c[1]}x{c[3]}-{c[4]}" for c in CASES])
def test_plain_versions_match_the_pallas_kernel_and_its_grad(b, n, h, dh, dtype):
    q, k, v, g = inputs(b, n, h, dh, dtype, b * n + dh)
    scale = dh ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    want_o = jax_mhsa(jq, jk, jv, scale, 512, True)
    want_grads = jax.grad(lambda *a: jnp.sum((jax_mhsa(*a, scale, 512, True) * jg)
                                             .astype(jnp.float32)), argnums=(0, 1, 2))(jq, jk, jv)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    o = mk.mhsa_reference(tq, tk, tv, scale)
    grads = mk.mhsa_backward_reference(tq, tk, tv, tg, scale)
    assert o.dtype == tdt and all(t.dtype == tdt for t in grads)
    assert rel(o, want_o.astype(jnp.float32)) <= REL[dtype]
    for got, want in zip(grads, want_grads):
        assert rel(got, want.astype(jnp.float32)) <= REL[dtype]


def test_autograd_wrapper_runs_the_plain_backward_on_the_cpu():
    q, k, v, g = (torch.from_numpy(a) for a in inputs(2, 70, 3, 64, "float32", 1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (mk.mhsa_fwd.launches, mk.mhsa_bwd.launches)
    out = mk.mhsa(*leaves, 0.125)
    got = torch.autograd.grad(out, leaves, g)
    assert torch.equal(out, mk.mhsa_reference(q, k, v, 0.125))
    for a, b in zip(got, mk.mhsa_backward_reference(q, k, v, g, 0.125)):
        assert torch.equal(a, b)
    with torch.inference_mode():
        assert torch.equal(mk.mhsa(q, k, v, 0.125), out.detach())
    assert (mk.mhsa_fwd.launches, mk.mhsa_bwd.launches) == before  # no kernel on the CPU


def test_attention_kernel_route_matches_the_plain_attention():
    """The route the card takes (qkv views -> mhsa -> proj), with mhsa's plain
    versions, against the plain attention: the wiring of heads and views."""
    torch.manual_seed(0)
    attn = Attention(256, 4)
    x = torch.randn(2, 300, 256, requires_grad=True)
    plain, route = attn(x), attn.forward_kernel(x)
    torch.testing.assert_close(route, plain, rtol=1e-5, atol=1e-5)
    params = [x, *attn.parameters()]
    for a, b in zip(torch.autograd.grad(route.square().sum(), params),
                    torch.autograd.grad(plain.square().sum(), params)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("n,dim,heads,route", [
    (26, 384, 6, "fused"), (257, 192, 3, "fused"), (1025, 768, 3, "layered"),
    (600, 384, 6, "layered"), (2048, 256, 1, "layered"),
])
def test_block_route_by_shape(n, dim, heads, route):
    assert Block(dim, heads).route(torch.zeros(1, n, dim)) == route


@pytest.mark.parametrize("n,dim,heads,match", [
    (2049, 768, 3, "sequence length 2049"), (1025, 768, 8, "head_dim 96"),
    (100, 192 * 2, 2, "sequence length 100"),
])
def test_block_route_refuses_what_no_kernel_takes(n, dim, heads, match):
    """Where neither the fused kernels nor mhsa take a call, the block takes its
    layered route with the plain attention (the JAX package's XLA attention),
    and the attention's gate names why mhsa refuses."""
    blk = Block(dim, heads)
    x = torch.zeros(1, n, dim)
    assert blk.route(x) == "layered"
    assert re.search(match, blk.attn.kernel_unsupported(x))


def test_layered_route_gates_as_the_jax_attention():
    blk = Block(768, 3, attn_drop=0.1)
    x = torch.zeros(1, 1025, 768)
    assert blk.train().route(x) == "layered"
    assert "attention dropout" in blk.attn.kernel_unsupported(x)
    assert blk.eval().route(x) == "layered"
    assert blk.attn.kernel_unsupported(x) is None
    assert blk.route(x, seg_len=5) == "layered"
    assert "seg_len" in blk.attn.kernel_unsupported(x, seg_len=5)
    assert mk.unsupported(1025, 256, torch.float32) is None
    assert "dtype" in mk.unsupported(1025, 256, torch.float16)
    assert "head_dim 96" in mk.unsupported(1025, 96, torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (a 10-bit mantissa), ties away from zero: the card's
    cvt.rna.tf32.f32, on the float32 bits."""
    bits = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def test_tf32_rounding_emulation():
    x = torch.tensor([1 + 2**-11, 1 + 2**-12, 1 + 3 * 2**-11, -(1 + 2**-11), 3.0, 0.0])
    want = torch.tensor([1 + 2**-10, 1.0, 1 + 2**-9, -(1 + 2**-10), 3.0, 0.0])
    assert torch.equal(tf32(x), want)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 bits cleared: how the tensor core reads a float32
    register as a TF32 operand."""
    bits = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy((bits & np.uint32(0xFFFFE000)).view(np.float32))


def tf32_product(passes: int):
    """A float32 matrix product on TF32 operands: one pass (a_big b_big) or
    the kernels' three (a_small b_big + a_big b_small + a_big b_big), with
    big = tf32(x) and small = x - big, read by the tensor core truncated."""
    def mm(a, b):
        ab, bb = tf32(a), tf32(b)
        if passes == 1:
            return ab @ bb
        return tf32_truncated(a - ab) @ bb + ab @ tf32_truncated(b - bb) + ab @ bb
    return mm


def attention_with(mm, q, k, v, g, scale):
    """The plain f32 forward and backward (mhsa_reference and
    mhsa_backward_reference) with every product through ``mm``: [o, dq, dk, dv]."""
    qh, kh, vh, gh = (t.permute(0, 2, 1, 3) for t in (q, k, v, g))
    s = mm(qh, kh.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = mm(gh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    out = (mm(p, vh), mm(ds, kh), mm(ds.transpose(-1, -2), qh), mm(p.transpose(-1, -2), gh))
    return [t.permute(0, 2, 1, 3) for t in out]


@pytest.mark.parametrize("passes", [3, 1], ids=["3-pass meets", "1-pass misses"])
def test_f32_products_need_the_3_pass_tf32_split(passes):
    """Why the kernels split each f32 operand in two: at an S3DIS-like shape
    (dh = 256, N = 257) the plain forward and backward with every product as
    3-pass TF32 stay within the card's f32 tolerance of the plain versions, and
    with one TF32 pass (10 bits an operand) they do not."""
    q, k, v, g = (torch.from_numpy(a) for a in inputs(1, 257, 1, 256, "float32", 5))
    scale = 256 ** -0.5
    want = [mk.mhsa_reference(q, k, v, scale), *mk.mhsa_backward_reference(q, k, v, g, scale)]
    err = rel_err(attention_with(tf32_product(passes), q, k, v, g, scale), want)
    exact = rel_err(attention_with(torch.matmul, q, k, v, g, scale), want)
    assert exact <= 1e-5  # the emulation's own arithmetic is the plain versions'
    if passes == 3:
        assert err <= MHSA_REL["float32"]
    else:
        assert err > MHSA_REL["float32"]


def test_kernel_views_keep_16_byte_alignment():
    """The kernels copy 16 bytes at a time: the packed qkv views pass as they
    are, a view off 16 bytes is copied (same values, contiguous)."""
    qkv = torch.zeros(2, 70, 3, 3, 64)
    q = qkv[:, :, 1]
    assert mk._aligned(q) is q
    off = torch.arange(2 * 70 * 64 + 1, dtype=torch.float32)[1:].view(2, 70, 1, 64)
    got = mk._aligned(off)
    assert got is not off and got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, off)
