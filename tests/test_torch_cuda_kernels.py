"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA Hopper card and nvcc; they skip elsewhere. On such a
machine, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the shared conftest imports jax, which the port's machine
need not have.) The shapes, tolerances and inputs are chip_smoke.py's, so the
two checks cannot drift apart.
"""

import pytest
import torch

from chip_smoke import (FPS_SHAPES, GATHER_BWD_REL, GATHER_SHAPES, GRAD_REL, KERNEL_SHAPES,
                        KNN_SHAPES, LWF_BLOCK_SHAPES, MHSA_REL, MHSA_SHAPES, TOL, TRAIN_SHAPES,
                        VA_REL, VA_SHAPES,
                        VAG_REL, VAG_RESID_REL, VAG_SHAPES, block_cdt_check, block_inputs,
                        errors, gather_check,
                        gather_inputs, knn_check, knn_inputs, mhsa_inputs, rel_err, unit_cloud,
                        va_err, va_inputs, vag_check, vag_inputs)
from simple3dformer_tpu_torch.kernels import mhsa as mk
from simple3dformer_tpu_torch.kernels import vector_attention as va
from simple3dformer_tpu_torch.kernels import vit_block as vb
from simple3dformer_tpu_torch.kernels.adam import adam_reference, fused_adam
from simple3dformer_tpu_torch.kernels.fps import fps, fps_reference
from simple3dformer_tpu_torch.kernels.gather import (gather_bwd, gather_bwd_reference, gather_fwd,
                                                     gather_fwd_reference, gather_rows)
from simple3dformer_tpu_torch.kernels.knn import knn
from simple3dformer_tpu_torch.kernels.vit_block import WNAMES, fused_vit_block, vit_block_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("label,b,n,d,heads,dtype", KERNEL_SHAPES + LWF_BLOCK_SHAPES,
                         ids=[s[0] for s in KERNEL_SHAPES + LWF_BLOCK_SHAPES])
def test_fused_vit_block_matches_plain(device, label, b, n, d, heads, dtype):
    x, w = block_inputs(torch, b, n, d, getattr(torch, dtype), seed=b * 1000 + n + d,
                        device=device)
    before = fused_vit_block.launches
    got = fused_vit_block(x, w, heads)
    want = vit_block_reference(x, w, heads)
    torch.cuda.synchronize()
    assert fused_vit_block.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_fused_vit_block_rejects_what_it_cannot_take(device):
    x, w = block_inputs(torch, 2, 26, 384, torch.float32, seed=0, device=device)
    with pytest.raises(ValueError, match="head_dim"):
        fused_vit_block(x, w, 4)  # head_dim 96
    long_x, long_w = block_inputs(torch, 1, 513, 384, torch.float32, seed=0, device=device)
    with pytest.raises(ValueError, match="sequence length"):
        fused_vit_block(long_x, long_w, 6)
    w_cpu = dict(w, wqkv=w["wqkv"].cpu())
    with pytest.raises(ValueError, match="wqkv"):
        fused_vit_block(x, w_cpu, 6)
    assert set(w) == set(WNAMES)


# the flagship, the partseg training shape in both dtypes, M = 858 token rows,
# not a multiple of the GEMMs' 64-row tiles, and the LwF paths' shapes
BLOCK_TRAIN_SHAPES = TRAIN_SHAPES[:2] + [s for s in TRAIN_SHAPES if s[0] in (
    "B=33", "partseg N=257", "partseg N=257 bf16")] + LWF_BLOCK_SHAPES


@pytest.mark.parametrize("label,b,n,d,heads,dtype", BLOCK_TRAIN_SHAPES,
                         ids=[s[0] for s in BLOCK_TRAIN_SHAPES])
def test_training_block_kernels_match_plain(device, label, b, n, d, heads, dtype):
    x, w = block_inputs(torch, b, n, d, getattr(torch, dtype), seed=b * 1000 + n + d,
                        device=device)
    g = torch.randn(b, n, d, generator=torch.Generator().manual_seed(1)).to(device, x.dtype)
    before = [vb.fused_vit_block_train_fwd.launches, vb.fused_vit_block_train_bwd.launches,
              vb.fused_vit_block_bwd.launches]
    y, res = vb.fused_vit_block_train_fwd(x, w, heads)
    gx, gw = vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res)
    cx, cw = vb.fused_vit_block_bwd(x, g, w, heads)
    y_ref, res_ref = vb.vit_block_train_reference(x, w, heads)
    want_x, want_w = vb.vit_block_backward_reference(x, g, w, heads, residuals=res)
    rec_x, rec_w = vb.vit_block_backward_reference(x, g, w, heads)
    torch.cuda.synchronize()
    assert [vb.fused_vit_block_train_fwd.launches, vb.fused_vit_block_train_bwd.launches,
            vb.fused_vit_block_bwd.launches] == [c + 1 for c in before]
    assert gx.dtype == x.dtype and all(t.dtype == torch.float32 for t in gw.values())
    assert errors({"y": y, **res}, {"y": y_ref, **res_ref})[1] <= GRAD_REL[dtype]
    assert errors({"gx": gx, **gw}, {"gx": want_x, **want_w})[1] <= GRAD_REL[dtype]
    assert errors({"gx": cx, **cw}, {"gx": rec_x, **rec_w})[1] <= GRAD_REL[dtype]
    gx2, gw2 = vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res)
    assert torch.equal(gx, gx2) and all(torch.equal(gw[k], gw2[k]) for k in WNAMES)
    cx2, cw2 = vb.fused_vit_block_bwd(x, g, w, heads)
    assert torch.equal(cx, cx2) and all(torch.equal(cw[k], cw2[k]) for k in WNAMES)


def test_training_block_through_autograd_in_a_block(device):
    from simple3dformer_tpu_torch.nn.layers import Block

    torch.manual_seed(0)
    blk = Block(384, 6)
    cuda_blk = Block(384, 6).to(device)
    cuda_blk.load_state_dict(blk.state_dict())
    x = torch.randn(4, 26, 384)
    for train in (True, False):
        blk.train(train)
        cuda_blk.train(train)
        want = torch.autograd.grad(blk(x).square().sum(), list(blk.parameters()))
        got = torch.autograd.grad(cuda_blk(x.to(device)).square().sum(),
                                  list(cuda_blk.parameters()))
        for a, b in zip(got, want):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3 * float(b.abs().max()))


def test_adam_kernel_matches_plain(device):
    rs = torch.Generator().manual_seed(2)
    leaves = []
    for shape in [(1000, 384), (384,), (7,), (5000,)]:
        p = torch.randn(*shape, generator=rs).to(device)
        m = 0.01 * torch.randn(*shape, generator=rs).to(device)
        v = 1e-4 * torch.rand(*shape, generator=rs).to(device)
        g = 0.01 * torch.randn(*shape, generator=rs).to(device)
        leaves.append((p, m, v, g))
    leaves.append((torch.randn(300, device=device), torch.zeros(300, device=device),
                   torch.zeros(300, device=device), None))
    want = [adam_reference(*leaf, 1e-3, 5, weight_decay=0.01) for leaf in leaves]
    before = fused_adam.launches
    fused_adam(leaves, 1e-3, 5, weight_decay=0.01)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 1
    for leaf, ref in zip(leaves, want):
        for a, b in zip(leaf[:3], ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("label,b,n,npoint", FPS_SHAPES, ids=[s[0] for s in FPS_SHAPES])
def test_fps_kernel_matches_plain(device, label, b, n, npoint):
    import numpy as np

    rs = np.random.RandomState(b + n)
    xyz = unit_cloud(torch, rs, b, n)
    start = torch.from_numpy(rs.randint(0, n, b).astype("int32")).to(device)
    before = fps.launches
    got, got_s = fps(xyz, npoint), fps(xyz, npoint, start)
    assert fps.launches == before + 2
    assert torch.equal(got, fps_reference(xyz, npoint))
    assert torch.equal(got_s, fps_reference(xyz, npoint, start))
    assert torch.equal(got_s[:, 0], start)


@pytest.mark.parametrize("label,b,s,n,k,dup", KNN_SHAPES, ids=[s[0] for s in KNN_SHAPES])
def test_knn_kernel_matches_plain(device, label, b, s, n, k, dup):
    """Bit for bit the exact-order plain version and a second run; near-ties of
    the matmul form; equal distances in index order (knn_check)."""
    import numpy as np

    q, p = knn_inputs(torch, np.random.RandomState(s + n + k), b, s, n, dup)
    before = knn.launches
    ok, _, _, facts = knn_check(torch, q, p, k)
    assert knn.launches == before + 2
    assert ok, facts
    if dup:
        assert facts["ties"]


@pytest.mark.parametrize("label,b,n,r,c,dtype,one_point", GATHER_SHAPES,
                         ids=[s[0] for s in GATHER_SHAPES])
def test_gather_kernels_match_plain_and_repeat_bit_for_bit(device, label, b, n, r, c, dtype,
                                                           one_point):
    pts, idx, g = gather_inputs(torch, b, n, r, c, dtype, one_point, seed=r + c, device=device)
    before = (gather_fwd.launches, gather_bwd.launches)
    ok, *_, facts = gather_check(torch, pts, idx, g)
    assert (gather_fwd.launches, gather_bwd.launches) == (before[0] + 1, before[1] + 2)
    assert ok, facts


def test_gather_bwd_sums_one_point_in_row_order(device):
    # random gradients, every row on one point: 16384 terms, each sum in
    # ascending r as on the CPU
    pts, idx, _ = gather_inputs(torch, 2, 1024, 16384, 48, "float32", True, seed=5, device=device)
    g = torch.randn(2, 16384, 48, generator=torch.Generator(device).manual_seed(6), device=device)
    gp, gp2 = gather_bwd(idx, g, 1024), gather_bwd(idx, g, 1024)
    assert torch.equal(gp.cpu(), gather_bwd_reference(idx.cpu(), g.cpu(), 1024))
    assert torch.equal(gp, gp2)
    assert int((gp.abs().sum(-1) > 0).sum()) == 2  # one point row each, the rest zero


# (label, B, N, R, C, dtype name, points and g viewed at an element offset):
# the smallest sizes, a histogram too large for shared memory, rows of odd
# bytes, views whose data_ptr is not 16-byte aligned, and B*R*C above 2**31
GATHER_EDGES = [("N=1", 3, 1, 40, 48, "float32", 0), ("R=1", 3, 50, 1, 48, "float32", 0),
                ("N=1 R=1 C=1", 1, 1, 1, 1, "bfloat16", 0),
                ("N=20000", 2, 20000, 5000, 16, "float32", 0),
                ("C=5 bf16 offset 1", 4, 300, 2000, 5, "bfloat16", 1),
                ("C=64 f32 offset 1", 4, 300, 2000, 64, "float32", 1),
                ("C=64 bf16 offset 4", 4, 300, 2000, 64, "bfloat16", 4),
                ("B*R*C above 2**31", 1, 64, 65536, 32800, "bfloat16", 0)]


@pytest.mark.parametrize("label,b,n,r,c,dtype,offset", GATHER_EDGES,
                         ids=[s[0] for s in GATHER_EDGES])
def test_gather_kernels_take_the_edges(device, label, b, n, r, c, dtype, offset):
    pts, idx, g = gather_inputs(torch, b, n, r, c, dtype, False, seed=n + r + c, device=device)
    if offset:  # the same values, stored at an element offset into a larger buffer

        def shifted(t):
            buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
            view = buf[offset:].view(t.shape)
            view.copy_(t)
            return view

        pts, g = shifted(pts), shifted(g)
        assert pts.is_contiguous() and pts.data_ptr() % 16 and g.data_ptr() % 16
    if b * r * c < 2 ** 31:
        ok, *_, facts = gather_check(torch, pts, idx, g)
        assert ok, facts
        return
    # too large for the CPU copies: the forward on the card, the backward's
    # last columns on the CPU (each column sums alone) and the rest on the card
    assert torch.equal(gather_fwd(pts, idx), gather_fwd_reference(pts, idx))
    gp, gp2 = gather_bwd(idx, g, n), gather_bwd(idx, g, n)
    want = gather_bwd_reference(idx, g, n)
    assert float((gp - want).abs().max()) <= GATHER_BWD_REL * float(want.abs().max())
    assert torch.equal(gp, gp2)
    tail = gather_bwd_reference(idx.cpu(), g[..., -64:].cpu(), n)
    assert torch.equal(gp[..., -64:].cpu(), tail)


def test_gather_rows_through_autograd(device):
    pts = torch.randn(2, 50, 8, device=device, requires_grad=True)
    idx = torch.randint(0, 50, (2, 70), device=device, dtype=torch.int32)
    before = gather_bwd.launches
    (grad,) = torch.autograd.grad(gather_rows(pts, idx).square().sum(), pts)
    assert gather_bwd.launches == before + 1
    cpu = pts.detach().cpu().requires_grad_()
    (want,) = torch.autograd.grad(gather_rows(cpu, idx.cpu()).square().sum(), cpu)
    torch.testing.assert_close(grad.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("label,b,n,h,dh,dtype", MHSA_SHAPES, ids=[s[0] for s in MHSA_SHAPES])
def test_mhsa_kernels_match_plain_and_repeat_bit_for_bit(device, label, b, n, h, dh, dtype):
    q, k, v, g = mhsa_inputs(torch, b, n, h, dh, getattr(torch, dtype), b * n + dh, device)
    scale = dh ** -0.5
    before = (mk.mhsa_fwd.launches, mk.mhsa_bwd.launches)
    o, stats = mk.mhsa_fwd(q, k, v, scale)
    grads = mk.mhsa_bwd(q, k, v, g, scale, stats, o)
    again = mk.mhsa_bwd(q, k, v, g, scale, stats, o)
    torch.cuda.synchronize()
    assert (mk.mhsa_fwd.launches, mk.mhsa_bwd.launches) == (before[0] + 1, before[1] + 2)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert rel_err([o], [mk.mhsa_reference(q, k, v, scale)]) <= MHSA_REL[dtype]
    assert rel_err(grads, mk.mhsa_backward_reference(q, k, v, g, scale)) <= MHSA_REL[dtype]
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


def test_mhsa_rejects_what_it_cannot_take(device):
    q, k, v, _ = mhsa_inputs(torch, 1, 300, 2, 96, torch.float32, 0, device)
    with pytest.raises(ValueError, match="head_dim"):
        mk.mhsa(q, k, v, 96 ** -0.5)
    q, k, v, _ = mhsa_inputs(torch, 1, 2049, 1, 64, torch.float32, 0, device)
    with pytest.raises(ValueError, match="sequence length"):
        mk.mhsa(q, k, v, 0.125)
    q, k, v, _ = mhsa_inputs(torch, 1, 300, 1, 64, torch.float16, 0, device)
    with pytest.raises(ValueError, match="dtype"):
        mk.mhsa(q, k, v, 0.125)


def test_layered_block_through_autograd_matches_plain(device):
    """N = 600 is beyond the fused kernels: the block runs its layered route,
    one mhsa forward and one backward, and no fused kernel."""
    from simple3dformer_tpu_torch.nn.layers import Block

    torch.manual_seed(0)
    blk = Block(768, 3)
    cuda_blk = Block(768, 3).to(device)
    cuda_blk.load_state_dict(blk.state_dict())
    x = torch.randn(2, 600, 768)
    assert cuda_blk.route(x) == "layered"
    for train in (True, False):
        blk.train(train)
        cuda_blk.train(train)
        before = (mk.mhsa_fwd.launches, mk.mhsa_bwd.launches, vb.fused_vit_block_train_fwd.launches,
                  vb.fused_vit_block.launches)
        want = torch.autograd.grad(blk(x).square().sum(), list(blk.parameters()))
        got = torch.autograd.grad(cuda_blk(x.to(device)).square().sum(),
                                  list(cuda_blk.parameters()))
        assert (mk.mhsa_fwd.launches, mk.mhsa_bwd.launches, vb.fused_vit_block_train_fwd.launches,
                vb.fused_vit_block.launches) == (before[0] + 1, before[1] + 1, *before[2:])
        for a, b in zip(got, want):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3 * float(b.abs().max()))


@pytest.mark.parametrize("label,b,n,d,heads", [("partseg N=257", 16, 257, 192, 3),
                                                 ("flagship", 32, 26, 384, 6)])
def test_fused_block_kernels_on_an_f32_stream_at_bf16_compute_match_plain(device, label, b, n, d,
                                                                          heads):
    """The bf16 3DViT's blocks: x (the residual stream) in f32, the matmuls in
    bf16; the forward, the training forward and both backwards against their
    plain versions, each backward twice bit-equal."""
    errs, same = block_cdt_check(torch, b, n, d, heads, torch.float32, torch.bfloat16,
                                 seed=b + n)
    assert same and max(errs.values()) <= GRAD_REL["bfloat16"], errs


def test_bf16_layered_block_through_autograd_matches_plain(device):
    """The bf16 S3DIS block (deit_base width, 3 heads, 1025 tokens, an f32
    residual stream): its layered route runs one mhsa forward and backward on
    bf16 q, k, v, no plain attention and no fused kernel; output and gradients
    within 5e-2 of each one's largest value of the CPU's plain path, the JAX
    package's own bound between its two bf16 attention routes (the kernels keep
    the softmax in f32 where the plain path rounds each of its steps to bf16)."""
    from simple3dformer_tpu_torch.nn.layers import Attention, Block

    torch.manual_seed(0)
    blk = Block(768, 3, dtype=torch.bfloat16).train()
    cuda_blk = Block(768, 3, dtype=torch.bfloat16).to(device).train()
    cuda_blk.load_state_dict(blk.state_dict())
    x = torch.randn(1, 1025, 768)
    assert cuda_blk.route(x) == "layered" and cuda_blk.attn.kernel_unsupported(x) is None
    before = (mk.mhsa_fwd.launches, mk.mhsa_bwd.launches, Attention.plain_calls,
              vb.fused_vit_block_train_fwd.launches)
    out = cuda_blk(x.to(device))
    got = torch.autograd.grad(out.square().sum(), list(cuda_blk.parameters()))
    assert (mk.mhsa_fwd.launches, mk.mhsa_bwd.launches, Attention.plain_calls,
            vb.fused_vit_block_train_fwd.launches) == (before[0] + 1, before[1] + 1, *before[2:])
    want_out = blk(x)
    want = torch.autograd.grad(want_out.square().sum(), list(blk.parameters()))
    assert out.dtype == want_out.dtype == torch.float32
    assert rel_err([out.detach().cpu()], [want_out.detach()]) <= 5e-2
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and rel_err([a.cpu()], [b]) <= 5e-2


def _va_flat(grads):
    gq, gk, gv, grel, gw = grads
    return [gq, gk, gv, grel, *[gw[name] for name in va.WNAMES]]


@pytest.mark.parametrize("label,b,n,kk,d,dup", VA_SHAPES, ids=[s[0] for s in VA_SHAPES])
def test_vector_attention_kernels_match_plain_and_repeat_bit_for_bit(device, label, b, n, kk, d,
                                                                     dup):
    """The f32 forward (its output and kept residuals) against the plain chain
    and the backward against the plain backward from those residuals, within
    VA_REL of each output's largest value; each twice bit-equal."""
    q, k, v, rel, w = va_inputs(torch, b, n, kk, d, b * n + kk + d, device, dup)
    g = torch.randn(b, n, d, generator=torch.Generator(device).manual_seed(n), device=device)
    before = (va.vector_attention_fwd.launches, va.vector_attention_bwd.launches)
    out, res = va.vector_attention_fwd(q, k, v, rel, w, save=True)
    out2, res2 = va.vector_attention_fwd(q, k, v, rel, w, save=True)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and all(torch.equal(res[key], res2[key]) for key in res)
    del out2, res2
    grads = va.vector_attention_bwd(g, rel, w, res)
    again = va.vector_attention_bwd(g, rel, w, res)
    torch.cuda.synchronize()
    assert (va.vector_attention_fwd.launches, va.vector_attention_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, c) for a, c in zip(_va_flat(grads), _va_flat(again)))
    del again
    want, want_res = va.vector_attention_resid_reference(q, k, v, rel, w)
    assert va_err("out", out, want) <= VA_REL
    for name in va.RESIDUALS:
        assert va_err(name, res[name], want_res[name]) <= VA_REL, name
    del want, want_res
    for name, a, c in zip(("gq", "gk", "gv", "grel", *va.WNAMES), _va_flat(grads),
                          _va_flat(va.vector_attention_resid_backward_reference(rel, w, res, g))):
        assert a.shape == c.shape
        assert va_err(name, a, c) <= VA_REL, name


def test_vector_attention_rejects_what_it_cannot_take(device):
    q, k, v, rel, w = va_inputs(torch, 1, 40, 8, 64, 0, device)
    with pytest.raises(ValueError, match="float32"):
        va.vector_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), rel, w)
    with pytest.raises(ValueError, match="wg1"):
        va.vector_attention_fwd(q, k, v, rel, dict(w, wg1=w["wg1"].cpu()))
    with pytest.raises(ValueError, match="contiguous"):
        va.vector_attention_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, rel, w)
    q, k, v, rel, w = va_inputs(torch, 1, 200, 129, 64, 0, device)
    with pytest.raises(ValueError, match="neighbours"):
        va.vector_attention_fwd(q, k, v, rel, w)


def test_vector_attention_block_through_autograd_matches_plain(device):
    """A Hengshuang block at N = 300 (and at N = 3, fewer points than
    neighbours) on the card against the CPU's plain path: one forward and one
    backward kernel launch each. fc_gamma's last bias has a zero gradient but
    for rounding (the softmax over K does not see it): both sides hold it below
    1e-6 of the block's largest gradient."""
    from simple3dformer_tpu_torch.nn.vector_attention import VectorAttentionBlock

    torch.manual_seed(0)
    blk = VectorAttentionBlock(64, 128, 16, generator=torch.Generator().manual_seed(0))
    cuda_blk = VectorAttentionBlock(64, 128, 16).to(device)
    cuda_blk.load_state_dict(blk.state_dict())
    for n in (300, 3):
        xyz, feats = torch.rand(2, n, 3), torch.randn(2, n, 64)
        before = (va.vector_attention_fwd.launches, va.vector_attention_bwd.launches)
        want = torch.autograd.grad(blk(xyz, feats)[0].square().sum(), list(blk.parameters()))
        got = torch.autograd.grad(cuda_blk(xyz.to(device), feats.to(device))[0].square().sum(),
                                  list(cuda_blk.parameters()))
        assert (va.vector_attention_fwd.launches, va.vector_attention_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        largest = max(float(g.abs().max()) for g in want)
        for name, a, b in zip([n for n, _ in blk.named_parameters()], got, want):
            if name == "fc_gamma.2.bias":
                assert max(float(a.abs().max()), float(b.abs().max())) < 1e-6 * largest
                continue
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3 * float(b.abs().max()))
    with pytest.raises(ValueError, match="float32"):
        cuda_blk.bfloat16()(xyz.bfloat16().to(device), feats.bfloat16().to(device))


def _vag_launches():
    return tuple(fn.launches for fn in (va.gather_attention_fwd, va.gather_attention_resid_fwd,
                                        va.gather_attention_bwd, va.gather_attention_resid_bwd))


@pytest.mark.parametrize("label,b,n,kk,d,dup", VAG_SHAPES, ids=[s[0] for s in VAG_SHAPES])
def test_bf16_vector_attention_kernels_match_plain_and_repeat_bit_for_bit(device, label, b, n, kk,
                                                                          d, dup):
    """The four bf16 kernels (forward, residual-saving forward, recompute and
    residual backward) against their plain versions within VAG_REL of each
    output's largest value, each twice bit-equal, the residual backward within
    VAG_RESID_REL of the recompute backward."""
    before = _vag_launches()
    r = vag_check(torch, b, n, kk, d, dup, seed=b * n + kk + d + 1, device=device)
    assert _vag_launches() == tuple(count + 2 for count in before)
    assert all(r["same"].values()), r["same"]
    assert r["finite"]
    for check, errs in r["err"].items():
        limit = VAG_RESID_REL if check == "resid vs recompute" else VAG_REL
        assert max(errs.values()) <= limit, (check, errs)


def test_bf16_vector_attention_rejects_what_it_cannot_take(device):
    q, k_all, v_all, idx, rel, w = vag_inputs(torch, 1, 40, 8, 64, 0, device)
    with pytest.raises(ValueError, match="bfloat16"):
        va.gather_attention_fwd(q.float(), k_all.float(), v_all.float(), idx, rel, w)
    with pytest.raises(ValueError, match="float32"):  # the parameters stay f32
        va.gather_attention_fwd(q, k_all, v_all, idx, rel, {k: t.bfloat16() for k, t in w.items()})
    with pytest.raises(ValueError, match="int32"):
        va.gather_attention_fwd(q, k_all, v_all, idx.long(), rel, w)
    with pytest.raises(ValueError, match="neighbours"):
        va.gather_attention_fwd(*vag_inputs(torch, 1, 200, 129, 64, 0, device))
    with pytest.raises(ValueError, match="multiple of 8"):
        va.gather_attention_fwd(*vag_inputs(torch, 1, 40, 8, 100, 0, device))


@pytest.mark.parametrize("resid", ["1", "0"], ids=["resid", "recompute"])
def test_bf16_vector_attention_block_through_autograd_matches_plain(device, monkeypatch, resid):
    """A bf16 Hengshuang block (parameters f32) at N = 300 and at N = 3 on the card
    against the CPU's plain path: the residual-saving pair, or under
    S3F_VA_RESID=0 the recompute pair, one forward and one backward launch each;
    gradients within 2e-2 of each one's largest value (bf16 intermediates).
    fc_gamma's last bias has a gradient that is zero but for rounding: both sides
    hold it below 1e-3 of the block's largest gradient."""
    from simple3dformer_tpu_torch.nn.vector_attention import VectorAttentionBlock

    monkeypatch.setenv("S3F_VA_RESID", resid)
    torch.manual_seed(0)
    blk = VectorAttentionBlock(64, 128, 16, generator=torch.Generator().manual_seed(0),
                               dtype=torch.bfloat16)
    cuda_blk = VectorAttentionBlock(64, 128, 16, dtype=torch.bfloat16).to(device)
    cuda_blk.load_state_dict(blk.state_dict())
    for n in (300, 3):
        xyz, feats = torch.rand(2, n, 3), torch.randn(2, n, 64)
        before = _vag_launches()
        want = torch.autograd.grad(blk(xyz, feats)[0].float().square().sum(),
                                   list(blk.parameters()))
        got = torch.autograd.grad(
            cuda_blk(xyz.to(device), feats.to(device))[0].float().square().sum(),
            list(cuda_blk.parameters()))
        step = (1, 0, 1, 0) if resid == "0" else (0, 1, 0, 1)
        assert _vag_launches() == tuple(a + s for a, s in zip(before, step))
        largest = max(float(g.abs().max()) for g in want)
        for name, a, b in zip([n for n, _ in blk.named_parameters()], got, want):
            assert a.dtype == torch.float32
            if name == "fc_gamma.2.bias":
                assert max(float(a.abs().max()), float(b.abs().max())) < 1e-3 * largest
                continue
            torch.testing.assert_close(a.cpu(), b, rtol=2e-2, atol=2e-2 * float(b.abs().max()))


def test_attention_outside_the_mhsa_gate_runs_plain_on_the_card(device):
    """A ViT block at 2049 tokens (beyond the mhsa kernels) takes the layered
    route with the plain attention, counted, and matches the CPU's plain path."""
    from simple3dformer_tpu_torch.nn.layers import Attention, Block

    torch.manual_seed(0)
    blk = Block(192, 3)
    cuda_blk = Block(192, 3).to(device)
    cuda_blk.load_state_dict(blk.state_dict())
    x = torch.randn(1, 2049, 192)
    assert cuda_blk.route(x) == "layered"
    assert "sequence length 2049" in cuda_blk.attn.kernel_unsupported(x)
    before = (Attention.plain_calls, mk.mhsa_fwd.launches)
    got = torch.autograd.grad(cuda_blk(x.to(device)).square().sum(), list(cuda_blk.parameters()))
    assert (Attention.plain_calls, mk.mhsa_fwd.launches) == (before[0] + 1, before[1])
    want = torch.autograd.grad(blk(x).square().sum(), list(blk.parameters()))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3 * float(b.abs().max()))
