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

from chip_smoke import GRAD_REL, KERNEL_SHAPES, TOL, TRAIN_SHAPES, block_inputs, errors
from simple3dformer_tpu_torch.kernels import vit_block as vb
from simple3dformer_tpu_torch.kernels.adam import adam_reference, fused_adam
from simple3dformer_tpu_torch.kernels.vit_block import WNAMES, fused_vit_block, vit_block_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("label,b,n,d,heads,dtype", KERNEL_SHAPES,
                         ids=[s[0] for s in KERNEL_SHAPES])
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


@pytest.mark.parametrize("label,b,n,d,heads,dtype", TRAIN_SHAPES[:2],
                         ids=[s[0] for s in TRAIN_SHAPES[:2]])
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
