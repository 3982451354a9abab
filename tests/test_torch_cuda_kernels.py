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

from chip_smoke import KERNEL_SHAPES, TOL, block_inputs
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
