"""Why the f32 ViT block takes three TF32 passes on the tensor cores.

The block's CUDA chain (``csrc/vit_block.cu`` on the core of
``csrc/tc_gemm.cuh``, f32 compute dtype) runs each of its twelve products on
the tensor cores in 3-pass TF32: each f32 operand x is split into big =
tf32(x), rounded to nearest with ties away on the bit pattern, and small = x -
big, which the tensor core reads truncated to TF32; a product is a_small b_big
+ a_big b_small + a_big b_big, each pass exact in f32 and summed in f32. Here
the same rounding is emulated in plain torch on the CPU for the forward's four
products (qkv, proj, fc1, fc2), the backward's four row products (g_a1, g_z2,
g_o, g_z1) and its four weight gradients, summed over M = 4,096 token rows as
at the partseg shape (16 x 257 rows), at a small width (D = 64, one head), and
held against float64 products of the same f32 operands, which a float64 chain
makes from inputs drawn as the chip check draws them. Three passes stay
within the chip check's GRAD_REL of each output's largest value (3.3e-7 to
6.6e-7 here); one pass departs by 1.8e-4 (dWqkv) to 3.6e-4 (fc2), past
GRAD_REL for every one of the twelve.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GRAD_REL
from simple3dformer_tpu_torch.kernels import vit_block as vb

B, N, D, H = 16, 256, 64, 1  # M = 4,096 token rows, the weight gradients' contraction
TOL = GRAD_REL["float32"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), to nearest with ties away from zero:
    the kernel's integer add and mask on the bit pattern."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by dropping the low 13 bits, as the tensor core reads an f32."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b (f32) on emulated TF32 tensor cores: one pass of the rounded
    operands, or three (the small terms first), each summed in f32."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = tf32_trunc(a - a_big), tf32_trunc(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


@pytest.fixture(scope="module")
def operands():
    """The f32 operands of the block's twelve products, from a float64 forward
    and backward on inputs drawn as chip_smoke.block_inputs draws them: name ->
    (left, right) with the product left @ right."""
    rs = np.random.RandomState(12)
    x = torch.from_numpy(rs.randn(B, N, D))
    w = {}
    for name, shape in vb.weight_shapes(D).items():
        if name in ("ln1_s", "ln2_s"):
            w[name] = torch.from_numpy(1.0 + 0.1 * rs.randn(*shape))
        elif len(shape) == 2:
            w[name] = torch.from_numpy(rs.randn(*shape) * shape[1] ** -0.5)
        else:
            w[name] = torch.from_numpy(0.1 * rs.randn(*shape))
    g = torch.from_numpy(rs.randn(B, N, D))
    dh = D // H
    z1, _, _ = vb._ln_parts(x, w["ln1_s"], w["ln1_b"])
    qkv = z1 @ w["wqkv"].T + w["bqkv"]
    q, k, v = qkv.reshape(B, N, 3, H, dh).permute(2, 0, 3, 1, 4)
    p = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, -1)
    o = (p @ v).transpose(1, 2).reshape(B, N, D)
    h1 = x + o @ w["wproj"].T + w["bproj"]
    z2, xh2, rstd2 = vb._ln_parts(h1, w["ln2_s"], w["ln2_b"])
    a1 = z2 @ w["w1"].T + w["b1"]
    g_a1 = (g @ w["w2"]) * vb._gelu_tanh_grad(a1)
    g_z2 = g_a1 @ w["w1"]
    g_h1 = g + vb._ln_bwd(g_z2, xh2, rstd2, w["ln2_s"])
    g_o = g_h1 @ w["wproj"]
    g_oh = g_o.reshape(B, N, H, dh).transpose(1, 2)
    g_p = g_oh @ v.transpose(-1, -2)
    g_s = p * (g_p - (g_p * p).sum(-1, keepdim=True)) * dh ** -0.5
    g_qkv = torch.stack([g_s @ k, g_s.transpose(-1, -2) @ q, p.transpose(-1, -2) @ g_oh])
    g_qkv = g_qkv.permute(1, 3, 0, 2, 4).reshape(B, N, 3 * D)
    rows = lambda t: t.reshape(-1, t.shape[-1]).float()  # noqa: E731
    wf = {name: t.float() for name, t in w.items()}
    return {"qkv = LN1(x) Wqkv^T": (rows(z1), wf["wqkv"].t()),
            "proj = o Wproj^T": (rows(o), wf["wproj"].t()),
            "fc1 = LN2(h1) W1^T": (rows(z2), wf["w1"].t()),
            "fc2 = gelu(a1) W2^T": (rows(vb._gelu_tanh(a1)), wf["w2"].t()),
            "g_a1 = g_y W2": (rows(g), wf["w2"]),
            "g_z2 = g_a1 W1": (rows(g_a1), wf["w1"]),
            "g_o = g_h1 Wproj": (rows(g_h1), wf["wproj"]),
            "g_z1 = g_qkv Wqkv": (rows(g_qkv), wf["wqkv"]),
            "dW2 = g_y^T gelu(a1)": (rows(g).t(), rows(vb._gelu_tanh(a1))),
            "dW1 = g_a1^T LN2(h1)": (rows(g_a1).t(), rows(z2)),
            "dWproj = g_h1^T o": (rows(g_h1).t(), rows(o)),
            "dWqkv = g_qkv^T LN1(x)": (rows(g_qkv).t(), rows(z1))}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


PRODUCTS = ["qkv = LN1(x) Wqkv^T", "proj = o Wproj^T", "fc1 = LN2(h1) W1^T",
            "fc2 = gelu(a1) W2^T", "g_a1 = g_y W2", "g_z2 = g_a1 W1", "g_o = g_h1 Wproj",
            "g_z1 = g_qkv Wqkv", "dW2 = g_y^T gelu(a1)", "dW1 = g_a1^T LN2(h1)",
            "dWproj = g_h1^T o", "dWqkv = g_qkv^T LN1(x)"]


@pytest.mark.parametrize("name", PRODUCTS)
def test_three_tf32_passes_hold_grad_rel_and_one_does_not(operands, name):
    left, right = operands[name]
    exact = left.double() @ right.double()
    three, one = (rel_err(product(left, right, p), exact) for p in (3, 1))
    assert three <= TOL, f"{name}: 3-pass error {three:.3e}"
    assert one > TOL, f"{name}: 1-pass error {one:.3e}"
