"""Why the f32 vector attention takes three TF32 passes on the tensor cores.

The kernels (``csrc/vector_attention.cu`` on the tensor-core core of
``csrc/tc_gemm.cuh``, its f32 route, forward and backward) split each f32
operand x into big = tf32(x), rounded to nearest with ties away on the bit
pattern, and small = x - big, which the tensor core reads truncated to TF32; a product is a_small b_big +
a_big b_small + a_big b_big, each pass exact in f32 and summed in f32. Here the
same rounding is emulated in plain torch on the CPU for the three products of
the forward chain (pos, hg_pre and the logits, each against a weight) and the
six of ``vector_attention_backward_reference`` (three row GEMMs against the
weights, three weight gradients summed over all B*N*K rows), at a shape with a
long row contraction, and held against float64 products of the same f32
operands: three passes stay within the chip check's VA_REL of each output's
largest value (1e-7 to 4e-7 here), one pass misses it for eight of the nine
(3e-4 to 5e-4). For wd2's gradient one pass measured 7.5e-5 here, under
VA_REL: its right factor hd is a ReLU's output, and its errors average out;
the test holds it to ten times the three-pass error instead. The forward's
output, every product of the chain so emulated, measured 2.1e-7 (three
passes) and 1.0e-4 (one pass) of its largest value against the float64 chain:
the softmax and the sum over K damp the products' errors, so one pass is held
to ten times the three-pass error there too.
"""

import numpy as np
import pytest
import torch

from chip_smoke import VA_REL
from simple3dformer_tpu_torch.kernels import vector_attention as va

B, N, K, D = 2, 512, 16, 32  # R = 16,384 rows, the weight gradients' contraction


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
    """The f32 operands of the forward's three products and the backward's six,
    from a float64 chain on inputs made with numpy as the chip check makes them
    (unit-gain Linear weights, rel of unit-sphere scale): name -> (left, right)
    with the product left @ right; "chain": the inputs, the f32 weights and
    the float64 output."""
    rs = np.random.RandomState(10)

    def t(*shape, scale=1.0):
        return torch.from_numpy(scale * rs.randn(*shape))

    q, k, v = t(B, N, D), t(B, N, K, D), t(B, N, K, D)
    rel = t(B, N, K, 3, scale=0.1)
    w = {name: t(*shape, scale=shape[1] ** -0.5 if len(shape) == 2 else 0.1)
         for name, shape in va.weight_shapes(D).items()}
    g = t(B, N, D)
    hd_pre, hd, pos, x, hg_pre, hg, a, u, out = va._chain(q, k, v, rel, w)
    g3 = g[:, :, None, :]
    g_a = g3 * u
    gl = a * (g_a - (a * g_a).sum(2, keepdim=True)) / D ** 0.5
    g_hg = (gl @ w["wg2"]) * (hg_pre > 0)
    g_pos = g_hg @ w["wg1"] + a * g3
    rows = lambda t: t.reshape(-1, D).float()  # noqa: E731
    wf = {name: t.float() for name, t in w.items()}
    return {"pos = hd wd2^T": (rows(hd), wf["wd2"].t()),
            "hg_pre = x wg1^T": (rows(x), wf["wg1"].t()),
            "z = hg wg2^T": (rows(hg), wf["wg2"].t()),
            "g_hg = gl wg2": (rows(gl), w["wg2"].float()),
            "g_x = g_hg wg1": (rows(g_hg), w["wg1"].float()),
            "g_hd = g_pos wd2": (rows(g_pos), w["wd2"].float()),
            "gwg2 = gl^T hg": (rows(gl).t(), rows(hg)),
            "gwg1 = g_hg^T x": (rows(g_hg).t(), rows(x)),
            "gwd2 = g_pos^T hd": (rows(g_pos).t(), rows(hd)),
            "chain": ((q.float(), k.float(), v.float(), rel.float(), wf), out)}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


PRODUCTS = ["pos = hd wd2^T", "hg_pre = x wg1^T", "z = hg wg2^T", "g_hg = gl wg2", "g_x = g_hg wg1", "g_hd = g_pos wd2", "gwg2 = gl^T hg",
            "gwg1 = g_hg^T x", "gwd2 = g_pos^T hd"]
ONE_PASS_HOLDS = {"gwd2 = g_pos^T hd"}  # measured 7.5e-5 at this shape (the docstring)


@pytest.mark.parametrize("name", PRODUCTS)
def test_three_tf32_passes_hold_va_rel_and_one_does_not(operands, name):
    left, right = operands[name]
    exact = left.double() @ right.double()
    three, one = (rel_err(product(left, right, p), exact) for p in (3, 1))
    assert three <= VA_REL, f"{name}: 3-pass error {three:.3e}"
    if name in ONE_PASS_HOLDS:
        assert one > 10 * three, f"{name}: 1-pass error {one:.3e}, 3-pass {three:.3e}"
    else:
        assert one > VA_REL, f"{name}: 1-pass error {one:.3e}"


def test_three_tf32_passes_hold_the_forwards_output_within_va_rel(operands):
    """The forward chain in f32 with its three products emulated against the
    float64 chain: three passes within VA_REL of the output's largest value,
    one pass over ten times their error (the module docstring)."""
    (q, k, v, rel, w), exact = operands["chain"]

    def out(passes):
        def linear(a, weight, bias):
            flat = product(a.reshape(-1, a.shape[-1]), weight.t(), passes)
            return flat.reshape(*a.shape[:-1], weight.shape[0]) + bias

        pos = linear(torch.relu(torch.nn.functional.linear(rel, w["wd1"], w["bd1"])), w["wd2"],
                     w["bd2"])
        hg = torch.relu(linear(q[:, :, None, :] - k + pos, w["wg1"], w["bg1"]))
        a = torch.softmax(linear(hg, w["wg2"], w["bg2"]) / D ** 0.5, dim=2)
        return (a * (v + pos)).sum(2)

    three, one = (rel_err(out(p), exact) for p in (3, 1))
    assert three <= VA_REL, f"3-pass error {three:.3e}"
    assert one > 10 * three, f"1-pass error {one:.3e}, 3-pass {three:.3e}"


def test_the_emulated_rounding_is_the_kernels():
    """tf32_round is round-to-nearest, ties away, to 10 mantissa bits; small is
    exact and its truncation drops under 2**-21 of x."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10,
                                      -(1.0 + 2.0 ** -10), 1.0]
    r = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    big = tf32_round(r)
    assert torch.equal(big + (r - big), r)
    assert float(((big + tf32_trunc(r - big)) - r).abs().div(r.abs()).max()) < 2.0 ** -21
