"""The port's vector attention against the JAX package's, on the CPU: the plain
forward and backward of the kernels against the pre-gathered Pallas kernel in
interpret mode (its forward and ``jax.grad``), the autograd Function, the
kernels' gate, and ``VectorAttentionBlock`` against the JAX block on its XLA
path and on its kernel path. Inputs are made with numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.kernels.vector_attention import fused_vector_attention_pregathered
from simple3dformer_tpu.nn import vector_attention as jax_va
from simple3dformer_tpu_torch.kernels import vector_attention as va
from simple3dformer_tpu_torch.nn.vector_attention import VectorAttentionBlock
from simple3dformer_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, n, kk, d, seed):
    """q, k, v, rel and the JAX weights ([in, out]) as the JAX package's test makes them."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(*s).astype(np.float32) * 0.3 for s in ((b, n, d), (b, n, kk, d),
                                                               (b, n, kk, d)))
    rel = rs.randn(b, n, kk, 3).astype(np.float32)
    w = {name: rs.randn(*s).astype(np.float32) * 0.05
         for name, s in [("wd1", (3, d)), ("bd1", (d,)), ("wd2", (d, d)), ("bd2", (d,)),
                         ("wg1", (d, d)), ("bg1", (d,)), ("wg2", (d, d)), ("bg2", (d,))]}
    g = rs.randn(b, n, d).astype(np.float32)
    return q, k, v, rel, w, g


def _torch_weights(w):
    """JAX [in, out] kernels -> the Linear layout [out, in]."""
    return {name: torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
            for name, a in w.items()}


# (B, N, K, D): the JAX package's test shape; N not a multiple of the TPU
# kernel's 32-row tile with K < 16; one point with a single neighbour
SHAPES = [(2, 64, 8, 128), (3, 27, 5, 128), (1, 1, 1, 64)]


@pytest.mark.parametrize("b,n,kk,d", SHAPES, ids=["B2N64K8", "B3N27K5", "N1K1"])
def test_plain_versions_match_the_pallas_kernel(b, n, kk, d):
    """Forward within 1e-5 (the JAX test's tolerance for this kernel: f32 sums in
    another order); gradients within 1e-4 of max(1, the largest value), the JAX
    test's scale: bg2's gradient is zero but for rounding, the softmax over K
    being blind to a bias added to every neighbour's logit."""
    q, k, v, rel, w, g = _inputs(b, n, kk, d, seed=b * n + kk)
    jargs = [jnp.asarray(a) for a in (q, k, v, rel)] + [{n_: jnp.asarray(a) for n_, a in w.items()}]
    want = fused_vector_attention_pregathered(*jargs, 32, True)
    tw = _torch_weights(w)
    got = va.vector_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, rel)), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def loss(*a):
        return jnp.sum(fused_vector_attention_pregathered(*a, 32, True) * g)

    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)
    gq, gk, gv, grel, gw = va.vector_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, rel)), tw, torch.from_numpy(g))
    pairs = [("gq", gq, jgrads[0]), ("gk", gk, jgrads[1]), ("gv", gv, jgrads[2]),
             ("grel", grel, jgrads[3])]
    pairs += [(name, gw[name], np.asarray(jgrads[4][name]).T if gw[name].ndim == 2
               else jgrads[4][name]) for name in va.WNAMES]
    for name, a, c in pairs:
        c = np.asarray(c)
        scale = max(float(np.abs(c).max()), 1.0)
        np.testing.assert_allclose(a.numpy() / scale, c / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("b,n,kk,d", SHAPES, ids=["B2N64K8", "B3N27K5", "N1K1"])
def test_backward_from_the_residuals_is_the_recompute_backward(b, n, kk, d):
    """The plain versions of the pair as the card runs it, the forward keeping
    x, u, relu(hg) and a and the backward from them, give the plain forward's
    output and the recompute backward's gradients bit for bit."""
    q, k, v, rel, w, g = _inputs(b, n, kk, d, seed=b * n + kk + 1)
    args = [torch.from_numpy(a) for a in (q, k, v, rel)]
    tw, gt = _torch_weights(w), torch.from_numpy(g)
    out, res = va.vector_attention_resid_reference(*args, tw)
    assert torch.equal(out, va.vector_attention_reference(*args, tw))
    assert all(res[name].shape == (b * n * kk, d) for name in va.RESIDUALS)
    gq, gk, gv, grel, gw = va.vector_attention_resid_backward_reference(args[3], tw, res, gt)
    want = va.vector_attention_backward_reference(*args, tw, gt)
    for a, c in zip([gq, gk, gv, grel, *gw.values()], [*want[:4], *want[4].values()]):
        assert torch.equal(a, c)


def test_autograd_function_runs_the_plain_backward_on_the_cpu():
    q, k, v, rel, w, g = _inputs(2, 20, 6, 32, seed=5)
    tw = {name: t.requires_grad_() for name, t in _torch_weights(w).items()}
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = va.vector_attention(*leaves, torch.from_numpy(rel), tw)
    got = torch.autograd.grad(out, [*leaves, *tw.values()], torch.from_numpy(g))
    gq, gk, gv, grel, gw = va.vector_attention_backward_reference(
        *leaves, torch.from_numpy(rel), tw, torch.from_numpy(g), need_rel_grad=False)
    assert grel is None
    for a, c in zip(got, [gq, gk, gv, *[gw[name] for name in tw]]):
        assert torch.equal(a, c)
    with torch.no_grad():  # nothing to record: the forward alone
        assert torch.equal(va.vector_attention(*leaves, torch.from_numpy(rel), tw), out)
    # a rel that needs its gradient gets it
    rel_leaf = torch.from_numpy(rel).requires_grad_()
    out = va.vector_attention(*leaves, rel_leaf, tw)
    (g_rel,) = torch.autograd.grad(out, [rel_leaf], torch.from_numpy(g))
    want = va.vector_attention_backward_reference(*leaves, rel_leaf, tw, torch.from_numpy(g))[3]
    assert torch.equal(g_rel, want)


def test_kernel_gate_and_row_chunks():
    assert va.unsupported(64, 1024, 16, 512, torch.float32) is None
    assert va.unsupported(64, 4, 4, 512, torch.float32) is None
    assert "float32" in va.unsupported(2, 64, 16, 512, torch.bfloat16)
    assert "neighbours" in va.unsupported(2, 256, 129, 512, torch.float32)
    assert "multiple of 8" in va.unsupported(2, 64, 16, 100, torch.float32)
    assert "2**31" in va.unsupported(2 ** 16, 2 ** 12, 16, 64, torch.float32)
    for rows in (1, 255, 4096, 16320, 64 * 1024 * 16, 64 * 4 * 4):
        chunk = va.wgrad_chunk(rows)
        assert chunk % 8 == 0 and chunk >= 256 and -(-rows // chunk) <= va.WGRAD_CHUNKS
    with pytest.raises(ValueError, match="cpu or cuda"):
        q = torch.zeros(1, 2, 8, device="meta")
        va.vector_attention_fwd(q, torch.zeros(1, 2, 2, 8, device="meta"),
                                torch.zeros(1, 2, 2, 8, device="meta"),
                                torch.zeros(1, 2, 2, 3, device="meta"),
                                {n: torch.zeros(s, device="meta")
                                 for n, s in va.weight_shapes(8).items()})


def _block_case(seed=0, n=64, d_points=32, d_model=128, k=8):
    rs = np.random.RandomState(seed)
    xyz = rs.rand(2, n, 3).astype(np.float32)
    feats = (rs.randn(2, n, d_points) * 0.3).astype(np.float32)
    blk = jax_va.VectorAttentionBlock(d_model=d_model, k=k)
    params = jax.device_get(blk.init(jax.random.key(seed), jnp.asarray(xyz),
                                     jnp.asarray(feats))["params"])
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rs.randn(*np.shape(a)).astype(np.float32), params)
    ours = VectorAttentionBlock(d_points, d_model, k)
    convert.load_jax_params(ours, params)
    return xyz, feats, blk, params, ours


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "pallas_interpret"])
def test_block_matches_jax(monkeypatch, fused):
    """The block's output within 1e-5 and its parameter gradients within 1e-4
    of max(1, the largest value), against the JAX block on its XLA path and on
    its kernel path (the Pallas kernel in interpret mode)."""
    xyz, feats, blk, params, ours = _block_case()
    monkeypatch.setattr(jax_va, "FORCE_FUSED", fused)
    monkeypatch.setattr(jax_va, "INTERPRET", fused)

    def loss(p):
        out, _ = blk.apply({"params": p}, jnp.asarray(xyz), jnp.asarray(feats))
        return jnp.sum(out ** 2), out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    out, attn = ours(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert attn is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    names = [name for name, _ in ours.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad((out ** 2).sum(), list(ours.parameters()))))
    want_grads = convert.jax_to_state_dict(jax.device_get(jgrads), ours.state_dict())
    assert set(want_grads) == set(grads)
    for name, c in want_grads.items():
        scale = max(float(c.abs().max()), 1.0)
        np.testing.assert_allclose(grads[name].numpy() / scale, c.numpy() / scale, rtol=0,
                                   atol=1e-4, err_msg=name)


def test_block_state_dict_names_are_the_references():
    ours = VectorAttentionBlock(32, 64, 16)
    assert sorted(ours.state_dict()) == sorted([
        "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias", "w_qs.weight", "w_ks.weight",
        "w_vs.weight", "fc_delta.0.weight", "fc_delta.0.bias", "fc_delta.2.weight",
        "fc_delta.2.bias", "fc_gamma.0.weight", "fc_gamma.0.bias", "fc_gamma.2.weight",
        "fc_gamma.2.bias"])
    w = ours.chain_weights()
    assert w["wd1"] is ours.fc_delta[0].weight and w["bg2"] is ours.fc_gamma[2].bias
