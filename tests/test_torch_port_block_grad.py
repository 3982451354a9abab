"""The port's block backwards (plain versions, and their autograd wiring) against
the JAX package's Pallas kernels in interpret mode, on the CPU.

Inputs, weights and the output cotangent are made with numpy from a seed and
handed to both sides; the port's weights are the same numbers in nn.Linear
layout ([out, in], the JAX kernels take [in, out]).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.kernels.vit_block import (fused_vit_block as jax_fused_vit_block,
                                                  fused_vit_block_train as jax_fused_vit_block_train)
from simple3dformer_tpu_torch.kernels import vit_block as vb

B, N, D, H, TILE = 3, 26, 128, 2, 104  # the JAX package's own gradient test shape
LINEAR = ("wqkv", "wproj", "w1", "w2")
# the JAX test's tolerances (tests/test_pallas_kernels.py:183-188); bf16: a
# last-bit difference in an f32 sum can round an intermediate to the
# neighbouring bf16 value, which then feeds later products
TOL = {"float32": (dict(rtol=1e-3, atol=1e-4), dict(rtol=3e-3, atol=3e-3)),
       "bfloat16": (dict(rtol=3e-2, atol=3e-2), dict(rtol=3e-2, atol=3e-2))}


def inputs(seed=0):
    """x, cotangent g, and the twelve weights in the JAX kernels' layout."""
    rs = np.random.RandomState(seed)
    x = (0.5 * rs.randn(B, N, D)).astype(np.float32)
    g = rs.randn(B, N, D).astype(np.float32)
    w = {}
    for name, shape in vb.weight_shapes(D).items():
        if name in ("ln1_s", "ln2_s"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name in LINEAR:
            v = rs.randn(*shape[::-1]) * shape[1] ** -0.5  # [in, out]
        else:
            v = 0.1 * rs.randn(*shape)
        w[name] = v.astype(np.float32)
    return x, g, w


def port_weights(w, requires_grad=False):
    return {k: torch.from_numpy(np.ascontiguousarray(v.T if k in LINEAR else v))
            .requires_grad_(requires_grad) for k, v in w.items()}


def jax_grads(fn, x, g, w, cdt):
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    gx, gw = jax.grad(lambda x, w: jnp.sum(fn(x, w, H, jnp.dtype(cdt), True, TILE) * g),
                      argnums=(0, 1))(jnp.asarray(x), jw)
    return np.asarray(gx), {k: np.asarray(v).T if k in LINEAR else np.asarray(v)
                            for k, v in gw.items()}


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["residual", "recompute"])
def test_plain_backwards_match_pallas_interpret(route, cdt):
    x, g, w = inputs()
    jax_fn = jax_fused_vit_block_train if route == "residual" else jax_fused_vit_block
    want_x, want_w = jax_grads(jax_fn, x, g, w, cdt)
    xt, gt, wt = torch.from_numpy(x), torch.from_numpy(g), port_weights(w)
    tcdt = getattr(torch, cdt)
    if route == "residual":
        y, res = vb.fused_vit_block_train_fwd(xt, wt, H, tcdt)
        assert {k: tuple(v.shape) for k, v in res.items()} == vb.residual_shapes(B, N, D, H)
        gx, gw = vb.fused_vit_block_train_bwd(xt, gt, wt, H, tcdt, res)
    else:
        gx, gw = vb.fused_vit_block_bwd(xt, gt, wt, H, tcdt)
    tol_x, tol_w = TOL[cdt]
    assert gx.dtype == xt.dtype and set(gw) == set(vb.WNAMES)
    np.testing.assert_allclose(gx.numpy(), want_x, **tol_x)
    for k in vb.WNAMES:
        assert gw[k].dtype == torch.float32
        np.testing.assert_allclose(gw[k].numpy(), want_w[k], err_msg=k, **tol_w)


@pytest.mark.parametrize("entry", ["fused_vit_block_train", "fused_vit_block"])
def test_autograd_functions_match_autograd_of_the_plain_forward(entry):
    """The plain backward against torch.autograd through vit_block_reference, f32,
    through the autograd Function a Block calls (its CPU path runs the plain
    versions, and counts no launch)."""
    x, g, w = inputs(seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    wt = port_weights(w, requires_grad=True)
    order = [xt] + [wt[k] for k in vb.WNAMES]
    want = torch.autograd.grad(vb.vit_block_reference(xt, wt, H), order, torch.from_numpy(g))
    counts = [getattr(vb, f).launches for f in ("fused_vit_block", "fused_vit_block_bwd",
                                                 "fused_vit_block_train_fwd",
                                                 "fused_vit_block_train_bwd")]
    y = getattr(vb, entry)(xt, wt, H)
    assert y.requires_grad
    got = torch.autograd.grad(y, order, torch.from_numpy(g))
    for name, a, b in zip(("x",) + vb.WNAMES, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
    assert counts == [getattr(vb, f).launches for f in (
        "fused_vit_block", "fused_vit_block_bwd", "fused_vit_block_train_fwd",
        "fused_vit_block_train_bwd")]


def test_training_forward_matches_forward_and_keeps_residuals():
    x, _, w = inputs(seed=2)
    xt, wt = torch.from_numpy(x), port_weights(w)
    y, res = vb.vit_block_train_reference(xt, wt, H)
    torch.testing.assert_close(y, vb.vit_block_reference(xt, wt, H), rtol=0, atol=0)
    # the residuals are the forward's intermediates: probabilities sum to one and
    # y follows from h1 and a1 alone
    torch.testing.assert_close(res["probs"].sum(-1), torch.ones(B, H, N))
    y2 = res["h1"] + vb._gelu_tanh(res["a1"]) @ wt["w2"].T + wt["b2"]
    torch.testing.assert_close(y, y2, rtol=1e-6, atol=1e-5)


def test_residual_backward_needs_residuals():
    x, g, w = inputs()
    with pytest.raises(ValueError, match="residuals"):
        vb.fused_vit_block_train_bwd(torch.from_numpy(x), torch.from_numpy(g), port_weights(w),
                                     H)
