"""The port's Adam (the kernel's plain version, and the optimizer around it)
against the JAX package's Pallas Adam in interpret mode and its optax chains,
on the CPU. Parameters and gradients are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from simple3dformer_tpu.kernels.adam import fused_adam_pair, fused_adam_update
from simple3dformer_tpu.train.optim import apply_lr, make_optimizer as jax_make_optimizer
from simple3dformer_tpu.train.optim import scale_by_adam_bf16_nu as jax_bf16_nu
from simple3dformer_tpu_torch.kernels.adam import adam_reference, bias_corrections, fused_adam
from simple3dformer_tpu_torch.train.optim import Adam, make_optimizer

# the JAX package's own Adam tolerance (tests/test_pallas_kernels.py:290-291)
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)


def tree(rs):
    return {"big": rs.randn(700, 128).astype(np.float32),
            "nested": {"w": rs.randn(513, 130).astype(np.float32),
                       "b": rs.randn(7).astype(np.float32)}}


def flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def grads_like(rs, params):
    return jax.tree_util.tree_map(lambda p: (1e-2 * rs.randn(*p.shape)).astype(np.float32),
                                  params)


def test_plain_adam_matches_fused_adam_update_interpret():
    rs = np.random.RandomState(0)
    params = tree(rs)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    mu = jax.tree_util.tree_map(jnp.zeros_like, jp)
    nu = jax.tree_util.tree_map(jnp.zeros_like, jp)
    leaves = {k: [torch.from_numpy(v.copy()), torch.zeros(v.shape), torch.zeros(v.shape)]
              for k, v in flat(params).items()}
    for step in (1, 2):
        g = grads_like(rs, params)
        jp, mu, nu = fused_adam_update(jp, jax.tree_util.tree_map(jnp.asarray, g), mu, nu,
                                       jnp.asarray(step, jnp.int32), 1e-3, interpret=True)
        fused_adam([(*leaves[k], torch.from_numpy(v)) for k, v in flat(g).items()], 1e-3, step)
        for name, want in (("p", jp), ("m", mu), ("v", nu)):
            i = "pmv".index(name)
            for k, v in flat(jax.device_get(want)).items():
                np.testing.assert_allclose(leaves[k][i].numpy(), v, err_msg=f"{name} {k}",
                                           **ADAM_TOL)


def test_masked_adam_matches_fused_adam_pair():
    rs = np.random.RandomState(1)
    params = {"backbone": {"w": rs.randn(600, 140).astype(np.float32)},
              "head": {"w": rs.randn(520, 133).astype(np.float32),
                       "b": rs.randn(5).astype(np.float32)}}
    mask = {"backbone": {"w": False}, "head": {"w": True, "b": True}}
    tx, update_fn = fused_adam_pair(trainable_mask=mask, interpret=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in flat(params).items()}
    opt = Adam(tp, trainable=flat(mask))
    assert set(opt.mu) == {"head.w", "head.b"}  # a frozen leaf carries no state
    assert st["mu"]["backbone"]["w"].size == 0
    frozen = tp["backbone.w"].detach().clone()
    for _ in range(2):
        g = grads_like(rs, params)
        jp, st = update_fn(jax.tree_util.tree_map(jnp.asarray, g), st, jp, 3e-3)
        opt.step({k: torch.from_numpy(v) for k, v in flat(g).items()}, 3e-3)
        assert torch.equal(tp["backbone.w"].detach(), frozen)  # byte-identical
        for k, v in flat(jax.device_get(jp)).items():
            np.testing.assert_allclose(tp[k].detach().numpy(), v, err_msg=k, **ADAM_TOL)
    assert opt.count == int(st["count"]) == 2


def test_weight_decay_matches_optax_chain():
    """L2 added to the gradient before Adam, as torch.optim.Adam(weight_decay)."""
    rs = np.random.RandomState(2)
    params = {"w": rs.randn(64, 33).astype(np.float32), "b": rs.randn(33).astype(np.float32)}
    tx = jax_make_optimizer("Adam", weight_decay=0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp, "Adam", weight_decay=0.05)
    for _ in range(3):
        g = grads_like(rs, params)
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, apply_lr(upd, 1e-2))
        opt.step({k: torch.from_numpy(v) for k, v in g.items()}, 1e-2)
    for k, v in jax.device_get(jp).items():
        np.testing.assert_allclose(tp[k].detach().numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_bf16_nu_matches_jax():
    rs = np.random.RandomState(3)
    params = {"w": rs.randn(96, 40).astype(np.float32)}
    tx = jax_bf16_nu()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {"w": torch.nn.Parameter(torch.from_numpy(params["w"].copy()))}
    opt = make_optimizer(tp, "Adam", bf16_nu=True)
    assert opt.nu["w"].dtype == torch.bfloat16
    for _ in range(3):
        g = grads_like(rs, params)
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, apply_lr(upd, 1e-3))
        opt.step({"w": torch.from_numpy(g["w"])}, 1e-3)
    np.testing.assert_allclose(tp["w"].detach().numpy(), np.asarray(jp["w"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(opt.nu["w"].float().numpy(),
                                  np.asarray(st["nu"]["w"].astype(jnp.float32)))


def test_missing_gradient_is_a_zero_gradient():
    p = torch.randn(10)
    m, v = 0.1 * torch.randn(10), torch.rand(10)
    got = [p.clone(), m.clone(), v.clone()]
    fused_adam([(*got, None)], 1e-2, 4)
    want = adam_reference(p, m, v, torch.zeros(10), 1e-2, 4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_runs_the_plain_version_and_counts_nothing():
    before = fused_adam.launches
    p, g = torch.randn(5), torch.randn(5)
    fused_adam([(p, torch.zeros(5), torch.zeros(5), g)], 1e-3, 1)
    assert fused_adam.launches == before
    one = np.float32(1.0)
    assert bias_corrections(1) == (float(one - np.float32(0.9)), float(one - np.float32(0.999)))


def test_optimizer_state_roundtrip_and_refusals():
    tp = {"a": torch.nn.Parameter(torch.randn(4)), "b": torch.nn.Parameter(torch.randn(3))}
    opt = make_optimizer(tp, trainable_mask={"a": True, "b": False})
    opt.step({"a": torch.ones(4)}, 1e-3)
    other = make_optimizer(tp, trainable_mask={"a": True, "b": False})
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and torch.equal(other.mu["a"], opt.mu["a"])
    sgd = make_optimizer(tp, "SGD", trainable_mask={"a": True, "b": False})
    sgd.step({"a": torch.ones(4)}, 1e-3)
    other_sgd = make_optimizer(tp, "SGD", trainable_mask={"a": True, "b": False})
    other_sgd.load_state_dict(sgd.state_dict())
    assert other_sgd.count == 1 and set(other_sgd.trace) == {"a"}
    assert torch.equal(other_sgd.trace["a"], sgd.trace["a"])
    with pytest.raises(KeyError):
        other.load_state_dict(sgd.state_dict())
    with pytest.raises(ValueError):
        make_optimizer(tp, "Lion")
