"""The port's bf16 vector-attention route against the JAX package's, on the CPU:
the plain versions of the four bf16 kernels against the in-kernel-gather
Pallas kernels in interpret mode (``fused_vector_attention`` and the
residual-saving pair), the block's dispatch between the two pairs, the block
against the JAX block on its kernel route and on its XLA bf16 route, ``dense``
and BatchNorm at bf16 against flax, and ``PointTransformerCls`` at bf16
(forward, gradients, three SGD steps) against the JAX model from the same
converted parameters. Inputs are made with numpy.

Tolerances, each over an output's own largest value: both sides round the same
f32 values to bf16 at the same places, but f32 sums taken in another order can
put a value on the other side of a bf16 rounding boundary, a step of 2**-8 of
it; the JAX CPU gather VJP sums bf16 rows in bf16 where the port sums in f32.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from simple3dformer_tpu.kernels import vector_attention as jk
from simple3dformer_tpu.models.hengshuang import PointTransformerCls as JaxCls
from simple3dformer_tpu.models.hengshuang import TransitionDown as JaxTransitionDown
from simple3dformer_tpu.nn import layers as jax_layers
from simple3dformer_tpu.nn import vector_attention as jax_va
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import cross_entropy as jax_cross_entropy
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu_torch.kernels import vector_attention as va
from simple3dformer_tpu_torch.models.hengshuang import PointTransformerCls
from simple3dformer_tpu_torch.nn import layers
from simple3dformer_tpu_torch.nn.set_abstraction import Conv1x1
from simple3dformer_tpu_torch.nn import vector_attention as port_va
from simple3dformer_tpu_torch.train import optim
from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step
from simple3dformer_tpu_torch.utils import convert

BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _rel(got, want) -> float:
    """Error over the largest value of ``want`` (over 1 where that is below 1e-30)."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _inputs(n, seed, b=2, kk=8, d=128):
    """q, k_all, v_all, idx (every point's second neighbour a copy of its first),
    rel and g as numpy, and the weights in the JAX layout [in, out]."""
    rs = np.random.RandomState(seed)
    q, k_all, v_all = (rs.randn(b, n, d).astype(np.float32) * 0.5 for _ in range(3))
    idx = rs.randint(0, n, (b, n, kk)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]
    rel = rs.randn(b, n, kk, 3).astype(np.float32) * 0.3
    w = {name: (rs.randn(*s) * (s[0] ** -0.5 if len(s) == 2 else 0.1)).astype(np.float32)
         for name, s in [("wd1", (3, d)), ("bd1", (d,)), ("wd2", (d, d)), ("bd2", (d,)),
                         ("wg1", (d, d)), ("bg1", (d,)), ("wg2", (d, d)), ("bg2", (d,))]}
    g = rs.randn(b, n, d).astype(np.float32)
    return q, k_all, v_all, idx, rel, w, g


def _jax_args(q, k_all, v_all, idx, rel, w):
    bf = jnp.bfloat16
    return ([jnp.asarray(a, bf) for a in (q, k_all, v_all)] + [jnp.asarray(idx), jnp.asarray(rel, bf)]
            + [{k: jnp.asarray(v) for k, v in w.items()}])


def _port_args(q, k_all, v_all, idx, rel, w):
    return ([torch.from_numpy(a).to(BF) for a in (q, k_all, v_all)]
            + [torch.from_numpy(idx), torch.from_numpy(rel).to(BF)]
            + [{k: torch.from_numpy(np.ascontiguousarray(v.T if v.ndim == 2 else v))
                for k, v in w.items()}])


def _port_grads(grads) -> dict:
    gq, gk, gv, grel, gw = grads
    return {"gq": gq, "gk_all": gk, "gv_all": gv, "grel": grel, **gw}


def _jax_grads(gq, gk, gv, grel, gw) -> dict:
    return {"gq": gq, "gk_all": gk, "gv_all": gv, "grel": grel,
            **{k: np.asarray(a).T if np.ndim(a) == 2 else a for k, a in gw.items()}}


def _assert_close(got: dict, want: dict, tol: float, floor_one=("bg2",)):
    """Each output within ``tol`` of its own largest value; bg2's gradient, zero
    but for rounding (the softmax over K does not see a bias added to every
    neighbour's logit), within ``tol`` of max(1, it)."""
    for name, c in want.items():
        c = _f32(c)
        scale = max(float(np.abs(c).max()), 1.0 if name in floor_one else 1e-30)
        err = float(np.abs(_f32(got[name]) - c).max()) / scale
        assert err <= tol, (name, err)


# N = 64 and N = 50 (not a multiple of the TPU kernel's 32-row tile: its padded rows)
NS = [64, 50]
# the plain versions against the Pallas kernels, both at the TPU kernel's policy
KERNEL_TOL = 1e-2


@pytest.mark.parametrize("n", NS)
def test_plain_forward_and_recompute_backward_match_the_pallas_kernel(n):
    q, k_all, v_all, idx, rel, w, g = _inputs(n, seed=n)
    jargs, targs = _jax_args(q, k_all, v_all, idx, rel, w), _port_args(q, k_all, v_all, idx, rel, w)
    want = jk.fused_vector_attention(*jargs, 32, True)
    got = va.gather_attention_reference(*targs)
    assert got.dtype == BF and got.shape == (2, n, 128)
    _assert_close({"out": got}, {"out": want}, KERNEL_TOL)
    _, vjp = jax.vjp(lambda *a: jk.fused_vector_attention(*a, 32, True), *jargs)
    gq, gk, gv, _, grel, gw = vjp(jnp.asarray(g, jnp.bfloat16))
    grads = _port_grads(va.gather_attention_backward_reference(*targs, torch.from_numpy(g).to(BF)))
    assert all(grads[k].dtype == BF for k in ("gq", "gk_all", "gv_all", "grel"))
    assert all(grads[k].dtype == torch.float32 for k in va.WNAMES)
    _assert_close(grads, _jax_grads(gq, gk, gv, grel, gw), KERNEL_TOL)


@pytest.mark.parametrize("n", NS)
def test_plain_resid_pair_matches_the_pallas_kernels(n):
    """The four saves of ``_fused_fwd_res`` (x and hg_pre exact up to a rounding
    boundary, u and a rounded to bf16) and ``_fused_bwd_res`` from them."""
    q, k_all, v_all, idx, rel, w, g = _inputs(n, seed=n + 1)
    jargs, targs = _jax_args(q, k_all, v_all, idx, rel, w), _port_args(q, k_all, v_all, idx, rel, w)
    want_out, res = jk._fused_fwd_res(*jargs, 32, True)
    out, saves = va.gather_attention_resid_reference(*targs)
    _assert_close({"out": out}, {"out": want_out}, KERNEL_TOL)
    kk = idx.shape[-1]
    for name, jax_save in zip(va.RESIDUALS, res[3:]):
        assert saves[name].dtype == BF and saves[name].shape == (2, n * kk, 128)
        _assert_close({name: saves[name]}, {name: np.asarray(jax_save)[:, :n * kk]}, KERNEL_TOL)
    gq, gk, gv, _, grel, gw = jk._fused_bwd_res(32, True, res, jnp.asarray(g, jnp.bfloat16))
    grads = _port_grads(va.gather_attention_resid_backward_reference(
        targs[3], targs[4], targs[5], saves, torch.from_numpy(g).to(BF)))
    _assert_close(grads, _jax_grads(gq, gk, gv, grel, gw), KERNEL_TOL)


@pytest.mark.parametrize("n", NS)
def test_resid_backward_matches_the_recompute_backward(n):
    """Within 2e-2 of each output's largest value (bg2's gradient: of max(1, it)),
    the JAX package's own bound for the pair: u and a are rounded to bf16 in the
    saves."""
    q, k_all, v_all, idx, rel, w, g = _inputs(n, seed=n + 2)
    targs = _port_args(q, k_all, v_all, idx, rel, w)
    gt = torch.from_numpy(g).to(BF)
    _, saves = va.gather_attention_resid_reference(*targs)
    res = _port_grads(va.gather_attention_resid_backward_reference(targs[3], targs[4], targs[5],
                                                                   saves, gt))
    rec = _port_grads(va.gather_attention_backward_reference(*targs, gt))
    _assert_close(res, rec, 2e-2)


@pytest.mark.parametrize("n", NS)
def test_recompute_backward_from_a_forward_state_is_the_recompute_backward(n):
    """With ``state`` (the residual forward's saves), the plain recompute
    backward takes x and hg_pre as their bf16 values; on its own chain's saves
    it gives what it gives without them, bit for bit: x enters the backward
    only rounded to bf16, hg_pre only rounded or by its sign."""
    q, k_all, v_all, idx, rel, w, g = _inputs(n, seed=n + 3)
    targs = _port_args(q, k_all, v_all, idx, rel, w)
    gt = torch.from_numpy(g).to(BF)
    _, saves = va.gather_attention_resid_reference(*targs)
    got = _port_grads(va.gather_attention_backward_reference(*targs, gt, state=saves))
    want = _port_grads(va.gather_attention_backward_reference(*targs, gt))
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_gate_and_autograd_pairs():
    assert va.gather_unsupported(64, 1024, 16, 512, BF) is None
    assert "bfloat16" in va.gather_unsupported(2, 64, 16, 512, torch.float32)
    assert "neighbours" in va.gather_unsupported(2, 64, 129, 512, BF)
    assert "multiple of 8" in va.gather_unsupported(2, 64, 16, 100, BF)
    q, k_all, v_all, idx, rel, w, g = _inputs(20, seed=3, kk=5, d=32)
    targs = _port_args(q, k_all, v_all, idx, rel, w)
    leaves = [t.requires_grad_() for t in targs[:3]]
    ws = {k: t.requires_grad_() for k, t in targs[5].items()}
    gt = torch.from_numpy(g).to(BF)
    for resid in (True, False):
        out = va.gather_attention(*leaves, targs[3], targs[4], ws, resid)
        got = torch.autograd.grad(out, [*leaves, *ws.values()], gt)
        if resid:
            _, saves = va.gather_attention_resid_reference(*targs[:5], ws)
            want = va.gather_attention_resid_backward_reference(targs[3], targs[4], ws, saves, gt,
                                                                need_rel_grad=False)
        else:
            want = va.gather_attention_backward_reference(*targs[:5], ws, gt, need_rel_grad=False)
        for a, c in zip(got, [*want[:3], *[want[4][k] for k in ws]]):
            assert torch.equal(a, c)
    with torch.no_grad():  # nothing to record: the forward alone
        assert torch.equal(va.gather_attention(*leaves, targs[3], targs[4], ws),
                           va.gather_attention_reference(*targs[:5], ws))


def _block_case(seed=0, n=64, d_points=32, d_model=128, k=8):
    rs = np.random.RandomState(seed)
    xyz = rs.rand(2, n, 3).astype(np.float32)
    feats = (rs.randn(2, n, d_points) * 0.3).astype(np.float32)
    blk = jax_va.VectorAttentionBlock(d_model=d_model, k=k, dtype=jnp.bfloat16)
    params = jax.device_get(blk.init(jax.random.key(seed), jnp.asarray(xyz),
                                     jnp.asarray(feats))["params"])
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rs.randn(*np.shape(a)).astype(np.float32),
        params)
    ours = port_va.VectorAttentionBlock(d_points, d_model, k, dtype=BF)
    convert.load_jax_params(ours, params)
    return xyz, feats, blk, params, ours


def _block_run(blk, params, ours, xyz, feats):
    """(JAX output, JAX gradients as a state dict, port output, port gradients)
    of sum(out^2) in f32."""
    def loss(p):
        out, _ = blk.apply({"params": p}, jnp.asarray(xyz), jnp.asarray(feats))
        return jnp.sum(jnp.square(out.astype(jnp.float32))), out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    out, attn = ours(torch.from_numpy(xyz), torch.from_numpy(feats))
    # fc2's bf16 output plus the f32 features: f32 in both packages
    assert attn is None and out.dtype == torch.float32 and want.dtype == jnp.float32
    names = [name for name, _ in ours.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(out.float().square().sum(),
                                                list(ours.parameters()))))
    return want, convert.jax_to_state_dict(jax.device_get(jgrads), ours.state_dict()), out, grads


@pytest.mark.parametrize("route", ["resid", "recompute_env", "recompute_cap"])
def test_block_matches_the_jax_kernel_route(monkeypatch, route):
    """The bf16 block against the JAX block with FORCE_FUSED (the Pallas kernels
    in interpret mode): output and parameter gradients within KERNEL_TOL of each
    one's largest value (fc_gamma's last bias: of max(1, it)). Both packages take
    the residual-saving pair, or both the recompute pair under S3F_VA_RESID=0 or
    a cap the saves do not fit."""
    xyz, feats, blk, params, ours = _block_case()
    monkeypatch.setattr(jax_va, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_va, "INTERPRET", True)
    if route == "recompute_env":
        monkeypatch.setenv("S3F_VA_RESID", "0")
    if route == "recompute_cap":
        monkeypatch.setattr(jax_va, "_RESID_CAP_BYTES", 0)
        monkeypatch.setattr(port_va, "RESID_CAP_BYTES", 0)
    calls = {"resid": 0, "recompute": 0}

    def spy(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(va, "gather_attention_resid_bwd", spy(va.gather_attention_resid_bwd,
                                                              "resid"))
    monkeypatch.setattr(va, "gather_attention_bwd", spy(va.gather_attention_bwd, "recompute"))
    want, want_grads, out, grads = _block_run(blk, params, ours, xyz, feats)
    assert calls == ({"resid": 1, "recompute": 0} if route == "resid"
                     else {"resid": 0, "recompute": 1})
    _assert_close({"out": out}, {"out": want}, KERNEL_TOL)
    assert set(grads) == set(want_grads)
    _assert_close(grads, want_grads, KERNEL_TOL, floor_one=("fc_gamma.2.bias",))


def test_block_near_the_jax_xla_bf16_route(monkeypatch):
    """Against the JAX block's XLA route (flax Dense all in bf16: biases, ReLU
    and softmax too, the route the JAX package takes below N = 256): within
    5e-2 of the largest value, the JAX package's own bound between its two
    bf16 routes (tests/test_vector_attention_fused.py); the port computes the
    kernel route's tighter function."""
    xyz, feats, blk, params, ours = _block_case(seed=1)
    monkeypatch.setattr(jax_va, "FORCE_FUSED", False)
    want, _, out, _ = _block_run(blk, params, ours, xyz, feats)
    assert _rel(out, want) <= 5e-2


def test_dense_and_batchnorm_at_bf16_match_flax():
    """dense(dtype=bf16) against flax Dense(dtype=bf16) within one bf16 step of
    the largest output (the f32 sum inside the product in another order), its
    gradients f32; BatchNorm on a bf16 input returns f32, as flax's does."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 10, 48).astype(np.float32)
    fl = jax_layers.dense(32, dtype=jnp.bfloat16)
    params = jax.device_get(fl.init(jax.random.key(0), jnp.asarray(x))["params"])
    params = {"kernel": np.asarray(params["kernel"]),
              "bias": rs.randn(32).astype(np.float32) * 0.1}
    want = fl.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    ours = layers.dense(48, 32, dtype=BF)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(params["kernel"].T.copy()))
        ours.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x).to(BF)
    got = ours(xt)
    assert got.dtype == BF and ours.weight.dtype == torch.float32
    assert _rel(got, want) <= 2 ** -7
    got.float().sum().backward()
    assert ours.weight.grad.dtype == torch.float32
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = bn.init(jax.random.key(1), jnp.zeros((4, 10, 32)))
    want_bn, _ = bn.apply(variables, want, mutable=["batch_stats"])
    assert want_bn.dtype == jnp.float32
    got_bn = layers.BatchNorm(32)(got)
    assert got_bn.dtype == torch.float32
    np.testing.assert_allclose(got_bn.detach().numpy(), np.asarray(want_bn), rtol=0,
                               atol=2e-2 * float(np.abs(want_bn).max()))


# the JAX package's Hengshuang test size: 64 points, 2 blocks, 8 neighbours, D 64
N, KW = 64, dict(nblocks=2, nneighbor=8, transformer_dim=64)
LR = 0.01


@functools.cache
def _model_case():
    """The JAX bf16 model and its variables (params perturbed, statistics away
    from init), and three batches."""
    jm = JaxCls(num_point=N, num_class=40, input_dim=6, dtype=jnp.bfloat16, **KW)
    variables = jax.jit(jm.init)(jax.random.key(4), jnp.zeros((2, N, 6)))
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map(lambda a: (0.5 + rs.rand(*np.shape(a))).astype(np.float32),
                                   jax.device_get(variables["batch_stats"]))
    batches = []
    for i in range(3):
        x = rs.randn(4, N, 6).astype(np.float32)
        x[..., :3] = rs.rand(4, N, 3)
        batches.append({"x": x, "y": rs.randint(0, 40, 4).astype(np.int32)})
    return jm, params, stats, batches


def _port_model():
    jm, params, stats, batches = _model_case()
    pm = PointTransformerCls(N, 40, 6, dtype=BF, **KW)
    convert.load_jax_params(pm, params, stats)
    return pm


@pytest.fixture
def jax_kernel_route(monkeypatch):
    monkeypatch.setattr(jax_va, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_va, "INTERPRET", True)


@functools.cache
def _jax_run(bf16: bool):
    """The JAX model (kernel route) at bf16 or f32 from the same parameters:
    (eval logits of the first batch, train-mode gradients of its loss as a state
    dict, the losses of three jitted SGD steps, the state after them)."""
    jm, params, stats, batches = _model_case()
    if not bf16:
        jm = JaxCls(num_point=N, num_class=40, input_dim=6, **KW)
    pm = PointTransformerCls(N, 40, 6, **KW)
    x, y = (jnp.asarray(batches[0][k]) for k in ("x", "y"))
    logits = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x), np.float32)

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x, deterministic=False,
                          mutable=["batch_stats"])
        return jax_cross_entropy(out, y)

    grads = convert.jax_to_state_dict(jax.device_get(jax.jit(jax.grad(loss))(params)),
                                      pm.state_dict())
    tx = jax_optim.make_optimizer("SGD")
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                                jax.tree_util.tree_map(jnp.asarray, stats))
    jstep = jax_make_train_step(jm, tx, has_batch_stats=True, donate=False)
    losses = []
    for batch in batches:
        jstate, out = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, LR,
                            jax.random.key(1))
        losses.append(float(out["loss"]))
    after = convert.jax_to_state_dict(jax.device_get(jstate.params), pm.state_dict(),
                                      jax.device_get(jstate.batch_stats))
    return logits, grads, losses, after


def _spread(got: dict, want: dict, keys) -> float:
    """The largest error over ``keys`` as a share of the largest value of ``want``."""
    big = max(float(want[k].abs().max()) for k in keys)
    return max(float((got[k].double() - want[k].double()).abs().max()) for k in keys) / big


# Each stage of the bf16 model in train mode, fed the JAX model's own input to
# it, against the JAX stage: the stem fc1, every vector-attention block, every
# transition-down and the head. The JAX stage runs as its own flax module from
# the same parameter subtree (the Pallas kernels in interpret mode).
STAGES = ["fc1", "transformer1", "transition_downs.0", "transformers.0",
          "transition_downs.1", "transformers.1", "fc2"]


def _jax_stage(name):
    """(fn(params, xyz, feats) -> (xyz, out), params subtree as a tree under
    the model's root) of the JAX bf16 model's stage ``name`` in train mode;
    the head's fn mean-pools its input first, as the model does."""
    bf = jnp.bfloat16
    _, params, stats, _ = _model_case()
    p, key = params["backbone"], name.replace(".", "_")
    if name == "fc1":
        d1, d2 = jax_layers.dense(32, dtype=bf), jax_layers.dense(32, dtype=bf)

        def fn(q, xyz, x):
            h = d1.apply({"params": q["backbone"]["fc1_1"]}, x)
            return xyz, d2.apply({"params": q["backbone"]["fc1_2"]}, jax.nn.relu(h))
        return fn, {"backbone": {k: p[k] for k in ("fc1_1", "fc1_2")}}
    if name == "fc2":
        head = jax_layers.MlpHead(widths=(256, 64), n_out=40, dtype=bf)
        return (lambda q, xyz, f: (xyz, head.apply({"params": q["fc2"]}, jnp.mean(f, axis=1))),
                {"fc2": params["fc2"]})
    if name.startswith("transition"):
        i = int(name[-1])
        ch = 32 * 2 ** (i + 1)
        td = JaxTransitionDown(k=N // 4 ** (i + 1), nneighbor=KW["nneighbor"],
                               channels=(ch // 2 + 3, ch, ch), dtype=bf)

        def fn(q, xyz, f):
            out, _ = td.apply({"params": q["backbone"][key],
                               "batch_stats": stats["backbone"][key]},
                              xyz, f, deterministic=False, mutable=["batch_stats"])
            return out
        return fn, {"backbone": {key: p[key]}}
    blk = jax_va.VectorAttentionBlock(d_model=KW["transformer_dim"], k=KW["nneighbor"],
                                      dtype=bf)
    return (lambda q, xyz, f: (xyz, blk.apply({"params": q["backbone"][key]}, xyz, f)[0]),
            {"backbone": {key: p[key]}})


@functools.cache
def _stage_inputs():
    """Each stage's (xyz, feats) input in the JAX bf16 model's train-mode
    forward on the first batch."""
    x = _model_case()[3][0]["x"]
    xyz, feats, out = jnp.asarray(x[..., :3]), jnp.asarray(x), {}
    for name in STAGES:
        out[name] = (xyz, feats)
        fn, q = _jax_stage(name)
        xyz, feats = fn(q, xyz, feats)
    return out


def _torch(a) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(BF) if a.dtype == jnp.bfloat16 else t


def _zero_but_for_rounding(name: str) -> bool:
    """Leaves whose exact gradient is zero, so both packages return rounding
    noise there: the bias of a 1x1 conv before a train-mode BatchNorm (which
    subtracts the batch mean) and fc_gamma's last bias (the softmax over the
    neighbours does not see a bias added to every neighbour's logit)."""
    return name.endswith("fc_gamma.2.bias") or (".mlp_convs." in name and name.endswith("bias"))


# Stage outputs: both packages round the same values to bf16 at the same places;
# a flip of one bf16 rounding (an f32 sum in another order), or the f32
# BatchNorm statistics summed in another order, moves a few elements. Measured:
# the stem, the blocks and the head bit-equal; a transition-down 0.73% of its
# elements beyond 2**-10 of themselves and 2.9e-3 of the largest at most. A
# stage computing a product in f32 instead moves most elements (a
# transition-down: 86%, a block: 14%).
STAGE_FLIP_SHARE = 0.02
STAGE_TOL = 1e-2
# Parameter gradients: each leaf within 3e-2 of its own largest value. A bias
# gradient sums a bf16 cotangent over every row, rounded to bf16 (a 2**-8 step);
# measured 1.7e-2 (the stem's last bias), weights at most 3.1e-3. A
# transition-down computing in f32 moves its weight gradients by 0.23-0.52.
STAGE_GRAD_TOL = 3e-2


@pytest.mark.parametrize("stage", STAGES)
def test_point_transformer_cls_bf16_stages_match_jax_in_train_mode(jax_kernel_route, stage):
    """Each stage of the bf16 model in train mode against the JAX stage from the
    same input: its output dtype (bf16 after a Linear, f32 after a BatchNorm and
    after a block's residual onto f32 features), every Linear or 1x1 conv
    returning bf16 and every BatchNorm f32 inside it, its output, and the
    gradients of its parameters and of its input under one random cotangent;
    the tolerances above."""
    xyz, feats = _stage_inputs()[stage]
    fn, q = _jax_stage(stage)
    want, vjp = jax.vjp(lambda q, f: fn(q, xyz, f)[1], q, feats)
    cot = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    want_q, want_in = vjp(jnp.asarray(cot, want.dtype))

    pm = _port_model().train()
    mod = pm.get_submodule(stage if stage == "fc2" else "backbone." + stage)
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((m, o.dtype)))
             for m in mod.modules() if isinstance(m, (layers.Dense, Conv1x1, layers.BatchNorm))]
    tin = _torch(feats).requires_grad_()
    txyz = _torch(xyz)
    if stage == "fc1":
        got = mod(tin)
    elif stage == "fc2":
        got = mod(tin.mean(1))
    else:
        got = mod(txyz, tin)[1 if stage.startswith("transition") else 0]
    for h in hooks:
        h.remove()
    assert got.dtype == (BF if want.dtype == jnp.bfloat16 else torch.float32), got.dtype
    assert seen and all(dt == (torch.float32 if isinstance(m, layers.BatchNorm) else BF)
                        for m, dt in seen), seen
    w, o = _f32(want), _f32(got)
    err = np.abs(o - w)
    assert err.max() <= STAGE_TOL * np.abs(w).max(), err.max() / np.abs(w).max()
    flips = float((err > 2.0 ** -10 * np.abs(w) + 1e-6 * np.abs(w).max()).mean())
    assert flips <= STAGE_FLIP_SHARE, flips

    names = [name for name, _ in mod.named_parameters()]
    *grads, gin = torch.autograd.grad(
        (got.float() * torch.from_numpy(cot).to(got.dtype).float()).sum(),
        [*mod.parameters(), tin])
    assert gin.dtype == tin.dtype and _rel(gin, want_in) <= STAGE_TOL
    prefix = "fc2." if stage == "fc2" else f"backbone.{stage}."
    want_sd = convert.jax_to_state_dict(jax.device_get(want_q), pm.state_dict())
    assert set(want_sd) == {prefix + n for n in names}
    for name, g in zip(names, grads):
        wg = want_sd[prefix + name]
        assert g.dtype == torch.float32, name
        if _zero_but_for_rounding(name):  # noise of the same size on both sides
            assert float(g.abs().max()) <= 4 * float(wg.abs().max()), name
        else:
            assert _rel(g, wg) <= STAGE_GRAD_TOL, (name, _rel(g, wg))


# At the whole model, a bf16 model's gradients and steps depart from its own f32
# ones far beyond a rounding step: a bf16 conv before a train-mode BatchNorm
# rounds its output to 8 bits, and the BatchNorm divides out a spread that can
# be smaller than the mean, which scales that rounding up through every later
# stage. The JAX package's bf16 step departs from its f32 step by up to 38% of
# the largest gradient at this size, and the port's from the JAX package's by
# as much. So these model-level checks hold the wiring end to end (the stages in
# order, the loss on f32 logits, the SGD update on f32 parameters) inside that
# band: every leaf within BAND times the JAX package's own bf16-vs-f32 spread of
# the JAX bf16 result, and its worst departure from the JAX f32 result no larger
# than the JAX package's (measured: gradients 0.342 and 0.214 of the largest
# against a spread of 0.384; three-step changes 0.556 and 0.341 against 0.645).
# Each stage's precision policy is held by the stage test above, the eval logits
# to a bf16 step.
BAND = 2.0


def test_point_transformer_cls_bf16_forward_and_gradients_match_jax(jax_kernel_route):
    """Eval logits within one bf16 step (2**-8) of each JAX logit (the same bf16
    roundings: the measured error is 0); train-mode gradients within the band
    above, in f32."""
    jm, params, stats, batches = _model_case()
    pm = _port_model()
    x, y = batches[0]["x"], batches[0]["y"]
    want_logits, want, _, _ = _jax_run(True)
    _, witness, _, _ = _jax_run(False)
    got = pm.eval()(torch.from_numpy(x))
    assert got.dtype == BF
    err = np.abs(_f32(got) - want_logits)
    assert (err <= 2.0 ** -8 * np.abs(want_logits)).all(), err.max()
    pm.train()
    out = torch.nn.functional.cross_entropy(pm(torch.from_numpy(x)).float(),
                                            torch.from_numpy(y).long())
    names = [name for name, _ in pm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(out, list(pm.parameters()))))
    assert set(grads) == set(want) and all(g.dtype == torch.float32 for g in grads.values())
    jax_spread = _spread(want, witness, names)
    assert _spread(grads, want, names) <= BAND * jax_spread
    assert _spread(grads, witness, names) <= jax_spread


def test_point_transformer_cls_bf16_three_sgd_steps_match_jax(jax_kernel_route):
    """Three SGD steps at the recipe's lr 0.01 against the JAX package's jitted
    make_train_step at bf16: losses within 1e-2 relative (measured 8.4e-4); the
    parameters' three-step changes within the band above; the parameters f32
    throughout."""
    jm, params, stats, batches = _model_case()
    pm = _port_model()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    step = make_train_step(TrainState(pm, optim.make_optimizer(dict(pm.named_parameters()),
                                                               "SGD")))
    losses = [float(step({k: torch.from_numpy(v) for k, v in batch.items()}, LR)["loss"])
              for batch in batches]
    _, _, want_losses, want = _jax_run(True)
    _, _, _, witness = _jax_run(False)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-2)
    names = [name for name, _ in pm.named_parameters()]
    after = pm.state_dict()
    assert all(after[k].dtype == torch.float32 for k in names)

    def change(state):
        return {k: state[k].double() - before[k].double() for k in names}

    jax_spread = _spread(change(want), change(witness), names)
    assert _spread(change(after), change(want), names) <= BAND * jax_spread
    assert _spread(change(after), change(witness), names) <= jax_spread
