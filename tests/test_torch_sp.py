"""The port's sequence parallelism (simple3dformer_tpu_torch/parallel/sp.py) on
the CPU: eight gloo ranks as (data=2, seq=4), spawned once for the file
(tests/_torch_model_parallel_worker.py), against the JAX package's replicated
single-device step, as tests/test_parallel.py:190 holds the JAX package's own
sequence-parallel step: PointTransformerCls(num_point=128, nblocks=1,
nneighbor=4, transformer_dim=16), one SGD step on 4 clouds of 128 points with
normals, each rank holding 32 points of 2 clouds. The loss, every gradient,
the updated parameters and the BatchNorm statistics are held to the JAX
test's bounds; the eval forward after the step to the port's unsplit model;
the bf16 route to the port's unsplit bf16 step.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_model_parallel_worker as MW
import _torch_parallel_worker as W
from simple3dformer_tpu.models.hengshuang import PointTransformerCls as JaxCls
from simple3dformer_tpu_torch.parallel import mesh
from simple3dformer_tpu_torch.parallel.sp import SequenceParallel
from simple3dformer_tpu_torch.train.loop import cross_entropy
from simple3dformer_tpu_torch.utils import convert

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_parallel.py:232
TOL = dict(rtol=5e-4, atol=5e-5)  # :238


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rs = np.random.RandomState(9)
    x = rs.randn(4, 128, 6).astype(np.float32)
    y = rs.randint(0, 5, size=(4,)).astype(np.int32)
    jm = JaxCls(**MW.SP_MODEL)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.key(2), jnp.asarray(x[:2])))
    pm = MW.sp_model()
    convert.load_jax_params(pm, variables["params"], variables["batch_stats"])
    inputs = {"sp_init": MW.state_of(pm), "sp_x": torch.from_numpy(x),
              "sp_y": torch.from_numpy(y)}
    case = tmp_path_factory.mktemp("sp")
    torch.save(inputs, case / "inputs.pt")
    W.spawn_ranks([os.path.join(W.REPO, "tests", "_torch_model_parallel_worker.py"), str(case),
                   "sp"], world=MW.WORLD)
    ranks = [torch.load(case / f"rank{r}.pt", weights_only=False) for r in range(MW.WORLD)]

    # tests/test_parallel.py:204's replicated single-device step
    tx = optax.sgd(MW.LR)

    def step(params, bstats, xb, yb):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": bstats}, xb, deterministic=False,
                                mutable=["batch_stats"])
            oh = jax.nn.one_hot(yb, out.shape[-1])
            loss = -jnp.mean(jnp.sum(oh * jax.nn.log_softmax(out.astype(jnp.float32)), -1))
            return loss, mut["batch_stats"]

        (loss, new_bs), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        upd, _ = tx.update(g, tx.init(params), params)
        return optax.apply_updates(params, upd), new_bs, loss, g

    p, bs, loss, g = jax.device_get(jax.jit(step)(variables["params"], variables["batch_stats"],
                                                  jnp.asarray(x), jnp.asarray(y)))
    like = inputs["sp_init"]
    return {"ranks": ranks, "inputs": inputs, "loss": float(loss),
            "state": convert.jax_to_state_dict(p, like, bs),
            "grads": convert.jax_to_state_dict(g, like)}


def test_sp_step_matches_replicated(runs):
    """Loss (rtol 1e-5), gradients, parameters and BatchNorm statistics (rtol
    5e-4, atol 5e-5) on every rank against the JAX replicated step."""
    for r in runs["ranks"]:
        np.testing.assert_allclose(float(r["loss"]), runs["loss"], **LOSS_TOL)
        for k, v in runs["grads"].items():
            np.testing.assert_allclose(r["grads"][k].numpy(), v.numpy(), **TOL,
                                       err_msg=f"grad {k}")
        for k, v in runs["state"].items():
            np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(), **TOL, err_msg=k)
        assert any(k.endswith("running_var") for k in runs["state"])


def test_sp_ranks_agree_and_eval(runs):
    """Every rank ends with the same state, bit for bit (the gradients are
    averaged over data x seq in one order); the eval forward after the step
    (running statistics, the points still split) against the unsplit model."""
    r0 = runs["ranks"][0]
    x = runs["inputs"]["sp_x"]
    for r in runs["ranks"]:
        for k, v in r0["state"].items():
            assert torch.equal(r["state"][k], v), k
    model = MW.sp_model()
    model.load_state_dict(r0["state"])
    model.eval()
    with torch.no_grad():
        want = model(x)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["eval"].numpy(), want[r["cols"]].numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_sp_bf16_route_matches_unsplit(runs):
    """The bf16 route (the in-kernel-gather chain on the all-gathered queries,
    each rank keeping its rows) against the port's unsplit bf16 step: the loss
    within bf16's 2e-3, each gradient within 2e-2 of the largest gradient
    (bf16 sums in another order; leaves whose gradient is zero but for
    rounding, such as the biases before a BatchNorm, are held to that
    scale too)."""
    inputs = runs["inputs"]
    x, y = inputs["sp_x"], inputs["sp_y"]
    model = MW.sp_model(torch.bfloat16)
    model.load_state_dict(inputs["sp_init"])
    model.train()
    names, params = zip(*model.named_parameters())
    loss = cross_entropy(model(x), y)
    want = dict(zip(names, torch.autograd.grad(loss, params)))
    scale = max(float(g.abs().max()) for g in want.values())
    for r in runs["ranks"]:
        got = r["bf16"]
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=2e-3)
        for k, v in want.items():
            assert float((got["grads"][k] - v).abs().max()) <= 2e-2 * scale, k


def test_sp_refuses_what_does_not_divide():
    """npoint and the point count must divide over the seq ranks."""
    layout = mesh.Layout(1, 3, "seq", 0, 0, None, None)
    with pytest.raises(ValueError, match="npoint 32 does not divide over 3"):
        SequenceParallel(MW.sp_model(), layout)
    layout = mesh.Layout(1, 4, "seq", 0, 1, None, None)
    sp = SequenceParallel(MW.sp_model(), layout)
    assert torch.equal(sp.shard(torch.arange(8)[None]), torch.tensor([[2, 3]]))
    with pytest.raises(ValueError, match="do not divide over 4"):
        sp.shard(torch.zeros(1, 6, 3))
    with pytest.raises(ValueError, match="'seq' layout"):
        SequenceParallel(MW.sp_model(), mesh.Layout(1, 4, "model", 0, 0, None, None))
