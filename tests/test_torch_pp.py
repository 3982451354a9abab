"""The port's pipeline parallelism (simple3dformer_tpu_torch/parallel/pp.py) on
the CPU: eight gloo ranks as (data=2, stage=4), spawned once for the file
(tests/_torch_model_parallel_worker.py), against the JAX package's sequential
block stack from the same converted blocks, at tests/test_parallel.py:282-335's
shapes and bounds: the forward of 8 blocks of width 32 in 4 stages over 5
microbatches, the gradients of 4 blocks through the reverse pipeline, and one
SGD step of a dp x pp train step (each data rank streaming its columns of
two microbatches).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_model_parallel_worker as MW
import _torch_parallel_worker as W
from simple3dformer_tpu.nn.layers import Block as JaxBlock
from simple3dformer_tpu_torch.parallel import pp
from simple3dformer_tpu_torch.utils import convert

FWD_TOL = dict(rtol=2e-5, atol=2e-6)  # tests/test_parallel.py:298
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)  # :327
DIM = MW.PP_DIM


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked_blocks(key, depth, heads, n_tok):
    """tests/test_parallel.py:247's depth-stacked flax blocks and their block_fn."""
    blk = JaxBlock(num_heads=heads)
    x0 = jnp.zeros((2, n_tok, DIM))
    per = [blk.init(k, x0)["params"] for k in jax.random.split(key, depth)]
    stacked = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *per)
    return stacked, per, lambda bp, x: blk.apply({"params": bp}, x)


def _seq_apply(block_fn, stacked, x):
    h, _ = jax.lax.scan(lambda hh, bp: (block_fn(bp, hh), None), x, stacked)
    return h


def _port_states(per, heads):
    out = []
    for params in per:
        blk = MW.block_stack(1, heads)[0]
        convert.load_jax_params(blk, jax.device_get(params))
        out.append(MW.state_of(blk))
    return out


def _jax_block_grads(g_tree, i, like):
    """Block i's gradients of a depth-stacked gradient tree, in port names."""
    return convert.jax_to_state_dict(
        jax.device_get(jax.tree_util.tree_map(lambda leaf: leaf[i], g_tree)), like)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rs = np.random.RandomState(9)
    fwd, fwd_per, fwd_fn = _stacked_blocks(jax.random.key(1), 8, 4, 6)
    grad, grad_per, grad_fn = _stacked_blocks(jax.random.key(2), 4, 2, 5)
    dp, dp_per, dp_fn = _stacked_blocks(jax.random.key(3), 4, 2, 5)
    inputs = {"pp_fwd_init": _port_states(fwd_per, 4), "pp_grad_init": _port_states(grad_per, 2),
              "pp_dp_init": _port_states(dp_per, 2),
              "pp_fwd_x": rs.randn(5, 2, 6, DIM).astype(np.float32),
              "pp_grad_x": rs.randn(3, 2, 5, DIM).astype(np.float32),
              "pp_dp_x": rs.randn(8, 5, DIM).astype(np.float32),
              "pp_dp_y": rs.randn(8, DIM).astype(np.float32)}
    case = tmp_path_factory.mktemp("pp")
    torch.save({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in inputs.items()}, case / "inputs.pt")
    W.spawn_ranks([os.path.join(W.REPO, "tests", "_torch_model_parallel_worker.py"), str(case),
                   "pp"], world=MW.WORLD)
    ranks = [torch.load(case / f"rank{r}.pt", weights_only=False) for r in range(MW.WORLD)]

    want = {"forward": np.asarray(jax.vmap(lambda x: _seq_apply(fwd_fn, fwd, x))(
        jnp.asarray(inputs["pp_fwd_x"])))}
    xs = jnp.asarray(inputs["pp_grad_x"])
    g = jax.grad(lambda p: jnp.sum(jax.vmap(lambda x: _seq_apply(grad_fn, p, x))(xs) ** 2))(grad)
    like = inputs["pp_grad_init"][0]
    want["grads"] = [_jax_block_grads(g, i, like) for i in range(4)]

    x, y = jnp.asarray(inputs["pp_dp_x"]), jnp.asarray(inputs["pp_dp_y"])

    def seq_loss(p):  # tests/test_parallel.py:364's sequential loss
        out = jax.vmap(lambda xx: _seq_apply(dp_fn, p, xx))(x.reshape(2, 4, 5, DIM))
        return jnp.mean((out.reshape(8, 5, DIM)[:, 0] - y) ** 2)

    loss, g = jax.value_and_grad(seq_loss)(dp)
    new = jax.tree_util.tree_map(lambda p, gg: p - MW.LR * gg, dp, g)
    want["dp_loss"] = float(loss)
    want["dp_params"] = [_jax_block_grads(new, i, like) for i in range(4)]
    return {"ranks": ranks, "want": want}


def test_pp_forward_matches_sequential(runs):
    """Every rank holds the 8-block stack's outputs for all 5 microbatches."""
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["forward"].numpy(), runs["want"]["forward"], **FWD_TOL)


def test_pp_grads_match_sequential(runs):
    """Each stage's block gradients through the reverse pipeline (autograd
    through the ring shift) against jax.grad of the sequential stack."""
    seen = set()
    for r in runs["ranks"]:
        for i, grads in r["grads"].items():
            seen.add(i)
            for k, v in runs["want"]["grads"][i].items():
                np.testing.assert_allclose(grads[k].numpy(), v.numpy(), **GRAD_TOL,
                                           err_msg=f"block {i}: {k}")
    assert seen == {0, 1, 2, 3}


def test_pp_dp_composed_train_step(runs):
    """(data=2, stage=4): the loss of one SGD step over the pipelined stack
    (tests/test_parallel.py's bound, rtol 1e-5) and the updated blocks,
    against the sequential replicated step."""
    for r in runs["ranks"]:
        np.testing.assert_allclose(float(r["dp"]["loss"]), runs["want"]["dp_loss"], rtol=1e-5)
        for name, v in r["dp"]["params"].items():
            i, key = name.split(".", 1)
            np.testing.assert_allclose(v.numpy(), runs["want"]["dp_params"][int(i)][key].numpy(),
                                       **GRAD_TOL, err_msg=name)


def test_stage_split_and_microbatches():
    """Contiguous stages (stage s holds blocks [s d/S, (s+1) d/S)), their
    inverse, the microbatch reshapes, and the errors where a size does not
    divide."""
    assert pp.split_stages(list(range(12)), 4) == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    assert pp.merge_stages(pp.split_stages(list(range(8)), 2)) == list(range(8))
    x = torch.arange(24.).reshape(8, 3)
    mb = pp.to_microbatches(x, 4)
    assert mb.shape == (4, 2, 3) and torch.equal(pp.from_microbatches(mb), x)
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        pp.split_stages(list(range(8)), 3)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pp.to_microbatches(x, 3)
    # one stage: the stack itself
    blocks = MW.block_stack(2, 2)
    xs = torch.randn(3, 2, 5, DIM)
    with torch.no_grad():
        want = torch.stack([pp.run_stage(blocks, xx) for xx in xs])
        assert torch.equal(pp.pipeline_apply(blocks, xs, None), want)
