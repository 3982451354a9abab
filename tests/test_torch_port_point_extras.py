"""The port's other point modules against the JAX package's, on the CPU: the
PointNet++ RelPos and MSG set abstractions (MSG with ball and kNN grouping,
its centres from JAX's random FPS starts passed in as ``seed_idx``),
``PointEmbed`` and its parts, and ``BNReLUDense`` / ``PosEmbedMLP``.

Each module runs in train mode (batch statistics, their running update) from
parameters drawn with numpy from the JAX modules' initializers and perturbed
(tests/_torch_port_numpy_init.py), carried across by utils/convert.py. Its outputs,
the gradients of sum(out * cotangent) with respect to every parameter and to
the point features (each leaf to its own largest magnitude; a leaf whose
gradient is zero in exact arithmetic, a per-channel constant just ahead of a
train-mode BatchNorm, to the module's largest gradient), and the new running statistics are held to the JAX
module's. Inputs are made with numpy from a seed. The JAX references are
computed once a module (``functools.cache``) and jitted.
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.nn import point_embed as jpe
from simple3dformer_tpu.nn import set_abstraction as jsa
from simple3dformer_tpu.ops import pointops as jops
from simple3dformer_tpu_torch.nn import point_embed as ppe
from simple3dformer_tpu_torch.nn import set_abstraction as psa
from simple3dformer_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params

from _torch_port_numpy_init import numpy_variables

B, N, D = 2, 128, 3  # D: the point features' width (normals, as PointNet++'s MSG takes them)
RTOL = 2e-5  # of the largest magnitude: one module in f32, sums in another order
# a per-channel constant ahead of a train-mode BatchNorm: zero gradient in
# exact arithmetic, rounding residue on both sides
ZERO_GRAD = re.compile(r"(mlp_convs\.\d+|conv_blocks\.\d+\.\d+|pos_embeds\.\d+\.fc2)\.bias$")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed=0):
    rs = np.random.RandomState(seed)
    return rs.rand(B, N, 3).astype(np.float32), rs.randn(B, N, D).astype(np.float32)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_reference(jmod, args, kwargs, seed):
    """Init, perturb and run the flax module in train mode; the vjp of
    sum(feats * cot) for the parameters and the features (args[-1])."""
    jargs = [jnp.asarray(a) for a in args]
    params, stats = numpy_variables(jmod, *jargs, seed=seed, scale=0.05, **kwargs)

    def f(p, feats):
        (xyz_out, out), mut = jmod.apply({"params": p, "batch_stats": stats}, *jargs[:-1], feats,
                                         deterministic=False, mutable=["batch_stats"], **kwargs)
        return out, (xyz_out, mut["batch_stats"])

    @jax.jit
    def run(p, feats, cot):
        out, vjp, aux = jax.vjp(f, p, feats, has_aux=True)
        return (out, aux) + vjp(cot)

    cot = np.random.RandomState(seed + 3).randn(
        *jax.eval_shape(f, params, jargs[-1])[0].shape).astype(np.float32)
    out, (xyz_out, new_stats), g_params, g_feats = jax.device_get(
        run(params, jargs[-1], jnp.asarray(cot)))
    return dict(params=params, stats=stats, out=np.asarray(out), xyz=np.asarray(xyz_out),
                new_stats=new_stats, g_params=g_params, g_feats=np.asarray(g_feats), cot=cot)


def check_against(pmod, ref, args, **kwargs):
    load_jax_params(pmod, ref["params"], ref["stats"])
    pmod.train()
    targs = [torch.from_numpy(a) for a in args]
    targs[-1].requires_grad_(True)
    xyz_out, out = pmod(*targs, **kwargs)
    assert rel_err(out.detach(), ref["out"]) < RTOL
    np.testing.assert_array_equal(xyz_out.detach().numpy(), ref["xyz"])
    (out * torch.from_numpy(ref["cot"])).sum().backward()
    assert rel_err(targs[-1].grad, ref["g_feats"]) < RTOL
    sd = dict(pmod.named_parameters())
    want = jax_to_state_dict(ref["g_params"], pmod.state_dict())
    assert set(want) == set(sd)
    top = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        if ZERO_GRAD.search(k):
            assert float((sd[k].grad - g).abs().max()) < RTOL * top, k
        else:
            assert rel_err(sd[k].grad, g) < RTOL, k
    for k, v in jax_to_state_dict({}, pmod.state_dict(), ref["new_stats"]).items():
        assert rel_err(pmod.state_dict()[k], v) < 1e-6, k


@functools.cache
def relpos_reference():
    args = inputs(1)
    jmod = jsa.PointNetSetAbstractionRelPos(npoint=32, radius=0.0, nsample=8, mlp=(16, 16, 32),
                                            knn=True)
    return args, jax_reference(jmod, args, {}, 10)


def test_relpos_matches_jax():
    args, ref = relpos_reference()
    pmod = psa.PointNetSetAbstractionRelPos(32, 0.0, 8, 3 + D, [16, 16, 32], knn=True)
    assert sorted(k for k in pmod.state_dict() if "pos_embeds" in k)[:2] == [
        "pos_embeds.0.fc1.bias", "pos_embeds.0.fc1.weight"]
    check_against(pmod, ref, args)


MSG = dict(radius_list=(0.15, 0.25, 0.4), nsample_list=(4, 8, 16),
           mlp_list=((8, 8, 16), (16, 16, 32), (16, 24, 32)))


@functools.cache
def msg_reference(knn):
    xyz, feats = inputs(2)
    seed_idx = np.array(jops.farthest_point_sample(jnp.asarray(xyz), 32, jax.random.key(5)))
    assert seed_idx[:, 0].tolist() != [0, 0]  # random starts
    jmod = jsa.PointNetSetAbstractionMsg(npoint=32, knn=knn, **MSG)
    return (xyz, feats), seed_idx, jax_reference(jmod, (xyz, feats),
                                                 {"seed_idx": jnp.asarray(seed_idx)}, 20)


@pytest.mark.parametrize("knn", [False, True], ids=["ball", "knn"])
def test_msg_matches_jax(knn):
    args, seed_idx, ref = msg_reference(knn)
    pmod = psa.PointNetSetAbstractionMsg(32, MSG["radius_list"], MSG["nsample_list"], D,
                                         MSG["mlp_list"], knn=knn)
    assert "conv_blocks.2.1.weight" in pmod.state_dict()
    assert tuple(pmod.state_dict()["bn_blocks.1.0.running_var"].shape) == (16,)
    check_against(pmod, ref, args, seed_idx=torch.from_numpy(seed_idx))


def test_msg_draws_its_centres_from_the_generator():
    xyz, feats = (torch.from_numpy(a) for a in inputs(3))
    pmod = psa.PointNetSetAbstractionMsg(16, (0.2,), (8,), D, ((8,),)).eval()
    a = pmod(xyz, feats, sample_generator=torch.Generator().manual_seed(4))[0]
    b = pmod(xyz, feats, sample_generator=torch.Generator().manual_seed(4))[0]
    c = pmod(xyz, feats)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c[:, 0], xyz[:, 0], rtol=0, atol=0)  # no generator: start 0


@functools.cache
def point_embed_reference():
    x = np.random.RandomState(4).rand(B, N, 3).astype(np.float32)
    jmod = jpe.PointEmbed(embed_dim=64, npoint=32, nsample=8)
    return (x,), jax_reference(jmod, (x,), {}, 30)


def test_point_embed_matches_jax():
    args, ref = point_embed_reference()
    pmod = ppe.PointEmbed(64, 3, npoint=32, nsample=8)
    assert tuple(pmod.state_dict()["conv1.conv.weight"].shape) == (64, 3, 1)
    assert "conv1.conv.bias" not in pmod.state_dict()  # bias-free, as the reference's
    check_against(pmod, ref, args)


@pytest.mark.parametrize("part", ["bnrelu_dense", "pos_embed_mlp", "local_op"])
def test_parts_match_jax(part):
    rs = np.random.RandomState(7)
    x = rs.randn(B, 16, 8, 12).astype(np.float32)
    if part == "bnrelu_dense":
        jmod, pmod = jsa.BNReLUDense(24), psa.BNReLUDense(12, 24)
    elif part == "pos_embed_mlp":
        x = x[..., :3]
        jmod, pmod = jsa.PosEmbedMLP(24), psa.PosEmbedMLP(24)
    else:
        jmod, pmod = jpe.LocalOp(24), ppe.LocalOp(12, 24)
    params, stats = numpy_variables(jmod, jnp.asarray(x), seed=8, scale=0.05)
    load_jax_params(pmod, params, stats)
    pmod.train()
    if not stats:
        want = jmod.apply({"params": params}, jnp.asarray(x))
    else:
        want, _ = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             deterministic=False, mutable=["batch_stats"])
    assert rel_err(pmod(torch.from_numpy(x)).detach(), want) < RTOL
