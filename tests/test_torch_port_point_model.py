"""The port's point modules and the 3DViT point model against the JAX
package's, on the CPU: flax-exact BatchNorm, set abstraction, feature
propagation, TransitionUp and PointViT, in train and eval mode, with the
weights and batch statistics carried across by utils/convert.py."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from simple3dformer_tpu.models import point_vit as jpv
from simple3dformer_tpu.models.hengshuang import TransitionUp as JaxTransitionUp
from simple3dformer_tpu.nn import set_abstraction as jsa
from simple3dformer_tpu_torch.models import point_vit as ppv
from simple3dformer_tpu_torch.models.hengshuang import TransitionUp
from simple3dformer_tpu_torch.models.registry import has_lwf_pathway, make_point_model
from simple3dformer_tpu_torch.nn.layers import BatchNorm
from simple3dformer_tpu_torch.nn.set_abstraction import (PointNetFeaturePropagation,
                                                         PointNetSetAbstraction)
from simple3dformer_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5  # one module, f32 sums in another order


def cloud(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def perturbed(tree, seed, scale=0.05):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(tree))


def positive_stats(tree, seed):
    """Batch statistics away from their init (variances positive)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.5 + rs.rand(*np.shape(a))).astype(np.float32), jax.device_get(tree))


def run_both(jmod, pmod, args, train, seed=0):
    """Init the flax module, carry its (perturbed) variables across, and run both.
    Returns (port outputs, JAX outputs, port state dict, JAX new batch stats)."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    variables = jmod.init(jax.random.key(seed), *jargs)
    params = perturbed(variables["params"], seed + 1)
    stats = positive_stats(variables.get("batch_stats", {}), seed + 2)
    load_jax_params(pmod, params, stats)
    pmod.train(train)
    if train:
        jout, mut = jmod.apply({"params": params, "batch_stats": stats}, *jargs,
                               deterministic=False, mutable=["batch_stats"])
        new_stats = mut["batch_stats"]
    else:
        jout = jmod.apply({"params": params, "batch_stats": stats}, *jargs, deterministic=True)
        new_stats = stats
    pout = pmod(*[None if a is None else torch.from_numpy(a) for a in args])
    return pout, jout, new_stats


def assert_close_tree(pout, jout):
    pout = pout if isinstance(pout, tuple) else (pout,)
    jout = jout if isinstance(jout, tuple) else (jout,)
    for a, b in zip(pout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=ATOL)


def assert_stats(pmod, new_stats):
    want = jax_to_state_dict({}, pmod.state_dict(), jax.device_get(new_stats))
    assert want
    got = pmod.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(2, 64, 5), (3, 10, 4, 7)])
def test_batchnorm_matches_flax(shape, train):
    x = 3.0 + 2.0 * cloud(20, *shape)
    c = shape[-1]
    jbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9)
    variables = jbn.init(jax.random.key(0), jnp.asarray(x))
    scale, bias = 1.0 + 0.1 * cloud(21, c), 0.1 * cloud(22, c)
    mean, var = cloud(23, c), 0.5 + np.abs(cloud(24, c))
    jvars = {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean, "var": var}}
    bn = BatchNorm(c).train(train)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    g = cloud(25, *shape)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))

    def f(xj):
        return jbn.apply(jvars, xj, mutable=["batch_stats"])

    jy, mut = f(jnp.asarray(x))
    _, vjp = jax.vjp(lambda xj: f(xj)[0], jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0, atol=1e-4)
    new = mut["batch_stats"] if train else jvars["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]), rtol=1e-5)
    assert int(bn.num_batches_tracked) == int(train)


def test_max_over_neighbours_splits_the_gradient_among_ties_as_jax():
    x = np.array([[[1.0, 2.0], [1.0, 0.0], [0.5, 2.0]]], np.float32)  # ties in both columns
    (jg,) = jax.grad(lambda a: jnp.sum(jnp.max(a, axis=1) * jnp.array([1.0, 3.0])),
                     argnums=(0,))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad((xt.amax(1) * torch.tensor([1.0, 3.0])).sum(), xt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("npoint", [64, 16])
def test_set_abstraction_matches_jax(npoint, train):
    jmod = jsa.PointNetSetAbstraction(npoint=npoint, radius=0.0, nsample=8, mlp=[16, 24],
                                      knn=True)
    pmod = PointNetSetAbstraction(npoint, 0.0, 8, 3 + 5, [16, 24], knn=True)
    pout, jout, new_stats = run_both(jmod, pmod, [cloud(26, 2, 64, 3), cloud(27, 2, 64, 5)],
                                     train)
    assert_close_tree(pout, jout)
    assert_stats(pmod, new_stats)


@pytest.mark.parametrize("train", [True, False])
def test_feature_propagation_matches_jax(train):
    jmod = jsa.PointNetFeaturePropagation(mlp=(16, 8))
    pmod = PointNetFeaturePropagation(4 + 6, (16, 8))
    args = [cloud(28, 2, 40, 3), cloud(29, 2, 10, 3), cloud(30, 2, 40, 4), cloud(31, 2, 10, 6)]
    pout, jout, new_stats = run_both(jmod, pmod, args, train)
    assert_close_tree(pout, jout)
    assert_stats(pmod, new_stats)
    assert tuple(pmod.mlp_convs[0].weight.shape) == (16, 10, 1)  # Conv1d layout


@pytest.mark.parametrize("train", [True, False])
def test_transition_up_matches_jax(train):
    jmod = JaxTransitionUp(dim_out=12)
    pmod = TransitionUp(20, 9, 12)
    args = [cloud(32, 2, 16, 3), cloud(33, 2, 16, 20), cloud(34, 2, 64, 3), cloud(35, 2, 64, 9)]
    pout, jout, new_stats = run_both(jmod, pmod, args, train)
    assert_close_tree(pout, jout)
    assert_stats(pmod, new_stats)
    assert "fc1.0.weight" in pmod.state_dict() and "fc1.2.running_var" in pmod.state_dict()


N, B, K, IN_DIM = 64, 2, 8, 22


@pytest.fixture(scope="module")
def point_models():
    """(variant, task) -> (JAX model, port model, input, params, batch stats),
    each pair built once in this module. Every call loads the (perturbed)
    variables into the port's model afresh, so a train-mode run before it
    leaves nothing behind."""
    built = {}

    def get(variant, task, seed=3):
        if (variant, task) not in built:
            jm = jpv.PointViT(variant=variant, task=task, num_point=N, num_class=50,
                              input_dim=IN_DIM, nneighbor=K)
            pm = ppv.PointViT(variant, task, N, 50, input_dim=IN_DIM, nneighbor=K)
            x = cloud(seed, B, N, IN_DIM)
            variables = jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(x))
            params = perturbed(variables["params"], seed + 1, 0.02)
            stats = positive_stats(variables.get("batch_stats", {}), seed + 2)
            built[variant, task] = jm, pm, x, params, stats
        jm, pm, x, params, stats = built[variant, task]
        missing = load_jax_params(pm, params, stats)
        assert all(k.endswith("num_batches_tracked")
                   or k.startswith(("patch_embed", "pos_embed", "head.")) for k in missing)
        return jm, pm, x, params, stats

    return get


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("task", ["seg", "cls"])
def test_pointvit_3dvit_matches_jax(point_models, task, train):
    jm, pm, x, params, stats = point_models("3DViT", task)
    pm.train(train)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    if train:
        want, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             deterministic=False, mutable=["batch_stats"])
        assert_stats(pm, mut["batch_stats"])
    else:
        want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    assert got.shape == ((B, N, 50) if task == "seg" else (B, 50)) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["3DViT_1_layer", "3DViT_0_layer", "3DViT_LWF"])
def test_other_variants_match_jax_in_eval(point_models, variant):
    jm, pm, x, params, stats = point_models(variant, "seg")
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    assert "new_head.weight" in pm.state_dict() and "head.weight" in pm.state_dict()
    # the 2D pathway (LwF): a JAX tree with it, the image logits in eval mode
    images = cloud(5, 1, 224, 224, 3)
    variables = jax.jit(lambda k, a, b: jm.init(k, a, b, method=jm.init_all))(
        jax.random.key(4), jnp.asarray(x), jnp.asarray(images))
    full = perturbed(variables["params"], 6, 0.02)
    load_jax_params(pm, full, stats)
    with torch.no_grad():
        got = pm.eval().forward_images(torch.from_numpy(images)).numpy()
    want = jm.apply({"params": full, "batch_stats": stats}, jnp.asarray(images),
                    method=jm.forward_images)
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_state_dict_names_are_the_references():
    pm = ppv.PointViT("3DViT", "seg", N, 50, input_dim=IN_DIM, nneighbor=K)
    sd = pm.state_dict()
    for key, shape in [("fc1.0.weight", (48, IN_DIM)), ("fc_pos_embed.2.weight", (48, 48)),
                       ("transition_downs.0.sa.mlp_convs.0.weight", (96, 51, 1, 1)),
                       ("transition_downs.1.sa.mlp_bns.1.running_var", (192,)),
                       ("transition_ups.0.fc1.0.weight", (96, 192)),
                       ("transition_ups.1.fc2.2.weight", (48,)), ("head.weight", (50, 48)),
                       ("blocks.11.attn.qkv.weight", (576, 192)), ("norm.weight", (192,)),
                       ("cls_token", (1, 1, 192))]:
        assert tuple(sd[key].shape) == shape, key
    assert not any(k.startswith(("new_head", "patch_embed", "pos_embed")) for k in sd)


@pytest.mark.parametrize("variant", ["3DViT", "3DViT_1_layer"])
def test_frozen_mask_matches_jax(point_models, variant):
    _, pm, _, params, _ = point_models(variant, "seg")
    # the JAX mask over a tree with the 2D pathway, as the LwF trainer builds it
    tree = dict(params, head={"kernel": 0}, patch_embed={"kernel": 0}) \
        if pm.spec["images"] else params
    for pretrained in (False, True):
        jmask = jpv.frozen_mask_point(tree, pretrained)
        ours = ppv.frozen_mask_point(pm, pretrained)
        for name, trainable in ours.items():
            top = name.split(".")[0]
            jtop = "new_head" if top == pm.head_name else top
            node = jmask[jtop] if jtop in jmask else None
            if isinstance(node, dict):
                node = jax.tree_util.tree_leaves(node)[0]
            if node is not None:
                assert trainable == bool(node), name
    assert not ppv.frozen_mask_point(pm, True).get("patch_embed.proj.weight", False)


def test_registry_builds_every_variant_and_refuses_hengshuang():
    from simple3dformer_tpu_torch.core.config import load_task_config

    cfg = load_task_config("partseg", ["num_point=64"])
    cfg.num_class, cfg.input_dim = 50, IN_DIM
    assert isinstance(make_point_model(cfg, "seg"), ppv.PointViT)
    assert not has_lwf_pathway(cfg)
    cfg.model.name = "3DViT_1_layer"
    assert has_lwf_pathway(cfg)
    cfg.model.name = "Hengshuang"  # ported with its vector-attention kernels: no refusal now
    cfg.model.nblocks, cfg.model.transformer_dim = 2, 64
    assert type(make_point_model(cfg, "seg")).__name__ == "PointTransformerSeg"
    assert not has_lwf_pathway(cfg)
    cfg.model.name = "4DViT"
    with pytest.raises(ValueError, match="4DViT"):
        make_point_model(cfg, "seg")
    with pytest.raises(ValueError):
        ppv.variant_spec("3DViT_2_layer", 192, 64)
