"""The port's legacy voxel-to-image model (FeatureVoxel2DViT) against the JAX
package's, on the CPU: ``DoubleConv`` and ``Up`` (bilinear, and the
transposed conv whose kernel the converter flips) in train mode on their own;
the whole model at deit_tiny (the smallest TEACHER_BACKBONES entry), B=2,
32^3: the eval forward with either head, one JAX ``make_train_step`` Adam step
(loss, gradients read from Adam's first moment, BatchNorm running statistics
at flax's momentum 0.99, the parameters after it), the bf16 forward, and the
128^3 conv stack at B=1.

Parameters are drawn with numpy from the JAX modules' initializers and
perturbed (tests/_torch_port_numpy_init.py), carried across by
utils/convert.py; inputs are made with numpy from a seed. Each JAX reference
is computed once (``functools.cache``), jitted: the 12-block model costs
several times more run op by op.
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.models import legacy_voxel as jlv
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu_torch.models import legacy_voxel as plv
from simple3dformer_tpu_torch.train import optim
from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step
from simple3dformer_tpu_torch.utils.convert import (find_optimizer_state, jax_to_state_dict,
                                                    load_jax_params)

from _torch_port_numpy_init import numpy_variables

B, CLASSES, BACKBONE, LR = 2, 10, "deit_tiny_patch16_224", 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grids(n, v, seed, fill=0.3):
    return (np.random.RandomState(seed).rand(n, v, v, v) < fill).astype(np.float32)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_grads(got: dict, want: dict, rtol: float):
    """Each leaf to its own largest magnitude; a conv bias just ahead of a
    train-mode BatchNorm, whose gradient is zero in exact arithmetic (both sides
    hold rounding residue), to the largest gradient of all."""
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        if re.search(r"(^|\.)conv[12]\.bias$", k):
            assert float((got[k] - g).abs().max()) < rtol * top, k
        else:
            assert rel_err(got[k], g) < rtol, k


# --- DoubleConv and Up on their own, train mode -----------------------------

@functools.cache
def part_reference(part):
    rs = np.random.RandomState(3)
    x = rs.randn(B, 7, 7, 8).astype(np.float32)
    jmod = {"double_conv": jlv.DoubleConv(6, mid_channels=5),
            "up_bilinear": jlv.Up(4, bilinear=True),
            "up_deconv": jlv.Up(3, bilinear=False)}[part]
    params, stats = numpy_variables(jmod, jnp.asarray(x), seed=4, scale=0.05)

    def f(p, xin):
        out, mut = jmod.apply({"params": p, "batch_stats": stats}, xin, deterministic=False,
                              mutable=["batch_stats"])
        return out, mut["batch_stats"]

    @jax.jit
    def run(p, xin, cot):
        out, vjp, new_stats = jax.vjp(f, p, xin, has_aux=True)
        return (out, new_stats) + vjp(cot)

    out_shape = jax.eval_shape(f, params, jnp.asarray(x))[0].shape
    cot = rs.randn(*out_shape).astype(np.float32)
    out, new_stats, g_params, g_x = jax.device_get(run(params, jnp.asarray(x), jnp.asarray(cot)))
    return x, params, stats, np.asarray(out), new_stats, g_params, np.asarray(g_x), cot


@pytest.mark.parametrize("part", ["double_conv", "up_bilinear", "up_deconv"])
def test_part_matches_jax(part):
    """Output, every gradient (contiguous) and the running statistics, f32 within 2e-5."""
    x, params, stats, want, new_stats, g_params, g_x, cot = part_reference(part)
    pmod = {"double_conv": lambda: plv.DoubleConv(8, 6, 5),
            "up_bilinear": lambda: plv.Up(8, 4, True),
            "up_deconv": lambda: plv.Up(8, 3, False)}[part]()
    if part == "up_deconv":
        assert tuple(pmod.state_dict()["deconv.weight"].shape) == (8, 8, 2, 2)  # [in, out, a, b]
    load_jax_params(pmod, params, stats)
    pmod.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pmod(xt)
    assert out.shape == want.shape
    assert rel_err(out.detach(), want) < 2e-5
    (out * torch.from_numpy(cot)).sum().backward()
    assert rel_err(xt.grad, g_x) < 2e-5
    assert_grads({k: p.grad for k, p in pmod.named_parameters()},
                 jax_to_state_dict(g_params, pmod.state_dict()), 2e-5)
    for k, p in pmod.named_parameters():  # the Adam kernel on the card takes contiguous leaves
        assert p.grad.is_contiguous(), k
    for k, v in jax_to_state_dict({}, pmod.state_dict(), new_stats).items():
        assert rel_err(pmod.state_dict()[k], v) < 1e-6, k


def test_upsample_is_half_pixel_bilinear_with_the_edge_clamped():
    """The resize weights equal F.interpolate(align_corners=False)'s at 2x."""
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32))
    want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                                           mode="bilinear", align_corners=False)
    torch.testing.assert_close(plv.upsample2x_bilinear(x), want.permute(0, 2, 3, 1),
                               rtol=0, atol=1e-6)


def test_resize_weights_cached_while_serving_serve_training():
    """The first resize of a size inside ``torch.inference_mode`` (a Predictor
    call) caches weights that a later train step can save for its backward."""
    with torch.inference_mode():
        plv.upsample2x_bilinear(torch.zeros(1, 9, 9, 2))
    x = torch.ones(1, 9, 9, 2, requires_grad=True)
    plv.upsample2x_bilinear(x).sum().backward()
    torch.testing.assert_close(x.grad, torch.full_like(x, 4.0), rtol=0, atol=1e-5)


# --- the whole model --------------------------------------------------------

def jax_model(two_layer_head=False, voxel_size=32, dtype=None):
    return jlv.FeatureVoxel2DViT(n_classes=CLASSES, voxel_size=voxel_size,
                                 transformer_backbone=BACKBONE, two_layer_head=two_layer_head,
                                 dtype=dtype, drop1=0.0, drop2=0.0)


def port_model(two_layer_head=False, voxel_size=32, dtype=None):
    return plv.FeatureVoxel2DViT(CLASSES, voxel_size, BACKBONE, two_layer_head, drop1=0.0,
                                 drop2=0.0, dtype=dtype)


@functools.cache
def jax_variables(two_layer_head=False, voxel_size=32):
    params, stats = numpy_variables(jax_model(two_layer_head, voxel_size),
                                    jnp.zeros((1, voxel_size, voxel_size, voxel_size)),
                                    seed=voxel_size + two_layer_head)
    assert "head" not in params["transformer"]
    return params, stats


def loaded(two_layer_head=False, voxel_size=32, dtype=None):
    pm = port_model(two_layer_head, voxel_size, dtype)
    params, stats = jax_variables(two_layer_head, voxel_size)
    assert [k for k in load_jax_params(pm, params, stats)
            if not k.endswith("num_batches_tracked")] == []
    return pm


@functools.cache
def jax_forward(two_layer_head=False, voxel_size=32, dtype=None, n=B):
    params, stats = jax_variables(two_layer_head, voxel_size)
    x = grids(n, voxel_size, 11)
    out = jax.jit(jax_model(two_layer_head, voxel_size, dtype).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    return x, np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("two_layer_head", [False, True], ids=["head", "two_layer_head"])
def test_forward_matches_jax(two_layer_head):
    """Eval logits within 1e-4 of the largest (12 blocks and a 224^2 decoder in f32)."""
    x, want = jax_forward(two_layer_head)
    pm = loaded(two_layer_head).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (B, CLASSES)
    assert rel_err(got, want) < 1e-4


def test_128_stack_matches_jax():
    """The 128^3 conv stack (four convs, three pools) through the whole model, B=1."""
    x, want = jax_forward(voxel_size=128, n=1)
    pm = loaded(voxel_size=128).eval()
    assert [k for k in pm.state_dict() if k.startswith("conv3d_")][-1] == "conv3d_4.bias"
    with torch.no_grad():
        assert rel_err(pm(torch.from_numpy(x)), want) < 1e-4


def test_bf16_forward_matches_jax():
    """The bf16 model (Linear layers, decoder convs and the ViT in bf16) against
    the JAX bf16 model, within twice the JAX package's own bf16-vs-f32 spread."""
    x, want = jax_forward(dtype=jnp.bfloat16)
    _, want_f32 = jax_forward()
    pm = loaded(dtype=torch.bfloat16).eval()
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    spread = rel_err(want, want_f32)
    assert 0 < rel_err(got.float(), want) <= 2 * spread


@functools.cache
def jax_step():
    """One jitted JAX train step (make_optimizer("Adam"), batch statistics on)."""
    params, stats = jax_variables()
    tx = jax_optim.make_optimizer("Adam")
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                               jax.tree_util.tree_map(jnp.asarray, stats))
    step = jax_make_train_step(jax_model(), tx, has_batch_stats=True, donate=False)
    x, y = grids(B, 32, 12), np.array([3, 7], np.int32)
    state, out = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, LR, jax.random.key(1))
    _, adam = find_optimizer_state(jax.device_get(state.opt_state))
    return x, y, float(out["loss"]), jax.device_get(state.params), \
        jax.device_get(state.batch_stats), adam["mu"]


def test_train_step_matches_jax():
    """One Adam step against the JAX step: the loss within 1e-5, each gradient
    (Adam's first moment, 0.1 g, on both sides), the running statistics
    (momentum 0.99) within 1e-5, and every parameter within 3 lr (Adam's first
    step moves each by about lr).

    The ViT's and the head's gradients agree within 2e-4 of each leaf's
    largest (measured 3e-6). Below the ViT (the decoder, the FC and the 3D
    convs) the gradient passes eight train-mode BatchNorms, and the JAX f32
    step's own error against a float64 evaluation of the same gradient
    reaches 1.1e-2 there (fc1), the port's 3.5e-3: those leaves are held
    within 2e-2. The decoder's parts are held within 2e-5 on their own above."""
    x, y, want_loss, want_params, want_stats, want_mu = jax_step()
    pm = loaded()
    assert pm.fc_bn.momentum == pm.deconv1.conv.bn1.momentum == 0.99
    opt = optim.make_optimizer(dict(pm.named_parameters()), "Adam")
    metrics = make_train_step(TrainState(pm, opt))({"x": torch.from_numpy(x),
                                                    "y": torch.from_numpy(y)}, LR)
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    sd = pm.state_dict()
    want_g = jax_to_state_dict(want_mu, sd)
    vit = [k for k in want_g if k.startswith(("transformer.", "head."))]
    assert_grads({k: opt.mu[k] for k in vit}, {k: want_g[k] for k in vit}, 2e-4)
    assert_grads({k: opt.mu[k] for k in want_g if k not in vit},
                 {k: v for k, v in want_g.items() if k not in vit}, 2e-2)
    for k, v in jax_to_state_dict({}, sd, want_stats).items():
        assert rel_err(sd[k], v) < 1e-5, k
    for k, v in jax_to_state_dict(want_params, sd).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=3 * LR, err_msg=k)


def test_dropout_is_live_in_train_mode_only():
    pm = plv.FeatureVoxel2DViT(CLASSES, 32, BACKBONE, two_layer_head=True, dropout_seed=3)
    x = torch.from_numpy(grids(1, 32, 13))
    with torch.no_grad():
        pm.train()
        a, b = pm.convs(x), pm.convs(x)
        pm.eval()
        c, d = pm.convs(x), pm.convs(x)
    assert not torch.equal(a, b)
    torch.testing.assert_close(c, d, rtol=0, atol=0)
