"""The port's ViP-3D against the JAX package's, on the CPU: WeightedPermuteMLP on
both JAX routes (the einsum default and the reference-shaped chain),
Downsample at patch 1 and 2, PosCNN, the whole model shaped like vip3d_s7 and
vip3d_m7 with and without PEG (forward, gradients, three Adam steps), each
stage at bf16 and the bf16 model inside the JAX package's own bf16-vs-f32
spread, the converter against scripts/refbridge's export, DropPath, and the
train_pure_mlp CLI for both embed families.

Widths are narrow but keep the grid rule (H == W == Z == segment_dim): C=64
on 8^3 tokens with segment 8, then 4^3 with segment 4. Parameters come from
the JAX init through utils/convert.py, perturbed so zero-initialised leaves
matter; inputs are made with numpy from a seed.
"""

import functools
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.models import vip3d as jv
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbedNoAverage as JaxEmbed
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu_torch.cli import train_pure_mlp as cli
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.models import vip3d as pv
from simple3dformer_tpu_torch.nn import layers
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbedNoAverage
from simple3dformer_tpu_torch.train import optim
from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step
from simple3dformer_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params

BF = torch.bfloat16
V, CELL, B, CLASSES = 32, 4, 2, 5
# narrow vip3d_s7: a patch-2 downsample after stage 0; narrow vip3d_m7: a
# patch-1 downsample (the widths differ) after stage 0 and a patch-2 one after stage 1
CONFIGS = {
    "s7": dict(layers=[2, 1, 2], transitions=[True, False, False], segment_dim=[8, 4, 4],
               mlp_ratios=[3, 3, 3], embed_dims=[64, 96, 96]),
    "m7": dict(layers=[1, 2, 1], transitions=[False, True, False], segment_dim=[8, 8, 4],
               mlp_ratios=[3, 3, 3], embed_dims=[64, 96, 128]),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(tree))


def grids(n, seed, fill=0.2):
    return (np.random.RandomState(seed).rand(n, V, V, V) < fill).astype(np.float32)


def jax_model(name, peg=False, dtype=None, qkv_bias=False):
    emb = JaxEmbed(voxel_size=V, cell_size=CELL, patch_size=V // CELL,
                   embed_dim=CONFIGS[name]["embed_dims"][0], dtype=dtype)
    return jv.VisionPermutator3D(embed_layer=emb, num_classes=CLASSES, qkv_bias=qkv_bias,
                                 pos_embedding="PEG" if peg else None, dtype=dtype,
                                 **CONFIGS[name])


def port_model(name, peg=False, dtype=None, qkv_bias=False, drop_path_rate=0.0):
    emb = VoxelEmbedNoAverage(voxel_size=V, cell_size=CELL, patch_size=V // CELL,
                              embed_dim=CONFIGS[name]["embed_dims"][0], dtype=dtype)
    return pv.VisionPermutator3D(emb, num_classes=CLASSES, qkv_bias=qkv_bias,
                                 pos_embedding="PEG" if peg else None,
                                 drop_path_rate=drop_path_rate, dtype=dtype, **CONFIGS[name])


@functools.cache
def jax_params(name, peg=False, qkv_bias=False, seed=2):
    variables = jax_model(name, peg, qkv_bias=qkv_bias).init(jax.random.key(0),
                                                             jnp.zeros((B, V, V, V)))
    return perturbed(variables["params"], seed)


def loaded(name, peg=False, dtype=None, qkv_bias=False):
    pm = port_model(name, peg, dtype, qkv_bias)
    assert load_jax_params(pm, jax_params(name, peg, qkv_bias)) == []
    return pm


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _mlp_pair(h, c, qkv_bias, seed):
    """The JAX WeightedPermuteMLP and the port's on one grid [B, h, h, h, c]
    (segment h), the same perturbed weights, and the input."""
    x = np.random.RandomState(seed).randn(B, h, h, h, c).astype(np.float32)
    jm = jv.WeightedPermuteMLP(segment_dim=h, qkv_bias=qkv_bias)
    params = perturbed(jm.init(jax.random.key(seed), jnp.asarray(x))["params"], seed + 1)
    tm = pv.WeightedPermuteMLP(c, h, qkv_bias)
    tm.load_state_dict(jax_to_state_dict(params, tm.state_dict()))
    return jm, params, tm, x


@pytest.mark.parametrize("h,c", [(8, 64), (4, 96)], ids=["8^3", "4^3"])
@pytest.mark.parametrize("qkv_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("route", ["einsum", "chain"])
def test_weighted_permute_mlp_matches_jax(monkeypatch, route, qkv_bias, h, c):
    """The axis mixes, the W/Z-swapped h restore, mlp_w on the z mix and each
    branch's bias at its own output axis: the forward within 1e-5 of its
    largest value and every parameter's and the input's gradient under one
    random cotangent within 1e-4 of its own largest value, against the JAX
    default route (the einsum forward with its chain-transpose backward) and
    the reference-shaped chain (S3F_VIP_EINSUM=0)."""
    if route == "chain":
        monkeypatch.setenv("S3F_VIP_EINSUM", "0")
    jm, params, tm, x = _mlp_pair(h, c, qkv_bias, seed=3 + h)
    assert "mlp_z" not in str(jax.tree_util.tree_structure(params))
    assert ("mlp_h.bias" in tm.state_dict()) == qkv_bias
    cot = np.random.RandomState(11).randn(*x.shape).astype(np.float32)
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    want, vjp = jax.vjp(lambda p, v: jm.apply({"params": p}, v), tree, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(cot))
    xin = torch.from_numpy(x).requires_grad_()
    got = tm(xin)
    assert rel_err(got.detach(), want) <= 1e-5
    names = [n for n, _ in tm.named_parameters()]
    *grads, gx = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                     [*tm.parameters(), xin])
    want_sd = jax_to_state_dict(jax.device_get(want_p), tm.state_dict())
    assert set(want_sd) == set(names)
    assert rel_err(gx, want_x) <= 1e-4
    for n, g in zip(names, grads):
        assert rel_err(g, want_sd[n]) <= 1e-4, n


def test_weighted_permute_mlp_keeps_the_grid_rule():
    """A grid other than segment_dim^3 fails with the JAX package's message."""
    tm = pv.WeightedPermuteMLP(64, 8)
    with pytest.raises(AssertionError, match="cubic token grid with H == W == Z == segment_dim; "
                                             "got grid 4x4x4, segment_dim 8"):
        tm(torch.zeros(1, 4, 4, 4, 64))


@pytest.mark.parametrize("patch", [1, 2])
def test_downsample_matches_jax(patch):
    """The patchify in (px, py, pz, C) order and one product without a bias;
    the weight held as the reference's Conv3d [out, in, p, p, p]."""
    x = np.random.RandomState(patch).randn(B, 8, 8, 8, 64).astype(np.float32)
    jd = jv.Downsample(out_dim=96, patch=patch)
    params = perturbed(jd.init(jax.random.key(0), jnp.asarray(x))["params"], 4)
    td = pv.Downsample(64, 96, patch)
    k = params["proj"]["kernel"]
    td.proj.weight.data.copy_(torch.from_numpy(
        k.reshape(patch, patch, patch, 64, 96).transpose(4, 3, 0, 1, 2).copy()))
    assert set(td.state_dict()) == {"proj.weight"}
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    got = td(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (B, 8 // patch, 8 // patch, 8 // patch, 96)
    assert rel_err(got, want) <= 1e-5


def test_poscnn_matches_jax():
    """The depthwise 3x3x3 conv with SAME padding, its bias and the residual,
    against lax.conv_general_dilated; f32 from 27 shifted multiply-adds (no
    cuDNN), gradients included."""
    x = np.random.RandomState(5).randn(B, 4, 4, 4, 96).astype(np.float32)
    jp = jv.PosCNN()
    params = perturbed(jp.init(jax.random.key(0), jnp.asarray(x))["params"], 6)
    tp = pv.PosCNN(96)
    tp.proj[0].weight.data.copy_(torch.from_numpy(
        params["kernel"].transpose(4, 3, 0, 1, 2).copy()))
    tp.proj[0].bias.data.copy_(torch.from_numpy(params["bias"]))
    cot = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda p, v: jp.apply({"params": p}, v),
                        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(cot))
    xin = torch.from_numpy(x).requires_grad_()
    got = tp(xin)
    assert rel_err(got.detach(), want) <= 1e-5
    gw, gb, gx = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                     [tp.proj[0].weight, tp.proj[0].bias, xin])
    assert rel_err(gx, want_x) <= 1e-5
    assert rel_err(gw, np.asarray(want_p["kernel"]).transpose(4, 3, 0, 1, 2)) <= 1e-4
    assert rel_err(gb, want_p["bias"]) <= 1e-4


def test_poscnn_refuses_a_bf16_stream_as_jax_does():
    """The JAX PosCNN's conv refuses a bf16 input against its f32 kernel; the
    port's PosCNN refuses it too, and so the bf16 model with PEG."""
    x = np.zeros((B, 4, 4, 4, 96), np.float32)
    jp = jv.PosCNN()
    params = jp.init(jax.random.key(0), jnp.asarray(x))
    with pytest.raises(TypeError, match="same dtypes"):
        jp.apply(params, jnp.asarray(x, jnp.bfloat16))
    with pytest.raises(ValueError, match="f32 stream"):
        pv.PosCNN(96)(torch.from_numpy(x).bfloat16())
    with pytest.raises(ValueError, match="f32 stream"):
        port_model("s7", True, torch.bfloat16)(torch.from_numpy(grids(B, 0)))


MODEL_CASES = [("s7", False), ("s7", True), ("m7", False), ("m7", True)]


@pytest.mark.parametrize("name,peg", MODEL_CASES, ids=[f"{n}{'_peg' if p else ''}"
                                                        for n, p in MODEL_CASES])
def test_model_forward_and_gradients_match_jax(name, peg):
    """The whole model from the converted weights: the layout (stages,
    downsamples, PEGs) the refbridge export names, the logits within 1e-5 of
    their largest value and every parameter's gradient of the CE loss within
    1e-4 of its own largest value."""
    params = jax_params(name, peg)
    jm = jax_model(name, peg)
    x = grids(B, 1)
    y = np.array([1, 3], np.int32)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(B), y]), logits

    (_, want), want_g = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    pm = loaded(name, peg)
    logits = pm(torch.from_numpy(x))
    assert rel_err(logits.detach(), want) <= 1e-5
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long())
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, list(pm.parameters()))
    want_sd = jax_to_state_dict(jax.device_get(want_g), pm.state_dict())
    assert set(want_sd) == set(names)
    for n, g in zip(names, grads):
        assert rel_err(g, want_sd[n]) <= 1e-4, n
        assert g.is_contiguous(), n  # the Adam kernel on the card takes contiguous leaves only


def _refbridge():
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "refbridge.py"
    spec = importlib.util.spec_from_file_location("refbridge", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,peg,qkv_bias", [("s7", True, True), ("m7", True, False),
                                               ("m7", False, False)])
def test_converter_matches_refbridge_export(name, peg, qkv_bias):
    """Every key and value the converter gives equals scripts/refbridge's
    export of the same tree, less the reference's dead mlp_z (which the port
    does not create), and covers the model: network.{ni}.{bj} skipping the PEG
    after block 0 and the downsample entries."""
    params = jax_params(name, peg, qkv_bias)
    cfg = CONFIGS[name]
    want = _refbridge().export_vip3d_state_dict(
        params, cfg["layers"], cfg["transitions"], cfg["embed_dims"], CELL, peg=peg,
        qkv_bias=qkv_bias)
    want = {k: v for k, v in want.items() if ".mlp_z." not in k}
    pm = port_model(name, peg, qkv_bias=qkv_bias)
    got = jax_to_state_dict(params, pm.state_dict())
    assert set(got) == set(want) == set(pm.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    ds = sorted(k for k in got if re.fullmatch(r"network\.\d+\.proj\.weight", k))
    assert ds == (["network.1.proj.weight"] if name == "s7" else
                  ["network.1.proj.weight", "network.3.proj.weight"])
    assert ("network.0.1.proj.0.weight" in got) == peg


def test_converter_refuses_a_tree_of_another_layout():
    with pytest.raises(KeyError, match="no such parameter|lacks"):
        load_jax_params(port_model("s7", peg=False), jax_params("s7", peg=True))
    with pytest.raises(KeyError, match="lacks"):
        load_jax_params(port_model("s7", peg=True), jax_params("s7", peg=False))


LR = 1e-3
STEP_CASES = [("s7", False), ("m7", True)]


def _batches():
    rs = np.random.RandomState(7)
    return [(grids(B, rs.randint(1 << 30)), rs.randint(0, CLASSES, B).astype(np.int32))
            for _ in range(3)]


@functools.cache
def _jax_steps(name, peg, bf16=False):
    """Three jitted Adam steps of the JAX model (make_optimizer("Adam"), as the
    JAX CLI; drop path off) from the perturbed init: (losses, state dict)."""
    jm = jax_model(name, peg, jnp.bfloat16 if bf16 else None)
    tx = jax_optim.make_optimizer("Adam")
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, jax_params(name, peg)), tx)
    step = jax_make_train_step(jm, tx, donate=False)
    losses = []
    for x, y in _batches():
        state, out = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, LR,
                          jax.random.key(1))
        losses.append(float(out["loss"]))
    return losses, jax_to_state_dict(jax.device_get(state.params),
                                     port_model(name, peg).state_dict())


def _port_steps(name, peg, dtype=None):
    pm = loaded(name, peg, dtype)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    opt = optim.make_optimizer(dict(pm.named_parameters()), "Adam")
    step = make_train_step(TrainState(pm, opt))
    losses = [float(step({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, LR)["loss"])
              for x, y in _batches()]
    assert opt.count == 3
    return losses, before, pm.state_dict()


@pytest.mark.parametrize("name,peg", STEP_CASES, ids=["s7", "m7_peg"])
def test_three_adam_steps_match_jax(name, peg):
    """Three Adam steps (the Adam kernel's plain version on the CPU) against
    the JAX package's jitted train step: losses within 1e-3 relative, and
    every parameter within 3 lr (Adam turns a sign difference in a gradient
    that is all rounding noise into up to lr a step)."""
    losses, _, after = _port_steps(name, peg)
    want_losses, want = _jax_steps(name, peg)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert set(want) == set(after)
    for k, v in want.items():
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), rtol=0, atol=3 * LR, err_msg=k)


def _stages(model, name):
    """The model's stages in order, each (JAX module name, port callable)."""
    out = [("embed_layer", model.patch_embed)]
    cfg = CONFIGS[name]
    part = iter(model.network)
    for i, n in enumerate(cfg["layers"]):
        blocks = next(part)
        out += [(f"stage{i}_block{b}", blocks[b]) for b in range(n)]
        if i < len(cfg["layers"]) - 1 and (cfg["transitions"][i]
                                           or cfg["embed_dims"][i] != cfg["embed_dims"][i + 1]):
            out.append((f"downsample{i}", next(part)))
    out.append(("head", lambda t: model.head(model.norm(t.reshape(t.shape[0], -1, t.shape[-1]))
                                             .mean(1))))
    return out


@functools.cache
def _jax_bf16_intermediates(name):
    """The JAX bf16 model's stage outputs, in order, and its input."""
    jm = jax_model(name, dtype=jnp.bfloat16)
    x = jnp.asarray(grids(B, 4))
    out, state = jm.apply({"params": jax_params(name)}, x, capture_intermediates=True,
                          mutable=["intermediates"])
    inter = state["intermediates"]
    outs = {k: v["__call__"][0] for k, v in inter.items() if k != "__call__"}
    outs["head"] = out
    return x, outs


@pytest.mark.parametrize("name", ["s7", "m7"])
def test_bf16_stages_match_jax(name):
    """Each stage of the bf16 model fed the JAX bf16 model's own input to it:
    the output in the JAX stage's dtype (the tokenizer's and every block's
    bf16, the residual stream bf16; the head's bf16 logits) within 2e-2 of
    its largest value, bf16 rounding of the same f32 values taken in another
    order; every Linear computes in bf16 and every LayerNorm returns f32."""
    pm = loaded(name, dtype=BF)
    x, outs = _jax_bf16_intermediates(name)
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((type(m), o.dtype)))
             for m in pm.modules() if isinstance(m, (layers.Dense, layers.LayerNorm))]
    prev = torch.from_numpy(np.array(x))
    with torch.no_grad():
        for jname, fn in _stages(pm, name):
            want = outs[jname]
            got = fn(prev)
            assert str(got.dtype).split(".")[-1] == str(want.dtype), jname
            assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2e-2, jname
            prev = torch.from_numpy(np.asarray(want, np.float32)).to(got.dtype)
    for h in hooks:
        h.remove()
    assert {d for t, d in seen if t is layers.Dense} == {BF}
    assert {d for t, d in seen if t is layers.LayerNorm} == {torch.float32}


# At the whole model, bf16 departs from f32 far beyond a rounding step, so
# the bf16 model is held inside the JAX package's own bf16-vs-f32 spread:
# its three-step parameter changes within BAND times that spread of the JAX
# bf16 change, and no further from the JAX f32 change than BAND times it.
BAND = 2.0


def _spread(got: dict, want: dict, keys) -> float:
    big = max(float(want[k].abs().max()) for k in keys)
    return max(float((got[k].double() - want[k].double()).abs().max()) for k in keys) / big


def test_bf16_model_inside_the_jax_spread():
    """The bf16 logits within the JAX package's own bf16-vs-f32 logit spread of
    the JAX bf16 logits (measured 9.8e-4 against 1.6e-3), and three Adam steps
    (f32 moments, as the JAX CLI's optimizer): losses within 5e-3 relative
    (measured 1.2e-3), parameters f32, their changes inside the band above
    (measured 1.71 of the largest change from both JAX runs, against the JAX
    package's own spread of 1.44)."""
    name = "s7"
    x = grids(B, 9)
    jb = np.asarray(jax_model(name, dtype=jnp.bfloat16).apply(
        {"params": jax_params(name)}, jnp.asarray(x)), np.float32)
    jf = np.asarray(jax_model(name).apply({"params": jax_params(name)}, jnp.asarray(x)))
    with torch.no_grad():
        pb = loaded(name, dtype=BF)(torch.from_numpy(x))
    assert pb.dtype == BF
    assert np.abs(pb.float().numpy() - jb).max() <= np.abs(jf - jb).max()

    losses, before, after = _port_steps(name, False, BF)
    want_losses, want = _jax_steps(name, False, bf16=True)
    _, witness = _jax_steps(name, False)
    np.testing.assert_allclose(losses, want_losses, rtol=5e-3)
    names = list(want)
    assert all(after[k].dtype == torch.float32 for k in names)

    def change(state):
        return {k: state[k].double() - before[k].double() for k in names}

    jax_spread = _spread(change(want), change(witness), names)
    assert _spread(change(after), change(want), names) <= BAND * jax_spread
    assert _spread(change(after), change(witness), names) <= BAND * jax_spread


def test_drop_path_draws_on_the_inputs_device():
    """One Bernoulli(keep) mask a sample, kept samples divided by keep, drawn on
    the input's device from a generator seeded once: the kept share near keep,
    fresh masks each call, the same masks from the same seed, the identity in
    eval mode; the model's block rates rise linearly to drop_path_rate."""
    x = torch.ones(4000, 2, 3)
    a, b = layers.DropPath(0.25, seed=3).train(), layers.DropPath(0.25, seed=3).train()
    first, second = a(x), a(x)
    kept = first[:, 0, 0] != 0
    assert torch.equal(first[kept], torch.full_like(first[kept], 1 / 0.75))
    assert torch.equal(first[~kept], torch.zeros_like(first[~kept]))
    assert abs(float(kept.float().mean()) - 0.75) < 0.03  # 4,000 draws: 4.4 standard deviations
    assert torch.equal(first, b(x)) and not torch.equal(first, second)
    assert list(a.generators) == ["cpu"]
    assert torch.equal(a.eval()(x), x) and torch.equal(layers.DropPath(0.0).train()(x), x)
    pm = port_model("s7", drop_path_rate=0.1)
    rates = [blk.drop_path.rate for stage in pm.network if isinstance(stage, torch.nn.ModuleList)
             for blk in stage]
    np.testing.assert_allclose(rates, [0.1 * i / 4 for i in range(5)])
    assert len({blk.drop_path.generators.seed for stage in pm.network
                if isinstance(stage, torch.nn.ModuleList) for blk in stage}) == 5


# the JAX CLI's epoch line (simple3dformer_tpu/cli/train_pure_mlp.py:151-152)
EPOCH_LINE = re.compile(r"^Epoch (\d+) loss (\d+\.\d{4}) test accuracy (\d\.\d{6}), "
                        r"mean class accuracy (\d\.\d{6}) \((\d+\.\d) samples/sec\)$")


@pytest.mark.parametrize("family", ["m40", "shapenet"])
def test_cli_on_the_cpu(tmp_path, capsys, family):
    """train_pure_mlp --device cpu at full width (vip3d_s7) on a few samples:
    ModelNet40's 30^3 synthetic grids padded to 32^3 at bf16 (two epochs, drop
    path live), and the ShapeNetV2 family at 128^3 with PEG (one epoch);
    the epoch lines, the best line, and a checkpoint holding the model."""
    if family == "m40":
        argv = ["--dataset", "ModelNet40", "--synthetic", "8", "--batchSize", "4",
                "--epochs", "2", "--dtype", "bf16"]
    else:
        argv = ["--dataset", "ShapeNetV2", "--embed-layer", "VoxelEmbed_vip_s7", "--synthetic",
                "8", "--batchSize", "4", "--epochs", "1", "--pos-embedding", "PEG"]
    best = cli.main(argv + ["--device", "cpu", "--outf", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch")]
    assert epochs and all(epochs) and len(epochs) == (2 if family == "m40" else 1)
    assert all(np.isfinite(float(m.group(2))) for m in epochs)
    assert lines[-1].startswith("Best test accuracy: epoch ") and lines[-1].endswith(f"{best:f}")
    assert "train 8 / test 4" in lines
    ckpt = Checkpointer(str(tmp_path / "vip3d_s7" / "ckpt"))
    state, metrics = ckpt.restore()
    assert metrics["accuracy"] == best
    assert state["opt_state"]["count"] == 2 * (ckpt.latest_step() + 1)  # 2 steps an epoch
    keys = set(state["params"])
    assert "network.1.proj.weight" in keys and "head.weight" in keys
    assert ("network.0.1.proj.0.weight" in keys) == (family == "shapenet")
    assert state["params"]["patch_embed.proj.conv3d_1.weight"].shape == (
        192, 1, *(3 * (4 if family == "m40" else 16,)))


def test_cli_does_not_move_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--synthetic", "8"])
