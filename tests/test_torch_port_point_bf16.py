"""The port's bf16 route of the 3DViT point models and of the voxel ViT against
the JAX package's, on the CPU: each stage of ``PointViT`` (3DViT seg) and of
``VoxelViT`` (default route) at ``dtype=bf16`` in train mode, fed the JAX
model's own input to it, against the JAX stage; three SGD steps of the bf16
PointViT and three Adam steps of the bf16 VoxelViT with Adam's second moment
in bf16, against the JAX package's jitted steps; the blocks' routes at bf16.
Parameters come from the JAX init through utils/convert.py; inputs are made
with numpy.

Tolerances, each over an output's own largest value: both sides round the same
f32 values to bf16 at the same places, but an f32 sum taken in another order
can put a value on the other side of a bf16 rounding boundary, a step of 2**-8
of it; each is stated beside its check.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from simple3dformer_tpu.cli import train_partseg as jax_partseg
from simple3dformer_tpu.models import point_vit as jpv
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn import layers as jax_layers
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu.train.loop import seg_cross_entropy as jax_seg_ce
from simple3dformer_tpu_torch.cli import train_partseg as partseg
from simple3dformer_tpu_torch.models import point_vit as ppv
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn import layers
from simple3dformer_tpu_torch.nn.set_abstraction import Conv1x1
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.train import eval_metrics, optim
from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step, seg_cross_entropy
from simple3dformer_tpu_torch.utils import convert

BF = torch.bfloat16
N, B, K, IN_DIM = 64, 2, 8, 22
V, CELL, PATCH, IMG = 12, 4, 3, 32
BACKBONE, HEADS = "deit_tiny_patch16_224", 3


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
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _torch(a) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(BF) if a.dtype == jnp.bfloat16 else t


def _perturbed(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(tree))


@functools.cache
def _point_case(bf16=True):
    """The JAX 3DViT seg model at bf16 (or f32), its variables (params
    perturbed, statistics away from init) and a cloud."""
    jm = jpv.PointViT(variant="3DViT", task="seg", num_point=N, num_class=50, input_dim=IN_DIM,
                      nneighbor=K, dtype=jnp.bfloat16 if bf16 else None)
    rs = np.random.RandomState(3)
    x = rs.randn(B, N, IN_DIM).astype(np.float32)
    x[..., :3] = rs.rand(B, N, 3)
    variables = jax.jit(jm.init)(jax.random.key(3), jnp.asarray(x))
    params = _perturbed(variables["params"], 4)
    stats = jax.tree_util.tree_map(lambda a: (0.5 + rs.rand(*np.shape(a))).astype(np.float32),
                                   jax.device_get(variables["batch_stats"]))
    return jm, params, stats, x


def _point_port(dtype=BF):
    _, params, stats, _ = _point_case()
    pm = ppv.PointViT("3DViT", "seg", N, 50, input_dim=IN_DIM, nneighbor=K, dtype=dtype)
    convert.load_jax_params(pm, params, stats)
    return pm


@functools.cache
def _voxel_case():
    """The JAX VoxelViT at bf16 (deit_tiny, 3^2 + 1 tokens), its perturbed
    parameters and occupancy grids."""
    emb = JaxVoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=192,
                        dtype=jnp.bfloat16)
    jm = JaxVoxelViT(voxel_embed=emb, n_classes=7, transformer_backbone=BACKBONE, img_size=IMG,
                     dtype=jnp.bfloat16)
    variables = jm.init(jax.random.key(0), jnp.zeros((2, V, V, V)),
                        jnp.zeros((1, IMG, IMG, 3)), method=JaxVoxelViT.init_all)
    x = (np.random.RandomState(5).rand(4, V, V, V) > 0.8).astype(np.float32)
    return jm, _perturbed(variables["params"], 6), x


def _voxel_port(dtype=BF):
    _, params, _ = _voxel_case()
    pm = VoxelViT(VoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=192,
                             dtype=dtype),
                  n_classes=7, transformer_backbone=BACKBONE, img_size=IMG, dtype=dtype)
    assert not convert.load_jax_params(pm, params)
    return pm


def _method(jm, stats, fn):
    """A stage of the JAX model, ``fn(module, *inputs)``, in train mode:
    (params, *inputs) -> output."""
    def run(params, *inputs):
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        out, _ = jm.apply(variables, *inputs, method=fn, mutable=["batch_stats"])
        return out
    return run


def _block(i):
    blk = jax_layers.Block(num_heads=HEADS, dtype=jnp.bfloat16)
    return lambda params, t: blk.apply({"params": params["core"][f"blocks_{i}"]}, t,
                                       deterministic=False)


def _norm(params, t):
    return flax_nn.LayerNorm(epsilon=1e-6).apply({"params": params["core"]["norm"]}, t)


# A stage: (port module, JAX function, its parameter subtree's path, the input
# index whose gradient is compared). Both sides take the same inputs.
def _point_stages():
    jm, params, stats, x = _point_case()
    m = functools.partial(_method, jm, stats)
    stages = {
        "fc1": (m(lambda mod, f: mod.fc1(f)), ("fc1",)),
        "fc_pos_embed": (m(lambda mod, f: mod.fc_pos_embed(f)), ("fc_pos_embed",)),
        "transition_downs.0": (m(lambda mod, xyz, f: mod.transition_downs[0](
            xyz, f, deterministic=False)), ("transition_downs_0",)),
        "transition_downs.1": (m(lambda mod, xyz, f: mod.transition_downs[1](
            xyz, f, deterministic=False)), ("transition_downs_1",)),
        "blocks.0": (_block(0), ("core", "blocks_0")),
        "blocks.11": (_block(11), ("core", "blocks_11")),
        "norm": (_norm, ("core", "norm")),
        "transition_ups.0": (m(lambda mod, cx, h, fx, ff: mod.transition_ups[0](
            cx, h, fx, ff, deterministic=False)), ("transition_ups_0",)),
        "transition_ups.1": (m(lambda mod, cx, h, fx, ff: mod.transition_ups[1](
            cx, h, fx, ff, deterministic=False)), ("transition_ups_1",)),
        "head": (m(lambda mod, h: mod.new_head(h)), ("new_head",)),
    }
    return params, stages


@functools.cache
def _point_stage_inputs():
    """Each stage's inputs (the differentiated one named by index) in the JAX
    bf16 model's train-mode forward: the model run stage by stage."""
    params, st = _point_stages()
    _, _, _, x = _point_case()
    fn = {k: functools.partial(v[0], params) for k, v in st.items()}
    x = jnp.asarray(x)
    xyz0 = x[..., :3]
    ins = {"fc1": ((x,), 0), "fc_pos_embed": ((xyz0,), 0)}
    f0 = fn["fc1"](x) + fn["fc_pos_embed"](xyz0)
    ins["transition_downs.0"] = ((xyz0, f0), 1)
    xyz1, f1 = fn["transition_downs.0"](xyz0, f0)
    ins["transition_downs.1"] = ((xyz1, f1), 1)
    xyz2, f2 = fn["transition_downs.1"](xyz1, f1)
    cls = jnp.broadcast_to(jnp.asarray(params["cls_token"]).astype(f2.dtype), (B, 1, f2.shape[-1]))
    t = jnp.concatenate([cls, f2], axis=1)
    for i in range(12):
        if i in (0, 11):
            ins[f"blocks.{i}"] = ((t,), 0)
        t = _block(i)(params, t)
    ins["norm"] = ((t,), 0)
    h = _norm(params, t)[:, 1:]
    ins["transition_ups.0"] = ((xyz2, h, xyz1, f1), 1)
    h = fn["transition_ups.0"](xyz2, h, xyz1, f1)
    ins["transition_ups.1"] = ((xyz1, h, xyz0, f0), 1)
    h = fn["transition_ups.1"](xyz1, h, xyz0, f0)
    ins["head"] = ((h,), 0)
    return ins


def _voxel_stages():
    jm, params, x = _voxel_case()
    m = functools.partial(_method, jm, None)
    return params, {
        "voxel_embed": (m(lambda mod, v: mod.voxel_embed(v)), ("voxel_embed",)),
        "blocks.0": (_block(0), ("core", "blocks_0")),
        "blocks.11": (_block(11), ("core", "blocks_11")),
        "norm": (_norm, ("core", "norm")),
        "voxel_head": (m(lambda mod, h: mod.voxel_head(h)), ("voxel_head",)),
    }


@functools.cache
def _voxel_stage_inputs():
    params, st = _voxel_stages()
    _, _, x = _voxel_case()
    x = jnp.asarray(x)
    ins = {"voxel_embed": ((x,), 0)}
    tok = st["voxel_embed"][0](params, x)
    tok = tok.reshape(tok.shape[0], -1, tok.shape[-1])
    cls = jnp.broadcast_to(jnp.asarray(params["cls_token"]).astype(tok.dtype),
                           (tok.shape[0], 1, tok.shape[-1]))
    t = jnp.concatenate([cls, tok], axis=1) + jnp.asarray(params["voxel_pos_embed"]).astype(
        tok.dtype)
    for i in range(12):
        if i in (0, 11):
            ins[f"blocks.{i}"] = ((t,), 0)
        t = _block(i)(params, t)
    ins["norm"] = ((t,), 0)
    ins["voxel_head"] = ((_norm(params, t)[:, 0],), 0)
    return ins


# Stage outputs, over the largest value, and the share of elements beyond
# 2**-10 of themselves: a flip of one bf16 rounding, or f32 statistics summed in
# another order, moves a few elements. Measured: the stems, blocks.0, the heads
# and the tokenizer bit-equal; the transition-downs 3.2e-3 (0.24% of elements),
# the norm and transition-ups 7e-7; blocks.11 4.3e-4 with 3.0% of elements
# (point model) and 2.7e-3 with 0.29% (voxel): a last-bit difference in the
# f32 LayerNorm statistics (PyTorch's sum order against XLA's) puts 1.0% of
# the bf16 qkv on the other side of a rounding boundary at that depth. A block
# computing GELU or the softmax in f32 and rounding once moves 20-49% of its
# elements, a transition-down computing in f32 86%.
STAGE_TOL = 1e-2
STAGE_FLIP_SHARE = 0.05
# Gradients, each leaf's (and the input's) within this share of its own
# largest value: a bias gradient sums a bf16 cotangent over every row, rounded
# to bf16 (a 2**-8 step), and a bf16 input's gradient is bf16. Measured: 2.6e-2
# (the tokenizer's bias), 2.2e-2 (a qkv bias), weights and inputs at most
# 9.0e-3.
STAGE_GRAD_TOL = 3e-2


def _zero_but_for_rounding(stage: str, name: str) -> bool:
    """Leaves whose exact gradient is zero, so both packages return rounding
    noise there: the bias of a Linear or 1x1 conv before a train-mode BatchNorm
    (which subtracts the batch mean)."""
    return name.endswith("bias") and (".mlp_convs." in name or (
        stage.startswith("transition_ups") and name in ("fc1.0.bias", "fc2.0.bias")))


def _check_stage(pm, stage, jax_fn, path, params, inputs, diff):
    """The port module ``stage`` of ``pm`` in train mode against ``jax_fn`` from
    the same inputs: output dtype, every Linear / 1x1 conv returning bf16 and
    every BatchNorm / LayerNorm f32 inside it, the output, and the gradients of
    its parameters and of input ``diff`` under one random cotangent."""
    def out(*a):  # a transition-down returns (xyz, features)
        y = jax_fn(*a)
        return y[1] if stage.startswith("transition_downs") else y

    args = list(inputs)
    want, vjp = jax.vjp(lambda p, f: out(p, *args[:diff], f, *args[diff + 1:]),
                        jax.tree_util.tree_map(jnp.asarray, params), args[diff])
    cot = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    want_p, want_in = vjp(jnp.asarray(cot, want.dtype))
    sub = want_p
    for p in path:
        sub = sub[p]
    for p in reversed(path):
        sub = {p: sub}

    mod = pm.train().get_submodule(stage)
    seen = []
    kinds = (layers.Dense, Conv1x1, layers.BatchNorm, layers.LayerNorm)
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((m, o.dtype)))
             for m in mod.modules() if isinstance(m, kinds)]
    targs = [_torch(a) for a in args]
    targs[diff].requires_grad_()
    got = mod(*targs)
    if stage.startswith("transition_downs"):
        got = got[1]
    for h in hooks:
        h.remove()
    assert got.dtype == (BF if want.dtype == jnp.bfloat16 else torch.float32), got.dtype
    norms = (layers.BatchNorm, layers.LayerNorm)
    assert (seen or stage == "voxel_embed") and all(
        dt == (torch.float32 if isinstance(m, norms) else BF) for m, dt in seen), seen
    w, o = _f32(want), _f32(got)
    err = np.abs(o - w)
    assert err.max() <= STAGE_TOL * np.abs(w).max(), err.max() / np.abs(w).max()
    flips = float((err > 2.0 ** -10 * np.abs(w) + 1e-6 * np.abs(w).max()).mean())
    assert flips <= STAGE_FLIP_SHARE, flips

    names = [name for name, _ in mod.named_parameters()]
    *grads, gin = torch.autograd.grad(
        (got.float() * torch.from_numpy(cot).to(got.dtype).float()).sum(),
        [*mod.parameters(), targs[diff]])
    assert gin.dtype == targs[diff].dtype and _rel(gin, want_in) <= STAGE_GRAD_TOL, _rel(gin,
                                                                                  want_in)
    want_sd = convert.jax_to_state_dict(jax.device_get(sub), pm.state_dict())
    assert set(want_sd) == {f"{stage}.{n}" for n in names}
    for name, g in zip(names, grads):
        wg = want_sd[f"{stage}.{name}"]
        assert g.dtype == torch.float32, name
        if _zero_but_for_rounding(stage, name):  # noise of the same size on both sides
            assert float(g.abs().max()) <= 4 * float(wg.abs().max()) + 1e-6, name
        else:
            assert _rel(g, wg) <= STAGE_GRAD_TOL, (name, _rel(g, wg))


POINT_STAGES = ["fc1", "fc_pos_embed", "transition_downs.0", "transition_downs.1", "blocks.0",
                "blocks.11", "norm", "transition_ups.0", "transition_ups.1", "head"]


@pytest.mark.parametrize("stage", POINT_STAGES)
def test_pointvit_bf16_stages_match_jax_in_train_mode(stage):
    """Each stage of the bf16 3DViT seg model: the stems return bf16, the
    transitions f32 (their BatchNorms), the blocks keep the f32 residual
    stream the cls token joins after the transitions, the final norm f32,
    the head bf16; the tolerances above."""
    params, stages = _point_stages()
    fn, path = stages[stage]
    inputs, diff = _point_stage_inputs()[stage]
    _check_stage(_point_port(), stage, fn, path, params, inputs, diff)


VOXEL_STAGES = ["voxel_embed", "blocks.0", "blocks.11", "norm", "voxel_head"]


@pytest.mark.parametrize("stage", VOXEL_STAGES)
def test_voxelvit_bf16_stages_match_jax_in_train_mode(stage):
    """Each stage of the bf16 VoxelViT on its default route: the tokenizer
    returns bf16 tokens, so the blocks' residual stream is bf16 (the cls token
    and the positional embedding cast to it), the final norm returns f32, the
    head bf16; the tolerances above."""
    params, stages = _voxel_stages()
    fn, path = stages[stage]
    inputs, diff = _voxel_stage_inputs()[stage]
    _check_stage(_voxel_port(), stage, fn, path, params, inputs, diff)


# At the whole model a bf16 model's steps depart from its own f32 ones far
# beyond a rounding step (a bf16 product before a train-mode BatchNorm is
# scaled up by it through every later stage), so the model-level checks hold
# the wiring end to end inside the JAX package's own bf16-vs-f32 spread: every
# parameter's three-step change within BAND times that spread of the JAX bf16
# change, and no further from the JAX f32 change than the JAX bf16 one is.
BAND = 2.0
SEG_LR = 0.05  # configs/partseg.yaml


def _seg_batches():
    rs = np.random.RandomState(10)
    out = []
    for _ in range(3):
        cats = rs.randint(0, 16, B).astype(np.int32)
        segs = np.stack([rs.choice(eval_metrics.SEG_CLASSES[list(eval_metrics.SEG_CLASSES)[c]],
                                   N) for c in cats]).astype(np.int32)
        x = rs.randn(B, N, 6).astype(np.float32)
        x[..., :3] = rs.rand(B, N, 3)
        out.append({"x": x, "cls": cats, "y": segs})
    return out


@functools.cache
def _jax_seg_steps(bf16: bool):
    """Three jitted SGD steps of the JAX 3DViT seg model at bf16 (or f32) from
    the same parameters: (losses, state dict after them)."""
    jm = _point_case(bf16)[0]
    _, params, stats, _ = _point_case()
    tree = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    tx = jax_optim.make_optimizer("SGD")
    jstate = create_train_state(tree(params), tx, tree(stats))
    jstep = jax_make_train_step(jm, tx, loss_fn=jax_seg_ce, has_batch_stats=True, donate=False)
    prepare = jax_partseg.make_prepare_fn()
    losses = []
    for batch in _seg_batches():
        x, y = prepare({k: jnp.asarray(v) for k, v in batch.items()})
        jstate, out = jstep(jstate, {"x": x, "y": y}, SEG_LR, jax.random.key(1))
        losses.append(float(out["loss"]))
    return losses, convert.jax_to_state_dict(jax.device_get(jstate.params),
                                             _point_port().state_dict())


def _spread(got: dict, want: dict, keys) -> float:
    """The largest error over ``keys`` as a share of the largest value of ``want``."""
    big = max(float(want[k].abs().max()) for k in keys)
    return max(float((got[k].double() - want[k].double()).abs().max()) for k in keys) / big


def test_pointvit_bf16_three_sgd_steps_match_jax():
    """Three SGD steps of the bf16 3DViT seg model at partseg's lr against the
    JAX package's jitted make_train_step at bf16: losses within 5e-3 relative
    (bf16 logits keep 8 bits, a step of 3.9e-3; measured 1.6e-3), the
    parameters f32 throughout, their three-step changes within the band above
    (measured: 0.83 of the largest change from the JAX bf16 run and 0.58 from
    the JAX f32 run, against the JAX package's own spread of 0.99)."""
    pm = _point_port()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    step = make_train_step(TrainState(pm, optim.make_optimizer(dict(pm.named_parameters()),
                                                               "SGD")),
                           seg_cross_entropy, prepare_fn=partseg.make_prepare_fn())
    losses = [float(step({k: torch.from_numpy(v) for k, v in b.items()}, SEG_LR)["loss"])
              for b in _seg_batches()]
    want_losses, want = _jax_seg_steps(True)
    _, witness = _jax_seg_steps(False)
    np.testing.assert_allclose(losses, want_losses, rtol=5e-3)
    names = [name for name, _ in pm.named_parameters()]
    after = pm.state_dict()
    assert all(after[k].dtype == torch.float32 for k in names)

    def change(state):
        return {k: state[k].double() - before[k].double() for k in names}

    jax_spread = _spread(change(want), change(witness), names)
    assert _spread(change(after), change(want), names) <= BAND * jax_spread
    assert _spread(change(after), change(witness), names) <= jax_spread


VOXEL_LR = 1e-3


def _voxel_batches():
    rs = np.random.RandomState(7)
    return [((rs.rand(4, V, V, V) > 0.8).astype(np.float32), rs.randint(0, 7, 4).astype(np.int32))
            for _ in range(3)]


@functools.cache
def _jax_voxel_steps(bf16: bool):
    """Three jitted Adam steps of the JAX VoxelViT at bf16 with bf16 nu (or f32
    with f32 nu, the JAX trainer's ``--bf16-nu auto``) from the same
    parameters: (losses, state dict after them)."""
    from simple3dformer_tpu.models.voxel_vit import frozen_mask as jax_frozen_mask

    jm, params, _ = _voxel_case()
    if not bf16:
        jm = JaxVoxelViT(voxel_embed=JaxVoxelEmbed(voxel_size=V, cell_size=CELL,
                                                   patch_size=PATCH, embed_dim=192),
                         n_classes=7, transformer_backbone=BACKBONE, img_size=IMG)
    tx = jax_optim.make_optimizer("Adam", trainable_mask=jax_frozen_mask(params, False),
                                  bf16_nu=bf16)
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    jstep = jax_make_train_step(jm, tx, donate=False)
    losses = []
    for x, y in _voxel_batches():
        jstate, out = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, VOXEL_LR,
                            jax.random.key(1))
        losses.append(float(out["loss"]))
    return losses, convert.jax_to_state_dict(jax.device_get(jstate.params),
                                             _voxel_port().state_dict())


def test_voxelvit_bf16_three_adam_steps_with_bf16_nu_match_jax():
    """The flagship recipe at bf16: three Adam steps with the second moment in
    bf16 (the JAX trainer's ``--bf16-nu auto`` at ``--dtype bf16``) against the
    JAX package's jitted step with ``bf16_nu=True``: losses within 1e-2
    relative (measured 5.1e-3), nu held in bf16 and the parameters in f32, the
    three-step changes within the band above from both JAX runs (the f32
    witness with f32 nu). Adam turns a gradient that is all rounding noise into
    a step of up to lr of either sign, so the JAX package's own bf16 and f32
    changes part by 1.97 of the largest change; the port's by 1.98 and 1.83."""
    from simple3dformer_tpu_torch.models.voxel_vit import frozen_mask

    pm = _voxel_port()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    opt = optim.make_optimizer(dict(pm.named_parameters()), "Adam",
                               trainable_mask=frozen_mask(pm, False), bf16_nu=True)
    step = make_train_step(TrainState(pm, opt))
    losses = [float(step({"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                         VOXEL_LR)["loss"]) for x, y in _voxel_batches()]
    want_losses, want = _jax_voxel_steps(True)
    _, witness = _jax_voxel_steps(False)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-2)
    assert opt.count == 3 and all(v.dtype == BF for v in opt.nu.values())
    names = [name for name, p in pm.named_parameters() if name in want]
    after = pm.state_dict()
    assert all(after[k].dtype == torch.float32 for k in names)

    def change(state):
        return {k: state[k].double() - before[k].double() for k in names}

    jax_spread = _spread(change(want), change(witness), names)
    assert _spread(change(after), change(want), names) <= BAND * jax_spread
    assert _spread(change(after), change(witness), names) <= BAND * jax_spread


def test_block_routes_at_bf16():
    """The blocks' routes on the card do not depend on the compute dtype
    (partseg's 257 tokens fused, S3DIS's 1025 layered), and the S3DIS shape's
    bf16 q, k, v are inside the mhsa kernels' gate, so its attention takes them."""
    partseg_blk = layers.Block(192, 3, dtype=BF)
    s3dis_blk = layers.Block(768, 3, dtype=BF)
    assert partseg_blk.route(torch.zeros(1, 257, 192)) == "fused"
    assert s3dis_blk.route(torch.zeros(1, 1025, 768)) == "layered"
    assert s3dis_blk.attn.kernel_unsupported(torch.zeros(1, 1025, 768)) is None
    assert "dtype" in layers.Block(768, 12).attn.kernel_unsupported(
        torch.zeros(1, 1025, 768, dtype=torch.float16))


@pytest.mark.parametrize("op", ["gelu", "softmax"])
def test_bf16_gelu_and_softmax_take_jax_nn_steps(op):
    """At bf16 the port's GELU equals jax.nn.gelu's bit for bit, also inside a
    larger compiled function (as in the JAX train step), and its softmax
    equals jax.nn.softmax as that compiles alone (inside a larger function
    XLA's fusion leaves a few elements a bf16 step from either form), while
    PyTorch's one op, computed in f32 and rounded once, differs in more than
    a twentieth of the elements: why the plain bf16 path replays jax.nn's
    steps. f32 takes PyTorch's one op."""
    rs = np.random.RandomState(11)
    x = 2 * rs.randn(2, 3, 65, 65).astype(np.float32)
    if op == "gelu":
        port, one = layers.gelu_tanh, lambda t: torch.nn.functional.gelu(t, approximate="tanh")
        jax_fn = jax.jit(lambda v: 1 + jax.nn.gelu(v + 0, approximate=True))
        lift = 1
    else:
        port, one = layers.softmax_last, lambda t: t.softmax(-1)
        jax_fn, lift = functools.partial(jax.nn.softmax, axis=-1), 0
    want = np.asarray(jax_fn(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(BF)
    np.testing.assert_array_equal(_f32(lift + port(xt)), want)
    assert float((_f32(lift + one(xt)) != want).mean()) > 0.05
    assert torch.equal(port(xt.float()), one(xt.float()))
