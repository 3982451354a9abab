"""The port's Hengshuang path against the JAX package's, on the CPU: both
Point Transformer models in train and eval mode with their batch statistics,
the converter round trip, three SGD steps, the ModelNet40 reader, the
synthetic stream, the cls augmentation, the instance/class meter, the lr
schedule and the train_cls CLI for both of its models. Inputs are made with
numpy."""

import copy
import functools
import itertools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.cli import _common as jax_common
from simple3dformer_tpu.cli import train_cls as jax_cli
from simple3dformer_tpu.core import config as jax_config
from simple3dformer_tpu.data import datasets as jax_datasets
from simple3dformer_tpu.models.hengshuang import PointTransformerCls as JaxCls
from simple3dformer_tpu.models.hengshuang import PointTransformerSeg as JaxSeg
from simple3dformer_tpu.ops import pointops as jax_pointops
from simple3dformer_tpu.train import eval_metrics as jax_metrics
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import cross_entropy as jax_cross_entropy
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu.utils.torch_convert import reference_hengshuang_to_jax_tree
from simple3dformer_tpu_torch.cli import _common as common
from simple3dformer_tpu_torch.cli import train_cls as cli
from simple3dformer_tpu_torch.core import config
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.data import augment, datasets
from simple3dformer_tpu_torch.models.hengshuang import PointTransformerCls, PointTransformerSeg
from simple3dformer_tpu_torch.models.registry import make_point_model
from simple3dformer_tpu_torch.train import eval_metrics, optim
from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step
from simple3dformer_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX package's test size (tests/test_hengshuang.py): 64 points, 2 blocks,
# 8 neighbours, transformer_dim 64
N, NBLOCKS, K, DIM = 64, 2, 8, 64
KW = dict(nblocks=NBLOCKS, nneighbor=K, transformer_dim=DIM)


def _classes(task):
    return ((JaxCls, PointTransformerCls, 40, 6) if task == "cls"
            else (JaxSeg, PointTransformerSeg, 50, 22))


@functools.cache
def _jax_variables(task, seed):
    """The JAX model and its variables (params perturbed, statistics away from
    init) as numpy trees; one init compile per (task, seed) for the file."""
    jcls, _, num_class, in_dim = _classes(task)
    jm = jcls(num_point=N, num_class=num_class, input_dim=in_dim, **KW)
    variables = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((2, N, in_dim)))
    rs = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map(
        lambda a: (0.5 + rs.rand(*np.shape(a))).astype(np.float32),
        jax.device_get(variables["batch_stats"]))
    return jm, params, stats


def _models(task, seed=0):
    """The JAX model, its variables, and a fresh port model holding them."""
    jm, params, stats = _jax_variables(task, seed)
    _, pcls, num_class, in_dim = _classes(task)
    pm = pcls(N, num_class, in_dim, **KW)
    convert.load_jax_params(pm, params, stats)
    return jm, params, stats, pm, in_dim


def _cloud(seed, b, c):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, N, c).astype(np.float32)
    x[..., :3] = rs.rand(b, N, 3)  # xyz in the unit cube, as the JAX test's blocks take it
    return x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("task", ["cls", "seg"])
def test_models_match_jax(task, train):
    """Outputs within 1e-4 of max(1, the largest logit) (two to five vector-
    attention blocks and BatchNorms, f32 sums in another order); in train mode
    the updated batch statistics within 1e-5 relative."""
    jm, params, stats, pm, in_dim = _models(task)
    x = _cloud(3, 2, in_dim)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, mut = jm.apply(variables, jnp.asarray(x), deterministic=False,
                             mutable=["batch_stats"])
        new_stats = mut["batch_stats"]
    else:
        want, new_stats = jm.apply(variables, jnp.asarray(x)), stats
    got = pm.train(train)(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == ((2, 40) if task == "cls" else (2, N, 50))
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)
    want_stats = convert.jax_to_state_dict({}, pm.state_dict(), jax.device_get(new_stats))
    assert any(k.endswith("running_var") for k in want_stats)
    for k, v in want_stats.items():
        np.testing.assert_allclose(pm.state_dict()[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_converter_round_trip(task):
    """JAX tree -> the port's state dict (the reference's names) -> the JAX
    package's reference_hengshuang_to_jax_tree -> the same tree."""
    _, params, stats, pm, _ = _models(task)
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    back_params, back_stats = reference_hengshuang_to_jax_tree(sd)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    back = dict(jax.tree_util.tree_leaves_with_path(back_params))
    assert set(flat) == set(back)
    for path, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[path]), v, err_msg=str(path))
    for path, v in jax.tree_util.tree_leaves_with_path(stats):
        got = dict(jax.tree_util.tree_leaves_with_path(back_stats))[path]
        np.testing.assert_array_equal(np.asarray(got), v, err_msg=str(path))
    if task == "seg":
        assert "transformers.1.w_qs.weight" in sd and "backbone.transformers.1.w_qs.weight" in sd
        assert "fc3.4.weight" in sd and "transformer2.fc_gamma.2.bias" in sd


def test_registry_builds_both_hengshuang_models():
    cfg = config.load_task_config("cls", ["model=Hengshuang", "num_point=64",
                                          "model.nblocks=2", "model.transformer_dim=64"])
    cfg.num_class, cfg.input_dim = 40, 6
    cls_model = make_point_model(cfg, "cls")
    seg_model = make_point_model(cfg, "seg")
    assert isinstance(cls_model, PointTransformerCls) and isinstance(seg_model, PointTransformerSeg)
    assert cls_model.backbone.transformer1.d_model == 64
    assert len(seg_model.transition_ups) == 2


def _three_steps(step, in_dim, dtype=np.float32):
    rs = np.random.RandomState(7)
    for i in range(3):
        batch = {"x": _cloud(10 + i, 4, in_dim).astype(dtype),
                 "y": rs.randint(0, 40, 4).astype(np.int32)}
        yield batch, step(batch)


LR = 0.01
# A leaf whose float64 gradient (or change) stays below this share of the
# model's largest is held against that largest value instead of its own: most
# such leaves are zero but for rounding (a bias in front of a BatchNorm,
# fc_gamma's last bias, which the softmax over K does not see, the stem's last
# bias, a shift of every point that the BatchNorms after it remove).
SMALL = 1e-5


def _as_f64_state_dict(pm, params, stats=None):
    f64 = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
    template = {k: v.double() for k, v in pm.state_dict().items()}
    return convert.jax_to_state_dict(f64(jax.device_get(params)), template,
                                     None if stats is None else f64(jax.device_get(stats)))


def _jax_run(dtype):
    """The JAX package's one-step gradients (jax.grad of its cross_entropy on
    the first batch, train mode) and its jitted make_train_step for three SGD
    steps, in ``dtype``, from the port model's weights: (losses, gradients,
    state after three steps), both as float64 state dicts."""
    jm, params, stats, pm, in_dim = _models("cls", seed=6)
    cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, dtype))
    (batch, _), = itertools.islice(_three_steps(lambda b: None, in_dim, dtype), 1)

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": cast(stats)}, jnp.asarray(batch["x"]),
                          deterministic=False, mutable=["batch_stats"])
        return jax_cross_entropy(out, jnp.asarray(batch["y"]))

    grads = _as_f64_state_dict(pm, jax.jit(jax.grad(loss))(cast(params)))
    tx = jax_optim.make_optimizer("SGD")
    jstate = create_train_state(cast(params), tx, cast(stats))
    jstep = jax_make_train_step(jm, tx, has_batch_stats=True, donate=False)
    losses = []
    for batch, _ in _three_steps(lambda b: None, in_dim, dtype):
        jstate, out = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, LR,
                            jax.random.key(1))
        losses.append(float(out["loss"]))
    return losses, grads, _as_f64_state_dict(pm, jstate.params, jstate.batch_stats)


@functools.cache
def _jax_float64_witness():
    """``_jax_run`` in float64, the independent reference for the port's f32
    steps. The JAX FPS keeps an f32 distance carry, so its picks are made on
    f32 xyz, as the port's FPS makes them (indices only; all else is float64).
    Its cross_entropy casts the logits to f32, which puts a relative 1e-7 on the
    loss and on the gradient entering the logits."""
    orig = jax_pointops.farthest_point_sample
    jax_pointops.farthest_point_sample = (
        lambda xyz, npoint, key=None: orig(xyz.astype(jnp.float32), npoint, key=key))
    try:
        with jax.enable_x64(True):
            return _jax_run(np.float64)
    finally:
        jax_pointops.farthest_point_sample = orig


def _port_run():
    """The port's f32 one-step gradients on the first batch (train mode) and
    its three SGD steps: (losses, gradients, the state dict before and after)."""
    *_, pm, in_dim = _models("cls", seed=6)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    (batch, _), = itertools.islice(_three_steps(lambda b: None, in_dim), 1)
    copy_ = copy.deepcopy(pm).train()  # a copy: its forward moves the batch statistics
    loss = torch.nn.functional.cross_entropy(copy_(torch.from_numpy(batch["x"])),
                                             torch.from_numpy(batch["y"]).long())
    names = [name for name, _ in copy_.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(copy_.parameters()))))
    step = make_train_step(TrainState(pm, optim.make_optimizer(dict(pm.named_parameters()),
                                                               "SGD")))
    losses = [float(out["loss"]) for _, out in _three_steps(
        lambda b: step({k: torch.from_numpy(v) for k, v in b.items()}, LR), in_dim)]
    return losses, grads, before, pm.state_dict()


def _gradient_errors(got, want):
    """({leaf: error over the leaf's own largest float64 value} for the leaves
    at or above SMALL of the largest gradient, {leaf: error over the largest
    gradient} for the rest)."""
    big = max(float(w.abs().max()) for w in want.values())
    rel, small = {}, {}
    for name, w in want.items():
        err = float((got[name].double() - w).abs().max())
        scale = float(w.abs().max())
        if scale < SMALL * big:
            small[name] = err / big
        else:
            rel[name] = err / scale
    return rel, small


def _change_errors(before, after, want):
    """{leaf: error of the three-step change after - before, over the change's
    own largest float64 value and less the f32 rounding of three updates of
    the leaf (half an ulp of its largest value each)} for the parameters whose
    change is at or above SMALL of the largest change."""
    keys = [k for k in want if not k.endswith(("running_mean", "running_var", "tracked"))]
    change = {k: want[k] - before[k].double() for k in keys}
    big = max(float(c.abs().max()) for c in change.values())
    out = {}
    for k in keys:
        scale = float(change[k].abs().max())
        if scale >= SMALL * big:
            rounding = 3 * 2.0 ** -24 * float(after[k].abs().max())
            err = float((after[k].double() - before[k].double() - change[k]).abs().max())
            out[k] = max(err - rounding, 0.0) / scale
    return out


def test_three_sgd_train_steps_match_jax():
    """Three SGD steps at the recipe's lr 0.01 against the JAX package's jitted
    make_train_step. Against its f32 step: losses within 1e-3 relative. Against
    the same step in float64 (the witness; the JAX f32 step's own gradients
    depart from it by up to 1.7e-2 of a leaf's largest value, see
    ``python tests/test_torch_port_hengshuang.py``): losses within 1e-5
    relative (measured 7e-8), every parameter's three-step change within 1e-4
    of the change's largest value beyond the f32 rounding of the parameter
    (measured 8.2e-6), every batch statistic within 1e-5 of its largest value
    (measured 3.2e-7)."""
    losses, _, before, after = _port_run()
    want_losses, _, want = _jax_float64_witness()
    jax_losses, *_ = _jax_run(np.float32)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    errs = _change_errors(before, after, want)
    assert len(errs) > 40
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(after[k].double().numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
        assert int(after[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 3


@pytest.mark.parametrize("seg_task", ["partseg", "s3dis"])
def test_seg_three_sgd_train_steps_match_jax(seg_task):
    """PointTransformerSeg as the partseg CLI (22 input channels, 50 parts) and
    the S3DIS CLI (9, 13 classes) train it: three SGD steps of per-point cross
    entropy against the JAX package's jitted make_train_step in f32, losses
    within 1e-3 relative (as the cls steps against the JAX f32 step: its f32
    gradients depart from float64 beyond rounding, see above)."""
    from simple3dformer_tpu.train.loop import seg_cross_entropy as jax_seg_ce

    from simple3dformer_tpu_torch.train.loop import seg_cross_entropy

    in_dim, num_class = (22, 50) if seg_task == "partseg" else (9, 13)
    jm = JaxSeg(num_point=N, num_class=num_class, input_dim=in_dim, **KW)
    variables = jax.jit(jm.init)(jax.random.key(8), jnp.zeros((2, N, in_dim)))
    rs = np.random.RandomState(9)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = jax.device_get(variables["batch_stats"])
    pm = PointTransformerSeg(N, num_class, in_dim, **KW)
    convert.load_jax_params(pm, params, stats)
    tx = jax_optim.make_optimizer("SGD")
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                                jax.tree_util.tree_map(jnp.asarray, stats))
    jstep = jax_make_train_step(jm, tx, loss_fn=jax_seg_ce, has_batch_stats=True, donate=False)
    step = make_train_step(TrainState(pm, optim.make_optimizer(dict(pm.named_parameters()),
                                                               "SGD")), seg_cross_entropy)
    losses, want = [], []
    for i in range(3):
        batch = {"x": _cloud(20 + i, 4, in_dim),
                 "y": rs.randint(0, num_class, (4, N)).astype(np.int32)}
        jstate, jout = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, LR,
                             jax.random.key(1))
        want.append(float(jout["loss"]))
        losses.append(float(step({k: torch.from_numpy(v) for k, v in batch.items()},
                                 LR)["loss"]))
    np.testing.assert_allclose(losses, want, rtol=1e-3)
    assert int(pm.transition_ups[0].fc1._modules["2"].num_batches_tracked) == 3


def test_three_sgd_train_steps_match_float64():
    """The port's three f32 steps against the same steps of the port in
    float64: losses within 1e-5 relative, every parameter and statistic within
    1e-5 of its largest value (measured: 2.6e-7 and 2.2e-6). The port's
    BatchNorm takes its batch statistics in f32 in both runs; the JAX float64
    witness above has none of the port's code."""
    *_, pm, in_dim = _models("cls", seed=6)
    pm64 = copy.deepcopy(pm).double()
    runs = []
    for model, dtype in ((pm, np.float32), (pm64, np.float64)):
        step = make_train_step(TrainState(model, optim.make_optimizer(
            dict(model.named_parameters()), "SGD")), x_dtype=getattr(torch, dtype.__name__))
        runs.append([float(out["loss"]) for _, out in _three_steps(
            lambda b: step({k: torch.from_numpy(v) for k, v in b.items()}, LR), in_dim, dtype)])
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)
    want = pm64.state_dict()
    for k, v in pm.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(want[k]) == 3
            continue
        scale = max(float(want[k].abs().max()), 1e-6)
        np.testing.assert_allclose(v.double().numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_gradients_match_float64():
    """The port's f32 gradients of one train-mode step against the JAX
    package's in float64: each leaf within 1e-4 of its own largest value
    (measured 3.5e-5, transformer1.fc2: the f32 BatchNorm statistics, whose
    fast variance E[x^2] - E[x]^2 loses up to mean^2/var ~ 700 ulps), and each
    leaf below SMALL of the largest gradient within 2e-5 of the largest
    gradient (measured 9.0e-6; the JAX f32 step's own: 3.4e-5)."""
    _, grads, _, _ = _port_run()
    _, want, _ = _jax_float64_witness()
    assert set(grads) == set(want)
    rel, small = _gradient_errors(grads, want)
    assert len(rel) > 45 and "backbone.transformer1.fc_gamma.2.bias" in small
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-4, (worst, rel[worst])
    worst = max(small, key=small.get)
    assert small[worst] <= 2e-5, (worst, small[worst])


def test_instance_class_meter_matches_jax():
    rs = np.random.RandomState(8)
    ours, theirs = eval_metrics.InstanceClassMeter(40), jax_metrics.InstanceClassMeter(40)
    for _ in range(4):
        label = rs.randint(0, 40, 16)
        pred = np.where(rs.rand(16) < 0.5, label, rs.randint(0, 40, 16))
        ours.update(pred, label)
        theirs.update(pred, label)
    assert ours.instance_accuracy == theirs.instance_accuracy
    assert ours.class_accuracy == theirs.class_accuracy
    assert eval_metrics.InstanceClassMeter(40).instance_accuracy == 0.0


def _modelnet_fixture(root, rs):
    shapes = ["airplane", "night_stand"]
    (root / "modelnet40_shape_names.txt").write_text("".join(f"{s}\n" for s in shapes))
    ids = {"train": [], "test": []}
    for s in shapes:
        (root / s).mkdir()
        for i in range(3):
            sid = f"{s}_{i + 1:04d}"
            rows = rs.randn(40 + i, 6)
            (root / s / f"{sid}.txt").write_text(
                "\n".join(",".join(f"{v:.6f}" for v in row) for row in rows) + "\n")
            ids["train" if i < 2 else "test"].append(sid)
    for split, items in ids.items():
        (root / f"modelnet40_{split}.txt").write_text("".join(f"{x}\n" for x in items))


@pytest.mark.parametrize("uniform,normal", [(False, True), (True, True), (True, False),
                                            (False, False)])
def test_modelnet_reader_matches_jax(tmp_path, uniform, normal):
    _modelnet_fixture(tmp_path, np.random.RandomState(9))
    for split, count in (("train", 4), ("test", 2)):
        ours = datasets.ModelNetPointCloud(str(tmp_path), 32, split, uniform, normal,
                                           rng=np.random.RandomState(3))
        theirs = jax_datasets.ModelNetPointCloud(str(tmp_path), 32, split, uniform, normal,
                                                 rng=np.random.RandomState(3))
        assert len(ours) == len(theirs) == count
        for i in list(range(count)) * 2:  # the second pass reads the cache
            (p, c), (jp, jc) = ours[i], theirs[i]
            np.testing.assert_array_equal(p, jp)
            np.testing.assert_array_equal(c, jc)
            assert p.shape == (32, 6 if normal else 3) and p.dtype == np.float32


def test_synthetic_stream_matches_jax_cli():
    for ov in (["synthetic=100", "num_point=16", "seed=3"],
               ["synthetic=20", "num_point=8", "normal=false", "model=Hengshuang", "seed=9"]):
        got = cli.load_arrays(config.load_task_config("cls", ov))
        want = jax_cli.load_arrays(jax_config.load_task_config("cls", ov))
        for (a, b), (ja, jb) in zip(got, want):
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(b, jb)


def test_cls_augment_properties():
    """Dropped points become the sample's first point (all channels), then xyz
    takes one scale in [0.8, 1.25) and one shift in [-0.1, 0.1) per axis for the
    whole sample; kept points keep their other channels."""
    x = torch.from_numpy(np.random.RandomState(1).randn(200, 64, 6).astype(np.float32))
    aug = augment.device_cls_augment(torch.Generator().manual_seed(0), x)
    dropped = (aug == aug[:, :1]).all(-1)
    dropped[:, 0] = False
    assert 0.05 < float(dropped.float().mean()) < 0.875
    np.testing.assert_array_equal(aug[..., 3:][~dropped].numpy(), x[..., 3:][~dropped].numpy())
    for b in range(200):
        kept = torch.nonzero(~dropped[b]).flatten()
        i, j = int(kept[0]), int(kept[-1])
        scale = (aug[b, i, :3] - aug[b, j, :3]) / (x[b, i, :3] - x[b, j, :3])
        shift = aug[b, kept, :3] - x[b, kept, :3] * scale
        assert 0.8 - 1e-3 <= float(scale.min()) and float(scale.max()) < 1.25 + 1e-3
        # scale and shift estimated from two points: f32 rounding of |x| up to ~4
        torch.testing.assert_close(scale, scale[:1].expand(3), rtol=1e-3, atol=0)
        assert float(shift.abs().max()) < 0.1 + 1e-3
        torch.testing.assert_close(shift, shift[:1].expand_as(shift), rtol=0, atol=1e-3)
    drop = augment.device_random_point_dropout(torch.Generator().manual_seed(2), x)
    assert bool(((drop == x).all(-1) | (drop == x[:, :1]).all(-1)).all())


def test_lr_schedule_matches_jax():
    cfg = config.load_task_config("cls")
    jcfg = jax_config.load_task_config("cls")
    ours, theirs = common.lr_schedule(cfg, 0.01), jax_common.lr_schedule(jcfg, 0.01)
    assert [ours(e) for e in (0, 49, 50, 120, 199)] == [theirs(e) for e in (0, 49, 50, 120, 199)]


EPOCH_LINE = re.compile(r"^Epoch (\d+): Train Instance Accuracy: \d\.\d{6} "
                        r"\(\d+\.\d samples/sec\)$")
TEST_LINE = re.compile(r"^Test Instance Accuracy: \d\.\d{6}, Class Accuracy: \d\.\d{6}$")


@pytest.mark.parametrize("model", ["Hengshuang", "3DViT"])
def test_cli_trains_on_the_cpu_and_resumes(tmp_path, capsys, model):
    out_dir = str(tmp_path / "run")
    argv = ["device=cpu", f"model={model}", "synthetic=16", "num_point=64", "batch_size=8",
            f"out_dir={out_dir}"]
    if model == "Hengshuang":
        argv += ["model.nblocks=2", "model.nneighbor=8", "model.transformer_dim=64"]
    best = cli.main(argv + ["epoch=2"])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch ")]
    tests = [TEST_LINE.match(line) for line in lines if line.startswith("Test Instance")]
    assert len(epochs) == len(tests) == 2 and all(epochs) and all(tests)
    assert "The size of train data is 16; test 64" in lines and "Save model..." in lines
    assert lines[-1] == "End of training..."
    assert re.match(rf"^Best Instance Accuracy: {best:f}, Class Accuracy: \d\.\d{{6}}$",
                    lines[-2])
    run = os.path.join(out_dir, model, "none" if model == "Hengshuang" else
                       "deit_tiny_patch16_224", "False" if model == "Hengshuang" else "True")
    copied = "hengshuang.py" if model == "Hengshuang" else "point_vit.py"
    assert os.path.exists(os.path.join(run, "resolved_config.json"))
    assert os.path.exists(os.path.join(run, copied))
    latest = Checkpointer(os.path.join(run, "ckpt")).latest_step()
    assert latest in (0, 1)
    # the resume: from the latest checkpoint, the epochs after it
    cli.main(argv + ["epoch=3"])
    lines = capsys.readouterr().out.splitlines()
    assert "Use pretrain model" in lines
    assert [int(m.group(1)) for m in map(EPOCH_LINE.match, lines) if m] == list(
        range(latest + 2, 4))


def test_cli_trains_hengshuang_at_bf16_on_the_cpu_and_resumes(tmp_path, capsys):
    """``dtype=bf16`` at test size: the epoch and eval lines with finite losses,
    a checkpoint of the f32 parameters, and the resume."""
    out_dir = str(tmp_path / "run")
    argv = ["device=cpu", "model=Hengshuang", "dtype=bf16", "synthetic=16", "num_point=64",
            "batch_size=8", f"out_dir={out_dir}", "model.nblocks=2", "model.nneighbor=8",
            "model.transformer_dim=64"]
    cli.main(argv + ["epoch=2"])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch ")]
    tests = [TEST_LINE.match(line) for line in lines if line.startswith("Test Instance")]
    assert len(epochs) == len(tests) == 2 and all(epochs) and all(tests)
    assert "Save model..." in lines and lines[-1] == "End of training..."
    ckpt = Checkpointer(os.path.join(out_dir, "Hengshuang", "none", "False", "ckpt"))
    latest = ckpt.latest_step()
    assert latest in (0, 1)
    cfg = config.load_task_config("cls", ["model=Hengshuang", "num_point=64", "model.nblocks=2",
                                          "model.nneighbor=8", "model.transformer_dim=64"])
    cfg.num_class, cfg.input_dim = 40, 6
    model = make_point_model(cfg, "cls", dtype=torch.bfloat16)
    state = TrainState(model, optim.make_optimizer(dict(model.named_parameters()), "SGD"))
    ckpt.restore_into(state)
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in model.parameters())
    cli.main(argv + ["epoch=3"])
    lines = capsys.readouterr().out.splitlines()
    assert "Use pretrain model" in lines
    assert [int(m.group(1)) for m in map(EPOCH_LINE.match, lines) if m] == list(
        range(latest + 2, 4))


def test_cli_resumed_run_draws_the_unbroken_runs_augmentation(tmp_path, monkeypatch):
    """A run stopped after one epoch and resumed draws, step by step, the
    augmentation an unbroken run draws at the same optimizer steps: each draw is
    the augmentation of one fixed probe batch from a copy of the generator as
    the step hands it over (the batches differ: both packages restart the host
    shuffle from the seed)."""
    real = augment.device_cls_augment
    probe = torch.from_numpy(np.random.RandomState(3).randn(8, 64, 6).astype(np.float32))
    draws = []

    def recording(gen, x):
        copy_gen = torch.Generator(device=gen.device)
        copy_gen.set_state(gen.get_state())
        draws.append(real(copy_gen, probe))
        return real(gen, x)

    monkeypatch.setattr(augment, "device_cls_augment", recording)
    argv = ["device=cpu", "model=Hengshuang", "synthetic=16", "num_point=64", "batch_size=8",
            "model.nblocks=2", "model.nneighbor=8", "model.transformer_dim=64"]
    cli.main(argv + ["epoch=2", f"out_dir={tmp_path / 'unbroken'}"])
    unbroken, draws[:] = list(draws), []
    stopped = argv + [f"out_dir={tmp_path / 'stopped'}"]
    cli.main(stopped + ["epoch=1"])
    first, draws[:] = list(draws), []
    cli.main(stopped + ["epoch=2"])
    resumed = list(draws)
    assert len(unbroken) == 4 and len(first) == len(resumed) == 2  # 2 steps an epoch
    assert all(torch.equal(a, b) for a, b in zip(first + resumed, unbroken))
    assert not torch.equal(unbroken[0], unbroken[2])  # the epochs' draws differ


def test_cli_trains_3dvit_at_bf16_and_does_not_move_to_the_cpu_by_itself(tmp_path, capsys):
    """``model=3DViT dtype=bf16`` (refused before this slice) trains: its epoch
    and eval lines, and a checkpoint of f32 parameters."""
    out_dir = str(tmp_path / "run")
    cli.main(["device=cpu", "synthetic=16", "num_point=64", "batch_size=8", "epoch=2",
              "dtype=bf16", f"out_dir={out_dir}"])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch ")]
    tests = [TEST_LINE.match(line) for line in lines if line.startswith("Test Instance")]
    assert len(epochs) == len(tests) == 2 and all(epochs) and all(tests)
    ckpt = Checkpointer(os.path.join(out_dir, "3DViT", "deit_tiny_patch16_224", "True", "ckpt"))
    state, _ = ckpt.restore()
    assert state["params"]["blocks.0.attn.qkv.weight"].dtype == torch.float32
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main(["synthetic=8", "model=Hengshuang"])


if __name__ == "__main__":
    # The gradients of one train step, the port's f32 and the JAX package's f32
    # against the JAX package's float64: the worst leaves, each error over the
    # leaf's own largest value.
    torch.set_num_threads(1)
    _, want, _ = _jax_float64_witness()
    _, port_grads, _, _ = _port_run()
    _, jax_grads, _ = _jax_run(np.float32)
    for label, got in (("port f32", port_grads), ("JAX f32", jax_grads)):
        rel, small = _gradient_errors(got, want)
        print(f"{label} against JAX float64: {len(rel)} leaves, worst",
              ", ".join(f"{k} {rel[k]:.3e}" for k in sorted(rel, key=rel.get)[-3:][::-1]),
              f"; {len(small)} small leaves, worst {max(small, key=small.get)} "
              f"{max(small.values()):.3e} of the largest gradient")
