"""The port's partseg training path against the JAX package's, on the CPU: SGD
with momentum, three train steps of the 3DViT seg model with BatchNorm
statistics, the ShapeNetPart metrics, the config loader, the dataset reader,
the synthetic stream and the partseg CLI. Inputs are made with numpy."""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.cli import train_partseg as jax_cli
from simple3dformer_tpu.core import config as jax_config
from simple3dformer_tpu.data.datasets import PartNormalDataset as JaxPartNormalDataset
from simple3dformer_tpu.models.point_vit import PointViT as JaxPointViT
from simple3dformer_tpu.train import eval_metrics as jax_metrics
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu.train.loop import seg_cross_entropy as jax_seg_ce
from simple3dformer_tpu_torch.cli import _common as common
from simple3dformer_tpu_torch.cli import train_partseg as cli
from simple3dformer_tpu_torch.core import config
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.data import augment
from simple3dformer_tpu_torch.data.datasets import PartNormalDataset
from simple3dformer_tpu_torch.models.point_vit import PointViT
from simple3dformer_tpu_torch.train import eval_metrics, optim
from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step, seg_cross_entropy
from simple3dformer_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, B, K = 64, 2, 8


def test_sgd_matches_optax_trace_with_mask():
    rs = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    mask = {"a": True, "b": True, "c": False}
    tx = jax_optim.make_optimizer("SGD", trainable_mask=mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = optim.make_optimizer(tp, "SGD", trainable_mask=mask)
    for step in range(3):
        grads = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
        if step == 1:
            grads["b"] = np.zeros(shapes["b"], np.float32)  # the loss did not reach b
        up, st = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), st, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, jax_optim.apply_lr(up, 0.05))
        opt.step({k: None if (step == 1 and k == "b") else torch.from_numpy(g)
                  for k, g in grads.items()}, 0.05)
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert set(opt.trace) == {"a", "b"} and opt.count == 3


def test_sgd_refuses_weight_decay():
    with pytest.raises(NotImplementedError, match="weight decay"):
        optim.make_optimizer({"a": torch.nn.Parameter(torch.zeros(2))}, "SGD", weight_decay=1e-4)


def _models(bn_momentum):
    jm = JaxPointViT(variant="3DViT", task="seg", num_point=N, num_class=50, input_dim=22,
                     nneighbor=K, bn_momentum=bn_momentum)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, N, 22)))
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = jax.device_get(variables["batch_stats"])
    pm = PointViT("3DViT", "seg", N, 50, input_dim=22, nneighbor=K)
    pm.set_bn_momentum(bn_momentum)
    convert.load_jax_params(pm, params, stats)
    return jm, params, stats, pm


def _batches(n):
    rs = np.random.RandomState(10)
    out = []
    for _ in range(n):
        cats = rs.randint(0, 16, B).astype(np.int32)
        segs = np.stack([rs.choice(eval_metrics.SEG_CLASSES[list(eval_metrics.SEG_CLASSES)[c]],
                                   N) for c in cats]).astype(np.int32)
        out.append({"x": rs.randn(B, N, 6).astype(np.float32), "cls": cats, "y": segs})
    return out


def test_three_sgd_train_steps_match_jax():
    """A ReLU input within a rounding of zero takes its gradient on one side
    and not on the other, and the runs then part (by 1e-4 of a parameter
    within a step); these inputs have none such, so the tolerance is the
    rounding of f32 sums in another order."""
    lr, momentum = 0.05, 1.0 - 0.9  # the partseg CLI's first epoch: flax momentum 0.1
    jm, params, stats, pm = _models(momentum)
    tx = jax_optim.make_optimizer("SGD")
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                                jax.tree_util.tree_map(jnp.asarray, stats))
    jstep = jax_make_train_step(jm, tx, loss_fn=jax_seg_ce, has_batch_stats=True, donate=False)
    jprepare = jax_cli.make_prepare_fn()
    opt = optim.make_optimizer(dict(pm.named_parameters()), "SGD")
    step = make_train_step(TrainState(pm, opt), seg_cross_entropy,
                           prepare_fn=cli.make_prepare_fn())
    for batch in _batches(3):
        x, y = jprepare({k: jnp.asarray(v) for k, v in batch.items()})
        jstate, jout = jstep(jstate, {"x": x, "y": y}, lr, jax.random.key(1))
        out = step({k: torch.from_numpy(v) for k, v in batch.items()}, lr)
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-4)
        assert abs(float(out["accuracy"]) - float(jout["accuracy"])) <= 1.0 / (B * N)
    want = convert.jax_to_state_dict(jax.device_get(jstate.params), pm.state_dict(),
                                     jax.device_get(jstate.batch_stats))
    got = pm.state_dict()
    assert any("running_var" in k for k in want)
    for k, v in want.items():
        scale = max(float(v.abs().max()), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


def test_seg_cross_entropy_matches_jax():
    rs = np.random.RandomState(3)
    logits = (3 * rs.randn(2, 7, 50)).astype(np.float32)
    labels = rs.randint(0, 50, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        float(seg_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jax_seg_ce(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


def test_part_seg_meter_matches_jax():
    rs = np.random.RandomState(4)
    assert eval_metrics.SEG_CLASSES == jax_metrics.SEG_CLASSES
    assert eval_metrics.SEG_LABEL_TO_CAT == jax_metrics.SEG_LABEL_TO_CAT
    ours, theirs = eval_metrics.PartSegMeter(), jax_metrics.PartSegMeter()
    for _ in range(3):
        cats = rs.randint(0, 16, 5)
        target = np.stack([rs.choice(list(eval_metrics.SEG_CLASSES.values())[c], 30)
                           for c in cats])
        logits = rs.randn(5, 30, 50).astype(np.float32)
        ours.update(logits, target)
        theirs.update(logits, target)
    assert ours.shape_ious == theirs.shape_ious
    assert (ours.accuracy, ours.class_avg_iou, ours.instance_avg_iou) == \
        (theirs.accuracy, theirs.class_avg_iou, theirs.instance_avg_iou)
    np.testing.assert_array_equal(
        eval_metrics.category_restricted_argmax(logits[0], "Lamp"),
        jax_metrics.category_restricted_argmax(logits[0], "Lamp"))


CONFIG_FILES = sorted(p.stem for p in config.CONFIG_ROOT.glob("*.yaml"))
MODEL_FILES = sorted(p.stem for p in (config.CONFIG_ROOT / "model").glob("*.yaml"))


@pytest.mark.parametrize("task", CONFIG_FILES)
def test_config_loader_matches_jax_for_every_file(task):
    assert config.load_task_config(task).to_dict() == jax_config.load_task_config(task).to_dict()
    for model in MODEL_FILES:
        ov = [f"model={model}", "synthetic=1024", "learning_rate=1e-3", "model.nneighbor=8",
              "dtype=bf16", "normal=false", "out_dir=/tmp/x"]
        assert (config.load_task_config(task, ov).to_dict()
                == jax_config.load_task_config(task, ov).to_dict()), (task, model)


def test_config_parser_refuses_yaml_beyond_the_subset():
    with pytest.raises(ValueError):
        config.parse_yaml("a: [1, 2]\n")
    assert config.parse_yaml("a:\n  b: 1e-2\n  c: ~\n") == {"a": {"b": "1e-2", "c": None}}


def _partnormal_fixture(root, rs):
    cats = {"Airplane": "02691156", "Mug": "03797390"}
    (root / "train_test_split").mkdir(parents=True)
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{k}\t{v}\n" for k, v in cats.items()))
    lists = {"train": [], "val": [], "test": []}
    for cat, synset in cats.items():
        (root / synset).mkdir()
        for i in range(4):
            sid = f"{synset}_{i}"
            parts = eval_metrics.SEG_CLASSES[cat]
            data = np.concatenate([rs.randn(50 + i, 6), rs.choice(parts, (50 + i, 1))], axis=1)
            np.savetxt(root / synset / f"{sid}.txt", data, fmt="%.6f")
            lists[["train", "train", "val", "test"][i]].append(f"shape_data/{synset}/{sid}")
    for split, items in lists.items():
        (root / "train_test_split" / f"shuffled_{split}_file_list.json").write_text(
            json.dumps(items))


@pytest.mark.parametrize("split,normal", [("trainval", True), ("test", False)])
def test_part_normal_dataset_matches_jax(tmp_path, split, normal):
    _partnormal_fixture(tmp_path, np.random.RandomState(5))
    ours = PartNormalDataset(str(tmp_path), 32, split, normal_channel=normal,
                             rng=np.random.RandomState(6))
    theirs = JaxPartNormalDataset(str(tmp_path), 32, split, normal_channel=normal,
                                  rng=np.random.RandomState(6))
    assert len(ours) == len(theirs) == (6 if split == "trainval" else 2)
    for i in list(range(len(ours))) * 2:  # the second pass reads the cache
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)


def test_synthetic_stream_matches_jax_cli():
    ov = ["synthetic=40", "num_point=32", "seed=3"]
    cfg = config.load_task_config("partseg", ov)
    jcfg = jax_config.load_task_config("partseg", ov)
    for got, want in zip(cli.load_arrays(cfg), jax_cli.load_arrays(jcfg)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_prepare_and_augment():
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    x, y = cli.make_prepare_fn()(batch)
    jx, jy = jax_cli.make_prepare_fn()({k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert torch.equal(y, batch["y"])
    g = torch.Generator().manual_seed(0)
    aug = cli.seg_augment(g, x)
    assert torch.equal(aug[..., 3:], x[..., 3:])
    scale = augment.device_random_scale(torch.Generator().manual_seed(1), torch.ones(500, 4, 3))
    shift = augment.device_shift(torch.Generator().manual_seed(1), torch.zeros(500, 4, 3))
    assert 0.8 <= float(scale.min()) and float(scale.max()) < 1.25
    assert bool((scale == scale[:, :1, :1]).all())  # one scale per sample
    assert -0.1 <= float(shift.min()) and float(shift.max()) < 0.1
    assert bool((shift == shift[:, :1]).all())  # one shift per sample and axis


EPOCH_LINE = re.compile(r"^Epoch (\d+) lr (\d+\.\d{6}) train loss (\d+\.\d{4}) "
                        r"\((\d+\.\d) samples/sec\)$")
TEST_LINE = re.compile(r"^Epoch (\d+) test Accuracy: \d\.\d{6}  Class avg mIOU: \d\.\d{6}  "
                       r"Inctance avg mIOU: (\d\.\d{6})$")


def test_cli_trains_on_the_cpu_and_restores(tmp_path, capsys):
    out_dir = str(tmp_path / "run")
    best = cli.main(["device=cpu", "synthetic=32", "epoch=2", "num_point=64", "batch_size=8",
                     "step_size=1", f"out_dir={out_dir}"])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if "train loss" in line]
    tests = [TEST_LINE.match(line) for line in lines if "test Accuracy" in line]
    assert len(epochs) == len(tests) == 2 and all(epochs) and all(tests)
    assert [float(m.group(2)) for m in epochs] == [0.05, 0.025]  # lr * 0.5^(epoch // 1)
    assert [line for line in lines if line.startswith("BN momentum")] == [
        "BN momentum updated to: 0.900000", "BN momentum updated to: 0.450000"]
    assert "train 32 / test 32" in lines
    assert lines[-1] == f"Best inctance avg mIOU is: {best:f}"
    run = os.path.join(out_dir, "3DViT", "deit_tiny_patch16_224", "True")
    assert os.path.exists(os.path.join(run, "resolved_config.json"))
    ckpt = Checkpointer(os.path.join(run, "ckpt"))
    cfg = config.load_task_config("partseg", ["num_point=64"])
    cfg.num_class, cfg.input_dim = 50, 22
    model = PointViT.from_config(cfg, "seg")
    state = TrainState(model, optim.make_optimizer(dict(model.named_parameters()), "SGD"))
    restored, metrics = ckpt.restore_into(state)
    assert restored is state and metrics["instance_avg_iou"] == pytest.approx(best)
    assert state.step in (4, 8) and float(model.transition_ups[0].fc1._modules["2"]
                                          .num_batches_tracked) > 0
    # the model restored from the best epoch is the one the CLI evaluated
    x = torch.zeros(1, 64, 22)
    assert torch.isfinite(model.eval()(x)).all()


@pytest.mark.parametrize("override,match", [
    ("dtype=bf16", "bf16"), ("model=Hengshuang", "Hengshuang"),
])
def test_cli_refuses_what_is_not_ported(override, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["device=cpu", "synthetic=8", "num_point=16", override])


def test_cli_does_not_move_to_the_cpu_by_itself():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main(["synthetic=8"])
    with pytest.raises(ValueError):
        common.resolve_device("meta")
