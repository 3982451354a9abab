"""The port's S3DIS semantic-segmentation path against the JAX package's, on
the CPU: the SemSeg metrics, the room-block reader, the CLI's synthetic
stream, three SGD steps of the 3DViT_s3dis seg model, and the CLI itself.
Inputs are made with numpy."""

import copy
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.cli import train_s3dis_semseg as jax_cli
from simple3dformer_tpu.core import config as jax_config
from simple3dformer_tpu.data.datasets import S3DISDataset as JaxS3DISDataset
from simple3dformer_tpu.models.point_vit import PointViT as JaxPointViT
from simple3dformer_tpu.train import eval_metrics as jax_metrics
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu.train.loop import seg_cross_entropy as jax_seg_ce
from simple3dformer_tpu_torch.cli import train_s3dis_semseg as cli
from simple3dformer_tpu_torch.core import config
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.data.datasets import S3DISDataset
from simple3dformer_tpu_torch.models.point_vit import PointViT
from simple3dformer_tpu_torch.nn import layers
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


def _same_meters(ours, theirs):
    assert ours.shape_ious == theirs.shape_ious
    for name in ("accuracy", "mean_class_accuracy", "miou", "class_avg_iou", "instance_avg_iou"):
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("flat", [False, True], ids=["per-sample", "flat"])
def test_semseg_meter_matches_jax(flat):
    rs = np.random.RandomState(4)
    ours, theirs = eval_metrics.SemSegMeter(13), jax_metrics.SemSegMeter(13)
    for _ in range(3):
        label = rs.randint(0, 13, (5, 40))
        pred = np.where(rs.rand(5, 40) < 0.4, label, rs.randint(0, 13, (5, 40)))
        pred[0] = (label[0] + 1) % 13  # a sample whose first-point class is never predicted
        if flat:
            pred, label = pred.reshape(-1), label.reshape(-1)
        ours.update(pred, label)
        theirs.update(pred, label)
    _same_meters(ours, theirs)
    assert bool(ours.shape_ious[0] or ours.shape_ious[1]) != flat


def _rooms(root, rs):
    """Two training rooms and one test room (Area_5) of x y z r g b label."""
    for name, n, size in (("Area_1_office_1.npy", 600, 3.0), ("Area_2_hall_1.npy", 300, 6.0),
                          ("Area_5_office_9.npy", 400, 2.0)):
        xyz = rs.rand(n, 3) * [size, size, 3.0]
        rgb = rs.randint(0, 256, (n, 3))
        label = rs.randint(0, 13, (n, 1))
        np.save(root / name, np.concatenate([xyz, rgb, label], axis=1).astype(np.float32))


@pytest.mark.parametrize("split", ["train", "test"])
def test_s3dis_dataset_matches_jax(tmp_path, split):
    _rooms(tmp_path, np.random.RandomState(5))
    ours = S3DISDataset(str(tmp_path), split=split, num_point=64, rng=np.random.RandomState(6))
    theirs = JaxS3DISDataset(str(tmp_path), split=split, num_point=64,
                             rng=np.random.RandomState(6))
    np.testing.assert_array_equal(ours.labelweights, theirs.labelweights)
    np.testing.assert_array_equal(ours.room_idxs, theirs.room_idxs)
    assert len(ours) == len(theirs) > 0
    for i in list(range(len(ours)))[:6] * 2:  # the same draws, in the same order
        (x, y), (jx, jy) = ours[i], theirs[i]
        assert x.shape == (64, 9) and x.dtype == np.float32 and y.dtype == np.int32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_synthetic_stream_matches_jax_cli():
    ov = ["synthetic=40", "num_point=32", "seed=3"]
    got = cli.load_arrays(config.load_task_config("semseg", ov))
    want = jax_cli.load_arrays(jax_config.load_task_config("semseg", ov))
    for split_got, split_want in zip(got, want):
        for a, b in zip(split_got, split_want):
            np.testing.assert_array_equal(a, b)
    assert len(got[1][0]) == 16  # max(40 // 5, 16) test blocks


N, B, K = 64, 2, 8


def _s3dis_models(backbone, bn_momentum):
    """The JAX 3DViT_s3dis seg model (9 inputs, 13 classes) at N=64 points, its
    init with seeded noise on every leaf, and the port's model loaded from it."""
    jm = JaxPointViT(variant="3DViT_s3dis", task="seg", num_point=N, num_class=13, input_dim=9,
                     nneighbor=K, transformer_backbone=backbone, bn_momentum=bn_momentum)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, N, 9)))
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = jax.device_get(variables["batch_stats"])
    pm = PointViT("3DViT_s3dis", "seg", N, 13, input_dim=9, nneighbor=K,
                  transformer_backbone=backbone)
    layers.set_bn_momentum(pm, bn_momentum)
    convert.load_jax_params(pm, params, stats)
    return jm, params, stats, pm


def _batches(n):
    data = np.random.RandomState(10)
    return [(data.rand(B, N, 9).astype(np.float32), data.randint(0, 13, (B, N)).astype(np.int32))
            for _ in range(n)]


def _state_errors(jstate, pm):
    """Each state-dict tensor's largest difference from the JAX state, over
    that tensor's largest value."""
    want = convert.jax_to_state_dict(jax.device_get(jstate.params), pm.state_dict(),
                                     jax.device_get(jstate.batch_stats))
    got = pm.state_dict()
    return {k: float((got[k] - v).abs().max()) / max(float(v.abs().max()), 1e-6)
            for k, v in want.items()}


CORE = ("blocks.", "norm.", "cls_token", "head.")


def test_three_sgd_train_steps_match_jax():
    """Three steps of the 3DViT_s3dis seg model at deit_tiny width (17 tokens,
    the blocks' plain path on the CPU) on inputs drawn as the CLI's stream
    draws them (uniform in [0, 1)), SGD at the config's lr 0.5, the first
    epoch's BatchNorm momentum.

    Losses within 1e-4 and accuracies within one point at every step. The
    state within 1e-4 of each tensor's largest value after the first two
    steps: the inputs are all positive, so the gradients before each
    BatchNorm are small sums of large terms that the two packages round
    differently (measured up to 2.9e-5). On the third batch a max over
    neighbours in the second transition-down lies within 1e-5 of a tie, and
    the point layers then part by up to 1.1%; the ViT blocks, the final norm,
    the cls token and the head stay within 1e-4."""
    lr, momentum = 0.5, 1.0 - 0.9
    jm, params, stats, pm = _s3dis_models("deit_tiny_patch16_224", momentum)
    tx = jax_optim.make_optimizer("SGD")
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                                jax.tree_util.tree_map(jnp.asarray, stats))
    jstep = jax_make_train_step(jm, tx, loss_fn=jax_seg_ce, has_batch_stats=True, donate=False)
    step = make_train_step(TrainState(pm, optim.make_optimizer(dict(pm.named_parameters()), "SGD")),
                           seg_cross_entropy)
    for i, (x, y) in enumerate(_batches(3)):
        jstate, jout = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, lr,
                             jax.random.key(1))
        out = step({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, lr)
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-4)
        assert abs(float(out["accuracy"]) - float(jout["accuracy"])) <= 1.0 / (B * N)
        errs = _state_errors(jstate, pm)
        checked = {k: e for k, e in errs.items() if i < 2 or k.startswith(CORE)}
        assert len(checked) > 100 and max(checked.values()) <= 1e-4, (i, sorted(
            checked.items(), key=lambda kv: -kv[1])[:5])


def test_deit_base_loss_matches_jax_and_gradients_match_float64():
    """At the S3DIS width (deit_base: D=768, 3 heads of 256) the model loads
    from the JAX init and its train-mode loss equals the JAX package's. Its f32
    gradients are held against a float64 run of the same model, within 1e-4 of
    each tensor's largest value: on this input the JAX package's f32 gradients
    differ from that float64 run beyond rounding, so they are no reference here."""
    jm, params, stats, pm = _s3dis_models("deit_base_patch16_224", 0.1)
    x, y = _batches(1)[0]
    jloss = jax.jit(lambda p, s: jax_seg_ce(jm.apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x), deterministic=False,
        mutable=["batch_stats"])[0], jnp.asarray(y)))(params, stats)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(pm).to(dtype).train()
        loss = seg_cross_entropy(model(torch.from_numpy(x).to(dtype)), torch.from_numpy(y))
        grads[dtype] = torch.autograd.grad(loss, list(model.parameters()))
        if dtype == torch.float32:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # a gradient that nearly vanishes (a bias whose shift the BatchNorms' mean
    # mostly removes: the stem's second bias, 3e-7 of the largest gradient) is
    # a small sum of terms that cancel, each rounded at the scale of the model's
    # gradients: the floor is 1e-5 of the largest gradient of the model
    top = max(float(b.abs().max()) for b in grads[torch.float64])
    for name, a, b in zip([k for k, _ in pm.named_parameters()], *grads.values()):
        atol = max(1e-4 * float(b.abs().max()), 1e-5 * top)
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=0, atol=atol, err_msg=name)


EPOCH_LINE = re.compile(r"^Epoch (\d+) lr (\d+\.\d{6}) loss (\d+\.\d{4}) "
                        r"\((\d+\.\d) samples/sec\)$")
EVAL_LINE = re.compile(r"^eval accuracy: \d\.\d{6}  mAcc: \d\.\d{6}  mIoU: \d\.\d{6}  "
                       r"Class avg mIOU: \d\.\d{6}  Inctance avg mIOU: (\d\.\d{6})$")


def test_cli_trains_on_the_cpu_and_restores(tmp_path, capsys):
    out_dir = str(tmp_path / "run")
    best = cli.main(["device=cpu", "synthetic=8", "epoch=2", "num_point=64", "step_size=1",
                     "model.transformer_backbone=deit_tiny_patch16_224", f"out_dir={out_dir}"])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch ")]
    evals = [EVAL_LINE.match(line) for line in lines if line.startswith("eval ")]
    assert len(epochs) == len(evals) == 2 and all(epochs) and all(evals)
    assert [float(m.group(2)) for m in epochs] == [0.5, 0.4]  # lr * 0.8^(epoch // 1)
    assert [line for line in lines if line.startswith("BN momentum")] == [
        "BN momentum updated to: 0.900000", "BN momentum updated to: 0.450000"]
    assert "train 8 / test 16 blocks" in lines
    assert lines[-1] == f"Best Inctance avg mIOU: {best:f}"
    run = os.path.join(out_dir, "3DViT_s3dis", "deit_tiny_patch16_224", "True")
    assert os.path.exists(os.path.join(run, "resolved_config.json"))
    cfg = config.load_task_config("semseg", ["num_point=64",
                                             "model.transformer_backbone=deit_tiny_patch16_224"])
    cfg.num_class, cfg.input_dim = cli.NUM_CLASS, cli.INPUT_DIM
    model = PointViT.from_config(cfg, "seg")
    state = TrainState(model, optim.make_optimizer(dict(model.named_parameters()), "SGD"))
    restored, metrics = Checkpointer(os.path.join(run, "ckpt")).restore_into(state)
    assert restored is state and metrics["instance_avg_iou"] == pytest.approx(best)
    assert state.step in (2, 4)
    assert torch.isfinite(model.eval()(torch.zeros(1, 64, 9))).all()


@pytest.mark.parametrize("overrides", [
    ["dtype=bf16"], ["model=Hengshuang"], ["model=Hengshuang", "dtype=bf16"],
], ids=["3DViT-bf16", "Hengshuang-f32", "Hengshuang-bf16"])
def test_cli_trains_every_model_in_both_dtypes(tmp_path, capsys, overrides):
    """The routes the CLI refused before this slice: 3DViT_s3dis (at deit_tiny
    width) at bf16 and PointTransformerSeg (at test size) in f32 and bf16: the
    epoch and eval lines, finite losses, a checkpoint of the best epoch."""
    model = "Hengshuang" if "model=Hengshuang" in overrides else "3DViT_s3dis"
    small = (["model.nblocks=2", "model.nneighbor=8", "model.transformer_dim=64"]
             if model == "Hengshuang" else ["model.transformer_backbone=deit_tiny_patch16_224"])
    out_dir = str(tmp_path / "run")
    best = cli.main(["device=cpu", "synthetic=8", "epoch=2", "num_point=64", "step_size=1",
                     f"out_dir={out_dir}", *overrides, *small])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch ")]
    evals = [EVAL_LINE.match(line) for line in lines if line.startswith("eval ")]
    assert len(epochs) == len(evals) == 2 and all(epochs) and all(evals)
    assert np.isfinite([float(m.group(3)) for m in epochs]).all()
    assert lines[-1] == f"Best Inctance avg mIOU: {best:f}"
    backbone = "none" if model == "Hengshuang" else "deit_tiny_patch16_224"
    pretrained = "False" if model == "Hengshuang" else "True"
    ckpt_dir = os.path.join(out_dir, model, backbone, pretrained, "ckpt")
    state, metrics = Checkpointer(ckpt_dir).restore()
    assert metrics["instance_avg_iou"] == pytest.approx(best) and state["step"] in (2, 4)
