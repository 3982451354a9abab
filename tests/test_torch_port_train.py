"""The port's training path against the JAX package's, on the CPU: schedules,
loss, host modules (kept as the port's own copies), train steps of VoxelViT,
and the trainer CLI. Inputs are made with numpy from a seed."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.data import binvox as jax_binvox
from simple3dformer_tpu.data import datasets as jax_datasets
from simple3dformer_tpu.data.pipeline import DeviceResidentDataset as JaxDeviceResidentDataset
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.models.voxel_vit import frozen_mask as jax_frozen_mask
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.eval_metrics import ClassificationMeter as JaxMeter
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import cross_entropy as jax_cross_entropy
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu_torch.cli import train_cls_voxel as cli
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.data import binvox, datasets
from simple3dformer_tpu_torch.data.classmaps import CLASSES_ModelNet40
from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT, frozen_mask
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.train import health, optim
from simple3dformer_tpu_torch.train.eval_metrics import ClassificationMeter
from simple3dformer_tpu_torch.train.loop import (TrainState, cross_entropy, make_eval_step,
                                                 make_scanned_eval, make_scanned_train_steps,
                                                 make_train_step)
from simple3dformer_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V, CELL, PATCH, B, IMG = 12, 4, 3, 4, 32
BACKBONE = "deit_tiny_patch16_224"


def test_schedules_equal_jax_over_3000_epochs():
    for epoch in range(3000):
        assert optim.steplr(0.05, 20, 0.5, epoch) == jax_optim.steplr(0.05, 20, 0.5, epoch)
        assert (optim.untuned_linear_warmup_factor(epoch)
                == jax_optim.untuned_linear_warmup_factor(epoch))
        for warmup in (False, True):
            assert (optim.epoch_lr(0.05, epoch, 20, 0.5, warmup)
                    == jax_optim.epoch_lr(0.05, epoch, 20, 0.5, warmup))
    # the int(2 / (1 - beta2)) truncation: 2 / 0.001 is 1999.99... in floats
    assert optim.untuned_linear_warmup_factor(1998) == 1.0


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(weighted):
    rs = np.random.RandomState(0)
    logits = (3 * rs.randn(16, 7)).astype(np.float32)
    labels = rs.randint(0, 7, 16).astype(np.int32)
    w = rs.rand(7).astype(np.float32) + 0.5 if weighted else None
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if w is None else jnp.asarray(w))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_epoch_indices_and_gather_match_jax(shuffle, drop_last):
    rs = np.random.RandomState(1)
    x = rs.randint(0, 2, (37, 3, 4, 5)).astype(np.uint8)
    y = rs.randint(0, 40, 37).astype(np.int32)
    ours, theirs = DeviceResidentDataset({"x": x, "y": y}, "cpu"), JaxDeviceResidentDataset({"x": x, "y": y})
    idx = ours.epoch_indices(8, np.random.RandomState(4), shuffle, drop_last)
    np.testing.assert_array_equal(idx, theirs.epoch_indices(8, np.random.RandomState(4), shuffle,
                                                           drop_last))
    batch = ours.gather(ours.put_indices(idx))
    assert batch["x"].dtype == torch.uint8 and batch["x"].shape == (*idx.shape, 3, 4, 5)
    np.testing.assert_array_equal(batch["x"].numpy(), x[idx])
    np.testing.assert_array_equal(batch["y"].numpy(), y[idx])


def test_classification_meter_matches_jax():
    rs = np.random.RandomState(2)
    ours, theirs = ClassificationMeter(10), JaxMeter(10)
    for _ in range(3):
        pred, label = rs.randint(0, 10, 50), rs.randint(0, 9, 50)  # class 9 never seen
        ours.update(pred, label)
        theirs.update(pred, label)
    assert ours.overall_accuracy == theirs.overall_accuracy
    assert ours.mean_class_accuracy == theirs.mean_class_accuracy


def _write_binvox(path, data, translate=(0.5, -1.0, 2.0), scale=1.5):
    vox = jax_binvox.Voxels(data, list(data.shape), list(translate), scale, "xyz")
    with open(path, "wb") as f:
        jax_binvox.write(vox, f)


def test_binvox_reader_and_modelnet_reader_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    grids = {}
    for cls_name in ("airplane", "night_stand"):
        (tmp_path / cls_name / "train").mkdir(parents=True)
        for i in range(2):
            data = rs.rand(8, 8, 8) > 0.7
            path = tmp_path / cls_name / "train" / f"{cls_name}_{i + 1:04d}.binvox"
            _write_binvox(path, data)
            grids[str(path)] = data
    for path, data in grids.items():
        with open(path, "rb") as f:
            got = binvox.read_as_3d_array(f)
        with open(path, "rb") as f:
            want = jax_binvox.read_as_3d_array(f)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.data, data)
        assert (got.dims, got.translate, got.scale) == (want.dims, want.translate, want.scale)
        with open(path, "rb") as f:
            raw = binvox.read_as_3d_array(f, fix_coords=False)
        assert raw.axis_order == "xzy"
        np.testing.assert_array_equal(raw.data, np.transpose(data, (0, 2, 1)))
    ours = datasets.ModelNetVoxelDataset(str(tmp_path), CLASSES_ModelNet40, "train")
    theirs = jax_datasets.ModelNetVoxelDataset(str(tmp_path), CLASSES_ModelNet40, "train")
    assert ours.samples == theirs.samples and len(ours) == 4
    x, y = ours.materialize()
    assert x.dtype == np.uint8 and x.shape == (4, 8, 8, 8)
    np.testing.assert_array_equal(x, np.stack([theirs[i]["voxel"] for i in range(4)]))
    np.testing.assert_array_equal(y, theirs.labels())
    np.testing.assert_array_equal(ours.class_weight(), theirs.class_weight())
    assert ours[1]["cls_idx"] == theirs[1]["cls_idx"]


def test_check_finite_names_the_step():
    health.check_finite({"loss": np.array([1.0, 2.0])}, 0)
    with pytest.raises(health.TrainingDiverged, match="step 1"):
        health.check_finite({"loss": np.array([1.0, np.nan, 3.0])}, 4)


def _models():
    emb = JaxVoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=192)
    jm = JaxVoxelViT(voxel_embed=emb, n_classes=7, transformer_backbone=BACKBONE, img_size=IMG)
    variables = jm.init(jax.random.key(0), jnp.zeros((2, V, V, V)),
                        jnp.zeros((1, IMG, IMG, 3)), method=JaxVoxelViT.init_all)
    rs = np.random.RandomState(6)  # perturbed so that zero-initialised leaves matter too
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    pm = VoxelViT(VoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=192),
                  n_classes=7, transformer_backbone=BACKBONE, img_size=IMG)
    assert not convert.load_jax_params(pm, params)
    return jm, params, pm


def test_three_train_steps_match_jax():
    lr = 1e-3
    jm, params, pm = _models()
    tx = jax_optim.make_optimizer("Adam", trainable_mask=jax_frozen_mask(params, False))
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    jstep = jax_make_train_step(jm, tx, donate=False)
    opt = optim.make_optimizer(dict(pm.named_parameters()), "Adam",
                               trainable_mask=frozen_mask(pm, False))
    step = make_train_step(TrainState(pm, opt))
    rs = np.random.RandomState(7)
    for _ in range(3):
        x = (rs.rand(B, V, V, V) > 0.8).astype(np.float32)
        y = rs.randint(0, 7, B).astype(np.int32)
        jstate, jm_out = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, lr,
                               jax.random.key(1))
        out = step({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, lr)
        np.testing.assert_allclose(float(out["loss"]), float(jm_out["loss"]), rtol=1e-4)
        assert float(out["accuracy"]) == float(jm_out["accuracy"])
    assert opt.count == int(jstate.step) == 3
    # Adam turns a sign difference in a gradient that is all rounding noise into up to
    # +-lr per step, so after 3 steps parameters agree to 3 lr
    want = convert.jax_to_state_dict(jax.device_get(jstate.params), pm.state_dict())
    got = pm.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=3 * lr, err_msg=k)


def test_frozen_mask_matches_jax():
    _, params, pm = _models()
    like = pm.state_dict()
    for pretrained in (False, True):
        jmask = jax_frozen_mask(params, pretrained)
        ours = frozen_mask(pm, pretrained)
        for path, leaf in convert._leaves(params):
            key, _ = convert._name_and_value(path, leaf, like)
            node = jmask
            for p in path:
                node = node[p]
            assert ours[key] == bool(node), key
    assert not frozen_mask(pm, True)["head.weight"] and frozen_mask(pm, True)["voxel_head.weight"]


def test_scanned_steps_eval_and_checkpoint_roundtrip(tmp_path):
    torch.manual_seed(0)
    _, _, pm = _models()
    opt = optim.make_optimizer(dict(pm.named_parameters()), "Adam")
    state = TrainState(pm, opt)
    rs = np.random.RandomState(8)
    ds = DeviceResidentDataset({"x": (rs.rand(12, V, V, V) > 0.8).astype(np.uint8),
                                "y": rs.randint(0, 7, 12).astype(np.int32)}, "cpu")
    idx = ds.put_indices(ds.epoch_indices(4, np.random.RandomState(0)))
    metrics = make_scanned_train_steps(state, ds)(idx, 1e-3)
    assert metrics["loss"].shape == (3,) and bool(torch.isfinite(metrics["loss"]).all())
    logits = make_scanned_eval(pm, ds)(idx)
    assert logits.shape == (3, 4, 7) and not pm.training
    torch.testing.assert_close(logits[0], make_eval_step(pm)(ds.gather(idx[0])["x"].float()))

    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(state.step, state.state_dict(), {"accuracy": 0.5})
    _, _, fresh = _models()
    fresh_state = TrainState(fresh, optim.make_optimizer(dict(fresh.named_parameters()), "Adam"))
    restored, metrics = ckpt.restore_into(fresh_state)
    assert restored is fresh_state and metrics == {"accuracy": 0.5} and fresh_state.step == 3
    for k, v in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    for k in opt.names:
        assert torch.equal(fresh_state.optimizer.mu[k], opt.mu[k])
        assert torch.equal(fresh_state.optimizer.nu[k], opt.nu[k])
    assert Checkpointer(str(tmp_path / "empty")).restore_into(fresh_state) == (None, None)


# the JAX CLI's epoch line (simple3dformer_tpu/cli/train_cls_voxel.py:279-282)
EPOCH_LINE = re.compile(r"^Epoch (\d+) loss (\d+\.\d{4}) test accuracy (\d\.\d{6}), "
                        r"mean class accuracy (\d\.\d{6}) \((\d+\.\d) samples/sec\)$")


def test_cli_trains_on_the_cpu_and_restores(tmp_path, capsys):
    argv = ["--dataset", "ModelNet40", "--synthetic", "64", "--epochs", "2", "--batchSize", "16",
            "--transformer-name", BACKBONE, "--cell-size", "6", "--patch-size", "5",
            "--lr", "0.02", "--device", "cpu", "--outf", str(tmp_path / "cls")]
    best = cli.main(argv)
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch")]
    assert len(epochs) == 2 and all(epochs)
    assert [int(m.group(1)) for m in epochs] == [0, 1]
    assert "train 64 / test 16 samples, 40 classes" in lines  # the test set floors at B
    assert re.match(r"^Best test accuracy: epoch \d test accuracy \d\.\d{6}$", lines[-1])
    assert 0.0 <= best <= 1.0
    ckpt_dir = tmp_path / "cls" / "Voxel3D_2DPretrain" / "VoxelEmbed_default" / BACKBONE / "ckpt"
    state, metrics = Checkpointer(str(ckpt_dir)).restore()
    assert set(state) == {"params", "opt_state", "step"} and state["step"] in (4, 8)
    assert metrics["accuracy"] == best  # the last save is the best epoch
    cli.main(argv[:-2] + ["--outf", str(tmp_path / "again"), "--epochs", "1",
                          "--model", str(ckpt_dir)])
    assert capsys.readouterr().out.count("Epoch 0 loss") == 1


@pytest.mark.parametrize("flag,match", [
    (["--zero1"], "parallelism"), (["--pos-embedding", "group_embed"], "other voxel routes"),
])
def test_cli_refuses_what_is_not_ported(flag, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["--synthetic", "8", "--device", "cpu"] + flag)


@pytest.mark.parametrize("bf16_nu", ["auto", "0"])
def test_cli_trains_at_bf16_on_the_cpu(tmp_path, capsys, bf16_nu):
    """``--dtype bf16`` (refused before this slice): the epoch lines, the model
    computing in bf16 with f32 parameters, and Adam's second moment in bf16
    under ``--bf16-nu auto`` (in f32 under ``0``), as the checkpoint holds it."""
    argv = ["--dataset", "ModelNet40", "--synthetic", "32", "--epochs", "2", "--batchSize", "16",
            "--transformer-name", BACKBONE, "--cell-size", "6", "--patch-size", "5",
            "--lr", "0.02", "--device", "cpu", "--outf", str(tmp_path / "cls"),
            "--dtype", "bf16", "--bf16-nu", bf16_nu]
    cli.main(argv)
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch")]
    assert len(epochs) == 2 and all(epochs)
    ckpt_dir = tmp_path / "cls" / "Voxel3D_2DPretrain" / "VoxelEmbed_default" / BACKBONE / "ckpt"
    state, _ = Checkpointer(str(ckpt_dir)).restore()
    nu = state["opt_state"]["nu"]
    assert {v.dtype for v in nu.values()} == {torch.bfloat16 if bf16_nu == "auto"
                                              else torch.float32}
    assert state["params"]["blocks.0.attn.qkv.weight"].dtype == torch.float32


def test_cli_does_not_move_to_the_cpu_by_itself():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--synthetic", "8"])


def test_load_voxel_arrays_synthetic_matches_jax_cli_stream():
    from simple3dformer_tpu.cli.train_cls_voxel import load_voxel_arrays as jax_load

    got = cli.load_voxel_arrays("ModelNet40", "", 40, min_test=16, seed=3)
    want = jax_load("ModelNet40", "", 40, min_test=16, seed=3)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4:] == want[4:]
