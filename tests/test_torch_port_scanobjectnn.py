"""The port's ScanObjectNN classification path against the JAX package's, on
the CPU: the h5 readers on a file the test writes, the synthetic streams and
the h5 split as the JAX CLI loads them, and the CLI (train, eval, checkpoint)
from both, in f32 and at bf16, for both of its models. Inputs are made with
numpy."""

import os
import re

import numpy as np
import pytest
import torch

from simple3dformer_tpu.cli import train_cls_scanobjectnn as jax_cli
from simple3dformer_tpu.core import config as jax_config
from simple3dformer_tpu.data import datasets as jax_datasets
from simple3dformer_tpu_torch.cli import train_cls_scanobjectnn as cli
from simple3dformer_tpu_torch.core import config
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.data import datasets


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_split(root, n_train=24, n_test=10, npoint=80, seed=0):
    """The main split's two h5 files under ``root``: float64 clouds and int64
    labels of shape [n], as the ScanObjectNN files hold them."""
    h5py = pytest.importorskip("h5py")
    rs = np.random.RandomState(seed)
    for name, n in ((cli.TRAIN_H5, n_train), (cli.TEST_H5, n_test)):
        with h5py.File(os.path.join(root, name), "w") as f:
            f["data"] = rs.randn(n, npoint, 3)
            f["label"] = rs.randint(0, cli.NUM_CLASS, n).astype(np.int64)
    return root


@pytest.mark.parametrize("label_shape", [(6,), (6, 1)], ids=["flat", "column"])
def test_h5_readers_match_jax(tmp_path, label_shape):
    h5py = pytest.importorskip("h5py")
    rs = np.random.RandomState(1)
    path = str(tmp_path / "split.h5")
    with h5py.File(path, "w") as f:
        f["data"] = rs.randn(6, 20, 3)
        f["label"] = rs.randint(0, 15, label_shape).astype(np.uint8)
        f["normal"] = rs.randn(6, 20, 3).astype(np.float32)
    got, want = datasets.load_scanobjectnn_h5(path), jax_datasets.load_scanobjectnn_h5(path)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    for a, b in zip(datasets.load_h5(path, ("data", "normal")),
                    jax_datasets.load_h5(path, ("data", "normal"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overrides", [
    ["synthetic=100", "num_point=16", "seed=3"],
    ["synthetic=20", "num_point=8", "model=Hengshuang", "seed=9"],
], ids=["3DViT", "Hengshuang"])
def test_synthetic_streams_match_jax_cli(overrides):
    got = cli.load_arrays(config.load_task_config("cls_scanobjectnn", overrides))
    want = jax_cli.load_arrays(jax_config.load_task_config("cls_scanobjectnn", overrides))
    for (a, b), (ja, jb) in zip(got, want):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    (tr_x, tr_y), (te_x, _) = got
    assert tr_x.shape[2] == 3 and len(te_x) == max(len(tr_x) // 5, 64)
    assert tr_y.max() < cli.NUM_CLASS


def test_h5_split_matches_jax_cli(tmp_path):
    """Each cloud cut to its first num_point points, as the JAX CLI cuts it."""
    root = _write_split(str(tmp_path))
    overrides = [f"data_path={root}", "num_point=48", "synthetic=0"]
    got = cli.load_arrays(config.load_task_config("cls_scanobjectnn", overrides))
    want = jax_cli.load_arrays(jax_config.load_task_config("cls_scanobjectnn", overrides))
    for (a, b), (ja, jb) in zip(got, want):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    assert got[0][0].shape == (24, 48, 3) and got[1][0].shape == (10, 48, 3)


EPOCH_LINE = re.compile(r"^Epoch (\d+) Test Instance Accuracy: (\d\.\d{6}), "
                        r"Class Accuracy: \d\.\d{6} \(\d+\.\d samples/sec\)$")


def _run(tmp_path, capsys, argv):
    out_dir = str(tmp_path / "run")
    best = cli.main(["device=cpu", "batch_size=8", "epoch=2", f"out_dir={out_dir}", *argv])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch ")]
    assert len(epochs) == 2 and all(epochs), lines[-4:]
    assert [int(m.group(1)) for m in epochs] == [1, 2]
    assert lines[-1] == f"Best Instance Accuracy: {best:f}"
    assert best == max(float(m.group(2)) for m in epochs)
    return out_dir, lines, best


@pytest.mark.parametrize("model,dtype", [("3DViT", "f32"), ("3DViT", "bf16"),
                                         ("Hengshuang", "f32"), ("Hengshuang", "bf16")])
def test_cli_trains_on_the_cpu_and_checkpoints(tmp_path, capsys, model, dtype):
    """Synthetic streams, 2 epochs of 2 steps: the epoch lines, the best
    instance accuracy, and a checkpoint of the best epoch that restores."""
    argv = [f"model={model}", f"dtype={dtype}", "synthetic=16", "num_point=64"]
    if model == "Hengshuang":
        argv += ["model.nblocks=2", "model.nneighbor=8", "model.transformer_dim=64"]
    out_dir, lines, best = _run(tmp_path, capsys, argv)
    assert "train 16 / test 64" in lines
    backbone, pretrained = (("none", "False") if model == "Hengshuang"
                            else ("deit_tiny_patch16_224", "True"))
    run = os.path.join(out_dir, model, backbone, pretrained)
    assert os.path.exists(os.path.join(run, "resolved_config.json"))
    state, metrics = Checkpointer(os.path.join(run, "ckpt")).restore()
    assert metrics["instance_acc"] == best and state["step"] in (2, 4)
    assert all(v.dtype == torch.float32 for k, v in state["params"].items()
               if v.is_floating_point())


def test_cli_trains_from_the_h5_split(tmp_path, capsys):
    root = _write_split(str(tmp_path))
    _, lines, _ = _run(tmp_path, capsys, [f"data_path={root}", "num_point=64"])
    assert "train 24 / test 10" in lines


def test_cli_does_not_move_to_the_cpu_by_itself():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    with pytest.raises(RuntimeError, match="device=cpu"):
        cli.main(["synthetic=8"])
