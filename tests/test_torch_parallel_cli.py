"""Every training CLI of the port at world size 2: two processes over gloo
(``device=cpu`` / ``--device cpu`` under an env:// rendezvous, as
``torchrun`` sets it), each rank under its own time limit
(tests/_torch_parallel_worker.spawn_ranks). Both ranks print the same metric
lines, rank 0 alone prints the config and writes the checkpoints; train_pure_mlp's
lines match a world-1 run within tests/test_multiprocess.py's tolerances, and
``--zero1`` prints its sharded fraction and writes a checkpoint with the full
moments."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer

PURE_MLP = ["-m", "simple3dformer_tpu_torch.cli.train_pure_mlp", "--dataset", "ModelNet40",
            "--synthetic", "32", "--batchSize", "8", "--epochs", "2", "--model-name", "vip3d_s7",
            "--embed-layer", "VoxelEmbed_m40_vip_s7", "--device", "cpu"]
EPOCH_RE = re.compile(r"Epoch (\d+) loss ([0-9.]+) test accuracy ([0-9.]+), mean class "
                      r"accuracy ([0-9.]+)")


def _epochs(out: str) -> np.ndarray:
    rows = EPOCH_RE.findall(out)
    assert rows, out[-2000:]
    return np.asarray([[float(v) for v in row[1:]] for row in rows])


def _metric_lines(out: str, prefixes) -> list[str]:
    """The metric lines, the throughput (a host clock's) cut off."""
    return [re.sub(r" \([0-9.]+ samples/sec\)", "", line) for line in out.splitlines()
            if line.startswith(prefixes)]


def test_train_pure_mlp_two_ranks_match_one(tmp_path):
    """The CLI tests/test_multiprocess.py drives in JAX: both ranks print the
    same epoch lines, within that test's tolerances of one process."""
    single = subprocess.Popen([sys.executable, *PURE_MLP, "--outf", str(tmp_path / "sp")],
                              cwd=W.REPO, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              env=dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
                                       PYTHONPATH=W.REPO))
    outs = W.spawn_ranks([*PURE_MLP, "--outf", str(tmp_path / "mp")], cwd=str(tmp_path))
    one, _ = single.communicate(timeout=W.TIMEOUT_S)
    assert single.returncode == 0, one[-4000:]
    assert "devices: 1 | rank 0 |" in one
    for r, out in enumerate(outs):
        assert f"devices: 2 | rank {r} gloo | cpu" in out, out[-2000:]
    assert ("Number of parameters" in outs[0]) and ("Number of parameters" not in outs[1])
    traj = [_epochs(out) for out in outs]
    np.testing.assert_array_equal(traj[0], traj[1])
    ref = _epochs(one)
    np.testing.assert_allclose(traj[0][:, 0], ref[:, 0], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(traj[0][:, 1:], ref[:, 1:], atol=1 / 32 + 1e-9)
    assert any((tmp_path / "mp" / "vip3d_s7" / "ckpt").iterdir())


def test_train_cls_voxel_zero1_two_ranks(tmp_path):
    """``--zero1`` at world 2: the sharded-fraction line, the same epoch lines
    on both ranks, and rank 0's checkpoint with the full moments, which loads
    into replicated Adam's layout."""
    argv = ["-m", "simple3dformer_tpu_torch.cli.train_cls_voxel", "--dataset", "ModelNet40",
            "--synthetic", "32", "--batchSize", "16", "--epochs", "2",
            "--transformer-name", "deit_tiny_patch16_224", "--cell-size", "6",
            "--patch-size", "5", "--lr", "1e-3", "--device", "cpu", "--zero1",
            "--outf", str(tmp_path / "cls")]
    outs = W.spawn_ranks(argv, cwd=str(tmp_path))
    assert "ZeRO-1: 100% of optimizer-state bytes sharded over 'data' (2 ways)" in outs[0]
    assert "ZeRO-1" not in outs[1]
    lines = [_metric_lines(out, ("Epoch", "Best")) for out in outs]
    assert len(lines[0]) == 3 and lines[0] == lines[1]
    ckpt = (tmp_path / "cls" / "Voxel3D_2DPretrain" / "VoxelEmbed_default"
            / "deit_tiny_patch16_224" / "ckpt")
    state, _ = Checkpointer(str(ckpt)).restore()
    mu = state["opt_state"]["mu"]
    assert set(mu) == set(state["params"]) and all(
        mu[k].shape == state["params"][k].shape for k in mu)
    assert any(float(v.abs().max()) > 0 for v in mu.values())


POINT_CLIS = {
    "train_cls": ["model=Hengshuang", "synthetic=32", "num_point=64", "batch_size=8", "epoch=1",
                  "model.nblocks=2", "model.transformer_dim=64"],
    "train_cls_scanobjectnn": ["synthetic=32", "num_point=64", "batch_size=8", "epoch=1"],
    "train_partseg": ["synthetic=16", "num_point=64", "batch_size=4", "epoch=1"],
    "train_s3dis_semseg": ["synthetic=8", "num_point=256", "batch_size=4", "epoch=1"],
    "train_partseg_lwf": ["synthetic=8", "batch_size=4", "num_point=64", "model.nneighbor=4",
                          "M=2", "epoch=1",
                          "model.transformer_backbone=deit_tiny_patch16_224"],
}
METRIC_PREFIXES = ("Epoch", "Test", "Best", "eval", "test")


@pytest.mark.parametrize("cli", sorted(POINT_CLIS))
def test_point_cli_two_ranks(tmp_path, cli):
    """Each point CLI at world 2 (``device=cpu``): the same metric lines on
    both ranks, the config printed by rank 0 alone, a checkpoint written."""
    argv = ["-m", f"simple3dformer_tpu_torch.cli.{cli}", "device=cpu",
            f"out_dir={tmp_path / 'out'}", *POINT_CLIS[cli]]
    outs = W.spawn_ranks(argv, cwd=str(tmp_path),
                         extra_env={"DEIT_CKPT_DIR": str(tmp_path / "no_weights")})
    lines = [_metric_lines(out, METRIC_PREFIXES) for out in outs]
    assert lines[0] and lines[0] == lines[1], outs[0][-3000:]
    assert "seed: 9" in outs[0] and "seed: 9" not in outs[1]
    ckpts = list((tmp_path / "out").rglob("ckpt"))
    assert ckpts and any(c.iterdir() for c in ckpts)
    assert all(torch.load(p, weights_only=True)["step"] > 0
               for c in ckpts for p in c.rglob("state.pt"))
