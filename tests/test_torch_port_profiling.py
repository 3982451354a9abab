"""utils/profiling.py and core/logging_utils.py of the port on the CPU: a
Chrome trace written, FLOPs counted (the ViT block op by its formula, equal to
the plain block's count), param_count equal to the JAX package's for the
flagship, Throughput, the run directory's log file and config snapshot."""

import json
import logging

import numpy as np
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.utils import profiling as jprof
from simple3dformer_tpu_torch.core import logging_utils
from simple3dformer_tpu_torch.core.config import Config, load_task_config
from simple3dformer_tpu_torch.kernels import vit_block as vb
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn.layers import Block
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (a @ a).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_flops_estimate_counts_products_and_the_block_op():
    lin = torch.nn.Linear(32, 16)
    assert profiling.flops_estimate(lin, torch.zeros(8, 32)) == {"flops": 2 * 8 * 32 * 16}
    b, n, d, heads = 2, 5, 128, 2
    block = Block(d, heads).eval()
    x = torch.randn(b, n, d)
    want = 24 * b * n * d * d + 4 * b * n * n * d
    with torch.no_grad():
        plain = profiling.flops_estimate(block, x)["flops"]  # the plain modules on the CPU
        op = profiling.flops_estimate(vb.fused_vit_block, x, block.fused_weights(), heads)["flops"]
    assert plain == op == want


def test_param_count_equals_jax_for_the_flagship():
    jm = JaxVoxelViT(voxel_embed=JaxVoxelEmbed(voxel_size=12, cell_size=4, patch_size=3,
                                               embed_dim=192),
                     n_classes=7, transformer_backbone="deit_tiny_patch16_224")
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((2, 12, 12, 12)),
                                              jnp.zeros((1, 224, 224, 3)),
                                              method=JaxVoxelViT.init_all), jax.random.key(0))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    pm = VoxelViT(VoxelEmbed(voxel_size=12, cell_size=4, patch_size=3, embed_dim=192),
                  n_classes=7, transformer_backbone="deit_tiny_patch16_224")
    n = profiling.param_count(pm)
    assert n == jprof.param_count(params) > 5_000_000
    assert profiling.param_count(dict(pm.named_parameters())) == n


def test_throughput_meter():
    meter = profiling.Throughput()
    meter.add(32)
    meter.add(32)
    assert meter.samples == 64 and meter.rate > 0
    meter.reset()
    assert meter.samples == 0 and meter.rate == 0.0


def test_logger_and_config_snapshot(tmp_path, capsys):
    logger = logging_utils.setup_logger(str(tmp_path / "run"), name="s3f-test")
    logger.info("epoch 1 loss 0.5")
    for handler in logger.handlers:
        handler.flush()
    log = (tmp_path / "run" / "train.log").read_text()
    assert "[s3f-test][INFO] epoch 1 loss 0.5" in log
    assert "epoch 1 loss 0.5" in capsys.readouterr().out
    assert len(logging_utils.setup_logger(str(tmp_path / "run"), name="s3f-test").handlers) == 2
    cfg = load_task_config("partseg_lwf", ["model=3DViT_lwf", "dtype=bf16"])
    path = logging_utils.snapshot_config(cfg, str(tmp_path / "run"))
    assert path == str(tmp_path / "run" / "config.yaml")
    assert Config.from_yaml(path) == cfg
