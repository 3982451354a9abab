"""scripts/jax_checkpoint_to_torch.py on the CPU: a checkpoint that the JAX
package's Checkpointer wrote after a JAX train step, converted into a port
checkpoint, served by the port's Predictor.from_checkpoint with the JAX
Predictor's logits, for the flagship VoxelViT (and read by the attention
visualizer, resumed by the trainer) and for a 3DViT partseg model with
BatchNorm statistics and its SGD momentum, which loads into the port CLI's
train state; flags that build another model or another optimizer are refused.
tests/test_torch_port_jax_resume.py resumes a JAX run in the port under every
optimizer form."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.cli import _common as jax_common
from simple3dformer_tpu.cli import train_partseg as jax_partseg
from simple3dformer_tpu.core.checkpoint import Checkpointer as JaxCheckpointer
from simple3dformer_tpu.core.config import load_task_config as jax_task_config
from simple3dformer_tpu.models.registry import make_point_model as jax_point_model
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.serve.predictor import Predictor as JaxPredictor
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import (create_train_state, cross_entropy, make_train_step,
                                            seg_cross_entropy)
from simple3dformer_tpu_torch.cli import _common as port_common
from simple3dformer_tpu_torch.cli import train_cls_voxel, visualize_attention_map_voxel
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.core.config import load_task_config
from simple3dformer_tpu_torch.models.registry import make_point_model
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.serve.predictor import Predictor
from simple3dformer_tpu_torch.train.loop import TrainState

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "jax_checkpoint_to_torch.py"
LOGIT_ATOL = 1e-4  # as tests/test_torch_port_serve.py: 12 f32 blocks in another order
BACKBONE = "deit_tiny_patch16_224"
VOXEL_FLAGS = ["--dataset", "ModelNet40", "--transformer-name", BACKBONE, "--cell-size", "6",
               "--patch-size", "5"]
POINT_OVERRIDES = ["model=3DViT", "num_point=64", "model.nneighbor=8"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def script():
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_train_and_save(model, variables, batch, loss_fn, has_bn, ckpt_dir, metrics, tx=None):
    """One jitted JAX train step (``tx``, by default Adam) from the init, saved
    at step 1 by the JAX Checkpointer; -> the JAX state."""
    tx = tx or jax_optim.make_optimizer("Adam")
    state = create_train_state(variables["params"], tx, variables.get("batch_stats"))
    step = make_train_step(model, tx, loss_fn=loss_fn, has_batch_stats=has_bn, donate=False)
    state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, 1e-3,
                    jax.random.key(1))
    JaxCheckpointer(ckpt_dir).save(1, state, metrics)
    return state


def test_flagship_checkpoint_serves_the_jax_logits(tmp_path):
    jm = JaxVoxelViT(voxel_embed=JaxVoxelEmbed(voxel_size=30, cell_size=6, patch_size=5,
                                               embed_dim=192),
                     n_classes=40, transformer_backbone=BACKBONE)
    variables = jax.jit(lambda k, a, b: jm.init(k, a, b, method=jm.init_all))(
        jax.random.key(0), jnp.zeros((2, 30, 30, 30)), jnp.zeros((2, 224, 224, 3)))
    rs = np.random.RandomState(0)
    batch = {"x": (rs.rand(4, 30, 30, 30) > 0.8).astype(np.float32),
             "y": rs.randint(0, 40, 4).astype(np.int32)}
    state = jax_train_and_save(jm, variables, batch, cross_entropy, False,
                               str(tmp_path / "jax"), {"test_acc": 0.25})
    assert not np.array_equal(state.params["voxel_head"]["kernel"],
                              variables["params"]["voxel_head"]["kernel"])  # it trained
    out = script().main([str(tmp_path / "jax"), str(tmp_path / "port"), "train_cls_voxel",
                         *VOXEL_FLAGS])
    assert out == str(tmp_path / "port" / "1")
    saved, metrics = Checkpointer(str(tmp_path / "port")).restore()
    assert saved["step"] == 1 and metrics == {"test_acc": 0.25}

    model = VoxelViT(VoxelEmbed(voxel_size=30, cell_size=6, patch_size=5, embed_dim=192),
                     n_classes=40, transformer_backbone=BACKBONE)
    served = Predictor.from_checkpoint(model, str(tmp_path / "port"), (30, 30, 30),
                                       device="cpu", batch_size=4, warmup=False)
    jax_pred = JaxPredictor(jm, {"params": state.params}, input_shape=(30, 30, 30),
                            batch_size=4, warmup=False)
    x = (rs.rand(5, 30, 30, 30) > 0.8).astype(np.float32)
    np.testing.assert_allclose(served(x), jax_pred(x), rtol=0, atol=LOGIT_ATOL)

    results = visualize_attention_map_voxel.main([
        *VOXEL_FLAGS, "--model", str(tmp_path / "port"), "--synthetic", "2", "--n-samples", "1",
        "--outf", str(tmp_path / "vis"), "--device", "cpu"])
    assert len(results) == 1 and np.isfinite(results[0][1]).all()

    # the port's trainer resumes the run from it (parameters and Adam's moments)
    best = train_cls_voxel.main([*VOXEL_FLAGS, "--model", str(tmp_path / "port"), "--synthetic",
                                 "8", "--batchSize", "4", "--epochs", "1", "--lr", "1e-3",
                                 "--device", "cpu", "--outf", str(tmp_path / "resumed")])
    assert 0.0 <= best <= 1.0
    resumed, _ = Checkpointer(str(tmp_path / "resumed" / "Voxel3D_2DPretrain" /
                                  "VoxelEmbed_default" / BACKBONE / "ckpt")).restore()
    assert resumed["step"] == 1 + 2  # the JAX step and two of B=4 on 8 samples


@pytest.fixture(scope="module")
def partseg_ckpt(tmp_path_factory):
    """The JAX 3DViT partseg model after one train step that moved its
    BatchNorm statistics, saved; -> (model, state, prepared inputs, directory)."""
    d = tmp_path_factory.mktemp("partseg")
    cfg = jax_task_config("partseg", POINT_OVERRIDES)
    cfg.num_class, cfg.input_dim = 50, 22
    jm = jax_point_model(cfg, task="seg")
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, 64, 22)))
    rs = np.random.RandomState(1)
    raw = {"x": rs.randn(4, 64, 6).astype(np.float32), "cls": rs.randint(0, 16, 4).astype(np.int32),
           "y": rs.randint(0, 50, (4, 64)).astype(np.int32)}
    raw["x"][..., :3] = rs.rand(4, 64, 3)
    x, y = jax_partseg.make_prepare_fn()({k: jnp.asarray(v) for k, v in raw.items()})
    # the optimizer the partseg flags build (the config's SGD): the script refuses another
    state = jax_train_and_save(jm, variables, {"x": np.asarray(x), "y": np.asarray(y)},
                               seg_cross_entropy, True, str(d / "jax"), {"instance_avg_iou": 0.5},
                               jax_common.reference_optimizer(cfg)[0])
    return jm, state, np.asarray(x), d


def test_partseg_checkpoint_with_batchnorm_statistics(partseg_ckpt, tmp_path):
    jm, state, x, d = partseg_ckpt
    script().main([str(d / "jax"), str(tmp_path / "port"), "train_partseg", *POINT_OVERRIDES])
    saved, _ = Checkpointer(str(tmp_path / "port")).restore()
    moved = [k for k in saved["params"] if k.endswith("running_mean")]
    assert moved and all(float(saved["params"][k].abs().max()) > 0 for k in moved)

    pcfg = load_task_config("partseg", POINT_OVERRIDES)
    pcfg.num_class, pcfg.input_dim = 50, 22
    served = Predictor.from_checkpoint(make_point_model(pcfg, task="seg"), str(tmp_path / "port"),
                                       (64, 22), device="cpu", batch_size=2, warmup=False)
    jax_pred = JaxPredictor(jm, {"params": state.params, "batch_stats": state.batch_stats},
                            input_shape=(64, 22), batch_size=2, warmup=False)
    np.testing.assert_allclose(served(x[:3]), jax_pred(x[:3]), rtol=0, atol=LOGIT_ATOL)


def test_flags_that_build_another_model_are_refused(partseg_ckpt, tmp_path):
    _, _, _, d = partseg_ckpt
    with pytest.raises(ValueError, match="do not match the model the flags build"):
        script().main([str(d / "jax"), str(tmp_path / "port"), "train_partseg",
                       "model=3DViT_1_layer", "num_point=64", "model.nneighbor=8"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        script().main([str(tmp_path / "empty"), str(tmp_path / "port"), "train_partseg",
                       *POINT_OVERRIDES])


def test_flags_that_build_another_optimizer_are_refused(partseg_ckpt, tmp_path):
    """The partseg run's SGD momentum is converted and loads into the train
    state the port's partseg CLI builds; flags that build Adam are refused."""
    _, state, _, d = partseg_ckpt
    script().main([str(d / "jax"), str(tmp_path / "port"), "train_partseg", *POINT_OVERRIDES])
    saved, _ = Checkpointer(str(tmp_path / "port")).restore()
    assert set(saved["opt_state"]) == {"count", "trace"} and saved["opt_state"]["count"] == 1
    pcfg = load_task_config("partseg", POINT_OVERRIDES)
    pcfg.num_class, pcfg.input_dim = 50, 22
    model = make_point_model(pcfg, task="seg")
    optimizer, _ = port_common.reference_optimizer(pcfg, dict(model.named_parameters()))
    run = TrainState(model, optimizer)
    Checkpointer(str(tmp_path / "port")).restore_into(run)
    assert run.step == int(state.step) == 1
    with pytest.raises(ValueError, match=r"holds SGD's momentum \(trace\), but the flags build "
                                         "Adam"):
        script().main([str(d / "jax"), str(tmp_path / "adam"), "train_partseg",
                       *POINT_OVERRIDES, "optimizer=Adam"])
