"""The port's visualizers against the JAX package's, on the CPU: ``rollout`` on
the same maps, ``capture_attention`` on a narrow flagship (the default route,
and group_embed, whose stage-1 maps the JAX function returns) from the same
converted weights, the capture switch scoped to the call (the blocks' fused
route refused inside it, taken again after it), and both visualizer CLIs end
to end with their PNGs, each restoring a checkpoint that the port's trainer
wrote."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn.voxel_embed import make_embed_layer as jax_embed_layer
from simple3dformer_tpu.utils import attention_rollout as jax_rollout
from simple3dformer_tpu_torch.cli import (train_cls_voxel, train_partseg,
                                          visualize_attention_map_voxel, visualize_point_cloud)
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn import layers
from simple3dformer_tpu_torch.nn.voxel_embed import make_embed_layer
from simple3dformer_tpu_torch.train.eval_metrics import SEG_CLASSES
from simple3dformer_tpu_torch.utils.attention_rollout import capture_attention, rollout
from simple3dformer_tpu_torch.utils.convert import load_jax_params

BACKBONE, IMG, CLASSES = "deit_tiny_patch16_224", 32, 7
# (embed layer, voxel, cell, patch): the flagship's tokenizer (25 tokens + cls)
# and group_embed's (9 pillars of 3 + 1 tokens, then 9 + 1)
ROUTES = {"default": ("VoxelEmbed", 30, 6, 5), "group_embed": ("VoxelEmbed_no_average", 27, 9, 3)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rollout_matches_jax():
    """The reference's get_mask on the same maps: mask, joint and grid equal."""
    rs = np.random.RandomState(0)
    att = rs.rand(4, 3, 26, 26).astype(np.float32)
    att /= att.sum(-1, keepdims=True)
    mask, joint, grid = rollout(att)
    want_mask, want_joint, want_grid = jax_rollout.rollout(att)
    assert grid == want_grid == 5 and mask.shape == (5, 5)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(joint, want_joint)
    np.testing.assert_allclose(joint[-1].sum(-1), 1.0, rtol=1e-5)


def _pair(route):
    name, v, cell, patch = ROUTES[route]
    jm = JaxVoxelViT(voxel_embed=jax_embed_layer(name, voxel_size=v, cell_size=cell,
                                                 patch_size=patch, embed_dim=192),
                     n_classes=CLASSES, transformer_backbone=BACKBONE, pos_embedding=route,
                     img_size=IMG)
    x = (np.random.RandomState(1).rand(2, v, v, v) < 0.2).astype(np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    rs = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rs.randn(*a.shape).astype(np.float32), params)
    pm = VoxelViT(make_embed_layer(name, v, cell, patch, embed_dim=192), n_classes=CLASSES,
                  transformer_backbone=BACKBONE, pos_embedding=route, img_size=IMG)
    load_jax_params(pm, params)
    return jm, params, pm, x


@pytest.mark.parametrize("route", list(ROUTES))
def test_capture_attention_matches_jax(route):
    """The logits and the maps [L, B, H, N, N] (group_embed: the first call of
    each block, stage 1's [12, 18, 3, 4, 4], as the JAX function walks its
    sown tuples) within 1e-5, the rollout masks within 1e-5; the model's
    train flag is kept, and the recording ends with the call."""
    jm, params, pm, x = _pair(route)
    out, maps = jax_rollout.capture_attention(jm, {"params": params}, jnp.asarray(x))
    pm.train()
    got_out, got = capture_attention(pm, torch.from_numpy(x))
    assert pm.training and layers.Attention.recorder is None
    want_shape = (12, 2, 3, 26, 26) if route == "default" else (12, 18, 3, 4, 4)
    assert tuple(got.shape) == np.shape(maps) == want_shape
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(maps), rtol=0, atol=1e-5)
    if route == "default":
        mask = rollout(got[:, 0].numpy())[0]
        want = jax_rollout.rollout(np.asarray(maps)[:, 0])[0]
        np.testing.assert_allclose(mask, want, rtol=0, atol=1e-5)


def test_recording_takes_the_layered_route_only_inside_the_call():
    """A block the fused kernels take (deit_small at 26 tokens) is refused them
    while the maps are recorded, and the mhsa gate refuses too; both gates are
    back once the recording ends. Plain attention calls on the card are
    counted (on the CPU there are none to count)."""
    blk = layers.Block(384, 6)
    x = torch.zeros(2, 26, 384)
    assert blk.route(x) == "fused"
    with layers.recording_attention() as recorded:
        assert blk.route(x) == "layered"
        assert blk.attn.kernel_unsupported(torch.zeros(1, 256, 384)) == \
            "attention maps are being recorded"
        before = layers.Attention.plain_calls
        blk.eval()(x)
        assert layers.Attention.plain_calls == before
    assert list(recorded) == [blk.attn] and tuple(recorded[blk.attn].shape) == (2, 6, 26, 26)
    assert blk.route(x) == "fused" and layers.Attention.recorder is None


def test_visualize_attention_cli_with_a_trained_checkpoint(tmp_path, capsys):
    """train_cls_voxel writes a checkpoint; the visualizer restores it and
    writes the final, per-layer and 3D PNGs of each sample, the mask on the
    5 x 5 grid of the tokenizer, the prediction line naming the class."""
    outf = tmp_path / "cls"
    common = ["--dataset", "ModelNet40", "--synthetic", "16", "--transformer-name", BACKBONE,
              "--cell-size", "6", "--patch-size", "5", "--device", "cpu"]
    train_cls_voxel.main(common + ["--batchSize", "16", "--epochs", "1", "--lr", "1e-3",
                                   "--outf", str(outf)])
    ckpt = outf / "Voxel3D_2DPretrain" / "VoxelEmbed_default" / BACKBONE / "ckpt"
    assert ckpt.is_dir()
    capsys.readouterr()
    results = visualize_attention_map_voxel.main(
        common + ["--n-samples", "2", "--model", str(ckpt), "--outf", str(tmp_path / "vis")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"loaded checkpoint from {ckpt}"
    assert len(results) == 2 and all(line.startswith(f"sample {i}: pred ")
                                     for i, line in enumerate(lines[1:]))
    for out_dir, mask in results:
        for png in ["attn_final.png", "attn_voxels_3d.png"] + [f"attn_{i}.png"
                                                               for i in range(1, 13)]:
            assert os.path.exists(os.path.join(out_dir, png)), png
        assert mask.shape == (5, 5) and np.isfinite(mask).all()


def test_visualize_point_cloud_cli_with_a_trained_checkpoint(tmp_path, capsys, monkeypatch):
    """train_partseg writes a checkpoint; the visualizer restores it (its
    predictions equal the restored model's restricted argmax, not the fresh
    init's), renders a PNG a sample, and ``predict`` keeps each prediction
    within its category's parts."""
    monkeypatch.chdir(tmp_path)
    common = ["device=cpu", "model=3DViT_1_layer", f"model.transformer_backbone={BACKBONE}",
              "synthetic=8", "num_point=32", "model.nneighbor=4", "batch_size=4"]
    train_partseg.main(common + ["epoch=1", f"out_dir={tmp_path}/seg"])
    ckpt = next(d for d, _, _ in os.walk(tmp_path / "seg") if d.endswith("ckpt"))
    capsys.readouterr()
    outs = visualize_point_cloud.main(common + ["n_samples=2", f"checkpoint={ckpt}",
                                                f"vis_dir={tmp_path}/seg_vis"])
    assert len(outs) == 2 and all(os.path.exists(p) for p in outs)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("sample")]
    assert len(lines) == 2

    from simple3dformer_tpu_torch.cli import _common as C
    from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
    from simple3dformer_tpu_torch.core.rng import generator
    from simple3dformer_tpu_torch.models.registry import make_point_model

    cfg, device = C.setup("partseg", common)
    cfg.num_class, cfg.input_dim = 50, (6 if cfg.normal else 3) + 16
    _, (te_x, te_c, te_s) = train_partseg.load_arrays(cfg)
    model = make_point_model(cfg, task="seg", generator=generator(int(cfg.seed)))
    fresh = visualize_point_cloud.predict(model, te_x[:2], te_c[:2], te_s[:2], device)
    model.load_state_dict(Checkpointer(ckpt).restore()[0]["params"])
    preds = visualize_point_cloud.predict(model, te_x[:2], te_c[:2], te_s[:2], device)
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(fresh, preds))
    for i, (logits, pred, cat) in enumerate(preds):
        assert logits.shape == (32, 50) and set(pred) <= set(SEG_CLASSES[cat])
        acc = float((pred == te_s[i]).mean())
        assert lines[i] == f"sample {i} ({cat}): point acc {acc:.3f} -> {outs[i]}"
