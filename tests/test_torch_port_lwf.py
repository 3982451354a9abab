"""The port's LwF path against the JAX package's, on the CPU: image
normalisation and the synthetic image canvas, the 2D DeiT (plain, distilled,
the teacher), the student models' image pathway, three LwF train steps with
SGD and with Adam, and both LwF CLIs. Inputs are made with numpy from a seed;
parameters are the JAX package's init, perturbed, carried across by
utils/convert.py."""

import functools
import os
import re
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.cli import train_partseg as jax_partseg
from simple3dformer_tpu.data.pipeline import DeviceResidentDataset as JaxDataset
from simple3dformer_tpu.models import point_vit as jpv
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.models.voxel_vit import frozen_mask as jax_frozen_mask
from simple3dformer_tpu.nn import vit as jvit
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.train import lwf as jlwf
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import seg_cross_entropy as jax_seg_ce
from simple3dformer_tpu_torch.cli import train_cls_voxel, train_partseg_lwf
from simple3dformer_tpu_torch.cli.train_partseg import make_prepare_fn
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.core.rng import generator
from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
from simple3dformer_tpu_torch.models import point_vit as ppv
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT, frozen_mask
from simple3dformer_tpu_torch.nn import vit as pvit
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.train import lwf, optim
from simple3dformer_tpu_torch.train.loop import TrainState, seg_cross_entropy
from simple3dformer_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOGIT_ATOL = 1e-4  # a few blocks of f32 sums in another order
IMG = 32  # the image side of the small models (4 patches), as tests/test_lwf.py
N, K, B, M = 64, 8, 2, 3  # points, neighbours, clouds and images a step


def perturbed(tree, seed, scale=0.02):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(tree))


def canvas(seed, n, side=IMG):
    return (np.random.RandomState(seed).rand(n, side, side, 3) * 255).astype(np.uint8)


def normalised(seed, n, side=IMG):
    return np.asarray(jlwf.normalize_images(jnp.asarray(canvas(seed, n, side))))


def test_normalize_and_synthetic_images_equal_jax():
    imgs = canvas(0, 4, 8)
    np.testing.assert_array_equal(lwf.normalize_images(torch.from_numpy(imgs)).numpy(),
                                  np.asarray(jlwf.normalize_images(jnp.asarray(imgs))))
    for synthetic, seed, side in ((16, 9, 32), (300, 3, 8)):
        got = lwf.load_images("/nonexistent", synthetic=synthetic, seed=seed, canvas=side)
        want = jlwf.load_images("/nonexistent", synthetic=synthetic, seed=seed, canvas=side)
        assert got.shape == (max(synthetic, 256), side, side, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert lwf.IMAGE_CANVAS == jlwf.IMAGE_CANVAS
    np.testing.assert_array_equal(np.float32(lwf.IMAGENET_MEAN), np.asarray(jlwf.IMAGENET_MEAN))
    np.testing.assert_array_equal(np.float32(lwf.IMAGENET_STD), np.asarray(jlwf.IMAGENET_STD))


def test_backbone_tables_equal_jax():
    assert pvit.DEIT_FACTORY == jvit.DEIT_FACTORY
    assert pvit.TEACHER_BACKBONES == jvit.TEACHER_BACKBONES
    assert pvit.BACKBONES == jvit.BACKBONES


@pytest.mark.parametrize("distilled", [False, True])
def test_vit2d_matches_jax(distilled):
    kw = dict(embed_dim=64, depth=2, num_heads=2, img_size=IMG, distilled=distilled)
    jm = jvit.ViT2D(**kw)
    x = normalised(1, 3)
    params = perturbed(jm.init(jax.random.key(0), jnp.asarray(x))["params"], 1)
    pm = pvit.ViT2D(64, 2, 2, img_size=IMG, distilled=distilled)
    assert not load_jax_params(pm, params)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    assert got.shape == (3, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", ["deit_tiny_patch16_224", "deit_tiny_distilled_patch16_224"])
def test_deit_factory_builds_the_reference_models(name):
    cfg = pvit.DEIT_FACTORY[name]
    model = pvit.deit_factory(name, num_classes=10)
    n_tokens = (cfg["img_size"] // 16) ** 2 + (2 if cfg["distilled"] else 1)
    assert model.pos_embed.shape == (1, n_tokens, cfg["embed_dim"])
    assert model.blocks[0].num_heads == cfg["num_heads"] and len(model.blocks) == 12
    assert hasattr(model, "head_dist") == cfg["distilled"] and model.head.out_features == 10


def test_teacher_logits_and_labels_match_jax():
    """make_teacher at full deit_tiny size (224 px, 12 blocks, 3 heads): logits
    within LOGIT_ATOL; labels equal wherever the top-2 margin exceeds it."""
    jt = jvit.make_teacher("deit_tiny_patch16_224")
    x = normalised(2, 6, 224)
    params = perturbed(jt.init(jax.random.key(0), jnp.asarray(x[:1]))["params"], 2)
    pt = pvit.make_teacher("deit_tiny_patch16_224")
    assert not load_jax_params(pt, params)
    with torch.no_grad():
        got = pt.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(1)[clear], want.argmax(1)[clear])
    print(f"teacher labels compared on {int(clear.sum())} of {len(x)} images "
          f"({int((~clear).sum())} within a top-2 margin of {LOGIT_ATOL})")


def jax_point_model(variant, seed=3, bf16=False):
    """The JAX student (at the compute dtype bf16 when ``bf16``), the port's
    holding the same perturbed f32 parameters, and both trees."""
    jdt, pdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jm = jpv.PointViT(variant=variant, task="seg", num_point=N, num_class=50, input_dim=22,
                      nneighbor=K, img_size=IMG, dtype=jdt)
    x = np.random.RandomState(seed).randn(B, N, 22).astype(np.float32)
    variables = jax.jit(lambda k, a, b: jm.init(k, a, b, method=jm.init_all))(
        jax.random.key(seed), jnp.asarray(x), jnp.zeros((1, IMG, IMG, 3)))
    pm = ppv.PointViT(variant, "seg", N, 50, input_dim=22, nneighbor=K, img_size=IMG, dtype=pdt)
    params = perturbed(variables["params"], seed + 1)
    stats = jax.device_get(variables.get("batch_stats", {}))
    load_jax_params(pm, params, stats)
    return jm, pm, params, stats


def jax_voxel_model(seed=0):
    emb = JaxVoxelEmbed(voxel_size=12, cell_size=4, patch_size=3, embed_dim=192)
    jm = JaxVoxelViT(voxel_embed=emb, n_classes=5, transformer_backbone="deit_tiny_patch16_224",
                     img_size=IMG)
    variables = jm.init(jax.random.key(seed), jnp.zeros((2, 12, 12, 12)),
                        jnp.zeros((1, IMG, IMG, 3)), method=JaxVoxelViT.init_all)
    params = perturbed(variables["params"], seed + 6)
    pm = VoxelViT(VoxelEmbed(voxel_size=12, cell_size=4, patch_size=3, embed_dim=192),
                  n_classes=5, transformer_backbone="deit_tiny_patch16_224", img_size=IMG)
    assert not load_jax_params(pm, params)
    return jm, pm, params


@pytest.mark.parametrize("variant", ["3DViT_1_layer", "3DViT_0_layer", "3DViT_LWF", "VoxelViT"])
def test_forward_images_matches_jax(variant):
    if variant == "VoxelViT":
        jm, pm, params = jax_voxel_model()
        variables = {"params": params}
    else:
        jm, pm, params, stats = jax_point_model(variant)
        variables = {"params": params, "batch_stats": stats}
    x = normalised(4, 3)
    with torch.no_grad():
        got = pm.eval().forward_images(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), method=jm.forward_images))
    assert got.shape == (3, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


# forward_images at bf16 (12 blocks on a bf16 residual stream, each rounding
# its output to 8 bits): the logits within this share of their largest value
# (a bf16 step is 2**-8 of a value, and a last-bit difference in an f32
# LayerNorm sum flips a rounding a few blocks on); measured 8.5e-3
BF16_LOGIT_REL = 2e-2


def test_forward_images_at_bf16_matches_jax():
    """3DViT_LWF at the compute dtype bf16: the patch embedding returns bf16,
    the cls token and the position embedding join the bf16 stream, the blocks
    keep it bf16 and the 2D head returns bf16 logits, as the JAX student's."""
    jm, pm, params, stats = jax_point_model("3DViT_LWF", bf16=True)
    x = normalised(4, 3)
    with torch.no_grad():
        tokens = pm.patch_embed(torch.from_numpy(x))
        got = pm.eval().forward_images(torch.from_numpy(x))
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                    method=jm.forward_images)
    assert tokens.dtype == got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert got.shape == (3, 1000) and err <= BF16_LOGIT_REL, err


def test_plain_3dvit_has_no_image_pathway():
    pm = ppv.PointViT("3DViT", "seg", N, 50, input_dim=22, nneighbor=K)
    with pytest.raises(ValueError, match="no 2D image pathway"):
        pm.forward_images(torch.zeros(1, IMG, IMG, 3))


def small_teacher(seed=1):
    jt = jvit.ViT2D(embed_dim=64, depth=1, num_heads=2, img_size=IMG)
    t_params = perturbed(jt.init(jax.random.key(seed), jnp.zeros((1, IMG, IMG, 3)))["params"],
                         seed, 0.05)
    pt = pvit.ViT2D(64, 1, 2, img_size=IMG)
    assert not load_jax_params(pt, t_params)
    return jt, t_params, pt


def run_both(jm, jparams, jstats, jtx, pm, opt, task, prepare, task_loss, lr, steps=3,
             rtol=1e-4):
    """Three LwF steps of both packages on the same corpora and indices, no
    augmentation, the losses within ``rtol``; -> the JAX state."""
    jt, t_params, pt = small_teacher()
    images = canvas(7, 8)
    jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, jparams), jtx,
                                None if jstats is None else
                                jax.tree_util.tree_map(jnp.asarray, jstats))
    jrun = jlwf.make_scanned_lwf_train_steps(
        jm, jt, t_params, jtx, JaxDataset(task), JaxDataset({"images": images}),
        task_loss_fn=jax_seg_ce if prepare else jlwf.cross_entropy,
        has_batch_stats=jstats is not None,
        prepare_fn=jax_partseg.make_prepare_fn() if prepare else None)
    rs = np.random.RandomState(8)
    n = len(next(iter(task.values())))
    idx = np.stack([rs.permutation(n)[:B] for _ in range(steps)]).astype(np.int32)
    img_idx = rs.randint(0, len(images), (steps, M)).astype(np.int32)
    jstate, jmetrics = jrun(jstate, jnp.asarray(idx), jnp.asarray(img_idx), lr,
                            jax.random.key(2))
    run = lwf.make_scanned_lwf_train_steps(
        TrainState(pm, opt), pt, DeviceResidentDataset(task, "cpu"),
        DeviceResidentDataset({"images": images}, "cpu"), task_loss_fn=task_loss,
        prepare_fn=make_prepare_fn() if prepare else None)
    metrics = run(torch.from_numpy(idx).long(), torch.from_numpy(img_idx).long(), lr)
    assert opt.count == int(jstate.step) == steps
    for k in ("loss", "task_loss", "lwf_loss"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jmetrics[k]), rtol=rtol,
                                   err_msg=k)
    return jstate


def seg_task():
    rs = np.random.RandomState(9)
    cats = rs.randint(0, 16, 6).astype(np.int32)
    return {"x": rs.randn(6, N, 6).astype(np.float32), "cls": cats,
            "y": rs.randint(0, 50, (6, N)).astype(np.int32)}


def lwf_sgd_run(bf16=False, rtol=1e-4):
    """Three LwF SGD steps of 3DViT_1_layer at the CLI's lr, pretrained mask,
    in both packages at one compute dtype; -> (port model, its state before,
    its state after, the JAX state after as a port state dict)."""
    jm, pm, params, stats = jax_point_model("3DViT_1_layer", bf16=bf16)
    jtx = jax_optim.make_optimizer("SGD", trainable_mask=jpv.frozen_mask_point(params, True))
    opt = optim.make_optimizer(dict(pm.named_parameters()), "SGD",
                               trainable_mask=ppv.frozen_mask_point(pm, True))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    jstate = run_both(jm, params, stats, jtx, pm, opt, seg_task(), True, seg_cross_entropy, 0.05,
                      rtol=rtol)
    want = jax_to_state_dict(jax.device_get(jstate.params), pm.state_dict(),
                             jax.device_get(jstate.batch_stats))
    return pm, before, pm.state_dict(), want


@functools.cache
def lwf_sgd_run_f32():
    return lwf_sgd_run()


def test_three_lwf_sgd_steps_match_jax():
    """3DViT_1_layer, pretrained mask (the 2D head and patch embedding
    frozen), SGD at the CLI's lr; the BatchNorm statistics of the point pass."""
    pm, before, got, want = lwf_sgd_run_f32()
    assert any("running_var" in k for k in want)
    for k, v in want.items():
        scale = max(float(v.abs().max()), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
    for k in ("head.weight", "head.bias", "patch_embed.proj.weight", "patch_embed.proj.bias"):
        assert torch.equal(got[k], before[k]), k
    assert not torch.equal(got["pos_embed"], before["pos_embed"])  # trains: only head, patch
    assert not torch.equal(got["blocks.0.attn.qkv.weight"], before["blocks.0.attn.qkv.weight"])


# bf16 logits keep 8 bits (a step of 3.9e-3): the three steps' loss, task and
# LwF terms within this relative error of the JAX bf16 step's (measured 4.1e-4,
# 7.9e-4 and 1.7e-3)
BF16_LOSS_RTOL = 5e-3
# the whole step at bf16 departs from its own f32 step far beyond a rounding
# (a bf16 product before a train-mode BatchNorm is scaled up by it), so each
# parameter's three-step change is held within BAND times the JAX package's
# own bf16-vs-f32 spread, from the JAX bf16 change and from the JAX f32 one,
# as tests/test_torch_port_point_bf16.py holds the 3DViT step. Measured: 1.6
# and 2.0 times that spread (0.34 and 0.42 of the largest change against
# 0.21), both at the first set abstraction's conv weight, a product before a
# train-mode BatchNorm (its bias, zero but for rounding, 0.13); every other
# leaf within 0.05, every block's within 0.011.
BAND = 2.5


def test_three_lwf_sgd_steps_at_bf16_match_jax():
    """The LwF SGD step of a bf16 student (dtype=bf16: every Linear and the
    image pathway in bf16, the parameters and the teacher f32) against the
    JAX step at bf16 from the same init: the losses within BF16_LOSS_RTOL;
    the frozen 2D leaves unchanged; every change inside the JAX package's own
    bf16-vs-f32 spread."""
    pm, before, got, want = lwf_sgd_run(bf16=True, rtol=BF16_LOSS_RTOL)
    _, _, _, witness = lwf_sgd_run_f32()
    names = [n for n, _ in pm.named_parameters()]
    assert all(got[k].dtype == torch.float32 for k in names)
    for k in ("head.weight", "head.bias", "patch_embed.proj.weight", "patch_embed.proj.bias"):
        assert torch.equal(got[k], before[k]), k
    trained = [k for k in names if not torch.equal(want[k], before[k])]

    def change(state):
        return {k: state[k].double() - before[k].double() for k in trained}

    def spread(a, b):
        big = max(float(b[k].abs().max()) for k in trained)
        return max(float((a[k] - b[k]).abs().max()) for k in trained) / big

    jax_spread = spread(change(want), change(witness))
    assert spread(change(got), change(want)) <= BAND * jax_spread
    assert spread(change(got), change(witness)) <= BAND * jax_spread


def test_three_lwf_adam_steps_match_jax():
    """VoxelViT (the voxel CLI's --lwf), pretrained mask: the 2D head, pos
    embed and patch embed frozen; Adam."""
    lr = 1e-3
    jm, pm, params = jax_voxel_model()
    rs = np.random.RandomState(10)
    task = {"x": (rs.rand(6, 12, 12, 12) > 0.8).astype(np.uint8),
            "y": rs.randint(0, 5, 6).astype(np.int32)}
    jtx = jax_optim.make_optimizer("Adam", trainable_mask=jax_frozen_mask(params, True))
    opt = optim.make_optimizer(dict(pm.named_parameters()), "Adam",
                               trainable_mask=frozen_mask(pm, True))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    jstate = run_both(jm, params, None, jtx, pm, opt, task, False, lwf.cross_entropy, lr)
    # Adam turns a sign difference in a gradient that is all rounding noise into up
    # to +-lr a step, so after 3 steps parameters agree to 3 lr
    want = jax_to_state_dict(jax.device_get(jstate.params), pm.state_dict())
    got = pm.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=3 * lr, err_msg=k)
    for k in ("head.weight", "head.bias", "pos_embed", "patch_embed.proj.weight"):
        assert torch.equal(got[k], before[k]), k
    assert not torch.equal(got["voxel_head.weight"], before["voxel_head.weight"])


# the JAX CLI's lines (simple3dformer_tpu/cli/train_partseg_lwf.py:139-150)
LWF_EPOCH = re.compile(r"^Epoch (\d+) lr (\d+\.\d{6}) loss (\d+\.\d{4}) "
                       r"\(task (\d+\.\d{4}) lwf (\d+\.\d{4})\)$")
LWF_TEST = re.compile(r"^test Accuracy: \d\.\d{6}  Class avg mIOU: \d\.\d{6}  "
                      r"Inctance avg mIOU: (\d\.\d{6})$")
SMALL = ["device=cpu", "model.transformer_backbone=deit_tiny_patch16_224", "synthetic=8",
         "batch_size=4", "num_point=64", "model.nneighbor=4", "M=2"]


def write_deit(path, name, seed=5):
    """A timm-named DeiT state dict at ``path/<name>.pth`` from a seeded model."""
    model = pvit.deit_factory(name, generator=generator(seed))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"model": sd}, os.path.join(path, f"{name}.pth"))
    return sd


@pytest.mark.parametrize("model,pretrained", [("3DViT_1_layer", False), ("3DViT_lwf", True)])
def test_partseg_lwf_cli_on_the_cpu(tmp_path, capsys, monkeypatch, model, pretrained):
    """The CLI at test size: its lines, a checkpoint of the best epoch that
    restores into the same model; pretrained, the student and the teacher load
    the file and the student's 2D head and patch embedding do not move."""
    run_partseg_lwf_cli(tmp_path, capsys, monkeypatch, model, pretrained)


def test_partseg_lwf_cli_at_bf16_on_the_cpu(tmp_path, capsys, monkeypatch):
    """dtype=bf16 runs the CLI as in f32 (the student at the compute dtype,
    its parameters and checkpoint f32); the teacher stays f32."""
    state = run_partseg_lwf_cli(tmp_path, capsys, monkeypatch, "3DViT_1_layer", True, "bf16")
    assert all(v.dtype == torch.float32 for k, v in state["params"].items()
               if "num_batches_tracked" not in k)


def run_partseg_lwf_cli(tmp_path, capsys, monkeypatch, model, pretrained, dtype="f32"):
    """The CLI at test size, checked as the tests above say; -> its checkpoint."""
    monkeypatch.setenv("DEIT_CKPT_DIR", str(tmp_path))
    sd = write_deit(str(tmp_path), "deit_tiny_patch16_224") if pretrained else None
    out_dir = str(tmp_path / "run")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        best = train_partseg_lwf.main([*SMALL, f"model={model}", f"model.pretrained={pretrained}",
                                       "epoch=2", f"out_dir={out_dir}", f"dtype={dtype}"])
    missing = [w for w in caught if "No local checkpoint" in str(w.message)]
    assert len(missing) == (0 if pretrained else 1)  # the teacher's, without a file
    lines = capsys.readouterr().out.splitlines()
    epochs = [LWF_EPOCH.match(line) for line in lines if line.startswith("Epoch")]
    tests = [LWF_TEST.match(line) for line in lines if line.startswith("test Accuracy")]
    assert len(epochs) == len(tests) == 2 and all(epochs) and all(tests)
    assert [float(m.group(2)) for m in epochs] == [0.01, 0.01]  # SGD's base lr, as in JAX
    for m in epochs:
        loss, task, lwf_loss = (float(m.group(i)) for i in (3, 4, 5))
        assert abs(loss - (task + 0.1 * lwf_loss)) < 2e-4
    assert "train 8 / test 32" in lines and "imagenet subset: 256 images" in lines
    loaded = [line for line in lines if line.startswith("loaded ")]
    assert len(loaded) == (2 if pretrained else 0)
    assert lines[-1] == f"Best inctance avg mIOU is: {best:f}"
    name = "3DViT_LWF" if model == "3DViT_lwf" else model
    run = os.path.join(out_dir, name, "deit_tiny_patch16_224", str(pretrained))
    state, metrics = Checkpointer(os.path.join(run, "ckpt")).restore()
    assert metrics["instance_avg_iou"] == pytest.approx(best) and state["step"] in (2, 4)
    if pretrained:
        for k in ("head.weight", "patch_embed.proj.weight", "blocks.3.mlp.fc2.bias"):
            assert k in sd
        assert torch.equal(state["params"]["head.weight"], sd["head.weight"])
        assert torch.equal(state["params"]["patch_embed.proj.weight"],
                           sd["patch_embed.proj.weight"])
        assert not torch.equal(state["params"]["blocks.3.mlp.fc2.bias"],
                               sd["blocks.3.mlp.fc2.bias"])
    return state


def test_partseg_lwf_cli_refuses_models_without_images():
    with pytest.raises(ValueError, match="no 2D image pathway"):
        train_partseg_lwf.main(["device=cpu", "model=3DViT"])


def test_portion_subsample_equals_jax():
    cats = np.random.RandomState(0).randint(0, 16, 200).astype(np.int32)
    keep = train_partseg_lwf.balanced_portion(cats, 0.3, 9)
    rng = np.random.RandomState(9)
    want = []
    for c in np.unique(cats):
        ids = np.where(cats == c)[0]
        want.extend(rng.choice(ids, int(len(ids) * 0.3), replace=False))
    np.testing.assert_array_equal(keep, np.asarray(sorted(want)))


VOXEL_EPOCH = re.compile(r"^Epoch (\d+) loss (\d+\.\d{4}) test accuracy (\d\.\d{6}), "
                         r"mean class accuracy (\d\.\d{6}) \((\d+\.\d) samples/sec\)$")


def test_voxel_cli_lwf_pretrained_on_the_cpu(tmp_path, capsys, monkeypatch):
    """--lwf --pretrained at test size: the student loads the file, the
    deit_base teacher has none here (the warning, its random init), the 2D
    leaves keep the file's values through the steps."""
    monkeypatch.setenv("DEIT_CKPT_DIR", str(tmp_path))
    sd = write_deit(str(tmp_path), "deit_tiny_patch16_224")
    argv = ["--dataset", "ModelNet40", "--synthetic", "4", "--epochs", "2", "--batchSize", "4",
            "--transformer-name", "deit_tiny_patch16_224", "--cell-size", "6",
            "--patch-size", "5", "--device", "cpu", "--outf", str(tmp_path / "cls"),
            "--lwf", "--pretrained"]
    with pytest.warns(UserWarning, match="deit_base_patch16_224"):
        train_cls_voxel.main(argv)
    lines = capsys.readouterr().out.splitlines()
    epochs = [VOXEL_EPOCH.match(line) for line in lines if line.startswith("Epoch")]
    assert len(epochs) == 2 and all(epochs)
    loaded = [line for line in lines if line.startswith("loaded ")]
    assert len(loaded) == 1 and "deit_tiny_patch16_224.pth" in loaded[0]
    assert int(loaded[0].split()[1]) == 4 + 12 * 12 + 2 + 2  # cls, pos, patch, blocks, norm, head
    ckpt_dir = (tmp_path / "cls" / "Voxel3D_2DPretrain" / "VoxelEmbed_default"
                / "deit_tiny_patch16_224" / "ckpt")
    state, _ = Checkpointer(str(ckpt_dir)).restore()
    params = state["params"]
    assert state["step"] in (1, 2)
    for k in ("head.weight", "head.bias", "pos_embed", "patch_embed.proj.weight"):
        assert torch.equal(params[k], sd[k]), k
    assert not torch.equal(params["cls_token"], sd["cls_token"])  # loaded, then trained


def test_clis_do_not_move_to_the_cpu_by_themselves():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    with pytest.raises(RuntimeError, match="device=cpu"):
        train_partseg_lwf.main(["synthetic=8"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cls_voxel.main(["--synthetic", "8", "--lwf"])
