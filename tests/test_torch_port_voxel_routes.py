"""The port's other voxel routes against the JAX package's, on the CPU: the
group_embed route (both ``group_axes``), weight_sharing, the post-norm group
encoder alone in f32 and bf16, VoxelEmbedHybrid with its antialiased resize,
the converter for the new leaves, three Adam steps of the group_embed model,
the group encoder's dropout masks, and the voxel CLI on these routes.

Parameters come from the JAX init through utils/convert.py (perturbed, so
zero-initialised leaves matter); inputs are made with numpy from a seed.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from simple3dformer_tpu.models.voxel_vit import PostNormEncoderLayer as JaxPostNorm
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.models.voxel_vit import frozen_mask as jax_frozen_mask
from simple3dformer_tpu.models.voxel_vit import pack_factor
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbedHybrid as JaxHybrid
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbedNoAverage as JaxNoAverage
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import cross_entropy as jax_cross_entropy
from simple3dformer_tpu_torch.cli import train_cls_voxel as cli
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.models.voxel_vit import (PostNormEncoderLayer, VoxelViT,
                                                       frozen_mask)
from simple3dformer_tpu_torch.nn import layers
from simple3dformer_tpu_torch.nn.voxel_embed import (VoxelEmbedHybrid, VoxelEmbedNoAverage,
                                                     make_embed_layer)
from simple3dformer_tpu_torch.train import optim
from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step
from simple3dformer_tpu_torch.utils import convert
from simple3dformer_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params

from _torch_port_numpy_init import numpy_variables

BF = torch.bfloat16
# 27^3 grids, cell 9 -> a 3 x 3 x 3 token grid: group_embed runs 9 pillars of
# 3 + 1 tokens a sample, weight_sharing 3 z-slices of 9 + 1
V, CELL, PATCH, B = 27, 9, 3, 2
BACKBONE, D = "deit_tiny_patch16_224", 192
IMG = 32  # the 2D pathway's image size: 4 patches keep init_all cheap
F32_ATOL = 1e-4  # 12 f32 blocks (24 on the group route) summed in another order


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(tree))


def grids(n, seed, fill=0.2):
    return (np.random.RandomState(seed).rand(n, V, V, V) < fill).astype(np.float32)


def jax_model(pos_embedding, group_axes="pillar", group_pack=0, dtype=None):
    emb = JaxNoAverage(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=D, dtype=dtype)
    return JaxVoxelViT(voxel_embed=emb, n_classes=7, transformer_backbone=BACKBONE,
                       pos_embedding=pos_embedding, group_axes=group_axes, group_pack=group_pack,
                       img_size=IMG, dtype=dtype)


def port_model(pos_embedding, group_axes="pillar", dtype=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    emb = VoxelEmbedNoAverage(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=D,
                              generator=g, dtype=dtype)
    return VoxelViT(emb, n_classes=7, transformer_backbone=BACKBONE, pos_embedding=pos_embedding,
                    group_axes=group_axes, dropout_seed=seed, img_size=IMG, generator=g,
                    dtype=dtype)


def jax_params(jm, seed=2):
    variables = jm.init(jax.random.key(0), jnp.zeros((B, V, V, V)))
    return perturbed(variables["params"], seed)


@pytest.mark.parametrize("pos_embedding,group_axes,group_pack", [
    ("group_embed", "pillar", 1),          # JAX unpacked: a pillar a row
    ("group_embed", "pillar", 0),          # JAX auto: all 18 pillars in one masked row
    ("group_embed", "reference_bug", 0),   # attention across the pillars at each z slot
    ("weight_sharing", "pillar", 0),
])
def test_routes_match_jax(pos_embedding, group_axes, group_pack):
    x = grids(B, 1)
    jm = jax_model(pos_embedding, group_axes, group_pack)
    params = jax_params(jm)
    if pos_embedding == "group_embed" and group_axes == "pillar" and group_pack == 0:
        assert pack_factor(B * PATCH ** 2, PATCH + 1) == B * PATCH ** 2
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = port_model(pos_embedding, group_axes).eval()
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (B, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def _encoder_pair(dtype):
    """The JAX PostNormEncoderLayer and the port's, the same perturbed weights,
    and a bf16 (or f32) input [18, 4, D] from numpy."""
    jdt = jnp.bfloat16 if dtype == BF else None
    x = np.random.RandomState(3).randn(2 * PATCH ** 2, PATCH + 1, D).astype(np.float32)
    xj = jnp.asarray(x, jdt or jnp.float32)
    jl = JaxPostNorm(dtype=jdt)
    params = perturbed(jl.init(jax.random.key(1), xj)["params"], 4)
    tl = PostNormEncoderLayer(D, dtype=dtype)
    like = {f"group_embed.{k}": v for k, v in tl.state_dict().items()}
    sd = jax_to_state_dict({"group_embed": params}, like)
    tl.load_state_dict({k.removeprefix("group_embed."): v for k, v in sd.items()})
    return jl, params, xj, tl.train(), torch.from_numpy(np.array(xj.astype(jnp.float32)))


def _f32(a):
    return np.array(a.float().detach() if isinstance(a, torch.Tensor)
                    else jnp.asarray(a, jnp.float32))


# (output, gradients), each over its own largest value. f32: sums in another
# order. bf16: both sides round the same f32 values to bf16 at the same places;
# an f32 sum taken in another order can put a value on the other side of a
# rounding boundary (a 2**-8 step), so the output is held to 1e-2 and each
# gradient to 3e-2 (a bias gradient sums a bf16 cotangent over every row), as
# tests/test_torch_port_point_bf16.py holds each stage. Such a flip at a bf16
# ReLU input one step from zero turns the ReLU's gate on one side only, which
# moves a whole row of linear1's weight gradient: measured 1-2 of the 13,824
# gates here, up to 8.1e-2 at 1.6% of linear1.weight's elements over four
# seeds. So in bf16 a gradient's elements beyond 3e-2 may be at most
# GATE_SHARE of them, and none beyond GATE_TOL.
TOL = {torch.float32: (1e-5, 1e-4), BF: (1e-2, 3e-2)}
GATE_SHARE, GATE_TOL = 0.03, 0.2


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_post_norm_encoder_matches_jax(dtype):
    """The group encoder alone from the JAX input, its dropout off (JAX
    deterministic): the output, its dtype (f32: flax's LayerNorm returns the
    promoted dtype), every Linear computing in the compute dtype, and the
    gradients of every parameter and of the input under one random cotangent."""
    jl, params, xj, tl, x = _encoder_pair(dtype)
    tl.dropout = 0.0
    want, vjp = jax.vjp(lambda p, v: jl.apply({"params": p}, v, deterministic=True),
                        jax.tree_util.tree_map(jnp.asarray, params), xj)
    cot = np.random.RandomState(5).randn(*want.shape).astype(np.float32)
    want_p, want_x = vjp(jnp.asarray(cot, want.dtype))

    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((type(m), o.dtype)))
             for m in tl.modules() if isinstance(m, (layers.Dense, layers.LayerNorm))]
    xin = x.to(dtype).requires_grad_()
    got = tl(xin)
    for h in hooks:
        h.remove()
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert sorted(seen, key=str) == sorted(
        [(layers.Dense, dtype)] * 3 + [(layers.LayerNorm, torch.float32)] * 2, key=str)
    out_tol, grad_tol = TOL[dtype]
    w = _f32(want)
    assert np.abs(_f32(got) - w).max() <= out_tol * np.abs(w).max()

    names = [n for n, _ in tl.named_parameters()]
    *grads, gx = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                     [*tl.parameters(), xin])
    like = {f"group_embed.{k}": v for k, v in tl.state_dict().items()}
    want_sd = jax_to_state_dict({"group_embed": jax.device_get(want_p)}, like)
    assert gx.dtype == dtype
    for name, g, wg in [("x", gx, torch.from_numpy(_f32(want_x)))] + [
            (n, g, want_sd[f"group_embed.{n}"]) for n, g in zip(names, grads)]:
        err = (g.float() - wg).abs() / float(wg.abs().max())
        if dtype == torch.float32:
            assert float(err.max()) <= grad_tol, (name, float(err.max()))
        else:
            share = float((err > grad_tol).float().mean())
            assert share <= GATE_SHARE and float(err.max()) <= GATE_TOL, (name, share,
                                                                          float(err.max()))


def _hybrid_pair(voxel):
    x = (np.random.RandomState(voxel).rand(1, voxel, voxel, voxel) < 0.15).astype(np.float32)
    jh = JaxHybrid(voxel_size=voxel, patch_size=1, embed_dim=64)
    params = perturbed(jh.init(jax.random.key(0), jnp.asarray(x))["params"], 6)
    th = VoxelEmbedHybrid(voxel_size=voxel, patch_size=1, embed_dim=64)
    like = {f"voxel_embed.{k}": v for k, v in th.state_dict().items()}
    sd = jax_to_state_dict({"voxel_embed": params}, like)
    th.load_state_dict({k.removeprefix("voxel_embed."): v for k, v in sd.items()})
    return jh, params, th, x


@pytest.mark.parametrize("voxel", [32, 128])
def test_hybrid_embed_matches_flax(voxel):
    """VoxNet's conv stack in f32; at 128^3 after jax.image's antialiased
    trilinear resize to 32^3 (not F.interpolate's, which differs by far more
    than the tolerance). The same 216 tokens as ``num_patches``."""
    jh, params, th, x = _hybrid_pair(voxel)
    want = np.asarray(jh.apply({"params": params}, jnp.asarray(x)))
    got = th(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 6, 6, 6, 64) and got.dtype == torch.float32
    assert th.num_patches == jh.num_patches == 216
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if voxel == 128:  # the resize is jax.image's, not PyTorch's trilinear interpolation
        naive = torch.nn.functional.interpolate(torch.from_numpy(x)[:, None], size=(32,) * 3,
                                                mode="trilinear", align_corners=False)[:, 0]
        small = torch.einsum("bxyz,ix,jy,kz->bijk", torch.from_numpy(x), th.resize, th.resize,
                             th.resize)
        assert float((naive - small).abs().max()) > 0.1


def test_hybrid_rejects_what_the_jax_package_rejects():
    """Hybrid's 6^3 grid fits neither a group_embed nor a weight_sharing model
    (patch 1: position embeddings of 2 tokens), and a 30^3 grid gives 125
    tokens against the 216 declared: the port raises, naming the shapes."""
    x = torch.zeros(1, 32, 32, 32)
    for mode in ("group_embed", "weight_sharing"):
        emb = make_embed_layer("VoxelEmbed_Hybrid", 32, embed_dim=D)
        model = VoxelViT(emb, n_classes=7, transformer_backbone=BACKBONE, pos_embedding=mode,
                         img_size=IMG)
        with pytest.raises(ValueError, match=r"(7|37) tokens .* \(1, 2, 192\)"):
            model(x)
    emb = make_embed_layer("VoxelEmbed_Hybrid", 30, embed_dim=D)
    model = VoxelViT(emb, n_classes=7, transformer_backbone=BACKBONE, img_size=IMG)
    with pytest.raises(ValueError, match=r"126 tokens .* \(1, 217, 192\)"):
        model(torch.zeros(1, 30, 30, 30))


def _refbridge():
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "refbridge.py"
    spec = importlib.util.spec_from_file_location("refbridge", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_converter_matches_refbridge_export_for_group_embed():
    jm = jax_model("group_embed")
    params, _ = numpy_variables(jm, jnp.zeros((B, V, V, V)), jnp.zeros((1, IMG, IMG, 3)), seed=4,
                                method=JaxVoxelViT.init_all)
    want = _refbridge().export_voxelvit_state_dict(params, cell_size=CELL)
    pm = port_model("group_embed")
    got = jax_to_state_dict(params, pm.state_dict())
    assert {k for k in want if k.startswith("group")} == {
        "group_pos_embed", "group_cls_token", "group_embed.self_attn.in_proj_weight",
        "group_embed.self_attn.in_proj_bias", "group_embed.self_attn.out_proj.weight",
        "group_embed.self_attn.out_proj.bias", "group_embed.linear1.weight",
        "group_embed.linear1.bias", "group_embed.linear2.weight", "group_embed.linear2.bias",
        "group_embed.norm1.weight", "group_embed.norm1.bias", "group_embed.norm2.weight",
        "group_embed.norm2.bias"}
    assert set(got) == set(want) == set(pm.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    pm.load_state_dict(want)


def test_converter_refuses_mismatched_group_and_hybrid_trees():
    pm = port_model("group_embed")
    like = pm.state_dict()
    with pytest.raises(ValueError, match="group_pos_embed: shape"):
        jax_to_state_dict({"group_pos_embed": np.zeros((1, 9, D), np.float32)}, like)
    with pytest.raises(KeyError, match="no such parameter"):
        jax_to_state_dict({"group_embed": {"linear3": {"bias": np.zeros(D, np.float32)}}}, like)
    with pytest.raises(KeyError, match="lacks"):
        load_jax_params(pm, numpy_variables(jax_model("weight_sharing"),
                                            jnp.zeros((B, V, V, V)))[0])  # no group leaves
    hybrid = {f"voxel_embed.{k}": v for k, v in VoxelEmbedHybrid(32, 1, 64).state_dict().items()}
    with pytest.raises(ValueError, match="voxel_embed.conv1.weight: shape"):
        jax_to_state_dict({"voxel_embed": {"conv1_kernel": np.zeros((3, 3, 3, 1, 32),
                                                                    np.float32)}}, hybrid)


def test_pretrained_mask_keeps_the_group_parameters_trainable():
    """``--pretrained`` freezes the 2D head, pos embed and patch embed only: the
    group encoder and its embeddings train, as the JAX package's mask says."""
    jm = jax_model("group_embed")
    params, _ = numpy_variables(jm, jnp.zeros((B, V, V, V)), jnp.zeros((1, IMG, IMG, 3)),
                                method=JaxVoxelViT.init_all)
    pm = port_model("group_embed")
    ours, like = frozen_mask(pm, True), pm.state_dict()
    jmask = jax_frozen_mask(params, True)
    for path, leaf in convert._leaves(params):
        node = jmask
        for p in path:
            node = node[p]
        assert ours[convert._name_and_value(path, leaf, like)[0]] == bool(node), path
    assert all(ours[k] for k in ours if k.startswith("group")) and not ours["pos_embed"]


def test_three_group_embed_adam_steps_match_jax():
    """Three Adam steps: JAX takes gradients of ``model.apply(...,
    deterministic=True)`` with its own make_optimizer (its scanned step always
    runs dropout live); the port trains with the group dropout off."""
    lr = 1e-3
    jm = jax_model("group_embed")
    params = jax_params(jm, seed=6)
    tx = jax_optim.make_optimizer("Adam", trainable_mask=jax_frozen_mask(params, False))

    @jax.jit
    def jstep(p, opt_state, x, y):
        def loss_fn(q):
            return jax_cross_entropy(jm.apply({"params": q}, x, deterministic=True), y)

        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, jax_optim.apply_lr(updates, lr)), opt_state, loss

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = tx.init(jp)
    pm = port_model("group_embed")
    pm.group_embed.dropout = 0.0
    load_jax_params(pm, params)
    opt = optim.make_optimizer(dict(pm.named_parameters()), "Adam",
                               trainable_mask=frozen_mask(pm, False))
    step = make_train_step(TrainState(pm, opt))
    rs = np.random.RandomState(7)
    for _ in range(3):
        x = grids(B, rs.randint(1 << 30))
        y = rs.randint(0, 7, B).astype(np.int32)
        jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y))
        out = step({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, lr)
        np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=1e-4)
    assert opt.count == 3
    # Adam turns a sign difference in a gradient that is all rounding noise into up to
    # +-lr per step, so after 3 steps parameters agree to 3 lr
    want = jax_to_state_dict(jax.device_get(jp), pm.state_dict())
    got = pm.state_dict()
    assert {k for k in want if k.startswith("group")} and set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=3 * lr, err_msg=k)


def test_group_dropout_masks():
    """flax's dropout in train mode: kept values scaled by 1 / 0.9, a keep rate
    of 0.9, the same masks from the same seed, fresh masks each call, another
    seed other masks; identity in eval mode and at rate 0."""
    def layer(seed, rate=0.1):
        return PostNormEncoderLayer(16, dropout=rate, dropout_seed=seed).train()

    x = torch.ones(1000, 64)
    a, b, c = layer(5), layer(5), layer(6)
    first, second = a.drop(x), a.drop(x)
    kept = first != 0
    assert torch.equal(first[kept], torch.full_like(first[kept], 1 / 0.9))
    assert abs(float(kept.float().mean()) - 0.9) < 0.01  # 64,000 draws: 8 standard deviations
    assert torch.equal(first, b.drop(x)) and torch.equal(second, b.drop(x))
    assert not torch.equal(first, second) and not torch.equal(first, c.drop(x))
    assert torch.equal(a.eval().drop(x), x) and torch.equal(layer(5, 0.0).drop(x), x)
    # the whole model: the same seed gives the same train-mode logits, and the
    # dropout is live (train-mode logits differ from eval's)
    xs = torch.from_numpy(grids(B, 8))
    m1, m2 = port_model("group_embed", seed=3).train(), port_model("group_embed", seed=3).train()
    with torch.no_grad():
        t1, t2 = m1(xs), m2(xs)
        assert torch.equal(t1, t2) and not torch.equal(t1, m1.eval()(xs))


@pytest.mark.parametrize("route", ["group_embed", "weight_sharing", "hybrid"])
def test_bf16_residual_streams(route):
    """At bf16, as in the JAX model: the group encoder's f32 LayerNorms make
    the stage-1 core's residual stream f32, and the core's final norm makes
    stage 2's f32 too; weight_sharing's core takes the bf16 tokens; Hybrid's
    tokens are f32 (its convs take no dtype cast). Every block's Linears
    compute in bf16."""
    if route == "hybrid":
        emb = make_embed_layer("VoxelEmbed_Hybrid", 32, embed_dim=D, dtype=BF)
        model, x = VoxelViT(emb, n_classes=7, transformer_backbone=BACKBONE, img_size=IMG,
                            dtype=BF), torch.zeros(1, 32, 32, 32)
        want = [torch.float32]
    else:
        model, x = port_model(route, dtype=BF), torch.from_numpy(grids(1, 9))
        want = [torch.float32] * 2 if route == "group_embed" else [BF]
    seen = []
    model.blocks[0].register_forward_hook(lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    qkv = []
    model.blocks[0].attn.qkv.register_forward_hook(lambda m, i, o: qkv.append(o.dtype))
    with torch.no_grad():
        logits = model.train()(x)
    assert [i for i, _ in seen] == [o for _, o in seen] == want
    assert set(qkv) == {BF} and logits.dtype == BF and bool(torch.isfinite(logits.float()).all())


# the JAX CLI's epoch line (simple3dformer_tpu/cli/train_cls_voxel.py:279-282)
EPOCH_LINE = re.compile(r"^Epoch (\d+) loss (\d+\.\d{4}) test accuracy (\d\.\d{6}), "
                        r"mean class accuracy (\d\.\d{6}) \((\d+\.\d) samples/sec\)$")


@pytest.mark.parametrize("route", ["group_embed", "weight_sharing", "hybrid"])
def test_cli_routes_on_the_cpu(tmp_path, capsys, route):
    """The voxel CLI on each route at test size: group_embed and weight_sharing
    on ModelNet40 grids (cell 6, patch 5: 25 pillars of 6 tokens, or 5 slices
    of 26), group_embed at bf16; Hybrid on ShapeNetV2's 128^3 grids at patch 1;
    the epoch lines, and a checkpoint holding the route's parameters."""
    if route == "hybrid":
        argv = ["--dataset", "ShapeNetV2", "--synthetic", "8", "--batchSize", "8",
                "--embed-layer", "VoxelEmbed_Hybrid", "--patch-size", "1"]
        run_dir = "VoxelEmbed_Hybrid_default"
    else:
        argv = ["--dataset", "ModelNet40", "--synthetic", "32", "--batchSize", "16",
                "--embed-layer", "VoxelEmbed_no_average", "--cell-size", "6", "--patch-size", "5",
                "--pos-embedding", route] + (["--dtype", "bf16"] if route == "group_embed" else [])
        run_dir = f"VoxelEmbed_no_average_{route}"
    cli.main(argv + ["--epochs", "2", "--transformer-name", BACKBONE, "--lr", "1e-3",
                     "--device", "cpu", "--outf", str(tmp_path / "cls")])
    lines = capsys.readouterr().out.splitlines()
    epochs = [EPOCH_LINE.match(line) for line in lines if line.startswith("Epoch")]
    assert len(epochs) == 2 and all(epochs)
    ckpt = tmp_path / "cls" / "Voxel3D_2DPretrain" / run_dir / BACKBONE / "ckpt"
    params = Checkpointer(str(ckpt)).restore()[0]["params"]
    want = {"group_embed": "group_embed.self_attn.in_proj_weight",
            "weight_sharing": "voxel_pos_embed", "hybrid": "voxel_embed.conv2.weight"}[route]
    assert want in params and bool(torch.isfinite(params[want]).all())
    if route == "weight_sharing":
        assert tuple(params[want].shape) == (1, 26, D)
