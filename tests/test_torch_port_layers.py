"""The port's layers and block kernel (plain path) against the JAX package, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both sides;
weights cross over through simple3dformer_tpu_torch.utils.convert.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.kernels.vit_block import fused_vit_block as jax_fused_vit_block
from simple3dformer_tpu.nn import layers as jl
from simple3dformer_tpu.nn import voxel_embed as jve
from simple3dformer_tpu_torch.kernels.vit_block import (
    WNAMES, fused_vit_block, vit_block_reference)
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn import layers as tl
from simple3dformer_tpu_torch.nn import voxel_embed as tve
from simple3dformer_tpu_torch.utils.convert import jax_to_state_dict

# f32 on both sides; XLA and torch sum in different orders
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def perturbed(tree, seed):
    """The same tree with seeded noise on every leaf, so that LayerNorm
    scales, biases and zero-initialised embeddings all matter."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(tree))


def block_params(d, seed):
    """A flax Block's parameter tree, made with numpy (no flax init)."""
    rs = np.random.RandomState(seed)

    def dense(i, o):
        return {"kernel": (rs.randn(i, o) * i ** -0.5).astype(np.float32),
                "bias": (0.05 * rs.randn(o)).astype(np.float32)}

    def norm():
        return {"scale": (1 + 0.1 * rs.randn(d)).astype(np.float32),
                "bias": (0.1 * rs.randn(d)).astype(np.float32)}

    return {"norm1": norm(), "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
            "norm2": norm(), "mlp": {"fc1": dense(d, 4 * d), "fc2": dense(4 * d, d)}}


def jax_block(b, n, d, heads, seed):
    x = np.random.RandomState(seed).randn(b, n, d).astype(np.float32)
    return jl.Block(num_heads=heads), block_params(d, seed + 1), x


def port_block(params, d, heads):
    blk = tl.Block(d, heads).eval()
    blk.load_state_dict(jax_to_state_dict(params, blk.state_dict()))
    return blk


@pytest.mark.parametrize("b,n,d,heads,seg_len", [
    (3, 26, 128, 2, None),
    (2, 17, 192, 3, None),   # deit_tiny width
    (2, 26, 128, 2, 13),     # two packed sequences per row
])
def test_block_matches_flax(b, n, d, heads, seg_len):
    blk, params, x = jax_block(b, n, d, heads, seed=n + d)
    want = blk.apply({"params": params}, jnp.asarray(x), seg_len=seg_len)
    with torch.no_grad():
        got = port_block(params, d, heads)(torch.from_numpy(x), seg_len=seg_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _jax_weights(p):
    return dict(
        ln1_s=p["norm1"]["scale"], ln1_b=p["norm1"]["bias"],
        wqkv=p["attn"]["qkv"]["kernel"], bqkv=p["attn"]["qkv"]["bias"],
        wproj=p["attn"]["proj"]["kernel"], bproj=p["attn"]["proj"]["bias"],
        ln2_s=p["norm2"]["scale"], ln2_b=p["norm2"]["bias"],
        w1=p["mlp"]["fc1"]["kernel"], b1=p["mlp"]["fc1"]["bias"],
        w2=p["mlp"]["fc2"]["kernel"], b2=p["mlp"]["fc2"]["bias"],
    )


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_vit_block_reference_matches_pallas_interpret(cdt):
    # B=5 also exercises the TPU kernel's fake-sample batch padding
    b, n, d, heads = 5, 26, 128, 2
    _, params, x = jax_block(b, n, d, heads, seed=7)
    jw = {k: jnp.asarray(v) for k, v in _jax_weights(params).items()}
    want = jax_fused_vit_block(jnp.asarray(x), jw, heads, jnp.dtype(cdt), True, 104)
    weights = port_block(params, d, heads).fused_weights()
    got = vit_block_reference(torch.from_numpy(x), weights, heads, getattr(torch, cdt))
    if cdt == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    else:
        # Both sides round the same operands to bf16 and sum in f32, but a
        # last-bit difference in an f32 sum can round an intermediate (z, q,
        # k, p, o, g) to the neighbouring bf16 value, 2**-8 relative, which
        # then feeds later products (measured here: at most 4.1e-3 absolute).
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-2, atol=1e-2)


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    _, params, x = jax_block(2, 26, 128, 2, seed=3)
    blk = port_block(params, 128, 2)
    before = fused_vit_block.launches
    with torch.no_grad():
        got = fused_vit_block(torch.from_numpy(x), blk.fused_weights(), 2)
        want = vit_block_reference(torch.from_numpy(x), blk.fused_weights(), 2)
        plain = blk(torch.from_numpy(x))
    assert fused_vit_block.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)
    assert set(blk.fused_weights()) == set(WNAMES)


def test_block_fused_guard_names_each_reason():
    blk = tl.Block(128, 2, drop=0.1)
    x = torch.zeros(2, 26, 128)
    with torch.inference_mode():
        assert "dropout" in blk.train().fused_unsupported(x)
        assert blk.eval().fused_unsupported(x) is None
        assert "seg_len" in blk.fused_unsupported(x, seg_len=13)
        assert "sequence length" in blk.fused_unsupported(torch.zeros(1, 513, 128))
        assert "head_dim" in tl.Block(96 * 2, 2).eval().fused_unsupported(torch.zeros(1, 4, 192))
    # grad mode with parameters that require grad: the kernels have backwards now
    assert blk.eval().fused_unsupported(x) is None
    assert "dropout" in blk.train().fused_unsupported(x)
    assert "LayerNorm eps" in tl.Block(128, 2, norm_eps=1e-5).eval().fused_unsupported(x)


def test_amsoftmax_matches_flax():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 64).astype(np.float32)
    head = jl.AMSoftmaxLayer(n_classes=10)
    params = perturbed(head.init(jax.random.key(0), jnp.asarray(x))["params"], 0)
    port = tl.AMSoftmaxLayer(64, 10)
    port.W.data.copy_(torch.from_numpy(params["W"]))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(head.apply({"params": params}, jnp.asarray(x))),
                               **F32_TOL)


@pytest.mark.parametrize("name,voxel,cell", [
    ("VoxelEmbed", 12, 4),
    ("VoxelEmbed", 13, 4),   # grid not divisible by the cell: trimmed
    ("VoxelEmbed_no_average", 12, 4),
    ("VoxelEmbed_no_zdim", 12, 4),
])
def test_voxel_embeds_match_flax(name, voxel, cell):
    x = (np.random.RandomState(voxel).rand(2, voxel, voxel, voxel) > 0.8).astype(np.float32)
    jmod = jve.make_embed_layer(name, voxel, cell, 3, embed_dim=64)
    params = perturbed(jmod.init(jax.random.key(0), jnp.asarray(x))["params"], 1)
    tmod = tve.make_embed_layer(name, voxel, cell, 3, embed_dim=64)
    # the converter names the tokenizer as the model holds it, under voxel_embed.
    like = {f"voxel_embed.{k}": v for k, v in tmod.state_dict().items()}
    sd = jax_to_state_dict({"voxel_embed": params}, like)
    tmod.load_state_dict({k.removeprefix("voxel_embed."): v for k, v in sd.items()})
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    assert got.shape == want.shape and tmod.num_patches == jmod.num_patches
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)


def test_make_embed_layer_refuses_what_is_not_ported():
    """Every tokenizer is ported; what the JAX package rejects, the port
    rejects: an unknown name, and VoxelEmbed_Hybrid on the group_embed route
    (patch 1 gives a position embedding of 2 tokens to 7-token pillars)."""
    with pytest.raises(ValueError, match="Unknown type of 3D data embedding"):
        tve.make_embed_layer("NoSuchEmbed", 32)
    hybrid = tve.make_embed_layer("VoxelEmbed_Hybrid", 32, embed_dim=192)
    assert isinstance(hybrid, tve.VoxelEmbedHybrid) and hybrid.patch_size == 1
    model = VoxelViT(hybrid, n_classes=7, transformer_backbone="deit_tiny_patch16_224",
                     pos_embedding="group_embed", img_size=32)
    with pytest.raises(ValueError, match=r"7 tokens .*group_pos_embed \(1, 2, 192\)"):
        model(torch.zeros(1, 32, 32, 32))


def test_mlp_head_matches_flax():
    x = np.random.RandomState(5).randn(3, 32).astype(np.float32)
    head = jl.MlpHead(widths=(64, 16), n_out=5)
    params = perturbed(head.init(jax.random.key(0), jnp.asarray(x))["params"], 5)
    port = tl.MlpHead(32, (64, 16), 5)
    port.load_state_dict(jax_to_state_dict(params, port.state_dict()))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(head.apply({"params": params}, jnp.asarray(x))),
                               **F32_TOL)


def test_drop_path_drops_whole_samples_only_in_training():
    dp = tl.DropPath(0.5, seed=0)
    x = torch.ones(64, 3, 4)
    assert torch.equal(dp.eval()(x), x)
    y = dp.train()(x)
    per_sample = y.reshape(64, -1)
    kept = per_sample[:, 0] != 0
    assert torch.equal(per_sample[kept], torch.full_like(per_sample[kept], 2.0))
    assert torch.equal(per_sample[~kept], torch.zeros_like(per_sample[~kept]))
    assert 0 < int(kept.sum()) < 64


def test_vit_blocks_draw_their_own_drop_path_masks():
    """Each block of a ViTCore draws from its own seed: the blocks do not all
    drop the same samples."""
    from simple3dformer_tpu_torch.nn.vit import ViTCore

    core = ViTCore(8, 3, 2, drop_path=0.5).train()
    x = torch.ones(64, 1, 1)
    kept = [blk.drop_path(x).flatten() != 0 for blk in core.blocks]
    assert not torch.equal(kept[0], kept[1]) and not torch.equal(kept[1], kept[2])
