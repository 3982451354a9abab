"""The port's VoxelViT against the JAX package's, with weights carried across
by simple3dformer_tpu_torch.utils.convert, on the CPU."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.data.datasets import synthetic_voxels as jax_synthetic_voxels
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT, pack_factor
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V, CELL, PATCH, B = 12, 4, 3, 4
BACKBONE = "deit_tiny_patch16_224"
IMG = 32  # the 2D pathway's image size: 4 patches keep init_all cheap


def _refbridge():
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "refbridge.py"
    spec = importlib.util.spec_from_file_location("refbridge", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def perturbed(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(tree))


def jax_model(head="default", pos_embedding="default"):
    emb = JaxVoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=192)
    return JaxVoxelViT(voxel_embed=emb, n_classes=7, transformer_backbone=BACKBONE,
                       head=head, pos_embedding=pos_embedding, img_size=IMG)


def port_model(head="default", pos_embedding="default"):
    emb = VoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=192)
    return VoxelViT(emb, n_classes=7, transformer_backbone=BACKBONE, head=head,
                    pos_embedding=pos_embedding, img_size=IMG).eval()


@pytest.mark.parametrize("head,pos_embedding,tree", [
    ("default", "default", "init"),          # model.init: no 2D-pathway leaves
    ("AMSoftmax", "no_embed", "init_all"),   # init_all: every leaf
])
def test_voxelvit_matches_jax(head, pos_embedding, tree):
    x = (np.random.RandomState(1).rand(B, V, V, V) > 0.8).astype(np.float32)
    jm = jax_model(head, pos_embedding)
    xj = jnp.asarray(x)
    if tree == "init":
        variables = jm.init(jax.random.key(0), xj)
    else:
        images = jnp.zeros((1, IMG, IMG, 3))
        variables = jm.init(jax.random.key(0), xj, images, method=JaxVoxelViT.init_all)
    params = perturbed(variables["params"], seed=2)
    # the JAX side packs B rows per attention row (auto batch_pack)
    assert pack_factor(B, (V // CELL) ** 2 + 1) > 1
    want = np.asarray(jm.apply({"params": params}, xj))

    pm = port_model(head, pos_embedding)
    missing = load_jax_params(pm, params)
    assert bool(missing) == (tree == "init")
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (B, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_converter_matches_refbridge_export():
    jm = jax_model()
    x = jnp.zeros((2, V, V, V))
    variables = jm.init(jax.random.key(3), x, jnp.zeros((1, IMG, IMG, 3)),
                        method=JaxVoxelViT.init_all)
    params = perturbed(variables["params"], seed=4)
    want = _refbridge().export_voxelvit_state_dict(params, cell_size=CELL)
    pm = port_model()
    got = jax_to_state_dict(params, pm.state_dict())
    assert set(got) == set(want) == set(pm.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    pm.load_state_dict(want)  # a reference-layout state dict loads as it is


def test_converter_refuses_mismatched_trees():
    pm = port_model()
    like = pm.state_dict()
    with pytest.raises(KeyError, match="no such parameter"):
        jax_to_state_dict({"extra": np.zeros(3, np.float32)}, like)
    with pytest.raises(ValueError, match="shape"):
        jax_to_state_dict({"cls_token": np.zeros((1, 1, 8), np.float32)}, like)
    with pytest.raises(KeyError, match="lacks"):
        load_jax_params(pm, {"cls_token": np.zeros((1, 1, 192), np.float32)})


def test_routes_not_ported_raise():
    for mode in ("group_embed", "weight_sharing"):
        with pytest.raises(NotImplementedError, match="other voxel routes"):
            port_model(pos_embedding=mode)
    with pytest.raises(ValueError):
        port_model(pos_embedding="nonsense")


def test_seeded_init_is_reproducible_and_complete():
    def build(seed):
        g = torch.Generator().manual_seed(seed)
        emb = VoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=192,
                         generator=g)
        return VoxelViT(emb, n_classes=40, transformer_backbone=BACKBONE, generator=g)

    a, b, c = build(9).state_dict(), build(9).state_dict(), build(10).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])
    assert {"patch_embed.proj.weight", "pos_embed", "head.weight",
            "voxel_embed.proj.conv3d_1.weight", "voxel_head.weight"} <= set(a)


def test_synthetic_voxels_same_stream_as_jax_package():
    for got, want in zip(synthetic_voxels(5, 8, 40, seed=3), jax_synthetic_voxels(5, 8, 40, seed=3)):
        np.testing.assert_array_equal(got, want)
