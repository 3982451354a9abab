"""The port's DeiT weight loader (utils/torch_convert.maybe_load_deit) against
the JAX package's, on the CPU: timm-named state dicts that the test writes
(plain, distilled, a ViT-21k layout, a position embedding of another grid)
loaded into the 2D DeiT and into the 3D models; both loaders apply the same
entries with the same values, and without a file both warn and change
nothing."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.models import point_vit as jpv
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn import vit as jvit
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.utils import torch_convert as jtc
from simple3dformer_tpu_torch.core.rng import generator
from simple3dformer_tpu_torch.models import point_vit as ppv
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn import vit as pvit
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.utils import convert
from simple3dformer_tpu_torch.utils import torch_convert as ptc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(embed_dim=64, depth=2, num_heads=2)  # a 2D DeiT at test size
NAME = "deit_small_patch16_224"  # the file name the loaders look for


def timm_state_dict(img_size=32, distilled=False, tiny=False, seed=11):
    """A timm-named state dict from a seeded port ViT2D (timm's names)."""
    cfg = (dict(embed_dim=192, depth=12, num_heads=3) if tiny else SMALL)
    model = pvit.ViT2D(cfg["embed_dim"], cfg["depth"], cfg["num_heads"], img_size=img_size,
                       distilled=distilled, generator=generator(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def to_21k(sd):
    """The ViT-21k layout the reference's fit_dict reads: a ``transformer.``
    prefix, ``pwff`` for ``mlp`` and q, k, v projections apart."""
    out = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            if ".attn.qkv." in k:
                for name, part in zip("qkv", v.chunk(3, dim=0)):
                    out["transformer." + k.replace("qkv", f"proj_{name}")] = part.clone()
                continue
            k = "transformer." + k.replace(".mlp.", ".pwff.")
        out[k] = v
    return out


def jax_and_port(kind):
    """(JAX params, port model holding the same values, JAX model) of a target."""
    rs_img = jnp.zeros((1, 32, 32, 3))
    if kind.startswith("vit2d"):
        distilled = "distilled" in kind
        img = 48 if "48" in kind else 32
        jm = jvit.ViT2D(**SMALL, img_size=img, distilled=distilled)
        params = jm.init(jax.random.key(0), jnp.zeros((1, img, img, 3)))["params"]
        pm = pvit.ViT2D(SMALL["embed_dim"], SMALL["depth"], SMALL["num_heads"], img_size=img,
                        distilled=distilled)
    elif kind in ("3DViT", "3DViT_1_layer"):
        jm = jpv.PointViT(variant=kind, task="seg", num_point=32, num_class=50, input_dim=22,
                          nneighbor=4, img_size=32)
        x = jnp.zeros((2, 32, 22))
        init = (jm.init if kind == "3DViT" else
                lambda k, a: jm.init(k, a, rs_img, method=jm.init_all))
        variables = jax.jit(init)(jax.random.key(0), x)
        params = variables["params"]
        pm = ppv.PointViT(kind, "seg", 32, 50, input_dim=22, nneighbor=4, img_size=32)
        convert.load_jax_params(pm, jax.device_get(params), jax.device_get(
            variables["batch_stats"]))
        return jax.device_get(params), pm
    else:
        emb = JaxVoxelEmbed(voxel_size=12, cell_size=4, patch_size=3, embed_dim=192)
        jm = JaxVoxelViT(voxel_embed=emb, n_classes=5,
                         transformer_backbone="deit_tiny_patch16_224", img_size=32)
        params = jm.init(jax.random.key(0), jnp.zeros((2, 12, 12, 12)), rs_img,
                         method=JaxVoxelViT.init_all)["params"]
        pm = VoxelViT(VoxelEmbed(voxel_size=12, cell_size=4, patch_size=3, embed_dim=192),
                      n_classes=5, transformer_backbone="deit_tiny_patch16_224", img_size=32)
    params = jax.device_get(params)
    assert not convert.load_jax_params(pm, params)
    return params, pm


def jax_load(params, monkeypatch):
    """The JAX loader on ``params``; -> (merged tree, the paths it applied)."""
    applied = []

    def recording(p, loaded, prefix=""):
        merged, names = merge(p, loaded, prefix)
        if not prefix:
            applied.extend(names)
        return merged, names

    merge = jtc.merge_into
    monkeypatch.setattr(jtc, "merge_into", recording)
    return jax.device_get(jtc.maybe_load_deit(params, NAME)), applied


def port_name(params, path, like):
    node = params
    for p in path.split("/"):
        node = node[p]
    return convert._name_and_value(tuple(path.split("/")), np.asarray(node, np.float32), like)[0]


CASES = {
    # target model, file: (img_size, distilled, tiny, 21k layout), entries applied
    "vit2d same": ("vit2d", (32, False, False, False), 4 + 2 * 12 + 2 + 2),
    "vit2d distilled from plain": ("vit2d distilled", (32, False, False, False), 4 + 24 + 4),
    "vit2d plain from distilled": ("vit2d", (32, True, False, False), 4 + 24 + 4),
    "vit2d 48 px from 32 px": ("vit2d 48", (32, False, False, False), 4 + 24 + 4),
    "vit2d from 21k layout": ("vit2d", (32, False, False, True), 4 + 24 + 4),
    # the plain 3DViT: no 2D pathway, its point head is no DeiT head
    "3DViT": ("3DViT", (32, False, True, False), 1 + 12 * 12 + 2),
    "3DViT_1_layer": ("3DViT_1_layer", (32, False, True, False), 4 + 144 + 4),
    "VoxelViT": ("voxel", (32, False, True, False), 4 + 144 + 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_both_loaders_apply_the_same_entries_and_values(case, tmp_path, monkeypatch, capsys):
    kind, (img, distilled, tiny, layout_21k), n_applied = CASES[case]
    sd = timm_state_dict(img, distilled, tiny)
    torch.save({"model": to_21k(sd) if layout_21k else sd}, os.path.join(tmp_path, f"{NAME}.pth"))
    monkeypatch.setenv("DEIT_CKPT_DIR", str(tmp_path))
    params, pm = jax_and_port(kind)
    like = pm.state_dict()
    merged, japplied = jax_load(params, monkeypatch)
    applied = ptc.maybe_load_deit(pm, NAME)
    out = capsys.readouterr().out.splitlines()
    assert out == [f"loaded {n_applied} tensors from {tmp_path}/{NAME}.pth"] * 2
    assert sorted(applied) == sorted(port_name(params, p, like) for p in japplied)
    assert len(applied) == n_applied
    got = pm.state_dict()
    want = convert.jax_to_state_dict(merged, like)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k in applied:  # the file's values where the entry is the same
        if k in sd and sd[k].shape == got[k].shape and not layout_21k:
            assert torch.equal(got[k], sd[k]), k
    if "48" in kind:  # the grid resampled: cls slot kept, 2x2 -> 3x3 bicubic
        assert "pos_embed" in applied and torch.equal(got["pos_embed"][:, :1], sd["pos_embed"][:, :1])
    if "distilled" in kind:  # the dist slot seeded from the cls slot
        assert torch.equal(got["pos_embed"][:, 1], sd["pos_embed"][:, 0])
    if kind == "3DViT":
        assert not any(k.startswith("head.") for k in applied)


def test_21k_fit_equals_jax():
    sd = to_21k(timm_state_dict())
    got = ptc.fit_21k_state_dict(sd)
    want = jtc.fit_21k_state_dict({k: v.numpy() for k, v in sd.items()})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert sorted(got) == sorted(timm_state_dict())


@pytest.mark.parametrize("n_extra", [(1, 1), (2, 1), (1, 2)])
def test_interpolate_pos_embed_equals_jax(n_extra):
    src_extra, tgt_extra = n_extra
    pos = np.random.RandomState(0).randn(1, src_extra + 16, 8).astype(np.float32)
    got = ptc.interpolate_pos_embed(torch.from_numpy(pos), src_extra, 36, tgt_extra)
    want = jtc.interpolate_pos_embed(pos, src_extra, 36, tgt_extra)
    assert got.shape == (1, tgt_extra + 36, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_without_a_file_both_warn_and_change_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("DEIT_CKPT_DIR", str(tmp_path))
    params, pm = jax_and_port("voxel")
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    with pytest.warns(UserWarning, match="No local checkpoint for deit_small_patch16_224"):
        assert jtc.maybe_load_deit(params, NAME) is params
    with pytest.warns(UserWarning, match="No local checkpoint for deit_small_patch16_224"):
        assert ptc.maybe_load_deit(pm, NAME) == []
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert ptc.find_checkpoint(NAME) is None and jtc.find_checkpoint(NAME) is None
    (tmp_path / f"{NAME}.pt").write_bytes(b"")
    assert ptc.find_checkpoint(NAME) == jtc.find_checkpoint(NAME) == f"{tmp_path}/{NAME}.pt"
    monkeypatch.delenv("DEIT_CKPT_DIR")
    assert (ptc.CKPT_DIR_ENV, ptc.DEFAULT_CKPT_DIR) == (jtc.CKPT_DIR_ENV, jtc.DEFAULT_CKPT_DIR)
