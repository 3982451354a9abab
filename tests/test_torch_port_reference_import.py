"""The reference-checkpoint importers of the port (utils/torch_convert.py)
against the JAX package's, on the CPU, for the four families: VoxelViT
(default and group_embed), Hengshuang segmentation with BatchNorm statistics,
the 3DViT family (the plain cls model and 3DViT_1_layer seg with its image
pathway) and ViP-3D with PEG.

Seeded values in the shapes of a JAX init (statistics positive) are written
in the reference's layout by scripts/refbridge.py's exporters (which need no
reference checkout) and saved in both of the reference's schemes: a bare
state dict with DDP's ``module.`` prefix, and the Hydra dict with numpy
metrics. The port's import must equal, leaf for leaf, utils/convert.py of the
JAX package's import of the same file; a missing entry must raise.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.models import point_vit as jpv
from simple3dformer_tpu.models import vip3d as jv
from simple3dformer_tpu.models.hengshuang import PointTransformerSeg as JaxSeg
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn import voxel_embed as jve
from simple3dformer_tpu.utils import torch_convert as jtc
from simple3dformer_tpu_torch.models import point_vit as ppv
from simple3dformer_tpu_torch.models import vip3d as pv
from simple3dformer_tpu_torch.models.hengshuang import PointTransformerSeg
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn import voxel_embed as pve
from simple3dformer_tpu_torch.utils import torch_convert as tc
from simple3dformer_tpu_torch.utils.convert import jax_to_state_dict

_SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
V, CELL, PATCH, D = 16, 4, 4, 192
N_PT, NNB = 64, 8
BACKBONE = "deit_tiny_patch16_224"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _refbridge():
    spec = importlib.util.spec_from_file_location("refbridge", _SCRIPTS / "refbridge.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


refbridge = _refbridge()


def _random(shapes, seed, stats=False):
    """Seeded values in the shapes of a JAX tree (``jax.eval_shape`` of an
    init: nothing is compiled); statistics positive."""
    rs = np.random.RandomState(seed)
    if stats:
        return jax.tree_util.tree_map(lambda a: (0.5 + rs.rand(*a.shape)).astype(np.float32),
                                      shapes)
    return jax.tree_util.tree_map(lambda a: 0.05 * rs.randn(*a.shape).astype(np.float32), shapes)


def _init_shapes(jm, *inputs, method=None):
    return jax.eval_shape(lambda k: jm.init(k, *inputs, method=method), jax.random.key(0))


def voxelvit(route):
    """(JAX params, stats, the reference state dict, the port model, the JAX
    importer: sd -> (params, stats))."""
    jemb, pemb = ((jve.VoxelEmbedNoAverage, pve.VoxelEmbedNoAverage) if route == "group_embed"
                  else (jve.VoxelEmbed, pve.VoxelEmbed))
    kw = dict(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=D)
    jm = JaxVoxelViT(voxel_embed=jemb(**kw), n_classes=7, transformer_backbone=BACKBONE,
                     pos_embedding=route, img_size=32)
    variables = _init_shapes(jm, jnp.zeros((2, V, V, V)), jnp.zeros((1, 32, 32, 3)),
                             method=JaxVoxelViT.init_all)
    params = _random(variables["params"], 1)
    sd = refbridge.export_voxelvit_state_dict(params, cell_size=CELL)
    pm = VoxelViT(pemb(**kw), n_classes=7, transformer_backbone=BACKBONE, pos_embedding=route,
                  img_size=32)
    return (params, {}, sd, pm, tc.reference_voxelvit_to_state_dict,
            lambda s: (jtc.reference_voxelvit_to_jax_tree(s), {}))


def hengshuang():
    jm = JaxSeg(num_point=N_PT, num_class=50, input_dim=22, nblocks=2, nneighbor=NNB,
                transformer_dim=64)
    variables = _init_shapes(jm, jnp.zeros((2, N_PT, 22)))
    params = _random(variables["params"], 2)
    stats = _random(variables["batch_stats"], 3, stats=True)
    sd = refbridge.export_hengshuang_state_dict(params, 2, stats, seg=True)
    pm = PointTransformerSeg(N_PT, 50, 22, nblocks=2, nneighbor=NNB, transformer_dim=64)
    return params, stats, sd, pm, tc.reference_hengshuang_to_state_dict, \
        jtc.reference_hengshuang_to_jax_tree


def pointvit(variant, task):
    in_dim, n_class = (6, 40) if task == "cls" else (22, 50)
    jm = jpv.PointViT(variant=variant, task=task, num_point=N_PT, num_class=n_class,
                      input_dim=in_dim, nneighbor=NNB, img_size=32)
    variables = _init_shapes(jm, jnp.zeros((2, N_PT, in_dim)), jnp.zeros((1, 32, 32, 3)),
                             method=jm.init_all)
    params = _random(variables["params"], 4)
    stats = _random(variables["batch_stats"], 5, stats=True)
    sd = refbridge.export_pointvit_state_dict(params, in_dim, stats)
    pm = ppv.PointViT(variant, task, N_PT, n_class, input_dim=in_dim, nneighbor=NNB, img_size=32)
    return params, stats, sd, pm, tc.reference_pointvit_to_state_dict, \
        jtc.reference_pointvit_to_jax_tree


def vip3d():
    """Narrow vip3d with PEG: 8^3 tokens at C=64, a patch-2 downsample, 4^3 at 96."""
    layers, trans, dims, seg, cell = [2, 2], [True, False], [64, 96], [8, 4], 2
    kw = dict(voxel_size=V, cell_size=cell, patch_size=8, embed_dim=dims[0])
    arch = dict(layers=layers, embed_dims=dims, transitions=trans, segment_dim=seg,
                mlp_ratios=[3, 3])
    jm = jv.VisionPermutator3D(embed_layer=jve.VoxelEmbedNoAverage(**kw), num_classes=9,
                               pos_embedding="PEG", **arch)
    params = _random(_init_shapes(jm, jnp.zeros((2, V, V, V)))["params"], 6)
    sd = refbridge.export_vip3d_state_dict(params, layers, trans, dims, cell, peg=True)
    pm = pv.VisionPermutator3D(pve.VoxelEmbedNoAverage(**kw), num_classes=9, pos_embedding="PEG",
                               **arch)
    return (params, {}, sd, pm, tc.reference_vip3d_to_state_dict,
            lambda s: (jtc.reference_vip3d_to_jax_tree(s, params), {}))


CASES = {
    "voxelvit_default": functools.cache(lambda: voxelvit("default")),
    "voxelvit_group_embed": lambda: voxelvit("group_embed"),
    "hengshuang_seg": functools.cache(hengshuang),
    "pointvit_plain_cls": lambda: pointvit("3DViT", "cls"),
    "pointvit_1_layer_seg": functools.cache(lambda: pointvit("3DViT_1_layer", "seg")),
    "vip3d_peg": functools.cache(vip3d),
}


def save(path, sd, scheme):
    """The reference's two schemes: train_cls_voxel.py's bare state dict of its
    DDP wrapper, the Hydra scripts' dict with numpy metrics."""
    if scheme == "ddp":
        torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    else:
        torch.save({"epoch": 3, "instance_avg_iou": np.float64(0.625),
                    "class_avg_iou": np.mean(np.array([0.5, 0.75], np.float32)),
                    "model_state_dict": sd, "optimizer_state_dict": {"state": {},
                                                                     "param_groups": []}}, path)


@pytest.mark.parametrize("case", list(CASES))
def test_reference_import_equals_the_jax_import(case, tmp_path):
    params, stats, sd, pm, port_map, jax_map = CASES[case]()
    like = pm.state_dict()
    for scheme in ("ddp", "hydra"):
        path = str(tmp_path / f"{scheme}.pth")
        save(path, sd, scheme)
        got_sd, meta = tc.load_reference_checkpoint(path)
        assert set(got_sd) == set(sd)
        if scheme == "hydra":
            assert meta == {"epoch": 3, "instance_avg_iou": 0.625, "class_avg_iou": 0.625}
        else:
            assert meta == {}
        state = port_map(got_sd, like)
        assert tc.import_reference_state(pm, state) == []

        jax_sd, _ = jtc.load_reference_checkpoint(path)
        jp, js = jax_map(jax_sd)
        jp = jtc.import_reference_state(params, jp)
        js = jtc.import_reference_state(stats, js) if stats else {}
        want = jax_to_state_dict(jax.device_get(jp), like, jax.device_get(js))
        got = pm.state_dict()
        assert set(want) <= set(got)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        for k in set(got) - set(want):  # the BatchNorm step counts, which JAX keeps none of
            assert k.endswith("num_batches_tracked") and torch.equal(got[k], sd[k]), k


@pytest.mark.parametrize("case", ["voxelvit_default", "hengshuang_seg", "pointvit_1_layer_seg",
                                  "vip3d_peg"])
def test_reference_import_raises_on_a_missing_entry(case):
    _, _, sd, pm, port_map, _ = CASES[case]()
    dropped = sorted(sd)[len(sd) // 2]
    if dropped not in pm.state_dict():  # a dead entry: take a live one
        dropped = next(k for k in sorted(pm.state_dict()) if k in sd)
    partial = {k: v for k, v in sd.items() if k != dropped}
    with pytest.raises(ValueError, match=f"first unmatched \\['{dropped}'\\]"):
        tc.import_reference_state(pm, port_map(partial, pm.state_dict()))
    assert tc.import_reference_state(pm, port_map(partial, pm.state_dict()),
                                     require_full=False) == [dropped]


def test_reference_import_warns_of_entries_without_a_place_and_checks_shapes():
    _, _, sd, pm, port_map, _ = CASES["vip3d_peg"]()
    extra = dict(sd, **{"network.9.attn.proj.weight": torch.zeros(3, 3)})
    with pytest.warns(UserWarning, match=r"1 entries .*'network\.9\.attn\.proj\.weight'"):
        port_map(extra, pm.state_dict())
    bad = dict(sd, **{"norm.weight": torch.zeros(7)})
    with pytest.raises(ValueError, match=r"norm\.weight has shape \(7,\)"):
        port_map(bad, pm.state_dict())
