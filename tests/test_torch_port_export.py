"""Predictor.export and load_exported on the CPU: the ViT block forward as the
op s3f::vit_block_fwd (opcheck, and kept as one node of an exported program),
the flagship, a group_embed VoxelViT and a ViP-3D model exported, saved and
loaded in a fresh process that imports no model code, their logits against the
eager Predictor's; a point model's export raises, naming the first kernel it
reaches; a card artifact is refused where no card is visible.

On the CPU a block runs its plain modules, so the voxel programs hold no op
node here (on the card each block is the op: chip_smoke.py phase 23 checks
it); the op's own program is checked through a module that calls
``fused_vit_block``. Models are narrow and seeded; inputs come from numpy.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple3dformer_tpu_torch.kernels import vit_block as vb
from simple3dformer_tpu_torch.models import point_vit as ppv
from simple3dformer_tpu_torch.models import vip3d as pv
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed, VoxelEmbedNoAverage
from simple3dformer_tpu_torch.serve import predictor as serve
from simple3dformer_tpu_torch.serve.predictor import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = "deit_tiny_patch16_224"
B = 2
# the exported program against the eager forward, over the largest logit: the
# same ops, which the export may decompose (linear into a product and an add)
EXPORT_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def flagship():
    g = _gen()
    return VoxelViT(VoxelEmbed(voxel_size=12, cell_size=4, patch_size=3, embed_dim=192,
                               generator=g), n_classes=7, transformer_backbone=BACKBONE,
                    generator=g), (12, 12, 12)


def group_embed():
    g = _gen(1)
    emb = VoxelEmbedNoAverage(voxel_size=27, cell_size=9, patch_size=3, embed_dim=192, generator=g)
    return VoxelViT(emb, n_classes=7, transformer_backbone=BACKBONE, pos_embedding="group_embed",
                    img_size=32, generator=g), (27, 27, 27)


def vip3d():
    """Narrow vip3d_s7: 8^3 tokens at C=64, a patch-2 downsample, 4^3 at 96."""
    g = _gen(2)
    emb = VoxelEmbedNoAverage(voxel_size=32, cell_size=4, patch_size=8, embed_dim=64, generator=g)
    return pv.VisionPermutator3D(emb, layers=[2, 1], embed_dims=[64, 96],
                                 transitions=[True, False], segment_dim=[8, 4],
                                 mlp_ratios=[3, 3], num_classes=5, generator=g), (32, 32, 32)


class OneBlock(torch.nn.Module):
    """A module calling fused_vit_block: on the CPU too its program holds the op."""

    def __init__(self, d=128, heads=2):
        super().__init__()
        rs = np.random.RandomState(3)
        self.heads = heads
        self.w = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(
                (0.1 * rs.randn(*shape) + (1.0 if k.endswith("_s") else 0.0)).astype(np.float32)))
            for k, shape in vb.weight_shapes(d).items()})

    def forward(self, x):
        return vb.fused_vit_block(x, dict(self.w), self.heads)


MODELS = {"flagship": flagship, "group_embed": group_embed, "vip3d": vip3d}

# the fresh process: load_exported on each artifact, its outputs, and the
# modules of the port that it imported
LOADER = """
import json, sys
import numpy as np
from simple3dformer_tpu_torch.serve.predictor import load_exported
d = sys.argv[1]
with open(f"{d}/names.json") as f:
    names = json.load(f)
for name in names:
    np.save(f"{d}/{name}.got.npy", load_exported(f"{d}/{name}.pt2")(np.load(f"{d}/{name}.x.npy")))
print(json.dumps(sorted(m for m in sys.modules if m.startswith("simple3dformer"))))
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each model exported through its Predictor (and OneBlock through
    torch.export) on the CPU, loaded in one fresh process; -> (directory, the
    eager outputs by name, the modules the process imported)."""
    d = tmp_path_factory.mktemp("exported")
    want = {}
    for i, (name, make) in enumerate(MODELS.items()):
        model, shape = make()
        predictor = Predictor(model, shape, device="cpu", batch_size=B, warmup=False)
        x = (np.random.RandomState(i).rand(B, *shape) > 0.8).astype(np.float32)
        predictor.export(str(d / f"{name}.pt2"))
        want[name] = predictor(x)
        np.save(d / f"{name}.x.npy", x)
    block = OneBlock()
    x = np.random.RandomState(9).randn(B, 5, 128).astype(np.float32)
    with torch.no_grad():
        program = torch.export.export(block, (torch.from_numpy(x),), strict=False)
        want["block"] = block(torch.from_numpy(x)).numpy()
    torch.export.save(program, str(d / "block.pt2"), extra_files={serve.EXPORT_DEVICE: "cpu"})
    np.save(d / "block.x.npy", x)
    (d / "names.json").write_text(json.dumps(list(want)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT,
                                                                    os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", LOADER, str(d)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return d, want, json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", [*MODELS, "block"])
def test_exported_program_matches_eager_in_a_fresh_process(exported, name):
    d, want, _ = exported
    got = np.load(d / f"{name}.got.npy")
    assert got.shape == want[name].shape and np.isfinite(got).all()
    err = float(np.abs(got - want[name]).max()) / float(np.abs(want[name]).max())
    assert err <= EXPORT_REL, err


def test_loading_needs_no_model_code(exported):
    _, _, modules = exported
    assert modules == ["simple3dformer_tpu_torch", "simple3dformer_tpu_torch.kernels",
                       "simple3dformer_tpu_torch.kernels.vit_block",
                       "simple3dformer_tpu_torch.serve", "simple3dformer_tpu_torch.serve.predictor"]


def test_block_program_keeps_the_op():
    """fused_vit_block without autograd is one call of s3f::vit_block_fwd in
    the exported graph, its weights lifted as the program's parameters."""
    with torch.no_grad():
        program = torch.export.export(OneBlock(), (torch.zeros(B, 5, 128),), strict=False)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets == [torch.ops.s3f.vit_block_fwd.default]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_vit_block_op_passes_opcheck(cdt):
    """torch.library.opcheck: the schema, the fake implementation against the
    CPU one, and the op under AOT dispatch."""
    block = OneBlock()
    x = torch.from_numpy(np.random.RandomState(4).randn(B, 5, 128).astype(np.float32))
    ws = [block.w[k].detach() for k in vb.WNAMES]
    torch.library.opcheck(torch.ops.s3f.vit_block_fwd.default, (x, ws, 2, cdt))
    np.testing.assert_array_equal(
        torch.ops.s3f.vit_block_fwd(x, ws, 2, cdt).numpy(),
        vb.vit_block_reference(x, dict(zip(vb.WNAMES, ws)), 2, cdt).numpy())


def test_op_fake_checks_the_gate():
    """The fake implementation refuses what the kernel refuses, with no data."""
    ws = [torch.empty(s, device="meta") for s in vb.weight_shapes(128).values()]
    x = torch.empty(B, 600, 128, device="meta")  # N above the kernel's 512
    with pytest.raises(ValueError, match="sequence length 600"):
        torch.ops.s3f.vit_block_fwd(x, ws, 2, torch.float32)
    assert torch.ops.s3f.vit_block_fwd(x[:, :5], ws, 2, torch.float32).shape == (B, 5, 128)


def test_point_model_export_names_the_kernel(tmp_path):
    pm = ppv.PointViT("3DViT_1_layer", "seg", 64, 50, input_dim=22, nneighbor=8, img_size=32)
    predictor = Predictor(pm, (64, 22), device="cpu", batch_size=B, warmup=False)
    with pytest.raises(RuntimeError, match="the fps kernel is not registered as a torch op"):
        predictor.export(str(tmp_path / "point.pt2"))


def test_card_artifact_is_refused_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    with torch.no_grad():
        program = torch.export.export(OneBlock(), (torch.zeros(B, 5, 128),), strict=False)
    path = str(tmp_path / "card.pt2")
    torch.export.save(program, path, extra_files={serve.EXPORT_DEVICE: "cuda"})
    assert serve.exported_device(path) == "cuda"
    with pytest.raises(RuntimeError, match="exported for a CUDA card and none is visible"):
        serve.load_exported(path)
