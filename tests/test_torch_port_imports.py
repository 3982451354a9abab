"""The port stands apart from JAX: its modules import none of it, not even
when the server builds its label maps, importing them builds nothing (no
compiler starts), and its chip check refuses to run without a card."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, subprocess, sys
started = []
subprocess.run = subprocess.Popen = lambda *a, **k: started.append(a) or 1 / 0
import simple3dformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not started, started
from simple3dformer_tpu_torch.serve.server import default_class_names
maps = {n: default_class_names(n) for n in WIDTHS}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
                                    "simple3dformer_tpu"))
print(json.dumps([names, bad, maps]))
"""
WIDTHS = (10, 13, 15, 40, 1000)
# ViP-3D, the two visualizers, profiling and run logging, imported like every other module
NEW_ENTRY_POINTS = ("models.vip3d", "cli.train_pure_mlp", "utils.attention_rollout",
                    "cli.visualize_attention_map_voxel", "cli.visualize_point_cloud",
                    "utils.profiling", "core.logging_utils",
                    # data parallelism and ZeRO-1 over torch.distributed
                    "parallel.mesh", "parallel.zero",
                    # tensor, pipeline and sequence parallelism
                    "parallel.tp", "parallel.pp", "parallel.sp",
                    # the modules no CLI reaches
                    "models.legacy_voxel", "nn.point_embed", "data.voxel_augment", "data.cad",
                    # the native ingest and the data tools, on g++-built host libraries
                    "data.native_ingest", "core.host_build", "tools.voxelize",
                    "tools.view_voxels", "tools.save_render", "tools.collect_s3dis",
                    "tools.indoor3d_blocks")


def test_port_imports_no_jax():
    code = f"import json\nWIDTHS = {WIDTHS}\n" + IMPORT_ALL
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad, maps = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) >= 79
    assert {f"simple3dformer_tpu_torch.{m}" for m in NEW_ENTRY_POINTS} <= set(names)
    assert bad == [], bad
    from simple3dformer_tpu.serve.server import default_class_names as jax_default_class_names

    for n in WIDTHS:
        want = jax_default_class_names(n)
        assert want and {int(k): v for k, v in maps[str(n)].items()} == want, n


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
