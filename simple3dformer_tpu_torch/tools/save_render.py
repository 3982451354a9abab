"""Offline fixed-view renderer for ShapeNet models (port of
simple3dformer_tpu/tools/save_render.py).

The reference renders PyTorch3D meshes at a fixed view (dist=1, elev=1,
azim=90) to 224x224 PNGs under .tmp/{synset_id}/{model_id}.png, over
mp.spawn ranks. This renders the *voxelized* models (what training reads)
with matplotlib at the same fixed view and output layout; the parallelism
is a process pool (host work, no collectives). A model that cannot be
rendered is skipped with a message, as in the reference. matplotlib is
imported inside the call only.

Usage:
  python -m simple3dformer_tpu_torch.tools.save_render DATA_ROOT [-o OUT_ROOT] [-j WORKERS]
"""

from __future__ import annotations

import glob
import multiprocessing
import os

import numpy as np

from ..data import binvox

FIXED_VIEW = dict(elev=1.0, azim=90.0)
IMG_SIZE = 224


def render_voxels_to_png(grid: np.ndarray, out_path: str,
                         view: dict | None = None) -> str:
    """Scatter the occupied voxels of ``grid`` at ``view`` into a 224x224 PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    view = view or FIXED_VIEW
    occ = np.argwhere(grid)
    fig = plt.figure(figsize=(IMG_SIZE / 100, IMG_SIZE / 100), dpi=100)
    ax = fig.add_subplot(projection="3d")
    if len(occ):
        ax.scatter(occ[:, 0], occ[:, 1], occ[:, 2], c=occ[:, 2],
                   cmap="viridis", marker="s", s=2)
    ax.view_init(elev=view["elev"], azim=view["azim"])
    ax.set_axis_off()
    fig.subplots_adjust(left=0, right=1, top=1, bottom=0)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    plt.savefig(out_path)
    plt.close(fig)
    return out_path


def _render_one(args) -> str | None:
    binvox_path, out_path = args
    try:
        with open(binvox_path, "rb") as f:
            grid = binvox.read_as_3d_array(f).data
        return render_voxels_to_png(grid, out_path)
    except (OSError, ValueError) as e:  # an unreadable model, skipped as the reference does
        print(f"skip {binvox_path}: {e}")
        return None


def generate_fixed_view_rendering(data_root: str, out_root: str = ".tmp",
                                  workers: int = 1) -> list[str]:
    """Render every */models/*.solid.binvox under data_root to
    out_root/{synset}/{model}.png."""
    jobs = []
    for path in sorted(glob.glob(os.path.join(data_root, "*", "*", "models", "*.solid.binvox"))):
        parts = path.split(os.sep)
        synset, model_id = parts[-4], parts[-3]
        jobs.append((path, os.path.join(out_root, synset, f"{model_id}.png")))
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            results = pool.map(_render_one, jobs)
    else:
        results = [_render_one(j) for j in jobs]
    return [r for r in results if r]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Fixed-view renders of a ShapeNet binvox tree.")
    ap.add_argument("data_root")
    ap.add_argument("-o", "--out-root", default=".tmp")
    ap.add_argument("-j", "--workers", type=int, default=1)
    args = ap.parse_args(argv)
    outs = generate_fixed_view_rendering(args.data_root, args.out_root, args.workers)
    print(f"rendered {len(outs)} models")


if __name__ == "__main__":
    main()
