#!/usr/bin/env python3
"""Device time of the ViT block's attention kernels in one or more checkouts,
in turns, on one card.

    python3 block_attention_ab.py [--steps] TREE [TREE ...]

Each TREE is the root of a checkout of the repository (``.`` for this one).
They run in the order given, each in a process of its own (a process imports
one copy of the port), so ``build/parent . . build/parent`` times a parent and
a change in turns. For each tree and each shape (the flagship, partseg and the
two LwF blocks at N=197; f32) a process prints the device ms a call of the
attention forward (``attention_kernel``) and backward (``attn_bwd_rows_kernel``
+ ``attn_bwd_cols_kernel``): torch.profiler over 10 calls of the training
forward and backward, ``chip_smoke.attention_device_ms`` of this checkout.
With ``--steps`` it also times the f32 train steps of the flagship (B=32,
Adam) and of partseg (B=16, SGD) at chip_smoke's shapes: host clock over 20
steps after a warm-up step, corpus on the card. Then a table gives each
tree's mean per shape. Needs the card and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# (label, B, N, D, heads)
SHAPES = [("flagship", 32, 26, 384, 6), ("partseg N=257", 16, 257, 192, 3),
          ("LwF deit_small N=197", 64, 197, 384, 6),
          ("LwF deit_base teacher N=197", 64, 197, 768, 12)]


STEPS = 20


def step_ms(torch, run, idx, lr) -> float:
    """ms a train step: host clock over STEPS steps after a warm-up step."""
    import time

    run(idx[:1], lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(run(idx[1:], lr)["loss"][-1])
    return (time.perf_counter() - t0) / STEPS * 1e3


def train_steps(torch, cs) -> dict:
    """ms a step of the flagship and partseg f32 train steps (chip_smoke's
    models, batches and learning rates)."""
    import numpy as np

    from simple3dformer_tpu_torch.cli import train_partseg as tp
    from simple3dformer_tpu_torch.core.config import Config
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.models.voxel_vit import frozen_mask
    from simple3dformer_tpu_torch.train.loop import (TrainState, make_scanned_train_steps,
                                                     seg_cross_entropy)
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    n = (STEPS + 1) * cs.BATCH
    model = cs.flagship_model(torch, "cuda")
    state = TrainState(model, make_optimizer(dict(model.named_parameters()), "Adam",
                                             trainable_mask=frozen_mask(model, False)))
    grids, labels = synthetic_voxels(n, cs.VOXEL, cs.N_CLASSES, seed=3)
    ds = DeviceResidentDataset({"x": grids, "y": labels}, "cuda")
    idx = ds.put_indices(np.arange(n).reshape(STEPS + 1, cs.BATCH))
    out = {"flagship step": step_ms(torch, make_scanned_train_steps(state, ds), idx, 1e-4)}

    n = (STEPS + 1) * cs.PB
    (xs, cats, segs), _ = tp.load_arrays(Config(num_point=cs.PN, normal=True, synthetic=n,
                                                seed=9))
    model = cs.partseg_model(torch, "cuda")
    state = TrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"))
    ds = DeviceResidentDataset({"x": xs[:n], "cls": cats[:n], "y": segs[:n]}, "cuda")
    idx = ds.put_indices(np.arange(n).reshape(STEPS + 1, cs.PB))
    run = make_scanned_train_steps(state, ds, seg_cross_entropy, prepare_fn=tp.make_prepare_fn())
    out["partseg step"] = step_ms(torch, run, idx, cs.PARTSEG_LR)
    return out


def worker(tree: str, steps: bool) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    if not Path(vb.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise SystemExit(f"imported {vb.__file__}, not the port of {tree}")
    out = {}
    for label, b, n, d, heads in SHAPES:
        x, w = cs.block_inputs(torch, b, n, d, torch.float32, seed=b * 1000 + n + d,
                               device="cuda")
        g = torch.randn(b, n, d, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
        _, res = vb.fused_vit_block_train_fwd(x, w, heads)
        ms = cs.attention_device_ms(
            torch, lambda: vb.fused_vit_block_train_fwd(x, w, heads),
            lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res))
        if not ms:
            raise SystemExit("the profiler recorded no device time")
        out[label] = ms
        print(f"{tree} {label}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    if steps:
        for label, ms in train_steps(torch, cs).items():
            out[label] = {"step": ms}
            print(f"{tree} {label}: {ms:.3f} ms", flush=True)
    print("RESULT " + json.dumps(out), flush=True)


def main(trees: list[str], steps: bool) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    runs: list[tuple[str, dict]] = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--worker", tree]
                              + (["--steps"] if steps else []), capture_output=True, text=True)
        print(proc.stdout, end="")
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
        runs.append((tree, json.loads(line[len("RESULT "):])))
    print("device ms a call, attention forward / backward; ms a train step (the mean by "
          "tree, then each run):")
    for label, first in runs[0][1].items():
        keys = [k for k in ("fwd", "bwd", "step") if k in first]
        by_tree: dict[str, list] = {}
        for tree, res in runs:
            by_tree.setdefault(tree, []).append([res[label][k] for k in keys])
        cells = []
        for tree, vals in by_tree.items():
            mean = " / ".join(f"{sum(v[i] for v in vals) / len(vals):.4f}"
                              for i in range(len(keys)))
            each = ", ".join(" / ".join(f"{x:.4f}" for x in v) for v in vals)
            cells.append(f"{tree}: {mean} ({each})")
        print(f"  {label} ({' / '.join(keys)}): " + "; ".join(cells))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    with_steps = "--steps" in args
    args = [a for a in args if a != "--steps"]
    if len(args) == 2 and args[0] == "--worker":
        worker(args[1], with_steps)
    elif args and "--worker" not in args:
        sys.exit(main(args, with_steps))
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
