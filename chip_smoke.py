#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (simple3dformer_tpu_torch) on one NVIDIA card.

Run from the root of a checkout on a machine with a Hopper card and nvcc:

    python3 chip_smoke.py

Phases, one line each (and a line per kernel shape):
  1. device   the card's name and power limit; TF32 off for the plain versions
  2. build    every csrc/*.cu with nvcc (all started together), seconds
  3. kernels  each kernel against its plain PyTorch version on the card, at the
              serving path's shapes and at the limits; time of both at the
              flagship shape
  4. serving  the flagship VoxelViT (deit_small, VoxelEmbed cell 6 / patch 5 on
              30^3 grids, 40 classes, seeded random weights) behind Predictor
              (batch 32) and ModelServer on 127.0.0.1: real HTTP requests, logits
              checked against the same weights on the CPU's plain path, launch
              counts read from the kernels' counters, latency and samples/s
Then a JSON line of the kernels, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before that
line. Without a card, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import copy
import http.client
import json
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

VOXEL, CELL, PATCH, N_CLASSES, BACKBONE = 30, 6, 5, 40, "deit_small_patch16_224"
BATCH = 32
# kernel shapes: (label, B, N, D, heads, dtype name)
KERNEL_SHAPES = [
    ("flagship f32", 32, 26, 384, 6, "float32"),
    ("flagship bf16", 32, 26, 384, 6, "bfloat16"),
    ("deit_base 3 heads", 32, 26, 768, 3, "float32"),
    ("deit_tiny", 32, 26, 192, 3, "float32"),
    ("N=65", 8, 65, 384, 6, "float32"),
    ("N=197", 4, 197, 768, 12, "float32"),
    ("B=1", 1, 26, 384, 6, "float32"),
    ("B=33", 33, 26, 384, 6, "float32"),
]
# f32: the same f32 products summed in another order.
# bf16: the same bf16-rounded operands, but a last-bit difference in an f32 sum
# can round an intermediate to the neighbouring bf16 value, and the output keeps
# 8 bits (one bf16 step is 2**-6 at magnitude 2..4).
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# served logits, CUDA kernel path vs the CPU plain path, after 12 blocks in f32
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from simple3dformer_tpu_torch.kernels.build import CSRC, build

    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = dict(zip(names, pool.map(build, names)))
    wall = time.perf_counter() - t0
    for name, (path, seconds, log) in results.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
        print(f"build {name}: {seconds:.1f} s nvcc, {len(regs)} kernels, "
              f"max {max(regs, default=0)} registers, {spills} bytes spill stores, {path.name}")
    print(f"build: {len(names)} sources in {wall:.1f} s")


def block_inputs(torch, b, n, d, dtype, seed, device):
    from simple3dformer_tpu_torch.kernels.vit_block import weight_shapes

    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, n, d).astype(np.float32)).to(device=device, dtype=dtype)
    weights = {}
    for name, shape in weight_shapes(d).items():
        if name in ("ln1_s", "ln2_s"):
            w = 1.0 + 0.1 * rs.randn(*shape)
        elif len(shape) == 2:
            w = rs.randn(*shape) * shape[1] ** -0.5
        else:
            w = 0.1 * rs.randn(*shape)
        weights[name] = torch.from_numpy(w.astype(np.float32)).to(device)
    return x, weights


def time_ms(torch, fn, iters=50):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(torch):
    from simple3dformer_tpu_torch.kernels.vit_block import fused_vit_block, vit_block_reference

    report = {}
    for label, b, n, d, heads, dtype in KERNEL_SHAPES:
        x, w = block_inputs(torch, b, n, d, getattr(torch, dtype), seed=b * 1000 + n + d,
                            device="cuda")
        got = fused_vit_block(x, w, heads)
        want = vit_block_reference(x, w, heads)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.isfinite(got).all()) and got.shape == x.shape and got.dtype == x.dtype
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        print(f"kernel fused_vit_block {label} B={b} N={n} D={d} H={heads} {dtype}: "
              f"max_abs_err {err:.3e} (tolerance {TOL[dtype]}) finite/shape {ok}")
        if not ok:
            raise AssertionError(f"fused_vit_block {label}: bad output")
        if label == "flagship f32":
            report["max_abs_err"] = err
            # in turns: plain, kernel, kernel, plain
            plain = [time_ms(torch, lambda: vit_block_reference(x, w, heads))]
            kernel = [time_ms(torch, lambda: fused_vit_block(x, w, heads)) for _ in range(2)]
            plain.append(time_ms(torch, lambda: vit_block_reference(x, w, heads)))
            report["ms"], report["plain_ms"] = float(np.mean(kernel)), float(np.mean(plain))
            print(f"kernel fused_vit_block flagship time: {report['ms']:.4f} ms kernel "
                  f"({kernel[0]:.4f}, {kernel[1]:.4f}), {report['plain_ms']:.4f} ms plain "
                  f"({plain[0]:.4f}, {plain[1]:.4f}), mean of 50 launches each")
    torch.cuda.synchronize()
    return report


def post(port, payload: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/predict", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def phase_serving(torch):
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.kernels.vit_block import fused_vit_block
    from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
    from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
    from simple3dformer_tpu_torch.serve.predictor import Predictor
    from simple3dformer_tpu_torch.serve.server import ModelServer

    g = generator(DEFAULT_SEED)
    emb = VoxelEmbed(voxel_size=VOXEL, cell_size=CELL, patch_size=PATCH, embed_dim=384,
                     generator=g)
    model = VoxelViT(emb, n_classes=N_CLASSES, transformer_backbone=BACKBONE, generator=g)
    depth = len(model.blocks)
    cpu_model = copy.deepcopy(model).eval()
    predictor = Predictor(model, (VOXEL,) * 3, device="cuda", batch_size=BATCH)
    server = ModelServer(predictor, host="127.0.0.1", port=0)
    port = server.start_background()
    try:
        sizes = [1, 40, 32, 7]  # 40: two chunks, the second padded
        grids, _ = synthetic_voxels(sum(sizes) + 10 * BATCH, VOXEL, N_CLASSES, seed=DEFAULT_SEED)
        grids = grids.astype(np.float32)
        fused_vit_block.launches = 0  # the main path starts here
        chunks, outs, start = 0, [], 0
        for n in sizes:
            x = grids[start:start + n]
            start += n
            status, body = post(port, json.dumps({"inputs": x.tolist()}))
            if status != 200:
                raise AssertionError(f"POST /predict of {n} samples: {status} {body}")
            logits = np.asarray(body["logits"], np.float32)
            if logits.shape != (n, N_CLASSES) or not np.isfinite(logits).all():
                raise AssertionError(f"bad logits for {n} samples: {logits.shape}")
            outs.append((x, logits))
            chunks += -(-n // BATCH)
        status, body = post(port, "{not json")
        if status != 400:
            raise AssertionError(f"malformed body answered {status}, not 400")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        if health.get("status") != "ok":
            raise AssertionError(f"/healthz: {health}")

        http_lat = []
        for _ in range(5):
            x = grids[start:start + BATCH]
            payload = json.dumps({"inputs": x.tolist()})
            t0 = time.perf_counter()
            status, _ = post(port, payload)
            http_lat.append(time.perf_counter() - t0)
            if status != 200:
                raise AssertionError(f"timed POST /predict: {status}")
            chunks += 1
        before = predictor.stats["requests"]
        x = grids[start:start + BATCH]
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            predictor(x)
            lat.append(time.perf_counter() - t0)
            chunks += 1
        launches = fused_vit_block.launches  # the main path ends here
        if predictor.stats["requests"] != before + 50:
            raise AssertionError("predictor request count")
        if launches != depth * chunks:
            raise AssertionError(f"fused_vit_block launched {launches} times for {chunks} "
                                 f"chunks of {depth} blocks")
    finally:
        server.shutdown()

    errs = []
    with torch.no_grad():
        for x, logits in outs:
            want = cpu_model(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(logits, want, **LOGIT_TOL)
            errs.append(float(np.abs(logits - want).max()))
    lat_ms = np.asarray(lat) * 1e3
    print(f"serving: {len(sizes)} POST /predict ({sizes} samples) + 5 timed, malformed -> 400, "
          f"healthz ok; logits (n, {N_CLASSES}) finite, max abs err vs CPU plain path "
          f"{max(errs):.3e} (tolerance {LOGIT_TOL}); fused_vit_block launches {launches} = "
          f"{depth} x {chunks} chunks")
    print(f"serving latency at batch {BATCH} (Predictor call, host clock, 50 calls): "
          f"p50 {np.percentile(lat_ms, 50):.3f} ms, p95 {np.percentile(lat_ms, 95):.3f} ms, "
          f"{BATCH / np.median(lat_ms) * 1e3:.1f} samples/s at p50; HTTP POST of 32 grids "
          f"(JSON included) p50 {np.median(http_lat) * 1e3:.1f} ms")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this check runs only on the card",
              file=sys.stderr)
        return 1
    try:
        import simple3dformer_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 1
    try:
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
        phase_build()
        report = phase_kernels(torch)
        launches = phase_serving(torch)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "simple3dformer_tpu"))
        if leaked:
            raise AssertionError(f"the port imported JAX-side modules: {leaked}")
    except Exception:  # noqa: BLE001 — any failed phase fails the check
        traceback.print_exc()
        return 1
    kernels = [dict(name="fused_vit_block", route="cuda",
                    source="simple3dformer_tpu_torch/csrc/vit_block.cu",
                    replaces="simple3dformer_tpu/kernels/vit_block.py:264",
                    launches=launches, **report)]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
