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
  5. training kernels  the training forward, both block backwards and Adam against
              their plain versions on the card; each backward run twice, bit-equal;
              times of kernel, plain version and (Adam) torch.optim.Adam(fused=True)
  6. training the flagship (deit_small, B=32, f32) through the port's trainer:
              3 steps on the card against 3 on the CPU's plain path from the same
              weights and batches; the CLI on a synthetic corpus held on the card
              (loss falls over 40 steps, launch counts from the counters); an
              eval-mode gradient (the recompute backward); samples/s over 50 steps
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


# the backwards' shapes: (label, B, N, D, heads, dtype name)
TRAIN_SHAPES = [s for s in KERNEL_SHAPES
                if s[0] in ("flagship f32", "flagship bf16", "deit_base 3 heads", "N=197",
                            "B=1", "B=33")]
# gradients: an error relative to the largest reference value. f32: sums of
# up to B*N products in another order; bf16: as TOL, a last-bit difference can
# round an intermediate to the neighbouring bf16 value.
GRAD_REL = {"float32": 1e-4, "bfloat16": 3e-2}
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12  # H100 SXM: HBM bytes/s, f32 non-tensor FLOP/s
# base lr of the CLI run (chosen on the CPU: 3.69 -> 0.76 over 40 steps); the
# warmup scales it by (epoch + 1) / 2000, so 1e-5 to 2e-4 over the 20 epochs
TRAIN_LR = 0.02
TRAIN_SAMPLES, TRAIN_EPOCHS = 64, 20  # 2 steps per epoch at B=32: 40 steps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms for the work, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    out = 0
    for t in tensors:
        if isinstance(t, dict):
            out += nbytes(*t.values())
        elif t is not None:
            out += t.numel() * t.element_size()
    return out


def block_flops(b, n, d, heads) -> int:
    """One block forward: qkv, proj, fc1, fc2 products and the two attention products."""
    return 24 * b * n * d * d + 4 * b * heads * n * n * (d // heads)


def errors(got: dict, want: dict) -> tuple[float, float]:
    """(max abs error, max error relative to the largest value of each output)."""
    diffs = [(float((got[k].float() - want[k].float()).abs().max()),
              max(1.0, float(want[k].float().abs().max()))) for k in want]
    return max(a for a, _ in diffs), max(a / m for a, m in diffs)


def in_turns(torch, kernel, plain):
    """Mean ms of kernel and plain, timed plain, kernel, kernel, plain (50 calls each)."""
    p = [time_ms(torch, plain)]
    k = [time_ms(torch, kernel) for _ in range(2)]
    p.append(time_ms(torch, plain))
    return float(np.mean(k)), float(np.mean(p))


def phase_train_kernels(torch):
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    report = {}
    for label, b, n, d, heads, dtype in TRAIN_SHAPES:
        x, w = block_inputs(torch, b, n, d, getattr(torch, dtype), seed=b * 1000 + n + d,
                            device="cuda")
        g = torch.from_numpy(np.random.RandomState(b + n + d).randn(b, n, d).astype(np.float32))
        g = g.to(device="cuda", dtype=x.dtype)
        y, res = vb.fused_vit_block_train_fwd(x, w, heads)
        y_ref, res_ref = vb.vit_block_train_reference(x, w, heads)
        gx, gw = vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res)
        gx2, gw2 = vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res)
        want_x, want_w = vb.vit_block_backward_reference(x, g, w, heads, residuals=res)
        cx, cw = vb.fused_vit_block_bwd(x, g, w, heads)
        cx2, cw2 = vb.fused_vit_block_bwd(x, g, w, heads)
        rec_x, rec_w = vb.vit_block_backward_reference(x, g, w, heads)
        torch.cuda.synchronize()
        abs_errs, errs = {}, {}
        for key, got, want in [("fwd", {"y": y, **res}, {"y": y_ref, **res_ref}),
                               ("bwd_res", {"gx": gx, **gw}, {"gx": want_x, **want_w}),
                               ("bwd", {"gx": cx, **cw}, {"gx": rec_x, **rec_w})]:
            abs_errs[key], errs[key] = errors(got, want)
        same = all(torch.equal(a, c) for a, c in [(gx, gx2), (cx, cx2)]
                   + [(gw[k], gw2[k]) for k in gw] + [(cw[k], cw2[k]) for k in cw])
        print(f"kernel training block {label} B={b} N={n} D={d} H={heads} {dtype}: error "
              f"relative to the largest value: forward+residuals {errs['fwd']:.3e}, residual "
              f"backward {errs['bwd_res']:.3e}, recompute backward {errs['bwd']:.3e} "
              f"(tolerance {GRAD_REL[dtype]}); two runs of each backward bit-equal {same}")
        if max(errs.values()) > GRAD_REL[dtype] or not same:
            raise AssertionError(f"training block kernels {label}: errors {errs}, "
                                 f"bit-equal {same}")
        if label != "flagship f32":
            continue
        flops = block_flops(b, n, d, heads)
        ws = [w[k] for k in vb.WNAMES]
        cases = {
            "fused_vit_block_train_fwd": (
                lambda: vb.fused_vit_block_train_fwd(x, w, heads),
                lambda: vb.vit_block_train_reference(x, w, heads),
                nbytes(x, *ws, y, res), flops, abs_errs["fwd"]),
            "fused_vit_block_train_bwd": (
                lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res),
                lambda: vb.vit_block_backward_reference(x, g, w, heads, residuals=res),
                nbytes(x, g, *ws, res, gx, gw), 2 * flops, abs_errs["bwd_res"]),
            "fused_vit_block_bwd": (
                lambda: vb.fused_vit_block_bwd(x, g, w, heads),
                lambda: vb.vit_block_backward_reference(x, g, w, heads),
                nbytes(x, g, *ws, cx, cw), 3 * flops, abs_errs["bwd"]),
        }
        for name, (kernel, plain, moved, ops, err) in cases.items():
            ms, plain_ms = in_turns(torch, kernel, plain)
            bound_ms, bound_by = bound(moved, ops)
            report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None)
            print(f"kernel {name} flagship: max abs err {err:.3e}; {ms:.4f} ms kernel, "
                  f"{plain_ms:.4f} ms plain, "
                  f"bound {bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.2f} MB, "
                  f"{ops / 1e9:.3f} GFLOP), mean of 50 launches each, in turns")
    report["fused_adam"] = adam_check(torch)
    torch.cuda.synchronize()
    return report


def flagship_model(torch, device="cpu"):
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
    from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed

    g = generator(DEFAULT_SEED)
    emb = VoxelEmbed(voxel_size=VOXEL, cell_size=CELL, patch_size=PATCH, embed_dim=384,
                     generator=g)
    return VoxelViT(emb, n_classes=N_CLASSES, transformer_backbone=BACKBONE,
                    generator=g).to(device)


def adam_check(torch):
    """fused_adam against adam_reference over the flagship's leaves, and the times
    of both and of torch.optim.Adam(fused=True) on the same leaves."""
    from simple3dformer_tpu_torch.kernels.adam import adam_reference, fused_adam

    params = [p.detach() for p in flagship_model(torch, "cuda").parameters()]
    rs = np.random.RandomState(0)
    leaves = []
    for p in params:
        m = torch.from_numpy(0.01 * rs.randn(*p.shape).astype(np.float32)).cuda()
        v = torch.from_numpy(1e-4 * rs.rand(*p.shape).astype(np.float32)).cuda()
        g = torch.from_numpy(0.01 * rs.randn(*p.shape).astype(np.float32)).cuda()
        leaves.append((p, m, v, g))
    lr, count = 1e-3, 3
    want = [adam_reference(p, m, v, g, lr, count) for p, m, v, g in leaves]
    got = [tuple(t.clone() for t in leaf) for leaf in leaves]
    fused_adam(got, lr, count)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for leaf, ref in zip(got, want)
              for a, b in zip(leaf[:3], ref))
    n = sum(p.numel() for p in params)
    print(f"kernel fused_adam: {len(leaves)} leaves, {n} parameters, max abs err vs plain "
          f"{err:.3e} (tolerance 0: the same IEEE operations in the same order)")
    if err != 0.0:
        raise AssertionError(f"fused_adam differs from adam_reference: {err}")

    def plain():
        for p, m, v, g in got:
            adam_reference(p, m, v, g, lr, count)

    ms, plain_ms = in_turns(torch, lambda: fused_adam(got, lr, count), plain)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, leaf in zip(lib_params, leaves):
        p.grad = leaf[3].clone()
    lib = torch.optim.Adam(lib_params, lr=lr, fused=True)
    library_ms = time_ms(torch, lib.step)
    bound_ms, bound_by = bound(7 * 4 * n, 12 * n)  # about 12 operations per element
    print(f"kernel fused_adam time: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
          f"{library_ms:.4f} ms torch.optim.Adam(fused=True), bound {bound_ms:.4f} ms "
          f"({bound_by}: {7 * 4 * n / 1e6:.1f} MB), mean of 50 calls each")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_training(torch):
    """The flagship through the port's trainer; returns the launch counts of the
    training path and the train throughput."""
    import contextlib
    import io
    import tempfile

    from simple3dformer_tpu_torch.cli import train_cls_voxel
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.kernels import vit_block as vb
    from simple3dformer_tpu_torch.kernels.adam import fused_adam
    from simple3dformer_tpu_torch.models.voxel_vit import frozen_mask
    from simple3dformer_tpu_torch.train.loop import (TrainState, make_scanned_train_steps,
                                                     make_train_step)
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    def trainer(device):
        model = flagship_model(torch, device)
        opt = make_optimizer(dict(model.named_parameters()), "Adam",
                             trainable_mask=frozen_mask(model, False))
        return TrainState(model, opt)

    # 3 steps on the card and on the CPU's plain path, same weights and batches
    grids, labels = synthetic_voxels(3 * BATCH, VOXEL, N_CLASSES, seed=DEFAULT_SEED + 2)
    losses = {}
    for device in ("cuda", "cpu"):
        state = trainer(device)
        step = make_train_step(state)
        out = []
        for i in range(3):
            batch = {"x": torch.from_numpy(grids[i * BATCH:(i + 1) * BATCH]).float().to(device),
                     "y": torch.from_numpy(labels[i * BATCH:(i + 1) * BATCH]).to(device)}
            out.append(float(step(batch, 1e-4)["loss"]))
        losses[device] = out
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    print(f"training: 3 flagship steps at B={BATCH}, lr 1e-4: losses on the card "
          f"{losses['cuda']} vs the CPU's plain path {losses['cpu']} (rtol 1e-3)")

    # the CLI on a synthetic corpus held on the card: the main path of training
    depth = 12
    for fn in (vb.fused_vit_block, vb.fused_vit_block_bwd, vb.fused_vit_block_train_fwd,
               vb.fused_vit_block_train_bwd, fused_adam):
        fn.launches = 0
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as outf, contextlib.redirect_stdout(log):
        train_cls_voxel.main([
            "--dataset", "ModelNet40", "--synthetic", str(TRAIN_SAMPLES),
            "--epochs", str(TRAIN_EPOCHS), "--batchSize", str(BATCH), "--lr", str(TRAIN_LR),
            "--transformer-name", BACKBONE, "--cell-size", str(CELL),
            "--patch-size", str(PATCH), "--outf", outf])
    steps = TRAIN_EPOCHS * (TRAIN_SAMPLES // BATCH)
    # an eval-mode gradient through the model: the recompute backward
    model = trainer("cuda").model.eval()
    x = torch.from_numpy(grids[:BATCH]).float().cuda()
    y = torch.from_numpy(labels[:BATCH]).long().cuda()
    loss = torch.nn.functional.cross_entropy(model(x), y)
    grads = torch.autograd.grad(loss, list(model.blocks.parameters()))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in (
        vb.fused_vit_block, vb.fused_vit_block_bwd, vb.fused_vit_block_train_fwd,
        vb.fused_vit_block_train_bwd, fused_adam)}  # the main path ends here
    epoch_losses = [float(line.split()[3]) for line in log.getvalue().splitlines()
                    if line.startswith("Epoch ")]
    print(f"training CLI: {steps} steps, epoch losses {epoch_losses[0]:.4f} -> "
          f"{epoch_losses[-1]:.4f}; launches {launches}")
    want = {"fused_vit_block_train_fwd": depth * steps, "fused_vit_block_train_bwd": depth * steps,
            "fused_adam": steps, "fused_vit_block_bwd": depth}
    if len(epoch_losses) != TRAIN_EPOCHS or not epoch_losses[-1] < 0.75 * epoch_losses[0]:
        raise AssertionError(f"training loss did not fall: {epoch_losses}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"launch counts {launches}, want {want}")
    if not all(bool(torch.isfinite(t).all()) for t in grads):
        raise AssertionError("eval-mode gradient is not finite")
    cpu_model = trainer("cpu").model.eval()
    cpu_loss = torch.nn.functional.cross_entropy(cpu_model(x.cpu()), y.cpu())
    cpu_grads = torch.autograd.grad(cpu_loss, list(cpu_model.blocks.parameters()))
    gerr = max(float((a.cpu() - b).abs().max()) / max(1e-6, float(b.abs().max()))
               for a, b in zip(grads, cpu_grads))
    print(f"eval-mode gradient through 12 blocks (recompute backward): error vs the CPU's "
          f"plain path relative to the largest value {gerr:.3e} (tolerance 1e-3)")
    if gerr > 1e-3:
        raise AssertionError(f"eval-mode gradient differs from the CPU's: {gerr}")

    # train throughput: 50 steps at B=32 from a corpus on the card, host clock
    state = trainer("cuda")
    corpus, clabels = synthetic_voxels(51 * BATCH, VOXEL, N_CLASSES, seed=DEFAULT_SEED + 3)
    ds = DeviceResidentDataset({"x": corpus, "y": clabels}, "cuda")
    run = make_scanned_train_steps(state, ds)
    idx = ds.put_indices(np.arange(51 * BATCH).reshape(51, BATCH))
    run(idx[:1], 1e-4)  # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run(idx[1:], 1e-4)
    float(metrics["loss"][-1])
    dt = time.perf_counter() - t0
    ms_step = dt / 50 * 1e3
    print(f"training throughput: {ms_step:.3f} ms per step, {50 * BATCH / dt:.1f} samples/s "
          f"at B={BATCH} f32 (host clock over 50 steps, corpus on the card)")
    profile_steps(torch, run, idx[1:11], ms_step)
    return launches, {"ms_per_step": ms_step, "samples_per_s": 50 * BATCH / dt}


KERNEL_GROUPS = ("grad_gemm_kernel", "gemm_kernel", "attention_kernel", "attn_bwd_rows_kernel",
                 "attn_bwd_cols_kernel", "colsum_kernel", "ln_bwd_kernel", "row_stats_kernel",
                 "adam_kernel")


def profile_steps(torch, run, idx, ms_step):
    """Where a train step's device time goes: torch.profiler over len(idx) steps;
    the busy share is against ``ms_step``, the step time without the profiler.
    Informational: a profiler that records no device time is reported, not fatal."""
    from torch.profiler import ProfilerActivity, profile

    steps = idx.shape[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(run(idx, 1e-4)["loss"][-1])
        wall = time.perf_counter() - t0
    groups: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        name = next((g for g in KERNEL_GROUPS if g in e.key), "other (PyTorch's own kernels, copies)")
        groups[name] = groups.get(name, 0.0) + us
    total = sum(groups.values())
    if not total:
        print("training profile: the profiler recorded no device time")
        return
    parts = ", ".join(f"{k} {v / steps / 1e3:.3f}" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    device_ms = total / steps / 1e3
    print(f"training profile over {steps} steps: device {device_ms:.3f} ms per step, "
          f"{device_ms / ms_step:.1%} of the {ms_step:.3f} ms step without the profiler "
          f"({wall / steps * 1e3:.3f} ms with it); ms per step by kernel: {parts}")


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
        train_report = phase_train_kernels(torch)
        train_launches, _ = phase_training(torch)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "simple3dformer_tpu"))
        if leaked:
            raise AssertionError(f"the port imported JAX-side modules: {leaked}")
    except Exception:  # noqa: BLE001 — any failed phase fails the check
        traceback.print_exc()
        return 1
    b, n, d, heads = 32, 26, 384, 6
    vit_bytes = 4 * (2 * b * n * d + 12 * d * d + 13 * d)  # x, y, weights
    bound_ms, bound_by = bound(vit_bytes, block_flops(b, n, d, heads))
    block_src = "simple3dformer_tpu_torch/csrc/vit_block.cu"
    kernels = [dict(name="fused_vit_block", route="cuda", source=block_src,
                    replaces="simple3dformer_tpu/kernels/vit_block.py:264",
                    launches=launches, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    **report)]
    for name, replaces, source in [
            ("fused_vit_block_bwd", "simple3dformer_tpu/kernels/vit_block.py:290", block_src),
            ("fused_vit_block_train_fwd", "simple3dformer_tpu/kernels/vit_block.py:366",
             block_src),
            ("fused_vit_block_train_bwd", "simple3dformer_tpu/kernels/vit_block.py:477",
             block_src),
            ("fused_adam", "simple3dformer_tpu/kernels/adam.py:76",
             "simple3dformer_tpu_torch/csrc/adam.cu")]:
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=train_launches[name], **train_report[name]))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
