#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (simple3dformer_tpu_torch) on one NVIDIA card.

Run from the root of a checkout on a machine with a Hopper card and nvcc:

    python3 chip_smoke.py

Phases, one line each (and a line per kernel shape):
  1. device   the card's name and power limit; TF32 off for the plain versions
  2. build    every csrc/*.cu with nvcc and the three host C++ libraries
              (the binvox ingest, the voxelizer, the viewer) with g++, all
              started together, seconds; the
              registers and spills of each instantiation of the tensor-core GEMM
              core (tc_gemm_kernel): the vector-attention forwards' and
              backwards', and the ViT block's (by GEMM and route); and of
              each kNN and FPS kernel
  3. kernels  each kernel against its plain PyTorch version on the card, at the
              serving path's shapes and at the limits; time of both and of
              torch.nn.TransformerEncoderLayer at the flagship shape
  4. serving  the flagship VoxelViT (deit_small, VoxelEmbed cell 6 / patch 5 on
              30^3 grids, 40 classes, seeded random weights) behind Predictor
              (batch 32) and ModelServer on 127.0.0.1: real HTTP requests, logits
              checked against the same weights on the CPU's plain path, launch
              counts read from the kernels' counters, latency and samples/s
  5. training kernels  the training forward, both block backwards and Adam against
              their plain versions on the card; each backward run twice, bit-equal;
              times of kernel, plain version and library call
              (torch.nn.TransformerEncoderLayer; torch.optim.Adam(fused=True)); the
              block forward's and backward's device time by kernel at the flagship
              and partseg shapes, each GEMM with its grid and TFLOP/s, and the
              attention kernels' device time a call beside their bound and
              scaled_dot_product_attention's (f32, each backend), in turns; the
              training forward run twice too, y and its residuals bit-equal
  6. training the flagship (deit_small, B=32, f32) through the port's trainer:
              3 steps on the card against 3 on the CPU's plain path from the same
              weights and batches; the CLI on a synthetic corpus held on the card
              (loss falls over 40 steps, launch counts from the counters); an
              eval-mode gradient (the recompute backward); samples/s over 50 steps
  7. point kernels  FPS, kNN and the gather forward and backward against their
              plain versions at the partseg shapes; FPS and kNN also at the S3DIS
              and Hengshuang paths' shapes (FPS at B=1 and up to N=16384 too,
              with start 0 and random starts; kNN bit-equal to its exact-order
              plain version and over two runs, within near-ties of the matmul
              form, with duplicated points, ragged N=4 and 16, k=32), timed
              with device times at each path's largest; the gathers also at the
              Hengshuang level 0 k/v shape, the S3DIS N=4096 shape, C=35 bf16 and
              one point named by every row, the backward bit-equal to the CPU
              plain version and over two runs; times of kernel, plain version and
              a library call where one exists (the gathers at C=48, C=3 and the
              Hengshuang shape, with device times by kernel)
  8. partseg  the 3DViT part-segmentation model (deit_tiny, N=1024, 50 parts,
              B=16, f32, SGD): 3 steps on the card against the CPU's plain path;
              the partseg CLI on a synthetic corpus (loss falls, launch counts of
              every kernel of the path from the counters); ms per step, samples/s
              and a per-kernel profile
  9. mhsa     the attention forward and backward against their plain versions
              (every head_dim in f32 and in bf16, the S3DIS shape in both, B=1,
              N=1, 256 and 2048, N one either side of the kernels' 32- and 64-row
              tiles), the backward twice bit-equal; at the S3DIS shape in f32 and
              bf16 the times of kernel, plain version and scaled_dot_product_attention
              under each backend that takes the call (the fastest, named, is the
              yardstick), and the kernels' TFLOP/s
 10. S3DIS    the 3DViT_s3dis semantic-segmentation model (deit_base, 3 heads,
              N=4096 points -> 1025 tokens, 13 classes, B=4, f32, SGD): the block
              routes; 2 steps on the card against the CPU's plain path at
              B=1 through 4 of the 12 blocks; the S3DIS
              CLI on its synthetic stream (finite losses, epoch and eval lines,
              launch counts of every kernel of the path, no fused block); a
              learnability run (labels a function of the points); ms per step,
              samples/s and a per-kernel profile
 11. vector attention  the forward and backward against their plain versions
              (the Hengshuang step's levels 0, 1 and 4 at B=64, N=255 and 256, a
              D other than 512, D=8 and D=136, duplicated neighbours), the
              forward and the backward twice bit-equal; times of kernel and plain
              version at level 0; the level-0 forward's device time by GEMM (pos,
              hg, logits) and the backward's by GEMM kind (row GEMMs,
              weight-gradient GEMMs) with TFLOP/s, every GEMM on the tensor-core
              core in 3-pass TF32
 12. Hengshuang  the Point Transformer cls model (D=512, 4 blocks, 16
              neighbours, N=1024 with normals, 40 classes, f32, SGD): 2 steps on
              the card against the CPU's plain path at B=4; the train_cls CLI on
              its synthetic stream at B=64 (epoch and eval lines, a checkpoint, the
              resume, launch counts of every kernel of the path); a learnability
              run; ms per step, samples/s and a per-kernel profile
 13. vector attention bf16  the in-kernel-gather forward, the recompute
              backward and the residual-saving pair against their plain versions
              (level 0 and level 4 of the bf16 step, N=1000, K=1, K=128 with
              duplicated neighbours, D=200, D=8 and D=136), each forward and each
              backward twice bit-equal, the residual backward against the
              recompute backward; times of kernel and plain version at level 0;
              each call's device time by GEMM (the forwards' pos, hg, logits; the
              backwards' by kind) with TFLOP/s, every GEMM on the tensor-core
              core in bf16
 14. Hengshuang bf16  the same model at dtype=bf16 (parameters f32): 2 steps on
              the card against the CPU's plain path at B=4; the train_cls CLI at
              dtype=bf16 (its lines, a checkpoint, the resume, launch counts: the
              residual-saving pair in training, the forward in eval); a
              learnability run; two steps under S3F_VA_RESID=0 (the recompute
              pair); ms per step, samples/s and a per-kernel profile
 15. attention route  a ViT block at 2049 tokens on the card: the plain
              attention outside the mhsa kernels' gate, counted, against the CPU
 16. ScanObjectNN  the ScanObjectNN CLI (3DViT, 1024 points of xyz, 15
              classes, B=64) on its synthetic streams: epoch lines, a checkpoint,
              launch counts of every kernel of the path
 17. Hengshuang segmentation  PointTransformerSeg (D=512, 4 blocks, 16
              neighbours) through the partseg CLI (B=16, N=1024) and the S3DIS
              CLI (B=4, N=4096), each in f32 and at dtype=bf16: 3 and 2 steps on
              the card against the CPU's plain path (B=2 and B=1), the CLI with the
              launch counts of each vector-attention kernel, kNN, FPS and the
              gathers, ms a step and a profile by kernel and by kind
 18. 3DViT bf16  the fused block kernels on an f32 residual stream with bf16
              matmuls against their plain versions; partseg (fused bf16 blocks)
              and S3DIS (the mhsa kernels on bf16 q, k, v, no plain attention) at
              dtype=bf16: 3 and 2 steps card vs CPU, the CLI with its launch counts, ms
              a step and a profile (S3DIS's card-vs-CPU steps through 4 of the
              12 blocks); the bf16 mhsa pair's device time a call
              beside scaled_dot_product_attention's at the S3DIS shape
 19. flagship bf16  the voxel CLI at --dtype bf16 with Adam's second moment
              in bf16: the loss falls over 40 steps, launch counts; ms a step
              beside the f32 step
 20. LwF      the fused block forward and training pair at the LwF shapes (N=197
              with D=384 / 6 heads, D=768 / 12 and 3 heads; N=65 with D=768 / 3
              heads) against their plain versions, the training forward and
              the backward twice bit-equal, times at N=197 beside
              TransformerEncoderLayer and the device time by kernel, the
              attention's beside its bound and SDPA's; the device crop against
              the CPU's from the same boxes; train_partseg_lwf at full width (deit_small
              3DViT_1_layer, B=32, N=1024, M=64 synthetic images): 2 steps card
              vs CPU, the CLI (the loss falls over 40 steps, a DeiT file loaded,
              launch counts a step from the model), ms a step and a profile;
              train_cls_voxel --lwf --pretrained at the flagship width (a DeiT
              file the phase writes loaded, the 2D leaves unchanged, launch
              counts, ms a step); the LwF student at dtype=bf16: its block calls
              (bf16 images, f32 points, bf16 matmuls) against their plain
              versions, 2 steps card vs CPU, the CLI (the loss falls, launch
              counts); model=3DViT_lwf (deit_base with 3 heads, 65 point tokens,
              a deit_base teacher) through the CLI in f32 and bf16 (launch
              counts); ms a step, samples/s, busy share and peak memory of the
              four partseg LwF steps
 21. group_embed  BASELINE.json's second config (ShapeNetV2 at 128^3, deit_base
              with 3 heads, VoxelEmbed_no_average cell 9 / patch 14, B=16): the
              block kernels at stage 1's [3136, 15, 768] (3 and 12 heads, f32
              and bf16 matmuls on the f32 stream) against their plain versions,
              each twice bit-equal, rows 1, 3, 4 timed beside
              TransformerEncoderLayer and the attention beside its bound and
              SDPA's; the CLI in f32 and bf16 (epoch lines, launch counts, no
              plain attention); ms a step, samples/s, a profile, the device
              time by part (tokenizer, group encoder, stage 1 by kind, stage
              2, Adam) and the peak memory; 2 steps card vs CPU at B=2 in each
              dtype, the group dropout off; a loss-falls run through the CLI
              on binvox grids with half the pillars empty; weight_sharing
              (ModelNet40, deit_small, bf16) and VoxelEmbed_Hybrid (128^3,
              deit_small) through the CLI for an epoch with launch counts
 22. ViP-3D and the visualizers  vip3d_s7 (VoxelEmbed_m40_vip_s7: ModelNet40's
              30^3 grids padded to 32^3, 40 classes, B=32, Adam, drop path 0.1)
              in f32 and bf16: 2 steps card vs CPU with drop path off,
              train_pure_mlp on a synthetic corpus on the card (the loss falls
              over 40 steps, the Adam kernel once a step), ms a step and
              samples/s over 50 steps, the busy share, the device time by kind,
              the launches a step and the peak memory; PEG, the 128^3
              ShapeNetV2 family and vip3d_m7 through the CLI for an epoch each;
              attention capture on the flagship card vs CPU (maps and rollout
              masks, no block or mhsa launch during it, the fused block after
              it); visualize_point_cloud's prediction at the partseg default
              card vs CPU with its launch counts
 23. export   Predictor.export of the flagship predictor (batch 32), a
              group_embed model and vip3d_s7 on the card, each program's
              s3f::vit_block_fwd nodes counted; load_exported in a fresh
              process that imports no model code: logits against the eager
              Predictor's, the block launches a call counted inside the op, the
              flagship's exported p50/p95 beside the Predictor's; a point
              model's export refused, naming the row-gather kernel
 24. data parallel  (a) train_cls_voxel plain, --zero1 and --zero1 --lwf, and
              train_partseg (3DViT), each at world size 1 through the env://
              rendezvous over NCCL: the devices line, epoch lines, a
              checkpoint, launch counts; (b) two ranks on the one card over
              gloo (this script with --dp-worker, twice) running the port's
              data-parallel steps at B=16 each, against world 1 at B=32 in
              this process: the flagship at full width 3 steps of SGD, Adam
              and ZeRO-1 Adam (the kernel on the rank's part: its launches
              printed, its parameters bit-equal to replicated Adam's), the
              partseg 3DViT 3 SGD steps with BatchNorm over the global batch
              and FPS start points drawn for it; the ranks bit-equal, each run
              within its tolerances of world 1 (times are gloo over host
              copies); (c) where the machine shows several cards,
              train_cls_voxel --zero1 with one NCCL rank a card
 25. model parallel  the TP halves of the block kernels against their plain
              versions; TP, PP and SP on gloo ranks of the one card against
              world 1; (d) TP and PP over NCCL where several cards show
 26. legacy voxel model and point modules  FeatureVoxel2DViT (32^3, deit_base
              with 12 heads, 10 classes) behind Predictor and ModelServer,
              logits against the CPU's plain path; 3 Adam steps card vs CPU
              (losses, parameters, BatchNorm running statistics); ms a step at
              B=32 with the device time by part; the two-layer head, bf16 and
              128^3 routes; PointNet++ MSG (ball and kNN, k up to 128), RelPos
              and PointEmbed forward and backward card vs CPU, launch counts
 27. data tools -> flagship  procedural OFF and OBJ meshes (box, octahedron,
              pyramid, cylinder as four ModelNet40 classes, 64 train and 16
              test each) -> binvox at 30^3 by tools.voxelize -> the native
              ingest (bit-equal to the numpy codec, the mixed-dims IOError,
              files/s at 128^3) -> train_cls_voxel at the flagship's width for
              5 epochs (the loss falls, launch counts) -> the viewer's render
Each phase ends with a line "phase <name>: <seconds> s". Then a JSON line of
the kernels, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before that
line. Without a card, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import collections
import contextlib
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
    ("partseg N=257", 16, 257, 192, 3, "float32"),
    ("partseg N=257 bf16", 16, 257, 192, 3, "bfloat16"),
    # the attention kernels' other tiles and edges: head_dim 128 (D=384 with 3
    # heads), N=512 at head_dim 256 (the largest shared-memory tile), N=1, and
    # N=197 at bf16
    ("dh=128", 8, 197, 384, 3, "float32"),
    ("dh=128 bf16", 8, 197, 384, 3, "bfloat16"),
    ("N=512 dh=256", 2, 512, 768, 3, "float32"),
    ("N=1", 4, 1, 384, 6, "float32"),
    ("N=197 bf16", 4, 197, 768, 12, "bfloat16"),
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
    from simple3dformer_tpu_torch.core import host_build
    from simple3dformer_tpu_torch.data import native_ingest
    from simple3dformer_tpu_torch.kernels.build import CSRC, build
    from simple3dformer_tpu_torch.tools import view_voxels, voxelize

    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    hosts = [("ingest", native_ingest.SOURCE, host_build.INGEST_FLAGS),
             ("voxelizer", voxelize.SOURCE, host_build.VOXELIZER_FLAGS),
             ("viewer", view_voxels.SOURCE, host_build.VIEWER_FLAGS)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names) + len(hosts)) as pool:
        host_results = [pool.submit(host_build.build, src, flags) for _, src, flags in hosts]
        results = dict(zip(names, pool.map(build, names)))
        host_results = [r.result() for r in host_results]
    wall = time.perf_counter() - t0
    for (name, _, flags), (path, seconds, _) in zip(hosts, host_results):
        print(f"build host {name}: {seconds:.1f} s g++ {' '.join(flags)}, {path.name}")
    for name, (path, seconds, log) in results.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
        print(f"build {name}: {seconds:.1f} s nvcc, {len(regs)} kernels, "
              f"max {max(regs, default=0)} registers, {spills} bytes spill stores, {path.name}")
        for kernel, nregs, nspill in ptxas_entries(log):
            if "tc_gemm_kernel" in kernel:
                label = tc_label(kernel) if is_va_gemm(kernel) else blk_label(kernel)
                print(f"build {name}: tc_gemm_kernel {label}: {nregs} registers, "
                      f"{nspill} bytes spill stores")
            elif name in ("fps", "knn") or any(k in kernel for k in ATTENTION_GROUPS):
                print(f"build {name}: {template_label(kernel)}: {nregs} registers, "
                      f"{nspill} bytes spill stores")
    print(f"build: {len(names)} CUDA and {len(hosts)} host sources in {wall:.1f} s")


def ptxas_entries(log: str) -> list[tuple[str, int, int]]:
    """(mangled name, registers, bytes of spill stores) of each kernel that
    ``ptxas -v`` reports in a build log."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((chunk.split("'")[0], int(regs.group(1)) if regs else 0,
                    int(spill.group(1)) if spill else 0))
    return out


def template_label(kernel: str) -> str:
    """A kernel's name with its integer and bool template arguments, from a
    mangled name: fps_kernel<512, 2>, attention_kernel<64, 0>."""
    m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)(I(?:L[ib]-?\d+E)+E)?", kernel)
    if not m:
        return kernel
    args = re.findall(r"L[ib](-?\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


# a vector-attention GEMM by its epilogue: the forwards' pos, hg and logits
# GEMMs; the backwards' row GEMMs and weight-gradient GEMMs
GEMM_KIND = {"VaEpiPartial": "weight-gradient GEMMs", "VaEpiHdMask": "row GEMMs",
             "VaEpiMask": "row GEMMs", "VaEpiGx": "row GEMMs", "VagEpiPos": "pos",
             "VaEpiPos": "pos", "VaEpiBias": "hg", "VaEpiSoftmax": "logits"}
GEMM_KINDS = {"forward": ("pos", "hg", "logits"),
              "backward": ("row GEMMs", "weight-gradient GEMMs")}
# TcRows<..., KMAJOR, RELU = true, SUM = false>, demangled and mangled
RELU_OPERAND = ("false, true, false>", "true, true, false>", "Lb0ELb1ELb0E", "Lb1ELb1ELb0E")


def is_va_gemm(kernel: str) -> bool:
    """Whether a kernel name is a vector-attention GEMM on the tensor-core core."""
    return "tc_gemm_kernel" in kernel and "VaAcc" in kernel


# a ViT block GEMM instantiation by its epilogue (and, for the weight
# gradients, the transform of the right factor), mangled or demangled; the
# first match names it
BLK_GEMMS = (("OutBiasGelu", "fc1"), ("OutBiasRes", "proj/fc2"), ("OutBias", "qkv"),
             ("OutGeluGrad", "g_a1"), ("OutStore", "g_z2/g_o/g_z1"))


def blk_label(kernel: str) -> str:
    """A ViT block GEMM instantiation by route and the GEMMs it runs."""
    route = "bf16" if "Bf16Mma" in kernel else "tf32x3"
    if "BlkEpiWgrad" in kernel:
        what = ("dW2" if "GeluXf" in kernel else "dW1/dWqkv"
                if "LnXf<true>" in kernel or "LnXfILb1E" in kernel else "dWproj")
    else:
        what = next(v for k, v in BLK_GEMMS if k in kernel)
        if what == "proj/fc2" and "bfloat16" in kernel.split("OutBiasRes")[1][:40]:
            what = "fc2 (bf16 y)"
    return f"{route} {what}"


def tc_label(kernel: str) -> str:
    """A tensor-core GEMM instantiation by route, epilogue and an operand formed
    on the way (hd from rel, or relu(hg_pre)); from a mangled or a demangled
    name."""
    route = "bf16" if "Bf16Mma" in kernel else "tf32x3"
    epi = next(e for e in GEMM_KIND if e in kernel)
    relu = any(p in kernel for p in RELU_OPERAND)
    return f"{route} {epi}" + (" hd" if "TcHd" in kernel else " relu" if relu else "")


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
            report["library_ms"] = library_times(torch, x, w, heads)["fwd"]
            print(f"kernel fused_vit_block flagship time: {report['ms']:.4f} ms kernel "
                  f"({kernel[0]:.4f}, {kernel[1]:.4f}), {report['plain_ms']:.4f} ms plain "
                  f"({plain[0]:.4f}, {plain[1]:.4f}), {report['library_ms']:.4f} ms "
                  "torch.nn.TransformerEncoderLayer (no_grad), mean of 50 launches each")
    torch.cuda.synchronize()
    return report


def library_layer(torch, w, d, heads):
    """torch.nn.TransformerEncoderLayer computing the block's function (pre-norm,
    biases on qkv, proj, fc1 and fc2, LayerNorm eps 1e-6, tanh GELU, no dropout)
    with the block's weights copied in: the yardstick of rows 1-4, timed here and
    called nowhere in the port."""
    layer = torch.nn.TransformerEncoderLayer(
        d, heads, dim_feedforward=4 * d, dropout=0.0,
        activation=lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
        layer_norm_eps=1e-6, batch_first=True, norm_first=True, device="cuda")
    names = {"norm1.weight": "ln1_s", "norm1.bias": "ln1_b", "self_attn.in_proj_weight": "wqkv",
             "self_attn.in_proj_bias": "bqkv", "self_attn.out_proj.weight": "wproj",
             "self_attn.out_proj.bias": "bproj", "norm2.weight": "ln2_s", "norm2.bias": "ln2_b",
             "linear1.weight": "w1", "linear1.bias": "b1", "linear2.weight": "w2",
             "linear2.bias": "b2"}
    layer.load_state_dict({k: w[v] for k, v in names.items()})
    return layer


def library_times(torch, x, w, heads, g=None, iters=50):
    """ms of the library layer on the block's inputs (an f32 x): its forward under
    no_grad ("fwd"); with ``g`` also its forward recording for autograd
    ("train_fwd"), its backward alone ("bwd", the way sdpa_times takes SDPA's)
    and forward and backward together ("fwd_bwd"). Checks once that its output
    is the plain version's within 1e-4, so that it is the same function."""
    from simple3dformer_tpu_torch.kernels.vit_block import vit_block_reference

    layer = library_layer(torch, w, x.shape[-1], heads)
    with torch.no_grad():
        err = float((layer(x) - vit_block_reference(x, w, heads)).abs().max())
        if err > 1e-4:
            raise AssertionError(f"TransformerEncoderLayer differs from the plain block: {err}")
        out = {"fwd": time_ms(torch, lambda: layer(x), iters)}
    if g is not None:
        xr = x.detach().requires_grad_()
        leaves = [xr, *layer.parameters()]
        out["train_fwd"] = time_ms(torch, lambda: layer(xr), iters)
        y = layer(xr)
        out["bwd"] = time_ms(torch, lambda: torch.autograd.grad(y, leaves, g, retain_graph=True),
                             iters)
        out["fwd_bwd"] = time_ms(torch, lambda: torch.autograd.grad(layer(xr), leaves, g), iters)
    print(f"library torch.nn.TransformerEncoderLayer B={x.shape[0]} N={x.shape[1]} "
          f"D={x.shape[2]} H={heads}: output vs the plain block max abs err {err:.3e} "
          "(tolerance 1e-4); ms " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


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
                            "B=1", "B=33", "partseg N=257", "partseg N=257 bf16", "dh=128",
                            "dh=128 bf16", "N=512 dh=256", "N=1", "N=197 bf16")]
# gradients: an error relative to the largest reference value. f32: sums of
# up to B*N products in another order; bf16: as TOL, a last-bit difference can
# round an intermediate to the neighbouring bf16 value.
GRAD_REL = {"float32": 1e-4, "bfloat16": 3e-2}
# H100 SXM: HBM bytes/s; f32 products at the 3-pass TF32 tensor-core rate (495 / 3
# TFLOP/s), which a kernel of f32 products can reach (csrc/mhsa.cu does); f32
# non-tensor FLOP/s for the elementwise work of FPS and kNN
PEAK_BYTES, PEAK_F32, PEAK_FMA = 3.35e12, 495e12 / 3, 67e12
PEAK_BF16 = 989e12  # H100 SXM: bf16 dense tensor-core FLOP/s
# base lr of the CLI run (chosen on the CPU: 3.69 -> 0.76 over 40 steps); the
# warmup scales it by (epoch + 1) / 2000, so 1e-5 to 2e-4 over the 20 epochs
TRAIN_LR = 0.02
TRAIN_SAMPLES, TRAIN_EPOCHS = 64, 20  # 2 steps per epoch at B=32: 40 steps


def bound(nbytes: float, flops: float, peak: float = PEAK_F32) -> tuple[float, str]:
    """The least time in ms for the work (operations at ``peak`` FLOP/s), and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
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


def in_turns(torch, kernel, plain, iters=50):
    """Mean ms of kernel and plain, timed plain, kernel, kernel, plain (``iters`` calls each)."""
    p = [time_ms(torch, plain, iters)]
    k = [time_ms(torch, kernel, iters) for _ in range(2)]
    p.append(time_ms(torch, plain, iters))
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
        y2, res2 = vb.fused_vit_block_train_fwd(x, w, heads)
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
        same = all(torch.equal(a, c) for a, c in [(y, y2), (gx, gx2), (cx, cx2)]
                   + [(res[k], res2[k]) for k in res]
                   + [(gw[k], gw2[k]) for k in gw] + [(cw[k], cw2[k]) for k in cw])
        print(f"kernel training block {label} B={b} N={n} D={d} H={heads} {dtype}: error "
              f"relative to the largest value: forward+residuals {errs['fwd']:.3e}, residual "
              f"backward {errs['bwd_res']:.3e}, recompute backward {errs['bwd']:.3e} "
              f"(tolerance {GRAD_REL[dtype]}); two runs of the training forward (y and every "
              f"residual) and of each backward bit-equal {same}")
        if max(errs.values()) > GRAD_REL[dtype] or not same:
            raise AssertionError(f"training block kernels {label}: errors {errs}, "
                                 f"bit-equal {same}")
        if label in ("flagship f32", "partseg N=257"):
            block_split(torch, lambda: vb.fused_vit_block_train_fwd(x, w, heads), b, n, d,
                        f"kernel fused_vit_block_train_fwd {label}", FWD_GEMMS)
            block_split(torch, lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res),
                        b, n, d, f"kernel fused_vit_block_train_bwd {label}", BWD_GEMMS)
            attention_report(torch, label, b, n, d, heads,
                             lambda: vb.fused_vit_block_train_fwd(x, w, heads),
                             lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res),
                             res["qkv"], g)
        if label != "flagship f32":
            continue
        lib = library_times(torch, x, w, heads, g)
        flops = block_flops(b, n, d, heads)
        ws = [w[k] for k in vb.WNAMES]
        cases = {
            "fused_vit_block_train_fwd": (
                lambda: vb.fused_vit_block_train_fwd(x, w, heads),
                lambda: vb.vit_block_train_reference(x, w, heads),
                nbytes(x, *ws, y, res), flops, abs_errs["fwd"], lib["train_fwd"]),
            "fused_vit_block_train_bwd": (
                lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res),
                lambda: vb.vit_block_backward_reference(x, g, w, heads, residuals=res),
                nbytes(x, g, *ws, res, gx, gw), 2 * flops, abs_errs["bwd_res"], lib["bwd"]),
            "fused_vit_block_bwd": (
                lambda: vb.fused_vit_block_bwd(x, g, w, heads),
                lambda: vb.vit_block_backward_reference(x, g, w, heads),
                nbytes(x, g, *ws, cx, cw), 3 * flops, abs_errs["bwd"], lib["fwd_bwd"]),
        }
        for name, (kernel, plain, moved, ops, err, library_ms) in cases.items():
            ms, plain_ms = in_turns(torch, kernel, plain)
            bound_ms, bound_by = bound(moved, ops)
            report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=library_ms)
            print(f"kernel {name} flagship: max abs err {err:.3e}; {ms:.4f} ms kernel, "
                  f"{plain_ms:.4f} ms plain, {library_ms:.4f} ms TransformerEncoderLayer, "
                  f"bound {bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.2f} MB, "
                  f"{ops / 1e9:.3f} GFLOP), mean of 50 launches each, in turns")
    report["fused_adam"] = adam_check(torch)
    torch.cuda.synchronize()
    return report


# the block's GEMMs in launch order: the forward's, the backward's
FWD_GEMMS = ("qkv", "proj", "fc1", "fc2")
BWD_GEMMS = ("g_a1", "dW2", "g_z2", "dW1", "g_o", "dWproj", "g_z1", "dWqkv")


def block_split(torch, fn, b, n, d, label, names, calls=5):
    """Device time of one block call by kernel (torch.profiler, one call a
    profile, ``calls`` profiles): each GEMM of ``names``, in launch order, with
    its grid (output tiles x contraction chunks, as the kernels launch it) and
    TFLOP/s, then the other kernels by group. A profile that missed a GEMM's
    launch is dropped. Fails where a GEMM ran on anything but the tensor-core
    core. Informational when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    from simple3dformer_tpu_torch.kernels import vit_block as vb

    fn()
    torch.cuda.synchronize()
    grids, shapes = vb.gemm_grids(b, n, d), vb.gemm_shapes(b, n, d)
    gemm_us = {k: 0.0 for k in names}
    rest: dict[str, float] = {}
    kept = 0
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if str(getattr(e, "device_type", "")).split(".")[-1] == "CUDA"),
                         key=lambda e: e.time_range.start)
        strays = [e.name[:60] for e in kernels if "gemm" in e.name.lower()
                  and not ("tc_gemm_kernel" in e.name and "BlkEpi" in e.name)]
        if strays:
            raise AssertionError(f"{label}: GEMMs off the tensor-core core: {strays}")
        gemms = [e for e in kernels if "tc_gemm_kernel" in e.name]
        if len(gemms) != len(names):
            continue
        kept += 1
        for k, e in zip(names, gemms):
            gemm_us[k] += e.time_range.elapsed_us()
        for e in kernels:
            if "tc_gemm_kernel" not in e.name:
                group = next((g for g in KERNEL_GROUPS if g in e.name), e.name[:40])
                rest[group] = rest.get(group, 0.0) + e.time_range.elapsed_us()
    if not kept:
        print(f"{label}: the profiler recorded no call with all {len(names)} GEMMs")
        return
    parts = []
    for k in names:
        ms = gemm_us[k] / kept / 1e3
        rows, cols, kk = shapes[k]
        tiles, chunks = grids[k]
        parts.append(f"{k} {ms:.4f} (grid {tiles}x{chunks}, "
                     f"{2 * rows * cols * kk / ms / 1e9:.1f} TFLOP/s)")
    gemm_ms = sum(gemm_us.values()) / kept / 1e3
    rest_ms = {g: v / kept / 1e3 for g, v in rest.items()}
    total = gemm_ms + sum(rest_ms.values())
    print(f"{label} device ms per call by kernel ({kept} of {calls} profiled calls): total "
          f"{total:.4f}, GEMMs {gemm_ms:.4f} ({gemm_ms / total:.0%}): " + ", ".join(parts)
          + "; the rest: " + ", ".join(f"{g} {v:.4f}" for g, v in
                                       sorted(rest_ms.items(), key=lambda kv: -kv[1])))


def attention_bounds(b, n, d, heads, peak=PEAK_F32) -> dict:
    """The block attention's bound, forward and backward: the forward reads qkv
    and writes o and the f32 probabilities; the backward reads qkv, the
    probabilities and g_o and writes g_qkv; q k^T and p v, then g_o v^T, p^T g_o,
    g_s k and g_s^T q, at ``peak``. -> {"fwd": (ms, by, MB, GFLOP), "bwd": ...}"""
    qkv, o, p = 12 * b * n * d, 4 * b * n * d, 4 * b * heads * n * n
    flops = 4 * b * heads * n * n * (d // heads)
    out = {}
    for k, moved, ops in (("fwd", qkv + o + p, flops), ("bwd", 2 * qkv + p + o, 2 * flops)):
        out[k] = (*bound(moved, ops, peak), moved / 1e6, ops / 1e9)
    return out


def attention_device_ms(torch, fwd, bwd, iters=10) -> dict:
    """Device ms a call of the block's attention kernels (torch.profiler over
    ``iters`` calls of the training forward ``fwd`` and backward ``bwd``):
    {"fwd": attention_kernel, "rows": attn_bwd_rows_kernel, "cols":
    attn_bwd_cols_kernel, "bwd": rows + cols}; empty where the profiler
    records no device time."""
    f, b = device_split(torch, fwd, iters), device_split(torch, bwd, iters)
    names = dict(zip(("fwd", "rows", "cols"), zip((f, b, b), ATTENTION_GROUPS)))
    if any(name not in split for split, name in names.values()):
        return {}
    out = {k: split[name][0] for k, (split, name) in names.items()}
    out["bwd"] = out["rows"] + out["cols"]
    return out


def call_device_ms(torch, fn, iters=10) -> float:
    """Device ms of every kernel of one call of ``fn``: device_split's launches
    recorded over ``iters`` calls, by the call."""
    return sum(ms * n for ms, n in device_split(torch, fn, iters).values()) / iters


def sdpa_block_ms(torch, qkv, g_o, b, n, d, heads) -> dict:
    """Device ms (device_or_event_ms) of scaled_dot_product_attention's forward
    and of its backward alone on the block's q, k, v (from its qkv residual,
    f32, TF32 off), with ``g_o`` [B, N, D] (any values: the time does not
    depend on them) as the output's gradient, under each backend that takes
    the call: {backend: (fwd, bwd, how each was timed)}. The library yardstick
    of the block's attention; the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dh = d // heads
    q, k, v = (t.contiguous().requires_grad_() for t in
               qkv.detach().reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4))
    go = g_o.float().reshape(b, n, heads, dh).transpose(1, 2).contiguous()
    out = {}
    for name in ("EFFICIENT_ATTENTION", "FLASH_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        with sdpa_kernel(getattr(SDPBackend, name)):
            def fwd():
                return F.scaled_dot_product_attention(q, k, v, scale=dh ** -0.5)
            try:
                y = fwd()
                torch.autograd.grad(y, (q, k, v), go, retain_graph=True)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            (f, how_f), (bw, how_b) = (device_or_event_ms(torch, fn) for fn in (fwd, lambda: (
                torch.autograd.grad(y, (q, k, v), go, retain_graph=True))))
            out[name] = (f, bw, how_f if how_f == how_b else f"{how_f} / {how_b}")
    return out


def device_or_event_ms(torch, fn) -> tuple[float, str]:
    """(ms, how): call_device_ms of ``fn``, or, where the profiler records no
    device time for it, its time by CUDA events over 20 calls."""
    ms = call_device_ms(torch, fn)
    return (ms, "device") if ms else (time_ms(torch, fn, 20), "CUDA events")


def attention_report(torch, label, b, n, d, heads, fwd, bwd, qkv, g_o) -> None:
    """The block attention's device time a call, forward and backward, beside
    its bound and SDPA's at the same q, k, v (f32), timed in turns: the
    kernels, SDPA, the kernels. Informational when the profiler records
    nothing."""
    first = attention_device_ms(torch, fwd, bwd)
    sdpa = sdpa_block_ms(torch, qkv, g_o, b, n, d, heads)
    second = attention_device_ms(torch, fwd, bwd)
    if not first or not second:
        print(f"kernel block attention {label}: the profiler recorded no device time")
        return
    ms = {k: (first[k] + second[k]) / 2 for k in first}
    bounds = attention_bounds(b, n, d, heads)
    parts = []
    for k, what in (("fwd", "forward"), ("bwd", "backward")):
        bms, by, mb, gf = bounds[k]
        parts.append(f"{what} {ms[k]:.4f} ms ({first[k]:.4f}, {second[k]:.4f}), bound {bms:.4f} "
                     f"({by}: {mb:.1f} MB, {gf:.3f} GFLOP; {ms[k] / bms:.1f}x)")
    lib = ", ".join(f"{name} {f:.4f} / {bw:.4f} ({how})"
                    for name, (f, bw, how) in sdpa.items()) or "none"
    print(f"kernel block attention {label} B={b} N={n} D={d} H={heads}: device ms a call, "
          + "; ".join(parts) + f" (rows {ms['rows']:.4f}, cols {ms['cols']:.4f}); "
          f"scaled_dot_product_attention f32 forward / backward ms: {lib}")


def flagship_model(torch, device="cpu", dtype=None):
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
    from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed

    g = generator(DEFAULT_SEED)
    emb = VoxelEmbed(voxel_size=VOXEL, cell_size=CELL, patch_size=PATCH, embed_dim=384,
                     generator=g, dtype=dtype)
    return VoxelViT(emb, n_classes=N_CLASSES, transformer_backbone=BACKBONE,
                    generator=g, dtype=dtype).to(device)


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


# the first group named in a kernel's name takes its time: the tensor-core
# GEMMs by epilogue (an f32 and a bf16 instantiation of one epilogue share its
# group; a step runs one of them): the vector attention's, then the ViT
# block's weight gradients (BlkEpiWgrad) and row GEMMs (BlkEpi)
KERNEL_GROUPS = ("VaEpiPos", "VagEpiPos", "VaEpiBias", "VaEpiSoftmax", "VaEpiMask", "VaEpiGx",
                 "VaEpiHdMask", "VaEpiPartial", "va_softmax_bwd_kernel", "va_sum_chunks_kernel",
                 "va_rel_wgrad_kernel", "va_rel_wgrad_sum_kernel", "va_rel_grad_kernel",
                 "vag_inverse_kernel", "vag_scatter_kernel", "BlkEpiWgrad", "BlkEpi",
                 "attention_kernel", "attn_bwd_rows_kernel",
                 "attn_bwd_cols_kernel", "colsum_kernel", "ln_bwd_kernel", "row_stats_kernel",
                 "adam_kernel", "fps_kernel", "knn_kernel", "gather_fwd_kernel",
                 "gather_bwd_sort_kernel", "gather_bwd_sum_kernel", "mhsa_fwd_kernel", "mhsa_go_kernel", "mhsa_delta_kernel",
                 "mhsa_dkdv_kernel", "mhsa_dq_kernel")


# the ViT block's attention kernels, forward and backward
ATTENTION_GROUPS = ("attention_kernel", "attn_bwd_rows_kernel", "attn_bwd_cols_kernel")


# KERNEL_GROUPS by kind: the first kind whose prefixes a group starts with
KERNEL_CATEGORIES = (
    ("vector-attention GEMMs", ("VaEpi", "VagEpi")),
    ("vector attention, other", ("va_", "vag_")),
    ("ViT block", ("Blk", "attention_kernel", "attn_bwd", "colsum", "ln_bwd", "row_stats")),
    ("mhsa", ("mhsa_",)),
    ("point kernels (FPS, kNN, gathers)", ("fps_", "knn_", "gather_")),
    ("Adam", ("adam_",)))


def profile_steps(torch, run, idx, ms_step, label="training", lr=1e-4, groups=KERNEL_GROUPS,
                  categories=KERNEL_CATEGORIES):
    """Where a train step's device time goes: torch.profiler over len(idx) steps,
    each kernel in the first of ``groups`` its name holds, each group in the
    first of ``categories`` whose prefixes it starts with; the launches a step;
    the busy share is against ``ms_step``, the step time without the profiler.
    Informational: a profiler that records no device time is reported, not fatal."""
    from torch.profiler import ProfilerActivity, profile

    steps = idx.shape[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(run(idx, lr)["loss"][-1])
        wall = time.perf_counter() - t0
    times: dict[str, float] = {}
    others: dict[str, float] = {}
    launches = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        launches += e.count
        name = next((g for g in groups if g in e.key), "other (PyTorch's own kernels, copies)")
        times[name] = times.get(name, 0.0) + us
        if name not in groups:
            others[e.key[:60]] = others.get(e.key[:60], 0.0) + us
    total = sum(times.values())
    if not total:
        print(f"{label} profile: the profiler recorded no device time")
        return
    parts = ", ".join(f"{k} {v / steps / 1e3:.3f}" for k, v in
                      sorted(times.items(), key=lambda kv: -kv[1]))
    device_ms = total / steps / 1e3
    print(f"{label} profile over {steps} steps: device {device_ms:.3f} ms per step, "
          f"{device_ms / ms_step:.1%} of the {ms_step:.3f} ms step without the profiler "
          f"({wall / steps * 1e3:.3f} ms with it); {launches / steps:.0f} launches a step; "
          f"ms per step by kernel: {parts}")
    cats: dict[str, float] = {}
    for name, us in times.items():
        cat = next((c for c, members in categories if name.startswith(members)),
                   "PyTorch's own kernels")
        cats[cat] = cats.get(cat, 0.0) + us
    print(f"{label} profile by kind, ms per step (share of the device time): " + ", ".join(
        f"{k} {v / steps / 1e3:.3f} ({v / total:.1%})" for k, v in
        sorted(cats.items(), key=lambda kv: -kv[1])))
    att = sum(times.get(k, 0.0) for k in ATTENTION_GROUPS)
    if att:
        print(f"{label} profile: the ViT block's attention kernels {att / steps / 1e3:.3f} ms per "
              f"step ({att / total:.1%} of the device time)")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} profile, PyTorch's own kernels, ms per step: "
          + "; ".join(f"{k} {v / steps / 1e3:.3f}" for k, v in top))
    host = sorted(((e.key[:50], e.self_cpu_time_total, e.count) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda kv: -kv[1])[:8]
    print(f"{label} profile, host: self CPU ms per step by operator (calls a step): "
          + "; ".join(f"{k} {us / steps / 1e3:.3f} ({n // steps})" for k, us, n in host))


# the point kernels at the partseg shapes (B=16, N=1024, deit_tiny, f32), and
# at the S3DIS (B=4, N=4096) and Hengshuang (B=64, N=1024 -> 4 by 4x a level) paths
PB, PN = 16, 1024
# at least one shape for each block size that fps.cu picks by N (N <= 32, 128,
# 256, 1024, 2048, 4096, 8192, 16384)
FPS_SHAPES = [("partseg TD1", PB, PN, PN // 4), ("B=1", 1, PN, PN // 4),
              ("S3DIS 4096 -> 1024", 4, 4096, 1024), ("Hengshuang 1024 -> 256", 64, 1024, 256),
              ("Hengshuang 256 -> 64", 64, 256, 64), ("Hengshuang 64 -> 16", 64, 64, 16),
              ("Hengshuang 16 -> 4", 64, 16, 4), ("N=100", 3, 100, 40), ("N=2048", 2, 2048, 512),
              ("N=8192", 1, 8192, 128), ("N=16384", 1, 16384, 64),
              ("MSG and RelPos 1024 -> 512", PB, PN, 512)]  # phase 26
FPS_TIMED = {"partseg TD1": 50, "S3DIS 4096 -> 1024": 5, "Hengshuang 1024 -> 256": 10}  # calls
# (label, B, S queries, N points, k, duplicated points)
KNN_SHAPES = [("TD0 k=16", PB, PN, PN, 16, False), ("TD1 k=16", PB, PN // 4, PN, 16, False),
              ("TU0 3-NN", PB, PN, PN // 4, 3, False), ("TU1 3-NN", PB, PN, PN, 3, False),
              ("ties k=16", 4, 512, PN, 16, True),
              ("Hengshuang level 0 k=16", 64, 1024, 1024, 16, False),
              ("Hengshuang TD 1024 -> 256", 64, 256, 1024, 16, False),
              ("Hengshuang level 1 k=16", 64, 256, 256, 16, False),
              ("Hengshuang TD 256 -> 64", 64, 64, 256, 16, False),
              ("Hengshuang level 2 k=16", 64, 64, 64, 16, False),
              ("Hengshuang TD 64 -> 16", 64, 16, 64, 16, False),
              ("Hengshuang level 3 k=16", 64, 16, 16, 16, False),
              ("Hengshuang TD 16 -> 4", 64, 4, 16, 16, False),
              ("Hengshuang level 4 k=4", 64, 4, 4, 4, False),
              ("S3DIS TD0 k=16", 4, 4096, 4096, 16, False),
              ("S3DIS TD1 k=16", 4, 1024, 4096, 16, False),
              ("S3DIS TU0 3-NN", 4, 4096, 1024, 3, False),
              ("S3DIS TU1 3-NN", 4, 4096, 4096, 3, False),
              ("k=32 N=3000", 2, 100, 3000, 32, False),
              # past a warp's list (the sorting kernel): PointNet++ MSG's k=128
              # (phase 26), with ties, k=33, and k=1024 over two buffer rounds
              ("MSG k=128", PB, 512, PN, 128, False), ("ties k=128", 4, 512, PN, 128, True),
              ("k=33 N=40", 2, 10, 40, 33, False), ("k=1024 N=5000", 2, 8, 5000, 1024, False),
              # Hengshuang segmentation: partseg (B=16, 1024 -> 4) and S3DIS
              # (B=4, 4096 -> 16) levels, transition-downs and 3-NN transition-ups
              # that the shapes above do not cover
              ("partseg seg level 1 k=16", PB, 256, 256, 16, False),
              ("partseg seg TD 256 -> 64", PB, 64, 256, 16, False),
              ("partseg seg level 3 k=16", PB, 16, 16, 16, False),
              ("partseg seg TU 256 <- 64", PB, 256, 64, 3, False),
              ("partseg seg TU 16 <- 4", PB, 16, 4, 3, False),
              ("S3DIS seg level 1 k=16", 4, 1024, 1024, 16, False),
              ("S3DIS seg level 4 k=16", 4, 16, 16, 16, False),
              ("S3DIS seg TU 1024 <- 256", 4, 1024, 256, 3, False),
              ("S3DIS seg TU 64 <- 16", 4, 64, 16, 3, False)]
KNN_TIMED = ("TD0 k=16", "S3DIS TD0 k=16", "Hengshuang level 0 k=16", "MSG k=128")
# (label, B, N, R, C, dtype name, every row naming one point)
GATHER_SHAPES = [("xyz C=3", PB, PN, PN * 16, 3, "float32", False),
                 ("TD0 points C=48", PB, PN, PN * 16, 48, "float32", False),
                 ("TD1 points C=96", PB, PN, PN // 4 * 16, 96, "float32", False),
                 ("TU0 C=96", PB, PN // 4, PN * 3, 96, "float32", False),
                 ("TU1 C=48", PB, PN, PN * 3, 48, "float32", False),
                 ("bf16 C=96", PB, PN, PN * 16, 96, "bfloat16", False),
                 ("Hengshuang level 0 k/v C=512", 64, 1024, 1024 * 16, 512, "float32", False),
                 ("one point named by every row", 2, PN, PN * 16, 48, "float32", True),
                 ("bf16 C=35", PB, PN, PN * 16, 35, "bfloat16", False),
                 ("S3DIS TD0 N=4096 C=192", 4, 4096, 4096 * 16, 192, "float32", False),
                 # Hengshuang segmentation: the f32 level-0 k and v gathers of both
                 # CLIs, R = 262,144 rows of 512, and a transition-up's 3-NN rows
                 ("partseg seg level 0 k/v C=512", PB, PN, PN * 16, 512, "float32", False),
                 ("S3DIS seg level 0 k/v C=512", 4, 4096, 4096 * 16, 512, "float32", False),
                 ("S3DIS seg TU 4096 <- 1024 C=32", 4, 1024, 4096 * 3, 32, "float32", False),
                 ("partseg seg TU bf16 C=64", PB, 64, 256 * 3, 64, "bfloat16", False),
                 # phase 26: MSG's 128-neighbour normals, PointEmbed's 32-neighbour features
                 ("MSG K=128 normals C=3", PB, PN, 512 * 128, 3, "float32", False),
                 ("PointEmbed K=32 C=64", PB, PN, 512 * 32, 64, "float32", False)]
# "one point named by every row" has gradients that are multiples of 2**-6, so
# that its sums are exact in any order: the card's plain version adds by float
# atomics in an order that changes from run to run, which with 16384 rows on
# one point strays up to 3.7e-6 of the largest value from the exact sum (the
# kernel's ascending-r sum of random values is held to the CPU's bit for bit
# in tests/test_torch_cuda_kernels.py)
# timed: the table's row (kept so old and new compare), the xyz gathers, the
# Hengshuang f32 step's largest k and v gathers
GATHER_TIMED = ("TD0 points C=48", "xyz C=3", "Hengshuang level 0 k/v C=512")
KNN_DIST_TOL = 1e-5  # distances: the same sums, q.p in another order on the plain side
GATHER_BWD_REL = 1e-6  # f32 sums in source order on both sides (index_add_ may not be)


def unit_cloud(torch, rs, b, n):
    """[B, N, 3] on the card, centred on the unit sphere, as pc_normalize leaves a shape."""
    x = torch.from_numpy(rs.randn(b, n, 3).astype(np.float32)).cuda()
    return x / x.norm(dim=-1).amax(-1)[:, None, None]


def knn_inputs(torch, rs, b, s, n, dup):
    """(queries, points): ``dup`` takes N / 2 points twice (exact ties); the
    queries are the first S points where S <= N."""
    p = unit_cloud(torch, rs, b, n // 2).repeat(1, 2, 1) if dup else unit_cloud(torch, rs, b, n)
    return (p[:, :s].contiguous() if s <= n else unit_cloud(torch, rs, b, s)), p


def knn_check(torch, q, p, k):
    """The kNN kernel on the card against its plain versions: idx and dist bit
    for bit those of the exact-order version and of a second run; against the
    matmul form, every differing rank a near-tie and the distances within
    KNN_DIST_TOL; equal distances in index order. Returns (ok, idx, dist, facts)."""
    from simple3dformer_tpu_torch.kernels.knn import (knn, knn_reference, knn_reference_exact,
                                                      near_ties)

    idx, dist = knn(q, p, k)
    idx2, dist2 = knn(q, p, k)
    eidx, edist = knn_reference_exact(q, p, k)
    ridx, rdist = knn_reference(q, p, k)
    torch.cuda.synchronize()

    def same(a, b):  # every bit of two f32 or int32 tensors
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    n_diff, n_near = near_ties(idx, dist, ridx, rdist)
    tied = dist[..., 1:] == dist[..., :-1]
    facts = dict(exact=same(idx, eidx) and same(dist, edist),
                 rerun=same(idx, idx2) and same(dist, dist2), n_diff=n_diff, n_near=n_near,
                 derr=float((dist - rdist).abs().max()), ties=int(tied.sum()),
                 disorder=int((tied & (idx[..., 1:] < idx[..., :-1])).sum()))
    ok = (facts["exact"] and facts["rerun"] and n_diff == n_near
          and facts["derr"] <= KNN_DIST_TOL and not facts["disorder"])
    return ok, idx, dist, facts


def gather_inputs(torch, b, n, r, c, dtype, one_point, seed, device):
    """points [B, N, C], idx [B, R] int32 and g [B, R, C], standard normal, made
    on ``device`` from ``seed``. Random indices include three out of range
    (clamped); ``one_point`` names point N // 3 in every row."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pts = torch.randn(b, n, c, generator=gen, device=device).to(getattr(torch, dtype))
    if one_point:
        idx = torch.full((b, r), n // 3, dtype=torch.int32, device=device)
    else:
        idx = torch.randint(0, n, (b, r), generator=gen, device=device, dtype=torch.int32)
        idx[0, :3] = torch.tensor([-5, n, n + 7][:r], dtype=torch.int32)
    g = torch.randn(b, r, c, generator=gen, device=device)
    if one_point:  # multiples of 2**-6: every order of the sums is exact (GATHER_SHAPES)
        g = (g * 64).round() / 64
    return pts, idx, g.to(pts.dtype)


def gather_check(torch, pts, idx, g):
    """The gather kernels on the card against their plain versions: the forward
    equal to the plain one; the backward equal bit for bit to the plain version
    on CPU copies (both sum in f32 in ascending r), within GATHER_BWD_REL of
    the card's plain version (index_add_ there adds by atomics), and bit-equal
    over two runs. Returns (ok, out, gp, card plain gp, facts for the log)."""
    from simple3dformer_tpu_torch.kernels.gather import (gather_bwd, gather_bwd_reference,
                                                         gather_fwd, gather_fwd_reference)

    n = pts.shape[1]
    out, want = gather_fwd(pts, idx), gather_fwd_reference(pts, idx)
    gp, gp2 = gather_bwd(idx, g, n), gather_bwd(idx, g, n)
    gwant = gather_bwd_reference(idx, g, n)
    torch.cuda.synchronize()
    facts = dict(forward_equal=torch.equal(out, want),
                 cpu_bit_equal=torch.equal(gp.cpu(), gather_bwd_reference(idx.cpu(), g.cpu(), n)),
                 rel=float((gp - gwant).abs().max()) / float(gwant.abs().max()),
                 rerun_bit_equal=torch.equal(gp, gp2))
    ok = (facts["forward_equal"] and facts["cpu_bit_equal"] and facts["rel"] <= GATHER_BWD_REL
          and facts["rerun_bit_equal"])
    return ok, out, gp, gwant, facts


def device_split(torch, fn, iters=10):
    """Device ms per call of ``fn`` by kernel name (torch.profiler), for kernels
    that ``fn`` launches once a call: each the mean of the launches that the
    profiler recorded (it can miss some), with their count; empty when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, list] = {}  # name -> [device ms, launches recorded]
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and str(getattr(e, "device_type", "")).split(".")[-1] == "CUDA":
            name = next((g for g in KERNEL_GROUPS if g in e.key), e.key[:40])
            rec = out.setdefault(name, [0.0, 0])
            rec[0] += us / 1e3
            rec[1] += e.count
    return {name: (ms / count, count) for name, (ms, count) in out.items()}


def split_text(split: dict, iters=10) -> str:
    """device_split's result as text: each kernel's ms and launches recorded."""
    return ", ".join(f"{k} {ms:.4f} ({n} of {iters} launches recorded)"
                     for k, (ms, n) in split.items()) or "not recorded"


def timed(torch, kernel, plain, library=None, iters=50):
    """(kernel ms, plain ms, library ms or None): in turns, ``iters`` calls each."""
    ms, plain_ms = in_turns(torch, kernel, plain, iters)
    return ms, plain_ms, (time_ms(torch, library, iters) if library is not None else None)


def point_report(name, err, times, moved, ops, note, iters=50, peak=PEAK_F32):
    ms, plain_ms, library_ms = times
    bound_ms, bound_by = bound(moved, ops, peak)
    lib = f", {library_ms:.4f} ms library ({note})" if library_ms is not None else ""
    print(f"kernel {name} time: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain{lib}; bound "
          f"{bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.2f} MB, {ops / 1e9:.4f} GFLOP), "
          f"mean of {iters} calls each, in turns")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_point_kernels(torch):
    """FPS, kNN and the gather forward and backward against their plain
    versions at the point paths' shapes; times at the largest of each path."""
    from simple3dformer_tpu_torch.kernels.fps import fps, fps_reference
    from simple3dformer_tpu_torch.kernels.gather import (gather_bwd, gather_bwd_reference,
                                                         gather_fwd, gather_fwd_reference)
    from simple3dformer_tpu_torch.kernels.knn import knn, knn_reference

    rs = np.random.RandomState(11)
    report = {}

    for label, b, n, npoint in FPS_SHAPES:
        xyz = unit_cloud(torch, rs, b, n)
        got, want = fps(xyz, npoint), fps_reference(xyz, npoint)
        start = torch.from_numpy(rs.randint(0, n, b).astype(np.int32)).cuda()
        got_s, want_s = fps(xyz, npoint, start), fps_reference(xyz, npoint, start)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and torch.equal(got_s, want_s)
        print(f"kernel fps {label} B={b} N={n} npoint={npoint}: indices equal to the plain "
              f"version {same} (start 0 and random starts)")
        if not same:
            raise AssertionError(f"fps {label}: indices differ from the plain version")
        if label in FPS_TIMED:
            name = "fps" if label == "partseg TD1" else f"fps {label}"
            iters = FPS_TIMED[label]
            rep = point_report(
                name, 0.0, timed(torch, lambda: fps(xyz, npoint),
                                 lambda: fps_reference(xyz, npoint), iters=iters),
                nbytes(xyz, got), 9 * b * n * (npoint - 1), "", iters=iters, peak=PEAK_FMA)
            print(f"kernel {name} device ms per call (profiler): "
                  f"{split_text(device_split(torch, lambda: fps(xyz, npoint)))}")
            if label == "partseg TD1":
                report["fps"] = rep

    for label, b, s, n, k, dup in KNN_SHAPES:
        q, p = knn_inputs(torch, rs, b, s, n, dup)
        ok, idx, dist, f = knn_check(torch, q, p, k)
        print(f"kernel knn {label} B={b} S={s} N={n} k={k}: idx and dist bit-equal to the "
              f"exact-order plain version {f['exact']}, over two runs {f['rerun']}; against "
              f"the matmul form {f['n_diff']} of {idx.numel()} ranks differ, {f['n_near']} of "
              f"them near-ties (distances within 1e-6), distance max abs err {f['derr']:.3e} "
              f"(tolerance {KNN_DIST_TOL}); {f['ties']} equal neighbouring distances, "
              f"{f['disorder']} out of index order")
        if not ok:
            raise AssertionError(f"knn {label}: {f}")
        if label in KNN_TIMED:
            name = "knn" if label == "TD0 k=16" else f"knn {label}"
            rep = point_report(
                name, f["derr"], timed(torch, lambda: knn(q, p, k),
                                       lambda: knn_reference(q, p, k)),
                nbytes(q, p, idx, dist), 9 * b * s * n, "", peak=PEAK_FMA)
            print(f"kernel {name} device ms per call (profiler): "
                  f"{split_text(device_split(torch, lambda: knn(q, p, k)))}")
            if label == "TD0 k=16":
                report["knn"] = rep

    for label, b, n, r, c, dtype, one_point in GATHER_SHAPES:
        pts, idx, g = gather_inputs(torch, b, n, r, c, dtype, one_point, seed=b + n + r + c,
                                    device="cuda")
        ok, out, gp, gwant, facts = gather_check(torch, pts, idx, g)
        print(f"kernel gather {label} B={b} N={n} R={r} C={c} {dtype}: forward equal "
              f"{facts['forward_equal']}; backward bit-equal to the CPU plain version "
              f"{facts['cpu_bit_equal']}, error relative to the largest value of the card's "
              f"{facts['rel']:.3e} (tolerance {GATHER_BWD_REL}), two runs bit-equal "
              f"{facts['rerun_bit_equal']}")
        if not ok:
            raise AssertionError(f"gather {label}: {facts}")
        if label not in GATHER_TIMED:
            continue
        name = "" if label == "TD0 points C=48" else f" {label}"
        idx_lib = idx.long().clamp(0, n - 1)
        expanded = idx_lib[..., None].expand(-1, -1, c)
        fwd = point_report(
            f"gather_fwd{name}", 0.0,
            timed(torch, lambda: gather_fwd(pts, idx), lambda: gather_fwd_reference(pts, idx),
                  lambda: torch.gather(pts, 1, expanded)),
            nbytes(pts, idx, out), 0, "torch.gather, int64 index expanded beforehand")
        flat = (idx_lib + torch.arange(b, device="cuda")[:, None] * n).reshape(-1)
        g2 = g.reshape(-1, c)
        bwd = point_report(
            f"gather_bwd{name}", float((gp - gwant).abs().max()),
            timed(torch, lambda: gather_bwd(idx, g, n), lambda: gather_bwd_reference(idx, g, n),
                  lambda: torch.zeros(b * n, c, device="cuda").index_add_(0, flat, g2)),
            nbytes(idx, g, gp), b * r * c, "zeros + index_add_, float atomics")
        for label_fn, kernel_fn, library_fn in (
                (f"gather_fwd{name}", lambda: gather_fwd(pts, idx),
                 lambda: torch.gather(pts, 1, expanded)),
                (f"gather_bwd{name}", lambda: gather_bwd(idx, g, n),
                 lambda: torch.zeros(b * n, c, device="cuda").index_add_(0, flat, g2))):
            split, lib = device_split(torch, kernel_fn), device_split(torch, library_fn)
            print(f"kernel {label_fn} device ms per call (profiler): {split_text(split)}; "
                  f"the library call {sum(ms for ms, _ in lib.values()):.4f}")
        if label == "TD0 points C=48":
            report["gather_fwd"], report["gather_bwd"] = fwd, bwd
    torch.cuda.synchronize()
    return report


# the mhsa kernels: (label, B, N, H, dh, dtype name); q, k, v are views of one
# packed [B, N, 3, H, dh] tensor, as Attention makes them
MHSA_SHAPES = [("S3DIS f32", 4, 1025, 3, 256, "float32"),
               ("S3DIS bf16", 4, 1025, 3, 256, "bfloat16"),
               ("N=256", 4, 256, 3, 256, "float32"),
               ("N=2048", 2, 2048, 3, 256, "float32"),
               ("head_dim 64", 16, 257, 3, 64, "float32"),
               ("B=1", 1, 1025, 3, 256, "float32"),
               ("N=77 head_dim 128", 2, 77, 4, 128, "float32"),
               ("head_dim 192 bf16", 2, 300, 2, 192, "bfloat16"),
               ("head_dim 64 bf16", 4, 257, 3, 64, "bfloat16"),
               ("head_dim 128 bf16", 2, 77, 4, 128, "bfloat16"),
               ("head_dim 192 f32 N=300", 2, 300, 2, 192, "float32"),
               ("head_dim 256 f32 N=97", 3, 97, 2, 256, "float32"),
               ("N=1", 2, 1, 3, 256, "float32"),
               ("N=1 bf16", 2, 1, 2, 64, "bfloat16"),
               # one below and one above the kernels' tiles of 32 and 64 rows
               # (queries or keys; 32 keys a forward warp group)
               ("N=31", 2, 31, 2, 128, "float32"),
               ("N=33 bf16", 2, 33, 2, 64, "bfloat16"),
               ("N=63", 2, 63, 2, 192, "float32"),
               ("N=65 bf16", 2, 65, 2, 256, "bfloat16")]
# error relative to the largest value of each output. f32: sums of up to N
# products in another order, one exp, and the last bits of the 3-pass TF32
# split; bf16: as TOL, a last-bit difference in an f32 value can round p or ds
# to the neighbouring bf16 value.
MHSA_REL = {"float32": 1e-4, "bfloat16": 3e-2}


def mhsa_inputs(torch, b, n, h, dh, dtype, seed, device):
    """q, k, v (views of one packed qkv) and g, standard normal: q.k * dh**-0.5 has unit scale."""
    rs = np.random.RandomState(seed)
    qkv = torch.from_numpy(rs.randn(b, n, 3, h, dh).astype(np.float32))
    g = torch.from_numpy(rs.randn(b, n, h, dh).astype(np.float32))
    qkv, g = qkv.to(device=device, dtype=dtype), g.to(device=device, dtype=dtype)
    return (*qkv.unbind(2), g)


def rel_err(got, want) -> float:
    """The largest error relative to each output's largest value; absolute for
    an output that is zero (dq and dk at N = 1, where p is 1 and ds 0)."""
    return max(float((a.float() - b.float()).abs().max()) / (float(b.float().abs().max()) or 1.0)
               for a, b in zip(got, want))


def sdpa_times(torch, fwd, bwd_of, dtype, iters=50):
    """ms of scaled_dot_product_attention's forward and of its backward alone
    under each backend that may take ``dtype`` ({name: (fwd, bwd)}, None where
    the backend refuses the call). ``bwd_of(out)`` runs the backward of an
    output made under the same backend, which picks the backward kernel."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = ["EFFICIENT_ATTENTION", "MATH"]
    if dtype == torch.bfloat16:
        names += ["FLASH_ATTENTION", "CUDNN_ATTENTION"]
    out = {}
    for name in names:
        with sdpa_kernel(getattr(SDPBackend, name)):
            try:
                y = fwd()
                torch.cuda.synchronize()
            except RuntimeError:
                out[name] = None
                continue
            out[name] = (time_ms(torch, fwd, iters), time_ms(torch, lambda: bwd_of(y), iters))
    return out


def fastest(times: dict, i: int) -> tuple[float, str]:
    """(ms, backend) of the fastest backend for the forward (i = 0) or backward (1)."""
    return min((t[i], name) for name, t in times.items() if t is not None)


def mhsa_profile(torch, step, label, iters=10):
    """Device ms of each mhsa kernel per forward-and-backward call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    times = {e.key[e.key.index("mhsa_"):].split("(")[0]: e.self_device_time_total / iters / 1e3
             for e in prof.key_averages() if "mhsa_" in e.key}
    print(f"kernel mhsa {label}: device ms per call by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])))


def phase_mhsa_kernels(torch):
    """The mhsa forward and backward against their plain versions; the backward
    twice, bit-equal; at the S3DIS shape in f32 and bf16 the times of kernel,
    plain version and scaled_dot_product_attention under each backend, and
    the kernels' TFLOP/s."""
    import torch.nn.functional as F

    from simple3dformer_tpu_torch.kernels.mhsa import (mhsa_backward_reference, mhsa_bwd,
                                                       mhsa_fwd, mhsa_reference)

    report = {}
    for label, b, n, h, dh, dtype in MHSA_SHAPES:
        q, k, v, g = mhsa_inputs(torch, b, n, h, dh, getattr(torch, dtype), b * n + dh, "cuda")
        scale = dh ** -0.5
        o, stats = mhsa_fwd(q, k, v, scale)
        grads = mhsa_bwd(q, k, v, g, scale, stats, o)
        again = mhsa_bwd(q, k, v, g, scale, stats, o)
        o_ref = mhsa_reference(q, k, v, scale)
        grads_ref = mhsa_backward_reference(q, k, v, g, scale)
        torch.cuda.synchronize()
        fwd_err, bwd_err = rel_err([o], [o_ref]), rel_err(grads, grads_ref)
        same = all(torch.equal(a, c) for a, c in zip(grads, again))
        ok = all(bool(torch.isfinite(t).all()) and t.shape == q.shape and t.dtype == q.dtype
                 for t in (o, *grads))
        print(f"kernel mhsa {label} B={b} N={n} H={h} dh={dh} {dtype}: error relative to the "
              f"largest value: forward {fwd_err:.3e}, backward {bwd_err:.3e} (tolerance "
              f"{MHSA_REL[dtype]}); two backward runs bit-equal {same}; finite/shape/dtype {ok}")
        if not max(fwd_err, bwd_err) <= MHSA_REL[dtype] or not same or not ok:
            raise AssertionError(f"mhsa {label}: errors {fwd_err}, {bwd_err}, bit-equal {same}, "
                                 f"finite/shape/dtype {ok}")
        if not label.startswith("S3DIS"):
            continue
        flops = 4 * b * h * n * n * dh  # q k^T and p v, 2 operations a multiply-add
        peak = PEAK_F32 if dtype == "float32" else PEAK_BF16
        qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        lib = sdpa_times(torch, lambda: F.scaled_dot_product_attention(*leaves, scale=scale),
                         lambda y: torch.autograd.grad(y, leaves, gh, retain_graph=True),
                         q.dtype)
        print(f"kernel mhsa {label}: scaled_dot_product_attention by backend, ms forward / "
              "backward alone: " + "; ".join(
                  f"{name} " + ("refused" if t is None else f"{t[0]:.4f} / {t[1]:.4f}")
                  for name, t in lib.items()))
        (lib_fwd, be_fwd), (lib_bwd, be_bwd) = fastest(lib, 0), fastest(lib, 1)
        fwd_times = timed(torch, lambda: mhsa_fwd(q, k, v, scale),
                          lambda: mhsa_reference(q, k, v, scale))[:2] + (lib_fwd,)
        bwd_times = timed(torch, lambda: mhsa_bwd(q, k, v, g, scale, stats, o),
                          lambda: mhsa_backward_reference(q, k, v, g, scale))[:2] + (lib_bwd,)
        print(f"kernel mhsa {label}: forward {flops / fwd_times[0] / 1e9:.1f} TFLOP/s, backward "
              f"{10 * flops // 4 / bwd_times[0] / 1e9:.1f} TFLOP/s (5 products); "
              f"scaled_dot_product_attention {flops / lib_fwd / 1e9:.1f} ({be_fwd}) and "
              f"{10 * flops // 4 / lib_bwd / 1e9:.1f} ({be_bwd})")
        fwd = point_report(
            f"mhsa_fwd {dtype}", float((o.float() - o_ref.float()).abs().max()), fwd_times,
            nbytes(q, k, v, o), flops,
            f"scaled_dot_product_attention forward, [B, H, N, dh], {be_fwd}", peak=peak)
        bwd = point_report(
            f"mhsa_bwd {dtype}", max(float((a.float() - c.float()).abs().max())
                                     for a, c in zip(grads, grads_ref)), bwd_times,
            nbytes(q, k, v, g, *grads), 10 * flops // 4,
            f"scaled_dot_product_attention backward alone, autograd.grad, {be_bwd}", peak=peak)
        mhsa_profile(torch, lambda: mhsa_bwd(q, k, v, g, scale, *mhsa_fwd(q, k, v, scale)[::-1]),
                     label)
        if dtype == "float32":
            report["mhsa_fwd"], report["mhsa_bwd"] = fwd, bwd
        del leaves, lib
    torch.cuda.synchronize()
    return report


# partseg training: the slice's main path
PARTSEG_LR = 0.05  # base lr of the CLI run (configs/partseg.yaml's), checked on the CPU
PARTSEG_SAMPLES, PARTSEG_EPOCHS = 64, 15  # 4 steps per epoch at B=16: 60 steps


def partseg_model(torch, device):
    from simple3dformer_tpu_torch.cli.train_partseg import NUM_CATEGORY, NUM_PART
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.point_vit import PointViT

    return PointViT("3DViT", "seg", PN, NUM_PART, input_dim=6 + NUM_CATEGORY, nneighbor=16,
                    transformer_backbone="deit_tiny_patch16_224",
                    generator=generator(DEFAULT_SEED)).to(device)


def point_counters():
    from simple3dformer_tpu_torch.kernels import fps, gather, knn
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    return {"fps": fps.fps, "knn": knn.knn, "gather_fwd": gather.gather_fwd,
            "gather_bwd": gather.gather_bwd, "fused_vit_block": vb.fused_vit_block,
            "fused_vit_block_train_fwd": vb.fused_vit_block_train_fwd,
            "fused_vit_block_train_bwd": vb.fused_vit_block_train_bwd}


def phase_partseg(torch):
    """The 3DViT partseg model (deit_tiny, N=1024, B=16, f32, SGD) through the
    port's trainer; returns the launch counts of the CLI run."""
    from simple3dformer_tpu_torch.cli import train_partseg as tp
    from simple3dformer_tpu_torch.core.config import Config
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.train.loop import (TrainState, make_scanned_train_steps,
                                                     make_train_step, seg_cross_entropy)
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    def trainer(device):
        model = partseg_model(torch, device)
        return TrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"))

    cfg = Config(num_point=PN, normal=True, synthetic=64 * PB, seed=9)
    (xs, cats, segs), _ = tp.load_arrays(cfg)
    prepare = tp.make_prepare_fn()

    def batch(i, device):
        sl = slice(i * PB, (i + 1) * PB)
        return {k: torch.from_numpy(v[sl]).to(device)
                for k, v in (("x", xs), ("cls", cats), ("y", segs))}

    # 3 steps on the card and on the CPU's plain path, same weights and batches
    losses = {}
    for device in ("cuda", "cpu"):
        step = make_train_step(trainer(device), seg_cross_entropy, prepare_fn=prepare)
        losses[device] = [float(step(batch(i, device), PARTSEG_LR)["loss"]) for i in range(3)]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    print(f"partseg training: 3 steps at B={PB}, N={PN}, lr {PARTSEG_LR}: losses on the card "
          f"{losses['cuda']} vs the CPU's plain path {losses['cpu']} (rtol 1e-3)")

    # the CLI on a synthetic corpus held on the card: the slice's main path
    _, lines, launches, _ = run_cli(tp.main, lambda d: [
        "model=3DViT", f"synthetic={PARTSEG_SAMPLES}", f"epoch={PARTSEG_EPOCHS}",
        f"batch_size={PB}", f"learning_rate={PARTSEG_LR}", f"out_dir={d}"], point_counters())
    epoch_losses = [float(line.split()[6]) for line in lines
                    if line.startswith("Epoch ") and "train loss" in line]
    ious = [line for line in lines if "Inctance avg mIOU" in line]
    steps = PARTSEG_EPOCHS * (PARTSEG_SAMPLES // PB)
    evals = PARTSEG_EPOCHS * -(-max(PARTSEG_SAMPLES // 5, 32) // PB)
    want = {"fps": steps + evals, "knn": 4 * (steps + evals), "gather_fwd": 8 * (steps + evals),
            "gather_bwd": 4 * steps, "fused_vit_block_train_fwd": 12 * steps,
            "fused_vit_block_train_bwd": 12 * steps, "fused_vit_block": 12 * evals}
    print(f"partseg CLI: {steps} train steps, {evals} eval batches; epoch losses "
          f"{epoch_losses[0]:.4f} -> {epoch_losses[-1]:.4f}; {ious[-1].strip()}; launches "
          f"{launches} (want {want})")
    if len(epoch_losses) != PARTSEG_EPOCHS or not epoch_losses[-1] < 0.75 * epoch_losses[0]:
        raise AssertionError(f"partseg training loss did not fall: {epoch_losses}")
    if launches != want:
        raise AssertionError(f"partseg launch counts {launches}, want {want}")

    # train throughput: 20 steps at B=16 from a corpus on the card, host clock
    n_steps = 20
    ds = DeviceResidentDataset({"x": xs[:(n_steps + 1) * PB], "cls": cats[:(n_steps + 1) * PB],
                                "y": segs[:(n_steps + 1) * PB]}, "cuda")
    run = make_scanned_train_steps(trainer("cuda"), ds, seg_cross_entropy, prepare_fn=prepare)
    idx = ds.put_indices(np.arange((n_steps + 1) * PB).reshape(n_steps + 1, PB))
    timed_steps(torch, run, idx, PARTSEG_LR, n_steps, "partseg", PB, n_profile=10)
    return launches


# S3DIS semantic segmentation: the slice's main path (configs/semseg.yaml: 3DViT_s3dis on
# deit_base with 3 heads, 4096 points of 9 features, 13 classes, batch 4, SGD at lr 0.5)
SB, SN = 4, 4096
# card-vs-CPU steps of the Hengshuang cls, LwF, group_embed and ViP-3D checks:
# 2 (the step at equal weights and the one after an update), not 3; with
# phase 10's B=1 and the S3DIS-shaped segmentation steps below, the depth
# given up for phase 26 (their CPU sides took 5-25 s a step)
CPU_PARITY_STEPS = 2
# the card-vs-CPU steps at B=1, as phase 18's bf16 S3DIS steps (B=4 took 61 s
# of the CPU: the depth given up for phase 26)
S3DIS_PARITY_B = 1
# and through 4 of the 12 blocks, as phase 21's group_embed steps, here at
# CPU_PARITY_STEPS steps, not 3 (all 12 blocks took 18.3 s of the CPU here at 3
# steps and 23.3 s in phase 18 at 2: the depth given up for phase 27)
S3DIS_PARITY_DEPTH = 4
S3DIS_SAMPLES, S3DIS_EPOCHS = 16, 2  # 4 train steps and 4 eval batches an epoch
# learnability: labels a function of the points (13 height bins of feature 2),
# SGD at this lr (not the config's 0.5; see PERF.md)
LEARN_LR, LEARN_STEPS = 0.05, 40


def s3dis_config(**overrides):
    from simple3dformer_tpu_torch.cli.train_s3dis_semseg import INPUT_DIM, NUM_CLASS
    from simple3dformer_tpu_torch.core.config import load_task_config

    cfg = load_task_config("semseg", [f"{k}={v}" for k, v in overrides.items()])
    cfg.num_class, cfg.input_dim, cfg.seed = NUM_CLASS, INPUT_DIM, 9
    cfg.setdefault("synthetic", 0)
    return cfg


def s3dis_trainer(torch, device, depth=None):
    """3DViT_s3dis with SGD; ``depth``: only the first blocks."""
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.registry import make_point_model
    from simple3dformer_tpu_torch.train.loop import TrainState
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    model = make_point_model(s3dis_config(), "seg", generator=generator(DEFAULT_SEED)).to(device)
    if depth is not None:
        model.blocks = model.blocks[:depth]
    return TrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"))


def s3dis_counters():
    from simple3dformer_tpu_torch.kernels import mhsa
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    return {**point_counters(), "fused_vit_block_bwd": vb.fused_vit_block_bwd,
            "mhsa_fwd": mhsa.mhsa_fwd, "mhsa_bwd": mhsa.mhsa_bwd}


def phase_s3dis(torch):
    """The S3DIS model (3DViT_s3dis, deit_base, N=4096 -> 1025 tokens, B=4, f32,
    SGD) through the port's trainer; returns the launch counts of the CLI run."""
    from simple3dformer_tpu_torch.cli import train_s3dis_semseg as ts
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.nn.layers import Block
    from simple3dformer_tpu_torch.train.loop import (make_scanned_train_steps, make_train_step,
                                                     seg_cross_entropy)

    lr = float(s3dis_config().learning_rate)
    routes = {label: Block(d, heads).route(torch.zeros(1, n, d))
              for label, d, heads, n in (("flagship", 384, 6, 26), ("partseg", 192, 3, 257),
                                         ("S3DIS", 768, 3, 1025))}
    print(f"S3DIS block routes on the card: {routes}")
    if routes != {"flagship": "fused", "partseg": "fused", "S3DIS": "layered"}:
        raise AssertionError(f"block routes {routes}")

    # CPU_PARITY_STEPS steps on the card and on the CPU's plain path, same
    # weights and batches
    pb, depth, n_steps = S3DIS_PARITY_B, S3DIS_PARITY_DEPTH, CPU_PARITY_STEPS
    (xs, ys), _ = ts.load_arrays(s3dis_config(synthetic=n_steps * pb))
    losses, seconds = {}, {}
    for device in ("cuda", "cpu"):
        step = make_train_step(s3dis_trainer(torch, device, depth), seg_cross_entropy)
        t0 = time.perf_counter()
        losses[device] = [float(step({"x": torch.from_numpy(xs[i * pb:(i + 1) * pb]).to(device),
                                      "y": torch.from_numpy(ys[i * pb:(i + 1) * pb]).to(device)},
                                     lr)["loss"]) for i in range(n_steps)]
        seconds[device] = time.perf_counter() - t0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    print(f"S3DIS training: {n_steps} steps at B={pb}, N={SN}, deit_base, {depth} of the 12 blocks, "
          f"lr {lr}: losses on the card "
          f"{losses['cuda']} vs the CPU's plain path {losses['cpu']} (rtol 1e-3); "
          f"{seconds['cuda']:.1f} s on the card, {seconds['cpu']:.1f} s on the CPU")

    # the CLI on its synthetic stream: the slice's main path
    _, lines, launches, _ = run_cli(
        ts.main, lambda d: [f"synthetic={S3DIS_SAMPLES}", f"epoch={S3DIS_EPOCHS}", f"out_dir={d}"],
        s3dis_counters())
    epoch_losses = [float(line.split()[5]) for line in lines if line.startswith("Epoch ")]
    evals_lines = [line for line in lines if line.startswith("eval accuracy:")]
    steps = S3DIS_EPOCHS * (S3DIS_SAMPLES // SB)
    evals = S3DIS_EPOCHS * -(-max(S3DIS_SAMPLES // 5, 16) // SB)
    want = {"fps": steps + evals, "knn": 4 * (steps + evals), "gather_fwd": 8 * (steps + evals),
            "gather_bwd": 4 * steps, "fused_vit_block": 0, "fused_vit_block_bwd": 0,
            "fused_vit_block_train_fwd": 0, "fused_vit_block_train_bwd": 0,
            "mhsa_fwd": 12 * (steps + evals), "mhsa_bwd": 12 * steps}
    print(f"S3DIS CLI (configs/semseg.yaml, synthetic={S3DIS_SAMPLES}): {steps} train steps, "
          f"{evals} eval batches; epoch losses {epoch_losses}; "
          f"{evals_lines[-1] if evals_lines else 'no eval line'}; "
          f"launches {launches} (want {want})")
    if (len(epoch_losses) != S3DIS_EPOCHS or not np.isfinite(epoch_losses).all()
            or len(evals_lines) != S3DIS_EPOCHS or not lines[-1].startswith("Best Inctance")):
        raise AssertionError(f"S3DIS CLI output: {lines[-8:]}")
    if launches != want:
        raise AssertionError(f"S3DIS launch counts {launches}, want {want}")

    # learnability: labels are 13 height bins of feature 2
    rs = np.random.RandomState(12)
    lx = rs.rand((LEARN_STEPS + 1) * SB, SN, 9).astype(np.float32)
    ly = np.minimum(lx[..., 2] * 13, 12).astype(np.int32)
    ds = DeviceResidentDataset({"x": lx, "y": ly}, "cuda")
    run = make_scanned_train_steps(s3dis_trainer(torch, "cuda"), ds, seg_cross_entropy)
    idx = ds.put_indices(np.arange((LEARN_STEPS + 1) * SB).reshape(LEARN_STEPS + 1, SB))
    curve = run(idx[:LEARN_STEPS], LEARN_LR)["loss"].cpu().numpy()
    first, last = float(curve[:5].mean()), float(curve[-5:].mean())
    print(f"S3DIS learnability (labels = height bin of feature 2, lr {LEARN_LR}, {LEARN_STEPS} "
          f"steps at B={SB}): loss {first:.4f} over the first 5 steps -> {last:.4f} over the "
          f"last 5; curve {np.round(curve, 4).tolist()}")
    if not np.isfinite(curve).all() or not last < 0.75 * first:
        raise AssertionError(f"S3DIS learnability: loss {first} -> {last}")

    # train throughput: 10 steps at B=4 from a corpus on the card, host clock
    run = make_scanned_train_steps(s3dis_trainer(torch, "cuda"), ds, seg_cross_entropy)
    timed_steps(torch, run, idx, lr, 10, "S3DIS", SB, n_profile=5)
    return launches


# the vector-attention kernels: (label, B, N, K, D, duplicated neighbours); the
# Hengshuang cls step's levels at B=64 are N = 1024, 256, 64, 16, 4 with K = 16
# (K = 4 at N = 4, kNN clamps k to N); the segmentation steps' level 0 at
# partseg's B=16, N=1024 and S3DIS's B=4, N=4096; D=8 and D=136: the
# tensor-core core's edges (a contraction not a multiple of 16, a width not a
# multiple of 128)
SEG_LEVEL0 = [("partseg seg level 0", 16, 1024, 16, 512, False),
              ("S3DIS seg level 0", 4, 4096, 16, 512, False)]
VA_SHAPES = [("level 0", 64, 1024, 16, 512, False), *SEG_LEVEL0,
             ("level 1", 64, 256, 16, 512, False),
             ("N=255", 2, 255, 16, 512, False), ("N=256", 2, 256, 16, 512, False),
             ("level 4 N=4 K=4", 64, 4, 4, 512, False), ("D=200 K=12", 3, 77, 12, 200, False),
             ("duplicates", 2, 64, 16, 512, True), ("D=8", 2, 100, 16, 8, False),
             ("D=136 K=10", 2, 130, 10, 136, False)]
# error relative to each output's own largest value: f32 sums of up to B*N*K
# products in another order
VA_REL = 1e-4


def va_err(name, got, want) -> float:
    """The error of one vector-attention output over its own largest value;
    over max(1, that value) for bg2's gradient, which is zero but for rounding
    (the softmax over K does not see a bias added to every neighbour's logit),
    as in the JAX package's test of this kernel."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (max(1.0, scale) if name == "bg2" else scale)


def va_inputs(torch, b, n, kk, d, seed, device, duplicates=False):
    """q, k, v, rel and the eight weights as the block makes them: k and v the
    rows of per-point [B, N, D] tensors at neighbour indices (all among the
    first three points with ``duplicates``), rel neighbour offsets of unit-sphere
    scale, Linear weights of unit gain."""
    from simple3dformer_tpu_torch.kernels.vector_attention import weight_shapes

    rs = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.randn(*shape)).astype(np.float32)).to(device)

    q, k_all, v_all = t(b, n, d), t(b, n, d), t(b, n, d)
    hi = min(3, n) if duplicates else n
    idx = torch.from_numpy(rs.randint(0, hi, (b, n, kk)).astype(np.int64)).to(device)
    rows = torch.arange(b, device=device)[:, None, None]
    k, v = k_all[rows, idx].contiguous(), v_all[rows, idx].contiguous()
    rel = t(b, n, kk, 3, scale=0.1)
    w = {name: t(*shape, scale=shape[1] ** -0.5 if len(shape) == 2 else 0.1)
         for name, shape in weight_shapes(d).items()}
    return q, k, v, rel, w


def gemm_split(torch, fn, b, n, kk, d, label, route, parts, iters=3, rounds=3):
    """Device time of one vector-attention call by GEMM (torch.profiler): a
    forward's ("forward" in ``parts``) pos, hg and logits GEMMs, a backward's
    three row GEMMs and three weight-gradient GEMMs by kind, each with its
    TFLOP/s (2 R D^2 a GEMM), then the other kernels. A kernel's time per call
    is its mean time per launch times its launches per call: the profiler can
    miss launches (the recorded ones are printed beside the expected ones), so
    it profiles ``iters`` calls again, up to ``rounds`` times, until every GEMM
    of ``parts`` was recorded. Fails where a GEMM of the call ran on anything
    but the tensor-core core with ``route``'s products ("bf16": Bf16Mma,
    "tf32x3": Tf32x3), or a GEMM of ``parts`` was never recorded.
    Informational when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kinds = {k: 0.0 for p in parts for k in GEMM_KINDS[p]}
    recorded: dict[str, list] = {}  # kernel name -> [device us, launches]
    for calls in range(iters, iters * rounds + 1, iters):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us > 0 and str(getattr(e, "device_type", "")).split(".")[-1] == "CUDA":
                seen = recorded.setdefault(e.key, [0.0, 0])
                seen[0] += us
                seen[1] += e.count
        gemms = {GEMM_KIND[tc_label(key).split()[1]] for key in recorded if is_va_gemm(key)}
        if gemms >= set(kinds):
            break
    rest: dict[str, float] = {}
    each: dict[str, tuple[float, int, int]] = {}
    strays = []
    for key, (us, count) in recorded.items():
        per_launch = us / count / 1e3
        if is_va_gemm(key):
            name = tc_label(key)
            kind = GEMM_KIND[name.split()[1]]
            if not name.startswith(f"{route} ") or kind not in kinds:
                strays.append(name)
                continue
            # the f32 route's x and hg weight gradients are one instantiation
            per_call = 2 if name == "tf32x3 VaEpiPartial" else 1
            kinds[kind] += per_launch * per_call
            ms, seen, want = each.get(name, (0.0, 0, 0))
            each[name] = (ms + per_launch * per_call, seen + count, want + per_call * calls)
        else:
            if "gemm" in key.lower():
                strays.append(key[:60])
            name = next((g for g in KERNEL_GROUPS if g in key), key[:40])
            rest[name] = rest.get(name, 0.0) + per_launch * max(1, round(count / calls))
    if not any(kinds.values()) and not rest and not strays:
        print(f"{label}: the profiler recorded no device time")
        return
    gemm = 2 * b * n * kk * d * d
    flops = {k: gemm * (1 if k in GEMM_KINDS["forward"] else 3) for k in kinds}
    shown = ", ".join(f"{k} {v:.3f} ms ({flops[k] / v / 1e9:.1f} TFLOP/s)" if v else f"{k} 0 ms"
                      for k, v in kinds.items())
    others = ", ".join(f"{k} {v:.3f}" for k, v in sorted(rest.items(), key=lambda kv: -kv[1]))
    gemms = ", ".join(f"{k} {ms:.3f} ({seen} of {want} launches recorded)"
                      for k, (ms, seen, want) in each.items())
    print(f"{label} device time by GEMM, ms per call (profiler, {calls} calls): {shown}; "
          f"each GEMM: {gemms}; the rest: {others}")
    missing = [k for k, v in kinds.items() if not v]
    if strays or missing:
        raise AssertionError(f"{label}: GEMMs not all on the {route} tensor-core core: ran "
                             f"elsewhere {strays}, not recorded in {calls} calls {missing}")


def phase_va_kernels(torch):
    """The vector-attention forward and backward against their plain versions
    at the Hengshuang step's shapes: the forward's output and kept residuals
    against the plain chain's, the backward against the plain backward from the
    forward's residuals (and, reported, against a backward through a
    recomputed plain chain, with the hg ReLUs that fall on the other side of
    zero there); each twice, bit-equal; times of kernel and plain version at
    level 0 (no PyTorch call computes the chain)."""
    from simple3dformer_tpu_torch.kernels import vector_attention as va

    report = {}
    for label, b, n, kk, d, dup in VA_SHAPES:
        q, k, v, rel, w = va_inputs(torch, b, n, kk, d, b * n + kk + d, "cuda", dup)
        g = torch.randn(b, n, d, generator=torch.Generator("cuda").manual_seed(n), device="cuda")
        out, res = va.vector_attention_fwd(q, k, v, rel, w, save=True)
        out_inf, _ = va.vector_attention_fwd(q, k, v, rel, w)
        out2, res2 = va.vector_attention_fwd(q, k, v, rel, w, save=True)
        torch.cuda.synchronize()
        same = (torch.equal(out, out_inf) and torch.equal(out, out2)
                and all(torch.equal(res[key], res2[key]) for key in res))
        del out2, res2
        grads = va.vector_attention_bwd(g, rel, w, res)
        again = va.vector_attention_bwd(g, rel, w, res)
        torch.cuda.synchronize()
        flat = lambda gr: [*gr[:4], *[gr[4][name] for name in va.WNAMES]]  # noqa: E731
        same = same and all(torch.equal(a, c) for a, c in zip(flat(grads), flat(again)))
        del again
        out_ref, res_ref = va.vector_attention_resid_reference(q, k, v, rel, w)
        fwd_errs = {"out": va_err("out", out, out_ref),
                    **{name: va_err(name, res[name], res_ref[name]) for name in va.RESIDUALS}}
        fwd_abs = float((out - out_ref).abs().max())
        flips = int(((res["hg"] > 0) != (res_ref["hg"] > 0)).sum())
        del out_ref, res_ref
        names = ("gq", "gk", "gv", "grel", *va.WNAMES)
        want = va.vector_attention_resid_backward_reference(rel, w, res, g)
        torch.cuda.synchronize()
        errs = {name: va_err(name, a, c) for name, a, c in zip(names, flat(grads), flat(want))}
        bwd_abs = max(float((a - c).abs().max()) for a, c in zip(flat(grads), flat(want)))
        del want
        want = va.vector_attention_backward_reference(q, k, v, rel, w, g)
        recomputed = {name: va_err(name, a, c)
                      for name, a, c in zip(names, flat(grads), flat(want))}
        del want
        ok = all(bool(torch.isfinite(t).all()) for t in (out, *flat(grads)))
        fwd_worst, worst = max(fwd_errs, key=fwd_errs.get), max(errs, key=errs.get)
        far = max(recomputed, key=recomputed.get)
        print(f"kernel vector_attention {label} B={b} N={n} K={kk} D={d}: error relative to "
              f"each output's largest value (bg2's gradient: max(1, it)): forward "
              f"{fwd_errs[fwd_worst]:.3e} ({fwd_worst}; out {fwd_errs['out']:.3e}), backward from "
              f"its residuals {errs[worst]:.3e} ({worst}) (tolerance {VA_REL}); forward kept/not "
              f"kept, two forward runs and two backward runs bit-equal {same}; finite {ok}; "
              f"against a backward through a recomputed plain chain {recomputed[far]:.3e} ({far}),"
              f" {flips} of {res['hg'].numel()} hg ReLUs on the other side of zero there")
        if max(fwd_errs[fwd_worst], errs[worst]) > VA_REL or not same or not ok:
            raise AssertionError(f"vector attention {label}: forward {fwd_errs}, backward "
                                 f"{errs}, bit-equal {same}, finite {ok}")
        if label == "level 0":
            ws = [w[name] for name in va.WNAMES]
            ops = va.flops(b, n, kk, d)
            times = timed(torch, lambda: va.vector_attention_fwd(q, k, v, rel, w, save=True),
                          lambda: va.vector_attention_reference(q, k, v, rel, w), iters=10)
            report["vector_attention_fwd"] = point_report(
                "vector_attention_fwd", fwd_abs, times, nbytes(q, k, v, rel, *ws, out), ops,
                "", iters=10)
            gemm_split(torch, lambda: va.vector_attention_fwd(q, k, v, rel, w, save=True), b, n,
                       kk, d, "kernel vector_attention_fwd level 0", "tf32x3", ("forward",))
            gq, gk, gv, grel, gw = grads
            times = timed(torch, lambda: va.vector_attention_bwd(g, rel, w, res),
                          lambda: va.vector_attention_resid_backward_reference(rel, w, res, g),
                          iters=10)
            report["vector_attention_bwd"] = point_report(
                "vector_attention_bwd", bwd_abs, times,
                nbytes(q, k, v, rel, *ws, g, gq, gk, gv, grel, gw), 2 * ops, "", iters=10)
            gemm_split(torch, lambda: va.vector_attention_bwd(g, rel, w, res), b, n, kk, d,
                       "kernel vector_attention_bwd level 0", "tf32x3", ("backward",))
            torch.cuda.synchronize()
            print(f"vector_attention level 0: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (kernel and plain "
                  f"versions, the residuals kept)")
        del q, k, v, rel, w, g, out, out_inf, res, grads
        torch.cuda.empty_cache()
    return report


# Hengshuang ModelNet40 cls: the slice's main path (configs/cls.yaml with
# configs/model/Hengshuang.yaml: transformer_dim 512, 4 blocks, 16 neighbours,
# 1024 points with normals, 40 classes, batch 64, SGD momentum 0.9 at lr 0.01)
HB, HN = 64, 1024
H_PARITY_B = 4  # the card-vs-CPU steps: full width, a batch the CPU finishes
H_SAMPLES, H_EPOCHS = 256, 3  # 4 train steps and 1 eval batch an epoch
# learnability: 8 classes, each an axis-scaling pattern of the cloud (bit j of
# the class doubles axis j); SGD at this lr (not the recipe's hard-coded 0.01,
# under which the trunc-normal(0.02) init leaves the loss flat for many steps)
H_LEARN_LR, H_LEARN_STEPS = 0.05, 40


def hengshuang_config(**overrides):
    from simple3dformer_tpu_torch.core.config import load_task_config

    cfg = load_task_config("cls", ["model=Hengshuang",
                                   *[f"{k}={v}" for k, v in overrides.items()]])
    cfg.num_class, cfg.input_dim, cfg.seed = 40, 6, 9
    return cfg


def hengshuang_trainer(torch, device, dtype=None):
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.registry import make_point_model
    from simple3dformer_tpu_torch.train.loop import TrainState
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    model = make_point_model(hengshuang_config(), "cls", dtype=dtype,
                             generator=generator(DEFAULT_SEED)).to(device)
    return TrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"))


def hengshuang_counters():
    from simple3dformer_tpu_torch.kernels import fps, gather, knn
    from simple3dformer_tpu_torch.kernels import vector_attention as va

    return {"fps": fps.fps, "knn": knn.knn, "gather_fwd": gather.gather_fwd,
            "gather_bwd": gather.gather_bwd, "vector_attention_fwd": va.vector_attention_fwd,
            "vector_attention_bwd": va.vector_attention_bwd,
            "vector_attention_gather_fwd": va.gather_attention_fwd,
            "vector_attention_gather_bwd": va.gather_attention_bwd,
            "vector_attention_resid_fwd": va.gather_attention_resid_fwd,
            "vector_attention_resid_bwd": va.gather_attention_resid_bwd}


def hengshuang_launches(steps, evals, bf16, resid=True) -> dict:
    """The launches of ``steps`` train steps and ``evals`` eval batches. Per
    forward: 5 vector-attention blocks (a kNN and the neighbours' xyz gather
    each, in f32 also the k and v gathers) and 4 transition-downs (FPS, a kNN
    and 3 gathers each); per backward the feature gather of each
    transition-down, in f32 also the k and v gathers of each block. The
    vector-attention kernels: in f32 the pre-gathered pair; in bf16 training
    the residual-saving pair (``resid``) or the recompute pair, in eval the
    forward."""
    fwd = steps + evals
    want = dict.fromkeys(hengshuang_counters(), 0)
    want.update(fps=4 * fwd, knn=9 * fwd, gather_fwd=(17 if bf16 else 27) * fwd,
                gather_bwd=(4 if bf16 else 14) * steps)
    if not bf16:
        want.update(vector_attention_fwd=5 * fwd, vector_attention_bwd=5 * steps)
    elif resid:
        want.update(vector_attention_gather_fwd=5 * evals, vector_attention_resid_fwd=5 * steps,
                    vector_attention_resid_bwd=5 * steps)
    else:
        want.update(vector_attention_gather_fwd=5 * fwd, vector_attention_gather_bwd=5 * steps)
    return want


def learn_clouds(n, seed):
    """n standard-normal clouds of 6 channels, the class (0..7) doubling the axes of its bits."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, HN, 6).astype(np.float32)
    y = rs.randint(0, 8, n).astype(np.int32)
    for j in range(3):
        x[..., j] *= (1 + ((y >> j) & 1))[:, None]
    return x, y


# card vs CPU: f32, the same sums in another order; bf16, the logits keep 8
# bits, and bf16 intermediates (the Linears' outputs, the kernels' operands)
# round f32 sums taken in another order on the two sides (3 steps' losses
# measured within 4.4e-4 relative on an H100). The eval logits of the first
# batch are compared centred (what the softmax sees), over the largest centred
# CPU logit, so a forward that lost the classes' differences fails.
H_LOSS_RTOL = {False: 1e-3, True: 2e-3}
H_LOGIT_REL = {False: 1e-3, True: 5e-2}


def phase_hengshuang(torch, bf16=False):
    """The Hengshuang Point Transformer (D=512, N=1024, B=64, SGD), f32 or at
    dtype=bf16 (parameters f32), through the port's trainer. Returns the launch
    counts of the CLI run (the main path) and, at bf16, of two steps under
    S3F_VA_RESID=0 (the recompute pair's path)."""
    import contextlib
    import io
    import os
    import tempfile

    from simple3dformer_tpu_torch.cli import train_cls
    from simple3dformer_tpu_torch.data.datasets import synthetic_points
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.train.loop import make_scanned_train_steps, make_train_step

    label, dtype = ("Hengshuang bf16", torch.bfloat16) if bf16 else ("Hengshuang", None)
    lr = 0.01  # the recipe's hard-coded SGD lr
    # steps on the card and on the CPU's plain path, same weights and batches
    xs, ys = synthetic_points(3 * H_PARITY_B, HN, 6, 40, seed=9)
    losses, seconds, logits = {}, {}, {}
    for device in ("cuda", "cpu"):
        state = hengshuang_trainer(torch, device, dtype)
        with torch.no_grad():
            out = state.model.eval()(torch.from_numpy(xs[:H_PARITY_B]).to(device)).float()
        logits[device] = out.cpu().numpy() - out.cpu().numpy().mean(-1, keepdims=True)
        state.model.train()
        step = make_train_step(state)
        t0 = time.perf_counter()
        losses[device] = [float(step({"x": torch.from_numpy(xs[i * H_PARITY_B:(i + 1) * H_PARITY_B])
                                      .to(device),
                                      "y": torch.from_numpy(ys[i * H_PARITY_B:(i + 1) * H_PARITY_B])
                                      .to(device)}, lr)["loss"])
                          for i in range(CPU_PARITY_STEPS)]
        seconds[device] = time.perf_counter() - t0
    print(f"{label} training: {CPU_PARITY_STEPS} steps at B={H_PARITY_B}, N={HN}, D=512, "
          f"lr {lr}: losses on "
          f"the card {losses['cuda']} vs the CPU's plain path {losses['cpu']} (rtol "
          f"{H_LOSS_RTOL[bf16]}); {seconds['cuda']:.1f} s on the card, {seconds['cpu']:.1f} s "
          "on the CPU")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=H_LOSS_RTOL[bf16])
    logit_err = float(np.abs(logits["cuda"] - logits["cpu"]).max() / np.abs(logits["cpu"]).max())
    print(f"{label} eval logits at B={H_PARITY_B}, card vs the CPU's plain path, centred: largest "
          f"error {logit_err:.3e} of the largest centred logit "
          f"{float(np.abs(logits['cpu']).max()):.4e} (limit {H_LOGIT_REL[bf16]})")
    if not logit_err <= H_LOGIT_REL[bf16]:
        raise AssertionError(f"{label} eval logits: card vs CPU {logit_err}")

    # the CLI on its synthetic stream: the slice's main path
    counters = hengshuang_counters()
    for fn in counters.values():
        fn.launches = 0
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["model=Hengshuang", *(["dtype=bf16"] if bf16 else []), f"synthetic={H_SAMPLES}",
                f"out_dir={out_dir}"]
        with contextlib.redirect_stdout(log):
            best = train_cls.main(argv + [f"epoch={H_EPOCHS}"])
        launches = {k: fn.launches for k, fn in counters.items()}  # the main path ends here
        lines = log.getvalue().splitlines()
        ckpt_dir = os.path.join(out_dir, "Hengshuang", "none", "False", "ckpt")
        saved = sorted(int(s) for s in os.listdir(ckpt_dir) if s.isdigit())
        resume_log = io.StringIO()
        with contextlib.redirect_stdout(resume_log):
            train_cls.main(argv + [f"epoch={H_EPOCHS + 1}"])
        resumed = resume_log.getvalue().splitlines()
    steps = H_EPOCHS * (H_SAMPLES // HB)
    evals = H_EPOCHS * -(-max(H_SAMPLES // 5, 64) // HB)
    want = hengshuang_launches(steps, evals, bf16)
    epoch_lines = [line for line in lines if re.match(r"^Epoch \d+: Train Instance Accuracy", line)]
    test_lines = [line for line in lines if line.startswith("Test Instance Accuracy")]
    resumed_epochs = [line for line in resumed if line.startswith("Epoch ")]
    print(f"{label} CLI (configs/cls.yaml, {' '.join(argv[:-2])}, synthetic={H_SAMPLES}): {steps} "
          f"train steps, {evals} eval batches; {epoch_lines[-1] if epoch_lines else 'no epoch'}"
          f"; {test_lines[-1] if test_lines else 'no eval line'}; best instance accuracy "
          f"{best:f}; checkpoints at epochs {saved}; resume: "
          f"{'Use pretrain model' in resumed}, "
          f"epochs {[ln.split(':')[0] for ln in resumed_epochs]}; launches {launches} "
          f"(want {want})")
    if (len(epoch_lines) != H_EPOCHS or len(test_lines) != H_EPOCHS or not saved
            or lines[-1] != "End of training..."):
        raise AssertionError(f"{label} CLI output: {lines[-8:]}")
    if ("Use pretrain model" not in resumed
            or [ln.split(":")[0] for ln in resumed_epochs]
            != [f"Epoch {e + 1}" for e in range(saved[-1] + 1, H_EPOCHS + 1)]):
        raise AssertionError(f"{label} CLI resume: {resumed[-8:]}")
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches}, want {want}")

    # learnability: the class is a function of the cloud's shape
    lx, ly = learn_clouds((H_LEARN_STEPS + 1) * HB, 12)
    ds = DeviceResidentDataset({"x": lx, "y": ly}, "cuda")
    run = make_scanned_train_steps(hengshuang_trainer(torch, "cuda", dtype), ds)
    idx = ds.put_indices(np.arange((H_LEARN_STEPS + 1) * HB).reshape(H_LEARN_STEPS + 1, HB))
    curve = run(idx[:H_LEARN_STEPS], H_LEARN_LR)["loss"].cpu().numpy()
    first, last = float(curve[:5].mean()), float(curve[-5:].mean())
    print(f"{label} learnability (8 classes by the cloud's axis scales, lr {H_LEARN_LR}, "
          f"{H_LEARN_STEPS} steps at B={HB}): loss {first:.4f} over the first 5 steps -> "
          f"{last:.4f} over the last 5 (ln 8 = {np.log(8):.4f}); curve "
          f"{np.round(curve, 4).tolist()}")
    if not np.isfinite(curve).all() or not last < 0.75 * first:
        raise AssertionError(f"{label} learnability: loss {first} -> {last}")

    recompute = None
    if bf16:  # the recompute pair's path: S3F_VA_RESID=0, two steps at B=64
        previous = os.environ.get("S3F_VA_RESID")
        os.environ["S3F_VA_RESID"] = "0"
        try:
            for fn in counters.values():
                fn.launches = 0
            run = make_scanned_train_steps(hengshuang_trainer(torch, "cuda", dtype), ds)
            rec_losses = run(idx[:2], lr)["loss"].cpu().numpy()
            recompute = {k: fn.launches for k, fn in counters.items()}
        finally:
            if previous is None:
                del os.environ["S3F_VA_RESID"]
            else:
                os.environ["S3F_VA_RESID"] = previous
        rec_want = hengshuang_launches(2, 0, bf16, resid=False)
        print(f"{label} under S3F_VA_RESID=0: 2 steps at B={HB}, losses {rec_losses.tolist()}; "
              f"launches {recompute} (want {rec_want})")
        if recompute != rec_want or not np.isfinite(rec_losses).all():
            raise AssertionError(f"S3F_VA_RESID=0 launches {recompute}, want {rec_want}")

    # train throughput: 5 steps at B=64 from a corpus on the card, host clock
    run = make_scanned_train_steps(hengshuang_trainer(torch, "cuda", dtype), ds)
    timed_steps(torch, run, idx, lr, 5, label, HB)
    return launches, recompute


# the bf16 vector-attention kernels (in-kernel gather by index): (label, B, N,
# K, D, duplicated neighbours); level 0 and level 4 of the bf16 Hengshuang step
# at B=64, the segmentation steps' level 0 (an inverse index over 65,536 rows
# of one batch element at S3DIS's N=4096), an N off every tile, one neighbour,
# 128 neighbours all among three points, a D that is a multiple of 8 but not
# of 128; D=8 and D=136: the tensor-core core's edges (a contraction not a
# multiple of 16, a width not a multiple of 128)
VAG_SHAPES = [("level 0", 64, 1024, 16, 512, False), *SEG_LEVEL0,
              ("level 4 N=4 K=4", 64, 4, 4, 512, False),
              ("N=1000", 2, 1000, 16, 512, False), ("K=1", 2, 300, 1, 512, False),
              ("K=128 duplicates", 2, 256, 128, 512, True), ("D=200 K=12", 3, 77, 12, 200, False),
              ("D=8", 2, 100, 16, 8, False), ("D=136 K=10", 2, 130, 10, 136, False)]
# error over each output's own largest value (bg2's gradient: over max(1, it)):
# both sides take the same bf16 operands and sum in f32 in another order, which
# can round an intermediate (x, hg_pre, a product's gradient operand) or an
# output to the neighbouring bf16 value, 2**-8 of it
VAG_REL = 2e-2
# the residual backward against the recompute backward: u and a are rounded to
# bf16 in the saves (the JAX package's own bound for the pair)
VAG_RESID_REL = 2e-2


def vag_inputs(torch, b, n, kk, d, seed, device, duplicates=False):
    """q, k_all, v_all [B, N, D] bf16, idx [B, N, K] int32 (all among the first
    three points with ``duplicates``), rel [B, N, K, 3] bf16 of unit-sphere
    scale, the eight f32 weights of unit gain."""
    from simple3dformer_tpu_torch.kernels.vector_attention import weight_shapes

    rs = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rs.randn(*shape)).astype(np.float32)).to(device)

    q, k_all, v_all = (t(b, n, d).bfloat16() for _ in range(3))
    hi = min(3, n) if duplicates else n
    idx = torch.from_numpy(rs.randint(0, hi, (b, n, kk)).astype(np.int32)).to(device)
    rel = t(b, n, kk, 3, scale=0.1).bfloat16()
    w = {name: t(*shape, scale=shape[1] ** -0.5 if len(shape) == 2 else 0.1)
         for name, shape in weight_shapes(d).items()}
    return q, k_all, v_all, idx, rel, w


def vag_flat(grads) -> dict:
    gq, gk, gv, grel, gw = grads
    return {"gq": gq, "gk_all": gk, "gv_all": gv, "grel": grel, **gw}


def vag_check(torch, b, n, kk, d, dup, seed, device="cuda") -> dict:
    """The four bf16 kernels on one input against their plain versions (the
    residual backward fed the kernel's own saves, the recompute backward's
    plain chain the kernel forward's x and hg_pre: each ReLU of hg_pre on the
    kernel's side of zero), each run twice, the residual backward against the
    recompute backward; reported, the recompute backward against a wholly
    plain chain and its hg_pre signs that differ from the kernel's. Returns the
    inputs, the kernels' outputs, the errors by check and output, the
    bit-equality of the reruns and whether every check held."""
    from simple3dformer_tpu_torch.kernels import vector_attention as va

    inputs = vag_inputs(torch, b, n, kk, d, seed, device, dup)
    idx, rel, w = inputs[3:]
    g = torch.randn(b, n, d, generator=torch.Generator(device).manual_seed(seed),
                    device=device).bfloat16()
    out, out_again = (va.gather_attention_fwd(*inputs) for _ in range(2))
    out_res, saves = va.gather_attention_resid_fwd(*inputs)
    out_res2, saves2 = va.gather_attention_resid_fwd(*inputs)
    torch.cuda.synchronize()
    same = {"forwards": torch.equal(out, out_res), "forward twice": torch.equal(out, out_again),
            "residual forward twice": (torch.equal(out_res, out_res2)
                                       and all(torch.equal(saves[k], saves2[k]) for k in saves))}
    del out_again, out_res2, saves2
    rec = [vag_flat(va.gather_attention_bwd(*inputs, g)) for _ in range(2)]
    res = [vag_flat(va.gather_attention_resid_bwd(idx, rel, w, saves, g)) for _ in range(2)]
    torch.cuda.synchronize()
    same |= {"recompute backward": all(torch.equal(rec[0][k], rec[1][k]) for k in rec[0]),
             "residual backward": all(torch.equal(res[0][k], res[1][k]) for k in res[0])}
    rec, res = rec[0], res[0]

    def errs(got, want):
        # an output that is zero throughout (at K=1 the softmax passes no gradient) is held to 0
        return {k: (va_err(k, got[k].float(), want[k].float()) if bool(want[k].any())
                    else float(got[k].float().abs().max())) for k in want}

    def abs_err(got, want):
        return max(float((got[k].float() - want[k].float()).abs().max()) for k in want)

    want_out, want_saves = va.gather_attention_resid_reference(*inputs)
    err = {"fwd": errs({"out": out}, {"out": want_out}),
           "resid_fwd": errs({"out": out_res, **saves}, {"out": want_out, **want_saves})}
    absolute = {"fwd": abs_err({"out": out}, {"out": want_out}),
                "resid_fwd": abs_err({"out": out_res, **saves}, {"out": want_out, **want_saves})}
    flips = int(((saves["hg"] > 0) != (want_saves["hg"] > 0)).sum())
    del want_saves
    want = vag_flat(va.gather_attention_backward_reference(*inputs, g, state=saves))
    err["bwd"], absolute["bwd"] = errs(rec, want), abs_err(rec, want)
    del want
    want = vag_flat(va.gather_attention_backward_reference(*inputs, g))
    recomputed = errs(rec, want)
    del want
    want = vag_flat(va.gather_attention_resid_backward_reference(idx, rel, w, saves, g))
    err["resid_bwd"], absolute["resid_bwd"] = errs(res, want), abs_err(res, want)
    del want
    err["resid vs recompute"] = errs(res, rec)
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out, *saves.values(), *rec.values(), *res.values()))
    worst = {k: max(v.values()) for k, v in err.items()}
    limit = {k: VAG_RESID_REL if k == "resid vs recompute" else VAG_REL for k in err}
    ok = all(worst[k] <= limit[k] for k in err) and all(same.values()) and finite
    return dict(inputs=inputs, g=g, out=out, saves=saves, rec=rec, res=res, err=err,
                abs=absolute, worst=worst, same=same, finite=finite, ok=ok,
                recomputed=recomputed, flips=flips)


def phase_vag_kernels(torch):
    """The bf16 vector-attention kernels against their plain versions at the bf16
    Hengshuang step's shapes and the edge shapes; times of kernel and plain
    version at level 0 (no PyTorch call computes the chain)."""
    from simple3dformer_tpu_torch.kernels import vector_attention as va

    report = {}
    for label, b, n, kk, d, dup in VAG_SHAPES:
        r = vag_check(torch, b, n, kk, d, dup, seed=b * n + kk + d)
        worst = ", ".join(f"{k} {v:.3e} ({max(r['err'][k], key=r['err'][k].get)})"
                          for k, v in r["worst"].items())
        far = max(r["recomputed"], key=r["recomputed"].get)
        print(f"kernel vector_attention bf16 {label} B={b} N={n} K={kk} D={d}: error relative "
              f"to each output's largest value (bg2's gradient: max(1, it)): {worst} "
              f"(tolerance {VAG_REL}, resid vs recompute {VAG_RESID_REL}); bit-equal "
              f"{r['same']}; finite {r['finite']}; the recompute backward against a wholly "
              f"plain chain {r['recomputed'][far]:.3e} ({far}), {r['flips']} of "
              f"{r['saves']['hg'].numel()} hg_pre on the other side of zero there")
        if not r["ok"]:
            raise AssertionError(f"bf16 vector attention {label}: {r['err']}, {r['same']}, "
                                 f"finite {r['finite']}")
        if label == "level 0":
            inputs, g, saves, rec, res = r["inputs"], r["g"], r["saves"], r["rec"], r["res"]
            idx, rel, w = inputs[3:]
            ops = va.flops(b, n, kk, d)
            outs = {"gq": rec["gq"], "gk": rec["gk_all"], "gv": rec["gv_all"],
                    "grel": rec["grel"], **{k: rec[k] for k in va.WNAMES}}
            cases = [
                ("vector_attention_gather_fwd", lambda: va.gather_attention_fwd(*inputs),
                 lambda: va.gather_attention_reference(*inputs), nbytes(*inputs, r["out"]), ops),
                ("vector_attention_resid_fwd", lambda: va.gather_attention_resid_fwd(*inputs),
                 lambda: va.gather_attention_resid_reference(*inputs),
                 nbytes(*inputs, r["out"], saves), ops),
                ("vector_attention_gather_bwd", lambda: va.gather_attention_bwd(*inputs, g),
                 lambda: va.gather_attention_backward_reference(*inputs, g),
                 nbytes(*inputs, g, outs), 3 * ops),
                ("vector_attention_resid_bwd",
                 lambda: va.gather_attention_resid_bwd(idx, rel, w, saves, g),
                 lambda: va.gather_attention_resid_backward_reference(idx, rel, w, saves, g),
                 nbytes(idx, rel, w, saves, g, outs), 2 * ops)]
            for (name, kernel, plain, moved, work), key in zip(
                    cases, ("fwd", "resid_fwd", "bwd", "resid_bwd")):
                times = timed(torch, kernel, plain, iters=5)
                report[name] = point_report(name, r["abs"][key], times, moved, work, "", iters=5,
                                            peak=PEAK_BF16)
                parts = {"fwd": ("forward",), "resid_fwd": ("forward",),
                         "bwd": ("forward", "backward"), "resid_bwd": ("backward",)}[key]
                gemm_split(torch, kernel, b, n, kk, d, f"kernel {name} level 0", "bf16", parts)
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            print(f"vector_attention bf16 level 0: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (kernels and plain "
                  "versions, the saves kept)")
        del r
        torch.cuda.empty_cache()
    return report


def phase_attention_route(torch):
    """Attention outside the mhsa kernels' gate on the card: a ViT block at 2049
    tokens (deit_base width, 3 heads) takes the layered route with the plain
    attention, counted, and matches the CPU's plain path, forward and gradients."""
    from simple3dformer_tpu_torch.kernels import mhsa as mk
    from simple3dformer_tpu_torch.nn.layers import Attention, Block

    torch.manual_seed(0)
    blk = Block(768, 3)
    cuda_blk = copy.deepcopy(blk).cuda()
    x = torch.randn(1, 2049, 768)
    route, why = cuda_blk.route(x), cuda_blk.attn.kernel_unsupported(x)
    before = (Attention.plain_calls, mk.mhsa_fwd.launches, mk.mhsa_bwd.launches)
    out = cuda_blk(x.cuda())
    got = torch.autograd.grad(out.square().sum(), list(cuda_blk.parameters()))
    torch.cuda.synchronize()
    after = (Attention.plain_calls, mk.mhsa_fwd.launches, mk.mhsa_bwd.launches)
    want_out = blk(x)
    want = torch.autograd.grad(want_out.square().sum(), list(blk.parameters()))
    out, want_out = out.detach(), want_out.detach()
    out_err = float((out.cpu() - want_out).abs().max()) / float(want_out.abs().max())
    grad_err = max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(got, want))
    print(f"attention outside the mhsa gate: Block(768, 3) at N=2049 on the card: route {route} "
          f"({why}); plain attention calls {after[0] - before[0]}, mhsa launches "
          f"{after[1] - before[1]} forward, {after[2] - before[2]} backward; against the CPU: "
          f"output {out_err:.3e}, gradients {grad_err:.3e} of each one's largest value "
          "(tolerance 1e-3)")
    if (route != "layered" or after != (before[0] + 1, before[1], before[2])
            or out_err > 1e-3 or grad_err > 1e-3):
        raise AssertionError("attention outside the mhsa gate")


# ---- the point CLIs with every model in f32 and bf16, and the flagship at bf16 ----

def run_cli(main, argv_for, counters, after=None):
    """Run a CLI, ``main(argv_for(out_dir))`` with a fresh output directory, its
    stdout captured and the launch counters set to 0 just before it; -> (its
    return value, its lines, the launches, the epochs of the checkpoints it
    saved). ``after(out_dir)`` runs before the directory goes."""
    import contextlib
    import io
    import os
    import tempfile

    for fn in counters.values():
        fn.launches = 0
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as out_dir:
        with contextlib.redirect_stdout(log):
            result = main(argv_for(out_dir))
        launches = {k: fn.launches for k, fn in counters.items()}  # the main path ends here
        saved = sorted(int(s) for d, _, _ in os.walk(out_dir) if d.endswith("ckpt")
                       for s in os.listdir(d) if s.isdigit())
        if after is not None:
            after(out_dir)
    return result, log.getvalue().splitlines(), launches, saved


def timed_steps(torch, run, idx, lr, n_steps, label, batch, n_profile=3, **kinds):
    """ms a train step (host clock over ``n_steps`` after a warm-up step, ending
    in a sync, corpus on the card), printed with samples/s and the peak device
    memory; then the per-kernel profile of ``n_profile`` steps (``kinds``: the
    profile's groups and categories)."""
    torch.cuda.reset_peak_memory_stats()
    run(idx[:1], lr)  # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(run(idx[1:n_steps + 1], lr)["loss"][-1])
    dt = time.perf_counter() - t0
    ms_step = dt / n_steps * 1e3
    print(f"{label} training throughput: {ms_step:.3f} ms per step, {n_steps * batch / dt:.2f} "
          f"samples/s at B={batch} (host clock over {n_steps} steps, corpus on the card); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_steps(torch, run, idx[1:n_profile + 1], ms_step, f"{label} training", lr, **kinds)
    return ms_step


# ScanObjectNN (BASELINE.json's fourth config, configs/cls_scanobjectnn.yaml:
# 3DViT on deit_tiny, 1024 points of xyz, 15 classes, batch 64, SGD)
SO_B, SO_SAMPLES, SO_EPOCHS = 64, 256, 2  # 4 train steps and 1 eval batch an epoch


def phase_scanobjectnn(torch):
    """The ScanObjectNN CLI on its synthetic streams at full width: its epoch
    lines, a checkpoint, and the launch counts of every kernel of the path."""
    from simple3dformer_tpu_torch.cli import train_cls_scanobjectnn as so

    best, lines, launches, saved = run_cli(
        so.main, lambda d: [f"synthetic={SO_SAMPLES}", f"epoch={SO_EPOCHS}", f"out_dir={d}"],
        point_counters())
    steps = SO_EPOCHS * (SO_SAMPLES // SO_B)
    evals = SO_EPOCHS * -(-max(SO_SAMPLES // 5, 64) // SO_B)
    # the 3DViT model's path, as partseg's: FPS 1, kNN 4, gathers 8 a forward,
    # 4 gather backwards and 12 block pairs a step, 12 forward blocks an eval
    want = {"fps": steps + evals, "knn": 4 * (steps + evals), "gather_fwd": 8 * (steps + evals),
            "gather_bwd": 4 * steps, "fused_vit_block_train_fwd": 12 * steps,
            "fused_vit_block_train_bwd": 12 * steps, "fused_vit_block": 12 * evals}
    epochs = [line for line in lines if re.match(
        r"^Epoch \d+ Test Instance Accuracy: \d\.\d{6}, Class Accuracy: \d\.\d{6} \(", line)]
    print(f"ScanObjectNN CLI (configs/cls_scanobjectnn.yaml, synthetic={SO_SAMPLES}, "
          f"B={SO_B}): {steps} train steps, {evals} eval batches; {lines[-1]}; epoch lines "
          f"{epochs}; checkpoints at epochs {saved}; launches {launches} (want {want})")
    if len(epochs) != SO_EPOCHS or not saved or lines[-1] != f"Best Instance Accuracy: {best:f}":
        raise AssertionError(f"ScanObjectNN CLI output: {lines[-6:]}")
    if launches != want:
        raise AssertionError(f"ScanObjectNN launch counts {launches}, want {want}")
    return launches


# Hengshuang segmentation (configs/model/Hengshuang.yaml: transformer_dim 512, 4
# blocks, 16 neighbours) through the partseg CLI (B=16, N=1024, 22 inputs, 50
# parts, lr 0.05) and the S3DIS CLI (B=4, N=4096, 9 inputs, 13 classes, lr 0.5):
# level 0 is R = B N K = 262,144 rows in both
HSEG = {"partseg": dict(task="partseg", b=16, n=1024, in_dim=22, classes=50, parity_b=2,
                        samples=32),
        "s3dis": dict(task="semseg", b=4, n=4096, in_dim=9, classes=13, parity_b=1, samples=8)}
# the card-vs-CPU steps of the S3DIS-shaped segmentation models (N=4096):
# 2, not 3 (20-30 s of the CPU a run at 3: the depth given up for phase 26)
S3DIS_SEG_PARITY_STEPS = 2


def hseg_launches(steps, evals, bf16) -> dict:
    """The launches of PointTransformerSeg's ``steps`` train steps and ``evals``
    eval batches: per forward 10 vector-attention blocks (transformer1, four
    transformers, transformer2, four up-transformers; a kNN and the xyz gather
    each, in f32 also the k and v gathers), 4 transition-downs (FPS, a kNN, 3
    gathers) and 4 transition-ups (a 3-NN, the features' gather); per backward
    the feature gather of each transition, in f32 also the k and v gathers of
    each block. The vector-attention kernels: in f32 the pre-gathered pair; in
    bf16 the residual-saving pair in training, the forward in eval."""
    fwd = steps + evals
    want = dict.fromkeys(hengshuang_counters(), 0)
    want.update(fps=4 * fwd, knn=18 * fwd, gather_fwd=(26 if bf16 else 46) * fwd,
                gather_bwd=(8 if bf16 else 28) * steps)
    if bf16:
        want.update(vector_attention_gather_fwd=10 * evals,
                    vector_attention_resid_fwd=10 * steps, vector_attention_resid_bwd=10 * steps)
    else:
        want.update(vector_attention_fwd=10 * fwd, vector_attention_bwd=10 * steps)
    return want


def seg_config(task, **overrides):
    from simple3dformer_tpu_torch.core.config import load_task_config

    return load_task_config(task, [f"{k}={v}" for k, v in overrides.items()])


def seg_trainer(torch, cfg, num_class, in_dim, device, dtype=None, depth=None):
    """A segmentation model of ``cfg`` with SGD; ``depth``: a 3DViT's first blocks only."""
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.registry import make_point_model
    from simple3dformer_tpu_torch.train.loop import TrainState
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    cfg.num_class, cfg.input_dim = num_class, in_dim
    model = make_point_model(cfg, "seg", dtype=dtype, generator=generator(DEFAULT_SEED))
    model = model.to(device)
    if depth is not None:
        model.blocks = model.blocks[:depth]
    return TrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"))


def seg_arrays(task, n_samples, seed=9):
    """(x [S, N, C], y [S, N]) of the CLI's synthetic stream, the partseg one-hot
    already joined (prepare), as numpy."""
    from simple3dformer_tpu_torch.cli import train_partseg as tp
    from simple3dformer_tpu_torch.cli import train_s3dis_semseg as ts

    if task == "partseg":
        (xs, cats, segs), _ = tp.load_arrays(seg_config("partseg", synthetic=n_samples,
                                                        seed=seed))
        onehot = np.eye(tp.NUM_CATEGORY, dtype=np.float32)[cats]
        x = np.concatenate([xs, np.broadcast_to(onehot[:, None], (*xs.shape[:2],
                                                                  tp.NUM_CATEGORY))], -1)
        return np.ascontiguousarray(x), segs
    (xs, ys), _ = ts.load_arrays(seg_config("semseg", synthetic=n_samples, seed=seed))
    return xs, ys


# card vs CPU, as the cls phases: f32 sums in another order; bf16 intermediates
# rounding f32 sums taken in another order
SEG_LOSS_RTOL = {False: 1e-3, True: 2e-3}


def seg_parity(torch, label, make_state, xs, ys, parity_b, lr, bf16, steps=3):
    """``steps`` train steps on the card and on the CPU's plain path from the
    same weights and batches; the losses within SEG_LOSS_RTOL."""
    from simple3dformer_tpu_torch.train.loop import make_train_step, seg_cross_entropy

    losses, seconds = {}, {}
    for device in ("cuda", "cpu"):
        step = make_train_step(make_state(device), seg_cross_entropy)
        t0 = time.perf_counter()
        losses[device] = [float(step({"x": torch.from_numpy(xs[i * parity_b:(i + 1) * parity_b])
                                      .to(device),
                                      "y": torch.from_numpy(ys[i * parity_b:(i + 1) * parity_b])
                                      .to(device)}, lr)["loss"]) for i in range(steps)]
        seconds[device] = time.perf_counter() - t0
    print(f"{label}: {steps} steps at B={parity_b}, lr {lr}: losses on the card {losses['cuda']} "
          f"vs the "
          f"CPU's plain path {losses['cpu']} (rtol {SEG_LOSS_RTOL[bf16]}); "
          f"{seconds['cuda']:.1f} s on the card, {seconds['cpu']:.1f} s on the CPU")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=SEG_LOSS_RTOL[bf16])


def phase_hengshuang_seg(torch, which, bf16=False):
    """PointTransformerSeg at full width through the partseg or the S3DIS CLI, in
    f32 or at dtype=bf16: 3 steps card vs CPU, the CLI with the launch counts
    of every kernel of the path, ms a step and its profile. Returns the CLI's
    launch counts."""
    from simple3dformer_tpu_torch.cli import train_partseg as tp
    from simple3dformer_tpu_torch.cli import train_s3dis_semseg as ts
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.train.loop import make_scanned_train_steps, seg_cross_entropy

    s = HSEG[which]
    dtype = torch.bfloat16 if bf16 else None
    label = f"Hengshuang {which}{' bf16' if bf16 else ''}"
    lr = float(seg_config(s["task"], model="Hengshuang").learning_rate)

    def make_state(device, cfg_task=s["task"]):
        return seg_trainer(torch, seg_config(cfg_task, model="Hengshuang"), s["classes"],
                           s["in_dim"], device, dtype)

    xs, ys = seg_arrays(which, 3 * s["parity_b"])
    seg_parity(torch, label, make_state, xs, ys, s["parity_b"], lr, bf16,
               S3DIS_SEG_PARITY_STEPS if which == "s3dis" else 3)

    main = tp.main if which == "partseg" else ts.main
    argv = ["model=Hengshuang", *(["dtype=bf16"] if bf16 else []), f"synthetic={s['samples']}",
            f"batch_size={s['b']}", "epoch=1"]
    _, lines, launches, saved = run_cli(main, lambda d: [*argv, f"out_dir={d}"],
                                        hengshuang_counters())
    steps = s["samples"] // s["b"]
    n_test = max(s["samples"] // 5, 32 if which == "partseg" else 16)
    evals = -(-n_test // s["b"])
    want = hseg_launches(steps, evals, bf16)
    losses = [float(line.split(" loss ")[1].split()[0]) for line in lines
              if line.startswith("Epoch ") and " loss " in line]
    per_step = {k: v for k, v in hseg_launches(1, 0, bf16).items() if v}
    print(f"{label} CLI ({' '.join(argv)}, B={s['b']}, N={s['n']}): {steps} train steps, "
          f"{evals} eval batches; losses {losses}; {lines[-1]}; checkpoints at epochs {saved}; "
          f"launches {launches} (want {want}; a train step: {per_step})")
    if len(losses) != 1 or not np.isfinite(losses).all() or not saved:
        raise AssertionError(f"{label} CLI output: {lines[-6:]}")
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches}, want {want}")

    n_steps = 5
    xs, ys = seg_arrays(which, (n_steps + 1) * s["b"], seed=12)
    ds = DeviceResidentDataset({"x": xs, "y": ys}, "cuda")
    run = make_scanned_train_steps(make_state("cuda"), ds, seg_cross_entropy)
    idx = ds.put_indices(np.arange((n_steps + 1) * s["b"]).reshape(n_steps + 1, s["b"]))
    timed_steps(torch, run, idx, lr, n_steps, label, s["b"])
    return launches


def block_cdt_check(torch, b, n, d, heads, x_dtype, cdt, seed=0, device="cuda"):
    """The fused block kernels with x in ``x_dtype`` and matmuls in ``cdt`` (the
    bf16 3DViT's f32 residual stream at bf16 compute) against their plain
    versions: the forward, the training forward's residuals and both
    backwards, errors over each output's largest value; the training forward
    and each backward twice bit-equal. -> (errors, bit-equal)."""
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    x, w = block_inputs(torch, b, n, d, x_dtype, seed, device)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(b, n, d).astype(np.float32))
    g = g.to(device=device, dtype=x_dtype)
    out = vb.fused_vit_block(x, w, heads, cdt)
    y, res = vb.fused_vit_block_train_fwd(x, w, heads, cdt)
    y2, res2 = vb.fused_vit_block_train_fwd(x, w, heads, cdt)
    y_ref, res_ref = vb.vit_block_train_reference(x, w, heads, cdt)
    gx, gw = vb.fused_vit_block_train_bwd(x, g, w, heads, cdt, residuals=res)
    gx2, gw2 = vb.fused_vit_block_train_bwd(x, g, w, heads, cdt, residuals=res)
    want_x, want_w = vb.vit_block_backward_reference(x, g, w, heads, cdt, residuals=res)
    cx, cw = vb.fused_vit_block_bwd(x, g, w, heads, cdt)
    cx2, cw2 = vb.fused_vit_block_bwd(x, g, w, heads, cdt)
    rec_x, rec_w = vb.vit_block_backward_reference(x, g, w, heads, cdt)
    torch.cuda.synchronize()
    errs = {"fwd": errors({"y": out}, {"y": vb.vit_block_reference(x, w, heads, cdt)})[1],
            "train_fwd": errors({"y": y, **res}, {"y": y_ref, **res_ref})[1],
            "bwd_res": errors({"gx": gx, **gw}, {"gx": want_x, **want_w})[1],
            "bwd": errors({"gx": cx, **cw}, {"gx": rec_x, **rec_w})[1]}
    same = all(torch.equal(a, c) for a, c in [(y, y2), (gx, gx2), (cx, cx2)]
               + [(res[k], res2[k]) for k in res]
               + [(gw[k], gw2[k]) for k in gw] + [(cw[k], cw2[k]) for k in cw])
    if not (out.dtype == y.dtype == gx.dtype == x_dtype):
        raise AssertionError(f"block kernels at x {x_dtype}: outputs {out.dtype}, {gx.dtype}")
    return errs, same


def sdpa_device_ms(torch, b, n, h, dh, dtype):
    """{backend: device ms of one scaled_dot_product_attention forward and
    backward} at [B, H, N, dh], for each backend that takes the call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, g = (t.transpose(1, 2).contiguous() for t in mhsa_inputs(torch, b, n, h, dh, dtype,
                                                                         5, "cuda"))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = {}
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION"):
        with sdpa_kernel(getattr(SDPBackend, name)):
            def step():
                y = F.scaled_dot_product_attention(*leaves, scale=dh ** -0.5)
                torch.autograd.grad(y, leaves, g)
            try:
                step()
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            split = device_split(torch, step)
            out[name] = sum(ms for ms, _ in split.values())
    return out


def phase_point_vit_bf16(torch):
    """The 3DViT point models at dtype=bf16 (parameters, gradients and SGD f32):
    the fused block kernels at the partseg shape with an f32 residual stream
    and bf16 matmuls against their plain versions; partseg (deit_tiny, 257
    tokens: the fused block kernels in bf16) and S3DIS (deit_base, 3 heads,
    1025 tokens: the layered route with the mhsa kernels on bf16 q, k, v):
    3 steps card vs CPU, the CLI with the launch counts (the bf16 kernels
    launched, no plain attention), ms a step; at S3DIS the device time of the
    mhsa kernels a call beside scaled_dot_product_attention's."""
    from simple3dformer_tpu_torch.cli import train_partseg as tp
    from simple3dformer_tpu_torch.cli import train_s3dis_semseg as ts
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.nn.layers import Attention
    from simple3dformer_tpu_torch.train.loop import make_scanned_train_steps, seg_cross_entropy

    errs, same = block_cdt_check(torch, PB, 257, 192, 3, torch.float32, torch.bfloat16)
    print(f"kernel fused block partseg N=257 x f32, bf16 matmuls: error relative to the largest "
          f"value {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tolerance "
          f"{GRAD_REL['bfloat16']}); two runs of the training forward and of each backward "
          f"bit-equal {same}")
    if max(errs.values()) > GRAD_REL["bfloat16"] or not same:
        raise AssertionError(f"block kernels at bf16 compute on f32 x: {errs}, bit-equal {same}")

    out = {}
    for which, task, classes, in_dim, b, n, parity_b, samples in (
            ("partseg", "partseg", 50, 22, PB, PN, 4, 32),
            ("S3DIS", "semseg", 13, 9, SB, SN, 1, 8)):
        label = f"3DViT {which} bf16"
        lr = float(seg_config(task).learning_rate)

        def make_state(device, task=task, classes=classes, in_dim=in_dim, depth=None):
            return seg_trainer(torch, seg_config(task), classes, in_dim, device, torch.bfloat16,
                               depth)

        xs, ys = seg_arrays(which.lower(), 3 * parity_b)
        if which == "S3DIS":  # 4 of the 12 blocks, as phase 10's steps
            seg_parity(torch, f"{label} ({S3DIS_PARITY_DEPTH} of the 12 blocks)",
                       lambda device: make_state(device, depth=S3DIS_PARITY_DEPTH), xs, ys,
                       parity_b, lr, True, S3DIS_SEG_PARITY_STEPS)
        else:
            seg_parity(torch, label, make_state, xs, ys, parity_b, lr, True)
        plain_before = Attention.plain_calls
        _, lines, launches, saved = run_cli(
            tp.main if which == "partseg" else ts.main,
            lambda d, b=b, samples=samples: ["dtype=bf16", f"synthetic={samples}",
                                             f"batch_size={b}", "epoch=1", f"out_dir={d}"],
            s3dis_counters())
        plain = Attention.plain_calls - plain_before
        steps = samples // b
        evals = -(-max(samples // 5, 32 if which == "partseg" else 16) // b)
        fwd = steps + evals
        want = {"fps": fwd, "knn": 4 * fwd, "gather_fwd": 8 * fwd, "gather_bwd": 4 * steps,
                "fused_vit_block_train_fwd": 0, "fused_vit_block_train_bwd": 0,
                "fused_vit_block": 0, "fused_vit_block_bwd": 0, "mhsa_fwd": 0, "mhsa_bwd": 0}
        if which == "partseg":
            want.update(fused_vit_block_train_fwd=12 * steps, fused_vit_block_train_bwd=12 * steps,
                        fused_vit_block=12 * evals)
        else:
            want.update(mhsa_fwd=12 * fwd, mhsa_bwd=12 * steps)
        print(f"{label} CLI (dtype=bf16, synthetic={samples}, B={b}): {steps} train steps, "
              f"{evals} eval batches; {lines[-1]}; checkpoints at epochs {saved}; launches "
              f"{launches} (want {want}; every launch at bf16 compute); plain attention calls "
              f"{plain}")
        if launches != want or plain or not saved:
            raise AssertionError(f"{label}: launches {launches}, plain attention calls {plain}")
        n_steps = 5
        xs, ys = seg_arrays(which.lower(), (n_steps + 1) * b, seed=12)
        ds = DeviceResidentDataset({"x": xs, "y": ys}, "cuda")
        run = make_scanned_train_steps(make_state("cuda"), ds, seg_cross_entropy)
        idx = ds.put_indices(np.arange((n_steps + 1) * b).reshape(n_steps + 1, b))
        out[which] = timed_steps(torch, run, idx, lr, n_steps, label, b)
        del ds, run

    # the S3DIS attention at bf16: the mhsa kernels against SDPA, device time a call
    from simple3dformer_tpu_torch.kernels.mhsa import mhsa_bwd, mhsa_fwd

    q, k, v, g = mhsa_inputs(torch, SB, 1025, 3, 256, torch.bfloat16, 5, "cuda")
    split = device_split(torch, lambda: mhsa_bwd(q, k, v, g, 256 ** -0.5,
                                                 *mhsa_fwd(q, k, v, 256 ** -0.5)[::-1]))
    ours = sum(ms for ms, _ in split.values())
    lib = sdpa_device_ms(torch, SB, 1025, 3, 256, torch.bfloat16)
    best = min(lib.items(), key=lambda kv: kv[1]) if lib else ("none", float("nan"))
    print(f"mhsa at bf16 on the S3DIS step's shape (B={SB}, N=1025, H=3, dh=256): forward and "
          f"backward {ours:.4f} ms device time a call ({split_text(split)}); "
          f"scaled_dot_product_attention forward and backward by backend: "
          + ", ".join(f"{k} {v:.4f}" for k, v in lib.items())
          + f"; {ours / best[1]:.2f}x the fastest ({best[0]}); 12 calls a step")

    # the S3DIS MLP's GELU at bf16: jax.nn.gelu's steps each rounded to bf16, as
    # the JAX package computes them (the port's), against PyTorch's one op
    import torch.nn.functional as F
    from simple3dformer_tpu_torch.nn.layers import gelu_tanh

    a = torch.randn(SB, 1025, 3072, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6)).bfloat16().requires_grad_()
    ga = torch.randn_like(a)
    steps_ms, one_ms, _ = timed(
        torch, lambda: torch.autograd.grad(gelu_tanh(a), a, ga),
        lambda: torch.autograd.grad(F.gelu(a, approximate="tanh"), a, ga), iters=20)
    print(f"GELU at bf16 on the S3DIS MLP's shape [{SB}, 1025, 3072], forward and backward "
          f"(CUDA events): jax.nn.gelu's steps each rounded (the port's) {steps_ms:.4f} ms, "
          f"PyTorch's one op {one_ms:.4f} ms a call; 12 calls a step: {12 * steps_ms:.3f} "
          f"and {12 * one_ms:.3f} ms of the {out['S3DIS']:.3f} ms step")
    return out


def voxel_counters():
    from simple3dformer_tpu_torch.kernels import vit_block as vb
    from simple3dformer_tpu_torch.kernels.adam import fused_adam

    return {fn.__name__: fn for fn in (vb.fused_vit_block, vb.fused_vit_block_bwd,
                                       vb.fused_vit_block_train_fwd, vb.fused_vit_block_train_bwd,
                                       fused_adam)}


def voxel_launches(passes, steps, evals, adam) -> dict:
    """A voxel model's launches: ``passes`` core passes of 12 blocks a forward,
    the training pair in a train step, the forward in an eval batch; the
    Adam kernel once a step where ``adam`` (f32 nu)."""
    return {"fused_vit_block": 12 * passes * evals, "fused_vit_block_bwd": 0,
            "fused_vit_block_train_fwd": 12 * passes * steps,
            "fused_vit_block_train_bwd": 12 * passes * steps,
            "fused_adam": steps if adam else 0}


def phase_flagship_bf16(torch):
    """The flagship at --dtype bf16 with Adam's second moment in bf16 (the JAX
    trainer's --bf16-nu auto): the CLI on a synthetic corpus on the card (its
    loss falls over 40 steps; the bf16 fused block kernels' launch counts; the
    update is the plain bf16-nu Adam, so no Adam kernel launch), and ms a step
    beside bf16 with f32 nu and the f32 step at B=32."""
    from simple3dformer_tpu_torch.cli import train_cls_voxel
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT, frozen_mask
    from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
    from simple3dformer_tpu_torch.train.loop import TrainState, make_scanned_train_steps
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    counters = voxel_counters()
    argv = ["--dataset", "ModelNet40", "--synthetic", str(TRAIN_SAMPLES), "--epochs",
            str(TRAIN_EPOCHS), "--batchSize", str(BATCH), "--lr", str(TRAIN_LR),
            "--transformer-name", BACKBONE, "--cell-size", str(CELL), "--patch-size", str(PATCH),
            "--dtype", "bf16"]
    _, lines, launches, saved = run_cli(train_cls_voxel.main, lambda d: [*argv, "--outf", d],
                                        counters)
    steps = TRAIN_EPOCHS * (TRAIN_SAMPLES // BATCH)
    evals = TRAIN_EPOCHS * -(-max(TRAIN_SAMPLES // 5, BATCH) // BATCH)
    epoch_losses = [float(line.split()[3]) for line in lines if line.startswith("Epoch ")]
    want = voxel_launches(1, steps, evals, adam=False)
    print(f"flagship bf16 CLI (--dtype bf16, --bf16-nu auto): {steps} steps, epoch losses "
          f"{epoch_losses[0]:.4f} -> {epoch_losses[-1]:.4f}; checkpoints at epochs {saved}; "
          f"launches {launches} (want {want})")
    if len(epoch_losses) != TRAIN_EPOCHS or not epoch_losses[-1] < 0.75 * epoch_losses[0]:
        raise AssertionError(f"flagship bf16 training loss did not fall: {epoch_losses}")
    if launches != want or not saved:
        raise AssertionError(f"flagship bf16 launch counts {launches}, want {want}")

    corpus, clabels = synthetic_voxels(21 * BATCH, VOXEL, N_CLASSES, seed=DEFAULT_SEED + 3)
    ds = DeviceResidentDataset({"x": corpus, "y": clabels}, "cuda")
    idx = ds.put_indices(np.arange(21 * BATCH).reshape(21, BATCH))
    ms = {}
    for name, dtype, bf16_nu in (("f32", None, False), ("bf16", torch.bfloat16, True),
                                 ("bf16 f32 nu", torch.bfloat16, False),
                                 ("f32 again", None, False)):
        g = generator(DEFAULT_SEED)
        emb = VoxelEmbed(voxel_size=VOXEL, cell_size=CELL, patch_size=PATCH, embed_dim=384,
                         generator=g, dtype=dtype)
        model = VoxelViT(emb, n_classes=N_CLASSES, transformer_backbone=BACKBONE, generator=g,
                         dtype=dtype).cuda()
        opt = make_optimizer(dict(model.named_parameters()), "Adam",
                             trainable_mask=frozen_mask(model, False), bf16_nu=bf16_nu)
        run = make_scanned_train_steps(TrainState(model, opt), ds)
        run(idx[:1], 1e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(run(idx[1:], 1e-4)["loss"][-1])
        ms[name] = (time.perf_counter() - t0) / 20 * 1e3
        if name == "bf16":
            profile_steps(torch, run, idx[1:11], ms[name], "flagship bf16 training", 1e-4)
    print(f"flagship train step at B={BATCH} (host clock over 20 steps, corpus on the card): "
          f"bf16 with bf16 nu {ms['bf16']:.3f} ms ({BATCH / ms['bf16'] * 1e3:.1f} "
          f"samples/s), bf16 with f32 nu (the Adam kernel) {ms['bf16 f32 nu']:.3f} ms, beside "
          f"f32 {ms['f32']:.3f} and {ms['f32 again']:.3f} ms")
    return launches


# LwF: BASELINE.json's fifth config (configs/partseg_lwf.yaml: 3DViT_1_layer on
# deit_small, pretrained, B=32, N=1024 with normals, M=64 images a step on a
# 256^2 canvas, lambda 0.1, SGD at the CLI's base lr 0.01) and the flagship's
# train_cls_voxel --lwf --pretrained (a deit_base teacher with 12 heads, M = B)
LWF_B, LWF_M = 32, 64
LWF_PARITY_B, LWF_PARITY_M = 8, 16  # the card-vs-CPU steps: full width, a batch the CPU finishes
LWF_SAMPLES, LWF_EPOCHS = 64, 20  # 2 steps an epoch at B=32: 40 steps
# the fused block at the LwF paths' new shapes: (label, B, N, D, heads, dtype name):
# the deit_small teacher and student image pass, the deit_base teacher, and
# 3DViT_LWF's student (deit_base with 3 heads) on images and on its 65 point tokens
LWF_BLOCK_SHAPES = [("LwF deit_small N=197", 64, 197, 384, 6, "float32"),
                    ("LwF deit_base teacher N=197", 64, 197, 768, 12, "float32"),
                    ("3DViT_LWF images N=197", 64, 197, 768, 3, "float32"),
                    ("3DViT_LWF points N=65", 32, 65, 768, 3, "float32")]
LWF_TIMED = ("LwF deit_small N=197", "LwF deit_base teacher N=197")
# the student's block calls at dtype=bf16 (bf16 matmuls; the image stream bf16,
# the point stream f32 after the transitions' BatchNorms), of 3DViT_1_layer
# (deit_small, 6 heads, 257 point tokens) and of 3DViT_LWF (deit_base with 3
# heads, 65 point tokens): (label, B, N, D, heads, x dtype, compute dtype)
LWF_BF16_BLOCK_SHAPES = [
    ("3DViT_1_layer images", 64, 197, 384, 6, "bfloat16", "bfloat16"),
    ("3DViT_1_layer points", 32, 257, 384, 6, "float32", "bfloat16"),
    ("3DViT_LWF images", 64, 197, 768, 3, "bfloat16", "bfloat16"),
    ("3DViT_LWF points", 32, 65, 768, 3, "float32", "bfloat16"),
]
CROP_ATOL = 1e-3  # the crop on the 0-255 scale: f32 sums of products in another order
# card vs CPU, 3 LwF steps' loss, task and lwf terms: f32, 24 blocks and the
# point path in another order; bf16, as the other bf16 paths (logits keep 8 bits)
LWF_LOSS_RTOL = {None: 1e-3, "bf16": 2e-3}
LWF_BASE_EPOCHS = 5  # model=3DViT_lwf (deit_base student and teacher) through the CLI: 10 steps


def block_row_times(torch, label, x, w, heads, g, iters=20):
    """Rows 1, 3 and 4 at one shape, x f32: each beside its plain version
    (in turns) and TransformerEncoderLayer, with its bound; the training
    forward's and backward's device time by GEMM; the attention's device time
    beside its bound and SDPA's."""
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    b, n, d = x.shape
    y0 = vb.fused_vit_block(x, w, heads)
    y, res = vb.fused_vit_block_train_fwd(x, w, heads)
    gx, gw = vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res)
    lib = library_times(torch, x, w, heads, g, iters)
    flops = block_flops(b, n, d, heads)
    ws = [w[k] for k in vb.WNAMES]
    rows = {
        "fused_vit_block (row 1)": (lambda: vb.fused_vit_block(x, w, heads),
                                    lambda: vb.vit_block_reference(x, w, heads),
                                    nbytes(x, *ws, y0), flops, lib["fwd"]),
        "fused_vit_block_train_fwd (row 3)": (
            lambda: vb.fused_vit_block_train_fwd(x, w, heads),
            lambda: vb.vit_block_train_reference(x, w, heads),
            nbytes(x, *ws, y, res), flops, lib["train_fwd"]),
        "fused_vit_block_train_bwd (row 4)": (
            lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res),
            lambda: vb.vit_block_backward_reference(x, g, w, heads, residuals=res),
            nbytes(x, g, *ws, res, gx, gw), 2 * flops, lib["bwd"]),
    }
    for name, (kernel, plain, moved, ops, library_ms) in rows.items():
        ms, plain_ms = in_turns(torch, kernel, plain, iters)
        bound_ms, bound_by = bound(moved, ops)
        print(f"kernel {name} {label}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"{library_ms:.4f} ms TransformerEncoderLayer, bound {bound_ms:.4f} ms "
              f"({bound_by}: {moved / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP), mean of {iters} "
              "launches each, in turns")
    block_split(torch, lambda: vb.fused_vit_block_train_fwd(x, w, heads), b, n, d,
                f"kernel fused_vit_block_train_fwd {label}", FWD_GEMMS, calls=3)
    block_split(torch, lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res),
                b, n, d, f"kernel fused_vit_block_train_bwd {label}", BWD_GEMMS, calls=3)
    attention_report(torch, label, b, n, d, heads,
                     lambda: vb.fused_vit_block_train_fwd(x, w, heads),
                     lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res),
                     res["qkv"], g)


def lwf_block_check(torch, label, b, n, d, heads, dtype):
    """The fused forward (row 1) and the training forward and backward (rows 3-4)
    at an LwF shape against their plain versions, the backward twice bit-equal;
    at LWF_TIMED each row's time beside the plain version and
    TransformerEncoderLayer, and each call's device time by kernel."""
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    x, w = block_inputs(torch, b, n, d, getattr(torch, dtype), seed=b * 1000 + n + d,
                        device="cuda")
    g = torch.from_numpy(np.random.RandomState(b + n + d).randn(b, n, d).astype(np.float32))
    g = g.to(device="cuda", dtype=x.dtype)
    y0 = vb.fused_vit_block(x, w, heads)
    want0 = vb.vit_block_reference(x, w, heads)
    y, res = vb.fused_vit_block_train_fwd(x, w, heads)
    y2, res2 = vb.fused_vit_block_train_fwd(x, w, heads)
    y_ref, res_ref = vb.vit_block_train_reference(x, w, heads)
    gx, gw = vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res)
    gx2, gw2 = vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res)
    want_x, want_w = vb.vit_block_backward_reference(x, g, w, heads, residuals=res)
    torch.cuda.synchronize()
    fwd_err = float((y0.float() - want0.float()).abs().max())
    torch.testing.assert_close(y0.float(), want0.float(), **TOL[dtype])
    _, train_err = errors({"y": y, **res}, {"y": y_ref, **res_ref})
    _, bwd_err = errors({"gx": gx, **gw}, {"gx": want_x, **want_w})
    same = (torch.equal(y, y2) and all(torch.equal(res[k], res2[k]) for k in res)
            and torch.equal(gx, gx2) and all(torch.equal(gw[k], gw2[k]) for k in gw))
    print(f"kernel LwF block {label} B={b} N={n} D={d} H={heads} {dtype}: forward max abs err "
          f"{fwd_err:.3e} (tolerance {TOL[dtype]}); error relative to the largest value: "
          f"training forward+residuals {train_err:.3e}, residual backward {bwd_err:.3e} "
          f"(tolerance {GRAD_REL[dtype]}); two runs of the training forward and of the "
          f"backward bit-equal {same}")
    if max(train_err, bwd_err) > GRAD_REL[dtype] or not same:
        raise AssertionError(f"LwF block kernels {label}: errors {train_err}, {bwd_err}, "
                             f"bit-equal {same}")
    if label in LWF_TIMED:
        block_row_times(torch, label, x, w, heads, g, iters=20)


def lwf_crop_check(torch):
    """The device crop and flip on the card against the same function on the
    CPU, from the same boxes and flips, at the partseg LwF step's shape."""
    from simple3dformer_tpu_torch.data import image_augment as ia
    from simple3dformer_tpu_torch.train import lwf

    images = torch.from_numpy(lwf.load_images("", synthetic=LWF_M, seed=9)[:LWF_M]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(9)
    boxes = ia.sample_crop_boxes(gen, LWF_M, lwf.IMAGE_CANVAS, lwf.IMAGE_CANVAS)
    flip = torch.rand(LWF_M, generator=gen, device="cuda") < 0.5
    got = ia.resized_crop_flip(images, *boxes, flip)
    want = ia.resized_crop_flip(images.cpu(), *(t.cpu() for t in boxes), flip.cpu())
    err = float((got.cpu() - want).abs().max())
    ms = time_ms(torch, lambda: ia.device_random_resized_crop_flip(gen, images), iters=20)
    heights = boxes[2].cpu().numpy()
    print(f"LwF crop: {LWF_M} images {lwf.IMAGE_CANVAS}^2 -> 224^2 (crop heights "
          f"{heights.min():.0f}-{heights.max():.0f}, {int(flip.sum())} flipped): card vs CPU max "
          f"abs err {err:.3e} on the 0-255 scale (tolerance {CROP_ATOL}); {ms:.4f} ms a call "
          "with its draws (plain PyTorch, CUDA events, 20 calls)")
    if err > CROP_ATOL or tuple(got.shape) != (LWF_M, 224, 224, 3):
        raise AssertionError(f"LwF crop on the card: err {err}, shape {tuple(got.shape)}")


def lwf_launches(n_td, depth, steps, evals) -> dict:
    """The LwF partseg path's launches: per point forward (train step or eval
    batch) n_td FPS, 2 n_td kNN (k=16, the 3-NN) and 4 n_td gathers, per train
    step 2 n_td gather backwards; the teacher's ``depth`` forwards (row 1) a
    step, the student's 2 ``depth`` training blocks a step (its point tokens
    and its images, rows 3-4), ``depth`` forwards an eval batch; no recompute
    backward and no mhsa (every block at N <= 512)."""
    fwd = steps + evals
    return dict(fps=n_td * fwd, knn=2 * n_td * fwd, gather_fwd=4 * n_td * fwd,
                gather_bwd=2 * n_td * steps, fused_vit_block=depth * fwd,
                fused_vit_block_train_fwd=2 * depth * steps,
                fused_vit_block_train_bwd=2 * depth * steps, fused_vit_block_bwd=0,
                mhsa_fwd=0, mhsa_bwd=0)


def lwf_cli_check(torch, tpl, counters, overrides, epochs, label, must_fall=True):
    """train_partseg_lwf through its CLI on synthetic points and images on the
    card: the epoch lines, both DeiT files loaded, the launch counts from the
    model, the loss falling (last epoch < 0.75 x the first) where ``must_fall``;
    -> the launch counts."""
    from simple3dformer_tpu_torch.core.config import load_task_config
    from simple3dformer_tpu_torch.models.registry import make_point_model

    _, lines, launches, saved = run_cli(tpl.main, lambda d: [
        f"synthetic={LWF_SAMPLES}", f"epoch={epochs}", f"out_dir={d}", *overrides], counters)
    cfg = load_task_config("partseg_lwf", overrides)
    cfg.num_class, cfg.input_dim = 50, 22
    model = make_point_model(cfg, "seg")
    steps = epochs * (LWF_SAMPLES // LWF_B)
    evals = epochs * -(-max(LWF_SAMPLES // 5, 32) // LWF_B)
    want = lwf_launches(len(model.transition_downs), len(model.blocks), steps, evals)
    per_step = {k: v for k, v in lwf_launches(len(model.transition_downs), len(model.blocks), 1,
                                              0).items() if v}
    epochs_lines = [line for line in lines if line.startswith("Epoch ")]
    epoch_losses = [float(line.split(" loss ")[1].split()[0]) for line in epochs_lines]
    loaded = [line for line in lines if line.startswith("loaded ")]
    ious = [line for line in lines if "Inctance avg mIOU" in line]
    print(f"{label} CLI (B={LWF_B}, N=1024, M={LWF_M}, {cfg.model.name} on "
          f"{cfg.model.transformer_backbone}, {' '.join(overrides) or 'f32'}, pretrained from a "
          f"seeded file): {steps} train steps, {evals} eval batches; {epochs_lines[0]} -> "
          f"{epochs_lines[-1]}; {ious[-1].strip()}; {loaded}; checkpoints at epochs {saved}; "
          f"launches {launches} (want {want}; a train step: {per_step})")
    if len(epoch_losses) != epochs or not np.isfinite(epoch_losses).all():
        raise AssertionError(f"{label} losses: {epoch_losses}")
    if must_fall and not epoch_losses[-1] < 0.75 * epoch_losses[0]:
        raise AssertionError(f"{label} loss did not fall: {epoch_losses}")
    if len(loaded) != 2 or not saved or len(ious) != epochs:
        raise AssertionError(f"{label} CLI output: {lines[-8:]}")
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches}, want {want}")
    return launches


def write_deit(torch, directory, name, seed):
    """A timm-named DeiT state dict at ``directory/<name>.pth`` from a seeded model."""
    import os

    from simple3dformer_tpu_torch.core.rng import generator
    from simple3dformer_tpu_torch.nn.vit import deit_factory

    sd = {k: v.clone() for k, v in deit_factory(name, generator=generator(seed)).state_dict().items()}
    torch.save({"model": sd}, os.path.join(directory, f"{name}.pth"))
    return sd


def lwf_timed(torch, run, task_ds, image_ds, lr, label, batch, m, n_steps=10):
    """ms a step of an LwF run over ``n_steps`` after a warm-up, and its profile."""
    rs = np.random.RandomState(5)
    task = rs.randint(0, len(task_ds), (n_steps + 1, batch))
    images = rs.randint(0, len(image_ds), (n_steps + 1, m))
    both = task_ds.put_indices(np.concatenate([task, images], 1))
    return timed_steps(torch, lambda rows, lr: run(rows[:, :batch], rows[:, batch:], lr), both,
                       lr, n_steps, label, batch)


def phase_lwf(torch):
    """LwF at full width: the block kernels at the path's new shapes (f32, and
    the bf16 student's), the device crop, train_partseg_lwf in f32 and at
    dtype=bf16 (3 steps card vs CPU, the CLI with its launch counts, ms a step
    and a profile), model=3DViT_lwf through the CLI in f32 and bf16 (launch
    counts, ms a step, a profile) and train_cls_voxel --lwf --pretrained (a
    DeiT file loaded, the 2D leaves unchanged, launch counts, ms a step).
    Returns the launch counts of the f32 partseg CLI run."""
    import os
    import tempfile

    from simple3dformer_tpu_torch.cli import _common
    from simple3dformer_tpu_torch.cli import train_cls_voxel
    from simple3dformer_tpu_torch.cli import train_partseg_lwf as tpl
    from simple3dformer_tpu_torch.cli.train_partseg import (load_arrays, make_prepare_fn,
                                                            seg_augment)
    from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
    from simple3dformer_tpu_torch.core.config import load_task_config
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.data.image_augment import device_random_resized_crop_flip
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.kernels.adam import fused_adam
    from simple3dformer_tpu_torch.models.point_vit import frozen_mask_point
    from simple3dformer_tpu_torch.models.registry import make_point_model
    from simple3dformer_tpu_torch.models.voxel_vit import frozen_mask
    from simple3dformer_tpu_torch.nn.vit import make_teacher
    from simple3dformer_tpu_torch.train import lwf
    from simple3dformer_tpu_torch.train.loop import TrainState, seg_cross_entropy
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    for shape in LWF_BLOCK_SHAPES:
        lwf_block_check(torch, *shape)
    for label, b, n, d, heads, x_dtype, cdt in LWF_BF16_BLOCK_SHAPES:
        errs, same = block_cdt_check(torch, b, n, d, heads, getattr(torch, x_dtype),
                                     getattr(torch, cdt), seed=n + d + heads)
        print(f"kernel LwF block bf16 student {label} B={b} N={n} D={d} H={heads}, x {x_dtype}, "
              f"{cdt} matmuls: error relative to the largest value "
              f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tolerance {GRAD_REL[cdt]}); "
              f"two runs of the training forward and of each backward bit-equal {same}")
        if max(errs.values()) > GRAD_REL[cdt] or not same:
            raise AssertionError(f"LwF bf16 block kernels {label}: {errs}, bit-equal {same}")
    lwf_crop_check(torch)

    cfg = load_task_config("partseg_lwf", [f"synthetic={3 * LWF_PARITY_B}", "seed=9"])
    cfg.num_class, cfg.input_dim = 50, 22
    base_cfg = load_task_config("partseg_lwf", ["model=3DViT_lwf", "seed=9"])
    base_cfg.num_class, base_cfg.input_dim = 50, 22

    def trainer(device, model_cfg=cfg, dtype=None):
        model = make_point_model(model_cfg, "seg", dtype=dtype,
                                 generator=generator(DEFAULT_SEED)).to(device)
        opt, lr = _common.reference_optimizer(model_cfg, dict(model.named_parameters()),
                                              frozen_mask_point(model, True))
        teacher = make_teacher(str(model_cfg.model.transformer_backbone),
                               generator=generator(lwf.TEACHER_SEED)).to(device)
        return TrainState(model, opt), teacher, lr

    # steps on the card and on the CPU's plain path in f32 and at dtype=bf16:
    # the same weights, batches and 224^2 images, the augmentations off (their
    # draws differ by device)
    (xs, cats, segs), _ = load_arrays(cfg)
    images = lwf.load_images("", synthetic=3 * LWF_PARITY_M, seed=9, canvas=224)
    prepare = make_prepare_fn()
    for dtype in (None, "bf16"):
        losses, seconds = {}, {}
        for device in ("cuda", "cpu"):
            state, teacher, lr = trainer(device, dtype=dtype and torch.bfloat16)
            step = lwf.make_lwf_train_step(state, teacher, task_loss_fn=seg_cross_entropy,
                                           prepare_fn=prepare)
            t1, out = time.perf_counter(), []
            for i in range(CPU_PARITY_STEPS):
                sl, il = slice(i * LWF_PARITY_B, (i + 1) * LWF_PARITY_B), \
                    slice(i * LWF_PARITY_M, (i + 1) * LWF_PARITY_M)
                batch = {k: torch.from_numpy(v[sl]).to(device)
                         for k, v in (("x", xs), ("cls", cats), ("y", segs))}
                metrics = step(batch, torch.from_numpy(images[il]).to(device), lr)
                out.append([float(metrics[k]) for k in ("loss", "task_loss", "lwf_loss")])
            losses[device], seconds[device] = out, time.perf_counter() - t1
        print(f"LwF partseg {dtype or 'f32'}: {CPU_PARITY_STEPS} steps at B={LWF_PARITY_B}, "
              f"M={LWF_PARITY_M}, lr "
              f"{lr} (loss, task, lwf): on the card {losses['cuda']} vs the CPU's plain path "
              f"{losses['cpu']} (rtol {LWF_LOSS_RTOL[dtype]}); {seconds['cuda']:.1f} s on the "
              f"card, {seconds['cpu']:.1f} s on the CPU")
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=LWF_LOSS_RTOL[dtype])

    counters = s3dis_counters()
    with tempfile.TemporaryDirectory() as weights:
        small = write_deit(torch, weights, str(cfg.model.transformer_backbone),
                           seed=DEFAULT_SEED + 20)
        # deit_base: the voxel --lwf teacher, and 3DViT_lwf's student and teacher
        write_deit(torch, weights, train_cls_voxel.LWF_TEACHER, seed=DEFAULT_SEED + 21)
        old = os.environ.get("DEIT_CKPT_DIR")
        os.environ["DEIT_CKPT_DIR"] = weights
        try:
            # the CLI on a synthetic corpus and synthetic images on the card: the
            # main path, in f32 and at dtype=bf16; then model=3DViT_lwf in both
            launches = lwf_cli_check(torch, tpl, counters, [], LWF_EPOCHS, "LwF partseg")
            lwf_cli_check(torch, tpl, counters, ["dtype=bf16"], LWF_EPOCHS, "LwF partseg bf16")
            for extra in ([], ["dtype=bf16"]):
                lwf_cli_check(torch, tpl, counters, ["model=3DViT_lwf", *extra], LWF_BASE_EPOCHS,
                              f"LwF 3DViT_lwf {extra[0] if extra else 'f32'}", must_fall=False)

            # train_cls_voxel --lwf --pretrained at the flagship width
            kept = {}

            def read_ckpt(out_dir):
                path = os.path.join(out_dir, "Voxel3D_2DPretrain", "VoxelEmbed_default", BACKBONE,
                                    "ckpt")
                kept.update(Checkpointer(path).restore()[0]["params"])

            vcounters = {fn.__name__: fn for fn in counters.values()
                         if fn.__name__.startswith("fused_vit")}
            vcounters["fused_adam"] = fused_adam
            argv = ["--dataset", "ModelNet40", "--synthetic", str(TRAIN_SAMPLES), "--epochs",
                    str(TRAIN_EPOCHS), "--batchSize", str(BATCH), "--lr", str(TRAIN_LR),
                    "--transformer-name", BACKBONE, "--cell-size", str(CELL), "--patch-size",
                    str(PATCH), "--lwf", "--pretrained"]
            _, vlines, vlaunches, vsaved = run_cli(train_cls_voxel.main,
                                                   lambda d: [*argv, "--outf", d], vcounters,
                                                   after=read_ckpt)
        finally:
            if old is None:
                del os.environ["DEIT_CKPT_DIR"]
            else:
                os.environ["DEIT_CKPT_DIR"] = old
    vsteps = TRAIN_EPOCHS * (TRAIN_SAMPLES // BATCH)
    vevals = TRAIN_EPOCHS * -(-max(TRAIN_SAMPLES // 5, BATCH) // BATCH)
    vwant = {"fused_vit_block": 12 * (vsteps + vevals), "fused_vit_block_bwd": 0,
             "fused_vit_block_train_fwd": 24 * vsteps, "fused_vit_block_train_bwd": 24 * vsteps,
             "fused_adam": vsteps}
    vlosses = [float(line.split()[3]) for line in vlines if line.startswith("Epoch ")]
    vloaded = [line for line in vlines if line.startswith("loaded ")]
    frozen = [k for k in kept if k.split(".")[0] in ("head", "pos_embed", "patch_embed")]
    unchanged = all(torch.equal(kept[k].cpu(), small[k]) for k in frozen)
    print(f"LwF voxel CLI (--lwf --pretrained, {BACKBONE}, B={BATCH}, deit_base teacher with 12 "
          f"heads, M={BATCH}): {vsteps} steps, epoch losses {vlosses[0]:.4f} -> "
          f"{vlosses[-1]:.4f}; {vloaded}; the 2D leaves {frozen} equal to the file's after the "
          f"steps: {unchanged}; checkpoints at epochs {vsaved}; launches {vlaunches} (want {vwant})")
    if (len(vlosses) != TRAIN_EPOCHS or not np.isfinite(vlosses).all() or len(vloaded) != 2
            or len(frozen) != 5 or not unchanged or not vsaved):
        raise AssertionError(f"LwF voxel CLI output: {vlines[-6:]}")
    if vlaunches != vwant:
        raise AssertionError(f"LwF voxel launch counts {vlaunches}, want {vwant}")

    # ms a step: the partseg LwF step as the CLI runs it, then the voxel one
    cfg.synthetic = 11 * LWF_B
    (xs, cats, segs), _ = load_arrays(cfg)
    task_ds = DeviceResidentDataset({"x": xs, "cls": cats, "y": segs}, "cuda")
    image_ds = DeviceResidentDataset({"images": lwf.load_images("", synthetic=LWF_M, seed=9)},
                                     "cuda")
    for label, model_cfg, dtype in (("LwF partseg", cfg, None),
                                    ("LwF partseg bf16", cfg, torch.bfloat16),
                                    ("LwF 3DViT_lwf", base_cfg, None),
                                    ("LwF 3DViT_lwf bf16", base_cfg, torch.bfloat16)):
        state, teacher, lr = trainer("cuda", model_cfg, dtype)
        run = lwf.make_scanned_lwf_train_steps(
            state, teacher, task_ds, image_ds, task_loss_fn=seg_cross_entropy,
            augment_fn=seg_augment, image_augment_fn=device_random_resized_crop_flip,
            prepare_fn=prepare)
        lwf_timed(torch, run, task_ds, image_ds, lr, label, LWF_B, LWF_M)
        del state, teacher, run
    grids, labels = synthetic_voxels(11 * BATCH, VOXEL, N_CLASSES, seed=DEFAULT_SEED + 3)
    vds = DeviceResidentDataset({"x": grids, "y": labels}, "cuda")
    vmodel = flagship_model(torch, "cuda")
    vopt = make_optimizer(dict(vmodel.named_parameters()), "Adam",
                          trainable_mask=frozen_mask(vmodel, True))
    vteacher = make_teacher(train_cls_voxel.LWF_TEACHER,
                            generator=generator(lwf.TEACHER_SEED)).cuda()
    vrun = lwf.make_scanned_lwf_train_steps(TrainState(vmodel, vopt), vteacher, vds, image_ds,
                                            image_augment_fn=device_random_resized_crop_flip)
    lwf_timed(torch, vrun, vds, image_ds, 1e-4, "LwF voxel", BATCH, BATCH)
    print(f"LwF phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ShapeNetV2 group_embed: BASELINE.json's second config (bench.py:345-354):
# ShapeNetV2 at 128^3, deit_base (3 heads of 256, the 3D models' head count),
# VoxelEmbed_no_average with cell 9 and patch 14, --pos-embedding group_embed,
# B=16, Adam at lr 1e-3. Stage 1 runs the 12 blocks over 16 * 14 * 14 = 3,136
# pillars of 14 + 1 tokens, stage 2 over [16, 197, 768].
GROUP_B, GROUP_VOXEL, GROUP_CELL, GROUP_PATCH = 16, 128, 9, 14
GROUP_BACKBONE, GROUP_CLASSES = "deit_base_patch16_224", 55
GROUP_ARGV = ["--dataset", "ShapeNetV2", "--batchSize", str(GROUP_B), "--transformer-name",
              GROUP_BACKBONE, "--embed-layer", "VoxelEmbed_no_average", "--cell-size",
              str(GROUP_CELL), "--patch-size", str(GROUP_PATCH), "--pos-embedding", "group_embed"]
GROUP_PILLARS = GROUP_B * (GROUP_VOXEL // GROUP_CELL) ** 2  # 3,136
# the fused block at stage 1's shape: (label, B, N, D, heads, x dtype, compute dtype):
# the model's 3 heads in f32 and at bf16 matmuls on its f32 stream, and 12 heads of 64
GROUP_BLOCK_SHAPES = [("stage 1 f32", GROUP_PILLARS, 15, 768, 3, "float32", "float32"),
                      ("stage 1 bf16", GROUP_PILLARS, 15, 768, 3, "float32", "bfloat16"),
                      ("stage 1 f32, 12 heads", GROUP_PILLARS, 15, 768, 12, "float32", "float32"),
                      ("stage 1 bf16, 12 heads", GROUP_PILLARS, 15, 768, 12, "float32",
                       "bfloat16")]
# card vs CPU at B=2 and full width with the first 4 of the 12 blocks (on the
# card machine's CPU 12 blocks take 24 s in f32 and 72 s in bf16)
GROUP_PARITY_B, GROUP_PARITY_DEPTH = 2, 4
GROUP_LOSS_RTOL = {False: 1e-3, True: 2e-3}  # f32, bf16: as the other paths' checks
# the loss-falls run: 64 samples (51 train, 13 test), 8 classes, half of each
# grid's (x, y) pillars empty; the CLI's default base lr, warmed up over epochs
GROUP_LEARN_SAMPLES, GROUP_LEARN_CLASSES, GROUP_LEARN_EPOCHS, GROUP_LEARN_LR = 64, 8, 6, 0.05


def group_model(torch, device, dtype=None, seed=None):
    """The ShapeNetV2 group_embed model with seeded random weights."""
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
    from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbedNoAverage

    seed = DEFAULT_SEED if seed is None else seed
    g = generator(seed)
    emb = VoxelEmbedNoAverage(voxel_size=GROUP_VOXEL, cell_size=GROUP_CELL,
                              patch_size=GROUP_PATCH, embed_dim=768, generator=g, dtype=dtype)
    return VoxelViT(emb, n_classes=GROUP_CLASSES, transformer_backbone=GROUP_BACKBONE,
                    pos_embedding="group_embed", dropout_seed=seed, generator=g,
                    dtype=dtype).to(device)


def half_empty_grids(n, seed, fill=0.15):
    """n random 128^3 occupancy grids (uint8) with a random half of the (x, y)
    pillars of the cell-9 grid empty in every sample."""
    rs = np.random.RandomState(seed)
    p = GROUP_VOXEL // GROUP_CELL
    out = np.empty((n, GROUP_VOXEL, GROUP_VOXEL, GROUP_VOXEL), np.uint8)
    for i in range(n):
        empty = np.zeros(p * p, bool)
        empty[rs.permutation(p * p)[: p * p // 2]] = True
        cols = np.zeros((GROUP_VOXEL, GROUP_VOXEL), bool)
        cols[: p * GROUP_CELL, : p * GROUP_CELL] = np.repeat(np.repeat(
            empty.reshape(p, p), GROUP_CELL, 0), GROUP_CELL, 1)
        grid = rs.rand(GROUP_VOXEL, GROUP_VOXEL, GROUP_VOXEL) < fill
        grid[cols] = False
        out[i] = grid
    return out


def write_binvox(path, grid):
    """A binvox file (the format data/binvox.read_as_3d_array reads): x-z-y
    order, (value, count) byte pairs, runs of at most 255."""
    flat = np.transpose(grid, (0, 2, 1)).ravel().astype(np.uint8)
    starts = np.r_[0, np.flatnonzero(np.diff(flat)) + 1]
    lens = np.diff(np.r_[starts, flat.size])
    reps = (lens + 254) // 255
    vals = np.repeat(flat[starts], reps)
    counts = np.full(int(reps.sum()), 255, np.int64)
    counts[np.cumsum(reps) - 1] = lens - 255 * (reps - 1)
    dims = " ".join(str(v) for v in grid.shape)
    with open(path, "wb") as f:
        f.write(f"#binvox 1\ndim {dims}\ntranslate 0 0 0\nscale 1\ndata\n".encode())
        f.write(np.stack([vals, counts], 1).astype(np.uint8).tobytes())


def write_shapenet_corpus(directory, grids, labels):
    """grids as ShapeNetCore.v2 solid binvox files under directory/<synset>/<model>/models/."""
    import os

    from simple3dformer_tpu_torch.data.classmaps import CLASSES_SHAPENET

    for i, (grid, label) in enumerate(zip(grids, labels)):
        d = os.path.join(directory, CLASSES_SHAPENET[int(label)], f"m{i:03d}", "models")
        os.makedirs(d)
        write_binvox(os.path.join(d, "model_normalized.solid.binvox"), grid)


def group_split(torch, model, opt, x):
    """ms of one train step's parts by CUDA events, each part's forward and
    backward run alone: the tokenizer, the group encoder (its dropout live),
    stage 1's 12 blocks and final norm, stage 2, Adam; and stage 1's device
    ms by kind (torch.profiler: the block GEMMs, the attention kernels, the
    rest; zeros where it records nothing)."""
    d = model.norm.weight.shape[0]
    model.train()
    emb, enc = model.voxel_embed, model.group_embed
    core = list(model.blocks.parameters()) + list(model.norm.parameters())
    tok = emb(x)
    b, px, py, pz, _ = tok.shape
    g_tok = torch.randn_like(tok)
    pil = model._with_cls(tok.detach().reshape(b * px * py, pz, d), model.group_cls_token)
    pil = (pil + model.group_pos_embed.to(pil.dtype)).detach().requires_grad_()
    s1 = enc(pil).detach().contiguous().requires_grad_()
    g_s1 = torch.randn_like(s1)
    s2 = torch.randn(b, px * py + 1, d, device=x.device, dtype=s1.dtype, requires_grad=True)
    g_out1 = torch.randn(b * px * py, pz + 1, d, device=x.device)
    g_out2 = torch.randn(b, px * py + 1, d, device=x.device)
    grads = {k: torch.zeros_like(p) for k, p in opt.params.items() if p.requires_grad}
    parts = {
        "tokenizer": lambda: torch.autograd.grad(emb(x), list(emb.parameters()), g_tok),
        "group encoder": lambda: torch.autograd.grad(enc(pil), [pil, *enc.parameters()], g_s1),
        "stage 1 blocks": lambda: torch.autograd.grad(model.encode(s1), [s1, *core], g_out1),
        "stage 2 blocks": lambda: torch.autograd.grad(model.encode(s2), [s2, *core], g_out2),
        "Adam": lambda: opt.step(grads, 0.0),
    }
    out = {name: time_ms(torch, fn, 3) for name, fn in parts.items()}
    kinds = {"GEMMs": 0.0, "attention": 0.0, "other": 0.0}
    for k, (ms, n) in device_split(torch, parts["stage 1 blocks"], iters=3).items():
        kind = ("attention" if k in ATTENTION_GROUPS else
                "GEMMs" if k.startswith("BlkEpi") else "other")
        kinds[kind] += ms * n / 3
    return out, kinds


def group_parity(torch, bf16):
    """3 train steps on the card and on the CPU's plain path at B=2 from the same
    weights and batches (grids with empty pillars), the group dropout off, at
    full width, GROUP_PARITY_DEPTH blocks."""
    from simple3dformer_tpu_torch.models.voxel_vit import frozen_mask
    from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    dtype = torch.bfloat16 if bf16 else None
    grids = half_empty_grids(3 * GROUP_PARITY_B, seed=31)
    labels = np.random.RandomState(32).randint(0, GROUP_CLASSES, 3 * GROUP_PARITY_B)
    losses, seconds = {}, {}
    depth = GROUP_PARITY_DEPTH
    for device in ("cuda", "cpu"):
        model = group_model(torch, device, dtype)
        model.group_embed.dropout = 0.0
        model.blocks = model.blocks[:depth]
        opt = make_optimizer(dict(model.named_parameters()), "Adam",
                             trainable_mask=frozen_mask(model, False), bf16_nu=bf16)
        step = make_train_step(TrainState(model, opt))
        t0, out = time.perf_counter(), []
        for i in range(CPU_PARITY_STEPS):
            sl = slice(i * GROUP_PARITY_B, (i + 1) * GROUP_PARITY_B)
            batch = {"x": torch.from_numpy(grids[sl]).float().to(device),
                     "y": torch.from_numpy(labels[sl]).to(device)}
            out.append(float(step(batch, 1e-4)["loss"]))
        losses[device], seconds[device] = out, time.perf_counter() - t0
    label = "bf16" if bf16 else "f32"
    print(f"group_embed {label}: {CPU_PARITY_STEPS} steps at B={GROUP_PARITY_B}, {depth} blocks "
          f"(half the "
          f"pillars empty, group dropout off), lr 1e-4: on the card {losses['cuda']} vs the CPU's "
          f"plain path {losses['cpu']} (rtol {GROUP_LOSS_RTOL[bf16]}); {seconds['cuda']:.1f} s "
          f"on the card, {seconds['cpu']:.1f} s on the CPU")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=GROUP_LOSS_RTOL[bf16])


def phase_group_embed(torch):
    """BASELINE.json's second config on the card (ShapeNetV2 group_embed at full
    width) and the other voxel routes: the block kernels at stage 1's shape,
    the CLI in f32 and bf16 with its launch counts, ms a step with its device
    split, 3 steps card vs CPU in each dtype, a loss-falls run on grids with
    empty pillars, weight_sharing and VoxelEmbed_Hybrid through the CLI."""
    import tempfile

    from simple3dformer_tpu_torch.cli import train_cls_voxel
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.models.voxel_vit import frozen_mask
    from simple3dformer_tpu_torch.nn.layers import Attention
    from simple3dformer_tpu_torch.train.loop import TrainState, make_scanned_train_steps
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    for label, b, n, d, heads, x_dtype, cdt in GROUP_BLOCK_SHAPES:
        errs, same = block_cdt_check(torch, b, n, d, heads, getattr(torch, x_dtype),
                                     getattr(torch, cdt), seed=n + heads)
        print(f"kernel fused block group_embed {label} B={b} N={n} D={d} H={heads}, x {x_dtype}, "
              f"{cdt} matmuls: error relative to the largest value "
              f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tolerance {GRAD_REL[cdt]}); "
              f"two runs of the training forward and of each backward bit-equal {same}")
        if max(errs.values()) > GRAD_REL[cdt] or not same:
            raise AssertionError(f"block kernels group_embed {label}: {errs}, bit-equal {same}")
    # times at the model's 3 heads; the attention also at 12 heads of 64
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    for heads in (3, 12):
        x, w = block_inputs(torch, GROUP_PILLARS, 15, 768, torch.float32, seed=heads, device="cuda")
        g = torch.from_numpy(np.random.RandomState(heads + 1).randn(GROUP_PILLARS, 15, 768)
                             .astype(np.float32)).cuda()
        label = f"group_embed stage 1 (H={heads})"
        if heads == 3:
            block_row_times(torch, label, x, w, heads, g, iters=10)
        else:
            res = vb.fused_vit_block_train_fwd(x, w, heads)[1]
            attention_report(torch, label, GROUP_PILLARS, 15, 768, heads,
                             lambda: vb.fused_vit_block_train_fwd(x, w, heads),
                             lambda: vb.fused_vit_block_train_bwd(x, g, w, heads, residuals=res),
                             res["qkv"], g)
        del x, w, g
    print(f"group_embed block kernels: {time.perf_counter() - t0:.1f} s")

    # the CLI at BASELINE.json's second config, f32 and bf16: the main path
    counters = voxel_counters()
    for bf16 in (False, True):
        plain_before = Attention.plain_calls
        argv = [*GROUP_ARGV, "--synthetic", "48", "--epochs", "2", "--lr", "1e-3"]
        argv += ["--dtype", "bf16"] if bf16 else []
        _, lines, launches, saved = run_cli(train_cls_voxel.main,
                                            lambda o, argv=argv: [*argv, "--outf", o], counters)
        plain = Attention.plain_calls - plain_before
        want = voxel_launches(2, steps=2 * (48 // GROUP_B), evals=2, adam=not bf16)
        epochs = [line for line in lines if line.startswith("Epoch ")]
        label = "bf16" if bf16 else "f32"
        print(f"group_embed CLI {label} (ShapeNetV2 128^3, {GROUP_BACKBONE}, cell {GROUP_CELL}, "
              f"patch {GROUP_PATCH}, B={GROUP_B}): " + " | ".join(epochs)
              + f"; checkpoints at epochs {saved}; launches {launches} (want {want}); plain "
              f"attention calls {plain}")
        losses = [float(line.split()[3]) for line in epochs]
        if len(epochs) != 2 or not np.isfinite(losses).all() or not saved:
            raise AssertionError(f"group_embed CLI {label}: {lines[-4:]}")
        if launches != want or plain:
            raise AssertionError(f"group_embed CLI {label}: launches {launches}, want {want}; "
                                 f"plain attention calls {plain}")

    # ms a step at B=16, the corpus on the card, and the device split
    grids = half_empty_grids(2 * GROUP_B, seed=33)
    labels = np.random.RandomState(34).randint(0, GROUP_CLASSES, 2 * GROUP_B).astype(np.int32)
    ds = DeviceResidentDataset({"x": grids, "y": labels}, "cuda")
    idx = ds.put_indices(np.random.RandomState(35).randint(0, 2 * GROUP_B, (6, GROUP_B)))
    for bf16 in (False, True):
        label = "group_embed " + ("bf16" if bf16 else "f32")
        model = group_model(torch, "cuda", torch.bfloat16 if bf16 else None)
        opt = make_optimizer(dict(model.named_parameters()), "Adam",
                             trainable_mask=frozen_mask(model, False), bf16_nu=bf16)
        run = make_scanned_train_steps(TrainState(model, opt), ds)
        ms_step = timed_steps(torch, run, idx, 1e-4, 5, label, GROUP_B)
        split, kinds = group_split(torch, model, opt, ds.gather(idx[0])["x"].float())
        total = sum(split.values())
        print(f"{label} ms by part (CUDA events), each part's forward and backward alone: "
              + ", ".join(f"{k} {v:.3f} ({v / total:.1%})" for k, v in split.items())
              + "; stage 1 blocks by kind, device ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items())
              + f"; sum {total:.3f} ms against the {ms_step:.3f} ms step")
        del model, opt, run
        torch.cuda.empty_cache()

    for bf16 in (False, True):
        group_parity(torch, bf16)

    # loss falls on grids with empty pillars, through the CLI from binvox files
    learn = half_empty_grids(GROUP_LEARN_SAMPLES, seed=36)
    learn_y = np.arange(GROUP_LEARN_SAMPLES) % GROUP_LEARN_CLASSES
    with tempfile.TemporaryDirectory() as root:
        write_shapenet_corpus(root, learn, learn_y)
        argv = [a for a in GROUP_ARGV] + ["--data-root", root, "--epochs",
                                          str(GROUP_LEARN_EPOCHS), "--lr", str(GROUP_LEARN_LR)]
        _, lines, launches, _ = run_cli(train_cls_voxel.main,
                                        lambda o: [*argv, "--outf", o], counters)
    losses = [float(line.split()[3]) for line in lines if line.startswith("Epoch ")]
    print(f"group_embed loss-falls run (f32, {GROUP_LEARN_SAMPLES} binvox grids with half the "
          f"pillars empty, {GROUP_LEARN_CLASSES} classes, base lr {GROUP_LEARN_LR}): "
          f"{lines[1]}; epoch losses {losses}; launches {launches}")
    if (len(losses) != GROUP_LEARN_EPOCHS or not np.isfinite(losses).all()
            or not losses[-1] < 0.75 * losses[0]):
        raise AssertionError(f"group_embed loss did not fall on grids with empty pillars: {losses}")

    # weight_sharing at bench.py:359-368's shape and VoxelEmbed_Hybrid at 128^3, an epoch each
    for route, argv, passes, steps, evals, adam in (
            ("weight_sharing", ["--dataset", "ModelNet40", "--synthetic", "512", "--batchSize",
                                "32", "--transformer-name", BACKBONE, "--embed-layer",
                                "VoxelEmbed_no_average", "--cell-size", "6", "--patch-size", "5",
                                "--pos-embedding", "weight_sharing", "--lr", "1e-3", "--dtype",
                                "bf16"], 1, 16, 4, False),
            ("VoxelEmbed_Hybrid", ["--dataset", "ShapeNetV2", "--synthetic", "48", "--batchSize",
                                   "16", "--transformer-name", BACKBONE, "--embed-layer",
                                   "VoxelEmbed_Hybrid", "--patch-size", "1", "--lr", "1e-3"],
             1, 3, 1, True)):
        plain_before = Attention.plain_calls
        _, lines, launches, saved = run_cli(
            train_cls_voxel.main, lambda o, argv=argv: [*argv, "--epochs", "1", "--outf", o],
            counters)
        plain = Attention.plain_calls - plain_before
        want = voxel_launches(passes, steps, evals, adam)
        epochs = [line for line in lines if line.startswith("Epoch ")]
        print(f"{route} CLI: {' | '.join(epochs)}; launches {launches} (want {want}); plain "
              f"attention calls {plain}")
        if len(epochs) != 1 or launches != want or plain or not saved:
            raise AssertionError(f"{route} CLI: {lines[-3:]}; launches {launches}, want {want}")
    print(f"group_embed phase: {time.perf_counter() - t0:.1f} s")


# ViP-3D: the JAX package's bench.py:338-343 record (vip3d_s7 with
# VoxelEmbed_m40_vip_s7: ModelNet40's 30^3 grids padded to 32^3, 8^3 tokens,
# 40 classes, B=32, Adam, drop path 0.1), through train_pure_mlp in f32 and bf16
VIP_MODEL, VIP_EMBED, VIP_B = "vip3d_s7", "VoxelEmbed_m40_vip_s7", 32
VIP_LOSS_RTOL = {False: 1e-3, True: 2e-3}  # f32, bf16: as the other paths' checks
# each leaf's gradient card vs CPU, of its largest value: f32 sums in another
# order; bf16 rounding
VIP_GRAD_REL = {False: 1e-4, True: 2e-2}
# the loss-falls run: 64 samples, 2 steps an epoch, 20 epochs (40 steps); the
# base lr the untuned warmup scales by (epoch + 1) / 2000
VIP_SAMPLES, VIP_EPOCHS, VIP_LR = 64, 20, 0.05
VIP_TIMED_STEPS = 50
# the device time of a ViP-3D step by kind: the first kind whose pattern a
# kernel's name holds (PyTorch's and cuBLAS's kernels, and the Adam kernel);
# profile_steps groups by the patterns and sorts the groups into the kinds
VIP_KINDS = (("Adam", ("adam_kernel",)),
             ("products", ("gemm", "Gemm", "nvjet", "cutlass", "xmma", "splitK", "gemv",
                           "dot_kernel")),
             ("permutes/copies", ("copy", "Copy")),
             ("LayerNorm", ("layer_norm", "LayerNorm", "GammaBeta")),
             ("reductions", ("reduce_kernel",)),
             ("softmax", ("softmax", "Softmax")),
             ("elementwise", ("elementwise", "Elementwise", "vectorized")))


def vip_argv(*extra) -> list[str]:
    return ["--dataset", "ModelNet40", "--model-name", VIP_MODEL, "--embed-layer", VIP_EMBED,
            "--batchSize", str(VIP_B), *extra]


def vip_model(torch, device, dtype=None, drop_path=0.1):
    """vip3d_s7 on the m40 tokenizer with seeded random weights (the CLI's
    build_model; drop path 0.1, the CLI's default)."""
    import argparse

    from simple3dformer_tpu_torch.cli import train_pure_mlp as tpm
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED

    args = argparse.Namespace(embed_layer=VIP_EMBED, model_name=VIP_MODEL, seed=DEFAULT_SEED,
                              drop_path=drop_path, pos_embedding="default")
    return tpm.build_model(args, N_CLASSES, dtype).to(device)


def vip_grids(n, seed):
    """n synthetic ModelNet40 grids, 30^3 padded to 32^3 as the CLI pads them."""
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels

    x, y = synthetic_voxels(n, VOXEL, N_CLASSES, seed=DEFAULT_SEED + seed)
    return np.pad(x, [(0, 0), (0, 2), (0, 2), (0, 2)]), y


def vip_parity(torch, bf16):
    """The gradients of the first batch, then 3 train steps, at B=32 on the card
    and on the CPU's plain path from the same weights and batches, drop path
    off."""
    from simple3dformer_tpu_torch.train.loop import TrainState, cross_entropy, make_train_step
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    dtype = torch.bfloat16 if bf16 else None
    x, y = vip_grids(3 * VIP_B, 4)
    grads, losses, seconds = {}, {}, {}
    for device in ("cuda", "cpu"):
        model = vip_model(torch, device, dtype, drop_path=0.0)
        names, leaves = zip(*model.named_parameters())
        grads[device] = dict(zip(names, (g.cpu() for g in torch.autograd.grad(cross_entropy(
            model.train()(torch.from_numpy(x[:VIP_B]).float().to(device)),
            torch.from_numpy(y[:VIP_B]).to(device)), leaves))))
        step = make_train_step(TrainState(model, make_optimizer(dict(model.named_parameters()),
                                                                "Adam")))
        t0, out = time.perf_counter(), []
        for i in range(CPU_PARITY_STEPS):
            sl = slice(i * VIP_B, (i + 1) * VIP_B)
            out.append(float(step({"x": torch.from_numpy(x[sl]).float().to(device),
                                   "y": torch.from_numpy(y[sl]).to(device)}, 1e-4)["loss"]))
        losses[device], seconds[device] = out, time.perf_counter() - t0
    errs = {k: float((grads["cuda"][k] - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for k, b in grads["cpu"].items()}
    worst = max(errs, key=lambda k: (np.isnan(errs[k]), errs[k]))
    grad_err = errs[worst]
    label = "bf16" if bf16 else "f32"
    print(f"ViP-3D {label}: {VIP_MODEL} at B={VIP_B}, drop path off: gradients card vs the CPU's "
          f"plain path within {grad_err:.3e} of each leaf's largest, at {worst} (tolerance "
          f"{VIP_GRAD_REL[bf16]}); {CPU_PARITY_STEPS} steps at lr 1e-4, losses on the card "
          f"{losses['cuda']} vs "
          f"the CPU's {losses['cpu']} (rtol {VIP_LOSS_RTOL[bf16]}); {seconds['cuda']:.1f} s on "
          f"the card, {seconds['cpu']:.1f} s on the CPU")
    if not grad_err <= VIP_GRAD_REL[bf16]:
        raise AssertionError(f"ViP-3D {label} gradients differ from the CPU's: {grad_err}")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=VIP_LOSS_RTOL[bf16])


def vip_cli(torch, counters, argv, label, samples, epochs, batch):
    """train_pure_mlp through run_cli; checks its lines and that the Adam kernel
    ran once a step; returns the epoch losses and the launches."""
    from simple3dformer_tpu_torch.cli import train_pure_mlp

    _, lines, launches, saved = run_cli(
        train_pure_mlp.main, lambda o: [*argv, "--synthetic", str(samples), "--epochs",
                                        str(epochs), "--outf", o], counters)
    steps = epochs * (samples // batch)
    epoch_lines = [line for line in lines if line.startswith("Epoch ")]
    losses = [float(line.split()[3]) for line in epoch_lines]
    print(f"ViP-3D CLI {label}: {steps} steps, epoch losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{epoch_lines[-1]}; checkpoints at epochs {saved}; launches {launches} (want "
          f"fused_adam {steps})")
    if (len(losses) != epochs or not np.isfinite(losses).all() or not saved
            or not lines[-1].startswith("Best test accuracy: epoch ")):
        raise AssertionError(f"ViP-3D CLI {label}: {lines[-3:]}")
    if launches != {"fused_adam": steps}:
        raise AssertionError(f"ViP-3D CLI {label}: launches {launches}, want {steps} Adam")
    return losses, launches


def capture_check(torch):
    """capture_attention on the flagship (deit_small, 26 tokens) on the card
    against the CPU: the maps and the rollout masks within 1e-4, no block or
    mhsa kernel launched and 12 plain attention calls a capture; the next
    ordinary forward launches the fused block again."""
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.kernels import mhsa as mk
    from simple3dformer_tpu_torch.nn.layers import Attention
    from simple3dformer_tpu_torch.utils.attention_rollout import capture_attention, rollout

    x = torch.from_numpy(synthetic_voxels(4, VOXEL, N_CLASSES, seed=41)[0]).float()
    counters = {**voxel_counters(), "mhsa_fwd": mk.mhsa_fwd, "mhsa_bwd": mk.mhsa_bwd}
    for fn in counters.values():
        fn.launches = 0
    plain = Attention.plain_calls
    model = flagship_model(torch, "cuda")
    out, maps = capture_attention(model, x.cuda())
    torch.cuda.synchronize()
    during = {k: fn.launches for k, fn in counters.items()}
    plain = Attention.plain_calls - plain
    with torch.inference_mode():
        model.eval()(x.cuda())
    torch.cuda.synchronize()
    after = counters["fused_vit_block"].launches - during["fused_vit_block"]
    cpu_out, cpu_maps = capture_attention(flagship_model(torch, "cpu"), x)
    err = float((maps.cpu() - cpu_maps).abs().max())
    logit_err = float((out.cpu() - cpu_out).abs().max())
    mask_err = max(float(np.abs(rollout(maps[:, i].cpu().numpy())[0]
                                - rollout(cpu_maps[:, i].numpy())[0]).max()) for i in range(4))
    print(f"attention capture (flagship, deit_small, 26 tokens, B=4): maps {tuple(maps.shape)} "
          f"card vs CPU max abs {err:.3e}, rollout masks {mask_err:.3e} (tolerance 1e-4), logits "
          f"{logit_err:.3e}; launches during the capture {during}, plain attention calls {plain}; "
          f"fused block launches of the next ordinary forward {after}")
    if tuple(maps.shape) != (12, 4, 6, 26, 26) or err > 1e-4 or mask_err > 1e-4:
        raise AssertionError(f"attention capture differs from the CPU's: {err}, {mask_err}")
    if any(during.values()) or plain != 12 or after != 12:
        raise AssertionError(f"attention capture launches {during}, plain {plain}, after {after}")


def point_cloud_prediction_check(torch):
    """visualize_point_cloud.predict at the partseg default (3DViT, deit_tiny,
    N=1024, B=1) on the card against the CPU; the launches of the fused block,
    FPS, kNN and the gather forward equal to the model's."""
    from simple3dformer_tpu_torch.cli import visualize_point_cloud as vpc
    from simple3dformer_tpu_torch.cli.train_partseg import load_arrays

    n = 2
    cfg = seg_config("partseg", synthetic=n, num_point=PN, seed=9)
    _, (te_x, te_c, te_s) = load_arrays(cfg)
    te_x, te_c, te_s = te_x[:n], te_c[:n], te_s[:n]
    counters = point_counters()
    for fn in counters.values():
        fn.launches = 0
    got = vpc.predict(partseg_model(torch, "cuda"), te_x, te_c, te_s, "cuda")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    want = vpc.predict(partseg_model(torch, "cpu"), te_x, te_c, te_s, "cpu")
    # a forward: FPS 1, kNN 4, gathers 8 (as the partseg phase counts), 12 blocks
    want_launches = {"fps": n, "knn": 4 * n, "gather_fwd": 8 * n, "gather_bwd": 0,
                     "fused_vit_block": 12 * n, "fused_vit_block_train_fwd": 0,
                     "fused_vit_block_train_bwd": 0}
    errs, flips = [], 0
    for (lg, pred, cat), (lc, pc, cc) in zip(got, want):
        errs.append(float(np.abs(lg - lc).max() / np.abs(lc).max()))
        top2 = np.sort(lc, -1)[:, -2:]
        near = (top2[:, 1] - top2[:, 0]) <= 1e-3 * np.abs(lc).max()
        flips += int(((pred != pc) & ~near).sum())
        assert cat == cc
    print(f"point-cloud prediction (partseg default, 3DViT deit_tiny, N={PN}, {n} samples at "
          f"B=1): logits card vs CPU {max(errs):.3e} of the largest (tolerance 1e-3), predicted "
          f"labels differing beyond near-ties {flips}; launches {launches} (want {want_launches})")
    if max(errs) > 1e-3 or flips or launches != want_launches:
        raise AssertionError(f"point-cloud prediction: {errs}, {flips} flips, {launches}")


def phase_vip3d(torch):
    """ViP-3D through train_pure_mlp at full width in f32 and bf16, its other
    routes through the CLI, and the visualizers' compute: the attention
    capture and the point-cloud prediction."""
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.kernels.adam import fused_adam
    from simple3dformer_tpu_torch.train.loop import TrainState, make_scanned_train_steps
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    t0 = time.perf_counter()
    for bf16 in (False, True):
        vip_parity(torch, bf16)

    # the main path: the CLI on a synthetic corpus on the card, the loss falls
    counters = {"fused_adam": fused_adam}
    for bf16 in (False, True):
        label = f"{VIP_MODEL} {'bf16' if bf16 else 'f32'}"
        argv = vip_argv("--lr", str(VIP_LR), *(["--dtype", "bf16"] if bf16 else []))
        losses, _ = vip_cli(torch, counters, argv, label, VIP_SAMPLES, VIP_EPOCHS, VIP_B)
        if not losses[-1] < 0.75 * losses[0]:
            raise AssertionError(f"ViP-3D {label} training loss did not fall: {losses}")

    # ms a step over 50 steps ending in a sync, the busy share, the device time
    # by kind, the launches a step and the peak memory
    x, y = vip_grids((VIP_TIMED_STEPS + 1) * VIP_B, 5)
    ds = DeviceResidentDataset({"x": x, "y": y}, "cuda")
    idx = ds.put_indices(np.arange(len(x)).reshape(-1, VIP_B))
    kinds = dict(groups=tuple(p for _, pats in VIP_KINDS for p in pats), categories=VIP_KINDS)
    for bf16 in (False, True):
        label = f"ViP-3D {VIP_MODEL} {'bf16' if bf16 else 'f32'}"
        model = vip_model(torch, "cuda", torch.bfloat16 if bf16 else None)
        run = make_scanned_train_steps(TrainState(model, make_optimizer(
            dict(model.named_parameters()), "Adam")), ds)
        timed_steps(torch, run, idx, 1e-4, VIP_TIMED_STEPS, label, VIP_B, **kinds)
        del model, run
    del ds, idx
    torch.cuda.empty_cache()

    # the other routes, an epoch each: PEG, the 128^3 ShapeNetV2 family, vip3d_m7
    for label, argv, samples, batch in (
            ("PEG", vip_argv("--pos-embedding", "PEG"), 64, VIP_B),
            ("VoxelEmbed_vip_s7 128^3", ["--dataset", "ShapeNetV2", "--embed-layer",
                                         "VoxelEmbed_vip_s7", "--batchSize", "16"], 48, 16),
            ("vip3d_m7", ["--dataset", "ModelNet40", "--model-name", "vip3d_m7",
                          "--embed-layer", "VoxelEmbed_m40_vip_m7", "--batchSize",
                          str(VIP_B)], 64, VIP_B)):
        vip_cli(torch, counters, argv, label, samples, 1, batch)

    capture_check(torch)
    point_cloud_prediction_check(torch)
    print(f"ViP-3D and visualizers phase: {time.perf_counter() - t0:.1f} s")


# Predictor.export: the flagship predictor (phase 4's, batch 32; its block op
# is the one a group_embed model exports, and ViP-3D exports no op: both are
# the CPU tests') and the point models at their phases' shapes: the partseg 3DViT
# (phase 8, B=PB), 3DViT_s3dis (phase 10, deit_base, 1025 tokens, the mhsa op)
# and Hengshuang cls in f32 (phase 12, the pre-gathered vector-attention op) and
# bf16 (phase 14, the in-kernel-gather op), all exported on the card and loaded
# in a fresh process that imports no model code; their logits against the
# eager Predictor's, and each kernel's launches a call inside the ops against
# the eager forward's
EXPORT_REL = 1e-6  # of the largest logit: the same ops in the same order
EXPORT_CALLS = 50  # timed calls of the flagship's exported callable and Predictor
POINT_EXPORT_CALLS = 20  # timed calls of each point model's
# the forward kernels an exported program calls as ops, by counter name
EXPORT_COUNTERS = {"fused_vit_block": ("vit_block", "fused_vit_block"),
                   "fps": ("fps", "fps"), "knn": ("knn", "knn"),
                   "gather_fwd": ("gather", "gather_fwd"), "mhsa_fwd": ("mhsa", "mhsa_fwd"),
                   "vector_attention_fwd": ("vector_attention", "vector_attention_fwd"),
                   "vector_attention_gather_fwd": ("vector_attention", "gather_attention_fwd")}
# the fresh process: load_exported of each artifact, its logits, the launches a
# call of each kernel (counted inside the ops), each model's latency over the
# calls names.json gives it, and the modules of the port it imported
EXPORT_LOADER = """
import importlib, json, sys, time
import numpy as np
from simple3dformer_tpu_torch.serve.predictor import load_exported
d = sys.argv[1]
spec = json.load(open(f"{d}/names.json"))
counters = {k: getattr(importlib.import_module("simple3dformer_tpu_torch.kernels." + m), f)
            for k, (m, f) in spec["counters"].items()}
def counts():
    return {k: c.launches for k, c in counters.items()}
report = {"launches": {}, "timed": {}, "p50": {}, "p95": {}}
for name, calls in spec["calls"].items():
    fn, x = load_exported(f"{d}/{name}.pt2"), np.load(f"{d}/{name}.x.npy")
    before = counts()
    np.save(f"{d}/{name}.got.npy", fn(x))
    mid = counts()
    report["launches"][name] = {k: mid[k] - before[k] for k in mid}
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn(x)
        lat.append(time.perf_counter() - t0)
    report["timed"][name] = {k: v - mid[k] for k, v in counts().items()}
    report["p50"][name], report["p95"][name] = (float(np.percentile(lat, q) * 1e3)
                                                for q in (50, 95))
report["modules"] = sorted(m for m in sys.modules if m.startswith("simple3dformer"))
print(json.dumps(report))
"""
EXPORT_MODULES = ["simple3dformer_tpu_torch", "simple3dformer_tpu_torch.kernels",
                  "simple3dformer_tpu_torch.kernels.build", "simple3dformer_tpu_torch.kernels.fps",
                  "simple3dformer_tpu_torch.kernels.gather", "simple3dformer_tpu_torch.kernels.knn",
                  "simple3dformer_tpu_torch.kernels.mhsa",
                  "simple3dformer_tpu_torch.kernels.vector_attention",
                  "simple3dformer_tpu_torch.kernels.vit_block",
                  "simple3dformer_tpu_torch.serve", "simple3dformer_tpu_torch.serve.predictor"]


def export_counts() -> dict:
    """Each exported forward kernel's launch counter, by EXPORT_COUNTERS name."""
    import importlib

    return {k: getattr(importlib.import_module(f"simple3dformer_tpu_torch.kernels.{m}"),
                       f).launches for k, (m, f) in EXPORT_COUNTERS.items()}


def export_point_models(torch) -> dict:
    """name -> (model on the card, input, the kernels its forward must launch)."""
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.registry import make_point_model

    rs = np.random.RandomState(14)

    def clouds(b, n, c):
        x = rs.randn(b, n, c).astype(np.float32)
        x[..., :3] = rs.rand(b, n, 3)
        return x

    point = ("fps", "knn", "gather_fwd")
    heng = {dtype: make_point_model(hengshuang_config(), "cls", dtype=dtype,
                                    generator=generator(DEFAULT_SEED)).to("cuda")
            for dtype in (None, torch.bfloat16)}
    return {"partseg": (partseg_model(torch, "cuda"), clouds(PB, PN, 22),
                        (*point, "fused_vit_block")),
            "s3dis": (make_point_model(s3dis_config(), "seg",
                                       generator=generator(DEFAULT_SEED)).to("cuda"),
                      clouds(SB, SN, 9), (*point, "mhsa_fwd")),
            "hengshuang": (heng[None], clouds(HB, HN, 6), (*point, "vector_attention_fwd")),
            "hengshuang_bf16": (heng[torch.bfloat16], clouds(HB, HN, 6),
                                (*point, "vector_attention_gather_fwd"))}


def phase_export(torch):
    """Predictor.export / load_exported on the card. Returns the block launches
    of the exported flagship's calls (each counted inside the op)."""
    import os
    import tempfile

    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.serve.predictor import Predictor

    t0 = time.perf_counter()
    grids, _ = synthetic_voxels(BATCH, VOXEL, N_CLASSES, seed=11)
    models = {"flagship": (flagship_model(torch, "cuda"), grids.astype(np.float32),
                           ("fused_vit_block",)),
              **export_point_models(torch)}
    calls = {name: EXPORT_CALLS if name == "flagship" else POINT_EXPORT_CALLS
             for name in models}
    want, predictors, nodes, eager = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as d:
        for name, (model, x, _) in models.items():
            predictor = Predictor(model, x.shape[1:], device="cuda", batch_size=len(x))
            t1 = time.perf_counter()
            predictor.export(os.path.join(d, f"{name}.pt2"))
            program = torch.export.load(os.path.join(d, f"{name}.pt2"))
            nodes[name] = collections.Counter(
                str(n.target).split(".")[1] for n in program.graph.nodes
                if n.op == "call_function" and str(n.target).startswith("s3f."))
            mib = os.path.getsize(os.path.join(d, f"{name}.pt2")) / 2**20
            print(f"export {name}: Predictor at batch {len(x)} on the card exported in "
                  f"{time.perf_counter() - t1:.1f} s ({mib:.1f} MiB); op nodes in the program "
                  f"{dict(nodes[name])}")
            before = export_counts()
            want[name], predictors[name] = predictor(x), predictor
            eager[name] = {k: v - before[k] for k, v in export_counts().items()}
            np.save(os.path.join(d, f"{name}.x.npy"), x)
        with open(os.path.join(d, "names.json"), "w") as f:
            json.dump({"calls": calls, "counters": EXPORT_COUNTERS}, f)
        out = subprocess.run([sys.executable, "-c", EXPORT_LOADER, d],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise AssertionError(f"loading the exported programs failed:\n{out.stderr[-4000:]}")
        report = json.loads(out.stdout.splitlines()[-1])
        got = {name: np.load(os.path.join(d, f"{name}.got.npy")) for name in models}

    for name, (_, x, kernels) in models.items():
        err = float(np.abs(got[name] - want[name]).max()) / float(np.abs(want[name]).max())
        same = np.array_equal(got[name], want[name])
        n = {k: v for k, v in report["launches"][name].items() if v}
        timed = {k: v for k, v in report["timed"][name].items() if v}
        want_n = {k: v for k, v in eager[name].items() if v}
        print(f"export {name}: the exported program in a fresh process against the eager "
              f"Predictor: logits {got[name].shape}, error {err:.3e} of the largest (tolerance "
              f"{EXPORT_REL}), bit-equal {same}; launches a call inside the ops {n}, the eager "
              f"forward's {want_n}")
        # each op node launches its kernel once a call
        if (err > EXPORT_REL or got[name].shape != want[name].shape or n != want_n
                or any(k not in n for k in kernels)
                or timed != {k: v * calls[name] for k, v in n.items()}
                or {op_name(k): v for k, v in n.items()} != dict(nodes[name])):
            raise AssertionError(f"exported {name}: err {err}, launches {n} (eager {want_n}, "
                                 f"{calls[name]} timed calls {timed}), op nodes {nodes[name]}, "
                                 f"kernels {kernels}")
    if report["modules"] != EXPORT_MODULES:
        raise AssertionError(f"loading needed more of the port: {report['modules']}")
    for name, (_, x, _) in models.items():
        lat = []
        for _ in range(calls[name]):
            t1 = time.perf_counter()
            predictors[name](x)
            lat.append(time.perf_counter() - t1)
        lat_ms = np.asarray(lat) * 1e3
        print(f"export {name} latency at batch {len(x)} (host clock, {calls[name]} calls each, "
              f"numpy in and out): exported callable in a fresh process p50 "
              f"{report['p50'][name]:.3f} ms, p95 {report['p95'][name]:.3f} ms; the eager "
              f"Predictor here p50 {np.percentile(lat_ms, 50):.3f} ms, p95 "
              f"{np.percentile(lat_ms, 95):.3f} ms")
    print(f"export: the fresh process imported only {report['modules']}")
    print(f"export phase: {time.perf_counter() - t0:.1f} s")
    return (report["launches"]["flagship"]["fused_vit_block"]
            + report["timed"]["flagship"]["fused_vit_block"])


def op_name(counter: str) -> str:
    """The s3f op that launches the kernel of an EXPORT_COUNTERS name."""
    return {"fused_vit_block": "vit_block_fwd",
            "vector_attention_gather_fwd": "gather_attention_fwd"}.get(counter, counter)


# data parallel (phase 24): (a) the CLIs at world 1 through the env:// rendezvous
# over NCCL; (b) two ranks on the one card over gloo against world 1 at
# B=32 global; (c) one NCCL rank a card where the machine shows more than one
DP_B, DP_STEPS = 32, 3
DP_SGD_LR, DP_ADAM_LR = 0.01, 1e-4
DP_SAMPLES = 64  # the CLIs: 2 steps of B=32 (4 of partseg's B=16) and one eval epoch
# world 2 against world 1: the CPU test's tolerances for SGD (tests/test_torch_parallel.py);
# Adam's update is about lr a step whatever the gradient's scale, so a component
# whose gradient is near 0 may flip its sign: 2 lr a step at most
DP_LOSS_TOL = dict(rtol=1e-4)
DP_SGD_TOL = dict(rtol=2e-4, atol=2e-5)
DP_ADAM_TOL = dict(rtol=0, atol=2 * DP_STEPS * DP_ADAM_LR)
# the partseg model max-pools over neighbours after ReLUs: a rounding-level
# difference (BatchNorm's sums, the gradients' sums) can move a max or a kink
# and route a gradient elsewhere. Where a partseg element leaves DP_SGD_TOL,
# the kink trace (DecisionTrace) must account for it: world 1 replaying
# world 2's decisions holds every element to DP_SGD_TOL


# The kink trace. A split batch sums BatchNorm's statistics, and the
# gradients, in another order than one process; where a ReLU's input or the
# gap between a max-pool's best two neighbours lies at rounding level, that
# order decides where a gradient goes. DecisionTrace records every such
# decision of a point model's train-mode forward, in call order (each
# BatchNorm's output sign, which the ReLU after it keeps; after a set
# abstraction's last BatchNorm the neighbour each channel's max picks; each
# nn.ReLU's input sign), with the elements within KINK_NEAR of a kink or a
# tie and their values in f32 and recomputed in f64 from the same f32 input
# and the batch's statistics in f64. In replay it imposes recorded decisions
# on a run: each sign flipped by negating the element (a change of its own
# size, at rounding level), each max moved by raising the recorded
# neighbour just above the max. A run at world 1 replaying the split run's
# decisions is the split run's computation with the routing held equal, so
# what is left between the two is the order of the sums alone.
KINK_NEAR = 1e-4
TINY = 1e-30


class DecisionTrace:
    def __init__(self, torch, model, replay: list | None = None):
        from simple3dformer_tpu_torch.kernels import vector_attention as va
        from simple3dformer_tpu_torch.nn.layers import BatchNorm
        from simple3dformer_tpu_torch.nn.set_abstraction import PointNetSetAbstraction

        self.torch, self.records, self.handles, self.replay, self.calls = torch, [], [], replay, 0
        # the vector attention's ReLU after fc_gamma's hidden layer: recorded
        # from the kernel's kept relu(hg); replayed through the plain chain
        self.va, self.va_saved = va, (va.vector_attention_fwd, va.vector_attention)
        if replay is None:
            def record(*args, **kwargs):
                return self.va_record(*args, **kwargs)

            # the kernel wrapper counts its launches on the module's name
            record.launches = 0
            va.vector_attention_fwd = record
        else:
            va.vector_attention = self.va_replay
        pooled = {id(m.mlp_bns[-1]) for m in model.modules()
                  if isinstance(m, PointNetSetAbstraction)}
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                self.handles.append(m.register_forward_hook(
                    lambda mod, inp, out, name=name, pool=id(m) in pooled:
                    self.bn(name, pool, mod, inp[0], out)))
            elif isinstance(m, torch.nn.ReLU):
                self.handles.append(m.register_forward_pre_hook(
                    lambda mod, inp, name=name: self.relu(name, mod, inp[0])))

    def flip(self, y, pos):
        """y with the recorded signs ``pos``: a flipped element negated in value;
        the gradient passes as through y itself (the ReLU after it decides)."""
        torch = self.torch
        want = torch.where(pos & (y <= 0), y.abs() + TINY, torch.where(~pos & (y > 0), -y, y))
        return y + (want - y).detach()

    def relu(self, name, mod, x):
        if not mod.training:
            return None
        i, self.calls = self.calls, self.calls + 1
        if self.replay is not None:
            return (self.flip(x, self.replay[i]["sign"].to(x.device)),)
        self.records.append({"name": name, "shape": tuple(x.shape),
                             "sign": np.packbits(x.detach().gt(0).reshape(-1).cpu().numpy())})
        return None

    def bn(self, name, pool, mod, x, y):
        torch = self.torch
        from simple3dformer_tpu_torch.parallel import mesh

        if not mod.training:
            return None
        i, self.calls = self.calls, self.calls + 1
        if self.replay is not None:
            rec = self.replay[i]
            y = self.flip(y, rec["sign"].to(y.device))
            if pool:
                r = y.clamp_min(0)
                mx = r.amax(2, keepdim=True)
                chosen = torch.zeros_like(y, dtype=torch.bool).scatter_(
                    2, rec["arg"].to(y.device).long()[:, :, None, :], True)
                ties = (r == mx).sum(2, keepdim=True) > 1
                need = (chosen & (rec["live"] & ~rec["tied"]).to(y.device)[:, :, None, :]
                        & ((r < mx) | ties))
                y = y + (torch.where(need, mx + mx.abs() * 1e-6 + TINY, y) - y).detach()
            return y
        x64 = x.detach().double().reshape(-1, x.shape[-1])
        stats = torch.cat([x64.sum(0), (x64 * x64).sum(0), x64.new_full((1,), x64.shape[0])])
        group, ranks = mesh.batch_stats_reduction()
        if ranks > 1:
            torch.distributed.all_reduce(stats, group=group)
        c = x.shape[-1]
        mean = stats[:c] / stats[-1]
        var = torch.clamp_min(stats[c:2 * c] / stats[-1] - mean * mean, 0.0)
        y64 = ((x.detach().double() - mean) * (torch.rsqrt(var + mod.eps) * mod.weight.double())
               + mod.bias.double())
        y = y.detach()
        near = (y.abs() < KINK_NEAR).reshape(-1).nonzero().squeeze(1)
        rec = {"name": name, "shape": tuple(y.shape),
               "sign": np.packbits(y.gt(0).reshape(-1).cpu().numpy()),
               "near": near.cpu(), "near_y": y.reshape(-1)[near].cpu(),
               "near_y64": y64.reshape(-1)[near].cpu()}
        if pool:  # relu, then the max over the neighbour axis (2)
            r = y.clamp_min(0)
            top = r.topk(2, dim=2)
            # an exact tie keeps amax's split of the gradient: not replayed
            rec.update(arg=top.indices[:, :, 0].to(torch.uint8).cpu(),
                       live=(top.values[:, :, 0] > 0).cpu(),
                       tied=(top.values[:, :, 0] == top.values[:, :, 1]).cpu())
        self.records.append(rec)
        return None

    def va_record(self, q, k, v, rel, weights, save=False):
        out, res = self.va_saved[0](q, k, v, rel, weights, save=save)
        if save:  # a training forward
            self.calls += 1
            b, n, kk, d = k.shape
            if q.is_cuda:  # the kernel's kept x = q - k + pos and relu(hg)
                x, hg = res["x"].reshape(b, n, kk, d), res["hg"].reshape(b, n, kk, d)
            else:  # the plain chain's own
                chain = self.va._chain(q, k, v, rel, weights)
                x, hg = chain[3], chain[5]
            pre64 = torch_linear64(self.torch, x.detach(), weights["wg1"], weights["bg1"])
            near = (pre64.abs() < KINK_NEAR).reshape(-1).nonzero().squeeze(1)
            self.records.append({"name": "vector attention relu(fc_gamma hidden)",
                                 "shape": (b, n, kk, d),
                                 "sign": np.packbits(hg.detach().gt(0).reshape(-1).cpu().numpy()),
                                 "near": near.cpu(), "near_y": pre64.reshape(-1)[near].float().cpu(),
                                 "near_y64": pre64.reshape(-1)[near].cpu()})
        return out, res

    def va_replay(self, q, k, v, rel, w):
        torch = self.torch
        F = torch.nn.functional
        i, self.calls = self.calls, self.calls + 1
        pos = F.linear(torch.relu(F.linear(rel, w["wd1"], w["bd1"])), w["wd2"], w["bd2"])
        x = q[:, :, None, :] - k + pos
        hg = torch.relu(self.flip(F.linear(x, w["wg1"], w["bg1"]),
                                  self.replay[i]["sign"].to(x.device)))
        z = F.linear(hg, w["wg2"], w["bg2"]) / q.shape[-1] ** 0.5
        return ((z - z.amax(2, keepdim=True)).softmax(2) * (v + pos)).sum(2)

    def remove(self):
        for h in self.handles:
            h.remove()
        if self.replay is None:
            self.va_saved[0].launches += self.va.vector_attention_fwd.launches
        self.va.vector_attention_fwd, self.va.vector_attention = self.va_saved


def torch_linear64(torch, x, w, b):
    """x w^T + b in f64 from f32 operands."""
    return torch.nn.functional.linear(x.double(), w.detach().double(), b.detach().double())


def decisions(torch, rec: dict):
    """A record's decisions as tensors: {"sign": bool [shape], "arg", "live"}."""
    n = int(np.prod(rec["shape"]))
    out = {"sign": torch.from_numpy(np.unpackbits(rec["sign"])[:n].astype(bool))
           .reshape(rec["shape"])}
    if "arg" in rec:
        out.update(arg=rec["arg"], live=rec["live"], tied=rec["tied"])
    return out


def gathered_decisions(torch, ranks: list[list], axis: int) -> list:
    """Every call's decisions of the split run laid together along the split
    axis (0: the batch; 1: the points); a record of two dims under a point
    split is the pooled features', equal on every rank."""
    out = []
    for recs in zip(*ranks):
        parts = [decisions(torch, r) for r in recs]
        ax = axis if axis == 0 or len(recs[0]["shape"]) > 2 else None
        if ax is None:
            out.append(parts[0])
            continue
        full = {"sign": torch.cat([p["sign"] for p in parts], ax)}
        if "arg" in parts[0]:
            full.update({k: torch.cat([p[k] for p in parts], ax) for k in ("arg", "live", "tied")})
        out.append(full)
    return out


def kink_report(torch, world1: list, split: list) -> dict:
    """World 1's decisions against the split run's (``split``: gathered
    decisions, call for call): the ReLU signs and max-pool choices that
    differ, the first call where one does, and the f32 and f64 values there."""
    first, flips, moved, lines = None, 0, 0, []
    for i, (w1, w2) in enumerate(zip(world1, split)):
        d1 = decisions(torch, w1)
        diff = (d1["sign"] != w2["sign"]).reshape(-1).nonzero().squeeze(1)
        mv = 0
        if "arg" in w1:
            mv = int(((d1["arg"] != w2["arg"]) & (d1["live"] | w2["live"])).sum())
        if len(diff) or mv:
            flips, moved = flips + len(diff), moved + mv
            first = first or (i, w1["name"])
            near = dict(zip(w1.get("near", torch.zeros(0)).tolist(),
                            zip(w1.get("near_y", torch.zeros(0)).tolist(),
                                w1.get("near_y64", torch.zeros(0)).tolist())))
            at = [f"{near[j][0]:.3e} (f64 {near[j][1]:.3e})" for j in diff[:4].tolist()
                  if j in near]
            lines.append(f"call {i} ({w1['name']}, {w1['shape']}): {len(diff)} ReLU signs differ "
                         f"(world 1's values there, f32 and f64: {at}); {mv} maxes pick another "
                         f"neighbour")
    return {"first": first, "flips": flips, "moved_maxes": moved, "lines": lines}


def dp_runs(torch, device, flagship: bool = True, replay: list | None = None) -> dict:
    """The port's data-parallel step functions (make_scanned_train_steps) on
    ``device`` at the world size of the process group (none: world 1), on the
    global batches of B=32: the flagship at full width, 3 steps of SGD, of
    Adam (the kernel on whole leaves) and of ZeRO-1 Adam (the kernel on this
    rank's part of the flat parameters); the partseg 3DViT at full width, 3
    SGD steps with its BatchNorm statistics over the global batch, its
    augmentation and FPS start points drawn for the global batch. Returns
    each run's losses, state (on the CPU), Adam launches and ms a step
    (the partseg run alone without ``flagship``)."""
    from simple3dformer_tpu_torch.cli import train_partseg as tp
    from simple3dformer_tpu_torch.core.config import Config
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator, step_seed
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.kernels.adam import fused_adam
    from simple3dformer_tpu_torch.models.voxel_vit import frozen_mask
    from simple3dformer_tpu_torch.train.loop import (TrainState, make_scanned_train_steps,
                                                     seg_cross_entropy)
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    def timed(run, idx, lr):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        losses = run(idx, lr)["loss"].cpu()
        return losses, (time.perf_counter() - t0) / DP_STEPS * 1e3

    out = {}
    grids, labels = synthetic_voxels(DP_STEPS * DP_B, VOXEL, N_CLASSES, seed=DEFAULT_SEED + 4)
    ds = DeviceResidentDataset({"x": grids, "y": labels}, device)
    idx = ds.put_indices(np.arange(DP_STEPS * DP_B).reshape(DP_STEPS, DP_B))
    for name, optimizer, zero1, lr in (("flagship SGD", "SGD", False, DP_SGD_LR),
                                       ("flagship Adam", "Adam", False, DP_ADAM_LR),
                                       ("flagship ZeRO-1", "Adam", True, DP_ADAM_LR))[
                                           :3 if flagship else 0]:
        model = flagship_model(torch, device)
        opt = make_optimizer(dict(model.named_parameters()), optimizer,
                             trainable_mask=frozen_mask(model, False), zero1=zero1)
        run = make_scanned_train_steps(TrainState(model, opt), ds)
        fused_adam.launches = 0
        losses, ms = timed(run, idx, lr)
        out[name] = {"loss": losses, "ms": ms, "adam": fused_adam.launches,
                     "state": {k: v.cpu() for k, v in model.state_dict().items()}}

    class Sampled(torch.nn.Module):
        """FPS start points drawn each step from a generator seeded with the step."""

        def __init__(self, model):
            super().__init__()
            self.m, self.state = model, None

        def forward(self, x):
            return self.m(x, sample_generator=generator(step_seed(DEFAULT_SEED, self.state.step)))

    (xs, cats, segs), _ = tp.load_arrays(Config(num_point=PN, normal=True,
                                                synthetic=DP_STEPS * DP_B, seed=DEFAULT_SEED))
    pds = DeviceResidentDataset({"x": xs, "cls": cats, "y": segs}, device)
    model = partseg_model(torch, device)
    wrapped = Sampled(model)
    wrapped.state = TrainState(wrapped, make_optimizer(dict(wrapped.named_parameters()), "SGD"))
    aug = torch.Generator(device=device).manual_seed(DEFAULT_SEED)
    run = make_scanned_train_steps(wrapped.state, pds, seg_cross_entropy,
                                   augment_fn=lambda x: tp.seg_augment(aug, x),
                                   prepare_fn=tp.make_prepare_fn())
    tracer = DecisionTrace(torch, model, replay)
    losses, ms = timed(run, idx, DP_SGD_LR)
    tracer.remove()
    out["partseg 3DViT"] = {"loss": losses, "ms": ms, "trace": tracer.records,
                            "state": {k: v.cpu() for k, v in model.state_dict().items()}}
    return out


def dp_worker(case_dir: str) -> int:
    """``chip_smoke.py --dp-worker DIR``: one rank of phase 24 (b), over gloo
    on the one card; writes DIR/rank<r>.pt."""
    import os

    import torch

    from simple3dformer_tpu_torch.parallel import mesh

    if not mesh.multihost_init("cpu") or mesh.world_size() != 2:
        raise RuntimeError("the phase 24 worker needs a rendezvous of two ranks")
    # gloo was chosen for the CPU; the tensors live on the one card
    torch.cuda.set_device(0)
    out = dp_runs(torch, torch.device("cuda", 0))
    torch.save(out, os.path.join(case_dir, f"rank{mesh.rank()}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launcher_env(world: int, rank: int, port: int) -> dict:
    import os

    return dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))


def dp_cli_world1(torch):
    """(a): train_cls_voxel plain, --zero1 and --zero1 --lwf, and train_partseg
    (3DViT), each through the env:// rendezvous at world size 1 (NCCL on the
    card, the group made by the first CLI and kept by the others): the
    devices line, finite epoch lines, a checkpoint, the launch counts."""
    import os
    import tempfile

    from simple3dformer_tpu_torch.cli import train_cls_voxel, train_partseg
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED

    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "DEIT_CKPT_DIR")
    saved_env = {k: os.environ.get(k) for k in keys}
    steps = DP_SAMPLES // DP_B
    evals = -(-max(DP_SAMPLES // 5, DP_B) // DP_B)
    voxel = ["--dataset", "ModelNet40", "--synthetic", str(DP_SAMPLES), "--epochs", "1",
             "--batchSize", str(DP_B), "--lr", str(TRAIN_LR), "--transformer-name", BACKBONE,
             "--cell-size", str(CELL), "--patch-size", str(PATCH)]
    runs = [("train_cls_voxel", train_cls_voxel.main, voxel, voxel_counters(),
             voxel_launches(1, steps, evals, True)),
            ("train_cls_voxel --zero1", train_cls_voxel.main, [*voxel, "--zero1"],
             voxel_counters(), voxel_launches(1, steps, evals, True)),
            ("train_cls_voxel --zero1 --lwf", train_cls_voxel.main, [*voxel, "--zero1", "--lwf"],
             voxel_counters(), {**voxel_launches(1, steps, evals, True),
                                "fused_vit_block": 12 * (steps + evals),
                                "fused_vit_block_train_fwd": 24 * steps,
                                "fused_vit_block_train_bwd": 24 * steps})]
    psteps, pevals = DP_SAMPLES // PB, -(-max(DP_SAMPLES // 5, 32) // PB)
    runs.append(("train_partseg", train_partseg.main,
                 ["model=3DViT", f"synthetic={DP_SAMPLES}", "epoch=1", f"batch_size={PB}",
                  f"learning_rate={PARTSEG_LR}", "seed=9"], point_counters(),
                 {"fps": psteps + pevals, "knn": 4 * (psteps + pevals),
                  "gather_fwd": 8 * (psteps + pevals), "gather_bwd": 4 * psteps,
                  "fused_vit_block_train_fwd": 12 * psteps,
                  "fused_vit_block_train_bwd": 12 * psteps, "fused_vit_block": 12 * pevals}))
    os.environ.update(launcher_env(1, 0, free_port()))
    all_launches = {}
    try:
        with tempfile.TemporaryDirectory() as weights:
            os.environ["DEIT_CKPT_DIR"] = weights  # no file: the random teacher, warned
            for label, main, argv, counters, want in runs:
                key = "--outf" if main is train_cls_voxel.main else "out_dir="

                def argv_for(d, argv=argv, key=key):
                    return [*argv, "--outf", d] if key == "--outf" else [*argv, f"out_dir={d}"]

                _, lines, launches, saved = run_cli(main, argv_for, counters)
                devices = [line for line in lines if line.startswith("devices:")]
                epochs = [line for line in lines if line.startswith("Epoch ")]
                zero = [line for line in lines if line.startswith("ZeRO-1:")]
                finite = all(np.isfinite(float(v)) for line in epochs
                             for v in re.findall(r"loss ([-0-9.naif]+)", line))
                print(f"data parallel (a) {label}: {devices[0]}; {len(epochs)} epoch lines "
                      f"{[e.split(' (')[0] for e in epochs]}; {zero}; checkpoints at "
                      f"epochs {saved}; launches {launches} (want {want})")
                if (not devices or "devices: 1 | rank 0 nccl | cuda:0" not in devices[0]
                        or not epochs or not finite or not saved):
                    raise AssertionError(f"data parallel (a) {label}: {lines[-8:]}")
                if "--zero1" in argv and zero != [
                        "ZeRO-1: 100% of optimizer-state bytes sharded over 'data' (1 ways)"]:
                    raise AssertionError(f"data parallel (a) {label}: ZeRO-1 line {zero}")
                if launches != want:
                    raise AssertionError(f"data parallel (a) {label}: launches {launches}, "
                                         f"want {want}")
                all_launches[label] = launches
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return all_launches


def leaves_outside(torch, got: dict, want: dict, tol: dict) -> dict:
    """{leaf: elements of ``got`` outside ``tol`` of ``want``}; integer leaves
    must be equal (a count of -1 where they are not)."""
    out = {}
    for k, v in want.items():
        if not v.is_floating_point():
            if not torch.equal(got[k], v):
                out[k] = -1
            continue
        off = int((~torch.isclose(got[k], v, rtol=tol["rtol"], atol=tol["atol"])).sum())
        if off:
            out[k] = off
    return out


def dp_compare(torch, ranks: list[dict], world1: dict, replayed: dict) -> None:
    """(b)'s checks: the ranks bit-equal to each other, ZeRO-1 bit-equal to
    replicated Adam, each run within its tolerances of world 1; where a
    partseg element is not, within them of world 1 replaying world 2's
    kink decisions (``replayed``), every element."""
    for name, w1 in world1.items():
        r0, r1 = (r[name] for r in ranks)
        same = torch.equal(r0["loss"], r1["loss"]) and all(
            torch.equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
        tol = DP_ADAM_TOL if "Adam" in name or "ZeRO" in name else DP_SGD_TOL
        perr = max(float((r0["state"][k] - v).abs().max()) for k, v in w1["state"].items()
                   if v.is_floating_point())
        lerr = float(((r0["loss"] - w1["loss"]).abs() / w1["loss"].abs()).max())
        stats = [k for k in w1["state"] if k.endswith(("running_mean", "running_var"))]
        serr = max([float((r0["state"][k] - w1["state"][k]).abs().max()) for k in stats] or [0])
        print(f"data parallel (b) {name}: world 2 losses {r0['loss'].tolist()} vs world 1 "
              f"{w1['loss'].tolist()} (max rel err {lerr:.3e}, tolerance {DP_LOSS_TOL['rtol']}); "
              f"parameters max abs err {perr:.3e} (tolerance {tol}); BatchNorm statistics "
              f"({len(stats)} buffers) max abs err {serr:.3e}; ranks bit-equal: {same}; "
              f"{r0['ms']:.1f} ms a step at world 2 (gloo over host copies; no speed is "
              f"claimed), {w1['ms']:.1f} ms at world 1")
        if not same:
            raise AssertionError(f"data parallel (b) {name}: the ranks differ")
        np.testing.assert_allclose(r0["loss"].numpy(), w1["loss"].numpy(), **DP_LOSS_TOL)
        outside = leaves_outside(torch, r0["state"], w1["state"], tol)
        if outside and name in replayed:
            # the elements outside must be the traced decisions' doing: world 1
            # replaying world 2's decisions holds every element to the bound
            again = leaves_outside(torch, r0["state"], replayed[name]["state"], tol)
            print(f"data parallel (b) {name}: elements outside {tol} against world 1 by leaf "
                  f"{outside}; against world 1 replaying world 2's ReLU signs and max-pool "
                  f"choices {again or 'none'}")
            if again:
                raise AssertionError(f"data parallel (b) {name}: outside {tol} with world 2's "
                                     f"decisions replayed: {again}")
        elif outside:
            raise AssertionError(f"data parallel (b) {name}: outside {tol}: {outside}")
    for r, res in enumerate(ranks):
        rep, zero = res["flagship Adam"], res["flagship ZeRO-1"]
        equal = torch.equal(rep["loss"], zero["loss"]) and all(
            torch.equal(rep["state"][k], zero["state"][k]) for k in rep["state"])
        print(f"data parallel (b) rank {r}: ZeRO-1 parameters bit-equal to replicated Adam's "
              f"after {DP_STEPS} steps: {equal}; Adam kernel launches {zero['adam']} on the "
              f"rank's part (replicated: {rep['adam']} on whole leaves)")
        if not equal or zero["adam"] != DP_STEPS or rep["adam"] != DP_STEPS:
            raise AssertionError(f"data parallel (b) rank {r}: ZeRO-1 against replicated Adam")


EPOCH_LINE = re.compile(r"Epoch (\d+) loss ([0-9.]+) test accuracy ([0-9.]+), mean class "
                        r"accuracy ([0-9.]+)")


def dp_cards(n: int, device: str = "cuda") -> None:
    """(c): train_cls_voxel --zero1 with one rank a card over NCCL (with
    ``device`` "cpu", n gloo processes: the rehearsal), against one process
    on the same global batches (B=32 a rank, 2 epochs of 2 steps): each rank's
    devices and ZeRO-1 lines, every rank the same epoch lines, within
    tests/test_multiprocess.py's tolerances of world 1."""
    import os
    import tempfile

    argv = [sys.executable, "-m", "simple3dformer_tpu_torch.cli.train_cls_voxel",
            "--dataset", "ModelNet40", "--synthetic", str(2 * DP_B * n), "--epochs", "2",
            "--batchSize", str(DP_B * n), "--lr", str(DP_ADAM_LR), "--transformer-name", BACKBONE,
            "--cell-size", str(CELL), "--patch-size", str(PATCH), "--zero1", "--device", device]
    with tempfile.TemporaryDirectory() as out_dir:
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([*argv, "--outf", os.path.join(out_dir, f"n{r}")],
                                  env=launcher_env(n, r, port), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(n)]
        procs.append(subprocess.Popen([*argv, "--outf", os.path.join(out_dir, "one")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"data parallel (c) process {r} failed:\n{out[-3000:]}")
    ranks, one = outs[:n], outs[n]
    want_devices = [f"devices: {n} | rank {r} {'nccl' if device == 'cuda' else 'gloo'} | "
                    f"{device}{f':{r}' if device == 'cuda' else ''}" for r in range(n)]
    lines = [[EPOCH_LINE.search(line).group(0) for line in out.splitlines()
              if EPOCH_LINE.search(line)] for out in ranks]
    traj = np.asarray([[float(v) for v in EPOCH_LINE.search(line).groups()[1:]]
                       for line in lines[0]])
    ref = np.asarray([[float(v) for v in EPOCH_LINE.search(line).groups()[1:]]
                      for line in one.splitlines() if EPOCH_LINE.search(line)])
    zero = [line for line in ranks[0].splitlines() if line.startswith("ZeRO-1:")]
    print(f"data parallel (c): train_cls_voxel --zero1 on {n} {device} ranks (B={DP_B} a rank), "
          f"{seconds:.1f} s with the world-1 run beside it: {zero}; epoch lines {lines[0]}; "
          f"world 1 {ref.tolist()}; the ranks' lines equal: {all(l == lines[0] for l in lines)}")
    if (any(w not in out for w, out in zip(want_devices, ranks)) or len(traj) != 2
            or zero != [f"ZeRO-1: 100% of optimizer-state bytes sharded over 'data' ({n} ways)"]
            or any(l != lines[0] for l in lines)):
        raise AssertionError(f"data parallel (c): {ranks[0][-3000:]}")
    # tests/test_multiprocess.py's bounds: losses rtol 5e-3, accuracies one test sample
    np.testing.assert_allclose(traj[:, 0], ref[:, 0], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(traj[:, 1:], ref[:, 1:], atol=1 / (DP_B * n) + 1e-9)


def phase_data_parallel(torch):
    """Phase 24: (a) the CLIs at world 1 over NCCL; (b) two gloo ranks on the
    card against world 1; (c) one NCCL rank a card where there are several.
    Returns (a)'s launch counts."""
    import os
    import tempfile

    t0 = time.perf_counter()
    launches = dp_cli_world1(torch)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as case:
        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", case],
                                  env=launcher_env(2, r, port), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        world1 = dp_runs(torch, torch.device("cuda"))
        outs = []
        try:
            for r, p in enumerate(procs):
                outs.append(p.communicate(timeout=300)[0])
                if p.returncode != 0:
                    raise AssertionError(f"data parallel (b) rank {r} failed:\n{outs[-1][-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = [torch.load(os.path.join(case, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    split = gathered_decisions(torch, [r["partseg 3DViT"]["trace"] for r in ranks], 0)
    kinks = kink_report(torch, world1["partseg 3DViT"]["trace"], split)
    print(f"data parallel (b) partseg kink trace, world 2 against world 1 (3 steps, every "
          f"BatchNorm and ReLU in call order): first difference {kinks['first']}; "
          f"{kinks['flips']} ReLU signs and {kinks['moved_maxes']} max-pool choices differ")
    for line in kinks["lines"][:12]:
        print(f"  {line}")
    replayed = {"partseg 3DViT": dp_runs(torch, torch.device("cuda"), flagship=False,
                                         replay=split)["partseg 3DViT"]}
    dp_compare(torch, ranks, world1, replayed)
    t2 = time.perf_counter()
    n = torch.cuda.device_count()
    if n > 1:
        dp_cards(n)
    else:
        print("data parallel (c): the machine shows one card; the multi-card run needs several")
    print(f"data parallel: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
          f"(c) {time.perf_counter() - t2:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# model parallelism (phase 25): tensor, pipeline and sequence parallelism as
# gloo ranks on the one card (NCCL takes one rank a card), each against one
# process (world 1) on the same batches; over NCCL, one rank a card, where
# the machine shows several cards (d)
# ---------------------------------------------------------------------------

MP_B, MP_STEPS, MP_LR = 32, 3, 0.01
MP_LOSS_TOL = {"float32": dict(rtol=1e-4), "bfloat16": dict(rtol=2e-3)}
MP_SGD_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_parallel.py:149's, f32
# bf16: each leaf's SGD update (linear in its gradient) within the bf16 block
# gradients' bound of the world-1 update's largest value
MP_BF16_UPDATE_REL = 3e-2
# (a) the TP layouts (n_data, n_model), the worlds that run them
TP_LAYOUTS = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
# (b) the flagship's 12 blocks in 4 stages of 3, 4 microbatches of 8
PP_STAGES, PP_MICRO, PP_MB = 4, 4, 8
PP_FWD_TOL, PP_GRAD_TOL = dict(rtol=2e-5, atol=2e-6), dict(rtol=5e-4, atol=5e-5)
# (c) Hengshuang cls at BASELINE.json's third config, B=16 in f32, seq=2
SP_B, SP_SEQ = 16, 2
SP_LOSS_TOL, SP_TOL = dict(rtol=1e-5, atol=1e-6), dict(rtol=5e-4, atol=5e-5)
TP_HALVES = ("vit_block_tp_attn_fwd", "vit_block_tp_mlp_fwd", "vit_block_tp_mlp_bwd",
             "vit_block_tp_attn_bwd", "vit_block_tp_ln_bwd")
# the TPU kernels each half cuts: the training forward and its backward
TP_REPLACES = {"vit_block_tp_attn_fwd": 366, "vit_block_tp_mlp_fwd": 366,
               "vit_block_tp_mlp_bwd": 477, "vit_block_tp_attn_bwd": 477,
               "vit_block_tp_ln_bwd": 477}
BLOCK_LEAVES = {"ln1_s": "norm1.weight", "ln1_b": "norm1.bias", "wqkv": "attn.qkv.weight",
                "bqkv": "attn.qkv.bias", "wproj": "attn.proj.weight", "bproj": "attn.proj.bias",
                "ln2_s": "norm2.weight", "ln2_b": "norm2.bias", "w1": "mlp.fc1.weight",
                "b1": "mlp.fc1.bias", "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias"}


def tp_rank_weights(torch, w: dict, heads: int, n_model: int, r: int) -> tuple[dict, int]:
    """Model rank r's block weights (kernels/vit_block.WNAMES) by parallel/tp.py's
    split, and its head count."""
    from simple3dformer_tpu_torch.parallel.tp import head_split, shard_state

    local = shard_state({f"b.{v}": w[k] for k, v in BLOCK_LEAVES.items()}, n_model, r, heads)
    lo, hi = head_split(heads, n_model)[r]
    return {k: local[f"b.{v}"].contiguous() for k, v in BLOCK_LEAVES.items()}, hi - lo


def tp_halves_check(torch, b, n, d, heads, n_model, dtype, seed=0, device="cuda") -> dict:
    """Every model rank's halves on the card against their plain versions from
    the same inputs, on an f32 stream with ``dtype`` matmuls: forward outputs
    within TOL's abs bound, gradients within GRAD_REL of each output's largest
    value, each half bit-equal over two runs. Returns {half: (max abs error,
    the error held: abs for the forward halves, of the largest value for the
    backward)}."""
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    cdt = getattr(torch, dtype)
    x, w = block_inputs(torch, b, n, d, torch.float32, seed, device)
    rs = np.random.RandomState(seed + 1)
    g = torch.from_numpy(rs.randn(b, n, d).astype(np.float32)).to(device)
    dh, out = d // heads, dict.fromkeys(TP_HALVES, (0.0, 0.0))
    for r in range(n_model):
        wr, h = tp_rank_weights(torch, w, heads, n_model, r)
        before = [getattr(vb, k).launches for k in TP_HALVES]
        runs = []
        for _ in range(2):
            part, res = vb.vit_block_tp_attn_fwd(x, wr, h, dh, cdt)
            h1 = x + (part + w["bproj"])
            part2, a1 = vb.vit_block_tp_mlp_fwd(h1, wr, cdt)
            gz2, gm = vb.vit_block_tp_mlp_bwd(g, h1, a1, wr, cdt)
            gh1, g2 = vb.vit_block_tp_ln_bwd(gz2, h1, w["ln2_s"], g)
            gz1, ga = vb.vit_block_tp_attn_bwd(x, gh1, res, wr, h, dh, cdt)
            gx, g1 = vb.vit_block_tp_ln_bwd(gz1, x, w["ln1_s"], gh1)
            runs.append({"attn_fwd": {"part": part, **res}, "mlp_fwd": {"part": part2, "a1": a1},
                         "mlp_bwd": {"gz2": gz2, **gm}, "ln_bwd": {"gh1": gh1, "gx": gx,
                                                                     **{f"s2{k}": v for k, v in
                                                                        g2.items()},
                                                                     **{f"s1{k}": v for k, v in
                                                                        g1.items()}},
                         "attn_bwd": {"gz1": gz1, **ga}})
        torch.cuda.synchronize()
        launched = [getattr(vb, k).launches - c for k, c in zip(TP_HALVES, before)]
        if torch.device(device).type == "cuda" and launched != [2, 2, 2, 2, 4]:
            raise AssertionError(f"TP halves launched {launched}, want 2 calls each (ln 4)")
        a, bb = runs
        for half in a:
            for k in a[half]:
                if not torch.equal(a[half][k], bb[half][k]):
                    raise AssertionError(f"TP {half} rank {r}: {k} differs between two runs")
        k0 = a
        # each plain version from the kernels' own inputs: one half's error at a time
        pp_, pres = vb.vit_block_tp_attn_fwd_reference(x, wr, h, dh, cdt)
        h1 = x + (k0["attn_fwd"]["part"] + w["bproj"])
        pm_, pa1 = vb.vit_block_tp_mlp_fwd_reference(h1, wr, cdt)
        pz2, pgm = vb.vit_block_tp_mlp_bwd_reference(g, h1, k0["mlp_fwd"]["a1"], wr, cdt)
        pgh1, pg2 = vb.vit_block_tp_ln_bwd_reference(k0["mlp_bwd"]["gz2"], h1, w["ln2_s"], g)
        pz1, pga = vb.vit_block_tp_attn_bwd_reference(
            x, k0["ln_bwd"]["gh1"], {q: k0["attn_fwd"][q] for q in vb.TP_ATTN_RES}, wr, h, dh,
            cdt)
        pgx, pg1 = vb.vit_block_tp_ln_bwd_reference(k0["attn_bwd"]["gz1"], x, w["ln1_s"],
                                                    k0["ln_bwd"]["gh1"])
        fwd_tol = TOL[dtype]["atol"]
        checks = {  # (abs, relative) errors, the one held, its tolerance
            "vit_block_tp_attn_fwd": (errors(k0["attn_fwd"], {"part": pp_, **pres}), 0, fwd_tol),
            "vit_block_tp_mlp_fwd": (errors(k0["mlp_fwd"], {"part": pm_, "a1": pa1}), 0,
                                     fwd_tol),
            "vit_block_tp_mlp_bwd": (errors(k0["mlp_bwd"], {"gz2": pz2, **pgm}), 1,
                                     GRAD_REL[dtype]),
            "vit_block_tp_attn_bwd": (errors(k0["attn_bwd"], {"gz1": pz1, **pga}), 1,
                                      GRAD_REL[dtype]),
            "vit_block_tp_ln_bwd": (errors(k0["ln_bwd"], {
                "gh1": pgh1, "gx": pgx, **{f"s2{k}": v for k, v in pg2.items()},
                **{f"s1{k}": v for k, v in pg1.items()}}), 1, GRAD_REL["float32"])}
        for half, (errs, which, tol) in checks.items():
            err = errs[which]
            out[half] = (max(out[half][0], errs[0]), max(out[half][1], err))
            if err > tol:
                raise AssertionError(f"TP {half} rank {r} of {n_model} ({dtype}): error "
                                     f"{err:.3e} > {tol}")
    return out


def tp_half_report(torch, b, n, d, heads, n_model, iters=50) -> dict:
    """Each half's time at model rank 0's shard (f32 matmuls): kernel and plain
    version on the card in turns, the bound (bytes moved once, or its
    products at the 3-pass TF32 rate); no single PyTorch call computes a half."""
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    x, w = block_inputs(torch, b, n, d, torch.float32, 0, "cuda")
    g = torch.randn(b, n, d, generator=torch.Generator().manual_seed(2)).cuda()
    wr, h = tp_rank_weights(torch, w, heads, n_model, 0)
    dh, m = d // heads, b * n
    dl, f = h * dh, wr["w1"].shape[0]
    part, res = vb.vit_block_tp_attn_fwd(x, wr, h, dh)
    h1 = x + (part + w["bproj"])
    _, a1 = vb.vit_block_tp_mlp_fwd(h1, wr)
    gz2, _ = vb.vit_block_tp_mlp_bwd(g, h1, a1, wr)
    att = 4 * b * h * n * n * dh
    calls = {
        "vit_block_tp_attn_fwd": (lambda: vb.vit_block_tp_attn_fwd(x, wr, h, dh),
                                  lambda: vb.vit_block_tp_attn_fwd_reference(x, wr, h, dh),
                                  nbytes(x, *(wr[k] for k in vb.TP_ATTN), part, res),
                                  2 * m * 3 * dl * d + att + 2 * m * d * dl),
        "vit_block_tp_mlp_fwd": (lambda: vb.vit_block_tp_mlp_fwd(h1, wr),
                                 lambda: vb.vit_block_tp_mlp_fwd_reference(h1, wr),
                                 nbytes(h1, *(wr[k] for k in vb.TP_MLP), part, a1),
                                 4 * m * f * d),
        "vit_block_tp_mlp_bwd": (lambda: vb.vit_block_tp_mlp_bwd(g, h1, a1, wr),
                                 lambda: vb.vit_block_tp_mlp_bwd_reference(g, h1, a1, wr),
                                 nbytes(g, h1, a1, wr["w1"], wr["w2"], gz2) + 4 * (2 * f * d + f + d),
                                 8 * m * f * d),
        "vit_block_tp_attn_bwd": (lambda: vb.vit_block_tp_attn_bwd(x, g, res, wr, h, dh),
                                  lambda: vb.vit_block_tp_attn_bwd_reference(x, g, res, wr, h,
                                                                             dh),
                                  nbytes(x, g, res, wr["wqkv"], wr["wproj"], part)
                                  + 4 * (2 * 3 * dl * d + 3 * dl + d),
                                  8 * m * dl * d + 2 * att),
        "vit_block_tp_ln_bwd": (lambda: vb.vit_block_tp_ln_bwd(gz2, h1, w["ln2_s"], g),
                                lambda: vb.vit_block_tp_ln_bwd_reference(gz2, h1, w["ln2_s"], g),
                                nbytes(gz2, h1, g, part) + 4 * 3 * d, 12 * m * d)}
    out = {}
    for name, (kernel, plain, moved, flops) in calls.items():
        ms, plain_ms = in_turns(torch, kernel, plain, iters)
        bound_ms, bound_by = bound(moved, flops)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None)
    return out


def mp_counters() -> dict:
    from simple3dformer_tpu_torch.kernels import vit_block as vb

    return {k: getattr(vb, k) for k in (*TP_HALVES, "fused_vit_block", "fused_vit_block_bwd",
                                        "fused_vit_block_train_fwd",
                                        "fused_vit_block_train_bwd")}


def mp_tp_run(torch, device, n_data, n_model, dtype) -> dict:
    """(a): the flagship's SGD steps on a (data, model) layout (none: world 1,
    the unsplit model): losses, the full state after them (gathered), the
    launches of the TP halves and of the whole-block kernels, ms a step."""
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels
    from simple3dformer_tpu_torch.parallel import mesh
    from simple3dformer_tpu_torch.parallel.tp import TensorParallel, TPTrainState
    from simple3dformer_tpu_torch.train.loop import TrainState, make_scanned_train_steps
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    grids, labels = synthetic_voxels(MP_STEPS * MP_B, VOXEL, N_CLASSES, seed=DEFAULT_SEED + 5)
    ds = DeviceResidentDataset({"x": grids, "y": labels}, device)
    idx = ds.put_indices(np.arange(MP_STEPS * MP_B).reshape(MP_STEPS, MP_B))
    model = flagship_model(torch, device, None if dtype == "float32" else getattr(torch, dtype))
    layout = None
    if n_model:
        layout = mesh.make_layout(n_data, n_model, "model")
        tp = TensorParallel(model, layout)
        ts = TPTrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"), tp)
    else:
        ts = TrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"))
    counters = mp_counters()
    with mesh.using_layout(layout):
        run = make_scanned_train_steps(ts, ds)
        torch.cuda.synchronize(device)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        loss = run(idx, MP_LR)["loss"].cpu()
        ms = (time.perf_counter() - t0) / MP_STEPS * 1e3
        launches = {k: c.launches for k, c in counters.items()}
        state = ts.state_dict()["params"]
    return {"loss": loss, "ms": ms, "launches": launches,
            "state": {k: v.detach().cpu().clone() for k, v in state.items()},
            "heads": [blk.tp.heads for blk in tp.blocks.values()] if n_model else None}


def pp_inputs(torch, device):
    """The 12 blocks' input: 32 token rows of the flagship's shape, from a seed."""
    rs = np.random.RandomState(25)
    return torch.from_numpy(rs.randn(PP_MICRO * PP_MB, 26, 384).astype(np.float32)).to(device)


def mp_pp_run(torch, device, group=None, stage=0) -> dict:
    """(b): the flagship's 12 blocks (train mode, the fused training kernels)
    over 4 microbatches of 8: in 4 stages over ``group``, or (no group) one
    after another on each microbatch. Outputs, each block's gradients of the
    mean square, the training kernels' launches."""
    from simple3dformer_tpu_torch.kernels import vit_block as vb
    from simple3dformer_tpu_torch.parallel.pp import (pipeline_apply, run_stage, split_stages,
                                                      to_microbatches)

    blocks = list(flagship_model(torch, device).blocks)
    for blk in blocks:
        blk.train()
    xs = to_microbatches(pp_inputs(torch, device), PP_MICRO)
    ids = split_stages(list(range(len(blocks))), PP_STAGES)[stage] if group is not None \
        else list(range(len(blocks)))
    mine = [blocks[i] for i in ids]
    params = [p for blk in mine for p in blk.parameters()]
    vb.fused_vit_block_train_fwd.launches = vb.fused_vit_block_train_bwd.launches = 0
    if group is not None:
        out = pipeline_apply(mine, xs, group)
    else:
        out = torch.stack([run_stage(mine, x) for x in xs])
    grads = torch.autograd.grad(out.square().mean(), params)
    torch.cuda.synchronize(device)
    launches = {"fused_vit_block_train_fwd": vb.fused_vit_block_train_fwd.launches,
                "fused_vit_block_train_bwd": vb.fused_vit_block_train_bwd.launches}
    it = iter(grads)
    return {"out": out.detach().cpu(), "launches": launches, "ids": ids,
            "grads": {i: {k: next(it).cpu() for k, _ in blocks[i].named_parameters()}
                      for i in ids}}


def mp_sp_run(torch, device, layout=None, replay: list | None = None) -> dict:
    """(c): one SGD step of Hengshuang cls (D=512, 16 neighbours, N=1024 with
    normals, B=16, f32), the points split over ``layout``'s seq ranks (none:
    world 1). Loss, gradients, BatchNorm statistics, launches on this rank."""
    from simple3dformer_tpu_torch.parallel import mesh
    from simple3dformer_tpu_torch.parallel.sp import SequenceParallel
    from simple3dformer_tpu_torch.train.loop import cross_entropy

    ts = hengshuang_trainer(torch, device)
    model = ts.model
    rs = np.random.RandomState(27)
    x = rs.randn(SP_B, 1024, 6).astype(np.float32)
    x[..., :3] /= np.linalg.norm(x[..., :3], axis=-1).max(-1)[:, None, None]
    x = torch.from_numpy(x).to(device)
    y = torch.from_numpy(rs.randint(0, 40, SP_B)).to(device)
    names, params = zip(*model.named_parameters())
    counters = hengshuang_counters()
    for c in counters.values():
        c.launches = 0
    model.train()
    tracer = DecisionTrace(torch, model, replay)
    with mesh.using_layout(layout):
        net = SequenceParallel(model, layout) if layout is not None else model
        loss = cross_entropy(net(x), y)
        grads = mesh.average_gradients(list(torch.autograd.grad(loss, params)), list(params))
    torch.cuda.synchronize(device)
    tracer.remove()
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    state.update({f"grad {k}": g.cpu() for k, g in zip(names, grads)})
    return {"loss": float(loss.detach()), "launches": launches, "state": state,
            "trace": tracer.records}


def mp_worker(case_dir: str) -> int:
    """``chip_smoke.py --mp-worker DIR``: one gloo rank of phase 25 on the one
    card (world 2: TP model=2 and SP seq=2; world 4: TP model=4 and data=2 x
    model=2, PP stage=4); writes DIR/rank<r>.pt."""
    import os

    import torch

    from simple3dformer_tpu_torch.parallel import mesh

    if not mesh.multihost_init("cpu") or mesh.world_size() not in TP_LAYOUTS:
        raise RuntimeError("the phase 25 worker needs a rendezvous of 2 or 4 ranks")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    device, world = torch.device("cuda", 0), mesh.world_size()
    out = {}
    for n_data, n_model in TP_LAYOUTS[world]:
        for dtype in ("float32", "bfloat16"):
            out[f"tp {n_data}x{n_model} {dtype}"] = mp_tp_run(torch, device, n_data, n_model,
                                                            dtype)
    if world == 2:
        out["sp"] = mp_sp_run(torch, device, mesh.make_layout(1, SP_SEQ, "seq"))
    else:
        layout = mesh.make_layout(1, PP_STAGES, "stage")
        with mesh.using_layout(layout):
            out["pp"] = mp_pp_run(torch, device, layout.inner_group, layout.inner_rank)
    out["staged"] = dict(mesh.STAGED)
    torch.save(out, os.path.join(case_dir, f"rank{mesh.rank()}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def mp_tp_compare(torch, name, got, want, dtype) -> None:
    """(a)'s checks of one rank's run against world 1."""
    np.testing.assert_allclose(got["loss"].numpy(), want["loss"].numpy(), **MP_LOSS_TOL[dtype],
                               err_msg=f"model parallel (a) {name}: losses")
    init = {k: v.cpu() for k, v in flagship_model(torch, "cpu").state_dict().items()}
    worst = 0.0
    for k, v in want["state"].items():
        if dtype == "float32":
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), **MP_SGD_TOL,
                                       err_msg=f"model parallel (a) {name}: {k}")
        else:
            upd, ref = got["state"][k] - init[k], v - init[k]
            rel = float((upd - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            worst = max(worst, rel)
            if rel > MP_BF16_UPDATE_REL:
                raise AssertionError(f"model parallel (a) {name}: {k} update off by {rel:.3e} "
                                     f"of its largest")
    return worst


def phase_model_parallel(torch) -> dict:
    """Phase 25: (a) TP, (b) PP, (c) SP as gloo ranks on the card against
    world 1, the TP halves against their plain versions and timed; (d) TP and
    PP over NCCL where the machine shows several cards. Returns the TP halves'
    kernel-line entries (launches from the model=2 f32 run's rank 0)."""
    import os
    import tempfile

    t0 = time.perf_counter()
    max_abs = dict.fromkeys(TP_HALVES, 0.0)  # over the f32 checks, the timed dtype
    for dtype in ("float32", "bfloat16"):
        for n_model in (2, 4):
            errs = tp_halves_check(torch, 32, 26, 384, 6, n_model, dtype, seed=n_model)
            if dtype == "float32":
                max_abs = {k: max(max_abs[k], errs[k][0]) for k in TP_HALVES}
            print(f"model parallel (a) TP halves at B=32, N=26, D=384, 6 heads over "
                  f"{n_model} ranks, {dtype} matmuls, against their plain versions (max error "
                  f"by half: forward abs, backward of the largest value; each bit-equal over "
                  f"two runs): " + ", ".join(f"{k} {v[1]:.3e} (abs {v[0]:.3e})"
                                             for k, v in errs.items()))
    report = tp_half_report(torch, 32, 26, 384, 6, 2)
    smi = nvidia_smi()
    for name, r in report.items():
        print(f"model parallel (a) {name} at model rank 0 of 2 (3 heads, F=768), f32: "
              f"{r['ms']:.4f} ms a call, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}) | {smi}")
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as case:
        procs = {}
        for world in TP_LAYOUTS:
            port = free_port()
            os.makedirs(os.path.join(case, f"w{world}"))
            procs[world] = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-worker",
                 os.path.join(case, f"w{world}")], env=launcher_env(world, r, port),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(world)]
        device = torch.device("cuda")
        world1 = {dtype: mp_tp_run(torch, device, 1, 0, dtype)
                  for dtype in ("float32", "bfloat16")}
        pp1 = mp_pp_run(torch, device)
        sp1 = mp_sp_run(torch, device)
        ranks = {}
        try:
            for world, ps in procs.items():
                for r, p in enumerate(ps):
                    out = p.communicate(timeout=600)[0]
                    if p.returncode != 0:
                        raise AssertionError(f"model parallel world {world} rank {r} failed:\n"
                                             f"{out[-3000:]}")
                ranks[world] = [torch.load(os.path.join(case, f"w{world}", f"rank{r}.pt"),
                                           weights_only=False) for r in range(world)]
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
    t2 = time.perf_counter()
    # (a) TP against world 1
    blocks = 12
    for world, layouts in TP_LAYOUTS.items():
        for n_data, n_model in layouts:
            for dtype in ("float32", "bfloat16"):
                name = f"tp {n_data}x{n_model} {dtype}"
                want = {"vit_block_tp_attn_fwd": blocks * MP_STEPS,
                        "vit_block_tp_mlp_fwd": blocks * MP_STEPS,
                        "vit_block_tp_mlp_bwd": blocks * MP_STEPS,
                        "vit_block_tp_attn_bwd": blocks * MP_STEPS,
                        "vit_block_tp_ln_bwd": 2 * blocks * MP_STEPS, "fused_vit_block": 0,
                        "fused_vit_block_bwd": 0, "fused_vit_block_train_fwd": 0,
                        "fused_vit_block_train_bwd": 0}
                for r, res in enumerate(ranks[world]):
                    got = res[name]
                    worst = mp_tp_compare(torch, name, got, world1[dtype], dtype)
                    if got["launches"] != want:
                        raise AssertionError(f"model parallel (a) {name} rank {r}: launches "
                                             f"{got['launches']}, want {want}")
                    if r == 0:
                        perr = max(float((got["state"][k] - v).abs().max())
                                   for k, v in world1[dtype]["state"].items())
                        print(f"model parallel (a) {name} (heads a block on the model ranks "
                              f"{[rr[name]['heads'][0] for rr in ranks[world][:n_model]]}): "
                              f"losses {got['loss'].tolist()} vs world 1 "
                              f"{world1[dtype]['loss'].tolist()}; parameters max abs err "
                              f"{perr:.3e}" + (f", bf16 updates {worst:.3e} of their largest"
                                               if dtype != "float32" else "") +
                              f"; launches a rank {got['launches']}; {got['ms']:.1f} ms a "
                              f"step over gloo host copies (no speed is claimed), world 1 "
                              f"{world1[dtype]['ms']:.1f} ms")
    # (b) PP against the sequential stack
    pp_ranks = [r["pp"] for r in ranks[4]]
    for r, res in enumerate(pp_ranks):
        np.testing.assert_allclose(res["out"].numpy(), pp1["out"].numpy(), **PP_FWD_TOL,
                                   err_msg=f"model parallel (b) stage {r}: outputs")
        for i, grads in res["grads"].items():
            for k, v in grads.items():
                np.testing.assert_allclose(v.numpy(), pp1["grads"][i][k].numpy(), **PP_GRAD_TOL,
                                           err_msg=f"model parallel (b) block {i}: {k}")
        want = {k: 3 * PP_MICRO for k in res["launches"]}
        if res["launches"] != want:
            raise AssertionError(f"model parallel (b) stage {r}: launches {res['launches']}")
    out_err = max(float((res["out"] - pp1["out"]).abs().max()) for res in pp_ranks)
    print(f"model parallel (b) PP: 12 blocks in {PP_STAGES} stages of 3, {PP_MICRO} microbatches "
          f"of {PP_MB}: outputs max abs err {out_err:.3e} against the sequential stack, every "
          f"block's gradients within {PP_GRAD_TOL}; training-kernel launches a stage "
          f"{[res['launches'] for res in pp_ranks]} (world 1: {pp1['launches']}); bubble "
          f"ticks skip their block calls")
    # (c) SP against world 1; where an element is outside, against world 1
    # replaying the split run's kink decisions
    sp_ranks = [r["sp"] for r in ranks[2]]
    split = gathered_decisions(torch, [r["trace"] for r in sp_ranks], 1)
    kinks = kink_report(torch, sp1["trace"], split)
    print(f"model parallel (c) SP kink trace, seq={SP_SEQ} against world 1 (every BatchNorm and "
          f"ReLU in call order): first difference {kinks['first']}; {kinks['flips']} ReLU "
          f"signs and {kinks['moved_maxes']} max-pool choices differ")
    for line in kinks["lines"][:12]:
        print(f"  {line}")
    replayed = None
    for r, res in enumerate(sp_ranks):
        np.testing.assert_allclose(res["loss"], sp1["loss"], **SP_LOSS_TOL,
                                   err_msg="model parallel (c): loss")
        outside = leaves_outside(torch, res["state"], sp1["state"], SP_TOL)
        again = {}
        if outside:
            if replayed is None:
                replayed = mp_sp_run(torch, torch.device("cuda"), replay=split)
            again = leaves_outside(torch, res["state"], replayed["state"], SP_TOL)
            if again:
                raise AssertionError(f"model parallel (c) rank {r}: outside {SP_TOL} with the "
                                     f"split run's decisions replayed: {again}")
        gerr = max(float((res["state"][k] - v).abs().max()) for k, v in sp1["state"].items()
                   if k.startswith("grad "))
        print(f"model parallel (c) SP rank {r} of seq={SP_SEQ}: loss {res['loss']:.6f} vs world 1 "
              f"{sp1['loss']:.6f}; gradients max abs err {gerr:.3e}; gradients and BatchNorm "
              f"statistics outside {SP_TOL} by leaf {outside or 'none'}"
              + (f", with the split run's decisions replayed {again or 'none'}" if outside
                 else "") + f"; launches {res['launches']} (world 1: {sp1['launches']})")
    staged = {w: [r["staged"] for r in rs] for w, rs in ranks.items()}
    print(f"model parallel: gloo all-gathers and ring shifts staged through host memory "
          f"(calls, bytes by rank): {staged}")
    t3 = time.perf_counter()
    n = torch.cuda.device_count()
    if n > 1:
        mp_cards(torch, min(n, 4))
    else:
        print("model parallel (d): the machine shows one card; TP and PP over NCCL need several")
    print(f"model parallel: halves {t1 - t0:.1f} s, ranks and world 1 {t2 - t1:.1f} s, "
          f"checks {t3 - t2:.1f} s, (d) {time.perf_counter() - t3:.1f} s")
    launches = ranks[2][0]["tp 1x2 float32"]["launches"]
    return {name: dict(launches=launches[name], max_abs_err=max_abs[name], **report[name])
            for name in TP_HALVES}


def mp_cards_worker(case_dir: str) -> int:
    """``chip_smoke.py --mp-cards-worker DIR``: one NCCL rank a card of (d):
    TP model=n on the flagship (f32, 3 SGD steps) and PP stage=n over the
    12 blocks; writes DIR/rank<r>.pt."""
    import os

    import torch

    from simple3dformer_tpu_torch.parallel import mesh

    mesh.multihost_init("cuda")
    n = mesh.world_size()
    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tp": mp_tp_run(torch, device, 1, n, "float32")}
    layout = mesh.make_layout(1, n, "stage")
    with mesh.using_layout(layout):
        out["pp"] = mp_pp_run(torch, device, layout.inner_group, layout.inner_rank)
    torch.save(out, os.path.join(case_dir, f"rank{mesh.rank()}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def mp_cards(torch, n: int) -> None:
    """(d): TP model=n and PP stage=n, one NCCL rank a card, against world 1
    on the first card."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as case:
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-cards-worker",
                                   case], env=launcher_env(n, r, port), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(n)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode:
                raise AssertionError(f"model parallel (d) rank {r} failed:\n{out[-3000:]}")
        ranks = [torch.load(os.path.join(case, f"rank{r}.pt"), weights_only=False)
                 for r in range(n)]
        seconds = time.perf_counter() - t0
    device = torch.device("cuda", 0)
    w1 = mp_tp_run(torch, device, 1, 0, "float32")
    pp1 = mp_pp_run(torch, device)
    for r, res in enumerate(ranks):
        mp_tp_compare(torch, f"(d) tp 1x{n} rank {r}", res["tp"], w1, "float32")
        np.testing.assert_allclose(res["pp"]["out"].numpy(), pp1["out"].numpy(), **PP_FWD_TOL)
        for i, grads in res["pp"]["grads"].items():
            for k, v in grads.items():
                np.testing.assert_allclose(v.numpy(), pp1["grads"][i][k].numpy(), **PP_GRAD_TOL,
                                           err_msg=f"model parallel (d) block {i}: {k}")
    print(f"model parallel (d): TP model={n} and PP stage={n} over NCCL, one rank a card, "
          f"{seconds:.1f} s: TP losses {ranks[0]['tp']['loss'].tolist()} vs world 1 "
          f"{w1['loss'].tolist()}, parameters within {MP_SGD_TOL}; TP launches a rank "
          f"{ranks[0]['tp']['launches']}; PP outputs and gradients within the sequential "
          f"stack's bounds; PP launches by stage {[r['pp']['launches'] for r in ranks]}")

# phase 26: the modules no CLI reaches. The legacy voxel-to-image model at
# full width (deit_base, D=768, 12 heads, 197 tokens of a synthesized 224^2
# image, ModelNet10's 10 classes), and PointNet++'s MSG first layer (the
# reference's pointnet2_cls_msg), a RelPos set abstraction and PointEmbed
LEGACY_B, LEGACY_PARITY_B, LEGACY_CLASSES = 32, 8, 10
LEGACY_BACKBONE = "deit_base_patch16_224"
LEGACY_LR = 1e-4
LEGACY_ADAM_TOL = dict(rtol=0, atol=2 * 3 * LEGACY_LR)  # Adam moves a weight about lr a step
# the BatchNorm running statistics card vs CPU, of each leaf's largest: after
# the first step (the one forward both sides run with equal weights: every
# BatchNorm sits before the ViT, f32 sums in another order), and after the
# third, where Adam has moved each weight by about lr whatever the sign of a
# gradient that is all rounding (the parameters' bound) and the batch means
# follow (seen 3.1e-3 in fc_bn)
LEGACY_STAT_REL = {"first": 1e-4, "third": 1e-2}
LEGACY_BF16_REL = 5e-2  # bf16 logits against the f32 forward, of the largest (H_LOGIT_REL's)
LEGACY_TIMED_STEPS = 20
SA_B, SA_N = 16, 1024
MSG_CFG = dict(npoint=512, radius_list=(0.1, 0.2, 0.4), nsample_list=(16, 32, 128),
               mlp_list=((32, 32, 64), (64, 64, 128), (64, 96, 128)))
SA_OUT_REL = 1e-4  # outputs card vs CPU, of the largest: f32 sums in another order
# gradients card vs CPU, relative L2 a leaf: a BatchNorm'd ReLU or a max over
# up to 128 neighbours within rounding of its runner-up can fall the other way
# on the card and send an element's gradient to another (seen 3.0e-3 at MSG's
# bn_blocks.2.1.weight, a sum over 1M rows; the outputs agree within 2.2e-6)
SA_GRAD_L2 = 1e-2
SA_ZERO_GRAD = re.compile(r"(mlp_convs\.\d+|conv_blocks\.\d+\.\d+|pos_embeds\.\d+\.fc2)\.bias$")


def legacy_model(torch, device, dtype=None, drop=True, two_layer_head=False, voxel_size=32):
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.models.legacy_voxel import FeatureVoxel2DViT

    rates = {} if drop else dict(drop1=0.0, drop2=0.0)
    return FeatureVoxel2DViT(LEGACY_CLASSES, voxel_size, LEGACY_BACKBONE, two_layer_head,
                             generator=generator(DEFAULT_SEED + 26), dtype=dtype,
                             **rates).to(device)


def legacy_grids(n, seed, voxel_size=32):
    from simple3dformer_tpu_torch.data.synthetic import synthetic_voxels

    return synthetic_voxels(n, voxel_size, LEGACY_CLASSES, seed=seed)


def legacy_serving(torch, counters) -> dict:
    """The model behind Predictor (batch 32) and ModelServer: real HTTP
    requests, logits against the CPU's plain path at B=8, launches."""
    from simple3dformer_tpu_torch.serve.predictor import Predictor
    from simple3dformer_tpu_torch.serve.server import ModelServer

    model = legacy_model(torch, "cpu")
    cpu_model = copy.deepcopy(model).eval()
    predictor = Predictor(model, (32,) * 3, device="cuda", batch_size=LEGACY_B)
    server = ModelServer(predictor, host="127.0.0.1", port=0)
    port = server.start_background()
    sizes = [1, 40, LEGACY_PARITY_B]
    grids, _ = legacy_grids(sum(sizes) + LEGACY_B, 261)
    grids = grids.astype(np.float32)
    try:
        for fn in counters.values():
            fn.launches = 0  # the main path starts here
        outs, start, chunks = [], 0, 0
        for n in sizes:
            x = grids[start:start + n]
            start += n
            status, body = post(port, json.dumps({"inputs": x.tolist()}))
            logits = np.asarray(body.get("logits", []), np.float32) if status == 200 else None
            if logits is None or logits.shape != (n, LEGACY_CLASSES) or \
                    not np.isfinite(logits).all():
                raise AssertionError(f"legacy POST /predict of {n}: {status} {body}")
            outs.append((x, logits))
            chunks += -(-n // LEGACY_B)
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            predictor(grids[start:start + LEGACY_B])
            lat.append(time.perf_counter() - t0)
            chunks += 1
        launches = {k: fn.launches for k, fn in counters.items()}  # the main path ends here
    finally:
        server.shutdown()
    x, logits = outs[-1]
    with torch.no_grad():
        want = cpu_model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, want, **LOGIT_TOL)
    if launches != voxel_launches(1, 0, chunks, False):
        raise AssertionError(f"legacy serving launches {launches} for {chunks} chunks")
    lat_ms = np.asarray(lat) * 1e3
    print(f"legacy serving: FeatureVoxel2DViT (32^3, deit_base 12 heads, {LEGACY_CLASSES} "
          f"classes) behind Predictor and ModelServer, {len(sizes)} POST /predict ({sizes}); "
          f"logits at B={LEGACY_PARITY_B} max abs err vs the CPU's plain path "
          f"{float(np.abs(logits - want).max()):.3e} (tolerance {LOGIT_TOL}); launches "
          f"{launches} = 12 x {chunks} chunks; Predictor at batch {LEGACY_B}: p50 "
          f"{np.percentile(lat_ms, 50):.3f} ms, p95 {np.percentile(lat_ms, 95):.3f} ms, "
          f"{LEGACY_B / np.median(lat_ms) * 1e3:.1f} samples/s (host clock, 20 calls)")
    return launches


def legacy_parity(torch, counters) -> dict:
    """3 Adam steps at B=8 on the card and on the CPU's plain path from the same
    weights and batches, the dropouts off; the card's launches."""
    from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    x, y = legacy_grids(3 * LEGACY_PARITY_B, 262)
    losses, states, seconds, first = {}, {}, {}, {}
    for device in ("cuda", "cpu"):
        model = legacy_model(torch, device, drop=False)
        step = make_train_step(TrainState(model, make_optimizer(dict(model.named_parameters()),
                                                                "Adam")))
        for fn in counters.values():
            fn.launches = 0
        t0, out = time.perf_counter(), []
        for i in range(3):
            sl = slice(i * LEGACY_PARITY_B, (i + 1) * LEGACY_PARITY_B)
            out.append(float(step({"x": torch.from_numpy(x[sl]).float().to(device),
                                   "y": torch.from_numpy(y[sl]).to(device)}, LEGACY_LR)["loss"]))
            if i == 0:  # the statistics of the one forward both sides run with equal weights
                first[device] = {k: v.detach().cpu().clone()
                                 for k, v in model.state_dict().items() if "running_" in k}
        if device == "cuda":
            launches = {k: fn.launches for k, fn in counters.items()}
        losses[device], seconds[device] = out, time.perf_counter() - t0
        states[device] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    param_err = max(float((states["cuda"][k] - v).abs().max()) for k, v in states["cpu"].items()
                    if v.is_floating_point() and "running_" not in k)
    stats = [k for k in states["cpu"] if "running_" in k]
    worst = {}
    for when, got, want in (("first", first["cuda"], first["cpu"]),
                            ("third", states["cuda"], states["cpu"])):
        errs = {k: float((got[k] - want[k]).abs().max()) / float(want[k].abs().max())
                for k in stats}
        k = max(errs, key=errs.get)
        worst[when] = (errs[k], k)
        if not errs[k] <= LEGACY_STAT_REL[when]:
            raise AssertionError(f"legacy {k} after the {when} step differs from the CPU's: "
                                 f"{errs[k]}")
    if not param_err <= LEGACY_ADAM_TOL["atol"]:
        raise AssertionError(f"legacy parameters differ from the CPU's by {param_err}")
    if launches != voxel_launches(1, 3, 0, True):
        raise AssertionError(f"legacy train launches {launches}")
    print(f"legacy training: 3 Adam steps at B={LEGACY_PARITY_B}, lr {LEGACY_LR}, dropouts off: "
          f"losses on the card {losses['cuda']} vs the CPU's plain path {losses['cpu']} (rtol "
          f"1e-3); parameters within {param_err:.3e} (tolerance {LEGACY_ADAM_TOL['atol']:.0e}); "
          f"{len(stats)} BatchNorm running statistics (momentum 0.99), of each leaf's largest, "
          f"within {worst['first'][0]:.3e} after the first step ({worst['first'][1]}; "
          f"tolerance {LEGACY_STAT_REL['first']}) and {worst['third'][0]:.3e} after the third "
          f"({worst['third'][1]}; tolerance {LEGACY_STAT_REL['third']}); launches {launches}; "
          f"{seconds['cuda']:.1f} s on the card, "
          f"{seconds['cpu']:.1f} s on the CPU")
    return launches


def legacy_split(torch, model, x) -> tuple[dict, dict]:
    """ms (CUDA events) and device ms (torch.profiler) of one train step's parts,
    each part's forward and backward run alone at B=32: the 3D convolutions, the
    decoder (FC, BatchNorm, the four Up stages), the ViT's 12 blocks with the
    patch embedding and final norm, the head, Adam."""
    model.train()
    vit = model.transformer
    feats = model.convs(x).detach()
    img = model.decode(feats).detach().requires_grad_()
    cls = vit.forward_features(img)[:, 0].detach().requires_grad_()
    feats.requires_grad_()
    conv_p = [p for n, p in model.named_parameters() if n.startswith("conv3d_")]
    dec_p = [p for n, p in model.named_parameters() if n.startswith(("fc1", "fc_bn", "deconv"))]
    head_p = list(model.head.parameters())
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer(dict(model.named_parameters()), "Adam")
    grads = {k: torch.zeros_like(p) for k, p in opt.params.items()}
    g_feats, g_img, g_cls = torch.randn_like(feats), torch.randn_like(img), torch.randn_like(cls)
    parts = {
        "3D convolutions": lambda: torch.autograd.grad(model.convs(x), conv_p, g_feats),
        "decoder": lambda: torch.autograd.grad(model.decode(feats), [feats, *dec_p], g_img),
        "ViT blocks": lambda: torch.autograd.grad(vit.forward_features(img)[:, 0],
                                                  [img, *vit.parameters()], g_cls),
        "head": lambda: torch.autograd.grad(model.head(cls).sum(), [cls, *head_p]),
        "Adam": lambda: opt.step(grads, 0.0),
    }
    ms = {name: time_ms(torch, fn, 3) for name, fn in parts.items()}
    device = {name: sum(t * n for t, n in device_split(torch, fn, iters=3).values()) / 3
              for name, fn in parts.items()}
    return ms, device


def legacy_timed(torch, counters) -> dict:
    """ms a train step at B=32 with the dropouts on (corpus on the card), a
    profile, the device time by part; the launches of the timed steps."""
    from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
    from simple3dformer_tpu_torch.train.loop import TrainState, make_scanned_train_steps
    from simple3dformer_tpu_torch.train.optim import make_optimizer

    model = legacy_model(torch, "cuda")
    state = TrainState(model, make_optimizer(dict(model.named_parameters()), "Adam"))
    n = LEGACY_TIMED_STEPS + 4
    corpus, labels = legacy_grids(n * LEGACY_B, 263)
    ds = DeviceResidentDataset({"x": corpus, "y": labels}, "cuda")
    run = make_scanned_train_steps(state, ds)
    idx = ds.put_indices(np.arange(n * LEGACY_B).reshape(n, LEGACY_B))
    for fn in counters.values():
        fn.launches = 0
    ms_step = timed_steps(torch, run, idx, LEGACY_LR, LEGACY_TIMED_STEPS, "legacy FeatureVoxel2DViT",
                          LEGACY_B)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = 1 + LEGACY_TIMED_STEPS + 3  # warm-up, timed, profiled
    if launches != voxel_launches(1, steps, 0, True):
        raise AssertionError(f"legacy timed launches {launches} for {steps} steps")
    ms, device = legacy_split(torch, model, torch.from_numpy(corpus[:LEGACY_B]).float().cuda())
    total = sum(device.values())
    print(f"legacy step by part at B={LEGACY_B} (each part's forward and backward alone; CUDA "
          f"events ms / device ms by torch.profiler): " + ", ".join(
              f"{k} {ms[k]:.3f} / {device[k]:.3f}" for k in ms)
          + f"; device sum {total:.3f} ms against the {ms_step:.3f} ms step; launches of the "
          f"{steps} timed steps {launches}")
    return dict(launches=launches, ms_step=ms_step, device=device)


def legacy_routes(torch, counters) -> None:
    """The two-layer head card vs CPU, the bf16 forward against the f32 forward
    on the card, one forward of the 128^3 stack at B=2 card vs CPU."""
    x, _ = legacy_grids(LEGACY_PARITY_B, 264)
    xt = torch.from_numpy(x).float()
    with torch.no_grad():
        two = legacy_model(torch, "cpu", two_layer_head=True).eval()
        want = two(xt)
        got = two.cuda()(xt.cuda()).cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)
        two_err = float((got - want).abs().max())
        f32 = legacy_model(torch, "cuda").eval()(xt.cuda())
        for fn in counters.values():
            fn.launches = 0
        bf16 = legacy_model(torch, "cuda", dtype=torch.bfloat16).eval()(xt.cuda())
        bf16_launches = counters["fused_vit_block"].launches
        bf16_err = float((bf16.float() - f32).abs().max() / f32.abs().max())
        x128, _ = legacy_grids(2, 265, 128)
        x128 = torch.from_numpy(x128).float()
        big = legacy_model(torch, "cpu", voxel_size=128).eval()
        want128 = big(x128)
        got128 = big.cuda()(x128.cuda()).cpu()
        np.testing.assert_allclose(got128.numpy(), want128.numpy(), **LOGIT_TOL)
    if bf16.dtype != torch.bfloat16 or not bf16_err <= LEGACY_BF16_REL or bf16_launches != 12:
        raise AssertionError(f"legacy bf16 forward: {bf16.dtype}, error {bf16_err}, "
                             f"{bf16_launches} block launches")
    print(f"legacy routes: two-layer head at B={LEGACY_PARITY_B} max abs err vs the CPU "
          f"{two_err:.3e} (tolerance {LOGIT_TOL}); bf16 forward against the f32 forward "
          f"{bf16_err:.3e} of the largest logit (tolerance {LEGACY_BF16_REL}), 12 fused block "
          f"launches; 128^3 stack at B=2 max abs err vs the CPU "
          f"{float((got128 - want128).abs().max()):.3e}")


def sa_inputs(torch, seed):
    """B=16 clouds of N=1024 points on a 1/64 grid in [0, 1)^3 (every squared
    distance exact in f32, so the ball, kNN and FPS choices are the same on the
    card and the CPU whatever the order of the sums) and unit normals."""
    rs = np.random.RandomState(seed)
    xyz = (rs.randint(0, 64, (SA_B, SA_N, 3)) / 64.0).astype(np.float32)
    normals = rs.randn(SA_B, SA_N, 3)
    normals = (normals / np.linalg.norm(normals, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(xyz), torch.from_numpy(normals)


def sa_check(torch, label, make, args, counters, **kw) -> dict:
    """One point module in train mode on the card and on the CPU's plain path
    from the same weights and FPS starts: outputs, the gradients of sum(out *
    cot) for the features and every parameter, the launches of one card call;
    the card's ms a forward and backward."""
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED

    base, res = make(), {}  # one init, copied to each device
    for device in ("cuda", "cpu"):
        mod = copy.deepcopy(base).to(device).train()
        xs = [a.to(device) for a in args]
        xs[-1].requires_grad_(True)
        cot = None

        def call():
            nonlocal cot
            new_xyz, out = mod(*xs, sample_generator=torch.Generator().manual_seed(DEFAULT_SEED),
                               **kw)
            if cot is None:
                cot = torch.from_numpy(np.random.RandomState(7).randn(*out.shape)
                                       .astype(np.float32)).to(device)
            names, leaves = zip(*[(n, p) for n, p in mod.named_parameters()])
            grads = torch.autograd.grad((out * cot).sum(), [xs[-1], *leaves])
            return new_xyz, out, dict(zip(("features", *names), grads))

        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = call()
        if device == "cuda":
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        res[device] = ([t.detach().cpu() for t in got[:2]],
                       {k: g.cpu() for k, g in got[2].items()}, time.perf_counter() - t0)
        if device == "cuda":
            card_ms = time_ms(torch, call, 5)
    (xyz_c, out_c), g_c, _ = res["cuda"]
    (xyz_p, out_p), g_p, cpu_s = res["cpu"]
    if not torch.equal(xyz_c, xyz_p):
        raise AssertionError(f"{label}: the sampled centres differ on the card")
    out_err = float((out_c - out_p).abs().max() / out_p.abs().max())
    # a per-channel constant just ahead of a train-mode BatchNorm has a zero
    # gradient in exact arithmetic (both sides hold rounding): those leaves are
    # held against the module's largest gradient norm
    top = max(float(g.norm()) for g in g_p.values())
    l2 = {k: float((g_c[k] - g).norm() / (top if SA_ZERO_GRAD.search(k) else
                                          max(float(g.norm()), 1e-30)))
          for k, g in g_p.items()}
    worst = max(l2, key=lambda k: (np.isnan(l2[k]), l2[k]))
    print(f"{label}: output {tuple(out_c.shape)} card vs the CPU's plain path {out_err:.3e} of "
          f"the largest (tolerance {SA_OUT_REL}); gradients relative L2 at most {l2[worst]:.3e} "
          f"({worst}; tolerance {SA_GRAD_L2}), the features' {l2['features']:.3e}; launches of "
          f"one forward and backward {launches}; {card_ms:.3f} ms on the card (CUDA events, 5 "
          f"calls), {cpu_s:.2f} s on the CPU")
    if not out_err <= SA_OUT_REL or not l2[worst] <= SA_GRAD_L2:
        raise AssertionError(f"{label}: output {out_err}, gradient {worst} {l2[worst]}")
    return dict(launches=launches, ms=card_ms)


def phase_legacy_points(torch) -> dict:
    """Phase 26. Returns the launches of the kernels of its paths."""
    from simple3dformer_tpu_torch.core.rng import DEFAULT_SEED, generator
    from simple3dformer_tpu_torch.nn.point_embed import PointEmbed
    from simple3dformer_tpu_torch.nn.set_abstraction import (PointNetSetAbstractionMsg,
                                                             PointNetSetAbstractionRelPos)

    t0 = time.perf_counter()
    vc = voxel_counters()
    launches = collections.Counter(legacy_serving(torch, vc))
    launches.update(legacy_parity(torch, vc))
    launches.update(legacy_timed(torch, vc)["launches"])
    legacy_routes(torch, vc)
    pc = {k: fn for k, fn in point_counters().items() if k in ("fps", "knn", "gather_fwd",
                                                             "gather_bwd")}
    xyz, normals = sa_inputs(torch, 266)
    for knn in (False, True):
        launches.update(sa_check(
            torch, f"PointNetSetAbstractionMsg ({'kNN' if knn else 'ball'}; B={SA_B}, N={SA_N}, "
            f"npoint 512, radii 0.1/0.2/0.4, nsample 16/32/128)",
            lambda: PointNetSetAbstractionMsg(MSG_CFG["npoint"], MSG_CFG["radius_list"],
                                              MSG_CFG["nsample_list"], 3, MSG_CFG["mlp_list"],
                                              knn=knn, generator=generator(DEFAULT_SEED)),
            (xyz, normals), pc)["launches"])
    launches.update(sa_check(
        torch, "PointNetSetAbstractionRelPos (kNN; npoint 512, nsample 32, mlp 64/64/128)",
        lambda: PointNetSetAbstractionRelPos(512, 0.2, 32, 6, [64, 64, 128], knn=True,
                                             generator=generator(DEFAULT_SEED)),
        (xyz, normals), pc)["launches"])
    launches.update(sa_check(
        torch, "PointEmbed (embed_dim 384, npoint 512, nsample 32, N=1024, xyz)",
        lambda: PointEmbed(384, 3, npoint=512, nsample=32, generator=generator(DEFAULT_SEED)),
        (xyz,), pc)["launches"])
    for k in ("fused_vit_block", "fused_vit_block_train_fwd", "fused_vit_block_train_bwd",
              "fused_adam", "fps", "knn", "gather_fwd", "gather_bwd"):
        if not launches[k]:
            raise AssertionError(f"phase 26: {k} never launched")
    print(f"phase 26 launches {dict(launches)}; {time.perf_counter() - t0:.1f} s")
    return dict(launches)


# phase 27: four ModelNet40 classes of procedural solids, 64 train and 16 test
# meshes each, voxelized at the flagship's 30^3 (cli/train_cls_voxel.py:143);
# the ingest timed on 256 files of 128^3 (ShapeNetV2's grid)
TOOL_CLASSES = {"dresser": "box", "vase": "octahedron", "tent": "pyramid", "bottle": "cylinder"}
TOOL_SPLITS, TOOL_DIM, TOOL_EPOCHS = {"train": 64, "test": 16}, 30, 5
INGEST_FILES, INGEST_DIM, INGEST_MESHES = 256, 128, 16


def solid_mesh(kind, rs):
    """A closed polyhedron ``kind`` at a random scale on each axis and a random
    rotation: (verts [V, 3], faces as vertex lists)."""
    if kind == "box":
        verts = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float)
        faces = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6], [0, 2, 6, 4],
                 [1, 5, 7, 3]]
    elif kind == "octahedron":
        verts = np.concatenate([np.eye(3), -np.eye(3)])
        faces = [[0, 1, 2], [1, 3, 2], [3, 4, 2], [4, 0, 2], [1, 0, 5], [3, 1, 5], [4, 3, 5],
                 [0, 4, 5]]
    elif kind == "pyramid":
        verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0], [0, 0, 1.5]], float)
        faces = [[3, 2, 1, 0], [0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]]
    else:  # a cylinder: a 24-gon prism
        a = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        ring = np.stack([np.cos(a), np.sin(a)], 1)
        verts = np.concatenate([np.c_[ring, -np.ones(24)], np.c_[ring, np.ones(24)]])
        faces = [list(range(23, -1, -1)), list(range(24, 48))]
        faces += [[i, (i + 1) % 24, 24 + (i + 1) % 24, 24 + i] for i in range(24)]
    q, _ = np.linalg.qr(rs.randn(3, 3))
    return (verts * rs.uniform(0.6, 1.4, 3)) @ q.T + rs.randn(3), faces


def write_mesh(path, verts, faces):
    """An OFF or an OBJ file, by the path's extension."""
    with open(path, "w") as f:
        if path.endswith(".off"):
            f.write(f"OFF\n{len(verts)} {len(faces)} 0\n")
            f.writelines(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
            f.writelines(f"{len(fc)} {' '.join(map(str, fc))}\n" for fc in faces)
        else:
            f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
            f.writelines(f"f {' '.join(str(i + 1) for i in fc)}\n" for fc in faces)


def write_mesh_tree(root, seed):
    """The ModelNet40 tree of procedural meshes, <class>/<split>/<class>_<n>.off
    (even n) or .obj (odd n); -> the number of meshes."""
    import os

    rs, n = np.random.RandomState(seed), 0
    for cls, kind in TOOL_CLASSES.items():
        for split, count in TOOL_SPLITS.items():
            os.makedirs(os.path.join(root, cls, split))
            for i in range(count):
                write_mesh(os.path.join(root, cls, split, f"{cls}_{i:04d}.{'obj' if i % 2 else 'off'}"),
                           *solid_mesh(kind, rs))
                n += 1
    return n


@contextlib.contextmanager
def ingest_route(native):
    """The native ingest (``native``) or, under S3F_NATIVE_INGEST=0, the numpy codec."""
    import os

    os.environ["S3F_NATIVE_INGEST"] = "1" if native else "0"
    try:
        yield
    finally:
        os.environ.pop("S3F_NATIVE_INGEST")


def ingest_timing(directory):
    """materialize of INGEST_FILES binvox files of INGEST_DIM^3 (tool-made from
    INGEST_MESHES meshes, each file copied to fill the count; warm in the page
    cache) at threads=None, threads=1 and through the numpy codec: files/s,
    the three arrays bit-equal."""
    import os
    import shutil

    from simple3dformer_tpu_torch.data import native_ingest
    from simple3dformer_tpu_torch.tools import voxelize

    rs, made = np.random.RandomState(271), []
    for i in range(INGEST_MESHES):
        mesh = os.path.join(directory, f"m{i}.off")
        write_mesh(mesh, *solid_mesh(list(TOOL_CLASSES.values())[i % 4], rs))
        made.append(voxelize.mesh_to_binvox(mesh, dim=INGEST_DIM))
    paths = []
    for i in range(INGEST_FILES):
        paths.append(os.path.join(directory, f"g{i:04d}.binvox"))
        shutil.copyfile(made[i % INGEST_MESHES], paths[-1])
    mib = os.path.getsize(paths[0]) * INGEST_FILES / 2**20
    out, rates = {}, {}
    for label, threads, native in (("threads=None", None, True), ("threads=1", 1, True),
                                   ("numpy codec", None, False)):
        with ingest_route(native):
            t0 = time.perf_counter()
            out[label] = native_ingest.materialize(paths, threads=threads)
            rates[label] = INGEST_FILES / (time.perf_counter() - t0)
    same = all(np.array_equal(out["numpy codec"], x) for x in out.values())
    print(f"ingest: materialize of {INGEST_FILES} binvox files of {INGEST_DIM}^3 "
          f"({out['numpy codec'].nbytes / 2**20:.0f} MiB dense, {mib:.1f} MiB of files, warm in "
          f"the page cache) on the host, os.cpu_count() {os.cpu_count()}: "
          + ", ".join(f"{k} {v:.1f} files/s" for k, v in rates.items())
          + f"; the library {rates['threads=None'] / rates['numpy codec']:.2f}x the numpy codec "
          f"on every CPU, {rates['threads=1'] / rates['numpy codec']:.2f}x on one; the three "
          f"arrays bit-equal {same}")
    if not same or not out["numpy codec"].any():
        raise AssertionError("the ingest's arrays differ from the numpy codec's")
    return rates


def phase_tools(torch):
    """Phase 27: meshes -> binvox with tools.voxelize -> the native ingest ->
    the flagship trained on the card from the tool-made tree, and the viewer.
    Returns the launches of the CLI run."""
    import os
    import shutil
    import tempfile

    from simple3dformer_tpu_torch.cli import train_cls_voxel
    from simple3dformer_tpu_torch.data import datasets
    from simple3dformer_tpu_torch.data.classmaps import CLASSES_ModelNet40
    from simple3dformer_tpu_torch.tools import view_voxels, voxelize

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "ModelNet40")
        n_meshes = write_mesh_tree(root, seed=27)
        t1 = time.perf_counter()
        binvox_paths = voxelize.convert_tree(root, dim=TOOL_DIM)
        seconds = time.perf_counter() - t1
        print(f"tools: {n_meshes} procedural meshes (OFF and OBJ; {', '.join(TOOL_CLASSES.values())} "
              f"as {', '.join(TOOL_CLASSES)}) -> {len(binvox_paths)} binvox files of "
              f"{TOOL_DIM}^3 by tools.voxelize.convert_tree in {seconds:.2f} s")
        if len(binvox_paths) != n_meshes:
            raise AssertionError(f"convert_tree converted {len(binvox_paths)} of {n_meshes}")

        # (b) the ingest: bit-equal to the numpy codec, the JAX package's errors
        train = datasets.ModelNetVoxelDataset(root, CLASSES_ModelNet40, "train")
        x, y = train.materialize()
        with ingest_route(native=False):
            x_np, y_np = train.materialize()
        occupancy = {CLASSES_ModelNet40[c]: float(x[y == c].mean()) for c in np.unique(y)}
        print(f"ingest: the train split {x.shape} {x.dtype} through the library, bit-equal to "
              f"the numpy codec {np.array_equal(x, x_np) and np.array_equal(y, y_np)}; "
              f"occupancy by class {occupancy}")
        if x.shape != (len(TOOL_CLASSES) * TOOL_SPLITS["train"],) + (TOOL_DIM,) * 3 \
                or not np.array_equal(x, x_np) or not np.array_equal(y, y_np) \
                or min(occupancy.values()) <= 0:
            raise AssertionError("the ingest's train split differs from the numpy codec's")
        mixed = os.path.join(work, "mixed")
        os.makedirs(os.path.join(mixed, "tent", "train"))
        odd = os.path.join(mixed, "tent", "train", "tent_0001.binvox")
        voxelize.mesh_to_binvox(os.path.join(root, "tent", "train", "tent_0000.off"), odd, dim=32)
        shutil.copyfile(train.samples[0], os.path.join(mixed, "tent", "train", "tent_0000.binvox"))
        want = f"{odd}: grid dims do not match the expected dims"
        for native in (True, False):
            with ingest_route(native):
                try:
                    datasets.ModelNetVoxelDataset(mixed, CLASSES_ModelNet40, "train").materialize()
                except OSError as e:
                    if str(e) != want:
                        raise AssertionError(f"mixed dims raised {e!r}, want {want!r}") from e
                else:
                    raise AssertionError("a split of mixed dims did not raise")
        print(f"ingest: a split with one {32}^3 file among {TOOL_DIM}^3 raises OSError "
              f"'{want[len(odd) + 2:]}' naming the file, through the library and the numpy codec")
        ingest_dir = os.path.join(work, "ingest")
        os.makedirs(ingest_dir)
        ingest_timing(ingest_dir)

        # (c) the flagship on the tool-made tree, through the CLI
        argv = ["--dataset", "ModelNet40", "--data-root", root, "--transformer-name", BACKBONE,
                "--cell-size", str(CELL), "--patch-size", str(PATCH), "--batchSize", str(BATCH),
                "--epochs", str(TOOL_EPOCHS)]
        _, lines, launches, saved = run_cli(train_cls_voxel.main, lambda d: [*argv, "--outf", d],
                                            voxel_counters())
        steps = TOOL_EPOCHS * (len(TOOL_CLASSES) * TOOL_SPLITS["train"] // BATCH)
        evals = TOOL_EPOCHS * -(-len(TOOL_CLASSES) * TOOL_SPLITS["test"] // BATCH)
        want_launches = voxel_launches(1, steps, evals, adam=True)
        epoch_losses = [float(line.split()[3]) for line in lines if line.startswith("Epoch ")]
        sizes = next((line for line in lines if line.startswith("train ")), "no sizes line")
        print(f"tools -> flagship CLI (ModelNet40 tree of tool-made binvox, {BACKBONE}, cell "
              f"{CELL}, patch {PATCH}, B={BATCH}, the default lr): {sizes}; {steps} steps, "
              f"{evals} eval batches; epoch losses {epoch_losses}; {lines[-1]}; checkpoints at "
              f"epochs {saved}; launches {launches} (want {want_launches})")
        if len(epoch_losses) != TOOL_EPOCHS or not epoch_losses[-1] < 0.75 * epoch_losses[0]:
            raise AssertionError(f"the loss on tool-made data did not fall: {epoch_losses}")
        if launches != want_launches or not saved:
            raise AssertionError(f"launch counts {launches}, want {want_launches}")

        # (d) the viewer on a converted grid
        grid = x[0]
        images = [view_voxels.render(grid, width=256, height=256) for _ in range(2)]
        shell = view_voxels.hollow(grid)
        covered = float((images[0] != 255).any(-1).mean())
        ppm = view_voxels.save_image(images[0], os.path.join(work, "view.ppm"))
        print(f"viewer: render of {train.samples[0].split(os.sep)[-1]} at 256x256 twice "
              f"bit-equal {np.array_equal(*images)}, {covered:.1%} of the pixels covered; "
              f"hollow keeps {int(shell.sum())} of {int(grid.sum())} voxels; "
              f"{os.path.basename(ppm)} {os.path.getsize(ppm)} bytes")
        if not np.array_equal(*images) or not 0.01 < covered < 1 \
                or not 0 < shell.sum() < grid.sum():
            raise AssertionError("the viewer's render is not repeatable or is blank")
    print(f"phase 27 launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


def run_phase(name, fn, *args):
    """``fn(*args)``, its wall time printed (the script's time budget is read from these)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


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
        run_phase("build", phase_build)
        report = run_phase("kernels", phase_kernels, torch)
        launches = run_phase("serving", phase_serving, torch)
        train_report = run_phase("train_kernels", phase_train_kernels, torch)
        train_launches, _ = run_phase("training", phase_training, torch)
        point_report = run_phase("point_kernels", phase_point_kernels, torch)
        partseg_launches = run_phase("partseg", phase_partseg, torch)
        mhsa_report = run_phase("mhsa_kernels", phase_mhsa_kernels, torch)
        s3dis_launches = run_phase("s3dis", phase_s3dis, torch)
        va_report = run_phase("va_kernels", phase_va_kernels, torch)
        hengshuang_launches, _ = run_phase("hengshuang", phase_hengshuang, torch)
        vag_report = run_phase("vag_kernels", phase_vag_kernels, torch)
        bf16_launches, recompute_launches = run_phase("hengshuang bf16", phase_hengshuang,
                                                      torch, True)
        run_phase("attention_route", phase_attention_route, torch)
        run_phase("scanobjectnn", phase_scanobjectnn, torch)
        for which in HSEG:
            for bf16 in (False, True):
                run_phase(f"hengshuang_seg {which}{' bf16' if bf16 else ''}",
                          phase_hengshuang_seg, torch, which, bf16)
        run_phase("point_vit_bf16", phase_point_vit_bf16, torch)
        run_phase("flagship_bf16", phase_flagship_bf16, torch)
        run_phase("lwf", phase_lwf, torch)
        run_phase("group_embed", phase_group_embed, torch)
        run_phase("vip3d", phase_vip3d, torch)
        export_launches = run_phase("export", phase_export, torch)
        run_phase("data_parallel", phase_data_parallel, torch)
        mp_report = run_phase("model_parallel", phase_model_parallel, torch)
        legacy_launches = run_phase("legacy_points", phase_legacy_points, torch)
        tools_launches = run_phase("tools", phase_tools, torch)
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
    # the forward is the op s3f::vit_block_fwd: the serving phase's launches and
    # those of the exported flagship's run (phase 23), each counted inside the op
    # rows 1, 3-5 and 8-11 add phase 26's launches (the legacy model served and
    # trained, the set abstractions and PointEmbed), rows 1 and 3-5 phase 27's
    # (the flagship trained on tool-made binvox files)
    kernels = [dict(name="fused_vit_block", route="cuda", source=block_src,
                    replaces="simple3dformer_tpu/kernels/vit_block.py:264",
                    launches=launches + export_launches + legacy_launches["fused_vit_block"]
                    + tools_launches["fused_vit_block"],
                    bound_ms=bound_ms, bound_by=bound_by, **report)]
    for name, replaces, source in [
            ("fused_vit_block_bwd", "simple3dformer_tpu/kernels/vit_block.py:290", block_src),
            ("fused_vit_block_train_fwd", "simple3dformer_tpu/kernels/vit_block.py:366",
             block_src),
            ("fused_vit_block_train_bwd", "simple3dformer_tpu/kernels/vit_block.py:477",
             block_src),
            ("fused_adam", "simple3dformer_tpu/kernels/adam.py:76",
             "simple3dformer_tpu_torch/csrc/adam.cu")]:
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=train_launches[name] + legacy_launches.get(name, 0)
                            + tools_launches.get(name, 0),
                            **train_report[name]))
    for name, replaces, source in [
            ("fps", "simple3dformer_tpu/kernels/fps.py:79", "fps.cu"),
            ("knn", "simple3dformer_tpu/kernels/knn.py:74", "knn.cu"),
            ("gather_fwd", "simple3dformer_tpu/kernels/gather.py:82", "gather.cu"),
            ("gather_bwd", "simple3dformer_tpu/kernels/gather.py:109", "gather.cu")]:
        kernels.append(dict(name=name, route="cuda",
                            source=f"simple3dformer_tpu_torch/csrc/{source}", replaces=replaces,
                            launches=partseg_launches[name] + legacy_launches[name],
                            **point_report[name]))
    for name, line in (("mhsa_fwd", 120), ("mhsa_bwd", 144)):
        kernels.append(dict(name=name, route="cuda", source="simple3dformer_tpu_torch/csrc/mhsa.cu",
                            replaces=f"simple3dformer_tpu/kernels/mhsa.py:{line}",
                            launches=s3dis_launches[name], **mhsa_report[name]))
    for name, line in (("vector_attention_fwd", 473), ("vector_attention_bwd", 506)):
        kernels.append(dict(name=name, route="cuda",
                            source="simple3dformer_tpu_torch/csrc/vector_attention.cu",
                            replaces=f"simple3dformer_tpu/kernels/vector_attention.py:{line}",
                            launches=hengshuang_launches[name], **va_report[name]))
    # the recompute backward's launches are those of its own path (S3F_VA_RESID=0)
    for name, line, path in (("vector_attention_gather_fwd", 254, bf16_launches),
                             ("vector_attention_gather_bwd", 290, recompute_launches),
                             ("vector_attention_resid_fwd", 689, bf16_launches),
                             ("vector_attention_resid_bwd", 722, bf16_launches)):
        kernels.append(dict(name=name, route="cuda",
                            source="simple3dformer_tpu_torch/csrc/vector_attention.cu",
                            replaces=f"simple3dformer_tpu/kernels/vector_attention.py:{line}",
                            launches=path[name], **vag_report[name]))
    # the tensor-parallel halves of rows 1-4 (phase 25 (a))
    for name in TP_HALVES:
        kernels.append(dict(name=name, route="cuda", source=block_src,
                            replaces=f"simple3dformer_tpu/kernels/vit_block.py:{TP_REPLACES[name]}",
                            **mp_report[name]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    missing = [(k.get("name"), key) for k in kernels for key in keys if key not in k]
    if missing or any(not k["launches"] for k in kernels):
        print(f"chip_smoke: the kernels line lacks {missing} or a kernel never launched",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mp-cards-worker"]:
        sys.exit(mp_cards_worker(sys.argv[2]))
    sys.exit(main())
