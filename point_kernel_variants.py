"""Time the design variants of the kNN and FPS kernels against each other on the card.

    python3 point_kernel_variants.py

Run from the root of a checkout on a machine with a CUDA card and nvcc
(builds for sm_90a). Two choices in ``csrc/knn.cu`` and ``csrc/fps.cu`` rest
on these times:

- kNN: a chunk from which 8 or more candidates enter the k-list, at k >= 8,
  is sorted and merged with it at once (``S3F_KNN_MERGE_AT`` = 8, as built
  by the port), against inserting every candidate one at a time (33: never
  merged). Timed
  at every kNN launch of the partseg, S3DIS and Hengshuang steps, and summed
  over a step's launches.
- FPS: the block size ``fps_kernel<THREADS, PER>`` that ``s3f_fps`` picks by
  N, against the others that cover N (N <= THREADS * PER <= 2 max(N, 32)),
  at every draw of the three paths, and summed over a step's draws.

Each variant is first held to its exact plain version (kNN ``idx`` and
``dist`` bit for bit, FPS indices equal), then timed by CUDA events, ``ITERS``
calls a round, the variants in order and then reversed, the mean of the two
rounds. Prints the card's name and power limit first; exits 1 if a variant
disagrees, does not build or no card is visible.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import (FPS_SHAPES, KNN_SHAPES, knn_inputs, nvidia_smi, ptxas_entries,
                        template_label, time_ms, unit_cloud)

ITERS = 20
MERGE_AT = {"merge at 8 (built)": None, "never merged": 33}
# the launches of one train step of each path, by their KNN_SHAPES and
# FPS_SHAPES labels (the bf16 Hengshuang step makes the same ones)
KNN_STEP = {
    "partseg": ("TD0 k=16", "TD1 k=16", "TU0 3-NN", "TU1 3-NN"),
    "S3DIS": ("S3DIS TD0 k=16", "S3DIS TD1 k=16", "S3DIS TU0 3-NN", "S3DIS TU1 3-NN"),
    "Hengshuang": ("Hengshuang level 0 k=16", "Hengshuang TD 1024 -> 256",
                   "Hengshuang level 1 k=16", "Hengshuang TD 256 -> 64",
                   "Hengshuang level 2 k=16", "Hengshuang TD 64 -> 16",
                   "Hengshuang level 3 k=16", "Hengshuang TD 16 -> 4",
                   "Hengshuang level 4 k=4"),
}
FPS_STEP = {
    "partseg": ("partseg TD1",),
    "S3DIS": ("S3DIS 4096 -> 1024",),
    "Hengshuang": ("Hengshuang 1024 -> 256", "Hengshuang 256 -> 64", "Hengshuang 64 -> 16",
                   "Hengshuang 16 -> 4"),
}


def fps_picked(n: int) -> tuple[int, int]:
    """The (THREADS, PER) that s3f_fps launches for N points (csrc/fps.cu)."""
    for limit, pick in ((32, (32, 1)), (128, (32, 4)), (256, (128, 2)), (1024, (128, 8)),
                        (2048, (512, 4)), (4096, (512, 8)), (8192, (1024, 8))):
        if n <= limit:
            return pick
    return 1024, 16


def fps_candidates(n: int) -> list[tuple[int, int]]:
    out = [(t, p) for t in (32, 64, 128, 256, 512, 1024) for p in (1, 2, 4, 8, 16)
           if n <= t * p <= 2 * max(n, 32)]
    return sorted(set(out) | {fps_picked(n)})


def compile_variant(name: str, source, flags=()) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` (a path) into build/variants/<name>.so with the port's flags."""
    from simple3dformer_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, _nvcc

    out = BUILD_DIR.parent / "variants" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def fps_source(variants) -> str:
    """csrc/fps.cu with an entry that launches a chosen instantiation."""
    from simple3dformer_tpu_torch.kernels.build import CSRC

    lines = [f'#include "{CSRC / "fps.cu"}"',
             'extern "C" int variant_fps(int threads, int per, const void* xyz, void* out,',
             '                           int B, int N, int npoint, void* stream) {',
             '  const float* x = static_cast<const float*>(xyz);',
             '  int* o = static_cast<int*>(out);',
             '  cudaStream_t s = static_cast<cudaStream_t>(stream);']
    lines += [f"  if (threads == {t} && per == {p}) return launch<{t}, {p}>(x, nullptr, o, B, N, "
              "npoint, s);" for t, p in variants]
    lines += ["  return cudaErrorInvalidValue;", "}", ""]
    return "\n".join(lines)


def in_rounds(torch, fns: dict) -> dict:
    """Mean ms a call of each of ``fns``: one round in order, one reversed."""
    names = list(fns)
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(time_ms(torch, fns[name], ITERS))
    return {name: float(np.mean(t)) for name, t in times.items()}


def knn_variants(torch, libs: dict) -> bool:
    from simple3dformer_tpu_torch.kernels.knn import knn_reference_exact

    def run(lib, q, p, k):
        b, s, _ = q.shape
        idx = torch.empty(b, s, k, dtype=torch.int32, device="cuda")
        dist = torch.empty(b, s, k, dtype=torch.float32, device="cuda")
        err = lib.s3f_knn(q.data_ptr(), p.data_ptr(), idx.data_ptr(), dist.data_ptr(), b, s,
                          p.shape[1], k, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"knn variant launch failed: CUDA error {err}")
        return idx, dist

    rs = np.random.RandomState(11)
    shapes = {s[0]: s for s in KNN_SHAPES}
    per_shape, ok = {}, True
    for label in dict.fromkeys(sum(KNN_STEP.values(), ())):
        _, b, s, n, k, dup = shapes[label]
        q, p = knn_inputs(torch, rs, b, s, n, dup)
        eidx, edist = knn_reference_exact(q, p, k)
        same = {}
        for name, lib in libs.items():
            idx, dist = run(lib, q, p, k)
            torch.cuda.synchronize()
            same[name] = torch.equal(idx, eidx) and torch.equal(dist.view(torch.int32),
                                                                edist.view(torch.int32))
        ms = in_rounds(torch, {name: (lambda lib=lib: run(lib, q, p, k))
                               for name, lib in libs.items()})
        per_shape[label] = ms
        ok &= all(same.values())
        print(f"knn {label} B={b} S={s} N={n} k={k}: "
              + "; ".join(f"{name} {ms[name]:.4f} ms (bit-equal to the exact-order plain "
                          f"version {same[name]})" for name in libs), flush=True)
    for path, labels in KNN_STEP.items():
        print(f"knn a {path} step ({len(labels)} launches): "
              + "; ".join(f"{name} {sum(per_shape[lb][name] for lb in labels):.4f} ms"
                          for name in libs))
    return ok


def fps_variants(torch, lib) -> bool:
    from simple3dformer_tpu_torch.kernels.fps import fps_reference

    def run(t, per, xyz, npoint):
        b, n, _ = xyz.shape
        out = torch.empty(b, npoint, dtype=torch.int32, device="cuda")
        err = lib.variant_fps(t, per, xyz.data_ptr(), out.data_ptr(), b, n, npoint,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fps variant <{t}, {per}> launch failed: CUDA error {err}")
        return out

    rs = np.random.RandomState(13)
    shapes = {s[0]: s for s in FPS_SHAPES}
    picked, fastest, ok = {}, {}, True
    for label in sum(FPS_STEP.values(), ()):
        _, b, n, npoint = shapes[label]
        xyz = unit_cloud(torch, rs, b, n)
        want = fps_reference(xyz, npoint)
        cands = fps_candidates(n)
        same = {v: torch.equal(run(*v, xyz, npoint), want) for v in cands}
        ms = in_rounds(torch, {v: (lambda v=v: run(*v, xyz, npoint)) for v in cands})
        ok &= all(same.values())
        picked[label], fastest[label] = ms[fps_picked(n)], min(ms.values())
        print(f"fps {label} B={b} N={n} npoint={npoint}: "
              + "; ".join(f"<{t}, {p}>{' (picked)' if (t, p) == fps_picked(n) else ''} "
                          f"{ms[(t, p)]:.4f} ms" for t, p in cands)
              + f"; every variant equal to the plain version {all(same.values())}", flush=True)
    for path, labels in FPS_STEP.items():
        print(f"fps a {path} step ({len(labels)} draws): picked "
              f"{sum(picked[lb] for lb in labels):.4f} ms, the fastest timed at each draw "
              f"{sum(fastest[lb] for lb in labels):.4f} ms")
    return ok


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("point_kernel_variants: no CUDA card visible", file=sys.stderr)
        return 1
    from simple3dformer_tpu_torch.kernels.build import BUILD_DIR, CSRC

    print(f"device: {nvidia_smi()}")
    timed = set(sum(FPS_STEP.values(), ()))
    fps_all = sorted({v for label, _, n, _ in FPS_SHAPES if label in timed
                      for v in fps_candidates(n)})
    fps_cu = BUILD_DIR.parent / "variants" / "fps_variants.cu"
    fps_cu.parent.mkdir(parents=True, exist_ok=True)
    fps_cu.write_text(fps_source(fps_all))
    jobs = {f"knn_merge_{at or 'built'}": (CSRC / "knn.cu",
                                           (f"-DS3F_KNN_MERGE_AT={at}",) if at else ())
            for at in MERGE_AT.values()}
    jobs["fps_variants"] = (fps_cu, ())
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: compile_variant(j, *jobs[j]), jobs)))
    for name, (_, log) in built.items():
        print(f"build {name}: " + ", ".join(f"{template_label(k)} {r} registers, {s} bytes "
                                            "spill stores" for k, r, s in ptxas_entries(log)))
    knn_libs = {name: built[f"knn_merge_{at or 'built'}"][0] for name, at in MERGE_AT.items()}
    for lib in knn_libs.values():
        lib.s3f_knn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fps_lib = built["fps_variants"][0]
    fps_lib.variant_fps.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    ok = knn_variants(torch, knn_libs)
    ok &= fps_variants(torch, fps_lib)
    print("point_kernel_variants: " + ("every variant agreed" if ok else "a variant disagreed"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
