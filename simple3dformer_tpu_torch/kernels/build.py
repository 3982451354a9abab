"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The sources may include the shared headers
``csrc/*.cuh``. Libraries go to ``build/kernels/`` at the root of the
checkout, named by a hash of the source, every shared header and the flags,
so an edited source or header is rebuilt and an unchanged tree is reused.
Nothing here runs at import time: the first call that needs a library
builds it.

``refuse_export`` is the guard of the kernels that are not registered as torch
ops: only the ViT block forward is (``s3f::vit_block_fwd``, kernels/vit_block.py),
so ``torch.export`` of a forward that reaches any other kernel raises, naming it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by the source, every
    ``csrc/*.cuh`` header (by name and content) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` if its library is missing.

    Returns (library path, build seconds, nvcc's output); seconds are 0 and
    the output empty when an up-to-date library already existed.
    """
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out, seconds, log


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))


def refuse_export(kernel: str) -> None:
    """Raise while ``torch.export`` traces a call of ``kernel``, a kernel an
    exported program could not launch (it is no registered torch op)."""
    import torch

    if torch.compiler.is_exporting():
        raise RuntimeError(
            f"the {kernel} kernel is not registered as a torch op, so a forward that reaches "
            "it cannot be exported (of the port's kernels only the ViT block forward, "
            "s3f::vit_block_fwd, is)")
