"""Build the port's host C++ sources with ``g++`` and load them.

The host libraries (the binvox ingest, ``data/native_ingest/ingest.cpp``;
the mesh voxelizer, ``tools/voxelizer/voxelizer.cpp``; the voxel viewer,
``tools/viewer/viewer.cpp``) are plain C interfaces loaded with ``ctypes``,
as in the JAX package, and compiled with that package's flags, so that their
floating-point code compiles the same and gives the same bits. Libraries go
to ``build/host/`` at the root of the checkout, named by a hash of the source
and the flags; a build writes a temporary file and renames it into place, so
processes that build at the same moment never load a partial file. Nothing
here runs at import time: the first call that needs a library builds it. A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_ROOT.parent / "build" / "host"
# the JAX package's flags for each library (tools/voxelize.py:31,
# tools/view_voxels.py:47-48, data/native_ingest/__init__.py:45-46)
VOXELIZER_FLAGS = ("-O3", "-shared", "-fPIC")
VIEWER_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
INGEST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path(source: Path, flags: tuple[str, ...]) -> Path:
    """Where the build of ``source`` with ``flags`` lives, keyed by both."""
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path, flags: tuple[str, ...]) -> tuple[Path, float, str]:
    """Compile ``source`` with ``g++ flags`` if its library is missing.

    Returns (library path, build seconds, the compiler's output); seconds are
    0 and the output empty when the library already existed.
    """
    out = library_path(source, flags)
    if out.exists():
        return out, 0.0, ""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: {Path(source).name} builds only where a "
                           "host C++ compiler is")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {Path(source).name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out, seconds, log


@functools.cache
def load(source: Path, flags: tuple[str, ...]) -> ctypes.CDLL:
    """The loaded library of ``source`` built with ``flags``, built on first use."""
    path, _, _ = build(source, flags)
    return ctypes.CDLL(str(path))
