"""Native (C++) binvox ingest: multithreaded bulk decode of dataset splits
(port of simple3dformer_tpu/data/native_ingest).

The host-side hot loop of the reference's data path (a binvox RLE decode per
sample inside DataLoader workers) as a thread-pooled C++ library,
``ingest.cpp``, that decodes a whole file list into one contiguous
``[n, *grid]`` uint8 array. The port puts a decoded split on the device once
(data/pipeline.DeviceResidentDataset), so the decode is a startup cost; at
ShapeNetV2 scale (about 52k files of 128^3) the library takes it from
minutes of single-threaded numpy to seconds.

The library is built with ``g++`` into ``build/host/`` on first use
(core/host_build.py, the JAX package's flags), and every result is
bit-equal to data/binvox.read_as_3d_array. ``S3F_NATIVE_INGEST=0`` chooses
the numpy codec, as in the JAX package. Where the JAX package also falls
back to numpy when the build fails, the port raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import io
import os
from pathlib import Path

import numpy as np

from ...core import host_build
from .. import binvox

SOURCE = Path(__file__).resolve().parent / "ingest.cpp"

_ERRORS = {
    -1: "open/read failed",
    -2: "malformed binvox header",
    -3: "grid dims do not match the expected dims",
    -4: "RLE payload does not cover the grid exactly",
    -5: "odd RLE payload byte count",
}


def _load():
    """The library, or None under ``S3F_NATIVE_INGEST=0``."""
    if os.environ.get("S3F_NATIVE_INGEST", "1") == "0":
        return None
    lib = host_build.load(SOURCE, host_build.INGEST_FLAGS)
    lib.s3f_decode_binvox.restype = ctypes.c_int
    lib.s3f_decode_binvox.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.s3f_read_dims.restype = ctypes.c_int
    lib.s3f_read_dims.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.s3f_materialize.restype = ctypes.c_int
    lib.s3f_materialize.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    return lib


def available() -> bool:
    """True unless ``S3F_NATIVE_INGEST=0``; builds the library on first use
    (a failed build raises)."""
    return _load() is not None


def _out_shape(dims, fix_coords: bool):
    # binvox file order is [d0][d1][d2]; fix_coords applies transpose(0, 2, 1)
    d0, d1, d2 = dims
    return (d0, d2, d1) if fix_coords else (d0, d1, d2)


def read_dims(path: str) -> tuple[int, int, int]:
    """Header-only dims of a binvox file (shape discovery for materialize)."""
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            dims, _, _ = binvox.read_header(f)
        return tuple(dims)
    out = np.zeros(3, np.int64)
    rc = lib.s3f_read_dims(os.fsencode(path), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")
    return tuple(int(v) for v in out)


def decode_bytes(file_bytes: bytes, dims, fix_coords: bool = True) -> np.ndarray:
    """Decode one in-memory binvox file to a dense uint8 grid (0/1)."""
    lib = _load()
    dims = tuple(int(d) for d in dims)
    if lib is None:
        v = binvox.read_as_3d_array(io.BytesIO(file_bytes), fix_coords)
        return v.data.astype(np.uint8)
    out = np.empty(_out_shape(dims, fix_coords), np.uint8)
    rc = lib.s3f_decode_binvox(
        file_bytes, len(file_bytes), out.ctypes.data_as(ctypes.c_void_p),
        dims[0], dims[1], dims[2], int(fix_coords))
    if rc != 0:
        raise IOError(f"binvox decode failed: {_ERRORS.get(rc, rc)}")
    return out


def materialize(paths, dims=None, fix_coords: bool = True,
                threads: int | None = None) -> np.ndarray:
    """Bulk-decode ``paths`` into one ``[n, *grid]`` uint8 array (0/1).

    ``dims``: expected header dims of every file (a mismatch raises). When
    None, discovered from the first file's header. ``threads`` defaults to
    ``os.cpu_count()``. Matches a loop of binvox.read_as_3d_array exactly.
    """
    paths = list(paths)
    if not paths:
        raise ValueError("materialize: empty path list")
    if dims is None:
        dims = read_dims(paths[0])
    dims = tuple(int(d) for d in dims)
    out = np.empty((len(paths),) + _out_shape(dims, fix_coords), np.uint8)
    lib = _load()
    if lib is None:
        for i, p in enumerate(paths):
            with open(p, "rb") as f:
                v = binvox.read_as_3d_array(f, fix_coords)
            if tuple(v.dims) != dims:
                raise IOError(f"{p}: {_ERRORS[-3]}")
            out[i] = v.data
        return out
    enc = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    err_index = ctypes.c_int64(-1)
    nthreads = threads if threads is not None else (os.cpu_count() or 1)
    rc = lib.s3f_materialize(
        arr, len(enc), out.ctypes.data_as(ctypes.c_void_p),
        dims[0], dims[1], dims[2], int(fix_coords), int(nthreads),
        ctypes.byref(err_index))
    if rc != 0:
        bad = paths[err_index.value] if 0 <= err_index.value < len(paths) else "<unknown>"
        raise IOError(f"{bad}: {_ERRORS.get(rc, rc)}")
    return out
