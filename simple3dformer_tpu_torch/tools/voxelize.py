"""Mesh -> binvox conversion (port of simple3dformer_tpu/tools/voxelize.py).

The reference shells out to the closed prebuilt binvox binary (its
data/binvox_converter.py and utils/off2binvox.py); here a native C++
voxelizer (tools/voxelizer/voxelizer.cpp, built with g++ into build/host/ on
first use) does the triangle rasterization and the solid fill, driven
through ctypes. Includes the reference converter's malformed-OFF-header
repair (headers like "OFF123 456 789" on one line).

Usage:
  python -m simple3dformer_tpu_torch.tools.voxelize MESH_OR_ROOT [-d DIM] [--surface]
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from ..core import host_build
from ..data import binvox

SOURCE = Path(__file__).resolve().parent / "voxelizer" / "voxelizer.cpp"


def build_library(force: bool = False) -> Path:
    """Build the voxelizer if its library is missing (``force``: rebuild);
    -> the library's path."""
    if force:
        host_build.library_path(SOURCE, host_build.VOXELIZER_FLAGS).unlink(missing_ok=True)
    path, _, _ = host_build.build(SOURCE, host_build.VOXELIZER_FLAGS)
    return path


def _get_lib():
    lib = host_build.load(SOURCE, host_build.VOXELIZER_FLAGS)
    lib.voxelize_mesh.restype = ctypes.c_long
    lib.voxelize_mesh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_long,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
    ]
    return lib


def voxelize(verts: np.ndarray, tris: np.ndarray, dim: int = 32,
             solid: bool = True) -> np.ndarray:
    """verts [V,3] float, tris [T,3] int -> bool occupancy [dim,dim,dim]."""
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    out = np.zeros(dim ** 3, dtype=np.uint8)
    n = _get_lib().voxelize_mesh(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(tris),
        dim, int(solid),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if n < 0:
        raise ValueError("voxelize_mesh: invalid mesh arguments")
    return out.reshape(dim, dim, dim).astype(bool)


def fix_off_header(text: str) -> str:
    """Repair 'OFF123 456 789' first lines (the reference's binvox_converter.py:21-28)."""
    first, _, rest = text.partition("\n")
    first = first.strip()
    if first.startswith("OFF") and first != "OFF":
        return "OFF\n" + first[3:].strip() + "\n" + rest
    return text


def read_off(path: str) -> tuple[np.ndarray, np.ndarray]:
    """An OFF file -> (verts [V,3] f32, tris [T,3] int32), polygons fan-triangulated."""
    with open(path) as f:
        text = fix_off_header(f.read())
    tokens = text.split()
    if not tokens or tokens[0] != "OFF":
        raise ValueError(f"not an OFF file: {path}")
    nv, nf = int(tokens[1]), int(tokens[2])
    pos = 4
    verts = np.array(tokens[pos: pos + nv * 3], dtype=np.float32).reshape(nv, 3)
    pos += nv * 3
    tris = []
    for _ in range(nf):
        k = int(tokens[pos])
        poly = [int(t) for t in tokens[pos + 1: pos + 1 + k]]
        pos += 1 + k
        for i in range(1, k - 1):  # fan triangulation
            tris.append((poly[0], poly[i], poly[i + 1]))
    return verts, np.asarray(tris, dtype=np.int32)


def read_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """An OBJ file's ``v`` and ``f`` lines -> (verts [V,3] f32, tris [T,3] int32)."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[i], idx[i + 1]))
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def mesh_to_binvox(mesh_path: str, out_path: str | None = None, dim: int = 32,
                   solid: bool = True) -> str:
    """OFF/OBJ file -> .binvox file (the reference's off2binvox.py)."""
    reader = read_off if mesh_path.lower().endswith(".off") else read_obj
    verts, tris = reader(mesh_path)
    grid = voxelize(verts, tris, dim=dim, solid=solid)
    out_path = out_path or os.path.splitext(mesh_path)[0] + ".binvox"
    model = binvox.Voxels(grid, [dim, dim, dim], [0.0, 0.0, 0.0], 1.0, "xyz")
    with open(out_path, "wb") as f:
        binvox.write(model, f)
    return out_path


def convert_tree(root: str, dim: int = 32, solid: bool = True,
                 exts: tuple = (".off", ".obj")) -> list[str]:
    """Convert every mesh under ``root`` next to itself (the reference's
    binvox_converter.py:31-88); a mesh that fails is reported and skipped."""
    outputs = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.lower().endswith(exts):
                src = os.path.join(dirpath, name)
                try:
                    outputs.append(mesh_to_binvox(src, dim=dim, solid=solid))
                except (OSError, ValueError, IndexError) as e:  # a bad mesh, as the reference
                    print(f"skip {src}: {e}")
    return outputs


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Convert OFF/OBJ meshes to binvox grids.")
    ap.add_argument("path", help="mesh file or dataset root")
    ap.add_argument("-d", "--dim", type=int, default=32)
    ap.add_argument("--surface", action="store_true", help="no solid fill")
    args = ap.parse_args(argv)
    if os.path.isdir(args.path):
        outs = convert_tree(args.path, dim=args.dim, solid=not args.surface)
        print(f"converted {len(outs)} meshes")
    else:
        print(mesh_to_binvox(args.path, dim=args.dim, solid=not args.surface))


if __name__ == "__main__":
    main()
