"""viewvox rebuild: render a binvox model to an image from the command line
(port of simple3dformer_tpu/tools/view_voxels.py).

The reference's closed-source `utils/viewvox` binary is an interactive
OpenGL viewer. Training hosts are headless, so the rebuild is an offscreen
C++ raycaster (tools/viewer/viewer.cpp, built with g++ into build/host/ on
first use) with the same feature surface exposed as flags instead of key
bindings:

  viewvox key/flag        here
  (default display)       internal voxels removed   (--ki keeps them)
  p (projection toggle)   --perspective / default orthographic
  mouse rotate/zoom       --azim/--elev/--dist
  x/y/z axis views        --view {x,y,z,X,Y,Z}
  a (alternate colours)   --alt-colors
  s/n/j/k (slice modes)   --slice AXIS:INDEX [--neighbours N]

Usage:
  python -m simple3dformer_tpu_torch.tools.view_voxels model.binvox -o out.png
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import numpy as np

from ..core import host_build

SOURCE = Path(__file__).resolve().parent / "viewer" / "viewer.cpp"

_AXIS_VIEWS = {
    # viewvox x/y/z look DOWN the axis, X/Y/Z look UP it
    "x": (180.0, 0.0), "y": (270.0, 0.0), "z": (90.0, 89.9),
    "X": (0.0, 0.0), "Y": (90.0, 0.0), "Z": (90.0, -89.9),
}


def _load():
    lib = host_build.load(SOURCE, host_build.VIEWER_FLAGS)
    lib.s3f_hollow.restype = None
    lib.s3f_hollow.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.s3f_render_voxels.restype = ctypes.c_int
    lib.s3f_render_voxels.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    return lib


def hollow(grid: np.ndarray) -> np.ndarray:
    """Remove voxels whose 6 neighbours are all occupied (viewvox default)."""
    g = np.ascontiguousarray(grid, np.uint8)
    if g.ndim != 3:
        raise ValueError("grid must be 3-D occupancy")
    out = np.empty_like(g)
    _load().s3f_hollow(g.ctypes.data_as(ctypes.c_void_p),
                       out.ctypes.data_as(ctypes.c_void_p), *g.shape)
    return out


def render(grid: np.ndarray, width: int = 512, height: int = 512,
           azim: float = 45.0, elev: float = 25.0, dist: float = 2.2,
           perspective: bool = False, alt_colors: bool = False,
           slice_axis: int = -1, slice_index: int = 0,
           neighbours: int = 0, keep_internal: bool = False) -> np.ndarray:
    """Render a 0/1 grid to an RGB uint8 image [height, width, 3]."""
    g = np.ascontiguousarray(grid, np.uint8)
    if g.ndim != 3:
        raise ValueError("grid must be 3-D occupancy")
    if not keep_internal:
        g = hollow(g)
    out = np.empty((height, width, 3), np.uint8)
    rc = _load().s3f_render_voxels(
        g.ctypes.data_as(ctypes.c_void_p), *g.shape, width, height,
        float(azim), float(elev), float(dist), int(perspective),
        int(alt_colors), int(slice_axis), int(slice_index), int(neighbours),
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"render failed (rc={rc}) — bad dims or slice index")
    return out


def save_image(img: np.ndarray, path: str) -> str:
    """PNG via PIL when it is installed, else PPM (``.ppm`` added to the
    name); -> the path written."""
    try:
        from PIL import Image
    except ImportError:
        if not path.endswith(".ppm"):
            path += ".ppm"
        with open(path, "wb") as f:
            f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
            f.write(np.ascontiguousarray(img, np.uint8).tobytes())
        return path
    Image.fromarray(img).save(path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", help=".binvox file to render")
    ap.add_argument("-o", "--out", default=None,
                    help="output image (default: <model>.png)")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--azim", type=float, default=45.0)
    ap.add_argument("--elev", type=float, default=25.0)
    ap.add_argument("--dist", type=float, default=2.2,
                    help="camera distance in grid extents")
    ap.add_argument("--view", choices=sorted(_AXIS_VIEWS), default=None,
                    help="axis-aligned view (viewvox x/y/z/X/Y/Z keys)")
    ap.add_argument("--perspective", action="store_true",
                    help="perspective projection (default orthographic)")
    ap.add_argument("--alt-colors", action="store_true",
                    help="alternating voxel colours (viewvox 'a')")
    ap.add_argument("--ki", action="store_true",
                    help="keep internal voxels (viewvox -ki)")
    ap.add_argument("--slice", default=None, metavar="AXIS:INDEX",
                    help="show one slice, e.g. z:40 (viewvox 's')")
    ap.add_argument("--neighbours", type=int, default=0,
                    help="extra slices each side of --slice (viewvox 'n')")
    args = ap.parse_args(argv)

    from ..data import binvox

    with open(args.model, "rb") as f:
        vox = binvox.read_as_3d_array(f)
    azim, elev = args.azim, args.elev
    if args.view is not None:
        azim, elev = _AXIS_VIEWS[args.view]
    slice_axis, slice_index = -1, 0
    if args.slice is not None:
        ax, idx = args.slice.split(":")
        slice_axis = {"x": 0, "y": 1, "z": 2}[ax.lower()]
        slice_index = int(idx)
    img = render(vox.data, width=args.width, height=args.height, azim=azim,
                 elev=elev, dist=args.dist, perspective=args.perspective,
                 alt_colors=args.alt_colors, slice_axis=slice_axis,
                 slice_index=slice_index, neighbours=args.neighbours,
                 keep_internal=args.ki)
    out = save_image(img, args.out or str(Path(args.model).with_suffix(".png")))
    print(f"rendered {args.model} [{vox.data.shape}] -> {out}")
    return out


if __name__ == "__main__":
    main()
