"""binvox occupancy-grid reader (port of the reader of simple3dformer_tpu/data/binvox.py).

The run-length format of Patrick Min's binvox, as the reference's
utils/binvox_rw.py reads it: an ASCII header (#binvox / dim / translate /
scale / data), then (value, count) byte pairs in x-z-y order; ``fix_coords``
transposes to x-y-z. Decoding is vectorised numpy on the host; the decoded
uint8 grids go to the device once, by data/pipeline.DeviceResidentDataset.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Voxels:
    data: np.ndarray  # bool, [X, Y, Z] (axis_order 'xyz') or [X, Z, Y] ('xzy')
    dims: list
    translate: list
    scale: float
    axis_order: str = "xyz"


def read_header(fp) -> tuple[list, list, float]:
    line = fp.readline().strip()
    if not line.startswith(b"#binvox"):
        raise IOError("Not a binvox file")
    dims = list(map(int, fp.readline().strip().split(b" ")[1:]))
    translate = list(map(float, fp.readline().strip().split(b" ")[1:]))
    scale = list(map(float, fp.readline().strip().split(b" ")[1:]))[0]
    fp.readline()  # "data"
    return dims, translate, scale


def read_as_3d_array(fp, fix_coords: bool = True) -> Voxels:
    """Decode to a dense bool grid; xzy -> xyz transpose when fix_coords."""
    dims, translate, scale = read_header(fp)
    raw = np.frombuffer(fp.read(), dtype=np.uint8)
    values, counts = raw[::2], raw[1::2]
    data = np.repeat(values.astype(bool), counts)
    if data.size != int(np.prod(dims)):
        raise IOError(f"binvox payload has {data.size} voxels, expected {np.prod(dims)}")
    data = data.reshape(dims)
    if fix_coords:
        data = np.transpose(data, (0, 2, 1))
        order = "xyz"
    else:
        order = "xzy"
    return Voxels(data, dims, translate, scale, order)
