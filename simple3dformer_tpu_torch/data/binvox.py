"""binvox occupancy-grid codec (port of simple3dformer_tpu/data/binvox.py).

The run-length format of Patrick Min's binvox, as the reference's
utils/binvox_rw.py reads it: an ASCII header (#binvox / dim / translate /
scale / data), then (value, count) byte pairs in x-z-y order; ``fix_coords``
transposes to x-y-z. Decoding is vectorised numpy on the host; the decoded
uint8 grids go to the device once, by data/pipeline.DeviceResidentDataset.
``read_as_coord_array`` decodes to the occupied voxels' coordinates (the
voxel augmentation's input), ``write`` encodes back (runs capped at 255).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


@dataclass
class Voxels:
    data: np.ndarray  # bool, [X, Y, Z] (axis_order 'xyz') or [X, Z, Y] ('xzy')
    dims: list
    translate: list
    scale: float
    axis_order: str = "xyz"

    def clone(self) -> "Voxels":
        return Voxels(self.data.copy(), list(self.dims), list(self.translate),
                      self.scale, self.axis_order)


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


def read_as_coord_array(fp, fix_coords: bool = True) -> Voxels:
    """Decode to a 3xN array of occupied voxel coordinates."""
    dims, translate, scale = read_header(fp)
    raw = np.frombuffer(fp.read(), dtype=np.uint8)
    values, counts = raw[::2].astype(bool), raw[1::2].astype(np.int64)
    ends = np.cumsum(counts)
    starts = np.concatenate(([0], ends[:-1]))
    # linear indices of all occupied voxels (vectorized run expansion)
    occ_starts, occ_ends = starts[values], ends[values]
    lengths = occ_ends - occ_starts
    if lengths.size == 0:
        flat = np.empty(0, dtype=np.int64)
    else:
        offsets = np.repeat(occ_starts, lengths)
        within = np.arange(lengths.sum()) - np.repeat(
            np.cumsum(lengths) - lengths, lengths
        )
        flat = offsets + within
    wxh = dims[0] * dims[1]
    x = flat // wxh
    zwpy = flat % wxh
    z = zwpy // dims[0]
    y = zwpy % dims[0]
    data = np.vstack((x, y, z)) if fix_coords else np.vstack((x, z, y))
    return Voxels(np.ascontiguousarray(data), dims, translate, scale,
                  "xyz" if fix_coords else "xzy")


def dense_to_sparse(voxel_data: np.ndarray, dtype=int) -> np.ndarray:
    if voxel_data.ndim != 3:
        raise ValueError("voxel data is wrong shape; should be 3D array")
    return np.asarray(np.nonzero(voxel_data), dtype)


def sparse_to_dense(voxel_data: np.ndarray, dims, dtype=bool) -> np.ndarray:
    if voxel_data.ndim != 2 or voxel_data.shape[0] != 3:
        raise ValueError("voxel data is wrong shape; should be 3xN array")
    if np.isscalar(dims):
        dims = [dims] * 3
    xyz = voxel_data.astype(np.int64)
    valid = np.all((xyz >= 0) & (xyz < np.array(dims)[:, None]), axis=0)
    xyz = xyz[:, valid]
    out = np.zeros(dims, dtype=dtype)
    out[tuple(xyz)] = True
    return out


def write(voxel_model: Voxels, fp) -> None:
    """RLE-encode a Voxels model back to binvox bytes (runs capped at 255)."""
    data = voxel_model.data
    if voxel_model.axis_order not in ("xzy", "xyz"):
        raise ValueError("unsupported voxel model axis order")
    if voxel_model.axis_order == "xyz":
        data = np.transpose(data, (0, 2, 1))  # back to file order

    fp.write(b"#binvox 1\n")
    fp.write(("dim " + " ".join(map(str, voxel_model.dims)) + "\n").encode())
    fp.write(
        ("translate " + " ".join(map(str, voxel_model.translate)) + "\n").encode()
    )
    fp.write(f"scale {voxel_model.scale}\n".encode())
    fp.write(b"data\n")

    flat = data.reshape(-1).astype(np.uint8)
    # vectorized RLE: boundaries where the value changes
    if flat.size == 0:
        return
    change = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [flat.size]))
    out = bytearray()
    for s, e in zip(starts, ends):
        v = int(flat[s])
        run = int(e - s)
        while run > 255:
            out += bytes((v, 255))
            run -= 255
        out += bytes((v, run))
    fp.write(bytes(out))


def roundtrip_bytes(voxels: Voxels) -> Voxels:
    """write -> read helper (used by tests)."""
    buf = io.BytesIO()
    write(voxels, buf)
    buf.seek(0)
    return read_as_3d_array(buf, fix_coords=(voxels.axis_order == "xyz"))
