"""S3DIS room -> training blocks/samples + OBJ/bbox export utilities (port
of simple3dformer_tpu/tools/indoor3d_blocks.py; a library, no command line).

Rebuilds the reference's data/indoor3d_util.py:77-594: the block sweepers
(`room2blocks*`), the whole-room samplers (`room2samples*`), and the
OBJ / bounding-box exporters used for visualization and detection eval.
Every sampler draws from ``rng`` in the JAX function's order, so the same
``RandomState`` and the same room give the same arrays.

Deviations from the reference, on purpose:
  * indoor3d_util.py:170 computes the y block count as
    `int(np.ceil(collect_point_label(limit[1] - block_size) / stride)) + 1`
    — a latent crash (it calls the annotation collector on a float). The
    intended arithmetic `ceil((limit_y - block_size) / stride) + 1` (the
    symmetric x-axis line :169) is implemented here.
  * randomness is injectable (`rng` arg, default the global numpy state the
    reference uses) so block sampling is reproducible in tests.
  * block membership / sampling are vectorized; per-line file writes become
    np.savetxt-style batched writes. Output semantics (line formats, shapes,
    discard-below-100-points rule, duplicate-pad sampling) are unchanged.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..data.classmaps import S3DIS_NAMES

CLASS2LABEL = {name: i for i, name in enumerate(S3DIS_NAMES)}

# indoor3d_util.py:14-28 — fixed per-class colors and the "easy view" set
CLASS2COLOR = {
    "ceiling": [0, 255, 0],
    "floor": [0, 0, 255],
    "wall": [0, 255, 255],
    "beam": [255, 255, 0],
    "column": [255, 0, 255],
    "window": [100, 100, 255],
    "door": [200, 200, 100],
    "table": [170, 120, 200],
    "chair": [255, 0, 0],
    "sofa": [200, 100, 100],
    "bookcase": [10, 200, 100],
    "board": [200, 200, 200],
    "clutter": [50, 50, 50],
}
LABEL2COLOR = {CLASS2LABEL[c]: CLASS2COLOR[c] for c in CLASS2COLOR}
EASY_VIEW_LABELS = (7, 8, 9, 10, 11, 1)


def _rng(rng):
    return np.random if rng is None else rng


# ---------------------------------------------------------------------------
# sampling helpers (indoor3d_util.py:118-138)
# ---------------------------------------------------------------------------

def sample_data(data: np.ndarray, num_sample: int, rng=None):
    """Keep exactly num_sample rows: subsample if too many, pad with random
    duplicates if too few (the reference's with-replacement semantics)."""
    r = _rng(rng)
    n = data.shape[0]
    if n == num_sample:
        return data, np.arange(n)
    if n > num_sample:
        sample = r.choice(n, num_sample)
        return data[sample], sample
    sample = r.choice(n, num_sample - n)
    dup = data[sample]
    return np.concatenate([data, dup], 0), np.concatenate(
        [np.arange(n), sample]
    )


def sample_data_label(data, label, num_sample: int, rng=None):
    new_data, idx = sample_data(data, num_sample, rng=rng)
    return new_data, label[idx]


# ---------------------------------------------------------------------------
# room -> blocks (indoor3d_util.py:140-272)
# ---------------------------------------------------------------------------

def room2blocks(data: np.ndarray, label: np.ndarray, num_point: int,
                block_size: float = 1.0, stride: float = 1.0,
                random_sample: bool = False, sample_num: int | None = None,
                sample_aug: int = 1, rng=None):
    """Sweep (or randomly place) block_size x block_size xy-columns over a
    shifted room; each block with >= 100 points yields num_point sampled rows.

    data [N,6] XYZRGB (RGB already in [0,1]), label [N] -> (K,num_point,6),
    (K,num_point).
    """
    assert stride <= block_size
    r = _rng(rng)
    limit = np.amax(data, 0)[0:3]

    if not random_sample:
        # the reference's y-line is the latent collect_point_label bug; this
        # is the intended symmetric arithmetic (see module docstring)
        num_block_x = int(np.ceil((limit[0] - block_size) / stride)) + 1
        num_block_y = int(np.ceil((limit[1] - block_size) / stride)) + 1
        xbeg_list = np.repeat(np.arange(num_block_x) * stride, num_block_y)
        ybeg_list = np.tile(np.arange(num_block_y) * stride, num_block_x)
    else:
        num_block_x = int(np.ceil(limit[0] / block_size))
        num_block_y = int(np.ceil(limit[1] / block_size))
        if sample_num is None:
            sample_num = num_block_x * num_block_y * sample_aug
        xbeg_list = r.uniform(-block_size, limit[0], size=sample_num)
        ybeg_list = r.uniform(-block_size, limit[1], size=sample_num)

    block_data_list, block_label_list = [], []
    for xbeg, ybeg in zip(xbeg_list, ybeg_list):
        cond = (
            (data[:, 0] >= xbeg) & (data[:, 0] <= xbeg + block_size)
            & (data[:, 1] >= ybeg) & (data[:, 1] <= ybeg + block_size)
        )
        if np.sum(cond) < 100:  # discard near-empty blocks (reference :196)
            continue
        block_data, block_label = sample_data_label(
            data[cond], label[cond], num_point, rng=rng
        )
        block_data_list.append(block_data[None])
        block_label_list.append(block_label[None])

    return (np.concatenate(block_data_list, 0),
            np.concatenate(block_label_list, 0))


def room2blocks_plus(data_label, num_point, block_size, stride, random_sample,
                     sample_num, sample_aug, rng=None):
    """room2blocks with RGB /255 preprocessing (indoor3d_util.py:212-221)."""
    data = data_label[:, 0:6].copy()
    data[:, 3:6] /= 255.0
    label = data_label[:, -1].astype(np.uint8)
    return room2blocks(data, label, num_point, block_size, stride,
                       random_sample, sample_num, sample_aug, rng=rng)


def _load_data_label(path: str) -> np.ndarray:
    if path.endswith("txt"):
        return np.loadtxt(path)
    if path.endswith("npy"):
        return np.load(path)
    raise ValueError(f"unknown file type for {path!r} (want .txt or .npy)")


def room2blocks_wrapper(data_label_filename, num_point, block_size=1.0,
                        stride=1.0, random_sample=False, sample_num=None,
                        sample_aug=1, rng=None):
    return room2blocks_plus(
        _load_data_label(data_label_filename), num_point, block_size, stride,
        random_sample, sample_num, sample_aug, rng=rng,
    )


def room2blocks_plus_normalized(data_label, num_point, block_size, stride,
                                random_sample, sample_num, sample_aug,
                                rng=None):
    """Blocks with the 9-channel layout: block-centered XYZ + RGB + XYZ
    normalized by the room extent (indoor3d_util.py:235-260)."""
    data = data_label[:, 0:6].copy()
    data[:, 3:6] /= 255.0
    label = data_label[:, -1].astype(np.uint8)
    max_room = np.amax(data[:, 0:3], axis=0)

    data_batch, label_batch = room2blocks(
        data, label, num_point, block_size, stride, random_sample, sample_num,
        sample_aug, rng=rng,
    )
    new = np.zeros((data_batch.shape[0], num_point, 9))
    new[:, :, 6:9] = data_batch[:, :, 0:3] / max_room
    minxy = data_batch[:, :, 0:2].min(axis=1, keepdims=True)  # per block
    data_batch[:, :, 0:2] -= minxy + block_size / 2
    new[:, :, 0:6] = data_batch
    return new, label_batch


def room2blocks_wrapper_normalized(data_label_filename, num_point,
                                   block_size=1.0, stride=1.0,
                                   random_sample=False, sample_num=None,
                                   sample_aug=1, rng=None):
    return room2blocks_plus_normalized(
        _load_data_label(data_label_filename), num_point, block_size, stride,
        random_sample, sample_num, sample_aug, rng=rng,
    )


# ---------------------------------------------------------------------------
# room -> contiguous samples (indoor3d_util.py:274-347)
# ---------------------------------------------------------------------------

def room2samples(data: np.ndarray, label: np.ndarray, sample_num_point: int,
                 rng=None):
    """Shuffle the room once, chop into ceil(N/P) chunks of P points, pad the
    last chunk with random points. Returns (K,P,6), (K,P,1)."""
    r = _rng(rng)
    n = data.shape[0]
    order = np.arange(n)
    r.shuffle(order)
    data, label = data[order], label[order]

    batch_num = int(np.ceil(n / float(sample_num_point)))
    sample_datas = np.zeros((batch_num, sample_num_point, data.shape[1]))
    sample_labels = np.zeros((batch_num, sample_num_point, 1))
    for i in range(batch_num):
        beg, end = i * sample_num_point, min((i + 1) * sample_num_point, n)
        num = end - beg
        sample_datas[i, :num] = data[beg:end]
        sample_labels[i, :num, 0] = label[beg:end]
        if num < sample_num_point:
            makeup = r.choice(n, sample_num_point - num)
            sample_datas[i, num:] = data[makeup]
            sample_labels[i, num:, 0] = label[makeup]
    return sample_datas, sample_labels


def room2samples_plus_normalized(data_label, num_point, rng=None):
    """Whole-room samples in the 9-channel layout; unlike the block variant
    the reference does NOT re-center XYZ here (its :330-332 are commented
    out) — mirrored exactly."""
    data = data_label[:, 0:6].copy()
    data[:, 3:6] /= 255.0
    label = data_label[:, -1].astype(np.uint8)
    max_room = np.amax(data[:, 0:3], axis=0)

    data_batch, label_batch = room2samples(data, label, num_point, rng=rng)
    new = np.zeros((data_batch.shape[0], num_point, 9))
    new[:, :, 6:9] = data_batch[:, :, 0:3] / max_room
    new[:, :, 0:6] = data_batch
    return new, label_batch


def room2samples_wrapper_normalized(data_label_filename, num_point, rng=None):
    return room2samples_plus_normalized(
        _load_data_label(data_label_filename), num_point, rng=rng
    )


# ---------------------------------------------------------------------------
# OBJ / bbox exporters (indoor3d_util.py:77-116, 350-594)
# ---------------------------------------------------------------------------

def data_to_obj(data: np.ndarray, name: str = "example.obj",
                no_wall: bool = True) -> None:
    """[N,7] XYZRGBL -> OBJ point vertices, optionally dropping ceiling/wall."""
    label = data[:, -1].astype(int)
    keep = np.ones(len(data), bool)
    if no_wall:
        keep &= (label != 2) & (label != 0)
    with open(name, "w") as f:
        for row in data[keep]:
            f.write("v %f %f %f %d %d %d\n" % tuple(row[:6]))


def point_label_to_obj(input_filename: str, out_filename: str,
                       label_color: bool = True, easy_view: bool = False,
                       no_wall: bool = False) -> None:
    """Room data_label txt -> OBJ colored by class (or by stored RGB)."""
    data_label = np.loadtxt(input_filename)
    data = data_label[:, 0:6]
    label = data_label[:, -1].astype(int)
    keep = np.ones(len(data), bool)
    if easy_view:
        keep &= np.isin(label, EASY_VIEW_LABELS)
    if no_wall:
        keep &= (label != 2) & (label != 0)
    with open(out_filename, "w") as f:
        for row, lab in zip(data[keep], label[keep]):
            color = LABEL2COLOR[lab] if label_color else row[3:6]
            f.write("v %f %f %f %d %d %d\n" % (
                row[0], row[1], row[2], color[0], color[1], color[2]))


def collect_bounding_box(anno_path: str, out_filename: str) -> np.ndarray:
    """Per-instance axis-aligned bboxes for a room's Annotations/ dir.
    Each output line: x1 y1 z1 x2 y2 z2 label (room shifted to origin)."""
    rows = []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        if cls not in CLASS2LABEL:  # 'staris' etc.
            cls = "clutter"
        points = np.loadtxt(f)
        rows.append(np.concatenate([
            np.amin(points[:, 0:3], axis=0),
            np.amax(points[:, 0:3], axis=0),
            [CLASS2LABEL[cls]],
        ])[None])
    bbox_label = np.concatenate(rows, 0)
    room_min = np.amin(bbox_label[:, 0:3], axis=0)
    bbox_label[:, 0:3] -= room_min
    bbox_label[:, 3:6] -= room_min
    with open(out_filename, "w") as f:
        for r in bbox_label:
            f.write("%f %f %f %f %f %f %d\n" % tuple(r))
    return bbox_label


def collect_point_bounding_box(anno_path: str, out_filename: str,
                               file_format: str = "numpy") -> np.ndarray:
    """Per-point parent-instance bboxes: each row is
    XYZRGBL offsetX offsetY offsetZ a b c (center = point + offset, half-dims
    a,b,c) — indoor3d_util.py:534-594."""
    rows = []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        if cls not in CLASS2LABEL:
            cls = "clutter"
        points = np.loadtxt(f)
        xyz_min = np.amin(points[:, 0:3], axis=0)
        xyz_max = np.amax(points[:, 0:3], axis=0)
        center = (xyz_min + xyz_max) / 2
        halfdim = (xyz_max - xyz_min) / 2
        n = points.shape[0]
        rows.append(np.concatenate([
            points,
            np.full((n, 1), CLASS2LABEL[cls], dtype=float),
            center - points[:, 0:3],
            np.broadcast_to(halfdim, (n, 3)),
        ], axis=1))
    point_bbox = np.concatenate(rows, 0)
    point_bbox[:, 0:3] -= np.amin(point_bbox[:, 0:3], axis=0)

    if file_format == "txt":
        np.savetxt(out_filename, point_bbox,
                   fmt="%f %f %f %d %d %d %d %f %f %f %f %f %f".split())
    elif file_format == "numpy":
        np.save(out_filename, point_bbox)
    else:
        raise ValueError(f"unknown file format {file_format!r}")
    return point_bbox


_BOX_FACES = ((4, 3, 2, 1), (1, 2, 6, 5), (7, 6, 2, 3),
              (4, 8, 7, 3), (5, 8, 4, 1), (5, 6, 7, 8))


def bbox_label_to_obj(input_filename: str, out_filename_prefix: str,
                      easy_view: bool = False) -> list[str]:
    """Bbox file -> one OBJ+MTL cuboid per instance, colored per class
    (indoor3d_util.py:392-453). Returns the written OBJ paths."""
    bbox_label = np.atleast_2d(np.loadtxt(input_filename))
    written = []
    ins_cnt = 0
    for row in bbox_label:
        label = int(row[-1])
        if easy_view and label not in EASY_VIEW_LABELS:
            continue
        cls = S3DIS_NAMES[label]
        obj_path = f"{out_filename_prefix}_{cls}_{ins_cnt}.obj"
        mtl_path = f"{out_filename_prefix}_{cls}_{ins_cnt}.mtl"
        x, y, z = row[0:3]
        a, b, c = row[3:6] - row[0:3]
        color = np.array(LABEL2COLOR[label], dtype=float) / 255.0
        corners = [
            (x, y, z + c), (x, y + b, z + c), (x + a, y + b, z + c),
            (x + a, y, z + c), (x, y, z), (x, y + b, z),
            (x + a, y + b, z), (x + a, y, z),
        ]
        material = f"material{ins_cnt}"
        with open(obj_path, "w") as f:
            f.write(f"mtllib {os.path.basename(mtl_path)}\n")
            f.write(f"usemtl {material}\n")
            for v in corners:
                f.write("v %f %f %f\n" % v)
            f.write("g default\n")
            for face in _BOX_FACES:
                f.write("f %d %d %d %d\n" % face)
            f.write("\n")
        with open(mtl_path, "w") as f:
            f.write(f"newmtl {material}\n")
            f.write("Kd %f %f %f\n\n" % tuple(color))
        written.append(obj_path)
        ins_cnt += 1
    return written
