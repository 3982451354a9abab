"""S3DIS raw annotations -> per-room npy files (XYZRGBL) (port of
simple3dformer_tpu/tools/collect_s3dis.py).

The reference's data/collect_indoor3d_data.py and indoor3d_util.py:35-75
(collect_point_label): walks Area_X/room/Annotations/*.txt instance files,
maps instance class names to the 13 S3DIS labels (unknown classes ->
clutter, including the dataset's 'staris' typo), shifts the room so the
minimum corner sits at the origin, and saves Area_X_room.npy, which
data.datasets.S3DISDataset reads.

Usage:
  python -m simple3dformer_tpu_torch.tools.collect_s3dis RAW_ROOT [-o OUTPUT]
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..data.classmaps import S3DIS_NAMES

CLASS2LABEL = {name: i for i, name in enumerate(S3DIS_NAMES)}


def collect_point_label(anno_path: str, out_filename: str,
                        file_format: str = "numpy") -> np.ndarray:
    """One room's Annotations/ dir -> [N, 7] XYZRGBL array (+ save)."""
    points_list = []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        if cls not in CLASS2LABEL:  # e.g. 'staris' in some rooms
            cls = "clutter"
        pts = np.loadtxt(f)
        labels = np.full((pts.shape[0], 1), CLASS2LABEL[cls], dtype=pts.dtype)
        points_list.append(np.concatenate([pts, labels], axis=1))
    data_label = np.concatenate(points_list, axis=0)
    data_label[:, 0:3] -= np.amin(data_label, axis=0)[0:3]
    if file_format == "numpy":
        np.save(out_filename, data_label)
    elif file_format == "txt":
        np.savetxt(out_filename, data_label, fmt="%f %f %f %d %d %d %d".split())
    else:
        raise ValueError(f"unknown file format {file_format}")
    return data_label


def collect_dataset(raw_root: str, output_folder: str) -> list[str]:
    """Walk Area_*/room/Annotations dirs producing Area_X_room.npy files; a
    room that cannot be read is reported and skipped, as in the reference."""
    os.makedirs(output_folder, exist_ok=True)
    outputs = []
    for anno_path in sorted(glob.glob(os.path.join(raw_root, "Area_*", "*", "Annotations"))):
        parts = anno_path.rstrip("/").split(os.sep)
        out_path = os.path.join(output_folder, f"{parts[-3]}_{parts[-2]}.npy")
        try:
            collect_point_label(anno_path, out_path, "numpy")
            outputs.append(out_path)
        except (OSError, ValueError) as e:  # the reference's per-room tolerance
            print(anno_path, "ERROR!!", e)
    return outputs


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Collect S3DIS annotations into per-room arrays.")
    ap.add_argument("raw_root", help="Stanford3dDataset_v1.2_Aligned_Version dir")
    ap.add_argument("-o", "--output", default="./data/stanford_indoor3d")
    args = ap.parse_args(argv)
    outs = collect_dataset(args.raw_root, args.output)
    print(f"collected {len(outs)} rooms")


if __name__ == "__main__":
    main()
