"""CAD-drawing dataset: rendered drawings and graph-node annotations (port of
simple3dformer_tpu/data/cad.py; the reference's data/CADdataset.py,
CADDataLoader :22-172, sample_and_group :174-199, draw_pts :201-210).

The reference module is unused by any entry point and cannot run as shipped
(it calls ``random_point_sample``, ``imagenet_preprocess``, ``PALLTE`` and
``AnnoList``, defined nowhere in its tree). The JAX package fills those holes
with their standard meanings (uniform index sampling without replacement;
ImageNet mean/std normalisation), and so does the port.

Layout on disk (reference :42-43):
    root/images/{split}/images/*.png
    root/annotations/{split}/constructed_graphs_withdeg/*.npy
Each .npy holds a pickled dict with keys ``class`` (per-node labels),
``centers_normed`` ([N,2] float coords in [-1,1]), ``node`` (geometry
features) and ``degrees`` (node degrees, clipped to [0,128] :111).

As in the JAX package: numpy in and out, NHWC float32 images; an injectable
``np.random.RandomState`` (drawn from in the JAX reader's order) instead of
four global RNGs reseeded to 123; the debug renderers draw with numpy and PIL
instead of cv2; each annotation's node count is read once.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from .datasets import _fps_numpy

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def imagenet_preprocess(img: np.ndarray) -> np.ndarray:
    """Normalize an HWC float32 [0,1] image with ImageNet statistics.

    The reference calls a torchvision transform of this name that is not
    defined anywhere in its tree (CADdataset.py:39) — this is the standard
    meaning.
    """
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def random_point_sample(xyz: np.ndarray, npoint: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Uniform sampling of ``npoint`` distinct indices — the missing
    ``random_point_sample`` the reference calls at CADdataset.py:186."""
    return rng.choice(xyz.shape[0], size=npoint, replace=False)


def sample_and_group(npoint: int, nsample: int, xyz: np.ndarray,
                     target: np.ndarray, geo_feat: np.ndarray,
                     degree: np.ndarray, rng: np.random.RandomState,
                     rand_prob: float = 0.0):
    """FPS (or, with prob ``rand_prob``, uniform) cluster centers + kNN
    grouping of all per-node arrays (reference :174-199, unbatched).

    Returns (grouped_xyz [S,K,2], grouped_target [S,K], grouped_geo
    [S,K,...], grouped_degree [S,K,1], idx [S,K]).
    """
    if rand_prob > 0.001 and rng.uniform(0.0, 1.0) < rand_prob:
        fps_idx = random_point_sample(xyz, npoint, rng)
    else:
        fps_idx = _fps_numpy(xyz, npoint, rng)
    new_xyz = xyz[fps_idx]                                   # [S, C]
    # squared pairwise distance, then the reference's full argsort-take
    # (:192-193) — kNN by sorted order, ties broken by index like argsort
    d = ((new_xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d, axis=-1, kind="stable")[:, :nsample]  # [S, K]
    return xyz[idx], target[idx], geo_feat[idx], degree[idx], idx


def _eval_divisor(n: int) -> int:
    """The reference's eval-time cluster-count schedule (:142-149):
    npoint = N // div with div bucketed by drawing size."""
    if 0 < n <= 1000:
        return 8
    if n <= 5000:
        return 16
    if n <= 20000:
        return 48
    return 96


class CADDrawingDataset:
    """Drawing images paired with graph-node point sets (reference
    ``CADDataLoader`` :22-172).

    Item layout mirrors the reference's 7-tuple: ``(image [size,size,3],
    point_set, target, geo_feat, degree, indexes, basename)``; with
    ``do_clus`` the point arrays are grouped ``[S, nn, ...]`` clusters —
    S = ``clus_num_per_batch`` in training (random centers with prob 0.2,
    else FPS), S = N//div at eval, where eval keeps the *ungrouped* target
    (reference :154, a quirk kept: eval consumers score per original node).
    Without ``do_clus`` point arrays are truncated to the first 10000 nodes
    (:166-167) and ``indexes`` is the reference's placeholder ``[1.]``.
    """

    EXCLUDE = ("0104-0102",)  # corrupt sample dropped by the reference :47-49

    def __init__(self, root: str, clus_ratio: float = 1 / 32,
                 split: str = "training", uniform: bool = False,
                 do_norm: bool = True, do_clus: bool = False, cfg=None,
                 rng: np.random.RandomState | None = None):
        # clus_ratio and uniform are accepted-but-unused in the reference
        # too (:23); kept for signature parity, not wired to anything.
        del clus_ratio, uniform
        self.root = root
        self.split = split
        self.do_norm = do_norm
        self.do_clus = do_clus
        self.rng = rng if rng is not None else np.random.RandomState(123)
        if cfg is not None:
            self.clus_num_per_batch = cfg.clus_num_per_batch
            self.nn = cfg.nn
            self.size = cfg.img_size
        else:  # reference defaults :33-35
            self.clus_num_per_batch = 16
            self.nn = 64
            self.size = 700

        imgs = sorted(glob(os.path.join(root, "images", split, "images",
                                        "*.png")))
        annos = sorted(glob(os.path.join(root, "annotations", split,
                                         "constructed_graphs_withdeg",
                                         "*.npy")))
        # DELIBERATE FIX of reference breakage: :47-49 removes the corrupt
        # sample from the image list only, then asserts equal lengths (:51)
        # — guaranteed AssertionError whenever the sample exists. Drop the
        # pair from both lists.
        imgs = [p for p in imgs
                if not any(b in p for b in self.EXCLUDE)]
        annos = [p for p in annos
                 if not any(b in p for b in self.EXCLUDE)]
        self.image_path_list, self.anno_path_list = imgs, annos
        assert len(imgs) == len(annos), (
            f"{len(imgs)} images vs {len(annos)} annotations under {root}")
        if do_clus:
            self._filter_smallset()

    def _load_anno(self, path: str) -> dict:
        return np.load(path, allow_pickle=True).item()

    def _filter_smallset(self):
        """Drop drawings with fewer than ``nn`` nodes (reference :72-82)."""
        keep_i, keep_a = [], []
        for img, ann in zip(self.image_path_list, self.anno_path_list):
            if len(self._load_anno(ann)["class"]) >= self.nn:
                keep_i.append(img)
                keep_a.append(ann)
        self.image_path_list, self.anno_path_list = keep_i, keep_a

    def __len__(self):
        return len(self.image_path_list)

    def _load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB").resize((self.size, self.size))
        arr = np.asarray(img, np.float32) / 255.0
        return imagenet_preprocess(arr) if self.do_norm else arr

    def __getitem__(self, index: int):
        img_path = self.image_path_list[index]
        ann_path = self.anno_path_list[index]
        base_i = os.path.basename(img_path).split(".")[0]
        base_a = os.path.basename(ann_path).split(".")[0]
        assert base_i == base_a, f"pairing mismatch: {base_i} vs {base_a}"

        image = self._load_image(img_path)
        anno = self._load_anno(ann_path)
        target = np.asarray(anno["class"], np.int64)
        point_set = np.asarray(anno["centers_normed"], np.float32)
        geo_feat = np.asarray(anno["node"], np.int64)
        degree = np.clip(np.asarray(anno["degrees"], np.int64),
                         0, 128)[:, None]
        basename = os.path.basename(img_path)

        if self.do_clus:
            if self.split == "training":
                point_set, target, geo_feat, degree, indexes = \
                    sample_and_group(self.clus_num_per_batch, self.nn,
                                     point_set, target, geo_feat, degree,
                                     self.rng, rand_prob=0.2)
            else:
                npoint = point_set.shape[0] // _eval_divisor(
                    point_set.shape[0])
                full_target = target
                point_set, target, geo_feat, degree, indexes = \
                    sample_and_group(npoint, self.nn, point_set, target,
                                     geo_feat, degree, self.rng)
                target = full_target  # reference :154 — eval scores per node
        else:
            indexes = np.asarray([1.0], np.float32)  # reference :165
            point_set = point_set[:10000]
            target = target[:10000]

        return image, point_set, target, geo_feat, degree, indexes, basename

    # ------------------------------------------------------------------
    # debug renderers (reference draw_pts :201-210 / plot_indexes :212-236,
    # cv2-free)
    # ------------------------------------------------------------------

    def draw_pts(self, point_set: np.ndarray, save_path: str,
                 re_norm: bool = True):
        """Rasterize node centers into a white-on-black PNG."""
        from PIL import Image

        img = np.zeros((700, 700), np.uint8)
        pts = point_set * 350 + 350 if re_norm else point_set
        ij = np.clip(pts.astype(np.int64), 0, 699)
        img[ij[:, 1], ij[:, 0]] = 255
        Image.fromarray(img).save(save_path)

    def plot_indexes(self, point_set: np.ndarray, indexes: np.ndarray,
                     basename: str, save_dir: str, re_norm: bool = True):
        """One random colour per cluster, the center drawn brighter."""
        os.makedirs(save_dir, exist_ok=True)
        from PIL import Image

        img = np.zeros((700, 700, 3), np.uint8)
        pts = point_set * 350 + 350 if re_norm else point_set
        ij = np.clip(pts.astype(np.int64), 0, 699)
        for row in indexes:
            color = self.rng.randint(64, 256, size=3)
            img[ij[row, 1], ij[row, 0]] = color
            img[ij[row[0], 1], ij[row[0], 0]] = np.minimum(color + 64, 255)
        out = os.path.join(save_dir, basename.replace(".svg", ".png"))
        Image.fromarray(img).save(out)
