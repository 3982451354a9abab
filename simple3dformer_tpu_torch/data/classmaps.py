"""Dataset class taxonomies (port of simple3dformer_tpu/data/classmaps.py; the
reference's global_var.py).

The standard public label maps for ModelNet10/40, the ShapeNet synset IDs,
S3DIS and ScanObjectNN, stored as ordered name lists, with the reference's
idx->name / name->idx dict views derived from them, and the ImageNet-1k names
(``imagenet_classes.json``, package data beside this module).
"""

from __future__ import annotations

MODELNET10_NAMES = [
    "bathtub", "chair", "dresser", "night_stand", "sofa",
    "toilet", "bed", "desk", "monitor", "table",
]

MODELNET40_NAMES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]

SHAPENET_V2_SYNSETS = [
    "02691156", "02747177", "02773838", "02801938", "02808440", "02818832",
    "02828884", "02843684", "02871439", "02876657", "02880940", "02924116",
    "02933112", "02942699", "02946921", "02954340", "02958343", "02992529",
    "03001627", "03046257", "03085013", "03207941", "03211117", "03261776",
    "03325088", "03337140", "03467517", "03513137", "03593526", "03624134",
    "03636649", "03642806", "03691459", "03710193", "03759954", "03761084",
    "03790512", "03797390", "03928116", "03938244", "03948459", "03991062",
    "04004475", "04074963", "04090263", "04099429", "04225987", "04256520",
    "04330267", "04379243", "04401088", "04460130", "04468005", "04530566",
    "04554684",
]

# v1 adds two extra synsets at the end (global_var.py:68-98)
SHAPENET_V1_SYNSETS = SHAPENET_V2_SYNSETS + ["02834778", "02858304"]

S3DIS_NAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
]

SCANOBJECTNN_NAMES = [
    "bag", "bin", "box", "cabinet", "chair", "desk", "display", "door",
    "shelf", "table", "bed", "pillow", "sink", "sofa", "toilet",
]


def idx2name(names: list[str]) -> dict[int, str]:
    return dict(enumerate(names))


def name2idx(names: list[str]) -> dict[str, int]:
    return {n: i for i, n in enumerate(names)}


def imagenet_class_names() -> dict[int, str]:
    """ImageNet-1k index -> human-readable name (the reference's
    data/class_names_imagenet.py lab_dict), read from the JSON beside this
    module."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "imagenet_classes.json")
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


CLASSES_ModelNet10 = idx2name(MODELNET10_NAMES)
CLASSES_ModelNet40 = idx2name(MODELNET40_NAMES)
CLASSES_SHAPENET = idx2name(SHAPENET_V2_SYNSETS)
CLASSES_SHAPENET_NUMBER = name2idx(SHAPENET_V2_SYNSETS)
CLASSES_SHAPENET_V1 = idx2name(SHAPENET_V1_SYNSETS)
CLASSES_SHAPENET_NUMBER_V1 = name2idx(SHAPENET_V1_SYNSETS)
