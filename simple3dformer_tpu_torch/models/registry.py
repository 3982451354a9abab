"""Model registry: config model names -> constructors (port of
simple3dformer_tpu/models/registry.py; the reference imported
``models.{name}.model`` by name).

Ported: the 3DViT family. ``Hengshuang`` raises until its slice.
"""

from __future__ import annotations

from .point_vit import PointViT, variant_spec

POINT_VIT_VARIANTS = {
    "3DViT", "3DViT_0_layer", "3DViT_1_layer", "3DViT_LWF", "3DViT_s3dis",
}


def make_point_model(cfg, task: str, **kw):
    """task: 'cls' | 'seg'. cfg needs num_point, num_class, input_dim and model.*"""
    name = cfg.model.name
    if name == "Hengshuang":
        raise NotImplementedError("model=Hengshuang is not ported yet: it comes with the "
                                  "Hengshuang slice (its vector-attention kernels)")
    if name in POINT_VIT_VARIANTS:
        return PointViT.from_config(cfg, task=task, **kw)
    raise ValueError(f"Unknown model name {name!r}")


def has_lwf_pathway(cfg) -> bool:
    name = cfg.model.name
    if name == "Hengshuang":
        return False
    return variant_spec(name, 4, 4)["images"]
