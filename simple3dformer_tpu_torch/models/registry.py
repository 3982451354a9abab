"""Model registry: config model names -> constructors (port of
simple3dformer_tpu/models/registry.py; the reference imported
``models.{name}.model`` by name).

The 3DViT family and the Hengshuang Point Transformer (cls and seg).
"""

from __future__ import annotations

from .hengshuang import PointTransformerCls, PointTransformerSeg
from .point_vit import PointViT, variant_spec

POINT_VIT_VARIANTS = {
    "3DViT", "3DViT_0_layer", "3DViT_1_layer", "3DViT_LWF", "3DViT_s3dis",
}


def make_point_model(cfg, task: str, dtype=None, **kw):
    """task: 'cls' | 'seg'. cfg needs num_point, num_class, input_dim and model.*
    ``dtype``: the compute dtype (None: f32; torch.bfloat16, the parameters
    staying f32)."""
    name = cfg.model.name
    if name == "Hengshuang":
        model = PointTransformerCls if task == "cls" else PointTransformerSeg
        return model.from_config(cfg, dtype=dtype, **kw)
    if name in POINT_VIT_VARIANTS:
        return PointViT.from_config(cfg, task=task, dtype=dtype, **kw)
    raise ValueError(f"Unknown model name {name!r}")


def has_lwf_pathway(cfg) -> bool:
    """Whether cfg's model has the 2D image pathway (``forward_images``) that
    LwF trains: the 3DViT variants 3DViT_LWF, 3DViT_1_layer and 3DViT_0_layer."""
    name = cfg.model.name
    if name == "Hengshuang":
        return False
    return variant_spec(name, 4, 4)["images"]
