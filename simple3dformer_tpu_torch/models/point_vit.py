"""3DViT family: point clouds through a DeiT backbone (port of
simple3dformer_tpu/models/point_vit.py; the reference's
models/3DViT{,_0_layer,_1_layer,_LWF}/model.py).

One module covers every variant; they differ in the stem width, the
TransitionDown pyramid, and whether the 2D image pathway (LwF) exists:

  variant        stem   transition-downs (npoint, channel)   2D pathway
  3DViT          D/4    (N, D/2), (N/4, D)                   no
  3DViT_LWF      D/4    (N/4, D/2), (N/16, D)                yes
  3DViT_1_layer  D/2    (N/4, D)                             yes
  3DViT_0_layer  D      -                                    yes
  3DViT_s3dis    an alias of 3DViT (see the JAX module)

The 3D forward of every variant is ported: stem MLPs, TransitionDowns, the
cls token and the ViT blocks (the fused CUDA kernels on the card), then a
TransitionUp per level back to full resolution; ``cls`` mean-pools, ``seg``
keeps per-point logits. ``dtype=torch.bfloat16`` is the JAX package's
``compute_dtype``: every Linear and 1x1 conv computes in bf16 and the
parameters stay f32. So the stems return bf16, each BatchNorm and LayerNorm
f32; the cls token takes the tokens' dtype (f32 after a transition-down, bf16
in ``3DViT_0_layer``), which the blocks' residual stream keeps; the head
returns bf16 logits. The image variants' 2D pathway (``forward_images``, the
LwF student's image logits) runs images through the patch embedding, the cls
token, the 2D position embedding, the same blocks and the 1000-way 2D head.

State-dict names are the reference's: ``fc1.0`` / ``fc1.2`` and
``fc_pos_embed.*`` for the stems, ``transition_downs.{i}.sa.*``,
``transition_ups.{i}.fc1.*``, ``blocks.*``, ``norm``, ``cls_token``; the point
head is ``head`` in the plain variant (the reference replaced DeiT's head,
models/3DViT/model.py:233-236) and ``new_head`` beside the 2D ``head`` in the
image variants. The JAX package calls the point head ``new_head`` in every
variant; utils/convert.py maps the names.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import AMSoftmaxLayer, dense, trunc_normal
from ..nn.vit import BACKBONES, PatchEmbed2D, ViTCore
from .hengshuang import TransitionDown, TransitionUp


def variant_spec(variant: str, D: int, N: int):
    if variant in ("3DViT", "3DViT_s3dis"):
        return dict(stem=D // 4, tds=[(N, D // 2), (N // 4, D)], images=False)
    if variant == "3DViT_LWF":
        return dict(stem=D // 4, tds=[(N // 4, D // 2), (N // 16, D)], images=True)
    if variant == "3DViT_1_layer":
        return dict(stem=D // 2, tds=[(N // 4, D)], images=True)
    if variant == "3DViT_0_layer":
        return dict(stem=D, tds=[], images=True)
    raise ValueError(f"Unknown 3DViT variant {variant!r}")


class StemMLP(nn.Sequential):
    """Linear -> ReLU -> Linear (the reference's fc1 / fc_pos_embed)."""

    def __init__(self, in_features: int, features: int, generator=None, device=None,
                 dtype=None):
        kw = dict(generator=generator, device=device, dtype=dtype)
        super().__init__(dense(in_features, features, **kw), nn.ReLU(),
                         dense(features, features, **kw))


class PointViT(ViTCore):
    """PointTransformerCls / PointTransformerSeg of the 3DViT family.

    x: [B, N, input_dim] (xyz first) -> [B, N, num_class] (seg) or
    [B, num_class] (cls).
    """

    def __init__(self, variant: str, task: str, num_point: int, num_class: int,
                 input_dim: int = 3, nneighbor: int = 16,
                 transformer_backbone: str = "deit_tiny_patch16_224", head: str = "default",
                 img_size: int = 224, bn_momentum: float = 0.9,
                 generator: torch.Generator | None = None, device=None,
                 dtype: torch.dtype | None = None):
        bb = BACKBONES[transformer_backbone]
        D = bb["embed_dim"]
        super().__init__(D, bb["depth"], bb["num_heads"], bb["mlp_ratio"], bb["qkv_bias"],
                         generator=generator, device=device, dtype=dtype)
        if task not in ("cls", "seg"):
            raise ValueError(f"task must be 'cls' or 'seg', not {task!r}")
        spec = variant_spec(variant, D, num_point)
        self.variant, self.task, self.spec, self.embed_dim = variant, task, spec, D
        kw = dict(generator=generator, device=device, dtype=dtype)

        self.fc1 = StemMLP(input_dim, spec["stem"], **kw)
        self.fc_pos_embed = StemMLP(3, spec["stem"], **kw)
        channels = [spec["stem"]] + [c for _, c in spec["tds"]]
        ntd = len(spec["tds"])
        self.transition_downs = nn.ModuleList(
            TransitionDown(npoint, nneighbor, (channels[i] + 3, c, c), bn_momentum, **kw)
            for i, (npoint, c) in enumerate(spec["tds"]))
        self.transition_ups = nn.ModuleList(
            TransitionUp(channels[ntd - i], channels[ntd - 1 - i], channels[ntd - 1 - i],
                         bn_momentum, **kw)
            for i in range(ntd))
        self.cls_token = nn.Parameter(trunc_normal((1, 1, D), 0.02, generator).to(device))

        # decode ends at the stem's width (D in 0_layer, which has no transitions)
        point_head = (AMSoftmaxLayer(channels[0], num_class, generator=generator, device=device)
                      if head == "AMSoftmax" else dense(channels[0], num_class, **kw))
        self.head_name = "new_head" if spec["images"] else "head"
        self.add_module(self.head_name, point_head)
        if spec["images"]:
            n2d = (img_size // bb["patch_size"]) ** 2
            self.patch_embed = PatchEmbed2D(bb["patch_size"], 3, D, **kw)
            self.pos_embed = nn.Parameter(trunc_normal((1, n2d + 1, D), 0.02, generator)
                                          .to(device))
            self.head = dense(D, 1000, **kw)

    @classmethod
    def from_config(cls, cfg, task: str, **kw):
        return cls(variant=cfg.model.name, task=task, num_point=cfg.num_point,
                   num_class=cfg.num_class, input_dim=cfg.input_dim,
                   nneighbor=cfg.model.nneighbor,
                   transformer_backbone=cfg.model.transformer_backbone,
                   head=cfg.model.get("head", "default"), **kw)

    def forward_features(self, x: torch.Tensor,
                         sample_generator: torch.Generator | None = None) -> torch.Tensor:
        xyz = x[..., :3]
        f = self.fc1(x) + self.fc_pos_embed(xyz)
        levels = [(xyz, f)]
        for td in self.transition_downs:
            levels.append(td(*levels[-1], sample_generator))
        tokens = levels[-1][1]
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        h = self.encode(torch.cat([cls, tokens], dim=1).contiguous())[:, 1:]
        for i, tu in enumerate(self.transition_ups):
            coarse_xyz = levels[-1 - i][0]
            fine_xyz, fine_f = levels[-2 - i]
            h = tu(coarse_xyz, h, fine_xyz, fine_f)
        return h  # [B, N, stem] ([B, N, D] for 0_layer)

    def forward_images(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] normalised images -> [B, 1000] logits of the 2D head."""
        if not self.spec["images"]:
            raise ValueError(f"{self.variant} has no 2D image pathway")
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(tokens.dtype)
        return self.head(self.encode(tokens.contiguous())[:, 0])

    def forward(self, x: torch.Tensor,
                sample_generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.forward_features(x, sample_generator)
        if self.task == "cls":
            h = h.mean(1)
        return getattr(self, self.head_name)(h)


# LwF variants freeze the 2D head and patch embed only (1_layer/model.py:283-289).
FROZEN_2D_PREFIXES_POINT = ("head", "patch_embed")


def frozen_mask_point(model: "PointViT", pretrained: bool) -> dict[str, bool]:
    """Parameter name -> trainable: with 2D-pretrained weights the 2D head and
    patch embedding are frozen. The plain variant's point head, also named
    ``head``, stays trainable, as its JAX name ``new_head`` does."""
    frozen = set(FROZEN_2D_PREFIXES_POINT) - {model.head_name}
    return {name: not (pretrained and name.split(".")[0] in frozen)
            for name, _ in model.named_parameters()}
