"""DeiT/ViT backbone tables, the block stack, the 2D patch embedding and the
2D DeiT classifier (port of simple3dformer_tpu/nn/vit.py).

``BACKBONES`` keeps the reference's quirk that the 3D models build deit_base
with num_heads=3 (the reference's models/vit_3d_2d_pretrain.py:298-306);
``TEACHER_BACKBONES`` has the true DeiT head counts for the LwF teacher
(``make_teacher``), and ``DEIT_FACTORY`` the reference's eight 2D DeiT models
(``deit_factory``). Images are channels-last [B, H, W, 3], as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Block, LayerNorm, dense, linear, trunc_normal

BACKBONES = {
    "deit_tiny_patch16_224": dict(patch_size=16, embed_dim=192, depth=12, num_heads=3, mlp_ratio=4.0, qkv_bias=True),
    "deit_small_patch16_224": dict(patch_size=16, embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0, qkv_bias=True),
    "deit_base_patch16_224": dict(patch_size=16, embed_dim=768, depth=12, num_heads=3, mlp_ratio=4.0, qkv_bias=True),
    "deit_base_distilled_patch16_224": dict(patch_size=16, embed_dim=768, depth=12, num_heads=3, mlp_ratio=4.0, qkv_bias=True),
    "vit_base_patch16_224_21k": dict(patch_size=16, embed_dim=768, depth=12, num_heads=3, mlp_ratio=4.0, qkv_bias=True),
    "vit_large_patch16_224": dict(patch_size=16, embed_dim=768, depth=12, num_heads=3, mlp_ratio=4.0, qkv_bias=True),
}

TEACHER_BACKBONES = {
    "deit_tiny_patch16_224": dict(patch_size=16, embed_dim=192, depth=12, num_heads=3, mlp_ratio=4.0, qkv_bias=True),
    "deit_small_patch16_224": dict(patch_size=16, embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0, qkv_bias=True),
    "deit_base_patch16_224": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0, qkv_bias=True),
}

# the reference's complete 2D factory (its models/DeIT.py:67-186): {tiny, small,
# base} x {plain, distilled} at 224 px and base {plain, distilled} at 384 px,
# with the true head counts
DEIT_FACTORY = {
    "deit_tiny_patch16_224": dict(embed_dim=192, num_heads=3, img_size=224, distilled=False),
    "deit_small_patch16_224": dict(embed_dim=384, num_heads=6, img_size=224, distilled=False),
    "deit_base_patch16_224": dict(embed_dim=768, num_heads=12, img_size=224, distilled=False),
    "deit_tiny_distilled_patch16_224": dict(embed_dim=192, num_heads=3, img_size=224, distilled=True),
    "deit_small_distilled_patch16_224": dict(embed_dim=384, num_heads=6, img_size=224, distilled=True),
    "deit_base_distilled_patch16_224": dict(embed_dim=768, num_heads=12, img_size=224, distilled=True),
    "deit_base_patch16_384": dict(embed_dim=768, num_heads=12, img_size=384, distilled=False),
    "deit_base_distilled_patch16_384": dict(embed_dim=768, num_heads=12, img_size=384, distilled=True),
}

EMBED_DIM = {name: cfg["embed_dim"] for name, cfg in BACKBONES.items()}


class ViTCore(nn.Module):
    """The block stack and the final LayerNorm (eps 1e-6): timm's ``blocks``
    and ``norm``.

    Models derive from it, so the parameters keep timm's top-level names
    (``blocks.0.attn.qkv.weight``, ``norm.weight``) and a timm or reference
    state dict loads as it is. The blocks are unrolled; the JAX package's
    ``scan_blocks`` only shrinks XLA programs. ``dtype`` is every block's
    compute dtype; the final norm returns f32, as flax's LayerNorm does.
    Block i draws its drop-path masks from seed i, so no two blocks drop the
    same samples.
    """

    def __init__(self, dim: int, depth: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio, qkv_bias, drop, attn_drop, drop_path,
                  drop_path_seed=i, generator=generator, device=device, dtype=dtype)
            for i in range(depth))
        self.norm = LayerNorm(dim, eps=1e-6, device=device)

    def encode(self, x, seg_len: int | None = None):
        """[B, N, D] tokens through every block, then the final norm."""
        for blk in self.blocks:
            x = blk(x, seg_len=seg_len)
        return self.norm(x)


class PatchEmbed2D(nn.Module):
    """The 2D pathway's 16x16 patch embedding, ``proj`` in timm's Conv2d
    layout [D, 3, P, P].

    [B, H, W, 3] channels-last images -> [B, (H/P)(W/P), D] tokens in row-major
    order over the patch grid (torch's flatten(2).transpose(1, 2)). As in the
    JAX package the stride-P convolution is patchify and one product with the
    weight laid out as a Linear over (row, column, channel) of a patch, in the
    compute dtype ``dtype`` (flax ``Dense(dtype=...)``'s casts).
    """

    def __init__(self, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size, device=device)
        with torch.no_grad():
            self.proj.weight.copy_(trunc_normal(self.proj.weight.shape, 0.02, generator))
            self.proj.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, p * p * c)
        return linear(x, weight, self.proj.bias, self.compute_dtype)


class ViT2D(ViTCore):
    """The 2D DeiT classifier: the LwF teacher and the reference's 2D factory.

    timm's VisionTransformer forward as the reference uses it: patch embedding,
    the cls token (and the distillation token) prepended, the position
    embedding added, the blocks and the final norm, the head on token 0. A
    distilled model returns the mean of ``head`` on token 0 and ``head_dist`` on
    token 1 (DeiT's inference mode). Parameter names are timm's, so a DeiT
    state dict loads as it is (utils/torch_convert.maybe_load_deit).
    ``dtype`` is the compute dtype of the patch embedding, every block and the
    heads (the JAX ViT2D's ``dtype``): at bf16 the tokens are bf16 from the
    patch embedding on, and the final norm returns f32.
    """

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, patch_size: int = 16,
                 num_classes: int = 1000, img_size: int = 224, distilled: bool = False,
                 generator: torch.Generator | None = None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__(embed_dim, depth, num_heads, mlp_ratio, qkv_bias, generator=generator,
                         device=device, dtype=dtype)
        self.distilled = distilled
        n_tokens = (img_size // patch_size) ** 2 + (2 if distilled else 1)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.patch_embed = PatchEmbed2D(patch_size, 3, embed_dim, **kw)
        self.cls_token = nn.Parameter(trunc_normal((1, 1, embed_dim), 0.02, generator).to(device))
        if distilled:
            self.dist_token = nn.Parameter(trunc_normal((1, 1, embed_dim), 0.02, generator)
                                           .to(device))
            self.head_dist = dense(embed_dim, num_classes, **kw)
        self.pos_embed = nn.Parameter(trunc_normal((1, n_tokens, embed_dim), 0.02, generator)
                                      .to(device))
        self.head = dense(embed_dim, num_classes, **kw)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] images -> the final norm's tokens [B, 1 (+1) + patches, D]."""
        tokens = self.patch_embed(x)
        extra = [self.cls_token] + ([self.dist_token] if self.distilled else [])
        extra = [t.to(tokens.dtype).expand(tokens.shape[0], -1, -1) for t in extra]
        tokens = torch.cat([*extra, tokens], dim=1) + self.pos_embed.to(tokens.dtype)
        return self.encode(tokens.contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.forward_features(x)
        if self.distilled:
            return (self.head(feats[:, 0]) + self.head_dist(feats[:, 1])) / 2.0
        return self.head(feats[:, 0])


def deit_factory(name: str, num_classes: int = 1000, generator: torch.Generator | None = None,
                 device=None) -> ViT2D:
    """Any of the reference's eight DeiT models (its models/DeIT.py:67-186)."""
    cfg = DEIT_FACTORY[name]
    return ViT2D(cfg["embed_dim"], 12, cfg["num_heads"], num_classes=num_classes,
                 img_size=cfg["img_size"], distilled=cfg["distilled"], generator=generator,
                 device=device)


def make_teacher(backbone: str = "deit_base_patch16_224",
                 generator: torch.Generator | None = None, device=None) -> ViT2D:
    """The LwF teacher: the 2D DeiT of ``backbone`` with its true head count
    (the reference's train_cls_voxel.py:180), in f32. The caller freezes it."""
    cfg = TEACHER_BACKBONES[backbone]
    return ViT2D(cfg["embed_dim"], cfg["depth"], cfg["num_heads"], cfg["mlp_ratio"],
                 cfg["qkv_bias"], cfg["patch_size"], generator=generator, device=device)
