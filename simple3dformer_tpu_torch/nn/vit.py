"""DeiT/ViT backbone tables, the block stack and the 2D patch embedding
(port of simple3dformer_tpu/nn/vit.py).

``BACKBONES`` keeps the reference's quirk that the 3D models build deit_base
with num_heads=3 (the reference's models/vit_3d_2d_pretrain.py:298-306);
``TEACHER_BACKBONES`` has the true DeiT head counts for the LwF teacher.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Block, LayerNorm, trunc_normal

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

EMBED_DIM = {name: cfg["embed_dim"] for name, cfg in BACKBONES.items()}


class ViTCore(nn.Module):
    """The block stack and the final LayerNorm (eps 1e-6): timm's ``blocks``
    and ``norm``.

    Models derive from it, so the parameters keep timm's top-level names
    (``blocks.0.attn.qkv.weight``, ``norm.weight``) and a timm or reference
    state dict loads as it is. The blocks are unrolled; the JAX package's
    ``scan_blocks`` only shrinks XLA programs. ``dtype`` is every block's
    compute dtype; the final norm returns f32, as flax's LayerNorm does.
    """

    def __init__(self, dim: int, depth: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio, qkv_bias, drop, attn_drop, drop_path,
                  generator=generator, device=device, dtype=dtype)
            for _ in range(depth))
        self.norm = LayerNorm(dim, eps=1e-6, device=device)

    def encode(self, x, seg_len: int | None = None):
        """[B, N, D] tokens through every block, then the final norm."""
        for blk in self.blocks:
            x = blk(x, seg_len=seg_len)
        return self.norm(x)


class PatchEmbed2D(nn.Module):
    """The 2D pathway's 16x16 patch embedding, ``proj`` in timm's Conv2d
    layout [D, 3, P, P].

    It holds the parameters so that state dicts are complete; the image
    forward (``forward_images``, LwF) is not ported yet.
    """

    def __init__(self, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 generator=None, device=None):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size, device=device)
        with torch.no_grad():
            self.proj.weight.copy_(trunc_normal(self.proj.weight.shape, 0.02, generator))
            self.proj.bias.zero_()
