"""Voxel ViT (port of simple3dformer_tpu/models/voxel_vit.py, Feature3D_ViT2D_V2).

A DeiT backbone whose patch embedding is swapped for a 3D voxel tokenizer,
with a new 3D head (Linear or AMSoftmax). Parameter names are the
reference's state-dict names (``cls_token``, ``blocks.{i}...``, ``norm``,
``voxel_embed.proj.conv3d_1``, ``voxel_pos_embed``, ``voxel_head``, and the
2D pathway's ``patch_embed``, ``pos_embed`` and ``head``), so a reference or
JAX-converted state dict loads with a plain ``load_state_dict``.

``dtype=torch.bfloat16`` is the JAX model's compute dtype: the tokenizer,
every block's Linears and the heads compute in bf16, the parameters stay f32;
the tokens, the cls token and the positional embedding are bf16, so the
blocks' residual stream is bf16 (the fused kernels take bf16 x), the final
LayerNorm returns f32 and the head bf16 logits.

Ported routes: ``default`` and ``no_embed``. The JAX package's
``batch_pack`` is absent: packing several samples per attention row only
fills the TPU's matrix tiles and leaves the math unchanged, and the port's
CUDA block kernel attends per sample.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import AMSoftmaxLayer, dense, trunc_normal
from ..nn.vit import BACKBONES, PatchEmbed2D, ViTCore


class VoxelViT(ViTCore):
    """DeiT backbone + 3D voxel tokenizer + 3D head (+ the 2D pathway's parameters).

    x: [B, V, V, V] float occupancy -> [B, n_classes] logits.
    """

    def __init__(self, voxel_embed: nn.Module, n_classes: int = 10,
                 transformer_backbone: str = "deit_base_patch16_224",
                 pos_embedding: str | None = "default", head: str = "default",
                 img_size: int = 224, generator: torch.Generator | None = None,
                 device=None, dtype: torch.dtype | None = None):
        cfg = BACKBONES[transformer_backbone]
        d = cfg["embed_dim"]
        super().__init__(d, cfg["depth"], cfg["num_heads"], cfg["mlp_ratio"],
                         cfg["qkv_bias"], generator=generator, device=device, dtype=dtype)
        mode = pos_embedding or "default"
        if mode in ("group_embed", "weight_sharing"):
            raise NotImplementedError(
                f"pos_embedding={mode!r} is not ported yet: it comes with the "
                "slice of the other voxel routes")
        if mode not in ("default", "no_embed"):
            raise ValueError("Unknown positional embedding scheme!")
        self.mode = mode
        self.cls_token = nn.Parameter(trunc_normal((1, 1, d), 0.02, generator).to(device))

        # the 2D pathway (LwF, forward_images): parameters only, for complete state dicts
        n2d = (img_size // cfg["patch_size"]) ** 2
        self.patch_embed = PatchEmbed2D(cfg["patch_size"], 3, d, generator=generator,
                                        device=device)
        self.pos_embed = nn.Parameter(trunc_normal((1, n2d + 1, d), 0.02, generator).to(device))
        self.head = dense(d, 1000, generator=generator, device=device, dtype=dtype)

        self.voxel_embed = voxel_embed
        if head == "AMSoftmax":
            self.voxel_head = AMSoftmaxLayer(d, n_classes, generator=generator, device=device)
        else:
            self.voxel_head = dense(d, n_classes, generator=generator, device=device,
                                    dtype=dtype)
        # starts at zero and trains on the default route; no_embed keeps it at
        # zero and never reads it (reference intent, see the JAX module)
        self.voxel_pos_embed = nn.Parameter(
            torch.zeros(1, voxel_embed.num_patches + 1, d, device=device),
            requires_grad=mode == "default")

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, V, V, V] occupancy -> pooled cls feature [B, D]."""
        tok = self.voxel_embed(x)  # [B, p, p, D] or [B, p, p, p, D]
        tok = tok.reshape(tok.shape[0], -1, tok.shape[-1])
        cls = self.cls_token.to(tok.dtype).expand(tok.shape[0], -1, -1)
        tok = torch.cat([cls, tok], dim=1)
        if self.mode == "default":
            tok = tok + self.voxel_pos_embed.to(tok.dtype)
        return self.encode(tok.contiguous())[:, 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.voxel_head(self.forward_features(x))


# Parameters frozen when 2D-pretrained weights are loaded (the reference's
# vit_3d_2d_pretrain.py:428-432): the 2D head, 2D pos embed, 2D patch embed.
FROZEN_2D_PREFIXES = ("head", "pos_embed", "patch_embed")


def frozen_mask(model: nn.Module, pretrained: bool) -> dict[str, bool]:
    """Parameter name -> trainable. Mirrors requires_grad=False on the 2D-side
    parameters when the backbone is 2D-pretrained; all trainable otherwise."""
    return {name: not (pretrained and name.split(".")[0] in FROZEN_2D_PREFIXES)
            for name, _ in model.named_parameters()}
