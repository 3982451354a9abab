"""Voxel ViT (port of simple3dformer_tpu/models/voxel_vit.py, Feature3D_ViT2D_V2).

A DeiT backbone whose patch embedding is swapped for a 3D voxel tokenizer,
with a new 3D head (Linear or AMSoftmax), and the 2D pathway the LwF trainer
runs images through (``forward_images``). Parameter names are the
reference's state-dict names (``cls_token``, ``blocks.{i}...``, ``norm``,
``voxel_embed.proj.conv3d_1``, ``voxel_pos_embed``, ``voxel_head``, the
group route's ``group_embed.self_attn.in_proj_weight`` etc. (torch's
TransformerEncoderLayer), ``group_pos_embed`` and ``group_cls_token``, and the
2D pathway's ``patch_embed``, ``pos_embed`` and ``head``), so a reference or
JAX-converted state dict loads with a plain ``load_state_dict``.

``dtype=torch.bfloat16`` is the JAX model's compute dtype: the tokenizer,
every block's Linears and the heads compute in bf16, the parameters stay f32;
the tokens, the cls token and the positional embedding are bf16, so the
blocks' residual stream is bf16 (the fused kernels take bf16 x), the final
LayerNorm returns f32 and the head bf16 logits.

Every route of the JAX module is ported: ``default``, ``no_embed``,
``group_embed`` (stage 1 over each z-pillar with the post-norm encoder
``group_embed``, then the core again over the pillar grid; ``group_axes``
"pillar" or the reference's "reference_bug") and ``weight_sharing`` (the
z-slices folded into the batch, one core pass, the mean of the cls tokens).
The JAX package's ``batch_pack`` and ``group_pack`` are absent: packing
several sequences per attention row only fills the TPU's matrix tiles and
leaves the math unchanged, and the port's CUDA block kernel attends per
sequence, so the stage-1 pillars [B px py, pz + 1, D] reach the fused
kernels as they are.

At ``dtype=torch.bfloat16`` the group encoder's Linears and softmax compute in
bf16 and its two LayerNorms return f32, as flax's do, so the stage-1 core
takes an f32 residual stream with bf16 matmuls; the core's final norm returns
f32, so stage 2 does too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import rng
from ..core.rng import DeviceGenerators
from ..parallel.mesh import current_split
from ..nn.layers import AMSoftmaxLayer, LayerNorm, dense, linear, softmax_last, trunc_normal
from ..nn.vit import BACKBONES, PatchEmbed2D, ViTCore


class _SelfAttn(nn.Module):
    """The parameters of torch.nn.MultiheadAttention: ``in_proj_weight`` [3C, C]
    (rows q, k, v, each [heads, head_dim]), ``in_proj_bias``, ``out_proj``."""

    def __init__(self, dim: int, generator=None, device=None, dtype=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(trunc_normal((3 * dim, dim), 0.02, generator)
                                           .to(device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
        self.out_proj = dense(dim, dim, generator=generator, device=device, dtype=dtype)


class PostNormEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer as the JAX module computes it: post-LN,
    a ReLU feed-forward of width ``dim``, ``num_heads`` heads, dropout at four
    places (the probabilities, the attention output, the hidden layer, the
    feed-forward output). Parameter names are TransformerEncoderLayer's.

    Attention is plain PyTorch on every device, as it is XLA in the JAX
    package. LayerNorm eps is flax's 1e-6 (not TransformerEncoderLayer's
    1e-5), and both norms return f32 from a bf16 input. Dropout is flax's
    (keep with probability 1 - p, kept values divided by 1 - p), live in
    train mode; its masks are drawn on the input's device from a generator
    seeded with ``dropout_seed`` on first use there.
    """

    def __init__(self, dim: int, num_heads: int = 4, dropout: float = 0.1,
                 dropout_seed: int = 0, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.compute_dtype = dtype
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.self_attn = _SelfAttn(dim, **kw)
        self.linear1 = dense(dim, dim, **kw)
        self.linear2 = dense(dim, dim, **kw)
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.generators = DeviceGenerators(dropout_seed)

    def drop(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.dropout == 0.0:
            return x
        keep = 1.0 - self.dropout
        # rows [B * groups] batch-major: this rank's samples' rows of the global draw
        mask = rng.rand(x.shape, self.generators(x.device)) < keep
        return torch.where(mask, x / keep, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, C] -> [B, N, C]; attention over N."""
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = linear(x, self.self_attn.in_proj_weight, self.self_attn.in_proj_bias,
                     self.compute_dtype)
        q, k, v = qkv.reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)  # [B, H, N, hd]
        probs = self.drop(softmax_last((q * hd ** -0.5) @ k.transpose(-1, -2)))
        out = (probs @ v).transpose(1, 2).reshape(b, n, c)
        x = self.norm1(x + self.drop(self.self_attn.out_proj(out)))
        hid = self.linear2(self.drop(F.relu(self.linear1(x))))
        return self.norm2(x + self.drop(hid))


class VoxelViT(ViTCore):
    """DeiT backbone + 3D voxel tokenizer + 3D head (+ the 2D pathway).

    x: [B, V, V, V] float occupancy -> [B, n_classes] logits. ``group_axes``
    and ``dropout_seed`` (the seed of the group encoder's dropout masks)
    concern the group_embed route; ``group_embed.dropout = 0.0`` turns that
    dropout off, as the JAX model's ``deterministic=True`` does.
    """

    def __init__(self, voxel_embed: nn.Module, n_classes: int = 10,
                 transformer_backbone: str = "deit_base_patch16_224",
                 pos_embedding: str | None = "default", head: str = "default",
                 img_size: int = 224, group_axes: str = "pillar", dropout_seed: int = 0,
                 generator: torch.Generator | None = None, device=None,
                 dtype: torch.dtype | None = None):
        cfg = BACKBONES[transformer_backbone]
        d = cfg["embed_dim"]
        super().__init__(d, cfg["depth"], cfg["num_heads"], cfg["mlp_ratio"],
                         cfg["qkv_bias"], generator=generator, device=device, dtype=dtype)
        mode = pos_embedding or "default"
        if mode not in ("default", "no_embed", "group_embed", "weight_sharing"):
            raise ValueError("Unknown positional embedding scheme!")
        if group_axes not in ("pillar", "reference_bug"):
            raise ValueError("group_axes must be 'pillar' or 'reference_bug'")
        self.mode = mode
        self.group_axes = group_axes
        self.cls_token = nn.Parameter(trunc_normal((1, 1, d), 0.02, generator).to(device))

        # the 2D pathway (forward_images: LwF's image logits)
        n2d = (img_size // cfg["patch_size"]) ** 2
        self.patch_embed = PatchEmbed2D(cfg["patch_size"], 3, d, generator=generator,
                                        device=device, dtype=dtype)
        self.pos_embed = nn.Parameter(trunc_normal((1, n2d + 1, d), 0.02, generator).to(device))
        self.head = dense(d, 1000, generator=generator, device=device, dtype=dtype)

        self.voxel_embed = voxel_embed
        if head == "AMSoftmax":
            self.voxel_head = AMSoftmaxLayer(d, n_classes, generator=generator, device=device)
        else:
            self.voxel_head = dense(d, n_classes, generator=generator, device=device,
                                    dtype=dtype)
        # starts at zero and trains; no_embed keeps it at zero and never reads
        # it (reference intent, see the JAX module). group_embed and
        # weight_sharing place it on the (px, py) grid.
        p = voxel_embed.patch_size
        n3d = voxel_embed.num_patches if mode in ("default", "no_embed") else p ** 2
        self.voxel_pos_embed = nn.Parameter(torch.zeros(1, n3d + 1, d, device=device),
                                            requires_grad=mode != "no_embed")
        if mode == "group_embed":
            self.group_embed = PostNormEncoderLayer(d, dropout_seed=dropout_seed,
                                                    generator=generator, device=device,
                                                    dtype=dtype)
            # trunc_normal(0.02) in pillar mode: with the reference's zeros an
            # empty pillar stays exactly zero and every LayerNorm backward at
            # its zero-variance rows multiplies the gradient by ~3.3e3 a block
            # (see the JAX module); reference_bug keeps the reference's zeros
            def group_param(shape):
                if group_axes == "reference_bug":
                    return nn.Parameter(torch.zeros(shape, device=device))
                return nn.Parameter(trunc_normal(shape, 0.02, generator).to(device))

            self.group_pos_embed = group_param((1, p + 1, d))
            self.group_cls_token = group_param((1, 1, d))

    def _with_cls(self, tokens: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        """[n, S, D] -> [n, S + 1, D], ``cls`` [1, 1, D] first, in the tokens' dtype."""
        cls = cls.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        return torch.cat([cls, tokens], dim=1)

    def _add_pos(self, tokens: torch.Tensor, pos: torch.Tensor, name: str) -> torch.Tensor:
        if tokens.shape[1:] != pos.shape[1:]:
            raise ValueError(f"{tokens.shape[1]} tokens of width {tokens.shape[2]} (cls "
                             f"included) against {name} {tuple(pos.shape)}: the tokenizer's "
                             f"grid does not fit the model's position embedding")
        return tokens + pos.to(tokens.dtype)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, V, V, V] occupancy -> pooled cls feature [B, D]."""
        tok = self.voxel_embed(x)  # [B, p, p, D] or [B, p, p, p, D]
        if self.mode in ("default", "no_embed"):
            tok = self._with_cls(tok.reshape(tok.shape[0], -1, tok.shape[-1]), self.cls_token)
            if self.mode == "default":
                tok = self._add_pos(tok, self.voxel_pos_embed, "voxel_pos_embed")
            return self.encode(tok.contiguous())[:, 0]
        if tok.ndim != 5:
            raise ValueError(f"pos_embedding={self.mode!r} needs a tokenizer that keeps z "
                             f"([B, px, py, pz, D]), got {tuple(tok.shape)}")
        b, px, py, pz, d = tok.shape
        if self.mode == "weight_sharing":  # one core pass over the z-slices, cls averaged
            slices = tok.permute(0, 3, 1, 2, 4).reshape(b * pz, px * py, d)
            slices = self._add_pos(self._with_cls(slices, self.cls_token),
                                   self.voxel_pos_embed, "voxel_pos_embed")
            return self.encode(slices.contiguous())[:, 0].reshape(b, pz, d).mean(1)
        # group_embed stage 1: each (px, py) pillar a sequence over z, its own cls
        pillars = self._with_cls(tok.reshape(b * px * py, pz, d), self.group_cls_token)
        pillars = self._add_pos(pillars, self.group_pos_embed, "group_pos_embed")
        if self.group_axes == "reference_bug":
            if current_split()[0] > 1:
                raise NotImplementedError("group_axes='reference_bug' attends across the batch: "
                                          "it cannot be split over ranks")
            # the reference's batch-first tensor in a seq-first encoder: attention
            # over the pillars at each z slot (LN and the feed-forward are per token)
            pillars = self.group_embed(pillars.transpose(0, 1)).transpose(0, 1)
        else:
            pillars = self.group_embed(pillars)
        feat = self.encode(pillars.contiguous())[:, 0].reshape(b, px * py, d)
        # stage 2: the core again over the pillar grid
        tok2 = self._add_pos(self._with_cls(feat, self.cls_token), self.voxel_pos_embed,
                             "voxel_pos_embed")
        return self.encode(tok2.contiguous())[:, 0]

    def forward_images(self, x: torch.Tensor) -> torch.Tensor:
        """The 2D pathway (the reference's vit_3d_2d_pretrain.py:435-451): [B, H, W, 3]
        normalised images -> [B, 1000] logits, the shared cls token prepended."""
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(tokens.dtype)
        return self.head(self.encode(tokens.contiguous())[:, 0])

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
