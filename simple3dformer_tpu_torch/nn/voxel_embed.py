"""3D voxel tokenizers (port of simple3dformer_tpu/nn/voxel_embed.py).

Input layout is the JAX package's: channels-last occupancy [B, X, Y, Z]
(float). Every tokenizer whose conv has kernel == stride runs as
patchify-reshape plus one ``torch.matmul`` with the conv weight, the same
contraction as the strided conv. ``nn.Conv3d`` would go to cuDNN, which runs
f32 convolutions in TF32 by default; the matmul stays in full f32. The conv
modules only hold the parameters, in the reference's layout
(``proj.conv3d_1.weight`` [D, 1, c, c, c], ``proj.conv2d_1.weight``
[D, 1, c, c]). A grid not divisible by the cell is trimmed as a stride-cell
conv would trim it. With ``dtype=torch.bfloat16`` the projection computes
as the JAX tokenizers' (cells, weight and bias cast to bf16, the product and
the bias added in bf16); the parameters stay f32.

``VoxelEmbedHybrid`` (VoxNet's conv stack) runs its convolutions as unfold
and ``torch.matmul`` in the input's dtype, f32 at every compute dtype, as the
JAX tokenizer takes no ``dtype`` cast.
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.image_augment import weight_matrix
from .layers import trunc_normal


def _patchify3d(x: torch.Tensor, cell: int) -> tuple[torch.Tensor, int]:
    """[B, X, Y, Z] -> ([B, p, p, p, cell^3], p), cell order (cx, cy, cz)."""
    b = x.shape[0]
    p = x.shape[1] // cell
    x = x[:, : p * cell, : p * cell, : p * cell]
    x = x.reshape(b, p, cell, p, cell, p, cell).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(b, p, p, p, cell ** 3), p


def _proj(name: str, conv: type, in_chans: int, embed_dim: int, cell: int,
          generator, device) -> nn.ModuleDict:
    layer = conv(in_chans, embed_dim, cell, cell, device=device)
    with torch.no_grad():
        layer.weight.copy_(trunc_normal(layer.weight.shape, 0.02, generator))
        layer.bias.zero_()
    return nn.ModuleDict({name: layer})


class _CellEmbed(nn.Module):
    """Shared state of the tokenizers: sizes and the conv's parameters."""

    conv_name = "conv3d_1"
    conv_type = nn.Conv3d

    def __init__(self, voxel_size: int = 128, cell_size: int = 16, patch_size: int = 8,
                 in_chans: int = 1, embed_dim: int = 768, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.voxel_size = voxel_size
        self.cell_size = cell_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.compute_dtype = dtype
        self.proj = _proj(self.conv_name, self.conv_type, in_chans, embed_dim,
                          cell_size, generator, device)

    def _check(self, x: torch.Tensor) -> None:
        if x.ndim != 4 or x.shape[1] != self.voxel_size:
            raise ValueError(f"input voxel grid {tuple(x.shape[1:])} != model "
                             f"{self.voxel_size}^3")

    def _project(self, cells: torch.Tensor) -> torch.Tensor:
        conv = self.proj[self.conv_name]
        dt = self.compute_dtype or conv.weight.dtype
        w = conv.weight.reshape(conv.weight.shape[0], -1).to(dt)  # [D, cells]
        return torch.matmul(cells.to(dt), w.t()) + conv.bias.to(dt)


class VoxelEmbed(_CellEmbed):
    """Conv3d(k=s=cell), then the mean over the z patch axis -> [B, p, p, D]."""

    @property
    def num_patches(self) -> int:
        return self.patch_size ** 2

    def forward(self, x):
        self._check(x)
        patches, _ = _patchify3d(x, self.cell_size)
        return self._project(patches).mean(dim=3)


class VoxelEmbedNoAverage(_CellEmbed):
    """Conv3d(k=s=cell), z kept -> [B, p, p, p, D] (p^3 tokens)."""

    @property
    def num_patches(self) -> int:
        return self.patch_size ** 3

    def forward(self, x):
        self._check(x)
        patches, _ = _patchify3d(x, self.cell_size)
        return self._project(patches)


class VoxelNaiveProjection(_CellEmbed):
    """clamp(sum_z(x), 0, 1), then Conv2d(k=s=cell) -> [B, p, p, D]."""

    conv_name = "conv2d_1"
    conv_type = nn.Conv2d

    @property
    def num_patches(self) -> int:
        return self.patch_size ** 2

    def forward(self, x):
        self._check(x)
        img = x.sum(dim=3).clamp(0.0, 1.0)  # [B, X, Y]
        b, c = img.shape[0], self.cell_size
        p = img.shape[1] // c
        img = img[:, : p * c, : p * c].reshape(b, p, c, p, c)
        return self._project(img.permute(0, 1, 3, 2, 4).reshape(b, p, p, c * c))


def _conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            stride: int = 1) -> torch.Tensor:
    """VALID 3D convolution of channels-last x [B, X, Y, Z, C] with a Conv3d
    weight [O, C, k, k, k]: the windows unfolded to [.., C k k k] and one
    ``torch.matmul`` in x's dtype (no cuDNN, so no TF32)."""
    k = weight.shape[-1]
    cols = x.unfold(1, k, stride).unfold(2, k, stride).unfold(3, k, stride)
    cols = cols.reshape(*cols.shape[:4], -1)  # window order (C, kx, ky, kz)
    return torch.matmul(cols, weight.reshape(weight.shape[0], -1).t()) + bias


def _lecun_conv(out_ch: int, in_ch: int, k: int, generator, device) -> nn.Conv3d:
    """nn.Conv3d holding flax's lecun_normal kernel (truncated normal, variance
    1 / (in k^3)) and a zero bias."""
    conv = nn.Conv3d(in_ch, out_ch, k, device=device)
    std = (1.0 / (in_ch * k ** 3)) ** 0.5 / 0.87962566103423978  # flax's truncation factor
    with torch.no_grad():
        conv.weight.copy_(trunc_normal(conv.weight.shape, std, generator))
        conv.bias.zero_()
    return conv


class VoxelEmbedHybrid(nn.Module):
    """VoxNet-style conv stack, then a projection; z kept -> [B, q, q, q, D].

    128^3 grids are first resized to 32^3 as ``jax.image.resize(...,
    "trilinear")`` resizes them (antialiased: a triangle kernel four voxels
    wide, not ``F.interpolate``): one [32, 128] weight matrix, built once and
    applied along each axis in turn. Then conv 5^3 stride 2 -> ReLU -> conv
    3^3 -> ReLU -> 2^3 max-pool -> conv patch^3 stride patch: 6^3 = 216
    tokens from 32^3 at patch 1, the count ``num_patches`` declares, as in
    the JAX module. Its two dropouts are never live (VoxelViT calls the
    tokenizer in deterministic mode), so they are left out. Parameters in
    Conv3d layout: ``conv1``, ``conv2``, ``proj``.
    """

    def __init__(self, voxel_size: int = 128, patch_size: int = 1, embed_dim: int = 768,
                 generator=None, device=None):
        super().__init__()
        self.voxel_size = voxel_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.conv1 = _lecun_conv(32, 1, 5, generator, device)
        self.conv2 = _lecun_conv(32, 32, 3, generator, device)
        self.proj = _lecun_conv(embed_dim, 32, patch_size, generator, device)
        if voxel_size == 128:
            w = weight_matrix(128, 32, torch.tensor([0.25]), torch.tensor([0.0]))[0]
            self.register_buffer("resize", w.to(device), persistent=False)  # [32, 128]
        else:
            self.resize = None

    @property
    def num_patches(self) -> int:
        return 6 ** 3  # 32^3 -> conv5s2: 14 -> conv3: 12 -> pool2: 6

    def forward(self, x):
        if x.ndim != 4 or x.shape[1] != self.voxel_size:
            raise ValueError(f"input voxel grid {tuple(x.shape[1:])} != model "
                             f"{self.voxel_size}^3")
        if self.resize is not None:  # the separable resize, x then y then z
            w = self.resize.to(x.dtype)
            x = torch.einsum("bxyz,ix->biyz", x, w)
            x = torch.einsum("biyz,jy->bijz", x, w)
            x = torch.matmul(x, w.t())
        x = torch.relu(_conv3d(x[..., None], self.conv1.weight, self.conv1.bias, 2))
        x = torch.relu(_conv3d(x, self.conv2.weight, self.conv2.bias))
        b, g, c = x.shape[0], x.shape[1] // 2, x.shape[-1]
        x = x[:, : 2 * g, : 2 * g, : 2 * g].reshape(b, g, 2, g, 2, g, 2, c).amax((2, 4, 6))
        return _conv3d(x, self.proj.weight, self.proj.bias, self.patch_size)


# VALID_EMBED_LAYER of the reference (its train_cls_voxel.py:46-53):
# name -> (class, default cell, default patch)
EMBED_LAYERS = {
    "VoxelEmbed": (VoxelEmbed, 16, 8),
    "VoxelEmbed_no_zdim": (VoxelNaiveProjection, 16, 8),
    "VoxelEmbed_no_average": (VoxelEmbedNoAverage, 16, 8),
    "VoxelEmbed_14": (VoxelEmbed, 9, 14),
    "VoxelEmbed_no_average_14": (VoxelEmbedNoAverage, 9, 14),
    "VoxelEmbed_no_zdim_14": (VoxelNaiveProjection, 9, 14),
    "VoxelEmbed_Hybrid": (VoxelEmbedHybrid, None, 1),
}


def make_embed_layer(name: str, voxel_size: int, cell_size: int | None = None,
                     patch_size: int | None = None, embed_dim: int = 768,
                     generator=None, device=None, dtype: torch.dtype | None = None) -> nn.Module:
    if name not in EMBED_LAYERS:
        raise ValueError(f"Unknown type of 3D data embedding: {name}")
    cls, d_cell, d_patch = EMBED_LAYERS[name]
    if cls is VoxelEmbedHybrid:  # no cell, and no compute dtype (see the class)
        return cls(voxel_size=voxel_size,
                   patch_size=patch_size if patch_size is not None else d_patch,
                   embed_dim=embed_dim, generator=generator, device=device)
    return cls(voxel_size=voxel_size,
               cell_size=cell_size if cell_size is not None else d_cell,
               patch_size=patch_size if patch_size is not None else d_patch,
               embed_dim=embed_dim, generator=generator, device=device, dtype=dtype)
