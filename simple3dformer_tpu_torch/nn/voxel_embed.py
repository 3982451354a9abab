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
"""

from __future__ import annotations

import torch
from torch import nn

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


# VALID_EMBED_LAYER of the reference (its train_cls_voxel.py:46-53):
# name -> (class, default cell, default patch)
EMBED_LAYERS = {
    "VoxelEmbed": (VoxelEmbed, 16, 8),
    "VoxelEmbed_no_zdim": (VoxelNaiveProjection, 16, 8),
    "VoxelEmbed_no_average": (VoxelEmbedNoAverage, 16, 8),
    "VoxelEmbed_14": (VoxelEmbed, 9, 14),
    "VoxelEmbed_no_average_14": (VoxelEmbedNoAverage, 9, 14),
    "VoxelEmbed_no_zdim_14": (VoxelNaiveProjection, 9, 14),
}


def make_embed_layer(name: str, voxel_size: int, cell_size: int | None = None,
                     patch_size: int | None = None, embed_dim: int = 768,
                     generator=None, device=None, dtype: torch.dtype | None = None) -> nn.Module:
    if name == "VoxelEmbed_Hybrid":
        raise NotImplementedError(
            "VoxelEmbed_Hybrid (VoxNet conv stack) is not ported yet: it comes "
            "with the slice of the other voxel routes")
    if name not in EMBED_LAYERS:
        raise ValueError(f"Unknown type of 3D data embedding: {name}")
    cls, d_cell, d_patch = EMBED_LAYERS[name]
    return cls(voxel_size=voxel_size,
               cell_size=cell_size if cell_size is not None else d_cell,
               patch_size=patch_size if patch_size is not None else d_patch,
               embed_dim=embed_dim, generator=generator, device=device, dtype=dtype)
