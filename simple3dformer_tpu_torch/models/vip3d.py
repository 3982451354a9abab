"""ViP-3D: Vision Permutator over voxel grids, a 3D MLP-mixer (port of
simple3dformer_tpu/models/vip3d.py).

``WeightedPermuteMLP`` mixes the token grid [B, H, W, Z, C] along H, W and Z
and over C, then weighs the four mixes by a softmax gate; stages of
``PermutatorBlock`` with a ``Downsample`` between them where the grid or the
width changes; with ``pos_embedding="PEG"`` a ``PosCNN`` after block 0 of each
stage; the final LayerNorm, a mean over tokens and the head.

The JAX package computes all of this in XLA, outside any Pallas kernel, so
here it is plain PyTorch: dense products, permutes, LayerNorm, GELU. The
reference's quirks are replayed:

  * each axis mix folds [axis, S] onto one [C, C] product, which needs a cubic
    grid with H == segment_dim (asserted, with the JAX package's message);
  * the h mix is restored with its W and Z axes swapped (the reference's
    permute(0, 4, 2, 3, 1, 5), not the inverse (0, 4, 3, 2, 1, 5));
  * the z mix reuses ``mlp_w``; there is no ``mlp_z`` parameter.

Each mix is the reference's chain (permute, fold, one Linear, unfold,
permute), the same linear map as the JAX package's einsum; autograd gives its
backward. Parameters are named as the reference's state dict:
``patch_embed.proj.conv3d_1``, ``network.{ni}.{bj}.{norm1,attn.mlp_h,...}``,
``network.{ni}.1.proj.0`` for a PEG, ``network.{ni}.proj`` for a downsample,
``norm`` and ``head``.

With ``dtype=torch.bfloat16`` it computes as the JAX model at bf16: every
Linear in bf16 (``nn.layers.linear``), the axis mixes on bf16 operands,
LayerNorm returning f32, the gate's mean and softmax on bf16 values (the mean
summed in f32 and rounded once, as ``jnp.mean``), the residual stream in the
tokenizer's bf16; the parameters stay f32. PEG takes an f32 stream only, as
in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import DropPath, LayerNorm, Mlp, dense, linear, softmax_last, trunc_normal

# layers, transitions, segment_dim, mlp_ratios, embed_dims (the reference's vip_3d.py:269-318)
VIP3D_CONFIGS = {
    "vip3d_s7": dict(layers=[4, 3, 8, 3], transitions=[True, False, False, False],
                     segment_dim=[8, 4, 4, 4], mlp_ratios=[3, 3, 3, 3],
                     embed_dims=[192, 384, 384, 384]),
    "vip3d_s14": dict(layers=[4, 3, 8, 3], transitions=[False, False, False, False],
                      segment_dim=[8, 8, 8, 8], mlp_ratios=[3, 3, 3, 3],
                      embed_dims=[384, 384, 384, 384]),
    "vip3d_m7": dict(layers=[4, 3, 14, 3], transitions=[False, True, False, False],
                     segment_dim=[8, 8, 4, 4], mlp_ratios=[3, 3, 3, 3],
                     embed_dims=[256, 256, 512, 512]),
    "vip3d_l7": dict(layers=[8, 8, 16, 4], transitions=[True, False, False, False],
                     segment_dim=[8, 4, 4, 4], mlp_ratios=[3, 3, 3, 3],
                     embed_dims=[256, 512, 512, 512]),
}


def mean_tokens(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean``: summed in f32, rounded once to a bf16 input's dtype."""
    return x.mean(dim) if x.dtype == torch.float32 else x.float().mean(dim).to(x.dtype)


class WeightedPermuteMLP(nn.Module):
    """The axis mixes and the 4-way softmax gate (the reference's vip_3d.py:43-88)."""

    def __init__(self, dim: int, segment_dim: int = 8, qkv_bias: bool = False,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.segment_dim = segment_dim
        self.compute_dtype = dtype
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.mlp_c = dense(dim, dim, bias=qkv_bias, **kw)
        self.mlp_h = dense(dim, dim, bias=qkv_bias, **kw)
        self.mlp_w = dense(dim, dim, bias=qkv_bias, **kw)
        self.reweight = Mlp(dim, dim // 3, dim * 4, **kw)
        self.proj = dense(dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, z, c = x.shape
        seg = self.segment_dim
        assert h == w == z == seg, (
            f"WeightedPermuteMLP needs a cubic token grid with "
            f"H == W == Z == segment_dim; got grid {h}x{w}x{z}, "
            f"segment_dim {seg} (see models/vip3d.py docstring)")
        s, t = c // seg, c // h
        x6 = x.reshape(b, h, w, z, seg, s)
        # the restore (0, 4, 2, 3, 1, 5) swaps the h mix's W and Z axes, as the reference's
        mh = self.mlp_h(x6.permute(0, 4, 3, 2, 1, 5).reshape(b, seg, z, w, h * s))
        mh = mh.reshape(b, seg, z, w, h, t).permute(0, 4, 2, 3, 1, 5).reshape(b, h, w, z, c)
        mw = self.mlp_w(x6.permute(0, 1, 4, 3, 2, 5).reshape(b, h, seg, z, w * s))
        mw = mw.reshape(b, h, seg, z, w, t).permute(0, 1, 4, 3, 2, 5).reshape(b, h, w, z, c)
        mz = self.mlp_w(x6.permute(0, 2, 1, 4, 3, 5).reshape(b, w, h, seg, z * s))  # mlp_w again
        mz = mz.reshape(b, w, h, seg, z, t).permute(0, 2, 1, 4, 3, 5).reshape(b, h, w, z, c)
        mc = self.mlp_c(x)

        a = mean_tokens((mh + mw + mz + mc).reshape(b, -1, c), 1)  # [B, C]
        # [B, 4C] -> [B, C, 4]: the reference's softmax over its 4 (interleaved) gates
        a = softmax_last(self.reweight(a).reshape(b, c, 4))[:, None, None, None]
        out = mh * a[..., 0] + mw * a[..., 1] + mz * a[..., 2] + mc * a[..., 3]
        return self.proj(out)


class PermutatorBlock(nn.Module):
    """x + drop_path(attn(norm1(x))) / skip_lam, then the same with the MLP."""

    def __init__(self, dim: int, segment_dim: int, mlp_ratio: float = 3.0,
                 qkv_bias: bool = False, drop_path: float = 0.0, skip_lam: float = 1.0,
                 drop_path_seed: int = 0, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.skip_lam = skip_lam
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = WeightedPermuteMLP(dim, segment_dim, qkv_bias, **kw)
        self.drop_path = DropPath(drop_path, seed=drop_path_seed)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x))) / self.skip_lam
        return x + self.drop_path(self.mlp(self.norm2(x))) / self.skip_lam


class Downsample(nn.Module):
    """Conv3d(k = s = patch, no bias) between stages, run as a patchify
    reshape and one product; at patch 1 a Linear. ``proj.weight`` [out, in,
    p, p, p] holds the conv's weight, and the patches are laid out in its
    (C, px, py, pz) order, so the product reads it as a view and its
    gradient comes back contiguous (the Adam kernel takes only such)."""

    def __init__(self, in_dim: int, out_dim: int, patch: int = 2, generator=None,
                 device=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.patch = patch
        self.compute_dtype = dtype
        self.proj = nn.Conv3d(in_dim, out_dim, patch, patch, bias=False, device=device)
        with torch.no_grad():
            self.proj.weight.copy_(trunc_normal((patch ** 3 * in_dim, out_dim), 0.02, generator)
                                   .reshape(patch, patch, patch, in_dim, out_dim)
                                   .permute(4, 3, 0, 1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, _, _, c = x.shape
        p = self.patch
        g = h // p
        x = x.reshape(b, g, p, g, p, g, p, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return linear(x.reshape(b, g, g, g, c * p ** 3), w, None, self.compute_dtype)


class PosCNN(nn.Module):
    """PEG (the reference's vip_3d.py:155-169, from Twins): a depthwise 3x3x3
    conv, SAME padding, plus its bias and the residual. ``proj.0`` holds the
    Conv3d's weight [C, 1, 3, 3, 3] and bias.

    The conv is 27 shifted multiply-adds in f32, never cuDNN (which would
    round f32 to TF32 by default). A bf16 stream is refused, as the JAX
    PosCNN refuses it (``lax.conv_general_dilated`` gets a bf16 input and an
    f32 kernel).
    """

    def __init__(self, dim: int, generator=None, device=None):
        super().__init__()
        conv = nn.Conv3d(dim, dim, 3, 1, 1, groups=dim, device=device)
        std = (1.0 / 27) ** 0.5 / 0.87962566103423978  # flax's lecun_normal, fan-in 27
        with torch.no_grad():
            conv.weight.copy_(trunc_normal((3, 3, 3, 1, dim), std, generator)
                              .permute(4, 3, 0, 1, 2))
            conv.bias.zero_()
        self.proj = nn.Sequential(conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            raise ValueError(f"PosCNN (PEG) takes an f32 stream, not {x.dtype}: the JAX "
                             "PosCNN's conv refuses a bf16 input against its f32 kernel")
        _, h, w, z, c = x.shape
        conv = self.proj[0]
        xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
        k = conv.weight.reshape(c, 27)
        y = conv.bias + x
        for t in range(27):
            dx, dy, dz = t // 9, t // 3 % 3, t % 3
            y = torch.addcmul(y, xp[:, dx:dx + h, dy:dy + w, dz:dz + z], k[:, t])
        return y


class VisionPermutator3D(nn.Module):
    """Stages of PermutatorBlocks over the tokenizer's [B, p, p, p, C] grid ->
    [B, num_classes] logits. ``embed_layer`` is a VoxelEmbedNoAverage. Block b
    of all takes drop path ``drop_path_rate * b / max(total - 1, 1)``, its
    masks drawn from seed ``drop_path_seed + b`` on the input's device."""

    def __init__(self, embed_layer: nn.Module, layers, embed_dims, transitions, segment_dim,
                 mlp_ratios, num_classes: int = 1000, skip_lam: float = 1.0,
                 qkv_bias: bool = False, drop_path_rate: float = 0.0,
                 pos_embedding: str | None = None, drop_path_seed: int = 0,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.patch_embed = embed_layer
        self.network = nn.ModuleList()
        total = sum(layers)
        done = 0
        for i, n_blocks in enumerate(layers):
            stage = nn.ModuleList()
            for b in range(n_blocks):
                stage.append(PermutatorBlock(
                    embed_dims[i], segment_dim[i], mlp_ratios[i], qkv_bias,
                    drop_path_rate * (done + b) / max(total - 1, 1), skip_lam,
                    drop_path_seed + done + b, dtype=dtype, **kw))
                if pos_embedding == "PEG" and b == 0:
                    stage.append(PosCNN(embed_dims[i], **kw))
            self.network.append(stage)
            done += n_blocks
            if i < len(layers) - 1 and (transitions[i] or embed_dims[i] != embed_dims[i + 1]):
                self.network.append(Downsample(embed_dims[i], embed_dims[i + 1],
                                               2 if transitions[i] else 1, dtype=dtype, **kw))
        self.norm = LayerNorm(embed_dims[-1], eps=1e-6, device=device)
        self.head = dense(embed_dims[-1], num_classes, dtype=dtype, **kw)

    @classmethod
    def from_name(cls, name: str, embed_layer: nn.Module, num_classes: int, **kw):
        return cls(embed_layer, num_classes=num_classes, **VIP3D_CONFIGS[name], **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, V, V, V] occupancy -> [B, num_classes]."""
        x = self.patch_embed(x)
        for part in self.network:
            for layer in (part if isinstance(part, nn.ModuleList) else (part,)):
                x = layer(x)
        x = self.norm(x.reshape(x.shape[0], -1, x.shape[-1]))
        return self.head(x.mean(1))
