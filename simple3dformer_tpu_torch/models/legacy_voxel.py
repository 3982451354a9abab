"""The legacy voxel-to-image model (port of simple3dformer_tpu/models/legacy_voxel.py;
the reference's models/vit_3d_2d_pretrain.py:97-210, FeatureVoxel_2DViT and
FeatureVoxel_2DViT_2layerhead).

The first experiment of the idea: a VoxNet-style 3D conv stack, a Linear to
196 per channel, a 14x14 "image" of 32 channels, a decoder that upscales it
to a 224x224 RGB image, and a standard 2D DeiT (``nn.vit.ViT2D``) that
classifies the synthesized image from its cls token.

Layout and numerics follow the JAX modules:

- Activations are channels-last. The 3D convolutions are VALID, as
  nn/voxel_embed._conv3d computes them (unfold and one matmul, so no TF32);
  the decoder's 3x3 convolutions (padding 1) are unfolded the same way, in
  the compute dtype (flax ``Conv(dtype=...)``'s casts).
- ``fc_bn`` normalises the channel axis of the [B, C, 196] features (flax
  BatchNorm over ``axis=1``): it runs on the transposed [B, 196, C].
- Every BatchNorm has flax's default momentum, 0.99.
- ``Up``'s bilinear 2x resize applies jax.image.resize's weights
  (data/image_augment.weight_matrix: half-pixel centres, the edge clamped),
  one [2n, n] matrix an axis. ``Up(bilinear=False)`` is flax
  ``ConvTranspose((2, 2), strides 2, padding SAME)``, which puts
  x[i] K[1 - a] at output 2i + a: the parameter is held as
  ``nn.ConvTranspose2d``'s [in, out, 2, 2] (out[2i + a] = x[i] w[a]), so the
  converter flips the JAX kernel's spatial axes (utils/convert.py).
- The ViT's head is never called (the model has its own), so it has none:
  the JAX tree has no ``transformer/head`` either.

Dropout masks are drawn on the data's device from a generator seeded with
``dropout_seed`` (core/rng), so their numbers are not the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import rng
from ..core.rng import DeviceGenerators
from ..data.image_augment import weight_matrix
from ..nn.layers import BatchNorm, dense, linear, trunc_normal
from ..nn.vit import TEACHER_BACKBONES, ViT2D
from ..nn.voxel_embed import _conv3d

BN_MOMENTUM = 0.99  # flax's default
_RESIZE: dict[tuple[int, str], torch.Tensor] = {}


def _lecun(module: nn.Module, fan_in: int, generator) -> nn.Module:
    """flax's lecun_normal kernel (truncated normal, variance 1 / fan_in), zero bias."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        module.weight.copy_(trunc_normal(module.weight.shape, std, generator))
        module.bias.zero_()
    return module


def conv3x3(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A 3x3 convolution with padding 1 of channels-last x [B, H, W, C]: the
    windows unfolded to [.., C 3 3] and one product with the [out, C 3 3] weight."""
    cols = F.pad(x, (0, 0, 1, 1, 1, 1)).unfold(1, 3, 1).unfold(2, 3, 1)
    cols = cols.reshape(*cols.shape[:3], -1)  # window order (C, ky, kx)
    return linear(cols, conv.weight.flatten(1), conv.bias, dtype)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """jax.image.resize(x, (B, 2H, 2W, C), "bilinear") of [B, H, W, C], in x's dtype."""
    _, h, w, _ = x.shape
    mats = []
    for n in (h, w):
        key = (n, str(x.device))
        if key not in _RESIZE:
            with torch.inference_mode(False):  # a serving call may be the first: a plain tensor
                _RESIZE[key] = weight_matrix(n, 2 * n, torch.tensor([2.0]),
                                             torch.tensor([0.0]))[0].to(x.device)
        mats.append(_RESIZE[key].to(x.dtype))
    x = torch.einsum("ph,bhwc->bpwc", mats[0], x)
    return torch.einsum("qw,bpwc->bpqc", mats[1], x)


def conv_transpose2x2(x: torch.Tensor, deconv: nn.ConvTranspose2d,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """The stride-2 2x2 transposed convolution of [B, H, W, C] -> [B, 2H, 2W, O]:
    the windows do not overlap, so it is one product and a reshape."""
    b, h, w, _ = x.shape
    o = deconv.weight.shape[1]
    dt = dtype or x.dtype
    # x @ [C, (O, a, b)]: the weight's gradient comes back contiguous, as the
    # Adam kernel takes it (a product with the transposed weight would not)
    y = torch.matmul(x.to(dt), deconv.weight.flatten(1).to(dt))
    y = (y + deconv.bias.repeat_interleave(4).to(dt)).reshape(b, h, w, o, 2, 2)
    return y.permute(0, 1, 4, 2, 5, 3).reshape(b, 2 * h, 2 * w, o)


class DoubleConv(nn.Module):
    """(Conv 3x3 -> BN -> ReLU) x 2 (vit_3d_2d_pretrain.py:58-75)."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.compute_dtype = dtype
        self.conv1 = _lecun(nn.Conv2d(in_channels, mid, 3, device=device), 9 * in_channels,
                            generator)
        self.bn1 = BatchNorm(mid, BN_MOMENTUM, device=device)
        self.conv2 = _lecun(nn.Conv2d(mid, out_channels, 3, device=device), 9 * mid, generator)
        self.bn2 = BatchNorm(out_channels, BN_MOMENTUM, device=device)

    def forward(self, x):
        x = F.relu(self.bn1(conv3x3(x, self.conv1, self.compute_dtype)))
        return F.relu(self.bn2(conv3x3(x, self.conv2, self.compute_dtype)))


class Up(nn.Module):
    """2x upsample then DoubleConv (vit_3d_2d_pretrain.py:78-95): bilinear
    (DoubleConv's mid width C // 2) or a 2x2 stride-2 transposed conv ``deconv``."""

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = True,
                 generator=None, device=None, dtype: torch.dtype | None = None):
        super().__init__()
        self.bilinear = bilinear
        self.compute_dtype = dtype
        kw = dict(generator=generator, device=device, dtype=dtype)
        if bilinear:
            self.conv = DoubleConv(in_channels, out_channels, in_channels // 2, **kw)
        else:
            self.deconv = _lecun(nn.ConvTranspose2d(in_channels, in_channels, 2, 2,
                                                    device=device), 4 * in_channels, generator)
            self.conv = DoubleConv(in_channels, out_channels, **kw)

    def forward(self, x):
        if self.bilinear:
            x = upsample2x_bilinear(x)
        else:
            x = conv_transpose2x2(x, self.deconv, self.compute_dtype)
        return self.conv(x)


class FeatureVoxel2DViT(nn.Module):
    """VoxNet conv stack -> FC -> 14x14 map -> upsampled 224^2 RGB -> ViT2D -> head.

    x [B, V, V, V] (V = ``voxel_size``, 32 or 128) -> logits [B, n_classes].
    ``two_layer_head`` is FeatureVoxel_2DViT_2layerhead (Linear 256, ReLU,
    dropout 0.3, Linear). ``dtype`` is the compute dtype of the Linear layers,
    the decoder's convolutions and the ViT (the JAX model's ``dtype``); the 3D
    convolutions compute in f32, as the JAX model's take no cast.
    """

    def __init__(self, n_classes: int = 10, voxel_size: int = 32,
                 transformer_backbone: str = "deit_base_patch16_224",
                 two_layer_head: bool = False, drop1: float = 0.2, drop2: float = 0.3,
                 dropout_seed: int = 0, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if voxel_size == 32:
            convs = [(32, 5, 2), (32, 3, 1)]
        elif voxel_size == 128:
            convs = [(8, 5, 2), (16, 3, 1), (32, 3, 1), (32, 3, 1)]
        else:
            raise ValueError("input_shape must be 32^3 or 128^3")
        self.voxel_size, self.two_layer_head = voxel_size, two_layer_head
        self.drop1, self.drop2 = drop1, drop2
        self.strides = [s for _, _, s in convs]
        kw = dict(generator=generator, device=device, dtype=dtype)
        cin = 1
        for i, (ch, k, _) in enumerate(convs):
            self.add_module(f"conv3d_{i + 1}",
                            _lecun(nn.Conv3d(cin, ch, k, device=device), cin * k ** 3, generator))
            cin = ch
        self.fc1 = dense(216, 196, **kw)  # 6^3 features a channel from either stack
        self.fc_bn = BatchNorm(32, BN_MOMENTUM, device=device)
        self.deconv1 = Up(32, 16, True, **kw)
        self.deconv2 = Up(16, 8, True, **kw)
        self.deconv3 = Up(8, 4, True, **kw)
        self.deconv4 = Up(4, 3, False, **kw)
        cfg = TEACHER_BACKBONES[transformer_backbone]
        self.transformer = ViT2D(cfg["embed_dim"], cfg["depth"], cfg["num_heads"],
                                 patch_size=cfg["patch_size"], **kw)
        del self.transformer.head  # never called: the model has its own head
        d = cfg["embed_dim"]
        if two_layer_head:
            self.head_fc1 = dense(d, 256, **kw)
            self.head_fc2 = dense(256, n_classes, **kw)
        else:
            self.head = dense(d, n_classes, **kw)
        self.generators = DeviceGenerators(dropout_seed)

    def _drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if not self.training or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = rng.rand(x.shape, self.generators(x.device)) < keep
        return torch.where(mask, x / keep, 0.0)

    def convs(self, x: torch.Tensor) -> torch.Tensor:
        """[B, V, V, V] -> the conv stack's features [B, 32, 216], channels-major
        over (X, Y, Z)."""
        if x.ndim != 4 or x.shape[1] != self.voxel_size:
            raise ValueError(f"input voxel grid {tuple(x.shape[1:])} != model "
                             f"{self.voxel_size}^3")
        h = x[..., None]
        for i, stride in enumerate(self.strides):
            conv = getattr(self, f"conv3d_{i + 1}")
            h = F.relu(_conv3d(h, conv.weight, conv.bias, stride))
            if i > 0:  # MaxPool3d(2) after every conv but the first
                b, g, c = h.shape[0], h.shape[1] // 2, h.shape[-1]
                h = h[:, :2 * g, :2 * g, :2 * g].reshape(b, g, 2, g, 2, g, 2, c).amax((2, 4, 6))
            h = self._drop(h, self.drop1 if i == 0 else self.drop2)
        return h.permute(0, 4, 1, 2, 3).reshape(h.shape[0], h.shape[-1], -1)

    def decode(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, 32, 216] -> the synthesized image [B, 224, 224, 3]."""
        h = self.fc1(feats)  # [B, 32, 196]
        h = F.relu(self.fc_bn(h.transpose(1, 2)))  # the channel axis last: [B, 196, 32]
        h = h.reshape(h.shape[0], 14, 14, h.shape[-1])
        for up in (self.deconv1, self.deconv2, self.deconv3, self.deconv4):
            h = up(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.transformer.forward_features(self.decode(self.convs(x)))[:, 0]
        if self.two_layer_head:
            g = self._drop(F.relu(self.head_fc1(feats)), 0.3)
            return self.head_fc2(g)
        return self.head(feats)
