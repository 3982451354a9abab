"""RandomResizedCrop(224) and a horizontal flip for the LwF image pathway (port
of simple3dformer_tpu/data/image_augment.py; the reference's
train_partseg_lwf.py:125-129, torchvision's transforms).

Two implementations, as in the JAX package:

- host (numpy): torchvision's get_params (10 attempts of an area fraction
  and a log-aspect, then the central fallback clamped to the ratio bounds),
  a crop and a half-pixel bilinear resize, the flip with p = 0.5;
- device (torch): the same distribution drawn from a ``torch.Generator`` on
  the images' device, vectorised over the batch (10 candidates an image, the
  first that fits wins; ``sample_crop_boxes``), and the crop and resize as
  one resampling pass over the whole canvas (``resized_crop_flip``) that
  reproduces ``jax.image.scale_and_translate(method="linear")`` with its
  default antialiasing: per image a [size, H] and a [size, W] weight matrix
  (the triangle kernel, widened by 1/scale when the crop is larger than the
  output; weights normalised, samples outside the image dropped) applied as
  two batched products. Output border pixels can blend up to one source
  pixel outside the crop box, as in the JAX package. Its draws are the
  global batch's, cut to this rank's images (core/rng.rand).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rng import rand as batch_rand

SCALE = (0.08, 1.0)
RATIO = (3.0 / 4.0, 4.0 / 3.0)
N_CANDIDATES = 10


# ---------------------------------------------------------------------------
# host (numpy)
# ---------------------------------------------------------------------------

def random_resized_crop_params(rng, height: int, width: int, scale=SCALE, ratio=RATIO):
    """(i, j, h, w) drawn from ``rng`` exactly as torchvision's get_params."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(N_CANDIDATES):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h + 1)
            j = rng.randint(0, width - w + 1)
            return i, j, h, w
    w, h = _fallback(height, width, ratio)
    return (height - h) // 2, (width - w) // 2, h, w


def _fallback(height: int, width: int, ratio) -> tuple[int, int]:
    """(w, h) of the central fallback crop, clamped into the ratio bounds."""
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        return width, int(round(width / min(ratio)))
    if in_ratio > max(ratio):
        return int(round(height * max(ratio))), height
    return width, height


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel bilinear resize without antialiasing, [H, W, C] float."""
    h, w = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def random_resized_crop_flip(img: np.ndarray, rng, size: int = 224, scale=SCALE,
                             ratio=RATIO) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [size, size, C]: the crop, then the flip with p = 0.5."""
    i, j, h, w = random_resized_crop_params(rng, img.shape[0], img.shape[1], scale, ratio)
    out = _bilinear_resize(img[i:i + h, j:j + w].astype(np.float32), size, size)
    if rng.rand() < 0.5:
        out = out[:, ::-1]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# device (torch)
# ---------------------------------------------------------------------------

def _affine(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """A [0, 1) uniform mapped to [low, high) in f32, as jax.random.uniform maps it."""
    lo, hi = torch.tensor(low, dtype=torch.float32), torch.tensor(high, dtype=torch.float32)
    return torch.maximum(lo.to(u.device), u * (hi - lo).to(u.device) + lo.to(u.device))


def crop_boxes(u_area: torch.Tensor, u_aspect: torch.Tensor, u_i: torch.Tensor,
               u_j: torch.Tensor, height: int, width: int, scale=SCALE, ratio=RATIO):
    """Boxes (i, j, h, w), each [n] f32, from [0, 1) uniforms: u_area and
    u_aspect [n, 10] (the candidates), u_i and u_j [n]. The JAX package's
    ``_sample_crop_boxes`` in the same f32 operations."""
    ta = float(height * width) * _affine(u_area, scale[0], scale[1])
    aspect = torch.exp(_affine(u_aspect, math.log(ratio[0]), math.log(ratio[1])))
    ws = torch.round(torch.sqrt(ta * aspect))
    hs = torch.round(torch.sqrt(ta / aspect))
    valid = (ws > 0) & (ws <= width) & (hs > 0) & (hs <= height)
    first = valid.to(torch.uint8).argmax(1, keepdim=True)  # the first that fits (0 if none)
    any_valid = valid.any(1)
    fb_w, fb_h = _fallback(height, width, ratio)
    w = torch.where(any_valid, ws.gather(1, first)[:, 0], float(fb_w))
    h = torch.where(any_valid, hs.gather(1, first)[:, 0], float(fb_h))
    # torchvision's randint(0, H - h + 1): the floor of a uniform over the range
    i = torch.where(any_valid, torch.floor(u_i * (height - h + 1)), torch.floor((height - h) / 2))
    j = torch.where(any_valid, torch.floor(u_j * (width - w + 1)), torch.floor((width - w) / 2))
    return i, j, h, w


def sample_crop_boxes(generator: torch.Generator, n: int, height: int, width: int,
                      scale=SCALE, ratio=RATIO):
    """``n`` boxes (i, j, h, w) drawn from ``generator`` on its device."""
    u_area, u_aspect = (batch_rand((n, N_CANDIDATES), generator) for _ in range(2))
    u_i, u_j = batch_rand((2, n), generator, axis=1)
    return crop_boxes(u_area, u_aspect, u_i, u_j, height, width, scale, ratio)


def weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """[n, out_size, in_size] f32 resampling weights of jax.image's
    compute_weight_mat (triangle kernel, antialias=True) for n f32 scales and
    translations, evaluated in f64 and rounded once: XLA's own f32 evaluation
    puts the sample positions up to a few ulps from the exact ones, which moves
    an output pixel by up to about 1e-2 on the 0-255 scale."""
    dev = scale.device
    inv = 1.0 / scale.double()[:, None]
    kernel_scale = torch.clamp(inv, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float64, device=dev) + 0.5) * inv
                - translation.double()[:, None] * inv - 0.5)  # [n, out]
    src = torch.arange(in_size, dtype=torch.float64, device=dev)
    x = (sample_f[:, :, None] - src).abs() / kernel_scale[:, :, None]  # [n, out, in]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(-1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, torch.zeros_like(weights)).float()


def resized_crop_flip(images: torch.Tensor, i: torch.Tensor, j: torch.Tensor, h: torch.Tensor,
                      w: torch.Tensor, flip: torch.Tensor, size: int = 224) -> torch.Tensor:
    """uint8 or float [B, H, W, C] -> f32 [B, size, size, C]: each image's box
    (i, j, h, w) resampled to size x size over the whole canvas, then flipped
    left-right where ``flip`` [B] is true."""
    b, height, width, c = images.shape
    out_size = h.new_tensor(float(size))  # a true division (torch's size / h is size * (1 / h))
    sy, sx = out_size / h, out_size / w
    wy = weight_matrix(height, size, sy, -i * sy)  # [B, size, H]
    wx = weight_matrix(width, size, sx, -j * sx)  # [B, size, W]
    x = images.float()
    rows = torch.bmm(wy, x.reshape(b, height, width * c)).reshape(b, size, width, c)
    out = torch.einsum("bowc,bpw->bopc", rows, wx)
    return torch.where(flip[:, None, None, None], out.flip(2), out)


def device_random_resized_crop_flip(generator: torch.Generator, images: torch.Tensor,
                                    size: int = 224, scale=SCALE, ratio=RATIO) -> torch.Tensor:
    """uint8 or float [B, H, W, C] -> f32 [B, size, size, C], a fresh crop and a
    flip with p = 0.5 for each image, drawn from ``generator``."""
    b, height, width, _ = images.shape
    i, j, h, w = sample_crop_boxes(generator, b, height, width, scale, ratio)
    flip = batch_rand((b,), generator) < 0.5
    return resized_crop_flip(images, i, j, h, w, flip, size)
