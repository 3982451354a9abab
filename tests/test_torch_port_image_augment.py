"""The port's LwF image augmentation against the JAX package's, on the CPU: the
host crop (torchvision's get_params) from the same RandomState, the device
crop boxes from the uniforms JAX's keys draw, and the antialiased resample
(jax.image.scale_and_translate, linear) from the same boxes and flips."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.data import image_augment as jia
from simple3dformer_tpu_torch.data import image_augment as pia

# the resample on the 0-255 scale, against jax.image's weight formula
# (compute_weight_mat) evaluated in float64 from the same f32 scales and
# translations: the f32 rounding of the weights and of two sums of products
RESAMPLE_ATOL = 1e-3
# against the JAX function itself: XLA evaluates the sample positions in f32
# with roundings of its own, up to a few ulps (2^-16 at 128-256) from the
# exact ones, and each such ulp moves a weight by up to 2^-16, a pixel (up
# to 255, two weights a sample in each of the two directions) by up to 8e-3
JAX_RESAMPLE_ATOL = 2e-2


@pytest.mark.parametrize("shape", [(256, 256), (64, 200), (300, 90), (17, 17)])
def test_host_crop_equals_jax(shape):
    h, w = shape
    img = (np.random.RandomState(1).rand(h, w, 3) * 255).astype(np.uint8)
    for seed in range(6):
        ours, theirs = np.random.RandomState(seed), np.random.RandomState(seed)
        assert (pia.random_resized_crop_params(ours, h, w)
                == jia.random_resized_crop_params(theirs, h, w))
        got = pia.random_resized_crop_flip(img, ours, size=24)
        want = jia.random_resized_crop_flip(img, theirs, size=24)
        assert got.dtype == np.uint8 and got.shape == (24, 24, 3)
        np.testing.assert_array_equal(got, want)
        assert ours.rand() == theirs.rand()  # the same number of draws


def test_host_fallback_equals_jax():
    """A scale and ratio no candidate fits: the central fallback."""
    for h, w in ((64, 64), (40, 200), (200, 40)):
        ours, theirs = np.random.RandomState(3), np.random.RandomState(3)
        args = dict(scale=(0.95, 1.0), ratio=(2.0, 3.0))
        assert (pia.random_resized_crop_params(ours, h, w, **args)
                == jia.random_resized_crop_params(theirs, h, w, **args))


BOX_CASES = [
    (256, 256, pia.SCALE, pia.RATIO),
    (64, 64, (0.9, 1.0), (2.0, 3.0)),  # no candidate fits: fallback, in_ratio < min
    (64, 200, (0.95, 1.0), pia.RATIO),  # fallback, in_ratio > max
    (200, 64, (0.95, 1.0), pia.RATIO),  # some fit, some fall back
]


@pytest.mark.parametrize("h,w,scale,ratio", BOX_CASES)
def test_crop_boxes_from_jax_uniforms_equal_jax(h, w, scale, ratio):
    n = 96
    key = jax.random.key(5)
    k_area, k_aspect, k_ij = jax.random.split(key, 3)
    u = [np.asarray(jax.random.uniform(k, (n, pia.N_CANDIDATES))) for k in (k_area, k_aspect)]
    u_i, u_j = np.asarray(jax.random.uniform(k_ij, (2, n)))
    got = pia.crop_boxes(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (*u, u_i, u_j)),
                         h, w, scale, ratio)
    want = jia._sample_crop_boxes(key, n, h, w, scale, ratio)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))
    i, j, bh, bw = (g.numpy() for g in got)
    assert (i >= 0).all() and (j >= 0).all() and (i + bh <= h).all() and (j + bw <= w).all()


def test_sample_crop_boxes_draws_from_the_generator():
    gen = torch.Generator().manual_seed(4)
    a = pia.sample_crop_boxes(gen, 512, 256, 256)
    b = pia.sample_crop_boxes(torch.Generator().manual_seed(4), 512, 256, 256)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    i, j, h, w = a
    area = (h * w / 256 ** 2).numpy()
    assert 0.05 < area.min() and area.max() <= 1.0 and 0.4 < area.mean() < 0.65
    assert (i + h <= 256).all() and (j + w <= 256).all()


def f64_weights(in_size, out_size, scale, translation):
    """jax.image's compute_weight_mat (triangle, antialias) in float64: [n, in, out]."""
    scale, translation = (np.asarray(a, np.float64)[:, None, None] for a in (scale, translation))
    inv = 1.0 / scale
    sample_f = (np.arange(out_size) + 0.5)[None, None, :] * inv - translation * inv - 0.5
    x = np.abs(sample_f - np.arange(in_size)[None, :, None]) / np.maximum(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(1, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    return np.where((sample_f >= -0.5) & (sample_f <= in_size - 0.5), w, 0)


@pytest.mark.parametrize("canvas,size", [(64, 224), (256, 224), (64, 24)])
def test_resample_from_the_same_boxes_matches_jax(canvas, size):
    """64 -> 224: upscaling only; 256 -> 224: crops larger and smaller than the
    output (the antialiased and the plain triangle); 64 -> 24: downscaling."""
    b = 12
    images = (np.random.RandomState(canvas + size).rand(b, canvas, canvas, 3) * 255
              ).astype(np.uint8)
    key = jax.random.key(canvas + size)
    want = np.asarray(jia.device_random_resized_crop_flip(key, jnp.asarray(images), size=size))
    k_box, k_flip = jax.random.split(key)
    i, j, h, w = (np.asarray(t) for t in
                  jia._sample_crop_boxes(k_box, b, canvas, canvas, jia.SCALE, jia.RATIO))
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (b, 1, 1, 1))).reshape(b)
    if (canvas, size) == (256, 224):
        assert (h > size).any() and (h < size).any()
    assert flip.any() and not flip.all()
    got = pia.resized_crop_flip(torch.from_numpy(images),
                                *(torch.from_numpy(t.copy()) for t in (i, j, h, w)),
                                torch.from_numpy(flip), size).numpy()
    assert got.dtype == np.float32 and got.shape == (b, size, size, 3)
    # the JAX function's f32 scales and translations (size / h, -i * scale)
    sy, sx = np.float32(size) / h, np.float32(size) / w
    rows = np.einsum("bhwc,bho->bowc", images.astype(np.float64),
                     f64_weights(canvas, size, sy, -i * sy), optimize=True)
    exact = np.einsum("bowc,bwp->bopc", rows, f64_weights(canvas, size, sx, -j * sx),
                      optimize=True)
    exact = np.where(flip[:, None, None, None], exact[:, :, ::-1], exact)
    np.testing.assert_allclose(got, exact, rtol=0, atol=RESAMPLE_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_RESAMPLE_ATOL)


def test_device_crop_is_fresh_per_draw_and_in_range():
    images = torch.from_numpy((np.random.RandomState(0).rand(8, 64, 64, 3) * 255)
                              .astype(np.uint8))
    gen = torch.Generator().manual_seed(1)
    a = pia.device_random_resized_crop_flip(gen, images, size=32)
    b = pia.device_random_resized_crop_flip(gen, images, size=32)
    again = pia.device_random_resized_crop_flip(torch.Generator().manual_seed(1), images, size=32)
    assert a.shape == (8, 32, 32, 3) and torch.equal(a, again) and not torch.equal(a, b)
    assert float(a.min()) >= -1e-3 and float(a.max()) <= 255 + 1e-3
