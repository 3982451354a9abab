"""Attention rollout over captured attention maps (port of
simple3dformer_tpu/utils/attention_rollout.py).

The reference registers forward hooks on every block's attn module (its
visualize_attention_map_voxel.py:144); the JAX package sows each softmax map
into flax's ``intermediates``. Here ``nn.layers.recording_attention`` keeps
the map of each ``Attention`` module's first call while it is open, with
every block on its layered route and the plain attention products: no fused
block and no ``mhsa`` kernel runs during a capture, as in the JAX package,
and the same model launches its kernels again after it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.layers import recording_attention


def capture_attention(model: nn.Module, x: torch.Tensor):
    """One forward of ``model`` in eval mode, capturing every block's
    attention map.

    Returns (output, maps): maps [L, B, H, N, N], L the number of blocks, one
    map per module (its first call: the group_embed route's stage-1 maps, as
    the JAX function returns them).
    """
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), recording_attention() as recorded:
            out = model(x)
    finally:
        model.train(was_training)
    return out, torch.stack(list(recorded.values()))


def rollout(att: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """att [L, H, N, N] (one sample) -> (mask [g, g], joint [L, N, N], g).

    Head-mean, add identity for the residual path, row-normalize, multiply
    through the layers; the cls-token row over patch tokens reshaped to the
    sqrt grid — exactly the reference's get_mask.
    """
    att = np.asarray(att)
    att = att.mean(axis=1)  # [L, N, N]
    L, N, _ = att.shape
    aug = att + np.eye(N)
    aug = aug / aug.sum(axis=-1, keepdims=True)

    joint = np.zeros_like(aug)
    joint[0] = aug[0]
    for layer in range(1, L):
        joint[layer] = aug[layer] @ joint[layer - 1]

    grid = int(np.sqrt(N))
    mask = joint[-1][0, 1:].reshape(grid, grid)
    return mask, joint, grid
