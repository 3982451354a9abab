"""Point-Transformer vector self-attention over kNN neighbourhoods (port of
simple3dformer_tpu/nn/vector_attention.py; the reference's
models/Hengshuang/transformer.py:7-44).

Per query point: its k nearest points in xyz (itself included, k clamped to
N), q from the point and k, v from its neighbours, and channelwise (vector)
attention softmax_K(fc_gamma(q - k + pos) / sqrt(d_model)) over the
neighbours with pos = fc_delta(xyz - neighbour xyz), aggregating v + pos.

The neighbours come from ``ops/pointops.knn_indices`` and k, v are gathered
by ``ops/pointops.index_points`` (the port's kNN and gather kernels on the
card), as the JAX package's f32 route does (its ``nn/vector_attention.py``
:132-139). The chain from there (fc_delta, fc_gamma, the softmax and the sum
over K) is ``kernels/vector_attention.vector_attention``: the CUDA kernels on
a CUDA tensor at every N and K the kernels take (the JAX package's gate of
N >= 256 on a TPU is a TPU reason only; both of its routes compute this
chain in f32), its plain version on a CPU tensor. A call the kernels cannot
take on the card (a dtype other than f32, more than 128 neighbours) raises.
The block returns ``attn=None``, as the JAX package's kernel route does:
every model discards it.

State-dict names are the reference's: ``fc1``, ``fc2``, ``w_qs``, ``w_ks``,
``w_vs`` and ``fc_delta.{0,2}`` / ``fc_gamma.{0,2}``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import vector_attention as va
from ..ops import pointops
from .layers import dense


class MLP2(nn.Sequential):
    """Linear -> ReLU -> Linear (fc_delta / fc_gamma), children 0, 1, 2."""

    def __init__(self, in_features: int, hidden: int, out: int, generator=None, device=None):
        super().__init__(dense(in_features, hidden, generator=generator, device=device),
                         nn.ReLU(),
                         dense(hidden, out, generator=generator, device=device))


class VectorAttentionBlock(nn.Module):
    """TransformerBlock(d_points, d_model, k) of the reference."""

    def __init__(self, d_points: int, d_model: int, k: int, generator=None, device=None):
        super().__init__()
        self.d_model, self.k = d_model, k
        kw = dict(generator=generator, device=device)
        self.fc1 = dense(d_points, d_model, **kw)
        self.fc2 = dense(d_model, d_points, **kw)
        self.fc_delta = MLP2(3, d_model, d_model, **kw)
        self.fc_gamma = MLP2(d_model, d_model, d_model, **kw)
        self.w_qs = dense(d_model, d_model, bias=False, **kw)
        self.w_ks = dense(d_model, d_model, bias=False, **kw)
        self.w_vs = dense(d_model, d_model, bias=False, **kw)

    def chain_weights(self) -> dict[str, torch.Tensor]:
        """fc_delta's and fc_gamma's weights under the kernel's names, no copies."""
        d, g = self.fc_delta, self.fc_gamma
        return dict(wd1=d[0].weight, bd1=d[0].bias, wd2=d[2].weight, bd2=d[2].bias,
                    wg1=g[0].weight, bg1=g[0].bias, wg2=g[2].weight, bg2=g[2].bias)

    def forward(self, xyz, features):
        """xyz [B, N, 3], features [B, N, d_points] -> (out [B, N, d_points], None)."""
        knn_idx = pointops.knn_indices(xyz, xyz, self.k)  # includes the point itself
        knn_xyz = pointops.index_points(xyz, knn_idx)
        x = self.fc1(features)
        q = self.w_qs(x)
        k = pointops.index_points(self.w_ks(x), knn_idx)  # [B, N, K, d_model]
        v = pointops.index_points(self.w_vs(x), knn_idx)
        rel = xyz[:, :, None, :] - knn_xyz
        res = va.vector_attention(q, k, v, rel, self.chain_weights())
        return self.fc2(res) + features, None
