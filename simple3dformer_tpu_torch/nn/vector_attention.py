"""Point-Transformer vector self-attention over kNN neighbourhoods (port of
simple3dformer_tpu/nn/vector_attention.py; the reference's
models/Hengshuang/transformer.py:7-44).

Per query point: its k nearest points in xyz (itself included, k clamped to
N), q from the point and k, v from its neighbours, and channelwise (vector)
attention softmax_K(fc_gamma(q - k + pos) / sqrt(d_model)) over the
neighbours with pos = fc_delta(xyz - neighbour xyz), aggregating v + pos.

The neighbours come from ``ops/pointops.knn_indices`` (the port's kNN
kernel on the card). Two routes by compute dtype, as the JAX package's kernel
route dispatches (its ``nn/vector_attention.py`` :113-152):

* f32 (``dtype=None``): k, v gathered by ``ops/pointops.index_points`` (the
  gather kernels), then ``kernels/vector_attention.vector_attention``, the
  pre-gathered chain (fc_delta, fc_gamma, the softmax and the sum over K).
* bf16 (``dtype=torch.bfloat16``; the parameters stay f32): q, k_all, v_all
  [B, N, D] and the indices go to ``kernels/vector_attention.gather_attention``,
  which reads the neighbour rows by index inside the kernels. Training takes
  the residual-saving pair when its four saves, 4 B N K D x 2 bytes, fit
  ``RESID_CAP_BYTES`` (6 GiB, the JAX package's cap) and ``S3F_VA_RESID`` is
  not ``0`` (the JAX package's switch), the recompute pair otherwise; a call
  that records no gradient runs the forward alone.

On a CUDA tensor the kernels run at every N and K they take (1 <= K <= 128,
D a multiple of 8); the JAX package's gate of N >= 256 and d_model % 128 == 0
is a TPU reason. Below it the JAX package computes the chain as flax Dense
layers, all in bf16 at bf16; the kernels' function (f32 biases, ReLU and
softmax, bf16 only as products' operands) is the tighter one, the one the JAX
package computes with ``FORCE_FUSED=True``. On a CPU tensor the kernels' plain
versions run. A call the kernels cannot take on the card raises. The block
returns ``attn=None``, as the JAX package's kernel route does: every model
discards it.

State-dict names are the reference's: ``fc1``, ``fc2``, ``w_qs``, ``w_ks``,
``w_vs`` and ``fc_delta.{0,2}`` / ``fc_gamma.{0,2}``.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..kernels import vector_attention as va
from ..ops import pointops
from .layers import dense

# the bf16 training route keeps its four saves up to this many bytes a call
RESID_CAP_BYTES = 6 * 2 ** 30


class MLP2(nn.Sequential):
    """Linear -> ReLU -> Linear (fc_delta / fc_gamma), children 0, 1, 2."""

    def __init__(self, in_features: int, hidden: int, out: int, generator=None, device=None,
                 dtype=None):
        kw = dict(generator=generator, device=device, dtype=dtype)
        super().__init__(dense(in_features, hidden, **kw), nn.ReLU(), dense(hidden, out, **kw))


class VectorAttentionBlock(nn.Module):
    """TransformerBlock(d_points, d_model, k) of the reference."""

    def __init__(self, d_points: int, d_model: int, k: int, generator=None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.d_model, self.k = d_model, k
        kw = dict(generator=generator, device=device, dtype=dtype)
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
        rel = xyz[:, :, None, :] - knn_xyz
        if q.dtype == torch.bfloat16:
            res = va.gather_attention(q, self.w_ks(x), self.w_vs(x), knn_idx, rel.to(q.dtype),
                                      self.chain_weights(), self.takes_resid(knn_idx, q))
        else:
            k = pointops.index_points(self.w_ks(x), knn_idx)  # [B, N, K, d_model]
            v = pointops.index_points(self.w_vs(x), knn_idx)
            res = va.vector_attention(q, k, v, rel, self.chain_weights())
        return self.fc2(res) + features, None

    def takes_resid(self, knn_idx: torch.Tensor, q: torch.Tensor) -> bool:
        """Whether a bf16 training call takes the residual-saving pair."""
        b, n, kk = knn_idx.shape
        saves = 4 * b * n * kk * self.d_model * q.element_size()
        return os.environ.get("S3F_VA_RESID", "1") != "0" and saves <= RESID_CAP_BYTES
