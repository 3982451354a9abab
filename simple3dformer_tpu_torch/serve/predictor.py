"""Batched inference serving (port of simple3dformer_tpu/serve/predictor.py).

``Predictor`` runs a model at one fixed batch size: a request of any length
is cut into chunks of ``batch_size``, the last chunk padded with zeros, and
only the real rows come back. Every forward then has the same shape, which
is the shape the kernels were checked at. The device is an explicit
argument: a predictor asked for "cuda" on a machine without a card fails
instead of running on the CPU. Forwards are serialised by a lock, since one
device runs one forward at a time anyway and the launch counts stay exact.

``Predictor.export`` writes the forward at the predictor's batch and input
shape, on its device and with the weights inside, as a ``torch.export``
program (a ``.pt2`` file: the counterpart of the JAX package's serialized
StableHLO), for every model of the port. ``load_exported`` runs it without
the model's code: it imports only the kernel modules that register the
forward kernels as torch ops (``s3f::vit_block_fwd``; the point models'
``s3f::fps``, ``s3f::knn``, ``s3f::gather_fwd``, ``s3f::mhsa_fwd``,
``s3f::vector_attention_fwd`` and ``s3f::gather_attention_fwd``), which an
exported program calls as nodes. A forward that reaches a kernel that is not
registered (only a training forward is not) raises at export, naming it.
"""

from __future__ import annotations

import threading
import time
import zipfile
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

EXPORT_DEVICE = "device"  # the extra file of an exported program naming its device


class Predictor:
    """Fixed-shape batched inference around a torch model."""

    def __init__(self, model: nn.Module, input_shape: tuple, device,
                 batch_size: int = 32, postprocess: Optional[Callable] = None,
                 warmup: bool = True):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.input_shape = tuple(input_shape)
        self.postprocess = postprocess
        self._latencies: list[float] = []
        self._lock = threading.Lock()
        if warmup:  # builds the kernels on first use, outside any request
            self._forward(np.zeros((batch_size, *self.input_shape), np.float32))

    @classmethod
    def from_checkpoint(cls, model: nn.Module, ckpt_dir: str, input_shape: tuple,
                        device, step: int | None = None, **kw) -> "Predictor":
        """Load ``state["params"]`` of a core.checkpoint.Checkpointer step."""
        from ..core.checkpoint import Checkpointer

        state, _ = Checkpointer(ckpt_dir).restore(step)
        if state is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        model.load_state_dict(state["params"])
        return cls(model, input_shape, device, **kw)

    @torch.inference_mode()
    def _forward(self, chunk: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(chunk).to(self.device)
        return self.model(x).float().cpu().numpy()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """x [n, *input_shape] with any n: padded/chunked to the fixed batch
        size; returns host numpy outputs for the n real rows."""
        x = np.asarray(x, dtype=np.float32)
        if x.shape[1:] != self.input_shape:
            raise ValueError(
                f"expected trailing shape {self.input_shape}, got {x.shape[1:]}")
        if len(x) == 0:
            raise ValueError("no inputs")
        outs = []
        with self._lock:
            t0 = time.perf_counter()
            for start in range(0, len(x), self.batch_size):
                chunk = x[start:start + self.batch_size]
                real = len(chunk)
                if real < self.batch_size:
                    pad = np.zeros((self.batch_size - real, *self.input_shape), np.float32)
                    chunk = np.concatenate([chunk, pad])
                outs.append(self._forward(chunk)[:real])
            self._latencies.append(time.perf_counter() - t0)
        result = np.concatenate(outs)
        return self.postprocess(result) if self.postprocess else result

    def export(self, path: str) -> str:
        """Write the model's forward at [batch_size, *input_shape] f32 on the
        predictor's device, weights inside, to ``path`` (a ``.pt2`` file);
        ``load_exported`` runs it. Raises if the forward reaches a kernel that
        is not a registered op."""
        x = torch.zeros((self.batch_size, *self.input_shape), device=self.device)
        with torch.no_grad():
            program = torch.export.export(self.model, (x,), strict=False)
        torch.export.save(program, path, extra_files={EXPORT_DEVICE: self.device.type})
        return path

    @property
    def stats(self) -> dict:
        lat = np.asarray(self._latencies)
        if lat.size == 0:
            return {"requests": 0}
        return {
            "requests": int(lat.size),
            "mean_latency_ms": float(lat.mean() * 1e3),
            "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_latency_ms": float(np.percentile(lat, 95) * 1e3),
        }


def exported_device(path: str) -> str:
    """The device type a ``Predictor.export`` artifact was written for."""
    with zipfile.ZipFile(path) as archive:
        for name in archive.namelist():
            if name.endswith(f"/extra/{EXPORT_DEVICE}"):
                return archive.read(name).decode()
    raise ValueError(f"{path} is not an artifact of Predictor.export")


def load_exported(path: str) -> Callable[[np.ndarray], np.ndarray]:
    """Load a ``Predictor.export`` artifact: a callable from inputs [B, ...] (the
    exported batch and shape, any array) to host numpy logits, run on the
    device the artifact was written for. It needs no model code. An artifact
    for the card raises where no card is visible; it never moves to the CPU."""
    # register the ops an exported program calls
    from ..kernels import fps, gather, knn, mhsa, vector_attention, vit_block  # noqa: F401

    device = exported_device(path)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for a CUDA card and none is visible")
    module = torch.export.load(path).module()

    @torch.inference_mode()
    def call(x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
        return module(x).float().cpu().numpy()

    return call


def topk_labels(logits: np.ndarray, k: int = 5,
                names: dict[int, str] | None = None) -> list[list]:
    """Human-readable top-k (index-or-name, prob) per sample."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1)[:, :k]
    out = []
    for row, p in zip(order, probs):
        out.append([((names[int(i)] if names else int(i)), float(p[i])) for i in row])
    return out
