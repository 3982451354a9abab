"""Profiling hooks (port of simple3dformer_tpu/utils/profiling.py).

- ``trace(logdir)``: ``torch.profiler`` around a block of code (the host, and
  the card where one is visible), written as a Chrome trace
  ``<logdir>/trace.json`` when the block ends.
- ``flops_estimate(fn, *args)``: the floating-point operations of one call,
  counted by ``torch.utils.flop_counter.FlopCounterMode``.
- ``param_count`` and the ``Throughput`` meter.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections.abc import Iterable

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from ..kernels import vit_block  # noqa: F401  registers s3f::vit_block_fwd


@register_flop_formula(torch.ops.s3f.vit_block_fwd)
def _vit_block_flops(x_shape, weights_shape, heads, cdt, *args, out_shape=None, **kwargs) -> int:
    """One block forward: the qkv, proj, fc1 and fc2 products and the two
    attention products, 2 FLOPs a multiply-add."""
    b, n, d = x_shape
    return 24 * b * n * d * d + 4 * b * n * n * d


@contextlib.contextmanager
def trace(logdir: str = "trace"):
    """Profile the block: yields the ``torch.profiler.profile`` (its
    ``key_averages()`` for a table) and writes ``<logdir>/trace.json`` (open it
    in Perfetto or chrome://tracing) when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def flops_estimate(fn, *args) -> dict:
    """The FLOPs of one call ``fn(*args)``, which runs once: {"flops": n}. This
    is not XLA's ``cost_analysis``: FlopCounterMode counts 2 FLOPs a
    multiply-add of the products, convolutions and attention calls only
    (nothing elementwise), the ViT block op by the formula above and the
    port's other kernels not at all, and it counts no bytes."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": counter.get_total_flops()}


def param_count(params: nn.Module | dict | Iterable[torch.Tensor]) -> int:
    """Elements of a module's parameters, a state dict's tensors or any tensors."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return sum(p.numel() for p in params)


class Throughput:
    """Running samples/sec meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.samples = 0

    def add(self, n: int):
        self.samples += n

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.samples / dt if dt > 0 else 0.0
