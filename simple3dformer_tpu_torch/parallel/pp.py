"""Pipeline parallelism over the ViT block stack, GPipe's schedule (port of
simple3dformer_tpu/parallel/pp.py).

The blocks (``ViTCore.blocks``, a list of ``Block``s: the port has no
``scan_blocks``) are cut into S contiguous stages, stage s holding blocks
[s d/S, (s+1) d/S); the ranks of a layout's ``stage`` group (parallel/mesh.
make_layout(n_data, S, "stage")) run one stage each, and a rank makes its
optimizer over its stage's blocks alone. ``pipeline_apply`` runs the JAX schedule: T = M + S - 1
ticks; at tick t stage 0 takes microbatch t, every stage runs its blocks on
what it holds and passes the result one hop round the ring
(mesh.ring_shift); microbatch i leaves the last stage at tick i + S - 1, and
the last stage's outputs reach every rank by a mask and an all-reduce over
the stage group. The backward is autograd's through the ring shift's
Function (its backward is the inverse shift), as ``jax.grad`` goes through
``ppermute``: there is no hand-written backward schedule.

The bubble ticks (stage s before tick s and after tick s + M - 1) compute on
nothing the output keeps: the JAX scan runs the blocks on zeros there and
throws the result away. Here their block calls are skipped and zeros go
round the ring instead, the same numbers with no launch: a stage runs its
blocks once a microbatch. Blocks run their normal routes (the fused training
kernels at the flagship's shape). dp x pp composes through the data axis:
each data rank streams its own columns of every microbatch, the pipeline's
collectives touch only the stage group, and the gradients are averaged over
the data group (train/loop.py under ``mesh.using_layout``).
"""

from __future__ import annotations

import torch

from .mesh import copy_to_group, group_rank, group_size, reduce_from_group, ring_shift


def split_stages(blocks, n_stage: int) -> list[list]:
    """The blocks (or any per-block items) cut into ``n_stage`` contiguous
    stages: stage s holds items [s d/S, (s+1) d/S)."""
    depth = len(blocks)
    if depth % n_stage:
        raise ValueError(f"depth {depth} not divisible by {n_stage} stages")
    per = depth // n_stage
    return [list(blocks[s * per:(s + 1) * per]) for s in range(n_stage)]


def merge_stages(stages) -> list:
    """Inverse of split_stages."""
    return [b for stage in stages for b in stage]


def run_stage(blocks, x: torch.Tensor) -> torch.Tensor:
    for blk in blocks:
        x = blk(x)
    return x


def pipeline_apply(blocks, microbatches: torch.Tensor, group) -> torch.Tensor:
    """[M, B, ...] microbatches through every stage -> [M, B, ...] on every rank.

    ``blocks``: this rank's stage (a list of modules, each x -> x of one
    shape); ``group``: the stage group, rank s holding stage s. On a data x
    stage layout pass each data rank's own columns of the microbatches: the
    collectives here stay inside ``group``.

    Every rank builds the same graph, as the JAX scan traces one program for
    every stage: each tick's input reads both the stream and what came round
    the ring (the other masked by a zero factor), a bubble tick's output is
    its input times zero, and the loss reads every rank's outputs through the
    last-stage mask. So each rank's backward runs the same ring shifts in the
    same order, and the stream's gradient is summed over the stages."""
    n_stage, sid = group_size(group), group_rank(group)
    m = microbatches.shape[0]
    first, last = float(sid == 0), float(sid == n_stage - 1)
    stream = copy_to_group(microbatches, group)
    held = torch.zeros_like(microbatches[0]).requires_grad_()
    # a zero that reads the stage's parameters: a bubble tick's output
    # depends on them as a live tick's does, so a backward that asks only
    # for the parameters' gradients still runs every tick's ring shift
    params = [p for blk in blocks for p in blk.parameters() if p.requires_grad]
    tie = sum(p.reshape(-1)[0] for p in params) * 0.0 if params else 0.0
    outs = []
    for t in range(m + n_stage - 1):
        x = stream[min(t, m - 1)] * (first if t < m else 0.0) + held * (1.0 - first)
        if sid <= t < sid + m:
            out = run_stage(blocks, x)
        else:
            out = x * 0.0 + (tie.to(x.dtype) if params else 0.0)
        outs.append(out)
        held = ring_shift(out, group)
    # microbatch i leaves the last stage at tick i + S - 1: that stage's
    # outputs, zeros elsewhere, summed over the stages
    return reduce_from_group(torch.stack(outs[n_stage - 1:]) * last, group)


def to_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, B / n_micro, ...]."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])


def from_microbatches(x: torch.Tensor) -> torch.Tensor:
    """Inverse of to_microbatches."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
