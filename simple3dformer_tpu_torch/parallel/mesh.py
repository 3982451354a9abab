"""Data parallelism over ``torch.distributed`` (port of simple3dformer_tpu/parallel/mesh.py).

The JAX package trains every entry point as one global-batch computation
over a device mesh: one process drives all local chips, the batch is
sharded over the ``data`` axis and XLA inserts the gradient reduction. The
port runs one process per card, PyTorch's idiom (``torchrun
--nproc_per_node=N``): each rank holds the whole model and the whole corpus,
takes its columns of each step's index matrix, and the ranks meet in a few
collectives written out here:

  * ``multihost_init``: the rendezvous (NCCL for a CUDA device, gloo for the
    CPU);
  * ``rank_columns``: rank r's columns ``r*B/n .. (r+1)*B/n`` of an
    ``[S, B]`` index matrix, or the whole matrix on every rank (with the JAX
    package's warning) where B does not divide by n;
  * ``data_split``: the split the current step runs under, read by the
    global-batch draws (core/rng.py), the synced BatchNorm (nn/layers.py) and
    the class-weighted loss (train/loop.py);
  * ``all_reduce_sum``: a differentiable all-reduce (all-reduce in both
    directions), for the BatchNorm statistics;
  * ``average_gradients``: one flat bucket of the trainable gradients,
    all-reduced and averaged. ``DistributedDataParallel`` is not used: the
    train steps take their gradients with ``torch.autograd.grad``, which
    never runs DDP's hooks;
  * ``fetch_global``: an all-gather along the batch axis, for eval.

The rule is that the port at world size n computes what it computes at world
size 1 on the same global batch, to within reduction order.

The 2-D layout (``make_layout(n_data, n_inner, inner)``, the counterpart of
``make_mesh(n_data, n_model)``): ranks laid out as the JAX package lays out
devices, ``devices.reshape(n_data, n_inner)``, so rank = d * n_inner + m, one
process group per axis: ``data`` and an inner axis named ``model`` (tensor
parallelism, parallel/tp.py), ``stage`` (the pipeline, parallel/pp.py) or
``seq`` (the point axis, parallel/sp.py). Inside ``using_layout(layout)`` the
data-parallel helpers above work on the ``data`` group (under ``seq`` the
batch statistics and the gradients run over data x seq, the global batch's
points); with no layout they work on the whole world, as before. Beside the
all-reduce, the differentiable collectives of the inner axes:
``all_reduce_sum(x, group)``, Megatron's pair ``copy_to_group`` (identity,
the gradient all-reduced) and ``reduce_from_group`` (all-reduced, the
gradient as it is), ``all_gather(x, axis, group)`` (its backward sums the
gradient over the group and keeps the rank's slice) and ``ring_shift(x,
group)`` (its backward is the inverse shift). Gloo takes all-reduce on CUDA
tensors but not all-gather, send or receive: under gloo those stage a CUDA
tensor through host memory (counted in ``STAGED``); the compute stays on the
card. There is no counterpart of the JAX mesh's ``dcn`` axis: between nodes,
ranks are just ranks, and NCCL picks the transport. A rendezvous that fails
raises; the CUDA path never moves to gloo or to one rank by itself, and no
collective is caught and skipped.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist

# torch 2.13 renames all_gather_into_tensor (same arguments)
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _slurm_first_host(nodelist: str) -> str:
    """The first host of a SLURM node list: ``gpu[03-05,9],cpu1`` -> ``gpu03``."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist)
    if m is None:
        raise ValueError(f"cannot read the SLURM node list {nodelist!r}")
    prefix, ranges = m.group(1), m.group(2)
    return prefix + ranges.split(",")[0].split("-")[0] if ranges else prefix


def rendezvous_env(env=None) -> dict | None:
    """The rendezvous the environment names, first match wins, as the JAX
    package's ``multihost_init`` reads it; None when none is set.

      * ``JAX_COORDINATOR_ADDRESS`` (host:port) with ``JAX_NUM_PROCESSES``, else
        ``WORLD_SIZE``, and ``JAX_PROCESS_ID``, else ``RANK``;
      * ``MASTER_ADDR``, ``MASTER_PORT`` (default 29500), ``WORLD_SIZE`` and
        ``RANK``, what ``torchrun`` sets;
      * SLURM: ``SLURM_PROCID`` and ``SLURM_NTASKS``, the first host of the
        job's node list as the address (``MASTER_PORT``, else a port from the
        job id, as jax's SLURM cluster picks it).

    Returns {"addr", "world", "rank", "local_rank"}."""
    env = os.environ if env is None else env
    local = env.get("LOCAL_RANK")
    if env.get("JAX_COORDINATOR_ADDRESS"):
        addr = env["JAX_COORDINATOR_ADDRESS"]
        world = env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE")
        rank = env.get("JAX_PROCESS_ID") or env.get("RANK")
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        world, rank = env["WORLD_SIZE"], env.get("RANK")
    elif env.get("SLURM_PROCID") is not None and env.get("SLURM_NTASKS"):
        nodes = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_JOB_NODELIST") or "localhost"
        port = env.get("MASTER_PORT") or str(int(env.get("SLURM_JOB_ID", "0")) % 2 ** 12
                                             + 65535 - 2 ** 12 + 1)
        addr = f"{_slurm_first_host(nodes)}:{port}"
        world, rank = env["SLURM_NTASKS"], env["SLURM_PROCID"]
        local = local or env.get("SLURM_LOCALID")
    else:
        return None
    if world is None or rank is None:
        raise ValueError(f"the rendezvous at {addr} needs the world size and the rank")
    return {"addr": addr, "world": int(world), "rank": int(rank),
            "local_rank": int(local) if local is not None else 0}


def local_device(name: str | torch.device) -> torch.device:
    """``cuda`` under a launcher is ``cuda:$LOCAL_RANK`` (SLURM's
    ``SLURM_LOCALID``); an explicit index and ``cpu`` stay as they are."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        rv = rendezvous_env()
        if rv is not None:
            return torch.device("cuda", rv["local_rank"])
    return device


def multihost_init(device: str | torch.device = "cuda") -> bool:
    """Join the process group the environment names (``rendezvous_env``):
    NCCL for a CUDA ``device``, gloo for the CPU. Does nothing when no
    rendezvous is set or the group already exists. Returns whether a group
    is up. A rendezvous that fails raises."""
    if dist.is_initialized():
        return True
    rv = rendezvous_env()
    if rv is None:
        return False
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{rv['addr']}", world_size=rv["world"],
                            rank=rv["rank"])
    return True


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main() -> bool:
    return rank() == 0


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 only."""
    if is_main():
        print(*args, **kwargs)


def barrier() -> None:
    if is_distributed():
        dist.barrier()


# ---------------------------------------------------------------------------
# the 2-D layout
# ---------------------------------------------------------------------------

INNER_AXES = ("model", "stage", "seq")


@dataclass(frozen=True)
class Layout:
    """Rank d * n_inner + m of a (data, inner) grid: its place and its two
    groups (None for a group of one rank, which needs no collective)."""

    n_data: int
    n_inner: int
    inner: str
    data_rank: int
    inner_rank: int
    data_group: object
    inner_group: object

    @property
    def seq(self) -> bool:
        """Whether the inner axis splits the point axis (the batch statistics
        and the gradients then run over data x seq)."""
        return self.inner == "seq" and self.n_inner > 1


def make_layout(n_data: int, n_inner: int, inner: str = "model") -> Layout:
    """The (data, inner) layout of the world's ranks, as ``make_mesh`` shapes
    its devices: rank = d * n_inner + m. Every rank must call it (each group
    is made by every rank, in the same order)."""
    if inner not in INNER_AXES:
        raise ValueError(f"inner axis {inner!r} not in {INNER_AXES}")
    n = world_size()
    if n_data * n_inner != n:
        raise ValueError(f"a {n_data} x {n_inner} layout needs {n_data * n_inner} ranks, "
                         f"the world has {n}")
    d, m = divmod(rank(), n_inner)
    data_groups, inner_groups = [None] * n_inner, [None] * n_data
    if n > 1:
        # dist.new_group is collective over the world: every rank makes every group
        data_groups = [dist.new_group([dd * n_inner + mm for dd in range(n_data)])
                       for mm in range(n_inner)]
        inner_groups = [dist.new_group([dd * n_inner + mm for mm in range(n_inner)])
                        for dd in range(n_data)]
    return Layout(n_data, n_inner, inner, d, m,
                  data_groups[m] if n_data > 1 else None,
                  inner_groups[d] if n_inner > 1 else None)


_LAYOUT = contextvars.ContextVar("layout", default=None)


@contextlib.contextmanager
def using_layout(layout: Layout | None):
    """Within the block the data-parallel helpers work on ``layout``'s data
    group (data x seq under a ``seq`` layout)."""
    token = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(token)


def data_size() -> int:
    """The number of data-parallel ranks: the world with no layout."""
    layout = _LAYOUT.get()
    return world_size() if layout is None else layout.n_data


def data_rank() -> int:
    layout = _LAYOUT.get()
    return rank() if layout is None else layout.data_rank


def data_group():
    """The data axis's group (None: the world, or one rank under a layout)."""
    layout = _LAYOUT.get()
    return None if layout is None else layout.data_group


def batch_reduction() -> tuple[object, int]:
    """(group, ranks) over which the global batch's statistics and the
    gradients are summed: the data axis, or the whole world under a ``seq``
    layout, where each rank holds part of every cloud's points."""
    layout = _LAYOUT.get()
    if layout is not None and layout.seq:
        return None, world_size()
    return data_group(), data_size()


def batch_stats_reduction() -> tuple[object, int]:
    """(group, ranks) over which a train-mode BatchNorm sums its statistics:
    the data ranks in a split step, the whole world under a ``seq`` layout,
    (None, 1) where this rank holds the whole batch."""
    layout = _LAYOUT.get()
    if layout is not None and layout.seq:
        return None, world_size()
    parts = current_split()[0]
    return (data_group(), parts) if parts > 1 else (None, 1)


# ---------------------------------------------------------------------------
# the batch split
# ---------------------------------------------------------------------------

# (parts, this process's part) of the batch the running step computes on
_SPLIT = contextvars.ContextVar("data_split", default=(1, 0))


def current_split() -> tuple[int, int]:
    """(parts, index): the current step's batch is the index-th of ``parts``
    equal parts of the global batch; (1, 0) outside a split step."""
    return _SPLIT.get()


@contextlib.contextmanager
def data_split(parts: int, index: int | None = None):
    """Run the block as part ``index`` (default: this rank) of ``parts``."""
    token = _SPLIT.set((parts, data_rank() if index is None else index) if parts > 1 else (1, 0))
    try:
        yield
    finally:
        _SPLIT.reset(token)


def rank_columns(idx: torch.Tensor) -> tuple[torch.Tensor, int]:
    """An ``[S, B]`` index matrix -> (this rank's columns, parts).

    Data rank r of n takes columns ``r*B/n .. (r+1)*B/n`` and ``parts`` is n.
    Where B does not divide by n, every rank runs the whole matrix (``parts``
    1): the same sequence of collectives on every rank, correct but not
    parallel."""
    n = data_size()
    if n == 1:
        return idx, 1
    b = idx.shape[1]
    if b % n:
        warnings.warn(
            f"batch {b} not divisible by data-axis size {n}: "
            "running replicated (correct but not data-parallel). Use a batch "
            "that is a multiple of the device count for full throughput.")
        return idx, 1
    per = b // n
    r = data_rank()
    return idx[:, r * per:(r + 1) * per], n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    """The ranks of ``group`` (None: the world)."""
    return dist.get_world_size(group) if is_distributed() else 1


def group_rank(group) -> int:
    return dist.get_rank(group) if is_distributed() else 0


# host staging of the collectives gloo does not take on CUDA tensors
STAGED = {"calls": 0, "bytes": 0}


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a CUDA tensor's all-gather or send goes through host memory:
    gloo reduces CUDA tensors but neither gathers nor sends them."""
    if not x.is_cuda or dist.get_backend(group) != "gloo":
        return False
    STAGED["calls"] += 1
    STAGED["bytes"] += x.numel() * x.element_size()
    return True


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x; the gradient of x is the sum over the group
    of the gradient of y (every rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (None: the world), differentiable;
    ``x`` itself on a group of one rank."""
    return _AllReduceSum.apply(x, group) if group_size(group) > 1 else x


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward, the gradient as it is (every rank of
    the group computes the same loss from the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient all-reduced (each rank's
    branch saw only its shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """A partial sum of a tensor-parallel branch, summed over ``group``."""
    return _ReduceFromGroup.apply(x, group) if group_size(group) > 1 else x


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a tensor-parallel branch: its gradient summed over ``group``."""
    return _CopyToGroup.apply(x, group) if group_size(group) > 1 else x


def gather_along(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``axis`` in
    group-rank order; no gradient."""
    n = group_size(group)
    if n == 1:
        return x
    moved = x.movedim(axis, 0).contiguous()
    if _staged(moved, group):
        host = moved.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        full = torch.cat(parts).to(x.device)
    else:
        full = moved.new_empty((n * moved.shape[0], *moved.shape[1:]))
        _all_gather_into(full, moved, group=group)
    return full.movedim(0, axis)


class _AllGather(torch.autograd.Function):
    """y = every rank's x along ``axis``; the gradient of x is the sum over the
    group of the gradient of y, this rank's slice."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group, ctx.local = axis, group, x.shape[axis]
        return gather_along(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.axis, r * ctx.local, ctx.local).contiguous(), None, None


def all_gather(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order,
    differentiable; ``x`` itself on a group of one rank."""
    return _AllGather.apply(x, axis, group) if group_size(group) > 1 else x


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """Send ``x`` to group rank r + offset and receive from r - offset (mod n)."""
    n, r = group_size(group), group_rank(group)
    peer = (lambda i: dist.get_global_rank(group, i)) if group is not None else (lambda i: i)
    send = x.contiguous()
    staged = _staged(send, group)
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, peer((r + offset) % n), group),
           dist.P2POp(dist.irecv, recv, peer((r - offset) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv


class _RingShift(torch.autograd.Function):
    """One hop round the ring: rank r's x goes to rank r + 1 (mod n), as the
    JAX pipeline's ``ppermute``; the gradient goes one hop back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of group rank r - 1 (mod n) on rank r, differentiable."""
    return _RingShift.apply(x, group) if group_size(group) > 1 else x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data ranks, a new tensor (no gradient)."""
    x = x.detach().clone()
    if is_distributed() and data_size() > 1:
        dist.all_reduce(x, group=data_group())
        x.div_(data_size())
    return x


def average_gradients(grads: list[torch.Tensor | None],
                      params: list[torch.Tensor]) -> list[torch.Tensor]:
    """The gradients averaged over the batch's ranks (the data axis, or data x
    seq, ``batch_reduction``): one flat bucket (None a zero), one all-reduce;
    two where some leaves are split over model ranks. Returns views of the
    buckets shaped as ``params``."""
    group, n = batch_reduction()
    # the leaves split over model ranks (parallel/tp.py) in a bucket of their
    # own: the whole leaves' bucket is then of one length on every model rank,
    # so its sums run in one order and the whole leaves stay equal there
    split = [getattr(p, "tp_split", False) for p in params]
    out = [None] * len(params)
    for kind in sorted(set(split)):
        ids = [i for i, s in enumerate(split) if s == kind]
        flat = torch.cat([(grads[i] if grads[i] is not None else torch.zeros_like(params[i]))
                          .reshape(-1) for i in ids])
        if n > 1:
            dist.all_reduce(flat, group=group)
            flat.div_(n)
        for i, part in zip(ids, flat.split([params[i].numel() for i in ids])):
            out[i] = part.view(params[i].shape)
    return out


def all_gather_flat(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's 1-D ``x`` (all of one length) laid end to end in rank order."""
    if data_size() == 1:
        return x.clone()
    return gather_along(x.contiguous(), 0, data_group()).clone()


def fetch_global(x: torch.Tensor, parts: int, axis: int = 1) -> torch.Tensor:
    """A result computed on this rank's part of the batch (``parts`` from
    ``rank_columns``; the batch along ``axis``) -> the whole batch's, every
    rank's part in rank order, on every rank; ``x`` itself when the batch was
    not split."""
    if parts == 1:
        return x
    moved = x.movedim(axis, 0).contiguous()
    full = all_gather_flat(moved.reshape(-1)).view(parts * moved.shape[0], *moved.shape[1:])
    return full.movedim(0, axis)
