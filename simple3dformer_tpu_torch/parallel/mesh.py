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
size 1 on the same global batch, to within reduction order. There is no
counterpart of the JAX mesh's ``model`` axis (tensor parallelism) nor of its
``dcn`` axis: between nodes, ranks are just ranks, and NCCL picks the
transport. A rendezvous that fails raises; the CUDA path never moves to gloo
or to one rank by itself, and no collective is caught and skipped.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import warnings

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
    token = _SPLIT.set((parts, rank() if index is None else index) if parts > 1 else (1, 0))
    try:
        yield
    finally:
        _SPLIT.reset(token)


def rank_columns(idx: torch.Tensor) -> tuple[torch.Tensor, int]:
    """An ``[S, B]`` index matrix -> (this rank's columns, parts).

    Rank r takes columns ``r*B/n .. (r+1)*B/n`` and ``parts`` is n. Where B
    does not divide by n, every rank runs the whole matrix (``parts`` 1): the
    same sequence of collectives on every rank, correct but not parallel."""
    n = world_size()
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
    r = rank()
    return idx[:, r * per:(r + 1) * per], n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of x is the sum over ranks of the
    gradient of y (every rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable; ``x`` at world 1."""
    return _AllReduceSum.apply(x) if is_distributed() else x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, a new tensor (no gradient)."""
    x = x.detach().clone()
    if is_distributed():
        dist.all_reduce(x)
        x.div_(dist.get_world_size())
    return x


def average_gradients(grads: list[torch.Tensor | None],
                      params: list[torch.Tensor]) -> list[torch.Tensor]:
    """The gradients averaged over the ranks: one flat bucket (None a zero),
    one all-reduce. Returns views of the bucket shaped as ``params``."""
    flat = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                      for g, p in zip(grads, params)])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    return [part.view(p.shape) for part, p in zip(flat.split([p.numel() for p in params]),
                                                  params)]


def all_gather_flat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D ``x`` (all of one length) laid end to end in rank order."""
    n = world_size()
    if n == 1:
        return x.clone()
    out = x.new_empty(n * x.numel())
    _all_gather_into(out, x.contiguous())
    return out


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
