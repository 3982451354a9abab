"""Checkpoint / resume over torch.save (port of simple3dformer_tpu/core/checkpoint.py).

The same API as the JAX package's orbax Checkpointer: ``save(step, state,
metrics)``, ``latest_step()``, ``restore()`` and ``max_to_keep``. A state is
whatever ``torch.save`` stores and ``torch.load(weights_only=True)`` reads
back: nested dicts and lists of tensors and plain numbers, such as
``{"params": model.state_dict(), "step": 3}``, or a train state's
``state_dict()`` (parameters, optimizer moments and step), which
``restore_into`` loads back into a live train state. Each step is a directory
``<directory>/<step>/`` holding ``state.pt`` and ``metrics.json``, written
under a temporary name and renamed into place, so a reader never sees half
a checkpoint.

Under data parallelism (parallel/mesh.py) every rank calls ``save`` with
the same state (a ZeRO-1 optimizer gathers its full moments there); rank 0
writes it and the other ranks wait at a barrier, so a restore that follows
reads the finished step on every rank.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from ..parallel.mesh import barrier, is_main


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, metrics: dict | None = None) -> None:
        if is_main():
            self._write(step, state, metrics)
        barrier()

    def _write(self, step: int, state: Any, metrics: dict | None) -> None:
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".{int(step)}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump(metrics or {}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def restore(self, step: int | None = None, map_location="cpu"):
        """Restore (state, metrics); returns (None, None) if nothing saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, str(int(step)))
        state = torch.load(os.path.join(path, "state.pt"), map_location=map_location,
                           weights_only=True)
        with open(os.path.join(path, "metrics.json")) as f:
            metrics = json.load(f)
        return state, metrics

    def restore_into(self, target, step: int | None = None):
        """Load a saved step into ``target`` (anything with ``load_state_dict``,
        such as train.loop.TrainState); returns (target, metrics), or
        (None, None) if nothing is saved."""
        state, metrics = self.restore(step)
        if state is None:
            return None, None
        target.load_state_dict(state)
        return target, metrics


def save_params(path: str, params: dict) -> None:
    """One-shot parameter snapshot (a state dict), written atomically."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(params, tmp)
    os.replace(tmp, path)


def load_params(path: str, map_location="cpu") -> dict:
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
