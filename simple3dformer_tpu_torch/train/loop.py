"""Train and eval steps (port of simple3dformer_tpu/train/loop.py).

The JAX package jits (state, batch, lr) -> (state, metrics) and scans whole
epochs in one dispatch. Here the state is the model's parameters and the
optimizer (moments and step count), updated in place. A train step runs the
model in train mode (every ViT block one call of the training kernels on the
card), takes the gradients with autograd, and applies one optimizer update
(Adam: one kernel launch; SGD with momentum: plain PyTorch). BatchNorm
running statistics are buffers of the model, updated by its train-mode
forward, and part of the state a checkpoint holds. ``make_scanned_train_steps`` is a Python loop over an epoch's
index matrix that is already on the device: each batch is an on-device
gather, and the per-step metrics stay on the device and are fetched once per
epoch, as the JAX loop fetches its scan's, so no step waits for the host.

Losses: classification cross-entropy, optionally class-weighted like torch
F.cross_entropy(weight=...) (the reference's train_cls_voxel.py:253-256), and
per-point segmentation cross-entropy (train_partseg.py:165).

``prepare_fn(batch) -> (x, y)`` builds the model's input from a gathered
batch (partseg concatenates the category one-hot), and ``augment_fn(x)``
augments it inside the step, as the JAX loop's hooks do (loop.py:189-200);
an augmentation draws from its own ``torch.Generator``, so its numbers are
not the JAX package's.

Data parallelism (parallel/mesh.py), as the JAX loop's global-batch step
under GSPMD: with a process group up, the scanned runners take this rank's
columns of the index matrix and run each step under ``data_split``, so the
draws, the BatchNorm statistics and the class-weighted loss are the global
batch's; the gradients are averaged over the ranks in one flat bucket before
the update, and the metrics are averaged over the ranks once an epoch. The
eval runs this rank's rows and all-gathers the logits, so every rank sees the
whole batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import (all_reduce_mean, all_reduce_sum, average_gradients,
                             current_split, data_group, data_split, fetch_global,
                             is_distributed, rank_columns)
from .optim import SGD, Adam


@dataclass
class TrainState:
    """What a checkpoint holds: the model's parameters and buffers (BatchNorm
    statistics), the optimizer, the step."""

    model: nn.Module
    optimizer: Adam | SGD

    @property
    def step(self) -> int:
        return self.optimizer.count

    def state_dict(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE in f32; with weights, torch's weighted-mean convention.

    In a split step (parallel/mesh.data_split over n parts) the weighted mean
    is the global batch's sum(w * ce) / sum(w): the denominator is summed over
    the ranks and the rank's share scaled by n, so the mean over the ranks of
    this loss (and of its gradient) is the global one. A mean of per-rank
    weighted means would weigh each rank alike."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if class_weights is None:
        return ce.mean()
    w = class_weights[labels.long()]
    parts = current_split()[0]
    if parts > 1:
        return (w * ce).sum() * parts / all_reduce_sum(w.sum().detach(), data_group())
    return (w * ce).sum() / w.sum()


def seg_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-point CE over [B, N, C] logits and [B, N] labels, mean in f32."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.long().reshape(-1))


def trainable(opt) -> tuple[list[str], list[torch.Tensor]]:
    """The optimizer's leaves that take a gradient: (names, parameters)."""
    names = [k for k in opt.names if opt.params[k].requires_grad]
    return names, [opt.params[k] for k in names]


def apply_update(opt, names: list[str], params: list[torch.Tensor], grads, lr: float) -> None:
    """One optimizer update from this rank's gradients: averaged over the
    ranks first (one flat bucket) when a process group is up."""
    if is_distributed():
        grads = average_gradients(list(grads), params)
    opt.step(dict(zip(names, grads)), lr)


def make_train_step(state: TrainState, loss_fn: Callable = cross_entropy,
                    class_weights: torch.Tensor | None = None,
                    prepare_fn: Callable | None = None, augment_fn: Callable | None = None,
                    x_dtype: torch.dtype = torch.float32):
    """(batch, lr) -> metrics: one optimizer step, in place.

    ``batch`` is {'x', 'y'}, or whatever ``prepare_fn`` turns into (x, y).
    The model runs in train mode. Metrics are 0-dim device tensors (loss,
    accuracy) of this rank's batch; reading them is the caller's choice.
    With a process group up the gradients are averaged over the ranks; the
    caller that split the batch runs the step under ``data_split``.
    """
    model, opt = state.model, state.optimizer
    names, params = trainable(opt)

    def step(batch: dict, lr: float) -> dict:
        model.train()
        x, y = prepare_fn(batch) if prepare_fn is not None else (batch["x"], batch["y"])
        x = x.to(x_dtype)
        if augment_fn is not None:
            x = augment_fn(x)
        logits = model(x)
        loss = loss_fn(logits, y) if class_weights is None else loss_fn(logits, y, class_weights)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        apply_update(opt, names, params, grads, lr)
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def run_rows(step: Callable, idx_matrix: torch.Tensor, keys, gather) -> dict:
    """``step(*gather(row))`` for each row of this rank's columns of
    ``idx_matrix``, under the batch's split; returns {key: [S] device tensor}
    of the steps' metrics, averaged over the ranks (one all-reduce)."""
    idx_matrix, parts = rank_columns(idx_matrix)
    s = idx_matrix.shape[0]
    metrics = torch.empty(len(keys), s, device=idx_matrix.device)
    with data_split(parts):
        for i in range(s):
            out = step(*gather(idx_matrix[i]))
            for j, k in enumerate(keys):
                metrics[j, i] = out[k]
    if is_distributed():
        metrics = all_reduce_mean(metrics)
    return dict(zip(keys, metrics))


def make_scanned_train_steps(state: TrainState, dataset, loss_fn: Callable = cross_entropy,
                             class_weights: torch.Tensor | None = None,
                             augment_fn: Callable | None = None,
                             prepare_fn: Callable | None = None, x_key: str = "x",
                             y_key: str = "y", x_dtype: torch.dtype = torch.float32):
    """(idx [S, B] on the device, lr) -> metrics {name: [S] device tensor}.

    One train step per row of ``idx``, each batch gathered on the device from
    ``dataset`` (data/pipeline.DeviceResidentDataset): with a process group
    up, this rank's columns of the row (parallel/mesh.rank_columns).
    """
    if prepare_fn is None:
        def prepare_fn(batch):
            return batch[x_key], batch[y_key]
    step = make_train_step(state, loss_fn, class_weights, prepare_fn, augment_fn, x_dtype)

    def run(idx_matrix: torch.Tensor, lr: float) -> dict:
        return run_rows(lambda batch: step(batch, lr), idx_matrix, ("loss", "accuracy"),
                        lambda idx: (dataset.gather(idx),))

    return run


def make_scanned_eval(model: nn.Module, dataset, prepare_fn: Callable | None = None,
                      x_key: str = "x", x_dtype: torch.dtype = torch.float32):
    """(idx [S, B] on the device) -> logits [S, B, ...]: the model in eval mode
    over every row, under inference mode (the serving kernels on the card).
    ``prepare_fn(batch) -> (x, y)`` builds the input, as in training. With a
    process group up each rank runs its columns and the logits are
    all-gathered, so every rank returns the whole batch's."""

    def inputs(batch):
        x = prepare_fn(batch)[0] if prepare_fn is not None else batch[x_key]
        return x.to(x_dtype)

    def run(idx_matrix: torch.Tensor) -> torch.Tensor:
        model.eval()
        idx_matrix, parts = rank_columns(idx_matrix)
        with torch.inference_mode():
            logits = torch.stack([model(inputs(dataset.gather(idx))) for idx in idx_matrix])
            return fetch_global(logits, parts)

    return run


def make_eval_step(model: nn.Module):
    """(x) -> logits, the model in eval mode under inference mode."""

    def call(x: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(x)

    return call
