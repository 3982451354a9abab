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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

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
    """Mean CE in f32; with weights, torch's weighted-mean convention."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if class_weights is None:
        return ce.mean()
    w = class_weights[labels.long()]
    return (w * ce).sum() / w.sum()


def seg_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-point CE over [B, N, C] logits and [B, N] labels, mean in f32."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.long().reshape(-1))


def make_train_step(state: TrainState, loss_fn: Callable = cross_entropy,
                    class_weights: torch.Tensor | None = None,
                    prepare_fn: Callable | None = None, augment_fn: Callable | None = None,
                    x_dtype: torch.dtype = torch.float32):
    """(batch, lr) -> metrics: one optimizer step, in place.

    ``batch`` is {'x', 'y'}, or whatever ``prepare_fn`` turns into (x, y).
    The model runs in train mode. Metrics are 0-dim device tensors (loss,
    accuracy); reading them is the caller's choice.
    """
    model, opt = state.model, state.optimizer
    names = [k for k in opt.names if opt.params[k].requires_grad]
    params = [opt.params[k] for k in names]

    def step(batch: dict, lr: float) -> dict:
        model.train()
        x, y = prepare_fn(batch) if prepare_fn is not None else (batch["x"], batch["y"])
        x = x.to(x_dtype)
        if augment_fn is not None:
            x = augment_fn(x)
        logits = model(x)
        loss = loss_fn(logits, y) if class_weights is None else loss_fn(logits, y, class_weights)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        opt.step(dict(zip(names, grads)), lr)
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_scanned_train_steps(state: TrainState, dataset, loss_fn: Callable = cross_entropy,
                             class_weights: torch.Tensor | None = None,
                             augment_fn: Callable | None = None,
                             prepare_fn: Callable | None = None, x_key: str = "x",
                             y_key: str = "y", x_dtype: torch.dtype = torch.float32):
    """(idx [S, B] on the device, lr) -> metrics {name: [S] device tensor}.

    One train step per row of ``idx``, each batch gathered on the device from
    ``dataset`` (data/pipeline.DeviceResidentDataset).
    """
    if prepare_fn is None:
        def prepare_fn(batch):
            return batch[x_key], batch[y_key]
    step = make_train_step(state, loss_fn, class_weights, prepare_fn, augment_fn, x_dtype)

    def run(idx_matrix: torch.Tensor, lr: float) -> dict:
        s = idx_matrix.shape[0]
        metrics = {k: torch.empty(s, device=idx_matrix.device) for k in ("loss", "accuracy")}
        for i in range(s):
            out = step(dataset.gather(idx_matrix[i]), lr)
            for k, v in out.items():
                metrics[k][i] = v
        return metrics

    return run


def make_scanned_eval(model: nn.Module, dataset, prepare_fn: Callable | None = None,
                      x_key: str = "x", x_dtype: torch.dtype = torch.float32):
    """(idx [S, B] on the device) -> logits [S, B, ...]: the model in eval mode
    over every row, under inference mode (the serving kernels on the card).
    ``prepare_fn(batch) -> (x, y)`` builds the input, as in training."""

    def inputs(batch):
        x = prepare_fn(batch)[0] if prepare_fn is not None else batch[x_key]
        return x.to(x_dtype)

    def run(idx_matrix: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return torch.stack([model(inputs(dataset.gather(idx))) for idx in idx_matrix])

    return run


def make_eval_step(model: nn.Module):
    """(x) -> logits, the model in eval mode under inference mode."""

    def call(x: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(x)

    return call
