"""Train and eval steps (port of simple3dformer_tpu/train/loop.py).

The JAX package jits (state, batch, lr) -> (state, metrics) and scans whole
epochs in one dispatch. Here the state is the model's parameters and the
optimizer (moments and step count), updated in place. A train step runs the
model in train mode (every ViT block one call of the training kernels on the
card), takes the gradients with autograd, and applies one Adam update (one
kernel launch). ``make_scanned_train_steps`` is a Python loop over an epoch's
index matrix that is already on the device: each batch is an on-device
gather, and the per-step metrics stay on the device and are fetched once per
epoch, as the JAX loop fetches its scan's, so no step waits for the host.

Losses: classification cross-entropy, optionally class-weighted like torch
F.cross_entropy(weight=...) (the reference's train_cls_voxel.py:253-256).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .optim import Adam


@dataclass
class TrainState:
    """What a checkpoint holds: the model's parameters, the optimizer, the step."""

    model: nn.Module
    optimizer: Adam

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


def make_train_step(state: TrainState, loss_fn: Callable = cross_entropy,
                    class_weights: torch.Tensor | None = None):
    """(batch, lr) -> metrics: one optimizer step on batch {'x', 'y'}, in place.

    The model runs in train mode. Metrics are 0-dim device tensors (loss,
    accuracy); reading them is the caller's choice.
    """
    model, opt = state.model, state.optimizer
    names = [k for k in opt.names if opt.params[k].requires_grad]
    params = [opt.params[k] for k in names]

    def step(batch: dict, lr: float) -> dict:
        model.train()
        x, y = batch["x"], batch["y"]
        logits = model(x)
        loss = loss_fn(logits, y) if class_weights is None else loss_fn(logits, y, class_weights)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        opt.step(dict(zip(names, grads)), lr)
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_scanned_train_steps(state: TrainState, dataset, loss_fn: Callable = cross_entropy,
                             class_weights: torch.Tensor | None = None, x_key: str = "x",
                             y_key: str = "y", x_dtype: torch.dtype = torch.float32):
    """(idx [S, B] on the device, lr) -> metrics {name: [S] device tensor}.

    One train step per row of ``idx``, each batch gathered on the device from
    ``dataset`` (data/pipeline.DeviceResidentDataset).
    """
    step = make_train_step(state, loss_fn, class_weights)

    def run(idx_matrix: torch.Tensor, lr: float) -> dict:
        s = idx_matrix.shape[0]
        metrics = {k: torch.empty(s, device=idx_matrix.device) for k in ("loss", "accuracy")}
        for i in range(s):
            batch = dataset.gather(idx_matrix[i])
            out = step({"x": batch[x_key].to(x_dtype), "y": batch[y_key]}, lr)
            for k, v in out.items():
                metrics[k][i] = v
        return metrics

    return run


def make_scanned_eval(model: nn.Module, dataset, x_key: str = "x",
                      x_dtype: torch.dtype = torch.float32):
    """(idx [S, B] on the device) -> logits [S, B, ...]: the model in eval mode
    over every row, under inference mode (the serving kernels on the card)."""

    def run(idx_matrix: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return torch.stack([model(dataset.gather(idx)[x_key].to(x_dtype))
                                for idx in idx_matrix])

    return run


def make_eval_step(model: nn.Module):
    """(x) -> logits, the model in eval mode under inference mode."""

    def call(x: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(x)

    return call
