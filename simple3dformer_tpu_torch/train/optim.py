"""Optimizer and learning-rate schedules (port of simple3dformer_tpu/train/optim.py).

Recipes replicated:
  * Adam(lr) + StepLR(step_size, gamma) stepped per epoch + UntunedLinearWarmup
    dampening applied per epoch (the reference's train_cls_voxel.py:195-198,
    293-294): pytorch_warmup's warmup period is int(2 / (1 - beta2)) and the
    factor min(1, (epoch + 1) / period).
  * torch.optim.Adam(weight_decay) semantics: L2 added to the gradient before
    Adam (not AdamW), as the JAX package chains add_decayed_weights first.
  * Frozen parameters (the 2D pathway when 2D-pretrained weights are loaded)
    get no update and carry no optimizer state.

The learning rate is not part of the optimizer: each step takes it, and the
host loop recomputes it per epoch exactly like the torch schedulers.
"""

from __future__ import annotations

import torch

from ..kernels.adam import B1, B2, EPS, bias_corrections, fused_adam


def steplr(base_lr: float, step_size: float, gamma: float, epoch: int) -> float:
    """torch StepLR: lr * gamma ** floor(epoch / step_size)."""
    return base_lr * (gamma ** (epoch // int(step_size)))


def untuned_linear_warmup_factor(epoch: int, beta2: float = 0.999) -> float:
    """pytorch_warmup.UntunedLinearWarmup factor after `epoch` dampen calls."""
    period = int(2.0 / (1.0 - beta2))
    return min(1.0, (epoch + 1) / period)


def epoch_lr(base_lr: float, epoch: int, step_size: float = 20, gamma: float = 0.5,
             warmup: bool = False, beta2: float = 0.999) -> float:
    lr = steplr(base_lr, step_size, gamma, epoch)
    if warmup:
        lr *= untuned_linear_warmup_factor(epoch, beta2)
    return lr


def scale_by_adam_bf16_nu(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                          g: torch.Tensor | None, lr: float, count: int, b1: float = B1,
                          b2: float = B2, eps: float = EPS, weight_decay: float = 0.0) -> None:
    """Adam with the second moment stored in bfloat16, one leaf, in place (plain
    PyTorch, as the JAX package's scale_by_adam_bf16_nu is plain jnp).

    The sums run in f32; nu is rounded to bfloat16 each step, so update
    directions deviate from f32 Adam in about the third decimal digit.
    """
    if g is None:
        g = torch.zeros_like(p)
    if weight_decay:
        g = g + weight_decay * p
    bc1, bc2 = (torch.tensor(bc, dtype=torch.float32, device=p.device)
                for bc in bias_corrections(count, b1, b2))
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_((b2 * v.float() + (1 - b2) * g * g).to(torch.bfloat16))
    update = (m / bc1) / (torch.sqrt(v.float() / bc2) + eps)
    p.add_(-lr * update)


class Adam:
    """Adam over named parameters, with a trainable mask and L2 weight decay.

    ``params``: name -> parameter (``dict(model.named_parameters())``).
    ``trainable``: name -> bool (None: all); False leaves are never touched
    and hold no moments. ``step(grads, lr)`` takes name -> gradient (None for
    a parameter the loss does not reach, a zero gradient) and updates every
    trainable f32 leaf with one launch of the Adam kernel on the card
    (kernels/adam.fused_adam); with ``bf16_nu`` it runs the plain
    ``scale_by_adam_bf16_nu`` instead.
    """

    def __init__(self, params: dict[str, torch.Tensor], trainable: dict[str, bool] | None = None,
                 weight_decay: float = 0.0, b1: float = B1, b2: float = B2, eps: float = EPS,
                 bf16_nu: bool = False):
        self.params = dict(params)
        trainable = trainable or {}
        self.names = [k for k in self.params if trainable.get(k, True)]
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.bf16_nu = bf16_nu
        for k in self.names:
            if self.params[k].dtype != torch.float32:
                raise TypeError(f"parameter {k} is {self.params[k].dtype}; Adam takes f32")
        self.count = 0
        self.mu = {k: torch.zeros_like(self.params[k]) for k in self.names}
        nu_dtype = torch.bfloat16 if bf16_nu else torch.float32
        self.nu = {k: torch.zeros_like(self.params[k], dtype=nu_dtype) for k in self.names}

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor | None], lr: float) -> None:
        self.count += 1
        if self.bf16_nu:
            for k in self.names:
                scale_by_adam_bf16_nu(self.params[k], self.mu[k], self.nu[k], grads.get(k), lr,
                                      self.count, self.b1, self.b2, self.eps, self.weight_decay)
            return
        fused_adam([(self.params[k], self.mu[k], self.nu[k], grads.get(k)) for k in self.names],
                   lr, self.count, self.b1, self.b2, self.eps, self.weight_decay)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.names):
            raise KeyError("optimizer state holds other leaves than the trainable ones")
        self.count = int(state["count"])
        for k in self.names:
            self.mu[k].copy_(state["mu"][k])
            self.nu[k].copy_(state["nu"][k])


def make_optimizer(params: dict[str, torch.Tensor], optimizer: str = "Adam",
                   weight_decay: float = 0.0, trainable_mask: dict[str, bool] | None = None,
                   bf16_nu: bool = False) -> Adam:
    """The optimizer of the recipes. ``trainable_mask``: name -> bool (True =
    trainable); False leaves receive no update and carry no optimizer state.

    ``bf16_nu``: store Adam's second moment in bfloat16 (off by default: the
    contract is torch.optim.Adam's f32 state).
    """
    name = optimizer.lower()
    if name == "adam":
        return Adam(params, trainable_mask, weight_decay, bf16_nu=bf16_nu)
    if name == "sgd":
        raise NotImplementedError("SGD (momentum 0.9) is not ported yet: it comes with the "
                                  "point-cloud classification slice (train_cls)")
    raise ValueError(f"Unknown optimizer {optimizer!r}")
