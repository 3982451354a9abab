"""Optimizer and learning-rate schedules (port of simple3dformer_tpu/train/optim.py).

Recipes replicated:
  * Adam(lr) + StepLR(step_size, gamma) stepped per epoch + UntunedLinearWarmup
    dampening applied per epoch (the reference's train_cls_voxel.py:195-198,
    293-294): pytorch_warmup's warmup period is int(2 / (1 - beta2)) and the
    factor min(1, (epoch + 1) / period).
  * torch.optim.Adam(weight_decay) semantics: L2 added to the gradient before
    Adam (not AdamW), as the JAX package chains add_decayed_weights first.
  * SGD with momentum 0.9 = optax.trace(decay=0.9, nesterov=False): the
    buffer t' = g + 0.9 t, the parameter p' = p + (-lr) t' (plain PyTorch:
    there is no TPU kernel for it), without weight decay as the recipes run it.
  * Frozen parameters (the 2D pathway when 2D-pretrained weights are loaded)
    get no update and carry no optimizer state.

The learning rate is not part of the optimizer: each step takes it, and the
host loop recomputes it per epoch exactly like the torch schedulers.
"""

from __future__ import annotations

import torch

from ..kernels.adam import B1, B2, EPS, bias_correction_tensors, fused_adam

MOMENTUM = 0.9  # SGD's, as the partseg and semseg recipes set it

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


def scale_by_adam_bf16_nu(m: torch.Tensor, v: torch.Tensor, g: torch.Tensor, count: int,
                          b1: float = B1, b2: float = B2, eps: float = EPS) -> torch.Tensor:
    """Adam's direction with the second moment stored in bfloat16 (plain
    PyTorch, as the JAX package's scale_by_adam_bf16_nu is plain jnp): updates
    the f32 ``m`` and the bf16 ``v`` in place from ``g`` and returns
    m_hat / (sqrt(v_hat) + eps) in f32. Elementwise, so one call serves every
    leaf laid end to end.

    The sums run in f32; nu is rounded to bfloat16 each step, so update
    directions deviate from f32 Adam in about the third decimal digit.
    """
    bc1, bc2 = bias_correction_tensors(count, m.device, b1, b2)
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_((b2 * v.float() + (1 - b2) * g * g).to(torch.bfloat16))
    return (m / bc1) / (torch.sqrt(v.float() / bc2) + eps)


class Adam:
    """Adam over named parameters, with a trainable mask and L2 weight decay.

    ``params``: name -> parameter (``dict(model.named_parameters())``).
    ``trainable``: name -> bool (None: all); False leaves are never touched
    and hold no moments. ``step(grads, lr)`` takes name -> gradient (None for
    a parameter the loss does not reach, a zero gradient) and updates every
    trainable f32 leaf with one launch of the Adam kernel on the card
    (kernels/adam.fused_adam). With ``bf16_nu`` it runs the plain
    ``scale_by_adam_bf16_nu`` instead, once over all leaves: the moments are
    views into one f32 and one bf16 buffer, and the gradients are laid end to
    end in the same order, so a step makes a few dozen launches, not a dozen
    a leaf.
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
        if bf16_nu:
            self.sizes = [self.params[k].numel() for k in self.names]
            device = self.params[self.names[0]].device if self.names else None
            self.flat_mu = torch.zeros(sum(self.sizes), device=device)
            self.flat_nu = torch.zeros(sum(self.sizes), dtype=torch.bfloat16, device=device)
            self.mu = self._leaves(self.flat_mu)
            self.nu = self._leaves(self.flat_nu)
        else:
            self.mu = {k: torch.zeros_like(self.params[k]) for k in self.names}
            self.nu = {k: torch.zeros_like(self.params[k]) for k in self.names}

    def _leaves(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """``flat`` cut into views shaped as the trainable leaves, in order."""
        return {k: part.view(self.params[k].shape)
                for k, part in zip(self.names, flat.split(self.sizes))}

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor | None], lr: float) -> None:
        self.count += 1
        if self.bf16_nu:
            if self.names:
                params = [self.params[k] for k in self.names]
                g = torch.cat([(grads[k] if grads.get(k) is not None else torch.zeros_like(p))
                               .reshape(-1) for k, p in zip(self.names, params)])
                if self.weight_decay:
                    g = g + self.weight_decay * torch.cat([p.reshape(-1) for p in params])
                step = -lr * scale_by_adam_bf16_nu(self.flat_mu, self.flat_nu, g, self.count,
                                                   self.b1, self.b2, self.eps)
                torch._foreach_add_(params, list(self._leaves(step).values()))
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


class SGD:
    """SGD with (heavy-ball) momentum ``MOMENTUM`` over named parameters, with
    a trainable mask; the interface of ``Adam``.

    Each f32 operation is one rounding, in optax's order (the buffer
    g + momentum t, then p + (-lr) t), so the updates equal the JAX
    package's. ``step`` runs PyTorch's multi-tensor ops over all leaves.
    """

    def __init__(self, params: dict[str, torch.Tensor], trainable: dict[str, bool] | None = None):
        self.params = dict(params)
        trainable = trainable or {}
        self.names = [k for k in self.params if trainable.get(k, True)]
        self.count = 0
        self.trace = {k: torch.zeros_like(self.params[k]) for k in self.names}

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor | None], lr: float) -> None:
        self.count += 1
        params = [self.params[k] for k in self.names]
        bufs = [self.trace[k] for k in self.names]
        torch._foreach_mul_(bufs, MOMENTUM)
        # a parameter the loss does not reach has a zero gradient
        reached = [(self.trace[k], grads[k]) for k in self.names if grads.get(k) is not None]
        if reached:
            torch._foreach_add_([b for b, _ in reached], [g for _, g in reached])
        torch._foreach_add_(params, torch._foreach_mul(bufs, -lr))

    def state_dict(self) -> dict:
        return {"count": self.count, "trace": dict(self.trace)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if set(state["trace"]) != set(self.names):
            raise KeyError("optimizer state holds other leaves than the trainable ones")
        self.count = int(state["count"])
        for k in self.names:
            self.trace[k].copy_(state["trace"][k])


def make_optimizer(params: dict[str, torch.Tensor], optimizer: str = "Adam",
                   weight_decay: float = 0.0, trainable_mask: dict[str, bool] | None = None,
                   bf16_nu: bool = False, zero1: bool = False) -> Adam | SGD:
    """The optimizer of the recipes. ``trainable_mask``: name -> bool (True =
    trainable); False leaves receive no update and carry no optimizer state.
    SGD runs without weight decay, as every recipe that uses it does.

    ``bf16_nu``: store Adam's second moment in bfloat16 (off by default: the
    contract is torch.optim.Adam's f32 state). ``zero1``: Adam's moments
    split over the data-parallel ranks (parallel/zero.Zero1Adam, whose
    ``state_dict`` gathers the full moments and ``load_state_dict`` takes
    this rank's part, so its checkpoints are this class's).
    """
    name = optimizer.lower()
    if zero1 and name != "adam":
        raise NotImplementedError("ZeRO-1 splits Adam's moments; no recipe shards SGD's")
    if name == "adam":
        if zero1:
            from ..parallel.zero import Zero1Adam

            return Zero1Adam(params, trainable_mask, weight_decay, bf16_nu=bf16_nu)
        return Adam(params, trainable_mask, weight_decay, bf16_nu=bf16_nu)
    if name == "sgd":
        if weight_decay:
            raise NotImplementedError("SGD with weight decay: no recipe of the port uses it")
        return SGD(params, trainable_mask)
    raise ValueError(f"Unknown optimizer {optimizer!r}")
