"""ZeRO-1: Adam's moments split over the data-parallel ranks (port of
simple3dformer_tpu/parallel/zero.py; Rajbhandari et al., arXiv:1910.02054,
stage 1).

The JAX package marks each moment leaf as sharded over the ``data`` axis on
its first axis that divides, and GSPMD derives the collectives. Here the
partition is the port's own: the trainable parameters laid end to end in the
optimizer's order form one flat range of T elements, and rank r keeps the
moments of the contiguous part ``r*ceil(T/n) .. (r+1)*ceil(T/n)`` (the last
part shorter or empty). A step updates that part of every parameter from the
gradient all-reduced over the ranks (train/loop.apply_update), then
all-gathers the updated parts, so every rank ends the step with all the
parameters:

  * f32 moments: the Adam kernel (kernels/adam.fused_adam, one launch) over
    the pieces of the leaves the part covers, each a ``p.view(-1)[a:b]``
    view, which the kernel's contiguity check takes;
  * ``bf16_nu``: ``scale_by_adam_bf16_nu`` over the part laid end to end.

Adam is elementwise and every rank sees the same averaged gradient, so the
parameters are bit-equal to the replicated update's; a rank's optimizer
memory is 2 T / n values instead of 2 T. ``state_dict`` all-gathers the full
moments in the replicated ``Adam``'s layout and ``load_state_dict`` takes this
rank's part, so a checkpoint written at one world size loads at any other,
with or without ZeRO-1.
"""

from __future__ import annotations

import torch

from ..kernels.adam import B1, B2, EPS, fused_adam
from ..train.optim import Adam, scale_by_adam_bf16_nu
from .mesh import all_gather_flat, data_rank, data_size


class Zero1Adam(Adam):
    """``train.optim.Adam`` with its moments split over the ranks."""

    def __init__(self, params: dict[str, torch.Tensor], trainable: dict[str, bool] | None = None,
                 weight_decay: float = 0.0, b1: float = B1, b2: float = B2, eps: float = EPS,
                 bf16_nu: bool = False):
        # Adam's attributes, its full moments left out (no Adam.__init__)
        self.params = dict(params)
        trainable = trainable or {}
        self.names = [k for k in self.params if trainable.get(k, True)]
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.bf16_nu = bf16_nu
        self.count = 0
        for k in self.names:
            if self.params[k].dtype != torch.float32:
                raise TypeError(f"parameter {k} is {self.params[k].dtype}; Adam takes f32")
        self.sizes = [self.params[k].numel() for k in self.names]
        self.total = sum(self.sizes)
        self.parts = data_size()
        self.shard = -(-self.total // self.parts)
        self.lo = min(data_rank() * self.shard, self.total)
        self.hi = min(self.lo + self.shard, self.total)
        # (name, a, b, offset): leaf elements a..b are part elements offset..
        self.pieces = []
        start = 0
        for k, n in zip(self.names, self.sizes):
            a, b = max(self.lo - start, 0), min(self.hi - start, n)
            if a < b:
                self.pieces.append((k, a, b, start + a - self.lo))
            start += n
        device = self.params[self.names[0]].device if self.names else None
        self.mu = torch.zeros(self.hi - self.lo, device=device)
        self.nu = torch.zeros(self.hi - self.lo, device=device,
                              dtype=torch.bfloat16 if bf16_nu else torch.float32)

    def _param_pieces(self) -> list[torch.Tensor]:
        return [self.params[k].detach().view(-1)[a:b] for k, a, b, _ in self.pieces]

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor | None], lr: float) -> None:
        """One update of this rank's part from ``grads`` (name -> the gradient
        averaged over the ranks, None for a zero), then the all-gather."""
        self.count += 1
        ps = self._param_pieces()
        gs = [grads[k].reshape(-1)[a:b] if grads.get(k) is not None else None
              for k, a, b, _ in self.pieces]
        if self.bf16_nu:
            if ps:
                g = torch.cat([gi if gi is not None else torch.zeros_like(p)
                               for gi, p in zip(gs, ps)])
                if self.weight_decay:
                    g = g + self.weight_decay * torch.cat(ps)
                step = -lr * scale_by_adam_bf16_nu(self.mu, self.nu, g, self.count,
                                                   self.b1, self.b2, self.eps)
                torch._foreach_add_(ps, list(step.split([p.numel() for p in ps])))
        else:
            fused_adam([(p, self.mu[o:o + p.numel()], self.nu[o:o + p.numel()],
                         None if g is None else g.contiguous())
                        for p, g, (_, _, _, o) in zip(ps, gs, self.pieces)],
                       lr, self.count, self.b1, self.b2, self.eps, self.weight_decay)
        self._gather_params(ps)

    def _all_parts(self, part: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's part of the flat range (this rank's is ``part``),
        gathered and cut into the leaves, flat."""
        send = torch.cat([part, part.new_zeros(self.shard - part.numel())])
        return list(all_gather_flat(send)[:self.total].split(self.sizes))

    def _gather_params(self, ps: list[torch.Tensor]) -> None:
        if self.parts == 1 or not self.names:
            return
        full = self._all_parts(torch.cat(ps) if ps else self.mu.new_empty(0))
        torch._foreach_copy_([self.params[k].detach().view(-1) for k in self.names], full)

    def _full_leaves(self, part: torch.Tensor) -> dict[str, torch.Tensor]:
        return {k: t.view(self.params[k].shape).clone()
                for k, t in zip(self.names, self._all_parts(part))}

    def state_dict(self) -> dict:
        """The replicated ``Adam``'s state: the full moments, gathered (every
        rank calls it)."""
        return {"count": self.count, "mu": self._full_leaves(self.mu),
                "nu": self._full_leaves(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.names):
            raise KeyError("optimizer state holds other leaves than the trainable ones")
        self.count = int(state["count"])
        for k, a, b, o in self.pieces:
            self.mu[o:o + b - a].copy_(state["mu"][k].reshape(-1)[a:b])
            self.nu[o:o + b - a].copy_(state["nu"][k].reshape(-1)[a:b])


def sharded_fraction(opt: Adam) -> float:
    """The share of the optimizer state's bytes held in parts (diagnostics):
    the moments of a ``Zero1Adam``, against its replicated step count."""
    if not isinstance(opt, Zero1Adam):
        return 0.0
    moments = opt.total * (4 + opt.nu.element_size())
    return moments / (moments + 8)
