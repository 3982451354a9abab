"""One-pass Adam over every trainable leaf: CUDA kernel for Hopper and its plain version.

Replaces the TPU kernel ``simple3dformer_tpu/kernels/adam.py`` (``_adam_kernel``
:40 over flat tiles, ``pallas_call`` :76 in ``_fused_adam_flat``) and the
semantics of ``fused_adam_update`` (:90) and ``fused_adam_pair`` (:135):

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g g
    p' = p - lr (m' / bc1) / (sqrt(v' / bc2) + eps),   bc = 1 - b**t in f32

with ``t`` the step count after the increment (the first update has t = 1),
the bias corrections divided, not multiplied by reciprocals, and optional L2
weight decay added to the gradient first (g + wd p, torch.optim.Adam's and
optax.add_decayed_weights' semantics). Frozen leaves are simply not passed:
they are left untouched and carry no state.

What bounds it on the card, and the design. The update reads p, m, v and g
and writes p, m and v: 7 f32 passes, so bytes bound it. The TPU wrapper
launches one ``pallas_call`` per large leaf; with about 155 leaves at the
flagship a launch per leaf would make the update bound by launch cost. So
``fused_adam`` launches one kernel per step over a device table of the
leaves' pointers and lengths (``csrc/adam.cu``), one block per 4096-element
chunk, and updates p, m and v in place. Every step of the arithmetic is an
IEEE-rounded intrinsic in the TPU kernel's order, so the kernel and
``adam_reference`` agree to the bit on the card.

On CPU tensors ``fused_adam`` runs ``adam_reference`` leaf by leaf; on CUDA
tensors it launches the kernel or raises. ``fused_adam.launches`` counts
kernel launches (one per call).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def bias_corrections(count: int, b1: float = B1, b2: float = B2) -> tuple[float, float]:
    """(1 - b1**t, 1 - b2**t) computed in f32 from an f32 t, as the JAX package does."""
    t = np.float32(count)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)


def bias_correction_tensors(count: int, device, b1: float = B1,
                            b2: float = B2) -> tuple[torch.Tensor, torch.Tensor]:
    """``bias_corrections`` as f32 tensors on ``device``: tensors, not Python
    numbers, since PyTorch on CUDA turns a division by a number into a product
    with its reciprocal, which rounds differently. Each is a copy to the card
    that waits for it, so a caller over many leaves makes them once a step."""
    return tuple(torch.tensor(bc, dtype=torch.float32, device=device)
                 for bc in bias_corrections(count, b1, b2))


def adam_reference(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor | None,
                   lr: float, count: int, b1: float = B1, b2: float = B2, eps: float = EPS,
                   weight_decay: float = 0.0):
    """Plain version of the kernel for one leaf: returns (p', m', v'), f32."""
    bc1, bc2 = bias_correction_tensors(count, p.device, b1, b2)
    if g is None:
        g = torch.zeros_like(p)
    if weight_decay:
        g = g + weight_decay * p
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    mhat = m / bc1
    vhat = v / bc2
    return p - lr * mhat / (torch.sqrt(vhat) + eps), m, v


@functools.cache
def _lib():
    from .build import load

    lib = load("adam")
    lib.s3f_adam.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                             + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    lib.s3f_adam.restype = ctypes.c_int
    lib.s3f_adam_chunk.restype = ctypes.c_int
    return lib


def _check_cuda_leaves(leaves, device: torch.device) -> None:
    for i, (p, m, v, g) in enumerate(leaves):
        for name, t in (("p", p), ("m", m), ("v", v)) + ((("g", g),) if g is not None else ()):
            if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"fused_adam leaf {i}: {name} must be contiguous float32 on "
                                 f"{device}, got {t.dtype} on {t.device}")
            if t.numel() != p.numel():
                raise ValueError(f"fused_adam leaf {i}: {name} has {t.numel()} elements, "
                                 f"p has {p.numel()}")


def fused_adam(leaves, lr: float, count: int, b1: float = B1, b2: float = B2, eps: float = EPS,
               weight_decay: float = 0.0) -> None:
    """Adam over ``leaves``, a list of (p, m, v, g) f32 tensors; p, m and v in place.

    ``count`` is the step count after the increment; ``g`` may be None for a
    leaf the loss does not reach (a zero gradient), and may be strided (it is
    copied to a contiguous tensor on the card; p, m and v must be contiguous).
    """
    leaves = [leaf for leaf in leaves if leaf[0].numel()]
    if not leaves:
        return
    device = leaves[0][0].device
    if device.type == "cpu":
        with torch.no_grad():
            for p, m, v, g in leaves:
                p1, m1, v1 = adam_reference(p, m, v, g, lr, count, b1, b2, eps, weight_decay)
                p.copy_(p1)
                m.copy_(m1)
                v.copy_(v1)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adam runs on cpu or cuda, not {device}")
    # a gradient is only read: one that autograd returns as a strided view (a
    # weight used through a permute) is copied to the contiguous layout the kernel reads
    leaves = [(p, m, v, g if g is None or g.is_contiguous() else g.contiguous())
              for p, m, v, g in leaves]
    _check_cuda_leaves(leaves, device)
    lib = _lib()
    chunk = lib.s3f_adam_chunk()
    n = np.array([p.numel() for p, _, _, _ in leaves], np.int64)
    table = np.concatenate([
        np.array([[p.data_ptr(), m.data_ptr(), v.data_ptr(), 0 if g is None else g.data_ptr()]
                  for p, m, v, g in leaves], np.int64).T.reshape(-1),
        n, np.concatenate([[0], np.cumsum(-(-n // chunk))])])
    # pinned, so the copy is queued on the stream without a host wait
    dev_table = torch.from_numpy(table).pin_memory().to(device, non_blocking=True)
    bc1, bc2 = bias_corrections(count, b1, b2)
    with torch.cuda.device(device):
        err = lib.s3f_adam(dev_table.data_ptr(), len(leaves), int(table[-1]), lr, bc1, bc2,
                           b1, b2, float(np.float32(1.0 - b1)), float(np.float32(1.0 - b2)),
                           eps, weight_decay, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")
    fused_adam.launches += 1


fused_adam.launches = 0
