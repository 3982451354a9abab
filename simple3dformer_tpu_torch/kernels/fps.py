"""Farthest point sampling: a CUDA kernel for Hopper and its plain version.

Replaces the TPU kernel ``simple3dformer_tpu/kernels/fps.py`` (``_fps_kernel``
:26, ``pallas_call`` :79 in ``fps_pallas``) and the ``lax.scan`` path of
``simple3dformer_tpu/ops/pointops.farthest_point_sample`` (:123-133):

    out[:, 0] = start;  dist = 1e10
    each next index: dist = min(dist, |xyz - xyz[last]|^2); argmax(dist)

with the squared distance summed as ((dx dx + dy dy) + dz dz) and argmax
taking the smallest index among equal maxima (``jnp.argmax``,
``torch.argmax``). The kernel (``csrc/fps.cu``) rounds every operation as
the plain version does, so the two give the same indices.

What bounds it on the card, and the design: the npoint iterations depend on
each other, so one iteration's latency bounds it, not bytes or operations.
One block per batch element, its size picked by N, holds xyz in shared
memory and the running distances in registers; an iteration updates them,
takes each warp's (distance, index) argmax with Hopper's ``redux.sync`` on
the distance bits and then the index, and crosses one barrier, after which
every warp reduces the warps' winners itself.

On a CPU tensor ``fps`` runs ``fps_reference``; on a CUDA tensor it launches
the kernel or raises. ``fps.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import refuse_export


def fps_reference(xyz: torch.Tensor, npoint: int, start: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: xyz [B, N, 3] -> indices [B, npoint] int32."""
    b, n, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    far = (torch.zeros(b, dtype=torch.long, device=xyz.device) if start is None
           else start.to(xyz.device, torch.long))
    dist = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    out = []
    for _ in range(npoint):
        out.append(far)
        dx, dy, dz = x - x[rows, far, None], y - y[rows, far, None], z - z[rows, far, None]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        far = dist.argmax(-1)
    return torch.stack(out, 1).to(torch.int32)


@functools.cache
def _lib():
    from .build import load

    lib = load("fps")
    lib.s3f_fps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.s3f_fps.restype = ctypes.c_int
    lib.s3f_fps_max_points.restype = ctypes.c_int
    return lib


def fps(xyz: torch.Tensor, npoint: int, start: torch.Tensor | None = None) -> torch.Tensor:
    """xyz [B, N, 3] -> [B, npoint] int32 indices, starting at ``start`` [B]
    (index 0 when None)."""
    refuse_export("fps")
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be [B, N, 3], got {tuple(xyz.shape)}")
    # the kernel reads xyz[start] from shared memory: an index outside [0, N) reads past it
    if start is not None and start.numel() and not (
            0 <= int(start.min()) and int(start.max()) < xyz.shape[1]):
        raise ValueError(f"start must lie in [0, {xyz.shape[1]})")
    if xyz.device.type == "cpu":
        return fps_reference(xyz, npoint, start)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps runs on cpu or cuda, not {xyz.device}")
    b, n, _ = xyz.shape
    lib = _lib()
    if npoint < 1 or not 1 <= n <= lib.s3f_fps_max_points():
        raise ValueError(f"fps kernel: npoint {npoint}, N {n} outside 1..{lib.s3f_fps_max_points()}")
    if xyz.dtype != torch.float32 or not xyz.is_contiguous():
        raise ValueError(f"fps kernel takes contiguous float32 xyz, got {xyz.dtype}")
    if start is not None:
        start = start.to(torch.int32)
        if start.shape != (b,) or start.device != xyz.device:
            raise ValueError(f"start must be [{b}] on {xyz.device}")
        start = start.contiguous()
    out = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.s3f_fps(xyz.data_ptr(), 0 if start is None else start.data_ptr(),
                          out.data_ptr(), b, n, npoint,
                          torch.cuda.current_stream(xyz.device).cuda_stream)
    if err:
        raise RuntimeError(f"fps kernel launch failed: CUDA error {err}")
    fps.launches += 1
    return out


fps.launches = 0
