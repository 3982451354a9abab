"""Shared runner pieces of the Hydra-style CLIs (port of
simple3dformer_tpu/cli/_common.py).

Override parsing (``key=value``, ``model=Name``), config loading, the device
(``device=cuda``, the default, or ``device=cpu``; a run never moves to the CPU
by itself), the compute dtype (``dtype=bf16``, which every point model
takes), the run-dir layout
(out_dir/model.name/backbone/pretrained, the reference's templated
hydra.run.dir), the reference's optimizer block, the cls lr schedule, and
the epoch timer. Under a launcher (``torchrun``, the JAX package's env
names, SLURM) ``setup`` joins the rendezvous and each rank trains its part
of every global batch on its own card (parallel/mesh.py); rank 0 alone
prints the config and writes the run directory's files, and every rank
prints the same epoch lines.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import torch

from ..core.config import Config, load_task_config
from ..core.rng import DEFAULT_SEED
from ..parallel import mesh
from ..train.optim import make_optimizer, steplr


def parse_cli(argv=None):
    """argv -> (['key=value', ...] overrides, other flags)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    flags = [a for a in argv if a not in overrides]
    return overrides, flags


def resolve_device(name: str, flag: str = "device=cpu") -> torch.device:
    """The rank's device: ``cuda`` is ``cuda:$LOCAL_RANK`` under a launcher.
    ``flag`` is how the caller's CLI asks for the CPU, for the error text."""
    device = mesh.local_device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {name}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA card is visible; pass {flag} to train on the CPU")
    return device


def init_devices(name: str, flag: str = "device=cpu") -> torch.device:
    """Pick the rank's device, join the rendezvous the environment names
    (parallel/mesh.multihost_init: NCCL on the card, gloo on the CPU) and
    print the ``devices:`` line. Returns the device."""
    device = resolve_device(name, flag)
    mesh.multihost_init(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    backend = f" {torch.distributed.get_backend()}" if mesh.is_distributed() else ""
    print(f"devices: {mesh.world_size()} | rank {mesh.rank()}{backend} | {device} ({kind})")
    return device


def setup(task: str, argv=None) -> tuple[Config, torch.device]:
    """Load the config, pick the device and join the rendezvous. Returns
    (cfg, device). Rank 0 prints the config."""
    overrides, flags = parse_cli(argv)
    cfg = load_task_config(task, overrides)
    cfg.setdefault("seed", DEFAULT_SEED)
    cfg.setdefault("synthetic", 0)
    cfg.setdefault("device", "cuda")
    for f in flags:
        if f == "--synthetic":
            cfg.synthetic = 512
    device = init_devices(str(cfg.device))
    mesh.print0(cfg.to_yaml())
    return cfg, device


def compute_dtype(cfg):
    """cfg.dtype: 'bf16'/'bfloat16' -> torch.bfloat16 compute (the parameters
    stay f32); 'f32' (the default) -> None."""
    name = str(cfg.get("dtype", "")).lower()
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    if name in ("", "f32", "float32", "none"):
        return None
    raise ValueError(f"unknown dtype {name!r}")


def run_dir(cfg, task: str) -> str:
    """The run's directory, with its provenance files written by rank 0 (the
    other ranks wait for them)."""
    d = os.path.join(cfg.get("out_dir", task), str(cfg.model.name),
                     str(cfg.model.get("transformer_backbone", "none")),
                     str(cfg.model.get("pretrained", False)))
    os.makedirs(d, exist_ok=True)
    if mesh.is_main():
        _write_provenance(d, cfg)
    mesh.barrier()
    return d


def _write_provenance(d: str, cfg) -> None:
    """``resolved_config.json`` (the config and argv) and a copy of the model's
    source file, as the reference's Hydra runs keep. Best-effort: provenance
    never fails a training run."""
    try:
        with open(os.path.join(d, "resolved_config.json"), "w") as f:
            json.dump({"argv": list(sys.argv), "config": cfg.to_dict()}, f, indent=2,
                      default=str)
        from ..models import hengshuang, point_vit
        from ..models.registry import POINT_VIT_VARIANTS

        name = str(cfg.model.name)
        mod = (hengshuang if name == "Hengshuang"
               else point_vit if name in POINT_VIT_VARIANTS else None)
        if mod is not None:
            shutil.copy(mod.__file__, os.path.join(d, os.path.basename(mod.__file__)))
    except OSError as e:
        print(f"provenance write skipped: {e}")


def reference_optimizer(cfg, params: dict, trainable_mask=None):
    """The Hydra scripts' optimizer block (the reference's train_cls.py:82-93):
    Adam with the config's lr and weight decay, or SGD momentum 0.9 at the
    hard-coded lr 0.01. Returns (optimizer, base lr)."""
    if str(cfg.optimizer) == "Adam":
        return (make_optimizer(params, "Adam", weight_decay=float(cfg.weight_decay),
                               trainable_mask=trainable_mask), float(cfg.learning_rate))
    return make_optimizer(params, "SGD", trainable_mask=trainable_mask), 0.01


def lr_schedule(cfg, base_lr: float):
    """epoch -> lr: StepLR(50, 0.3) for cls (the reference's train_cls.py:93), or
    the config's ``sched_step`` / ``sched_gamma``."""
    step = int(cfg.get("sched_step", 50))
    gamma = float(cfg.get("sched_gamma", 0.3))
    return lambda epoch: steplr(base_lr, step, gamma, epoch)


class EpochTimer:
    def __init__(self):
        self.t0 = time.time()

    def lap(self, n_samples: int) -> str:
        dt = time.time() - self.t0
        self.t0 = time.time()
        return f"{n_samples / dt:.1f} samples/sec"
