"""Shared runner pieces of the Hydra-style CLIs (port of
simple3dformer_tpu/cli/_common.py).

Override parsing (``key=value``, ``model=Name``), config loading, the device
(``device=cuda``, the default, or ``device=cpu``; a run never moves to the CPU
by itself), the run-dir layout (out_dir/model.name/backbone/pretrained, the
reference's templated hydra.run.dir), the reference's optimizer block, and
the epoch timer. There is no device mesh: the port trains on one card.
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
from ..train.optim import make_optimizer


def parse_cli(argv=None):
    """argv -> (['key=value', ...] overrides, other flags)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    flags = [a for a in argv if a not in overrides]
    return overrides, flags


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {name}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass device=cpu to train on the CPU")
    return device


def setup(task: str, argv=None) -> tuple[Config, torch.device]:
    """Load the config and pick the device. Returns (cfg, device)."""
    overrides, flags = parse_cli(argv)
    cfg = load_task_config(task, overrides)
    cfg.setdefault("seed", DEFAULT_SEED)
    cfg.setdefault("synthetic", 0)
    cfg.setdefault("device", "cuda")
    for f in flags:
        if f == "--synthetic":
            cfg.synthetic = 512
    if str(cfg.get("dtype", "f32")).lower() not in ("", "f32", "float32", "none"):
        raise NotImplementedError(f"dtype={cfg.dtype} is not ported yet: the point models run "
                                  "in f32 (their bf16 route comes with a later slice)")
    device = resolve_device(str(cfg.device))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"devices: 1 | {device} ({kind})")
    print(cfg.to_yaml())
    return cfg, device


def run_dir(cfg, task: str) -> str:
    d = os.path.join(cfg.get("out_dir", task), str(cfg.model.name),
                     str(cfg.model.get("transformer_backbone", "none")),
                     str(cfg.model.get("pretrained", False)))
    os.makedirs(d, exist_ok=True)
    _write_provenance(d, cfg)
    return d


def _write_provenance(d: str, cfg) -> None:
    """``resolved_config.json`` (the config and argv) and a copy of the model's
    source file, as the reference's Hydra runs keep. Best-effort: provenance
    never fails a training run."""
    try:
        with open(os.path.join(d, "resolved_config.json"), "w") as f:
            json.dump({"argv": list(sys.argv), "config": cfg.to_dict()}, f, indent=2,
                      default=str)
        from ..models import point_vit
        from ..models.registry import POINT_VIT_VARIANTS

        if str(cfg.model.name) in POINT_VIT_VARIANTS:
            shutil.copy(point_vit.__file__, os.path.join(d, os.path.basename(point_vit.__file__)))
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


class EpochTimer:
    def __init__(self):
        self.t0 = time.time()

    def lap(self, n_samples: int) -> str:
        dt = time.time() - self.t0
        self.t0 = time.time()
        return f"{n_samples / dt:.1f} samples/sec"
