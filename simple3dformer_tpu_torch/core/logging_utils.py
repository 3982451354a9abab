"""Run-directory logging (port of simple3dformer_tpu/core/logging_utils.py).

A logger writing to ``<run_dir>/train.log`` and to the console, and
``snapshot_config``, which writes the resolved config to
``<run_dir>/config.yaml`` (the model is reconstructable from it).
"""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(run_dir: str, name: str = "simple3dformer") -> logging.Logger:
    os.makedirs(run_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
    fh = logging.FileHandler(os.path.join(run_dir, "train.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def snapshot_config(cfg, run_dir: str) -> str:
    """Write the resolved config (a core.config.Config) into the run directory."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config.yaml")
    with open(path, "w") as f:
        f.write(cfg.to_yaml())
    return path
