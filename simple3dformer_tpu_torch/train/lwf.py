"""Learning-without-Forgetting training: the 3D task loss plus a 2D teacher's
distillation (port of simple3dformer_tpu/train/lwf.py; the reference's
train_cls_voxel.py:238-268 and train_partseg_lwf.py:198-231).

Each step pairs a 3D batch with an image batch, both gathered on the device
from their ``DeviceResidentDataset``s, and minimises

    task_loss(model(x), y) + lambda * CE(model.forward_images(images), argmax(teacher(images)))

The teacher is a frozen DeiT (``nn.vit.make_teacher``) in eval mode, run under
``torch.no_grad``: on the card its blocks are the fused forward kernel. Both
passes of the student go through one autograd graph, so the blocks they share
receive the sum of both gradients in one backward; BatchNorm statistics move
in the point pass only (the image pathway has none). The images are cropped
and flipped on the device (``image_augment_fn``) from the uint8 canvas, then
ImageNet-normalised.

Augmentations draw from one ``torch.Generator`` on the model's device, seeded
each step from the run's seed and the optimizer step (``core.rng.step_seed``),
as the JAX step folds ``state.step`` into its key: the image crop first, then
the task augmentation. The numbers are not the JAX package's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..core.rng import DEFAULT_SEED, step_seed
from .loop import TrainState, cross_entropy

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IMAGE_CANVAS = 256  # the staged source resolution of the on-device crops
TEACHER_SEED = 0  # the teacher's random init where no DeiT checkpoint is found


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 (or float on the 0-255 scale) [B, H, W, 3] -> normalised f32, as
    torchvision's ToTensor and Normalize."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - mean) / std


def load_images(imagenet_path: str, *, synthetic: int = 0, seed: int = DEFAULT_SEED,
                canvas: int = IMAGE_CANVAS, max_images: int = 20000) -> np.ndarray:
    """ImageNet val as uint8 [N, canvas, canvas, 3], or with ``synthetic`` > 0 at
    least 256 random images from RandomState(seed + 7): the one image contract
    of both LwF CLIs. The crops are made on the device in each step from this
    canvas (the JAX package's documented deviation from cropping originals)."""
    if synthetic:
        rng = np.random.RandomState(int(seed) + 7)
        n = max(int(synthetic), 256)
        return (rng.rand(n, canvas, canvas, 3) * 255).astype(np.uint8)
    import os

    from PIL import Image

    valdir = os.path.join(imagenet_path, "val")
    paths = []
    for root, _, files in os.walk(valdir):
        paths.extend(os.path.join(root, f) for f in files
                     if f.lower().endswith((".jpeg", ".jpg", ".png")))
    rng = np.random.RandomState(int(seed))
    rng.shuffle(paths)
    out = []
    for p in paths[:max_images]:
        img = Image.open(p).convert("RGB").resize((canvas, canvas))
        out.append(np.asarray(img, dtype=np.uint8))
    return np.stack(out)


def make_lwf_train_step(state: TrainState, teacher: nn.Module,
                        task_loss_fn: Callable = cross_entropy, lambda_weight: float = 0.1,
                        augment_fn: Callable | None = None,
                        image_augment_fn: Callable | None = None,
                        prepare_fn: Callable | None = None, seed: int = DEFAULT_SEED):
    """(batch, raw uint8 images [M, H, W, 3], lr) -> metrics: one optimizer step,
    in place. ``batch`` is {'x', 'y'}, or whatever ``prepare_fn`` turns into
    (x, y); x is taken in f32. ``augment_fn(generator, x)`` and
    ``image_augment_fn(generator, images)`` draw from the step's generator.
    Metrics are 0-dim device tensors: ``loss``, ``task_loss``, ``lwf_loss``."""
    model, opt = state.model, state.optimizer
    teacher.eval().requires_grad_(False)
    names = [k for k in opt.names if opt.params[k].requires_grad]
    params = [opt.params[k] for k in names]
    gen = torch.Generator(device=next(model.parameters()).device)

    def step(batch: dict, raw_images: torch.Tensor, lr: float) -> dict:
        model.train()
        x, y = prepare_fn(batch) if prepare_fn is not None else (batch["x"], batch["y"])
        x = x.float()
        gen.manual_seed(step_seed(seed, state.step))
        if image_augment_fn is not None:
            raw_images = image_augment_fn(gen, raw_images)
        images = normalize_images(raw_images)
        if augment_fn is not None:
            x = augment_fn(gen, x)
        with torch.no_grad():
            labels = teacher(images).argmax(-1)
        task_loss = task_loss_fn(model(x), y)
        lwf_loss = cross_entropy(model.forward_images(images), labels)
        loss = task_loss + lambda_weight * lwf_loss
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        opt.step(dict(zip(names, grads)), lr)
        return {"loss": loss.detach(), "task_loss": task_loss.detach(),
                "lwf_loss": lwf_loss.detach()}

    return step


def make_scanned_lwf_train_steps(state: TrainState, teacher: nn.Module, task_ds, image_ds,
                                 **kw):
    """(task idx [S, B], image idx [S, M], both on the device; lr) -> metrics
    {name: [S] device tensor}: one LwF step per row, each batch gathered on the
    device from ``task_ds`` and ``image_ds`` (its ``images`` array). ``kw`` are
    ``make_lwf_train_step``'s."""
    step = make_lwf_train_step(state, teacher, **kw)

    def run(task_idx: torch.Tensor, img_idx: torch.Tensor, lr: float) -> dict:
        s = task_idx.shape[0]
        metrics = {k: torch.empty(s, device=task_idx.device)
                   for k in ("loss", "task_loss", "lwf_loss")}
        for i in range(s):
            out = step(task_ds.gather(task_idx[i]), image_ds.gather(img_idx[i])["images"], lr)
            for k, v in out.items():
                metrics[k][i] = v
        return metrics

    return run
