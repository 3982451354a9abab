"""ShapeNetPart part segmentation with LwF distillation from a 2D DeiT teacher
(port of simple3dformer_tpu/cli/train_partseg_lwf.py; the reference's
train_partseg_lwf.py).

    python -m simple3dformer_tpu_torch.cli.train_partseg_lwf synthetic=1024 epoch=2

The same ``key=value`` overrides over configs/partseg_lwf.yaml (the model
``3DViT_1_layer`` on deit_small, or ``model=3DViT_lwf`` on deit_base with 3
heads; B=32, N=1024 with normals, 50 parts, M=64 images a step, lambda 0.1)
and the JAX CLI's recipe and printed lines: the class-balanced ``portion``
subsample of the training split, a frozen teacher ``make_teacher(backbone)``
with the true head count, SGD (momentum 0.9 at the optimizer block's base lr,
0.01; the 2D head and patch embedding frozen when ``model.pretrained``),
lr max(lr * decay^(epoch // step), 1e-5), a fresh random image subset for each
epoch, each step's loss ``CE_seg + lambda * CE(forward_images, argmax
teacher)`` with the images cropped and flipped on the device, the epoch line
``Epoch e lr ... loss ... (task ... lwf ...)``, the category-restricted mIoU
eval and a checkpoint at each best instance mIoU.

2D weights: ``maybe_load_deit`` (utils/torch_convert.py) reads
``<backbone>.pth`` from ``$DEIT_CKPT_DIR`` (default ``./weights``) into the
teacher always and into the student when ``model.pretrained``; without the
file it warns and keeps the random init (the teacher's from its own
generator, seed 0). Without ImageNet on disk, ``synthetic=N`` (or
``--synthetic``) also makes random images (train/lwf.load_images).

It runs on the card (``device=cuda``, the default) and on the CPU only when
asked (``device=cpu``). ``dtype=bf16`` builds the student at the compute dtype,
as the JAX CLI does (every Linear and the image pathway's patch embedding in
bf16, the parameters f32); the teacher stays f32, so its labels do not change
with the dtype, and both cross-entropies take the logits in f32.
"""

from __future__ import annotations

import numpy as np

from ..core import checkpoint as ckpt_lib
from ..core.rng import generator
from ..data.image_augment import device_random_resized_crop_flip
from ..data.pipeline import DeviceResidentDataset
from ..models.point_vit import frozen_mask_point
from ..models.registry import has_lwf_pathway, make_point_model
from ..nn.vit import make_teacher
from ..train import lwf
from ..train.eval_metrics import PartSegMeter
from ..train.loop import TrainState, make_scanned_eval, seg_cross_entropy
from ..utils.torch_convert import maybe_load_deit
from . import _common as C
from .train_partseg import NUM_CATEGORY, NUM_PART, load_arrays, make_prepare_fn, seg_augment

def load_images(cfg) -> np.ndarray:
    """The config's keys over train/lwf.load_images, the shared image contract."""
    return lwf.load_images(cfg.imagenet_data_path, synthetic=int(cfg.synthetic or 0),
                           seed=int(cfg.seed), canvas=int(cfg.get("image_canvas",
                                                                  lwf.IMAGE_CANVAS)))


def balanced_portion(cats: np.ndarray, portion: float, seed: int) -> np.ndarray:
    """Indices of a class-balanced ``portion`` of the split, the JAX CLI's draws
    (the reference's train_partseg_lwf.py:70-88)."""
    rng = np.random.RandomState(seed)
    keep = []
    for c in np.unique(cats):
        ids = np.where(cats == c)[0]
        keep.extend(rng.choice(ids, int(len(ids) * portion), replace=False))
    return np.asarray(sorted(keep))


def main(argv=None):
    cfg, device = C.setup("partseg_lwf", argv)
    if not has_lwf_pathway(cfg):
        raise ValueError(f"model {cfg.model.name} has no 2D image pathway for LwF")
    cfg.num_class = NUM_PART
    cfg.input_dim = (6 if cfg.normal else 3) + NUM_CATEGORY
    cfg.data_path = cfg.get("shapenetpart_data_path", cfg.get("data_path"))

    (tr_x, tr_c, tr_s), (te_x, te_c, te_s) = load_arrays(cfg)
    portion = float(cfg.get("portion", 1.0))
    if portion < 1.0:
        keep = balanced_portion(tr_c, portion, int(cfg.seed))
        tr_x, tr_c, tr_s = tr_x[keep], tr_c[keep], tr_s[keep]
    print(f"train {len(tr_x)} / test {len(te_x)}")
    train_ds = DeviceResidentDataset({"x": tr_x, "cls": tr_c, "y": tr_s}, device)
    test_ds = DeviceResidentDataset({"x": te_x, "cls": te_c, "y": te_s}, device)
    image_ds = DeviceResidentDataset({"images": load_images(cfg)}, device)
    print(f"imagenet subset: {len(image_ds)} images")

    backbone = str(cfg.model.transformer_backbone)
    pretrained = bool(cfg.model.get("pretrained"))
    model = make_point_model(cfg, task="seg", dtype=C.compute_dtype(cfg),
                             generator=generator(int(cfg.seed))).to(device)
    print(f"Number of parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    if pretrained:
        maybe_load_deit(model, backbone)
    teacher = make_teacher(backbone, generator=generator(lwf.TEACHER_SEED)).to(device)
    maybe_load_deit(teacher, backbone)

    optimizer, base_lr = C.reference_optimizer(cfg, dict(model.named_parameters()),
                                               frozen_mask_point(model, pretrained))
    state = TrainState(model, optimizer)
    prepare = make_prepare_fn()
    train_run = lwf.make_scanned_lwf_train_steps(
        state, teacher, train_ds, image_ds, task_loss_fn=seg_cross_entropy,
        lambda_weight=float(cfg.get("lambda_weight", 0.1)), augment_fn=seg_augment,
        image_augment_fn=device_random_resized_crop_flip, prepare_fn=prepare,
        seed=int(cfg.seed))
    eval_run = make_scanned_eval(model, test_ds, prepare_fn=prepare)

    host_rng = np.random.RandomState(int(cfg.seed))
    batch, m = int(cfg.batch_size), int(cfg.get("M", 64))
    eval_idx = test_ds.put_indices(test_ds.epoch_indices(batch, host_rng, shuffle=False,
                                                         drop_last=False))
    ckpt = ckpt_lib.Checkpointer(f"{C.run_dir(cfg, 'partseg_lwf')}/ckpt")

    best_iou = 0.0
    for epoch in range(int(cfg.epoch)):
        lr = max(base_lr * (float(cfg.lr_decay) ** (epoch // int(cfg.step_size))), 1e-5)
        idx = train_ds.epoch_indices(batch, host_rng)
        # a fresh random image subset each epoch (the reference's :194-195)
        img_idx = host_rng.randint(0, len(image_ds), size=(idx.shape[0], m))
        metrics = train_run(train_ds.put_indices(idx), image_ds.put_indices(img_idx), lr)
        host = {k: float(v.mean()) for k, v in metrics.items()}
        print(f"Epoch {epoch + 1} lr {lr:f} loss {host['loss']:.4f} "
              f"(task {host['task_loss']:.4f} lwf {host['lwf_loss']:.4f})")

        logits = eval_run(eval_idx).reshape(-1, int(cfg.num_point), NUM_PART)[: len(te_s)]
        meter = PartSegMeter()
        meter.update(logits.float().cpu().numpy(), te_s)
        acc, c_iou, i_iou = meter.accuracy, meter.class_avg_iou, meter.instance_avg_iou
        print(f"test Accuracy: {acc:f}  Class avg mIOU: {c_iou:f}  Inctance avg mIOU: {i_iou:f}")
        if i_iou >= best_iou:
            best_iou = i_iou
            ckpt.save(epoch, state.state_dict(), {"instance_avg_iou": i_iou})
    print(f"Best inctance avg mIOU is: {best_iou:f}")
    return best_iou


if __name__ == "__main__":
    main()
