"""Part-segmentation prediction renderer (port of
simple3dformer_tpu/cli/visualize_point_cloud.py, which mirrors the reference's
visualize_point_cloud.py; the reference expects a config/vis.yaml it never
shipped, so this CLI takes the partseg config surface).

``predict`` runs a B=1 forward of the seg model for each sample on the
device (the 3DViT path: FPS, kNN, the gathers and the fused block kernels on
the card) and takes the category-restricted argmax; ``render`` draws the
ground truth beside the prediction as 3D scatter plots (matplotlib, imported
there only). ``checkpoint=<dir>`` restores the latest step that the port's
train_partseg wrote.

    python -m simple3dformer_tpu_torch.cli.visualize_point_cloud \\
        model=3DViT synthetic=8 n_samples=4 vis_dir=./seg_vis
    python -m simple3dformer_tpu_torch.cli.visualize_point_cloud device=cpu \\
        model=3DViT_1_layer synthetic=8 num_point=64 n_samples=2

It runs on the card (``device=cuda``, the default) and on the CPU only when
asked (``device=cpu``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import checkpoint as ckpt_lib
from ..core.rng import generator
from ..models.registry import make_point_model
from ..train.eval_metrics import SEG_LABEL_TO_CAT, category_restricted_argmax
from . import _common as C
from .train_partseg import NUM_CATEGORY, NUM_PART, load_arrays, make_prepare_fn


def render(points, gt, pred, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 5))
    for k, (labels, title) in enumerate([(gt, "ground truth"),
                                         (pred, "prediction")]):
        ax = fig.add_subplot(1, 2, k + 1, projection="3d")
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=labels,
                   cmap="tab20", s=4)
        ax.set_title(title)
        ax.set_axis_off()
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def predict(model, points, cats, segs, device) -> list[tuple[np.ndarray, np.ndarray, str]]:
    """For each sample (points [S, N, C], cats [S], segs [S, N] as numpy), one
    B=1 forward in eval mode on ``device`` -> (logits [N, 50] f32, the
    category-restricted prediction [N], the category named by the first
    label)."""
    prepare = make_prepare_fn()
    model.eval()
    out = []
    for i in range(len(points)):
        batch = {"x": torch.from_numpy(points[i:i + 1]).to(device),
                 "cls": torch.from_numpy(cats[i:i + 1]).to(device),
                 "y": torch.from_numpy(segs[i:i + 1]).to(device)}
        with torch.inference_mode():
            logits = model(prepare(batch)[0])[0].float().cpu().numpy()
        cat = SEG_LABEL_TO_CAT[int(segs[i, 0])]
        out.append((logits, category_restricted_argmax(logits, cat), cat))
    return out


def main(argv=None):
    cfg, device = C.setup("partseg", argv)
    cfg.num_class = NUM_PART
    cfg.input_dim = (6 if cfg.normal else 3) + NUM_CATEGORY
    n_samples = int(cfg.get("n_samples", 4))
    out_dir = str(cfg.get("vis_dir", "./seg_vis"))
    os.makedirs(out_dir, exist_ok=True)

    _, (te_x, te_c, te_s) = load_arrays(cfg)
    model = make_point_model(cfg, task="seg", dtype=C.compute_dtype(cfg),
                             generator=generator(int(cfg.seed))).to(device)
    if cfg.get("checkpoint"):
        state, _ = ckpt_lib.Checkpointer(str(cfg.checkpoint)).restore()
        if state is not None:
            model.load_state_dict(state["params"])

    n = min(n_samples, len(te_x))
    outs = []
    for i, (_, pred, cat) in enumerate(predict(model, te_x[:n], te_c[:n], te_s[:n], device)):
        path = os.path.join(out_dir, f"sample_{i}_{cat}.png")
        render(te_x[i], te_s[i], pred, path)
        acc = float((pred == te_s[i]).mean())
        print(f"sample {i} ({cat}): point acc {acc:.3f} -> {path}")
        outs.append(path)
    return outs


if __name__ == "__main__":
    main()
