"""Convert a checkpoint that a JAX CLI wrote into a checkpoint of the port.

    python scripts/jax_checkpoint_to_torch.py JAX_CKPT_DIR OUT_DIR [--step N] CLI [CLI flags]

JAX_CKPT_DIR is the ``ckpt`` directory of a JAX CLI's run
(``simple3dformer_tpu/core/checkpoint.Checkpointer``, orbax); CLI names that
CLI (train_cls_voxel, train_pure_mlp, train_partseg, train_partseg_lwf,
train_cls, train_cls_scanobjectnn, train_s3dis_semseg) and the flags after it
are the ones the run took, as far as they shape the model (for the voxel CLI
``--dataset``, ``--transformer-name``, ``--embed-layer``, ``--cell-size``,
``--patch-size``, ``--pos-embedding``, ``--head``; for the Hydra-style CLIs
the ``key=value`` overrides such as ``model=3DViT_lwf``). For example:

    python scripts/jax_checkpoint_to_torch.py \
        cls/Voxel3D_2DPretrain/VoxelEmbed_default/deit_small_patch16_224/ckpt port_ckpt \
        train_cls_voxel --dataset ModelNet40 --transformer-name deit_small_patch16_224 \
        --cell-size 6 --patch-size 5

The model and the shapes of its initial variables (the state template, by
``jax.eval_shape``: nothing is computed) are built as the CLI builds them (the
voxel CLI: simple3dformer_tpu/cli/train_cls_voxel.py:145-210; the Hydra-style
CLIs: cli/_common.py and each CLI's classes and input width), and so is the
optimizer (``train/optim.make_optimizer`` with the CLI's trainable mask and
``--bf16-nu``, or ``cli/_common.reference_optimizer``: Adam with or without
weight decay, or SGD with momentum), whose ``init`` on that template gives the
optimizer state the run must hold. The latest step (or ``--step``) is restored
as it was saved. Its ``params`` and ``batch_stats`` must have the template's
leaves and shapes, and its ``opt_state`` the optimizer's: the same optimizer
(Adam's mu and nu, or SGD's trace), state for the same trainable leaves (the
mask: frozen leaves hold none), nu in the same dtype. Otherwise the script
stops, naming what differs. The parameters and statistics are converted by the
port's ``utils/convert.load_jax_params`` into the port's model, built the same
way, the optimizer state by ``utils/convert.load_jax_opt_state`` into the
port's optimizer as the port's CLI builds it, and both written as one step of
the port's ``core/checkpoint.Checkpointer`` at OUT_DIR, numbered as the JAX
step was (the JAX CLIs number steps by epoch): the port CLI's train state
``{"params": state dict, "opt_state": the optimizer's state, "step": the JAX
train step}``, with the JAX metrics in ``metrics.json``. A port run resumes
from it as from its own checkpoint: ``cli/train_cls.py`` from its run
directory's ``ckpt``, ``cli/train_cls_voxel.py --model OUT_DIR``, any CLI's
train state by ``Checkpointer(OUT_DIR).restore_into`` (with ``--zero1`` each
rank keeps its part of the moments). ``serve/predictor.Predictor.from_checkpoint``,
``cli/visualize_attention_map_voxel.py --model`` and
``cli/visualize_point_cloud.py checkpoint=`` read its parameters.

This script imports jax and the JAX package; the port package does not.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the Hydra-style CLIs: config task, model task, classes, input width of a config
HYDRA = {
    "train_partseg": ("partseg", "seg", 50, lambda cfg: (6 if cfg.normal else 3) + 16, False),
    "train_partseg_lwf": ("partseg_lwf", "seg", 50, lambda cfg: (6 if cfg.normal else 3) + 16,
                          True),
    "train_cls": ("cls", "cls", 40, lambda cfg: 6 if cfg.normal else 3, False),
    "train_cls_scanobjectnn": ("cls_scanobjectnn", "cls", 15, lambda cfg: 3, False),
    "train_s3dis_semseg": ("semseg", "seg", 13, lambda cfg: 9, False),
}
CLIS = ("train_cls_voxel", "train_pure_mlp", *HYDRA)


def voxel_models(argv):
    """(the JAX VoxelViT's initial variables, the port's model, the JAX
    optimizer, the port's optimizer), as the voxel CLIs build them."""
    import jax
    import jax.numpy as jnp

    from simple3dformer_tpu.cli import train_cls_voxel as jcli
    from simple3dformer_tpu.data.classmaps import (CLASSES_ModelNet10, CLASSES_ModelNet40,
                                                   CLASSES_SHAPENET)
    from simple3dformer_tpu.models.voxel_vit import VoxelViT, frozen_mask
    from simple3dformer_tpu.nn.vit import EMBED_DIM
    from simple3dformer_tpu.nn.voxel_embed import make_embed_layer
    from simple3dformer_tpu.train.optim import make_optimizer
    from simple3dformer_tpu_torch.cli import train_cls_voxel as pcli
    from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT as PortVoxelViT
    from simple3dformer_tpu_torch.models.voxel_vit import frozen_mask as port_frozen_mask
    from simple3dformer_tpu_torch.nn.voxel_embed import make_embed_layer as port_embed_layer
    from simple3dformer_tpu_torch.train.optim import make_optimizer as port_optimizer

    args = jcli.build_argparser().parse_args(argv)
    idx2cls, voxel = {"ModelNet10": (CLASSES_ModelNet10, 30),
                      "ModelNet40": (CLASSES_ModelNet40, 30),
                      "ShapeNetV2": (CLASSES_SHAPENET, 128)}[args.dataset]
    kw = dict(voxel_size=voxel, cell_size=args.cell_size, patch_size=args.patch_size,
              embed_dim=EMBED_DIM[args.transformer_name])
    dtype = jnp.bfloat16 if args.dtype == "bf16" else None
    model = VoxelViT(voxel_embed=make_embed_layer(args.embed_layer, dtype=dtype, **kw),
                     n_classes=len(idx2cls), transformer_backbone=args.transformer_name,
                     pos_embedding=args.pos_embedding, head=args.head, dtype=dtype)
    variables = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((2, voxel, voxel, voxel)), jnp.zeros((2, 224, 224, 3)),
        method=model.init_all), jax.random.key(args.seed))
    pargs = pcli.build_argparser().parse_args(argv)
    port = PortVoxelViT(port_embed_layer(pargs.embed_layer, **kw), n_classes=len(idx2cls),
                        transformer_backbone=pargs.transformer_name,
                        pos_embedding=pargs.pos_embedding, head=pargs.head)
    bf16_nu = (dtype is not None) if args.bf16_nu == "auto" else args.bf16_nu == "1"
    tx = make_optimizer("Adam", trainable_mask=frozen_mask(variables["params"], args.pretrained),
                        bf16_nu=bf16_nu)
    opt = port_optimizer(dict(port.named_parameters()), "Adam",
                         trainable_mask=port_frozen_mask(port, pargs.pretrained), bf16_nu=bf16_nu)
    return variables, port, tx, opt


def vip3d_models(argv):
    """ViP-3D as the train_pure_mlp CLIs build it."""
    import jax
    import jax.numpy as jnp

    from simple3dformer_tpu.cli import train_pure_mlp as jcli
    from simple3dformer_tpu.data.classmaps import CLASSES_ModelNet40, CLASSES_SHAPENET
    from simple3dformer_tpu.models.vip3d import VisionPermutator3D
    from simple3dformer_tpu.nn.voxel_embed import VoxelEmbedNoAverage
    from simple3dformer_tpu.train.optim import make_optimizer
    from simple3dformer_tpu_torch.cli import train_pure_mlp as pcli
    from simple3dformer_tpu_torch.train.optim import make_optimizer as port_optimizer

    args = jcli.build_argparser().parse_args(argv)
    n_classes = len(CLASSES_ModelNet40 if args.dataset == "ModelNet40" else CLASSES_SHAPENET)
    emb_cfg = jcli.EMBED_CONFIGS[args.embed_layer]
    v = emb_cfg["voxel_size"]
    dtype = jnp.bfloat16 if args.dtype == "bf16" else None
    emb = VoxelEmbedNoAverage(voxel_size=v, cell_size=emb_cfg["cell_size"],
                              patch_size=v // emb_cfg["cell_size"],
                              embed_dim=emb_cfg["embed_dim"], dtype=dtype)
    model = VisionPermutator3D.from_name(
        args.model_name, embed_layer=emb, num_classes=n_classes, drop_path_rate=args.drop_path,
        dtype=dtype, pos_embedding=args.pos_embedding if args.pos_embedding == "PEG" else None)
    variables = jax.eval_shape(lambda k: model.init(k, jnp.zeros((2, v, v, v))),
                               jax.random.key(args.seed))
    port = pcli.build_model(pcli.build_argparser().parse_args(argv), n_classes, None)
    return variables, port, make_optimizer("Adam"), port_optimizer(
        dict(port.named_parameters()), "Adam")


def point_models(cli, argv):
    """(initial variables, port model, JAX optimizer, port optimizer) of a point
    model as the Hydra-style CLI ``cli`` builds it."""
    import jax
    import jax.numpy as jnp

    from simple3dformer_tpu.cli import _common as C
    from simple3dformer_tpu.core.config import load_task_config
    from simple3dformer_tpu.core.rng import DEFAULT_SEED
    from simple3dformer_tpu.models.point_vit import frozen_mask_point
    from simple3dformer_tpu.models.registry import make_point_model
    from simple3dformer_tpu_torch.cli import _common as PC
    from simple3dformer_tpu_torch.core.config import load_task_config as port_task_config
    from simple3dformer_tpu_torch.core.rng import generator
    from simple3dformer_tpu_torch.models.point_vit import frozen_mask_point as port_frozen_mask
    from simple3dformer_tpu_torch.models.registry import make_point_model as port_point_model

    task, model_task, num_class, input_dim, images = HYDRA[cli]
    overrides, _ = C.parse_cli(argv)
    cfg = load_task_config(task, overrides)
    cfg.setdefault("seed", DEFAULT_SEED)
    cfg.num_class, cfg.input_dim = num_class, input_dim(cfg)
    model = make_point_model(cfg, task=model_task, dtype=C.compute_dtype(cfg))
    x = jnp.zeros((2, int(cfg.num_point), cfg.input_dim))
    if images:  # C.init_model's two routes
        variables = jax.eval_shape(lambda k: model.init(k, x, jnp.zeros((2, 224, 224, 3)),
                                                        method=model.init_all),
                                   jax.random.key(int(cfg.seed)))
    else:
        variables = jax.eval_shape(lambda k: model.init(k, x), jax.random.key(int(cfg.seed)))
    pcfg = port_task_config(task, overrides)
    pcfg.num_class, pcfg.input_dim = num_class, input_dim(pcfg)
    # a model.init tree has no 2D pathway: the port model keeps its seeded init there
    port = port_point_model(pcfg, task=model_task, generator=generator(int(cfg.seed)))
    pretrained = bool(cfg.model.get("pretrained"))
    # train_partseg_lwf masks the 2D pathway; the other Hydra CLIs train every leaf
    tx, _ = C.reference_optimizer(
        cfg, frozen_mask_point(variables["params"], pretrained) if images else None)
    opt, _ = PC.reference_optimizer(pcfg, dict(port.named_parameters()),
                                    port_frozen_mask(port, pretrained) if images else None)
    return variables, port, tx, opt


def restore(ckpt_dir: str, step: int | None):
    """(the saved state as nested dicts, its metrics, its step) of a JAX
    Checkpointer directory, read as saved."""
    import orbax.checkpoint as ocp

    from simple3dformer_tpu.core.checkpoint import Checkpointer

    ckpt = Checkpointer(ckpt_dir)
    step = ckpt.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    restored = ckpt.manager.restore(step, args=ocp.args.Composite(
        state=ocp.args.StandardRestore(), metrics=ocp.args.JsonRestore()))
    return restored["state"], restored["metrics"], step


def check_like(template, tree, what: str) -> None:
    """``tree`` has the leaves and shapes of ``template``."""
    import jax

    want = {jax.tree_util.keystr(p): np.shape(v)
            for p, v in jax.tree_util.tree_leaves_with_path(template)}
    got = {jax.tree_util.keystr(p): np.shape(v)
           for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:6]
        raise ValueError(f"the checkpoint's {what} do not match the model the flags build: "
                         f"first differences {diff}")


def _moment_leaves(tree) -> tuple[str, dict]:
    """(the optimizer, {moment/parameter path: (shape, dtype)}) of an opt_state
    or its template; masked nodes hold no leaves."""
    import jax

    from simple3dformer_tpu_torch.utils.convert import find_optimizer_state

    kind, state = find_optimizer_state(tree)
    leaves = {}
    for moment in ("mu", "nu", "trace"):
        for path, v in jax.tree_util.tree_leaves_with_path(state.get(moment)):
            keys = [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path]
            leaves[moment + "/" + "/".join(keys)] = (tuple(np.shape(v)), str(v.dtype))
    return kind, leaves


def check_opt_state(template, tree) -> None:
    """``tree`` (a restored opt_state) holds the state of the optimizer whose
    ``init`` gave ``template``: the same optimizer, state for the same leaves
    (the trainable mask), each of the same shape and dtype. The chain and
    mask wrappers around it may differ (an all-trainable mask adds no state)."""
    want_kind, want = _moment_leaves(template)
    got_kind, got = _moment_leaves(tree)
    if want_kind != got_kind:
        what = {"Adam": "Adam's moments (mu, nu)", "SGD": "SGD's momentum (trace)"}
        raise ValueError(f"the checkpoint holds {what[got_kind]}, but the flags build "
                         f"{want_kind}")
    params = {k.split("/", 1)[1] for k in want}
    saved = {k.split("/", 1)[1] for k in got}
    if params != saved:
        raise ValueError(
            "the checkpoint's trainable mask differs from the one the flags build: state for "
            f"{sorted(saved - params)[:6]} (frozen under the flags), none for "
            f"{sorted(params - saved)[:6]} (trainable under the flags)")
    diff = [(k, got[k], want[k]) for k in sorted(want) if want[k] != got[k]]
    if diff:
        raise ValueError(f"the checkpoint's optimizer state differs from the one the flags "
                         f"build (a bf16 nu is --bf16-nu): (leaf, saved, flags) {diff[:6]}")


def convert(ckpt_dir: str, out_dir: str, cli: str, argv: list[str],
            step: int | None = None) -> str:
    """Convert one step; -> the port checkpoint's directory."""
    if cli == "train_cls_voxel":
        variables, port, tx, opt = voxel_models(argv)
    elif cli == "train_pure_mlp":
        variables, port, tx, opt = vip3d_models(argv)
    else:
        variables, port, tx, opt = point_models(cli, argv)
    state, metrics, step = restore(ckpt_dir, step)
    return write_port_step(state, metrics, step, variables, tx, port, opt, out_dir)


def write_port_step(state, metrics, step: int, variables, tx, port, opt, out_dir: str) -> str:
    """Check a restored JAX train state against the model's variables and the
    optimizer ``tx``, convert it into ``port`` and its optimizer ``opt``, and
    write it as step ``step`` of a port Checkpointer at ``out_dir``; -> the
    step's directory."""
    import jax

    from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
    from simple3dformer_tpu_torch.train.loop import TrainState
    from simple3dformer_tpu_torch.utils.convert import load_jax_opt_state, load_jax_params

    params = jax.device_get(state["params"])
    stats = jax.device_get(state.get("batch_stats") or {})
    check_like(variables["params"], params, "params")
    check_like(variables.get("batch_stats", {}), stats, "batch_stats")
    opt_state = jax.device_get(state["opt_state"])
    check_opt_state(jax.eval_shape(tx.init, variables["params"]), opt_state)
    load_jax_params(port, params, stats)
    load_jax_opt_state(opt, port, opt_state, int(state["step"]))
    Checkpointer(out_dir).save(step, TrainState(port, opt).state_dict() | {
        "step": int(state["step"])}, metrics)
    return os.path.join(os.path.abspath(out_dir), str(step))


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("jax_ckpt", help="the ckpt directory of a JAX CLI's run")
    p.add_argument("out", help="the port checkpoint directory to write")
    p.add_argument("--step", type=int, default=None, help="the step to convert (default latest)")
    p.add_argument("cli", choices=CLIS, help="the JAX CLI that wrote the checkpoint")
    p.add_argument("cli_args", nargs=argparse.REMAINDER, help="that CLI's model flags")
    args = p.parse_args(argv)
    path = convert(args.jax_ckpt, args.out, args.cli, args.cli_args, args.step)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
