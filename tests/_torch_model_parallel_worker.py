"""Worker of tests/test_torch_{tp,pp,sp}.py: the port's tensor, pipeline and
sequence parallelism on gloo CPU ranks (one process a rank, torch on one
thread), at the shapes of the JAX package's tests/test_parallel.py.

    MASTER_ADDR=localhost MASTER_PORT=<port> WORLD_SIZE=8 RANK=<r> \\
        python tests/_torch_model_parallel_worker.py CASE_DIR {tp,pp,sp}

reads ``CASE_DIR/inputs.pt`` (initial state dicts converted from the JAX
inits, the data, all from numpy seeds; written by the test) and writes
``CASE_DIR/rank<r>.pt``. Every run lays the world out as (data, inner) with
rank = d * n_inner + m, as the JAX package's mesh lays out its devices.
"""

from __future__ import annotations

import os
import sys

import torch

from simple3dformer_tpu_torch.core.rng import generator
from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
from simple3dformer_tpu_torch.models.hengshuang import PointTransformerCls
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn.layers import Block
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.parallel import mesh
from simple3dformer_tpu_torch.parallel.pp import (from_microbatches, pipeline_apply,
                                                  split_stages, to_microbatches)
from simple3dformer_tpu_torch.parallel.sp import SequenceParallel
from simple3dformer_tpu_torch.parallel.tp import TensorParallel, TPTrainState
from simple3dformer_tpu_torch.train.loop import cross_entropy, make_scanned_train_steps
from simple3dformer_tpu_torch.train.optim import make_optimizer

WORLD = 8
LR = 1e-2
# tests/test_parallel.py:190's Point Transformer, :282-335's block stacks
SP_MODEL = dict(num_point=128, num_class=5, input_dim=6, nblocks=1, nneighbor=4,
                transformer_dim=16)
PP_DIM = 32


def tp_model() -> VoxelViT:
    """tests/test_parallel.py:103's VoxelViT: deit_tiny (3 heads) on 8^3 voxels."""
    g = generator(0)
    emb = VoxelEmbed(voxel_size=8, cell_size=4, patch_size=2, embed_dim=192, generator=g)
    return VoxelViT(emb, n_classes=4, transformer_backbone="deit_tiny_patch16_224", generator=g)


def sp_model(dtype=None) -> PointTransformerCls:
    return PointTransformerCls(generator=generator(0), dtype=dtype, **SP_MODEL)


def sp_step(model, layout, x, y, cols):
    """This data rank's loss and the gradients averaged over data x seq."""
    names, params = zip(*model.named_parameters())
    with mesh.using_layout(layout), mesh.data_split(layout.n_data):
        loss = cross_entropy(SequenceParallel(model, layout)(x[cols]), y[cols])
        grads = mesh.average_gradients(list(torch.autograd.grad(loss, params)), list(params))
    return loss.detach(), {k: g.clone() for k, g in zip(names, grads)}


def block_stack(depth: int, heads: int, dim: int = PP_DIM) -> list[Block]:
    return [Block(dim, heads, generator=generator(i)) for i in range(depth)]


def state_of(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def copied(state):
    """A (nested) state dict with every tensor copied: state dicts hold views
    of the live parameters."""
    if isinstance(state, dict):
        return {k: copied(v) for k, v in state.items()}
    return state.detach().clone() if isinstance(state, torch.Tensor) else state


def tp_train(inputs, n_data: int, n_model: int, idx_key: str = "idx", init: dict | None = None):
    """SGD steps of the split VoxelViT; the gathered (full) state after them."""
    layout = mesh.make_layout(n_data, n_model, "model")
    model = tp_model()
    model.load_state_dict(inputs["tp_init"])
    tp = TensorParallel(model, layout)
    ts = TPTrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"), tp)
    reloaded = None
    if init is not None:
        ts.load_state_dict(init)
        reloaded = copied(ts.state_dict())
    with mesh.using_layout(layout):
        run = make_scanned_train_steps(ts, DeviceResidentDataset(inputs["tp_data"], "cpu"))
        loss = run(torch.from_numpy(inputs[idx_key]), LR)["loss"]
        full = copied(ts.state_dict())
    heads = [blk.tp.heads for blk in tp.blocks.values()]
    return {"loss": loss.clone(), "state": full["params"], "opt": full["opt_state"],
            "heads": heads, "mlp_split": [blk.tp.mlp_split for blk in tp.blocks.values()],
            "ts": ts, "reloaded": reloaded}


def tp_block_layered(inputs, n_data: int, n_model: int) -> dict:
    """One block on its layered route (head_dim 32 is outside the fused gate),
    split over the model ranks: output, input gradient, full weight gradients."""
    layout = mesh.make_layout(n_data, n_model, "model")
    blk = Block(96, 3, generator=generator(4))
    blk.load_state_dict(inputs["layered_init"])
    holder = torch.nn.Module()
    holder.add_module("blk", blk)
    tp = TensorParallel(holder, layout)
    x = inputs["layered_x"].clone().requires_grad_()
    with mesh.using_layout(layout):
        y = blk(x)
        assert blk.route(x) == "layered"
        names = [k for k, _ in blk.named_parameters()]
        grads = torch.autograd.grad((y * inputs["layered_g"]).sum(),
                                    [x, *[p for _, p in blk.named_parameters()]])
    local = {f"blk.{k}": g for k, g in zip(names, grads[1:])}
    return {"y": y.detach(), "gx": grads[0], "grads": tp.gather(local)}


def run_tp(inputs) -> dict:
    out = {}
    for n_data, n_model in ((2, 4), (4, 2)):
        r = tp_train(inputs, n_data, n_model)
        out[f"{n_data}x{n_model}"] = {k: r[k] for k in ("loss", "state", "opt", "heads",
                                                       "mlp_split")}
        if n_model == 4:
            saved = copied(r["ts"].state_dict())
    # a model=4 checkpoint loaded at model=2, gathered again, then one more step
    restored = tp_train(inputs, 4, 2, idx_key="next", init=saved)
    out["restored"] = {"loss": restored["loss"], "state": restored["state"],
                       "opt": restored["opt"], "saved": saved, "reloaded": restored["reloaded"]}
    out["layered"] = tp_block_layered(inputs, 2, 4)
    return out


def run_sp(inputs) -> dict:
    """One SGD step of tests/test_parallel.py:190's model, the point axis over
    seq=4, the batch over data=2; then the eval forward."""
    layout = mesh.make_layout(2, 4, "seq")
    model = sp_model()
    model.load_state_dict(inputs["sp_init"])
    sp = SequenceParallel(model, layout)
    x, y = inputs["sp_x"], inputs["sp_y"]
    with mesh.using_layout(layout):
        cols = mesh.rank_columns(torch.arange(x.shape[0])[None])[0][0]
    model.train()
    loss, grads = sp_step(model, layout, x, y, cols)
    with mesh.using_layout(layout):
        loss = mesh.all_reduce_mean(loss)
    make_optimizer(dict(model.named_parameters()), "SGD").step(grads, LR)
    model.eval()
    with torch.no_grad(), mesh.using_layout(layout):
        logits = sp(x[cols])
    # the bf16 route: the in-kernel-gather chain on every rank's queries
    bf16 = sp_model(torch.bfloat16)
    bf16.load_state_dict(inputs["sp_init"])
    bf16.train()
    bf16_loss, bf16_grads = sp_step(bf16, layout, x, y, cols)
    with mesh.using_layout(layout):
        bf16_loss = mesh.all_reduce_mean(bf16_loss)
    return {"loss": loss, "grads": grads, "state": state_of(model), "eval": logits,
            "cols": cols, "bf16": {"loss": bf16_loss, "grads": bf16_grads}}


def run_pp(inputs) -> dict:
    """tests/test_parallel.py:282 (forward), :302 (gradients) and :335 (a dp x
    pp SGD step), each on a (data=2, stage=4) layout."""
    layout = mesh.make_layout(2, 4, "stage")
    group, stage = layout.inner_group, layout.inner_rank
    out = {}
    blocks = block_stack(8, 4)
    for i, blk in enumerate(blocks):
        blk.load_state_dict(inputs["pp_fwd_init"][i])
    mine = split_stages(blocks, 4)[stage]
    with torch.no_grad(), mesh.using_layout(layout):
        out["forward"] = pipeline_apply(mine, inputs["pp_fwd_x"], group)

    blocks = block_stack(4, 2)
    for i, blk in enumerate(blocks):
        blk.load_state_dict(inputs["pp_grad_init"][i])
    ids = split_stages(list(range(4)), 4)[stage]
    mine = [blocks[i] for i in ids]
    params = [p for blk in mine for p in blk.parameters()]
    with mesh.using_layout(layout):
        loss = (pipeline_apply(mine, inputs["pp_grad_x"], group) ** 2).sum()
        grads = torch.autograd.grad(loss, params)
    it = iter(grads)
    out["grads"] = {i: {k: next(it) for k, _ in blocks[i].named_parameters()} for i in ids}

    blocks = block_stack(4, 2)
    for i, blk in enumerate(blocks):
        blk.load_state_dict(inputs["pp_dp_init"][i])
    mine = [blocks[i] for i in ids]
    named = [(f"{i}.{k}", p) for i in ids for k, p in blocks[i].named_parameters()]
    x, y = inputs["pp_dp_x"], inputs["pp_dp_y"]
    d = layout.data_rank
    with mesh.using_layout(layout):
        xs = to_microbatches(x, 2)[:, 2 * d:2 * d + 2]
        ys = to_microbatches(y, 2)[:, 2 * d:2 * d + 2]
        outs = pipeline_apply(mine, xs, group)
        loss = ((from_microbatches(outs)[:, 0] - from_microbatches(ys)) ** 2).mean()
        grads = mesh.average_gradients(list(torch.autograd.grad(loss, [p for _, p in named])),
                                       [p for _, p in named])
        loss = mesh.all_reduce_mean(loss)
    with torch.no_grad():
        new = {k: p - LR * g for (k, p), g in zip(named, grads)}
    out["dp"] = {"loss": loss, "params": new}
    out["stage"] = stage
    return out


RUNS = {"tp": run_tp, "pp": run_pp, "sp": run_sp}


def main(case_dir: str, what: str) -> None:
    torch.set_num_threads(1)
    assert mesh.multihost_init("cpu") and mesh.world_size() == WORLD
    inputs = torch.load(os.path.join(case_dir, "inputs.pt"), weights_only=False)
    out = RUNS[what](inputs)
    out["rank"] = mesh.rank()
    torch.save(out, os.path.join(case_dir, f"rank{mesh.rank()}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
