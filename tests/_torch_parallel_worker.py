"""Worker of tests/test_torch_parallel.py: the port's data-parallel training
steps at the world size the environment names (one process a rank, gloo,
torch on one thread).

    MASTER_ADDR=localhost MASTER_PORT=<port> WORLD_SIZE=2 RANK=<r> \\
        python tests/_torch_parallel_worker.py CASE_DIR

reads ``CASE_DIR/inputs.pt`` (the models' initial state dicts, the data and
the index matrices, written by the test) and writes ``CASE_DIR/rank<r>.pt``:
each scenario's per-step losses, final state dict and eval logits, the ZeRO-1
runs' parameters and gathered moments, the draws of the global-batch helpers,
and the warning of a batch that does not divide. Rank 0 also writes a ZeRO-1
checkpoint under ``CASE_DIR/ckpt``. The test runs the same functions in its
own process, without a process group, for world size 1.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import warnings

import torch

from simple3dformer_tpu_torch.cli.train_partseg import make_prepare_fn, seg_augment
from simple3dformer_tpu_torch.core import rng
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.core.rng import generator, step_seed
from simple3dformer_tpu_torch.data.image_augment import device_random_resized_crop_flip
from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
from simple3dformer_tpu_torch.models.hengshuang import PointTransformerCls
from simple3dformer_tpu_torch.models.point_vit import PointViT
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn import vit
from simple3dformer_tpu_torch.nn.layers import set_bn_momentum
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.parallel import mesh
from simple3dformer_tpu_torch.train.loop import (TrainState, cross_entropy, make_scanned_eval,
                                                 make_scanned_train_steps, seg_cross_entropy)
from simple3dformer_tpu_torch.train.lwf import make_scanned_lwf_train_steps
from simple3dformer_tpu_torch.train.optim import make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300  # each rank's limit
# a two-block, 96-wide backbone: the flagship's shape at test width
TINY = dict(patch_size=16, embed_dim=96, depth=2, num_heads=3, mlp_ratio=4.0, qkv_bias=True)
N_POINT, K, HENG = 64, 8, dict(nblocks=2, nneighbor=8, transformer_dim=64)
SGD_LR, ADAM_LR = 0.01, 1e-3


def register_tiny() -> None:
    vit.BACKBONES.setdefault("dp_tiny", TINY)
    vit.TEACHER_BACKBONES.setdefault("dp_tiny", TINY)


def flagship_model() -> VoxelViT:
    register_tiny()
    g = generator(0)
    emb = VoxelEmbed(voxel_size=8, cell_size=4, patch_size=2, embed_dim=96, generator=g)
    return VoxelViT(emb, n_classes=4, transformer_backbone="dp_tiny", generator=g)


def partseg_model() -> PointViT:
    register_tiny()
    m = PointViT("3DViT", "seg", N_POINT, 50, input_dim=22, nneighbor=K,
                 transformer_backbone="dp_tiny", generator=generator(0))
    set_bn_momentum(m, 0.1)  # the partseg CLI's first epoch, flax's convention
    return m


def hengshuang_model() -> PointTransformerCls:
    return PointTransformerCls(N_POINT, 40, 6, generator=generator(0), **HENG)


MODELS = {"flagship": flagship_model, "partseg": partseg_model, "hengshuang": hengshuang_model}


class Sampled(torch.nn.Module):
    """The partseg model with FPS start points drawn each step from a CPU
    generator seeded with the step (the global batch's draws)."""

    def __init__(self, model: PointViT, state_step):
        super().__init__()
        self.m, self.state_step = model, state_step

    def forward(self, x):
        return self.m(x, sample_generator=generator(step_seed(3, self.state_step())))


def train(model, data, idx, loss_fn=cross_entropy, optimizer="SGD", lr=SGD_LR, **kw) -> dict:
    """The scanned train steps over ``idx``: per-step losses, the final state dict."""
    opt_kw = {k: kw.pop(k) for k in ("zero1", "bf16_nu") if k in kw}
    opt = make_optimizer(dict(model.named_parameters()), optimizer, **opt_kw)
    state = TrainState(model, opt)
    run = make_scanned_train_steps(state, DeviceResidentDataset(data, "cpu"), loss_fn=loss_fn,
                                   **kw)
    losses = run(torch.from_numpy(idx), lr)["loss"]
    return {"loss": losses.clone(), "state": state_of(model), "opt": opt, "ts": state}


def state_of(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_models(inputs) -> dict:
    """The flagship, the partseg 3DViT and Hengshuang, three SGD steps each from
    the converted JAX init; eval logits of the flagship at a batch that
    divides and at one that does not."""
    out = {}
    for name in MODELS:
        model = MODELS[name]()
        model.load_state_dict(inputs["init"][name])
        kw = {}
        if name == "partseg":
            kw = dict(loss_fn=seg_cross_entropy, prepare_fn=make_prepare_fn())
        r = train(model, inputs["data"][name], inputs["idx"][name], **kw)
        out[name] = {"loss": r["loss"], "state": r["state"]}
        if name == "flagship":
            ev = make_scanned_eval(model, DeviceResidentDataset(inputs["data"][name], "cpu"))
            out[name]["eval"] = ev(torch.from_numpy(inputs["idx"]["eval"]))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out[name]["eval_odd"] = ev(torch.from_numpy(inputs["idx"]["eval_odd"]))
            out[name]["odd_warning"] = [str(w.message) for w in caught]
    # the partseg model with its augmentation and FPS start points drawn
    # for the global batch
    model = partseg_model()
    model.load_state_dict(inputs["init"]["partseg"])
    holder = {}
    wrapped = Sampled(model, lambda: holder["ts"].step)
    aug = torch.Generator().manual_seed(5)
    opt = make_optimizer(dict(wrapped.named_parameters()), "SGD")
    holder["ts"] = TrainState(wrapped, opt)
    run = make_scanned_train_steps(holder["ts"], DeviceResidentDataset(inputs["data"]["partseg"],
                                                                       "cpu"),
                                   loss_fn=seg_cross_entropy, prepare_fn=make_prepare_fn(),
                                   augment_fn=lambda x: seg_augment(aug, x))
    out["partseg_aug"] = {"loss": run(torch.from_numpy(inputs["idx"]["partseg"]), SGD_LR)["loss"],
                          "state": state_of(model)}
    # the class-weighted loss with the classes split unevenly over the ranks
    model = flagship_model()
    model.load_state_dict(inputs["init"]["flagship"])
    r = train(model, inputs["data"]["weighted"], inputs["idx"]["weighted"],
              class_weights=torch.tensor([0.25, 1.0, 2.0, 4.0]))
    out["weighted"] = {"loss": r["loss"], "state": r["state"]}
    # a batch that does not divide by the world size: whole on every rank
    model = flagship_model()
    model.load_state_dict(inputs["init"]["flagship"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r = train(model, inputs["data"]["flagship"], inputs["idx"]["odd"])
    out["odd"] = {"loss": r["loss"], "state": r["state"],
                  "warning": [str(w.message) for w in caught]}
    return out


def lwf_setup(inputs, zero1: bool):
    model = flagship_model()
    model.load_state_dict(inputs["init"]["flagship"])
    teacher = vit.make_teacher("dp_tiny", generator=generator(1))
    opt = make_optimizer(dict(model.named_parameters()), "Adam", zero1=zero1)
    state = TrainState(model, opt)
    run = make_scanned_lwf_train_steps(
        state, teacher, DeviceResidentDataset(inputs["data"]["flagship"], "cpu"),
        DeviceResidentDataset({"images": inputs["images"]}, "cpu"), lambda_weight=0.1,
        image_augment_fn=device_random_resized_crop_flip, seed=9)
    return model, run


def run_zero1(inputs, ckpt_dir: str | None) -> dict:
    """Replicated Adam against ZeRO-1, f32 and bf16 nu and with LwF: three
    steps each. The f32 ZeRO-1 run then writes a checkpoint (rank 0) and takes
    a fourth step."""
    out = {}
    data, idx = inputs["data"]["flagship"], inputs["idx"]["flagship"]
    for bf16_nu in (False, True):
        for zero1 in (False, True):
            model = flagship_model()
            model.load_state_dict(inputs["init"]["flagship"])
            r = train(model, data, idx, optimizer="Adam", lr=ADAM_LR, zero1=zero1,
                      bf16_nu=bf16_nu)
            key = f"adam{'_bf16' if bf16_nu else ''}{'_zero1' if zero1 else ''}"
            out[key] = {"loss": r["loss"], "state": r["state"]}
            if zero1 and not bf16_nu:
                out[key]["shard"] = int(r["opt"].mu.numel())
                out[key]["moments"] = r["opt"].state_dict()
                if ckpt_dir is not None:
                    Checkpointer(ckpt_dir).save(3, r["ts"].state_dict())
                run = make_scanned_train_steps(r["ts"], DeviceResidentDataset(data, "cpu"))
                run(torch.from_numpy(inputs["idx"]["next"]), ADAM_LR)
                out[key]["next"] = state_of(model)
    for zero1 in (False, True):
        model, run = lwf_setup(inputs, zero1)
        metrics = run(torch.from_numpy(idx), torch.from_numpy(inputs["idx"]["images"]), ADAM_LR)
        out[f"lwf{'_zero1' if zero1 else ''}"] = {"loss": metrics["loss"],
                                                 "state": state_of(model)}
    return out


def run_draws() -> dict:
    """The global-batch draw helpers under the step's split."""
    g = torch.Generator().manual_seed(11)
    with mesh.data_split(mesh.world_size()):
        return {"rand": rng.rand((4, 3), g), "rand_axis1": rng.rand((2, 4), g, axis=1),
                "randint": rng.randint(0, 1000, (4,), g)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(args: list[str], world: int = 2, timeout: int = TIMEOUT_S, cwd: str = REPO,
                extra_env: dict | None = None) -> list[str]:
    """``python <args>`` once a rank over an env:// rendezvous on localhost,
    no card visible, torch on one thread; returns the ranks' outputs (stdout
    and stderr). Each rank runs under ``timeout`` seconds; a rank that fails
    or times out fails the caller."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
                   OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
        procs.append(subprocess.Popen([sys.executable, *args], env=env, cwd=cwd, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def main(case_dir: str) -> None:
    torch.set_num_threads(1)
    assert mesh.multihost_init("cpu") and mesh.world_size() == 2
    inputs = torch.load(os.path.join(case_dir, "inputs.pt"), weights_only=False)
    out = {"world": mesh.world_size(), "rank": mesh.rank(), "draws": run_draws()}
    out.update(run_models(inputs))
    out.update(run_zero1(inputs, os.path.join(case_dir, "ckpt")))
    torch.save(out, os.path.join(case_dir, f"rank{mesh.rank()}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
