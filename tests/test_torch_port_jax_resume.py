"""A JAX run resumed in the port, on the CPU: the JAX package takes K = 2
train steps of the flagship VoxelViT (at test width: a two-block, 96-wide
backbone) and saves its whole TrainState with its own Checkpointer;
``scripts/jax_checkpoint_to_torch.py`` converts it (parameters and optimizer
state); the port restores it through ``Checkpointer.restore_into`` and takes
step K+1 on the same batch and lr, which is held to the JAX package's step K+1.
Every optimizer form the JAX package builds: Adam (under the voxel CLI's
all-trainable mask), Adam with weight decay (the Hydra CLIs' chain), Adam with
bf16 nu, SGD with momentum, and Adam under a ``--pretrained`` mask whose frozen
leaves hold no state; the Adam import loaded into ``Zero1Adam`` at world 2 over
gloo; and the refusals of another optimizer and another mask.

Bounds of step K+1 (the state before it is the JAX state itself, so only the
step's gradient differs, by f32 sums in another order):

- SGD: parameters and trace within rtol 2e-4, atol 2e-5, the port's SGD parity
  bound (tests/test_torch_parallel.py).
- Adam: parameters within lr. Adam's update is about lr whatever the gradient's
  scale, so a component whose gradient is all rounding noise may move by up to
  lr the other way (tests/test_torch_port_train.py bounds three steps by 3 lr);
  and all but 1% of the elements within 1e-6 (measured 0.03%, 1.5e-5 at most,
  where a step moves a parameter by 1.6e-4 at the median), which a step that
  was lost or taken twice would break.
  mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2 take the gradient's own
  error: within 1e-4 of the leaf's largest value and rtol 1e-3.
- bf16 nu: as Adam, nu within one bf16 step (2**-8 relative), where a rounding of
  the f32 sum can fall either side, and 1e-4 of the leaf's largest value (a
  gradient of rounding noise, such as the key bias's, has no relative bound).
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.core.checkpoint import Checkpointer as JaxCheckpointer
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.models.voxel_vit import frozen_mask as jax_frozen_mask
from simple3dformer_tpu.nn import vit as jax_vit
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import make_train_step as jax_make_train_step
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT, frozen_mask
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.train import optim
from simple3dformer_tpu_torch.train.loop import TrainState, make_train_step
from simple3dformer_tpu_torch.utils import convert

import _torch_parallel_worker as W

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "jax_checkpoint_to_torch.py"
V, CELL, PATCH, D, IMG, B, CLASSES = 8, 4, 2, 96, 32, 4, 5
K_STEPS = 2
SGD_TOL = dict(rtol=2e-4, atol=2e-5)
MOMENT_REL, MOMENT_RTOL = 1e-4, 1e-3
ADAM_CLOSE, ADAM_FAR_SHARE = 1e-6, 1e-2
# name -> (JAX optimizer, port optimizer kwargs, lr): the forms train/optim builds
CASES = {
    "adam": (lambda p: jax_optim.make_optimizer("Adam", trainable_mask=jax_frozen_mask(p, False)),
             dict(optimizer="Adam"), 1e-3),
    "adam_wd": (lambda p: jax_optim.make_optimizer("Adam", weight_decay=1e-2),
                dict(optimizer="Adam", weight_decay=1e-2), 1e-3),
    "adam_bf16_nu": (lambda p: jax_optim.make_optimizer(
        "Adam", trainable_mask=jax_frozen_mask(p, False), bf16_nu=True),
        dict(optimizer="Adam", bf16_nu=True), 1e-3),
    "sgd": (lambda p: jax_optim.make_optimizer("SGD"), dict(optimizer="SGD"), 0.01),
    "masked": (lambda p: jax_optim.make_optimizer("Adam", trainable_mask=jax_frozen_mask(p, True)),
               dict(optimizer="Adam", pretrained=True), 1e-3),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def script():
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_model() -> VoxelViT:
    W.register_tiny()
    return VoxelViT(VoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=D),
                    n_classes=CLASSES, transformer_backbone="dp_tiny", img_size=IMG)


def port_optimizer(model, optimizer="Adam", pretrained=False, **kw):
    """The port's optimizer as the port's CLIs build it."""
    return optim.make_optimizer(dict(model.named_parameters()), optimizer,
                                trainable_mask=frozen_mask(model, pretrained), **kw)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model, its variables (every leaf perturbed: zero-initialised
    leaves move too) and the K+1 batches."""
    jax_vit.BACKBONES.setdefault("dp_tiny", W.TINY)
    jm = JaxVoxelViT(voxel_embed=JaxVoxelEmbed(voxel_size=V, cell_size=CELL, patch_size=PATCH,
                                               embed_dim=D),
                     n_classes=CLASSES, transformer_backbone="dp_tiny", img_size=IMG)
    variables = jax.jit(lambda k, a, b: jm.init(k, a, b, method=jm.init_all))(
        jax.random.key(0), jnp.zeros((2, V, V, V)), jnp.zeros((1, IMG, IMG, 3)))
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    batches = [{"x": (rs.rand(B, V, V, V) > 0.7).astype(np.float32),
                "y": rs.randint(0, CLASSES, B).astype(np.int32)} for _ in range(K_STEPS + 1)]
    return jm, params, batches


@pytest.fixture(scope="module")
def runs(jax_model, tmp_path_factory):
    """For each case: the JAX run (K steps, saved at step 1, the K+1st step)
    converted by the script and resumed in the port. -> {case: dict}."""
    jm, params, batches = jax_model
    template = jax.eval_shape(lambda p: p, params)
    out = {}
    for name, (make_tx, port_kw, lr) in CASES.items():
        d = tmp_path_factory.mktemp(name)
        tx = make_tx(params)
        jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
        jstep = jax_make_train_step(jm, tx, donate=False)
        for batch in batches[:K_STEPS]:
            jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, lr,
                              jax.random.key(1))
        JaxCheckpointer(str(d / "jax")).save(1, jstate, {"accuracy": 0.5})
        after, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[-1].items()}, lr,
                         jax.random.key(1))

        conv = script()
        saved, metrics, step = conv.restore(str(d / "jax"), None)
        model = port_model()
        conv.write_port_step(saved, metrics, step, {"params": template}, tx, model,
                             port_optimizer(model, **port_kw), str(d / "port"))

        # the port CLI's train state, restored and stepped
        model = port_model()
        state = TrainState(model, port_optimizer(model, **port_kw))
        restored, metrics = Checkpointer(str(d / "port")).restore_into(state)
        assert restored is state and metrics == {"accuracy": 0.5}
        before = {k: v.clone() for k, v in model.state_dict().items()}
        resumed = {"count": state.optimizer.count,
                   "state": {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
                             for k, v in state.optimizer.state_dict().items()}}
        make_train_step(state)({k: torch.from_numpy(v) for k, v in batches[-1].items()}, lr)
        out[name] = dict(jax_before=jstate, jax_after=after, model=model, opt=state.optimizer,
                         before=before, resumed=resumed, lr=lr, dir=d)
    return out


def _jax_moments(run, kind, which="jax_after"):
    """A JAX moment tree (masked nodes dropped) as port names."""
    _, st = convert.find_optimizer_state(jax.device_get(run[which].opt_state))
    return convert._moments(st[kind], run["model"].state_dict())


@pytest.mark.parametrize("case", list(CASES))
def test_import_is_the_jax_state(runs, case):
    """Before step K+1 the port holds the JAX state bit for bit: parameters,
    count and every moment (nu in bf16 where the JAX nu is)."""
    run = runs[case]
    assert run["resumed"]["count"] == int(run["jax_before"].step) == K_STEPS
    want = convert.jax_to_state_dict(jax.device_get(run["jax_before"].params), run["before"])
    for k, v in want.items():
        assert torch.equal(run["before"][k], v), k
    for kind in (("trace",) if case == "sgd" else ("mu", "nu")):
        jm = _jax_moments(run, kind, "jax_before")
        got = run["resumed"]["state"][kind]
        assert set(got) == set(run["opt"].names)
        for k in got:
            assert got[k].dtype == (torch.bfloat16 if case == "adam_bf16_nu" and kind == "nu"
                                    else torch.float32)
            assert torch.equal(got[k].float(), jm[k]), (kind, k)


@pytest.mark.parametrize("case", list(CASES))
def test_step_after_resume_matches_jax(runs, case):
    run = runs[case]
    opt, lr = run["opt"], run["lr"]
    assert opt.count == int(run["jax_after"].step) == K_STEPS + 1
    want = convert.jax_to_state_dict(jax.device_get(run["jax_after"].params),
                                     run["model"].state_dict())
    got = run["model"].state_dict()
    moved = 0
    for k, v in want.items():
        tol = SGD_TOL if case == "sgd" else dict(rtol=0, atol=lr)
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)
        moved += not torch.equal(got[k], run["before"][k])
    assert moved > len(opt.names) // 2  # the step moved the parameters
    diff = torch.cat([(got[k] - v).abs().reshape(-1) for k, v in want.items()])
    assert float((diff > ADAM_CLOSE).double().mean()) <= ADAM_FAR_SHARE
    for kind in (("trace",) if case == "sgd" else ("mu", "nu")):
        jm = _jax_moments(run, kind)
        ours = opt.state_dict()[kind]
        assert set(ours) == set(opt.names)
        for k in opt.names:
            a, b = ours[k].double().numpy(), jm[k].double().numpy()
            if case == "sgd":
                np.testing.assert_allclose(a, b, err_msg=k, **SGD_TOL)
            elif case == "adam_bf16_nu" and kind == "nu":
                np.testing.assert_allclose(a, b, rtol=2.0 ** -8,
                                           atol=MOMENT_REL * float(np.abs(b).max()), err_msg=k)
            else:
                np.testing.assert_allclose(a, b, rtol=MOMENT_RTOL,
                                           atol=MOMENT_REL * float(np.abs(b).max()), err_msg=k)


def test_frozen_leaves_hold_no_state_and_stay_bit_equal(runs):
    run = runs["masked"]
    frozen = [k for k, trainable in frozen_mask(run["model"], True).items() if not trainable]
    assert frozen and not set(frozen) & set(run["opt"].names)
    assert not set(frozen) & set(run["resumed"]["state"]["mu"])
    for k in frozen:
        assert torch.equal(run["model"].state_dict()[k], run["before"][k]), k
    # the JAX state has masked nodes there, and the same trainable leaves
    assert set(_jax_moments(run, "mu")) == set(run["opt"].names)


def test_another_optimizer_or_mask_is_refused(runs, jax_model):
    """The script names what differs: Adam moments into an SGD run and the
    reverse, a mask other than the flags', a bf16 nu into an f32 one."""
    _, params, _ = jax_model
    template = {"params": jax.eval_shape(lambda p: p, params)}
    conv = script()

    def convert_with(case, tx, **port_kw):
        saved, metrics, step = conv.restore(str(runs[case]["dir"] / "jax"), None)
        model = port_model()
        conv.write_port_step(saved, metrics, step, template, tx, model,
                             port_optimizer(model, **port_kw), str(runs[case]["dir"] / "again"))

    with pytest.raises(ValueError, match=r"holds Adam's moments \(mu, nu\), but the flags "
                                         "build SGD"):
        convert_with("adam", jax_optim.make_optimizer("SGD"), optimizer="SGD")
    with pytest.raises(ValueError, match=r"holds SGD's momentum \(trace\), but the flags "
                                         "build Adam"):
        convert_with("sgd", jax_optim.make_optimizer("Adam"))
    with pytest.raises(ValueError, match="trainable mask differs .* none for .*head"):
        convert_with("masked", jax_optim.make_optimizer(
            "Adam", trainable_mask=jax_frozen_mask(params, False)))
    with pytest.raises(ValueError, match=r"state for .*head.*\(frozen under the flags\)"):
        convert_with("adam", jax_optim.make_optimizer(
            "Adam", trainable_mask=jax_frozen_mask(params, True)), pretrained=True)
    with pytest.raises(ValueError, match="a bf16 nu is --bf16-nu"):
        convert_with("adam_bf16_nu", jax_optim.make_optimizer("Adam"))
    # the converter itself refuses a port optimizer of the other kind or mask
    _, st = convert.find_optimizer_state(jax.device_get(runs["adam"]["jax_before"].opt_state))
    model = port_model()
    with pytest.raises(ValueError, match="the JAX optimizer state is Adam's"):
        convert.load_jax_opt_state(port_optimizer(model, "SGD"), model, st, K_STEPS)
    with pytest.raises(ValueError, match="a different mask"):
        convert.load_jax_opt_state(port_optimizer(model, pretrained=True), model, st, K_STEPS)


# the world-2 worker: the converted Adam checkpoint restored into Zero1Adam,
# each rank's part and the K+1st step over the global batch split in two
ZERO1_WORKER = """
import os, sys
import torch
import _torch_parallel_worker as W
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.parallel import mesh
from simple3dformer_tpu_torch.train.loop import TrainState, make_scanned_train_steps
from simple3dformer_tpu_torch.train.optim import make_optimizer
d = sys.argv[1]
torch.set_num_threads(1)
assert mesh.multihost_init("cpu") and mesh.world_size() == 2
inputs = torch.load(os.path.join(d, "inputs.pt"))
W.register_tiny()
model = VoxelViT(VoxelEmbed(**inputs["embed"]), n_classes=inputs["classes"],
                 transformer_backbone="dp_tiny", img_size=inputs["img"])
opt = make_optimizer(dict(model.named_parameters()), "Adam", zero1=True)
state = TrainState(model, opt)
Checkpointer(os.path.join(d, "port")).restore_into(state)
part = {"lo": opt.lo, "hi": opt.hi, "mu": opt.mu.clone(), "nu": opt.nu.clone(), "count": opt.count}
run = make_scanned_train_steps(state, DeviceResidentDataset(inputs["batch"], "cpu"))
run(torch.arange(len(inputs["batch"]["y"]))[None], inputs["lr"])
torch.save({"part": part, "params": model.state_dict()}, os.path.join(d, f"rank{mesh.rank()}.pt"))
torch.distributed.destroy_process_group()
"""


def test_zero1_at_world_2_takes_its_part_of_the_import(runs, jax_model):
    """The converted Adam state loaded into Zero1Adam on two gloo ranks: each
    rank's part of mu and nu is that range of the replicated import, laid end
    to end; the K+1st step over the global batch is the JAX step's."""
    _, _, batches = jax_model
    run = runs["adam"]
    d = run["dir"]
    torch.save({"embed": dict(voxel_size=V, cell_size=CELL, patch_size=PATCH, embed_dim=D),
                "classes": CLASSES, "img": IMG, "lr": run["lr"],
                "batch": {k: torch.from_numpy(v) for k, v in batches[-1].items()}},
               d / "inputs.pt")
    W.spawn_ranks(["-c", ZERO1_WORKER, str(d)])
    replicated = run["resumed"]["state"]
    names = run["opt"].names
    flat = {k: torch.cat([replicated[k][n].reshape(-1) for n in names]) for k in ("mu", "nu")}
    want = convert.jax_to_state_dict(jax.device_get(run["jax_after"].params),
                                     run["model"].state_dict())
    ranges = []
    for r in range(2):
        got = torch.load(d / f"rank{r}.pt")
        part = got["part"]
        ranges.append((part["lo"], part["hi"]))
        assert part["count"] == K_STEPS
        for k in ("mu", "nu"):
            assert torch.equal(part[k], flat[k][part["lo"]:part["hi"]]), (r, k)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=0,
                                       atol=run["lr"], err_msg=f"rank {r} {k}")
    assert ranges[0] == (0, ranges[1][0]) and ranges[1][1] == flat["mu"].numel()
