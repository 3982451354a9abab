"""The port's data parallelism (simple3dformer_tpu_torch/parallel) on the CPU:
two ranks over gloo, spawned once for the file (tests/_torch_parallel_worker.py,
torch on one thread each), against the port at world size 1 on the same
global batch and against the JAX package's step on a 2-device mesh of the
conftest's virtual CPU devices, from one converted init.

The rule is the JAX package's (tests/test_parallel.py:41): world size n
computes what world size 1 computes, to within reduction order. SGD, as
there: Adam amplifies reduction-order differences. ZeRO-1 is exact:
its parameters are bit-equal to replicated Adam's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_parallel_worker as W
from simple3dformer_tpu.cli.train_partseg import make_prepare_fn as jax_prepare_fn
from simple3dformer_tpu.data.pipeline import DeviceResidentDataset as JaxDataset
from simple3dformer_tpu.models.hengshuang import PointTransformerCls as JaxHengshuang
from simple3dformer_tpu.models.point_vit import PointViT as JaxPointViT
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn import vit as jax_vit
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.parallel.mesh import ShardingRules, make_mesh
from simple3dformer_tpu.train import optim as jax_optim
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import cross_entropy as jax_ce
from simple3dformer_tpu.train.loop import make_scanned_train_steps as jax_scanned
from simple3dformer_tpu.train.loop import seg_cross_entropy as jax_seg_ce
from simple3dformer_tpu_torch.core import rng
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer
from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
from simple3dformer_tpu_torch.models.voxel_vit import PostNormEncoderLayer
from simple3dformer_tpu_torch.parallel import mesh
from simple3dformer_tpu_torch.parallel.zero import Zero1Adam, sharded_fraction
from simple3dformer_tpu_torch.train.loop import TrainState, make_scanned_train_steps
from simple3dformer_tpu_torch.train.optim import make_optimizer
from simple3dformer_tpu_torch.utils import convert

REPO = W.REPO
# tests/test_parallel.py:52-61's tolerances
LOSS_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
ODD_WARNING = "not divisible by data-axis size 2: running replicated"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_models():
    jax_vit.BACKBONES.setdefault("dp_tiny", W.TINY)
    return {
        "flagship": (JaxVoxelViT(voxel_embed=JaxVoxelEmbed(voxel_size=8, cell_size=4,
                                                           patch_size=2, embed_dim=96),
                                 n_classes=4, transformer_backbone="dp_tiny"),
                     (2, 8, 8, 8)),
        "partseg": (JaxPointViT(variant="3DViT", task="seg", num_point=W.N_POINT, num_class=50,
                                input_dim=22, nneighbor=W.K, transformer_backbone="dp_tiny",
                                bn_momentum=0.1), (2, W.N_POINT, 22)),
        "hengshuang": (JaxHengshuang(num_point=W.N_POINT, num_class=40, input_dim=6, **W.HENG),
                       (2, W.N_POINT, 6)),
    }


def _inputs():
    """Initial states from the JAX inits (parameters perturbed off init), the
    data and the index matrices, all from numpy seeds."""
    rs = np.random.RandomState(0)
    init, jax_vars = {}, {}
    for i, (name, (jm, shape)) in enumerate(_jax_models().items()):
        variables = jax.device_get(jax.jit(jm.init)(jax.random.key(i), jnp.zeros(shape)))
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32),
            variables["params"])
        stats = variables.get("batch_stats", {})
        pm = W.MODELS[name]()
        convert.load_jax_params(pm, params, stats)
        init[name] = W.state_of(pm)
        jax_vars[name] = (jm, params, stats)
    cats = rs.randint(0, 16, 32).astype(np.int32)
    from simple3dformer_tpu_torch.train.eval_metrics import SEG_CLASSES

    segs = np.stack([rs.choice(SEG_CLASSES[list(SEG_CLASSES)[c]], W.N_POINT)
                     for c in cats]).astype(np.int32)
    cloud = rs.randn(32, W.N_POINT, 6).astype(np.float32)
    cloud[..., :3] = rs.rand(32, W.N_POINT, 3)
    weighted_y = np.concatenate([np.zeros(32), rs.randint(1, 4, 32)]).astype(np.int32)
    data = {
        "flagship": {"x": (rs.rand(64, 8, 8, 8) > 0.7).astype(np.uint8),
                     "y": rs.randint(0, 4, 64).astype(np.int32)},
        "partseg": {"x": rs.randn(32, W.N_POINT, 6).astype(np.float32), "cls": cats, "y": segs},
        "hengshuang": {"x": cloud, "y": rs.randint(0, 40, 32).astype(np.int32)},
    }
    data["weighted"] = {"x": data["flagship"]["x"], "y": weighted_y}
    idx = {
        "flagship": rs.randint(0, 64, (3, 16)).astype(np.int32),
        "partseg": rs.randint(0, 32, (3, 4)).astype(np.int32),
        "hengshuang": rs.randint(0, 32, (3, 4)).astype(np.int32),
        # rank 0's columns all of class 0 (weight 0.25), rank 1's of classes 1-3
        "weighted": np.concatenate([rs.randint(0, 32, (2, 8)), rs.randint(32, 64, (2, 8))],
                                   axis=1).astype(np.int32),
        "odd": rs.randint(0, 64, (2, 15)).astype(np.int32),
        "eval": rs.randint(0, 64, (2, 16)).astype(np.int32),
        "eval_odd": rs.randint(0, 64, (1, 7)).astype(np.int32),
        "next": rs.randint(0, 64, (1, 16)).astype(np.int32),
        "images": rs.randint(0, 16, (3, 4)).astype(np.int32),
    }
    images = rs.randint(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    return {"init": init, "data": data, "idx": idx, "images": images}, jax_vars


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 ranks' results, the world-1 results and the JAX inputs."""
    case = tmp_path_factory.mktemp("dp")
    inputs, jax_vars = _inputs()
    torch.save(inputs, case / "inputs.pt")
    W.spawn_ranks([os.path.join(REPO, "tests", "_torch_parallel_worker.py"), str(case)])
    ranks = [torch.load(case / f"rank{r}.pt", weights_only=False) for r in range(2)]
    world1 = W.run_models(inputs)
    return {"ranks": ranks, "world1": world1, "inputs": inputs, "jax": jax_vars,
            "ckpt": str(case / "ckpt")}


def _close_states(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        if v.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **PARAM_TOL,
                                       err_msg=f"{what}: {k}")
        else:
            assert torch.equal(got[k], v), (what, k)


WORLD_CASES = ["flagship", "partseg", "hengshuang", "partseg_aug", "weighted", "odd"]


@pytest.mark.parametrize("case", WORLD_CASES)
def test_world2_matches_world1(runs, case):
    """Losses and the whole state (parameters, BatchNorm statistics) after the
    steps at world 2 against world 1 on the same global batches: with the
    augmentation and FPS start points drawn for the global batch
    (partseg_aug), the class-weighted loss with rank 0's columns all of one
    class (weighted), and a batch of 15 that runs whole on both ranks (odd)."""
    w1 = runs["world1"][case]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[case]["loss"].numpy(), w1["loss"].numpy(), **LOSS_TOL)
        _close_states(r[case]["state"], w1["state"], case)


@pytest.mark.parametrize("case", WORLD_CASES + ["adam", "adam_zero1", "lwf_zero1"])
def test_ranks_hold_bit_equal_state(runs, case):
    """Every rank ends with the same parameters and BatchNorm running
    statistics to the bit, and prints the same losses."""
    r0, r1 = (r[case] for r in runs["ranks"])
    assert torch.equal(r0["loss"], r1["loss"])
    assert r0["state"].keys() == r1["state"].keys()
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), (case, k)
    if case in ("partseg", "hengshuang"):
        assert any("running_var" in k for k in r0["state"])


def _jax_mesh2_run(runs, name):
    jm, params, stats = runs["jax"][name]
    inputs = runs["inputs"]
    mesh2 = make_mesh(n_data=2, devices=jax.devices()[:2])
    rules = ShardingRules(mesh2)
    tx = jax_optim.make_optimizer("SGD")
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                               jax.tree_util.tree_map(jnp.asarray, stats) if stats else None)
    state = jax.device_put(state, rules.params)
    kw = {"has_batch_stats": bool(stats)}
    if name == "partseg":
        kw.update(loss_fn=jax_seg_ce, prepare_fn=jax_prepare_fn())
    else:
        kw.update(loss_fn=jax_ce)
    run = jax_scanned(jm, tx, JaxDataset(inputs["data"][name], mesh=mesh2), rules, **kw)
    state, metrics = run(state, rules.put_scan_idx(inputs["idx"][name]), W.SGD_LR,
                         jax.random.key(7))
    like = runs["world1"][name]["state"]
    want = convert.jax_to_state_dict(jax.device_get(state.params), like,
                                     jax.device_get(state.batch_stats) or None)
    return np.asarray(metrics["loss"]), want


@pytest.mark.parametrize("name", ["flagship", "partseg", "hengshuang"])
def test_world2_matches_jax_two_device_mesh(runs, name):
    """The port at world 2 against the JAX package's scanned step on a
    2-device mesh (the batch sharded over ``data``, BatchNorm statistics over
    the sharded array), from the same parameters, dropout off."""
    loss, want = _jax_mesh2_run(runs, name)
    got = runs["ranks"][0][name]
    np.testing.assert_allclose(got["loss"].numpy(), loss, **LOSS_TOL)
    for k, v in want.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), **PARAM_TOL,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("pair", [("adam", "adam_zero1"), ("adam_bf16", "adam_bf16_zero1"),
                                  ("lwf", "lwf_zero1")])
def test_zero1_is_bit_equal_to_replicated_adam(runs, pair):
    """ZeRO-1 (each rank's part of the moments, the Adam kernel's plain
    version over ``p.view(-1)[a:b]`` pieces, then the all-gather) against
    replicated Adam at world 2: three steps, f32 and bf16 nu, and with LwF."""
    for r in runs["ranks"]:
        rep, zero = r[pair[0]], r[pair[1]]
        assert torch.equal(rep["loss"], zero["loss"])
        for k in rep["state"]:
            assert torch.equal(rep["state"][k], zero["state"][k]), (pair, k)
        assert rep["state"].keys() == zero["state"].keys()


def test_zero1_shards_and_gathers_the_moments(runs):
    """Each rank holds half the moments (the last part shorter) and
    ``state_dict`` gathers the same full moments on both ranks."""
    r0, r1 = (r["adam_zero1"] for r in runs["ranks"])
    total = sum(v.numel() for k, v in runs["world1"]["flagship"]["state"].items()
                if not k.startswith("running"))
    assert r0["shard"] == -(-total // 2) and r0["shard"] + r1["shard"] == total
    for part in ("mu", "nu"):
        for k in r0["moments"][part]:
            assert torch.equal(r0["moments"][part][k], r1["moments"][part][k])


def test_zero1_checkpoint_restores_at_world_one(runs):
    """A checkpoint that ZeRO-1 at world 2 wrote (rank 0) holds the full
    moments, bit-equal to the ranks' gathered moments; restored at world 1,
    into replicated Adam and into ZeRO-1, its next step matches world 2's next
    step within the world-size tolerances."""
    inputs, r0 = runs["inputs"], runs["ranks"][0]["adam_zero1"]
    state, _ = Checkpointer(runs["ckpt"]).restore(3)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    for part in ("mu", "nu"):
        for k, v in r0["moments"][part].items():
            assert torch.equal(state["opt_state"][part][k], v), (part, k)
    for zero1 in (False, True):
        model = W.flagship_model()
        opt = make_optimizer(dict(model.named_parameters()), "Adam", zero1=zero1)
        ts = TrainState(model, opt)
        Checkpointer(runs["ckpt"]).restore_into(ts, 3)
        assert isinstance(opt, Zero1Adam) == zero1 and opt.count == 3
        run = make_scanned_train_steps(ts, DeviceResidentDataset(inputs["data"]["flagship"],
                                                                 "cpu"))
        run(torch.from_numpy(inputs["idx"]["next"]), W.ADAM_LR)
        _close_states(W.state_of(model), r0["next"], f"next step (zero1={zero1})")
        if zero1:
            assert sharded_fraction(opt) > 0.99


def test_eval_gathers_the_whole_batch(runs):
    """make_scanned_eval at world 2: each rank's rows, the logits all-gathered
    in rank order (a batch of 7 runs whole on both ranks, with the warning)."""
    w1 = runs["world1"]["flagship"]
    for r in runs["ranks"]:
        for key in ("eval", "eval_odd"):
            assert r["flagship"][key].shape == w1[key].shape
            np.testing.assert_allclose(r["flagship"][key].numpy(), w1[key].numpy(),
                                       rtol=1e-4, atol=1e-5)
        assert any(ODD_WARNING in w for w in r["flagship"]["odd_warning"])
        assert any(ODD_WARNING in w for w in r["odd"]["warning"])
    assert not any(ODD_WARNING in w for w in w1["odd_warning"])


def test_global_batch_draws_are_the_ranks_rows(runs):
    """rand / randint under a 2-way split: each rank's rows of the draw that
    world 1 makes for the global batch, along axis 0 and along axis 1."""
    g = torch.Generator().manual_seed(11)
    want = {"rand": torch.rand(8, 3, generator=g), "rand_axis1": torch.rand(2, 8, generator=g),
            "randint": torch.randint(0, 1000, (8,), generator=g)}
    for r, res in enumerate(runs["ranks"]):
        d = res["draws"]
        assert torch.equal(d["rand"], want["rand"][4 * r:4 * r + 4])
        assert torch.equal(d["rand_axis1"], want["rand_axis1"][:, 4 * r:4 * r + 4])
        assert torch.equal(d["randint"], want["randint"][4 * r:4 * r + 4])


def test_post_norm_encoder_dropout_rows_map_to_samples():
    """PostNormEncoderLayer's masks over [B * groups] rows: under a 2-way
    split, part r's rows (samples r*B/2 .., their groups batch-major) drop
    what the world-1 draw drops for those samples."""
    b, groups, n, d = 4, 3, 5, 16
    x = torch.from_numpy(np.random.RandomState(2).randn(b * groups, n, d).astype(np.float32))
    layer = PostNormEncoderLayer(d, num_heads=4, dropout=0.5, dropout_seed=3,
                                 generator=rng.generator(0)).train()
    want = layer(x)
    for part in range(2):
        fresh = PostNormEncoderLayer(d, num_heads=4, dropout=0.5, dropout_seed=3,
                                     generator=rng.generator(0)).train()
        rows = slice(part * (b // 2) * groups, (part + 1) * (b // 2) * groups)
        with mesh.data_split(2, part):
            got = fresh(x[rows])
        np.testing.assert_allclose(got.detach().numpy(), want[rows].detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert mesh.current_split() == (1, 0)


def test_rank_columns_and_rendezvous_routes(monkeypatch):
    """The rank's columns of an index matrix, and the three rendezvous routes
    read as the JAX package's multihost_init reads them."""
    idx = torch.arange(12).reshape(2, 6)
    monkeypatch.setattr(mesh, "world_size", lambda: 3)
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    cols, parts = mesh.rank_columns(idx)
    assert parts == 3 and torch.equal(cols, idx[:, 2:4])
    with pytest.warns(UserWarning, match="not divisible by data-axis size 3"):
        cols, parts = mesh.rank_columns(idx[:, :5])
    assert parts == 1 and cols.shape == (2, 5)
    assert mesh.rendezvous_env({}) is None
    assert mesh.rendezvous_env({"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "4",
                                "JAX_PROCESS_ID": "2", "MASTER_ADDR": "x",
                                "WORLD_SIZE": "9"}) == dict(addr="h:1", world=4, rank=2,
                                                            local_rank=0)
    assert mesh.rendezvous_env({"MASTER_ADDR": "m", "WORLD_SIZE": "2", "RANK": "1",
                                "LOCAL_RANK": "1"}) == dict(addr="m:29500", world=2, rank=1,
                                                            local_rank=1)
    slurm = mesh.rendezvous_env({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
                                 "SLURM_JOB_ID": "77", "SLURM_JOB_NODELIST": "gpu[03-05,9],c1"})
    assert slurm == dict(addr=f"gpu03:{77 % 4096 + 61440}", world=8, rank=5, local_rank=1)
    # the JAX route falls back to torchrun's names, as multihost_init does
    assert mesh.rendezvous_env({"JAX_COORDINATOR_ADDRESS": "h:1234", "WORLD_SIZE": "2",
                                "RANK": "1"}) == dict(addr="h:1234", world=2, rank=1,
                                                      local_rank=0)
    # where both are set and disagree, the JAX names win
    assert mesh.rendezvous_env({"JAX_COORDINATOR_ADDRESS": "h:1234", "JAX_NUM_PROCESSES": "4",
                                "JAX_PROCESS_ID": "0", "WORLD_SIZE": "2",
                                "RANK": "1"}) == dict(addr="h:1234", world=4, rank=0,
                                                      local_rank=0)
    with pytest.raises(ValueError, match="world size and the rank"):
        mesh.rendezvous_env({"JAX_COORDINATOR_ADDRESS": "h:1"})
