"""The port's tensor parallelism (simple3dformer_tpu_torch/parallel/tp.py) on
the CPU: eight gloo ranks, spawned once for the file
(tests/_torch_model_parallel_worker.py), against the JAX package's
single-device step from the same converted init, as tests/test_parallel.py:103
holds the JAX package's own TP step: a deit_tiny VoxelViT on 8^3 voxels, two
SGD steps of 8, on (data=2, model=4), where the three heads split 1, 1, 1, 0,
and on (data=4, model=2). The comparison goes through the full parameters
(gathered), never shard by shard: the JAX package splits qkv's last axis in
equal chunks, the port by whole heads.

Also here: the fused route's plain halves summed over ranks against the whole
block's plain version (f32 and bf16), the layered route split over four
ranks against the whole block, a checkpoint written at model=4 and resumed at
model=2, and the split rules.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_model_parallel_worker as MW
import _torch_parallel_worker as W
from simple3dformer_tpu.data.pipeline import DeviceResidentDataset as JaxDataset
from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.parallel.mesh import ShardingRules, make_mesh
from simple3dformer_tpu.train.loop import create_train_state
from simple3dformer_tpu.train.loop import make_scanned_train_steps as jax_scanned
from simple3dformer_tpu.train.optim import make_optimizer as jax_make_optimizer
from simple3dformer_tpu_torch.data.pipeline import DeviceResidentDataset
from simple3dformer_tpu_torch.kernels import vit_block as vb
from simple3dformer_tpu_torch.nn.layers import Block
from simple3dformer_tpu_torch.parallel import tp
from simple3dformer_tpu_torch.train.loop import TrainState, make_scanned_train_steps
from simple3dformer_tpu_torch.train.optim import make_optimizer
from simple3dformer_tpu_torch.utils import convert

# tests/test_parallel.py:138-149's tolerances
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model():
    emb = JaxVoxelEmbed(voxel_size=8, cell_size=4, patch_size=2, embed_dim=192)
    return JaxVoxelViT(voxel_embed=emb, n_classes=4, transformer_backbone="deit_tiny_patch16_224")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the inputs and the JAX single-device run."""
    rs = np.random.RandomState(9)
    x = (rs.rand(16, 8, 8, 8) > 0.7).astype(np.uint8)
    y = rs.randint(0, 4, size=(16,)).astype(np.int32)
    idx = rs.randint(0, 16, size=(2, 8)).astype(np.int32)
    jm = _jax_model()
    variables = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, 8, 8, 8))))
    pm = MW.tp_model()
    convert.load_jax_params(pm, variables["params"])
    layered = Block(96, 3, generator=MW.generator(4))
    with torch.no_grad():  # off init: LayerNorms and biases nonzero
        for p in layered.parameters():
            p.add_(0.05 * torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
    inputs = {"tp_init": MW.state_of(pm), "tp_data": {"x": x, "y": y}, "idx": idx,
              "next": rs.randint(0, 16, size=(1, 8)).astype(np.int32),
              "layered_init": MW.state_of(layered),
              "layered_x": torch.from_numpy(rs.randn(2, 7, 96).astype(np.float32)),
              "layered_g": torch.from_numpy(rs.randn(2, 7, 96).astype(np.float32))}
    case = tmp_path_factory.mktemp("tp")
    torch.save(inputs, case / "inputs.pt")
    W.spawn_ranks([os.path.join(W.REPO, "tests", "_torch_model_parallel_worker.py"), str(case),
                   "tp"], world=MW.WORLD)
    ranks = [torch.load(case / f"rank{r}.pt", weights_only=False) for r in range(MW.WORLD)]

    # the JAX package's single-device step (tests/test_parallel.py:20's _run(1, ...))
    mesh1 = make_mesh(n_data=1, devices=jax.devices()[:1])
    rules = ShardingRules(mesh1)
    tx = jax_make_optimizer("SGD")
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = jax.device_put(create_train_state(params, tx), rules.params)
    run = jax_scanned(jm, tx, JaxDataset({"x": x, "y": y}, mesh=mesh1), rules)
    state, metrics = run(state, rules.put_scan_idx(idx), MW.LR, jax.random.key(7))
    want = convert.jax_to_state_dict(jax.device_get(state.params), inputs["tp_init"])
    return {"ranks": ranks, "inputs": inputs, "jax_loss": np.asarray(metrics["loss"]),
            "jax_state": want, "layered": layered}


@pytest.mark.parametrize("layout", ["2x4", "4x2"])
def test_tp_step_matches_jax_single_device(runs, layout):
    """Two SGD steps on (data, model) against the JAX single-device step: the
    losses, and every parameter of the gathered full state."""
    for r in runs["ranks"]:
        got = r[layout]
        np.testing.assert_allclose(got["loss"].numpy(), runs["jax_loss"], **LOSS_TOL)
        for k, v in runs["jax_state"].items():
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), **PARAM_TOL,
                                       err_msg=f"{layout}: {k}")


@pytest.mark.parametrize("layout", ["2x4", "4x2"])
def test_tp_heads_split_and_ranks_agree(runs, layout):
    """The heads dealt out 1, 1, 1, 0 (model=4) and 2, 1 (model=2), fc1 split;
    every rank gathers the same full state and momenta and prints the same
    losses."""
    n_model = int(layout.split("x")[1])
    want = {4: [1, 1, 1, 0], 2: [2, 1]}[n_model]
    r0 = runs["ranks"][0][layout]
    for rank, res in enumerate(runs["ranks"]):
        got = res[layout]
        assert got["heads"] == [want[rank % n_model]] * 12
        assert got["mlp_split"] == [True] * 12
        assert torch.equal(got["loss"], r0["loss"])
        for part in ("state", "opt"):
            flat = got[part] if part == "state" else got[part]["trace"]
            ref = r0[part] if part == "state" else r0[part]["trace"]
            assert flat.keys() == ref.keys()
            for k in ref:
                assert torch.equal(flat[k], ref[k]), (layout, part, k)


def test_tp_checkpoint_resumes_at_another_degree(runs):
    """The full state written at model=4 (parameters and SGD momenta), loaded
    at model=2 and gathered again, is bit-equal to what was written; its next
    step equals the port's unsplit step from the same state."""
    inputs = runs["inputs"]
    for r in runs["ranks"]:
        res = r["restored"]
        for part in ("params", "opt_state"):
            a, b = res["saved"][part], res["reloaded"][part]
            leaves = a if part == "params" else a["trace"]
            other = b if part == "params" else b["trace"]
            for k in leaves:
                assert torch.equal(leaves[k], other[k]), (part, k)
    saved = runs["ranks"][0]["restored"]["saved"]
    model = MW.tp_model()
    ts = TrainState(model, make_optimizer(dict(model.named_parameters()), "SGD"))
    ts.load_state_dict(saved)
    run = make_scanned_train_steps(ts, DeviceResidentDataset(inputs["tp_data"], "cpu"))
    loss = run(torch.from_numpy(inputs["next"]), MW.LR)["loss"]
    got = runs["ranks"][0]["restored"]
    np.testing.assert_allclose(got["loss"].numpy(), loss.numpy(), **LOSS_TOL)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), **PARAM_TOL, err_msg=k)


def test_tp_layered_route_matches_whole_block(runs):
    """A block outside the fused gate (head_dim 32) split over model=4 (heads
    1, 1, 1, 0; Megatron's f/g pair around each half): output, input gradient
    and full weight gradients against the unsplit block."""
    inputs, blk = runs["inputs"], runs["layered"]
    x = inputs["layered_x"].clone().requires_grad_()
    y = blk(x)
    grads = torch.autograd.grad((y * inputs["layered_g"]).sum(), [x, *blk.parameters()])
    want = dict(zip([f"blk.{k}" for k, _ in blk.named_parameters()], grads[1:]))
    for r in runs["ranks"]:
        got = r["layered"]
        np.testing.assert_allclose(got["y"].numpy(), y.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["gx"].numpy(), grads[0].numpy(), rtol=1e-4, atol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def _split_weights(w: dict, n: int, r: int, heads: int) -> tuple[dict, int]:
    """Rank r's block weights (WNAMES) by tp.shard_state's rules."""
    names = {"ln1_s": "norm1.weight", "ln1_b": "norm1.bias", "wqkv": "attn.qkv.weight",
             "bqkv": "attn.qkv.bias", "wproj": "attn.proj.weight", "bproj": "attn.proj.bias",
             "ln2_s": "norm2.weight", "ln2_b": "norm2.bias", "w1": "mlp.fc1.weight",
             "b1": "mlp.fc1.bias", "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias"}
    local = tp.shard_state({f"b.{v}": w[k] for k, v in names.items()}, n, r, heads)
    lo, hi = tp.head_split(heads, n)[r]
    return {k: local[f"b.{v}"] for k, v in names.items()}, hi - lo


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tp_halves_sum_to_whole_block(n, cdt):
    """The four halves' plain versions and the LayerNorm backward, summed over
    n model ranks (6 heads: 3, 3 and 2, 2, 1, 1), against
    vit_block_train_reference / vit_block_backward_reference, at the block's
    tolerances: forward 1e-4 (f32) / 3e-2 (bf16) abs; gradients 1e-4 / 3e-2
    of the largest value."""
    rs = np.random.RandomState(3)
    b, nt, d, heads = 2, 9, 384, 6
    x = torch.from_numpy(rs.randn(b, nt, d).astype(np.float32))
    g = torch.from_numpy(rs.randn(b, nt, d).astype(np.float32))
    w = {k: torch.from_numpy(0.05 * rs.randn(*s).astype(np.float32))
         for k, s in vb.weight_shapes(d).items()}
    w["ln1_s"] += 1.0
    w["ln2_s"] += 1.0
    y, res = vb.vit_block_train_reference(x, w, heads, cdt)
    gx, gw = vb.vit_block_backward_reference(x, g, w, heads, cdt, res)
    ranks = [_split_weights(w, n, r, heads) for r in range(n)]
    attn = [vb.vit_block_tp_attn_fwd(x, wr, h, d // heads, cdt) for wr, h in ranks]
    h1 = x + (sum(p for p, _ in attn) + w["bproj"])
    mlp = [vb.vit_block_tp_mlp_fwd(h1, wr, cdt) for wr, _ in ranks]
    y_tp = h1 + (sum(p for p, _ in mlp) + w["b2"])
    fwd_tol = 1e-4 if cdt == torch.float32 else 3e-2
    assert float((y_tp - y).abs().max()) <= fwd_tol
    mb = [vb.vit_block_tp_mlp_bwd(g, h1, a1, wr, cdt) for (wr, _), (_, a1) in zip(ranks, mlp)]
    g_h1, g2 = vb.vit_block_tp_ln_bwd(sum(p for p, _ in mb), h1, w["ln2_s"], g)
    ab = [vb.vit_block_tp_attn_bwd(x, g_h1, ra, wr, h, d // heads, cdt)
          for (wr, h), (_, ra) in zip(ranks, attn)]
    g_x, g1 = vb.vit_block_tp_ln_bwd(sum(p for p, _ in ab), x, w["ln1_s"], g_h1)
    got = dict(ln1_s=g1["s"], ln1_b=g1["b"], ln2_s=g2["s"], ln2_b=g2["b"],
               bproj=ab[0][1]["bproj"], b2=mb[0][1]["b2"])
    for (_, ga), (_, gm) in zip(ab, mb):  # the whole biases' gradients, equal on every rank
        assert torch.equal(ga["bproj"], got["bproj"]) and torch.equal(gm["b2"], got["b2"])
    lo_hi = tp.head_split(heads, n)
    dh = d // heads
    got["wqkv"] = torch.cat([torch.cat([ga["wqkv"].reshape(3, -1, d)[t] for (_, ga) in ab])
                             for t in range(3)])
    got["bqkv"] = torch.cat([torch.cat([ga["bqkv"].reshape(3, -1)[t] for (_, ga) in ab])
                             for t in range(3)])
    got["wproj"] = torch.cat([ga["wproj"] for _, ga in ab], 1)
    got["w1"] = torch.cat([gm["w1"] for _, gm in mb])
    got["b1"] = torch.cat([gm["b1"] for _, gm in mb])
    got["w2"] = torch.cat([gm["w2"] for _, gm in mb], 1)
    assert [hi - lo for lo, hi in lo_hi] == [h for _, h in ranks] and dh == 64
    grad_tol = 1e-4 if cdt == torch.float32 else 3e-2
    scale = float(gx.abs().max())
    assert float((g_x - gx).abs().max()) <= grad_tol * scale
    for k in vb.WNAMES:
        err = float((got[k] - gw[k]).abs().max())
        assert err <= grad_tol * float(gw[k].abs().max()), (k, err)


def test_split_rules_and_state_round_trip():
    """Heads dealt out whole and contiguous, as evenly as they go; fc1 split
    where n divides it (else whole, as _spec_for keeps it replicated); a
    state dict split over n ranks and laid back together is the original."""
    assert tp.head_split(6, 4) == [(0, 2), (2, 4), (4, 5), (5, 6)]
    assert tp.head_split(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    assert tp.head_split(6, 2) == [(0, 3), (3, 6)]
    assert tp.mlp_splits(768, 4) and not tp.mlp_splits(768, 5)
    blk = Block(192, 3, generator=MW.generator(1))
    full = {f"b.{k}": v for k, v in blk.state_dict().items()}
    for n in (2, 4, 5):
        parts = [tp.shard_state(full, n, r, 3) for r in range(n)]
        if n == 5:  # fc1 whole, attention split by heads (1, 1, 1, 0, 0)
            assert all(p["b.mlp.fc1.weight"].shape == (768, 192) for p in parts)
            assert [p["b.attn.qkv.weight"].shape[0] for p in parts] == [192] * 3 + [0] * 2
        qkv = torch.cat([torch.cat([p["b.attn.qkv.weight"].reshape(3, -1, 192)[t]
                                    for p in parts]) for t in range(3)])
        assert torch.equal(qkv, full["b.attn.qkv.weight"])
        assert torch.equal(torch.cat([p["b.attn.proj.weight"] for p in parts], 1),
                           full["b.attn.proj.weight"])
        if n != 5:
            assert torch.equal(torch.cat([p["b.mlp.fc2.weight"] for p in parts], 1),
                               full["b.mlp.fc2.weight"])
        # gather_state on one rank of a group of one: the rank's own slots
        only = tp.gather_state(parts[0], n, 0, 3, None, {"b.": (192, 768)})
        assert only["b.attn.qkv.weight"].shape == (576, 192)
