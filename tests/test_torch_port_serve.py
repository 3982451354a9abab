"""The port's Predictor, ModelServer and checkpoints, on the CPU, against the
JAX package's Predictor on the same weights."""

import http.client
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.models.voxel_vit import VoxelViT as JaxVoxelViT
from simple3dformer_tpu.nn.voxel_embed import VoxelEmbed as JaxVoxelEmbed
from simple3dformer_tpu.serve.predictor import Predictor as JaxPredictor
from simple3dformer_tpu_torch.core.checkpoint import Checkpointer, load_params, save_params
from simple3dformer_tpu_torch.models.voxel_vit import VoxelViT
from simple3dformer_tpu_torch.nn.voxel_embed import VoxelEmbed
from simple3dformer_tpu_torch.serve.predictor import Predictor, topk_labels
from simple3dformer_tpu_torch.serve.server import ModelServer, default_class_names
from simple3dformer_tpu_torch.utils.convert import load_jax_params

V, N_CLS = 12, 7


def port_model():
    emb = VoxelEmbed(voxel_size=V, cell_size=4, patch_size=3, embed_dim=192)
    return VoxelViT(emb, n_classes=N_CLS, transformer_backbone="deit_tiny_patch16_224")


@pytest.fixture(scope="module")
def jax_side():
    emb = JaxVoxelEmbed(voxel_size=V, cell_size=4, patch_size=3, embed_dim=192)
    model = JaxVoxelViT(voxel_embed=emb, n_classes=N_CLS,
                        transformer_backbone="deit_tiny_patch16_224")
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((2, V, V, V)))
    return model, variables


@pytest.fixture(scope="module")
def predictor(jax_side):
    model = port_model()
    load_jax_params(model, jax.device_get(jax_side[1]["params"]))
    return Predictor(model, input_shape=(V, V, V), device="cpu", batch_size=4)


def grids(n, seed):
    return (np.random.RandomState(seed).rand(n, V, V, V) > 0.8).astype(np.float32)


def test_predictor_pads_and_chunks(predictor):
    before = predictor.stats["requests"]
    x = grids(6, 0)  # 6 = 4 + (2 real rows, 2 pad rows)
    out = predictor(x)
    assert out.shape == (6, N_CLS) and np.isfinite(out).all()
    # padding must not leak into real outputs: same inputs, other chunking
    np.testing.assert_allclose(out[:3], predictor(x[:3]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[4:], predictor(x[4:]), rtol=1e-5, atol=1e-6)
    stats = predictor.stats
    assert stats["requests"] == before + 3
    assert stats["p95_latency_ms"] >= stats["p50_latency_ms"] > 0
    with pytest.raises(ValueError, match="trailing shape"):
        predictor(np.zeros((2, V, V)))
    with pytest.raises(ValueError, match="no inputs"):
        predictor(np.zeros((0, V, V, V)))


def test_served_logits_match_jax_predictor(predictor, jax_side):
    model, variables = jax_side
    jax_pred = JaxPredictor(model, variables, input_shape=(V, V, V), batch_size=4)
    x = grids(5, 1)
    np.testing.assert_allclose(predictor(x), jax_pred(x), rtol=0, atol=1e-4)


def test_topk_labels():
    logits = np.array([[0.0, 2.0, 1.0]])
    out = topk_labels(logits, k=2, names={0: "a", 1: "b", 2: "c"})
    assert out[0][0][0] == "b" and out[0][1][0] == "c"
    assert abs(sum(p for _, p in out[0]) - 1.0) < 0.5
    assert default_class_names(40)[0] == "airplane"


def test_http_server_roundtrip(predictor):
    server = ModelServer(predictor, port=0, class_names=None)
    port = server.start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and "requests" in health["stats"]

        x = grids(2, 2)
        conn.request("POST", "/predict", body=json.dumps({"inputs": x.tolist()}),
                     headers={"Content-Type": "application/json"})
        resp = json.loads(conn.getresponse().read())
        np.testing.assert_allclose(np.asarray(resp["logits"]), predictor(x), rtol=1e-6, atol=1e-6)
        assert len(resp["topk"][0]) == 5

        for body in ("{bad json", json.dumps({"no_inputs": 1}),
                     json.dumps({"inputs": [[1.0, 2.0]]})):
            conn.request("POST", "/predict", body=body,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            assert r.status == 400
            assert "error" in json.loads(r.read())
        conn.request("GET", "/nowhere")
        r = conn.getresponse()
        assert r.status == 404
        r.read()
    finally:
        server.shutdown()


def test_checkpoint_roundtrip_and_serve(predictor, tmp_path):
    params = predictor.model.state_dict()
    ckpt = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    assert ckpt.restore() == (None, None)
    for step in (1, 2, 3):
        ckpt.save(step, {"params": params, "step": step}, {"loss": 1.0 / step})
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    state, metrics = ckpt.restore()
    assert state["step"] == 3 and metrics == {"loss": 1.0 / 3}
    assert all(torch.equal(state["params"][k], params[k]) for k in params)

    served = Predictor.from_checkpoint(port_model(), str(tmp_path / "ckpt"), (V, V, V),
                                       device="cpu", batch_size=4, warmup=False)
    x = grids(3, 3)
    np.testing.assert_allclose(served(x), predictor(x), rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(port_model(), str(tmp_path / "empty"), (V, V, V), device="cpu")

    save_params(str(tmp_path / "params.pt"), params)
    loaded = load_params(str(tmp_path / "params.pt"))
    assert all(torch.equal(loaded[k], params[k]) for k in params)
