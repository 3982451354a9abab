"""The point models' forward kernels as torch ops, and the point models
exported, on the CPU.

Each of the six ops (``s3f::fps``, ``s3f::knn``, ``s3f::gather_fwd``,
``s3f::mhsa_fwd``, ``s3f::vector_attention_fwd``, ``s3f::gather_attention_fwd``)
passes ``torch.library.opcheck`` and equals its plain version. Then the 3DViT
cls and seg models, 3DViT_s3dis (17 tokens) and 3DViT_LWF on a two-block,
96-wide backbone, Hengshuang cls in f32 and bf16 and Hengshuang seg (2
blocks, 64 wide), each loaded from its JAX init by
``utils/convert.load_jax_params``, are
exported by ``Predictor.export``, loaded in one fresh process that imports no
model code, and held to the eager port model (within 1e-6 of the largest logit:
the same ops in the same order) and to the JAX model's forward from the same
weights and inputs (numpy, seeded) at the tolerance of that model's parity test.

On the CPU the ops run their plain versions, and attention at 17 tokens is the
plain products (no ``mhsa`` node; on the card 3DViT_s3dis's 1025 tokens take the
op: chip_smoke.py's export phase checks it).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.models import point_vit as jpv
from simple3dformer_tpu.models.hengshuang import PointTransformerCls as JaxCls
from simple3dformer_tpu.models.hengshuang import PointTransformerSeg as JaxSeg
from simple3dformer_tpu.nn import vector_attention as jax_va
from simple3dformer_tpu.nn import vit as jax_vit
from simple3dformer_tpu_torch.kernels import fps, gather, knn, mhsa
from simple3dformer_tpu_torch.kernels import vector_attention as va
from simple3dformer_tpu_torch.models import point_vit as ppv
from simple3dformer_tpu_torch.models.hengshuang import PointTransformerCls, PointTransformerSeg
from simple3dformer_tpu_torch.serve.predictor import Predictor
from simple3dformer_tpu_torch.utils.convert import load_jax_params

import _torch_parallel_worker as W
from _torch_port_numpy_init import numpy_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, K = 2, 64, 8
EXPORT_REL = 1e-6  # the exported program against the eager model, of the largest logit
HENG = dict(nblocks=2, nneighbor=K, transformer_dim=64)
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread: beside other test processes, its
    spinning thread pool makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rs, *shape) -> torch.Tensor:
    return torch.from_numpy(rs.randn(*shape).astype(np.float32))


def _op_cases():
    """op name -> (args, the plain version's output)."""
    rs = np.random.RandomState(0)
    xyz = _rand(rs, B, N, 3)
    start = torch.from_numpy(rs.randint(0, N, B).astype(np.int32))
    query = xyz[:, :16].contiguous()
    points, idx = _rand(rs, B, N, 5), torch.from_numpy(rs.randint(0, N, (B, 40)).astype(np.int32))
    q, k, v = (_rand(rs, B, 260, 2, 64) for _ in range(3))  # N in mhsa's 256..2048
    d, kk = 16, 4
    ws = [0.3 * _rand(rs, *s) for s in va.weight_shapes(d).values()]
    w = dict(zip(va.WNAMES, ws))
    vq, vk, vv, rel = _rand(rs, B, 8, d), _rand(rs, B, 8, kk, d), _rand(rs, B, 8, kk, d), \
        _rand(rs, B, 8, kk, 3)
    gq, gk, gv = (_rand(rs, B, 8, d).to(BF) for _ in range(3))
    gidx = torch.from_numpy(rs.randint(0, 8, (B, 8, kk)).astype(np.int32))
    grel = rel.to(BF)
    return {
        "fps": ((xyz, 16, None), fps.fps_reference(xyz, 16)),
        "fps_start": ((xyz, 16, start), fps.fps_reference(xyz, 16, start)),
        "knn": ((query, xyz, K), knn.knn_reference(query, xyz, K)),
        "gather_fwd": ((points, idx), gather.gather_fwd_reference(points, idx)),
        "gather_fwd_bf16": ((points.to(BF), idx), gather.gather_fwd_reference(points.to(BF), idx)),
        "mhsa_fwd": ((q, k, v, 0.125), mhsa.mhsa_reference(q, k, v, 0.125)),
        "mhsa_fwd_bf16": ((q.to(BF), k.to(BF), v.to(BF), 0.125),
                          mhsa.mhsa_reference(q.to(BF), k.to(BF), v.to(BF), 0.125)),
        "vector_attention_fwd": ((vq, vk, vv, rel, ws),
                                 va.vector_attention_reference(vq, vk, vv, rel, w)),
        "gather_attention_fwd": ((gq, gk, gv, gidx, grel, ws),
                                 va.gather_attention_reference(gq, gk, gv, gidx, grel, w)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_op_passes_opcheck_and_is_the_plain_version(case):
    """torch.library.opcheck (the schema, the fake implementation against the
    CPU one, the op under AOT dispatch), then the op's output bit-equal to the
    plain version's."""
    args, want = _op_cases()[case]
    op = getattr(torch.ops.s3f, case.removesuffix("_start").removesuffix("_bf16")).default
    torch.library.opcheck(op, args)
    got = op(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype and a.is_contiguous()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fake_implementations_need_no_data():
    """The fakes give the shapes on meta tensors; the range check of FPS's
    start, which reads values, runs in the implementation."""
    meta = dict(device="meta")
    assert torch.ops.s3f.fps(torch.empty(B, N, 3, **meta), 16, None).shape == (B, 16)
    idx, dist = torch.ops.s3f.knn(torch.empty(B, 5, 3, **meta), torch.empty(B, N, 3, **meta), 4)
    assert idx.shape == dist.shape == (B, 5, 4) and idx.dtype == torch.int32
    assert torch.ops.s3f.gather_fwd(torch.empty(B, N, 7, dtype=BF, **meta),
                                    torch.empty(B, 9, dtype=torch.int32, **meta)).dtype == BF
    with pytest.raises(ValueError, match="k = 65 outside"):
        torch.ops.s3f.knn(torch.empty(B, 5, 3, **meta), torch.empty(B, N, 3, **meta), N + 1)
    with pytest.raises(ValueError, match=r"start must lie in \[0, 64\)"):
        fps.fps(torch.zeros(B, N, 3), 4, torch.tensor([0, N], dtype=torch.int32))


def _clouds(seed, c):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, N, c).astype(np.float32)
    x[..., :3] = rs.rand(B, N, 3)  # xyz in the unit cube
    return x


def _pointvit(variant, task, num_class, in_dim):
    """A 3DViT variant on a two-block, 96-wide backbone."""
    W.register_tiny()
    jax_vit.BACKBONES.setdefault("dp_tiny", W.TINY)
    kw = dict(num_point=N, num_class=num_class, input_dim=in_dim, nneighbor=K,
              transformer_backbone="dp_tiny")
    return (jpv.PointViT(variant=variant, task=task, **kw),
            ppv.PointViT(variant, task, N, num_class, input_dim=in_dim, nneighbor=K,
                         transformer_backbone="dp_tiny"))


def _hengshuang(dtype):
    return (JaxCls(num_point=N, num_class=40, input_dim=6, dtype=dtype and jnp.bfloat16, **HENG),
            PointTransformerCls(N, 40, 6, dtype=dtype, **HENG))


def _hengshuang_seg():
    return (JaxSeg(num_point=N, num_class=50, input_dim=22, **HENG),
            PointTransformerSeg(N, 50, 22, **HENG))


# name -> (the JAX and port models, input width, the s3f ops the CPU program
# holds, the tolerance against the JAX forward: ("abs", atol over max(1, the
# largest logit)) as the PointViT and Hengshuang parity tests
# (tests/test_torch_port_point_model.py, test_torch_port_hengshuang.py), or
# ("bf16", steps) as the bf16 model's: each logit within one bf16 step of the
# JAX logit (tests/test_torch_port_vector_attention_bf16.py, which writes the
# step as 2**-8 of the logit, the step of a value just below a power of two; a
# step is up to 2**-7 of the value. The two sides sum the same bf16 products
# in f32 in another order, so a logit's last rounding can fall either way: one
# logit of 0.0178 here lands one step, 1.22e-4, off)
POINT = ("fps", "knn", "gather_fwd")
CASES = {
    "3dvit_cls": (lambda: _pointvit("3DViT", "cls", 40, 6), 6, POINT, ("abs", 1e-4)),
    "3dvit_seg": (lambda: _pointvit("3DViT", "seg", 50, 22), 22, POINT, ("abs", 1e-4)),
    "3dvit_s3dis": (lambda: _pointvit("3DViT_s3dis", "seg", 13, 9), 9, POINT, ("abs", 1e-4)),
    "3dvit_lwf": (lambda: _pointvit("3DViT_LWF", "seg", 50, 22), 22, POINT, ("abs", 1e-4)),
    "hengshuang": (lambda: _hengshuang(None), 6, (*POINT, "vector_attention_fwd"),
                   ("abs", 1e-4)),
    "hengshuang_bf16": (lambda: _hengshuang(BF), 6, (*POINT, "gather_attention_fwd"),
                        ("bf16", 1)),
    "hengshuang_seg": (_hengshuang_seg, 22, (*POINT, "vector_attention_fwd"), ("abs", 1e-4)),
}

# the fresh process: load_exported on each artifact and its outputs
LOADER = """
import json, sys
import numpy as np
from simple3dformer_tpu_torch.serve.predictor import load_exported
d = sys.argv[1]
for name in json.load(open(f"{d}/names.json")):
    np.save(f"{d}/{name}.got.npy", load_exported(f"{d}/{name}.pt2")(np.load(f"{d}/{name}.x.npy")))
print(json.dumps(sorted(m for m in sys.modules if m.startswith("simple3dformer"))))
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each case's JAX forward, eager port forward and export; the programs
    loaded in one fresh process. -> {name: (exported logits, eager, JAX, the
    program's s3f op names)}."""
    d = tmp_path_factory.mktemp("points")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX bf16 model on its kernel route, the Pallas kernels in interpret mode
        mp.setattr(jax_va, "FORCE_FUSED", True)
        mp.setattr(jax_va, "INTERPRET", True)
        for i, (name, (make, in_dim, _, _)) in enumerate(CASES.items()):
            jm, pm = make()
            x = _clouds(10 + i, in_dim)
            params, stats = numpy_variables(jm, jnp.zeros((B, N, in_dim)), seed=20 + i)
            load_jax_params(pm, params, stats)
            want = np.asarray(jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                                                jnp.asarray(x)), np.float32)
            predictor = Predictor(pm, (N, in_dim), device="cpu", batch_size=B, warmup=False)
            path = str(d / f"{name}.pt2")
            predictor.export(path)
            program = torch.export.load(path)
            ops = sorted({str(n.target).split(".")[1] for n in program.graph.nodes
                          if n.op == "call_function" and str(n.target).startswith("s3f.")})
            out[name] = [None, predictor(x), want, ops]
            np.save(d / f"{name}.x.npy", x)
    (d / "names.json").write_text(json.dumps(list(CASES)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT,
                                                                    os.environ.get("PYTHONPATH")])))
    run = subprocess.run([sys.executable, "-c", LOADER, str(d)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert not any(m.startswith(("simple3dformer_tpu_torch.models", "simple3dformer_tpu_torch.nn"))
                   for m in json.loads(run.stdout.splitlines()[-1]))
    for name in CASES:
        out[name][0] = np.load(d / f"{name}.got.npy")
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_point_model_exports_and_matches_eager_and_jax(exported, name):
    got, eager, want, ops = exported[name]
    _, _, kernels, (kind, tol) = CASES[name]
    assert ops == sorted(kernels)
    assert got.shape == eager.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - eager).max()) / float(np.abs(eager).max())
    assert err <= EXPORT_REL, err
    if kind == "abs":
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)
    else:  # bf16 steps: a value in [2**(e-1), 2**e) has the step 2**(e-8)
        step = np.ldexp(1.0, np.frexp(want)[1] - 8)
        assert (np.abs(got - want) <= tol * step).all(), (np.abs(got - want) / step).max()
