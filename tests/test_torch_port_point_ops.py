"""The port's point kernels (their plain versions on the CPU) and ops/pointops
against the JAX package: the Pallas kernels in interpret mode and the XLA
functions, from the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple3dformer_tpu.kernels.fps import fps_pallas
from simple3dformer_tpu.kernels.gather import gather_rows as jax_gather_rows
from simple3dformer_tpu.kernels.knn import knn_pallas
from simple3dformer_tpu.ops import pointops as jops
from simple3dformer_tpu_torch.kernels import fps as fps_mod
from simple3dformer_tpu_torch.kernels import gather as gather_mod
from simple3dformer_tpu_torch.kernels import knn as knn_mod
from simple3dformer_tpu_torch.ops import pointops as pops

TOL = dict(rtol=1e-5, atol=1e-5)


def cloud(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("b,n,npoint,start", [(3, 128, 32, None), (1, 128, 32, None),
                                              (2, 300, 64, [5, 17])])
def test_fps_matches_pallas_and_lax(b, n, npoint, start):
    xyz = cloud(b * n, b, n, 3)
    st = None if start is None else jnp.asarray(start, jnp.int32)
    pallas = np.asarray(fps_pallas(jnp.asarray(xyz), npoint, start=st, interpret=True))
    before = fps_mod.fps.launches
    got = fps_mod.fps(t(xyz), npoint, None if start is None else torch.tensor(start))
    assert fps_mod.fps.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.int32 and got.shape == (b, npoint)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if start is None:
        lax = np.asarray(jops.farthest_point_sample(jnp.asarray(xyz), npoint))
        np.testing.assert_array_equal(pops.farthest_point_sample(t(xyz), npoint).numpy(), lax)


@pytest.mark.parametrize("s,n,k", [(100, 300, 8), (64, 64, 16), (200, 50, 3)])
def test_knn_matches_pallas_and_lax(s, n, k):
    q, p = cloud(1, 2, s, 3), cloud(2, 2, n, 3)
    pidx, pdist = knn_pallas(jnp.asarray(q), jnp.asarray(p), k=k, tile=32, interpret=True)
    idx, dist = knn_mod.knn(t(q), t(p), k)
    assert idx.dtype == torch.int32 and idx.shape == (2, s, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(pdist), rtol=0, atol=1e-5)
    lax = np.asarray(jops.knn_indices(jnp.asarray(q), jnp.asarray(p), k))
    np.testing.assert_array_equal(pops.knn_indices(t(q), t(p), k).numpy(), lax)


def test_knn_breaks_ties_by_the_smaller_index():
    p = np.repeat(cloud(3, 1, 40, 3), 2, axis=1)  # every point twice: exact ties
    pidx, _ = knn_pallas(jnp.asarray(p), jnp.asarray(p), k=6, tile=16, interpret=True)
    idx, dist = knn_mod.knn(t(p), t(p), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    tied = dist[..., 1:] == dist[..., :-1]
    assert bool(tied.any()) and not bool((tied & (idx[..., 1:] < idx[..., :-1])).any())
    # k above N clamps, as the reference's argsort()[..., :k] does
    assert pops.knn_indices(t(p[:, :4]), t(p[:, :4]), 16).shape == (1, 4, 4)


# (S queries, N points, k, integer points each twice: every distance exact in any form)
@pytest.mark.parametrize("s,n,k,dup", [(100, 300, 8, False), (64, 64, 16, False),
                                       (50, 120, 5, True)])
def test_exact_order_knn_matches_the_matmul_form_and_pallas(s, n, k, dup):
    """knn_reference_exact, the card check's oracle: its distances are numpy's
    in the kernel's rounding order, bit for bit; it agrees with the matmul form
    and the Pallas kernel but for near-ties, and exactly where every distance
    is exact, equal distances in index order."""
    if dup:
        p = np.repeat(np.random.RandomState(5).randint(-3, 4, (2, n // 2, 3)), 2, axis=1)
        p = p.astype(np.float32)
        q = p[:, :s]
    else:
        q, p = cloud(1, 2, s, 3), cloud(2, 2, n, 3)
    eidx, edist = knn_mod.knn_reference_exact(t(q), t(p), k)
    assert eidx.dtype == torch.int32 and eidx.shape == (2, s, k)
    qv, pv = q[:, :, None, :], p[:, None, :, :]
    qq = (qv[..., 0] * qv[..., 0] + qv[..., 1] * qv[..., 1]) + qv[..., 2] * qv[..., 2]
    pp = (pv[..., 0] * pv[..., 0] + pv[..., 1] * pv[..., 1]) + pv[..., 2] * pv[..., 2]
    cross = (qv[..., 0] * pv[..., 0] + qv[..., 1] * pv[..., 1]) + qv[..., 2] * pv[..., 2]
    d = np.maximum((qq + pp) - np.float32(2) * cross, np.float32(0))
    np.testing.assert_array_equal(edist.numpy(), np.take_along_axis(d, eidx.numpy(), -1))
    pidx, pdist = knn_pallas(jnp.asarray(q), jnp.asarray(p), k=k, tile=32, interpret=True)
    others = (knn_mod.knn_reference(t(q), t(p), k), (t(np.array(pidx)), t(np.array(pdist))))
    for idx, dist in others:
        n_diff, n_near = knn_mod.near_ties(eidx, edist, idx, dist)
        assert n_diff == n_near
        np.testing.assert_allclose(edist.numpy(), dist.numpy(), rtol=0, atol=1e-5)
    tied = edist[..., 1:] == edist[..., :-1]
    assert not bool((tied & (eidx[..., 1:] < eidx[..., :-1])).any())
    if dup:
        assert bool(tied.any())
        for idx, dist in others:
            assert torch.equal(eidx, idx) and torch.equal(edist, dist)


def test_near_ties_counts_only_equal_distance_swaps():
    ref_idx = torch.tensor([[[0, 1, 2]]], dtype=torch.int32)
    ref_dist = torch.tensor([[[0.1, 0.2, 0.2]]])
    idx = torch.tensor([[[0, 2, 1]]], dtype=torch.int32)
    assert knn_mod.near_ties(idx, ref_dist, ref_idx, ref_dist) == (2, 2)
    far = torch.tensor([[[0.1, 0.3, 0.2]]])
    assert knn_mod.near_ties(idx, far, ref_idx, ref_dist) == (2, 1)


# (dtype, C, R, every row naming one point)
GATHER_CASES = {"float32": ("float32", 64, 513, False), "bfloat16": ("bfloat16", 64, 513, False),
                "C=3": ("float32", 3, 513, False), "C=35 bf16": ("bfloat16", 35, 513, False),
                "one point": ("float32", 64, 513, True), "R=1": ("float32", 64, 1, False)}


@pytest.mark.parametrize("dtype,c,r,one_point", GATHER_CASES.values(), ids=GATHER_CASES.keys())
def test_gather_forward_and_vjp_match_the_pallas_kernel(dtype, c, r, one_point):
    b, n = 2, 128
    pts = cloud(4, b, n, c)
    idx = np.random.RandomState(5).randint(0, n, (b, r)).astype(np.int32)
    if one_point:
        idx[:] = 17
    cot = cloud(6, b, r, c)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp, jc = jnp.asarray(pts).astype(jdt), jnp.asarray(cot).astype(jdt)
    out, vjp = jax.vjp(lambda p: jax_gather_rows(p, jnp.asarray(idx), 256, True), jp)
    (jgrad,) = vjp(jc)

    tdt = getattr(torch, dtype)
    tp = t(pts).to(tdt).requires_grad_()
    before = (gather_mod.gather_fwd.launches, gather_mod.gather_bwd.launches)
    got = gather_mod.gather_rows(tp, t(idx))
    (grad,) = torch.autograd.grad(got, tp, t(cot).to(tdt))
    assert (gather_mod.gather_fwd.launches, gather_mod.gather_bwd.launches) == before
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
    # both sum in f32 and round once to the points' dtype
    want = np.asarray(jgrad.astype(jnp.float32))
    np.testing.assert_allclose(grad.float().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max() if dtype == "float32" else 0)


def test_gather_clamps_out_of_range_indices():
    pts = cloud(7, 1, 5, 3)
    idx = np.array([[-3, 0, 4, 9]], np.int32)
    got = gather_mod.gather_fwd(t(pts), t(idx))
    np.testing.assert_array_equal(got.numpy(), pts[:, [0, 0, 4, 4]])
    # in range, the XLA path agrees; out of range it wraps a negative index
    # and fills NaN past N instead
    want = np.asarray(jnp.take_along_axis(jnp.asarray(pts), jnp.asarray(idx)[..., None], 1))
    np.testing.assert_array_equal(got.numpy()[:, 1:3], want[:, 1:3])
    np.testing.assert_array_equal(want[:, 0], pts[:, 5 - 3])
    assert np.isnan(want[:, 3]).all()
    g = gather_mod.gather_bwd(t(idx), torch.ones(1, 4, 3), 5)
    np.testing.assert_array_equal(g[0, :, 0].numpy(), [2, 0, 0, 0, 2])


def test_index_points_and_square_distance_match_jax():
    pts, xyz = cloud(8, 2, 50, 7), cloud(9, 2, 30, 3)
    idx = np.random.RandomState(10).randint(0, 50, (2, 6, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        pops.index_points(t(pts), t(idx)).numpy(),
        np.asarray(jops.index_points(jnp.asarray(pts), jnp.asarray(idx))))
    for exact in (False, True):
        np.testing.assert_allclose(
            pops.square_distance(t(xyz), t(pts[..., :3]), exact).numpy(),
            np.asarray(jops.square_distance(jnp.asarray(xyz), jnp.asarray(pts[..., :3]), exact)),
            **TOL)


@pytest.mark.parametrize("nsample,radius", [(8, 0.8), (4, 0.3)])
def test_query_ball_point_matches_jax(nsample, radius):
    xyz, new_xyz = cloud(11, 2, 60, 3) * 0.5, cloud(12, 2, 10, 3) * 0.5
    want = np.asarray(jops.query_ball_point(radius, nsample, jnp.asarray(xyz),
                                            jnp.asarray(new_xyz)))
    got = pops.query_ball_point(radius, nsample, t(xyz), t(new_xyz))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("npoint,knn", [(64, True), (16, True), (16, False)])
def test_sample_and_group_matches_jax(npoint, knn):
    xyz, feats = cloud(13, 2, 64, 3), cloud(14, 2, 64, 5)
    jx, jf = jnp.asarray(xyz), jnp.asarray(feats)
    want = jops.sample_and_group(npoint, 0.6, 8, jx, jf, knn=knn, return_fps=True)
    got = pops.sample_and_group(npoint, 0.6, 8, t(xyz), t(feats), knn=knn, return_fps=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    new_xyz, grouped = pops.sample_and_group(npoint, 0.6, 8, t(xyz), None, knn=knn)
    assert grouped.shape == (2, npoint, 8, 3)


def test_group_all_with_center_and_interpolation_match_jax():
    xyz, feats = cloud(15, 2, 64, 3), cloud(16, 2, 64, 5)
    jx, jf = jnp.asarray(xyz), jnp.asarray(feats)
    for got, want in [
        (pops.sample_and_group_all(t(xyz), t(feats)), jops.sample_and_group_all(jx, jf)),
        (pops.sample_and_group_with_center(16, 8, t(xyz), t(feats)),
         jops.sample_and_group_with_center(16, 8, jx, jf)),
    ]:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    coarse, cf = xyz[:, :16], cloud(17, 2, 16, 6)
    for s in (16, 1):
        np.testing.assert_allclose(
            pops.three_nn_interpolate(t(xyz), t(coarse[:, :s]), t(cf[:, :s])).numpy(),
            np.asarray(jops.three_nn_interpolate(jx, jnp.asarray(coarse[:, :s]),
                                                 jnp.asarray(cf[:, :s]))), **TOL)
    np.testing.assert_allclose(pops.pc_normalize(t(xyz[0])).numpy(),
                               np.asarray(jops.pc_normalize(jx[0])), **TOL)


def test_random_fps_start_comes_from_the_generator():
    xyz = t(cloud(18, 3, 50, 3))
    a = pops.farthest_point_sample(xyz, 8, torch.Generator().manual_seed(1))
    b = pops.farthest_point_sample(xyz, 8, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    start = torch.randint(0, 50, (3,), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[:, 0], start.to(torch.int32))


def test_wrappers_refuse_what_they_cannot_take():
    with pytest.raises(ValueError, match="xyz"):
        fps_mod.fps(torch.zeros(2, 5, 2), 3)
    for start in ([0, 5], [-1, 0]):
        with pytest.raises(ValueError, match="start"):
            fps_mod.fps(torch.zeros(2, 5, 3), 3, torch.tensor(start))
    with pytest.raises(ValueError, match="k = 9"):
        knn_mod.knn(torch.zeros(1, 4, 3), torch.zeros(1, 8, 3), 9)
    with pytest.raises(ValueError, match="meta"):
        gather_mod.gather_fwd(torch.zeros(1, 4, 3, device="meta"), torch.zeros(1, 2))
