"""The port's last four impls on the CPU against the JAX package's: ``fused``
(``aidw_fused.py:_fused_kernel``), ``tiled_v2`` (``aidw_tiled_v2.py:
_knn_kernel_v2`` with the exact weight sweep), ``idw`` (``idw_tiled.py:
_idw_kernel``) and ``chunked`` (plain PyTorch, ``knn`` brute and grid), each
kernel module's plain version against its Pallas kernel in interpret mode and
each impl through ``build_plan`` + ``execute_with_stats`` against the JAX
``execute``; with them the entry points that reach them (``idw``,
``aidw_v2``, ``aidw_interpolate``) and the repairs of the port's entry
points, k list, x64 context and build directory.

Tolerances: alpha within 1e-6 absolute plus 4 ulps relative and z within
1e-5 relative in float32; 1e-12 in float64, with the float64 JAX reference
made under JAX's x64 context (``test_torch_core.enable_x64``).  The 4 ulps
are the known difference of ROADMAP C: XLA's CPU backend contracts d^2 into
an FMA, so a Pallas k-best can hold other last bits, and where Eq. (6) is
steep (d alpha / d mu = 5 near alpha = 4) r_obs's ulp becomes 2.5 ulps of
alpha (1.19e-6 at one query of 256 here; the same inputs through the JAX
``adaptive_alpha`` on the port's r_obs give the port's bits).  Plan data and statics are
equal exactly.  The golden gate is the one of ``tests/test_golden.py``: RTOL
5e-4 / ATOL 5e-5.  The merge count of ``tiled_v2`` equals the Pallas
kernel's, except that a (block, tile) pair holding a d^2 within 2 ulps of its
row's k-th best at the tile's start may go either way, since XLA's CPU
backend contracts d^2 into an FMA (ROADMAP C, known differences): the counts
may differ by at most the number of such pairs.  Inside the port fused
equals tiled SoA, tiled_v2 alpha equals tiled alpha, idw equals the weight
sweep at a filled alpha / 2, and ``aidw_interpolate`` equals a hand-built
chunked plan, bit for bit.
"""

import math
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as j_core
from repro.core.accuracy import relative_rmse as j_relative_rmse
from repro.core.aidw import AIDWParams as JParams
from repro.core.idw import idw_interpolate as j_idw_interpolate
from repro.core.idw import idw_reference as j_idw_reference
from repro.core.layouts import soa_to_aoas as j_soa_to_aoas
from repro.engine import build_plan as j_build_plan
from repro.engine import execute as j_execute
from repro.engine import execute_with_stats as j_execute_with_stats
from repro.kernels import ref as j_ref
from repro.kernels.aidw_fused import aidw_fused_soa as j_fused
from repro.kernels.aidw_tiled_v2 import aidw_knn_v2 as j_knn_v2
from repro.kernels.aidw_tiled_v2 import aidw_tiled_v2_soa as j_tiled_v2
from repro.kernels.idw_tiled import idw_tiled_soa as j_idw_tiled
from repro.kernels.ops import aidw_v2 as j_aidw_v2
import repro_torch.core as t_core
from repro_torch.core import PointSet, aidw_interpolate, idw_interpolate, idw_reference
from repro_torch.core.accuracy import relative_rmse
from repro_torch.core.aidw import AIDWParams
from repro_torch.engine import build_plan, execute, execute_with_stats, plan_from_reference
from repro_torch.kernels import _build, aidw, idw, ref
from repro_torch.kernels._common import merge_k_best, sq_dist_tile
from repro_torch.kernels.aidw_fused import aidw_fused_soa
from repro_torch.kernels.aidw_tiled import SUPPORTED_K, check_k, knn_alpha, weight_sweep
from repro_torch.kernels.aidw_tiled_v2 import aidw_tiled_v2_soa, knn_alpha_v2
from repro_torch.kernels.idw_tiled import idw_tiled_soa
from repro_torch.kernels.ops import aidw_v2
from test_torch_core import enable_x64

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "aidw_golden.npz")
RTOL, ATOL = 5e-4, 5e-5
DTYPES = [np.float32, np.float64]
TOL = {np.float32: (1e-6, 1e-5), np.float64: (1e-12, 1e-12)}
# alpha against the Pallas kernels, relative, beside TOL's absolute part
ALPHA_RTOL = {np.float32: 4 * float(np.finfo(np.float32).eps), np.float64: 0.0}
P = dict(k=10, area=1.0)
# (impl, extra build_plan options) of this slice
IMPLS = {"fused": {}, "tiled_v2": {}, "idw": dict(idw_alpha=2.5), "chunked-brute": dict(knn="brute"),
         "chunked-grid": dict(knn="grid")}
EXACT = ["fused", "tiled_v2", "chunked-brute", "chunked-grid"]


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as blob:
        return {k: blob[k] for k in blob.files}


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


def _inputs(golden, name, dtype):
    """A golden batch, or "ragged": m = 500 data points and n = 203 queries,
    neither a multiple of its block, with an exact hit at query 9."""
    if name == "ragged":
        rng = np.random.default_rng(80)
        dx, dy, qx, qy = rng.random(500), rng.random(500), rng.random(203), rng.random(203)
        dz = np.sin(6 * dx) * np.cos(6 * dy) + 2.0
        qx[9], qy[9] = dx[40], dy[40]
        return [a.astype(dtype) for a in (dx, dy, dz, qx, qy)]
    return [golden[f"{name}_{n}"].astype(dtype) for n in ("dx", "dy", "dz", "qx", "qy")]


def _padded(v, mult, dtype, fill=None):
    fill = np.finfo(dtype).max / 4 if fill is None else fill
    return np.concatenate([v, np.full((-len(v)) % mult, fill, dtype)]).astype(dtype)


def _sorted_inputs(dtype):
    """m = 2,000 points sorted by x and 150 queries with x < 0.05: past the
    first tiles no d^2 of a block beats its k-th best, so tiles skip."""
    rng = np.random.default_rng(82)
    dx, dy = np.sort(rng.random(2000)), rng.random(2000)
    dz = np.sin(6 * dx) * np.cos(6 * dy) + 2.0
    qx, qy = 0.05 * rng.random(150), rng.random(150)
    return [a.astype(dtype) for a in (dx, dy, dz, qx, qy)]


def _kernel_inputs(dtype, block_q=64, block_d=128, kind="ragged"):
    dx, dy, dz, qx, qy = _inputs(None, "ragged", dtype) if kind == "ragged" else _sorted_inputs(dtype)
    pads = [_padded(dx, block_d, dtype), _padded(dy, block_d, dtype), _padded(dz, block_d, dtype, 0.0)]
    qp = [_padded(q, block_q, dtype, 0.0) for q in (qx, qy)]
    return pads, qp


def _impl(name):
    return name.split("-")[0], IMPLS[name]


def _build_both(name, dx, dy, dz, dtype, **kw):
    impl, extra = _impl(name)
    with enable_x64(dtype == np.float64):
        jp = j_build_plan(dx, dy, dz, params=JParams(**P), impl=impl, **extra, **kw)
    plan = build_plan(dx, dy, dz, params=AIDWParams(**P), impl=impl, device="cpu", **extra, **kw)
    return jp, plan


def _tiles_near_tau(qx, qy, dx, dy, *, block_q, tile_d, k):
    """Per query block, the tiles holding a d^2 within 2 ulps of its row's
    k-th best at the tile's start: there the Pallas merge test reads XLA's
    contracted d^2 and may fall the other way."""
    n = qx.shape[0]
    best = torch.full((n, k), math.inf, dtype=qx.dtype)
    near = torch.zeros(n // block_q, dtype=torch.int64)
    eps = torch.finfo(qx.dtype).eps
    for j in range(dx.shape[0] // tile_d):
        d2 = sq_dist_tile(qx[:, None], qy[:, None], dx[None, j * tile_d:(j + 1) * tile_d],
                          dy[None, j * tile_d:(j + 1) * tile_d])
        tau = best[:, -1:]
        close = torch.isfinite(tau) & ((d2 - tau).abs() <= 2 * eps * tau.abs())
        near += close.reshape(n // block_q, -1).any(dim=1)
        best = merge_k_best(best, d2)
    return near


def _hold_merges(got, want, near):
    """The merge count equals the Pallas kernel's but on near-tau pairs."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    assert (np.abs(got.astype(np.int64) - want) <= _np(near)).all(), (got, want, _np(near))


# ------------------------------------------------- kernel modules vs Pallas
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_plain_matches_pallas(dtype):
    """B11's plain version against ``aidw_fused_soa``."""
    atol, rtol = TOL[dtype]
    pads, qp = _kernel_inputs(dtype)
    kw = dict(area=1.0, m_real=500, block_q=64, block_d=128)
    with enable_x64(dtype == np.float64):
        jz, ja = j_fused(*(jnp.asarray(p)[None] for p in pads), *(jnp.asarray(q)[:, None] for q in qp),
                         params=JParams(**P), interpret=True, **kw)
    z, a = aidw_fused_soa(*map(_t, pads), *map(_t, qp), params=AIDWParams(**P), **kw)
    np.testing.assert_allclose(_np(a), np.asarray(ja)[:, 0], rtol=ALPHA_RTOL[dtype], atol=atol)
    np.testing.assert_allclose(_np(z), np.asarray(jz)[:, 0], rtol=rtol, atol=0)
    assert _np(z)[9] == pads[2][40]  # the exact hit takes its point's z


@pytest.mark.parametrize("kind", ["ragged", "sorted"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_knn_v2_plain_matches_pallas(dtype, kind):
    """B12's plain version against ``aidw_knn_v2`` (alpha and merges) and
    ``aidw_tiled_v2_soa`` (z); on sorted data most tiles skip."""
    atol, rtol = TOL[dtype]
    pads, qp = _kernel_inputs(dtype, kind=kind)
    m_real = 500 if kind == "ragged" else 2000
    kw = dict(area=1.0, m_real=m_real, block_q=64, block_d=128)
    with enable_x64(dtype == np.float64):
        jd = [jnp.asarray(p)[None] for p in pads]
        jq = [jnp.asarray(q)[:, None] for q in qp]
        ja, jm = j_knn_v2(jd[0], jd[1], *jq, params=JParams(**P), interpret=True, **kw)
        jz, ja2, jm2 = j_tiled_v2(*jd, *jq, params=JParams(**P), interpret=True, **kw)
    a, merges = knn_alpha_v2(*map(_t, qp), _t(pads[0]), _t(pads[1]), block_q=64, tile_d=128,
                             params=AIDWParams(**P), area=1.0, m_real=m_real)
    assert merges.dtype == torch.int32 and merges.shape == (len(qp[0]) // 64,)
    np.testing.assert_allclose(_np(a), np.asarray(ja)[:, 0], rtol=ALPHA_RTOL[dtype], atol=atol)
    near = _tiles_near_tau(*map(_t, qp), _t(pads[0]), _t(pads[1]), block_q=64, tile_d=128, k=10)
    _hold_merges(merges, jm, near)
    z, a2, m2 = aidw_tiled_v2_soa(*map(_t, pads), *map(_t, qp), params=AIDWParams(**P), **kw)
    assert torch.equal(a2, a) and torch.equal(m2, merges)
    np.testing.assert_allclose(_np(z), np.asarray(jz)[:, 0], rtol=rtol, atol=0)
    # the first tile always merges: every block starts from an empty k-best
    n_tiles = len(pads[0]) // 128
    assert bool((merges >= 1).all()) and int(merges.max()) <= n_tiles
    if kind == "sorted":
        assert int(merges.max()) < n_tiles // 2  # most tiles skip
    # and the alpha is B1's, skip or not
    assert torch.equal(a, knn_alpha(*map(_t, qp), _t(pads[0])[None], _t(pads[1])[None], block_q=64, tile_d=128,
                                    params=AIDWParams(**P), area=1.0, m_real=m_real))


@pytest.mark.parametrize("alpha", [2.0, 3.3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_idw_plain_matches_pallas(dtype, alpha):
    """B13's plain version against ``idw_tiled_soa``."""
    _, rtol = TOL[dtype]
    pads, qp = _kernel_inputs(dtype)
    with enable_x64(dtype == np.float64):
        jz = j_idw_tiled(*(jnp.asarray(p)[None] for p in pads), *(jnp.asarray(q)[:, None] for q in qp),
                         alpha=alpha, block_q=64, block_d=128, interpret=True)
    z = idw_tiled_soa(*map(_t, pads), *map(_t, qp), alpha=alpha, block_q=64, block_d=128)
    np.testing.assert_allclose(_np(z), np.asarray(jz)[:, 0], rtol=rtol, atol=0)
    assert _np(z)[9] == pads[2][40]


# ------------------------------------------------------------- plan state
@pytest.mark.parametrize("name", list(IMPLS))
def test_plan_state_equals_jax(golden, name):
    for dtype in DTYPES:
        dx, dy, dz, _, _ = _inputs(golden, "ragged", dtype)
        jp, plan = _build_both(name, dx, dy, dz, dtype, area=1.0, block_q=128, block_d=128, q_chunk=64,
                               d_chunk=256)
        for f in ("impl", "layout", "m", "area", "block_q", "block_d", "knn", "q_chunk", "d_chunk", "idw_alpha"):
            assert getattr(plan, f) == getattr(jp, f), f
        assert len(plan.data) == len(jp.data) == 3
        for got, want in zip(plan.data, jp.data):
            np.testing.assert_array_equal(_np(got), np.asarray(want).reshape(-1))
            assert got.dtype == _t(np.asarray(want)).dtype
        if name == "chunked-grid":
            for f in ("counts", "cum", "starts", "pt_x", "pt_y", "pt_z"):
                np.testing.assert_array_equal(_np(getattr(plan.grid, f)), np.asarray(getattr(jp.grid, f)), f)
        else:
            assert plan.grid is None and jp.grid is None


def test_idw_plans_need_neither_k_points_nor_area():
    """``idw`` skips ``m >= k`` and sets ``area=0.0`` without one, as the
    reference's ``build_plan`` does."""
    dx, dy, dz, qx, qy = _inputs(None, "ragged", np.float32)
    few = [a[:5] for a in (dx, dy, dz)]
    jp = j_build_plan(*few, impl="idw", idw_alpha=1.5, block_q=64, block_d=128)
    plan = build_plan(*few, impl="idw", idw_alpha=1.5, block_q=64, block_d=128, device="cpu")
    assert plan.area == jp.area == 0.0 and plan.m == jp.m == 5 and plan.idw_alpha == 1.5
    jz, ja = j_execute(jp, jnp.asarray(qx), jnp.asarray(qy))
    z, a = execute(plan, qx, qy)
    np.testing.assert_allclose(_np(z), np.asarray(jz), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(_np(a), np.asarray(ja))
    assert (_np(a) == 1.5).all()
    with pytest.raises(ValueError, match="at least k"):
        build_plan(*few, impl="tiled", area=1.0, device="cpu")
    with pytest.raises(ValueError, match="static area"):
        build_plan(dx, dy, dz, impl="fused", device="cpu")


def test_chunked_validations_match_jax():
    dx, dy, dz, qx, qy = _inputs(None, "ragged", np.float32)
    grid = t_core.build_grid(_t(dx), _t(dy), _t(dz))
    for bad, match in ((dict(impl="chunked", knn="kd"), "knn must be"),
                       (dict(impl="chunked", knn="brute", grid=grid), "grid= is only meaningful"),
                       (dict(impl="tiled", grid=grid), "grid= is only meaningful")):
        with pytest.raises(ValueError, match=match):
            build_plan(dx, dy, dz, area=1.0, device="cpu", **bad)
    with pytest.raises(ValueError, match="knn must be"):
        j_build_plan(dx, dy, dz, area=1.0, impl="chunked", knn="kd")
    with pytest.raises(ValueError, match="grid= is only meaningful"):
        aidw_interpolate(dx, dy, dz, qx, qy, AIDWParams(**P), area=1.0, knn="brute", grid=grid, device="cpu")
    with pytest.raises(ValueError, match="static area"):
        aidw_interpolate(dx, dy, dz, qx, qy, AIDWParams(k=10), device="cpu")
    # a grid passed in is kept, not rebuilt
    plan = build_plan(dx, dy, dz, area=1.0, impl="chunked", knn="grid", grid=grid, device="cpu")
    assert plan.grid is grid


# ------------------------------------------------------------ the slice
@pytest.mark.parametrize("batch", ["uniform", "clustered", "ragged"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(IMPLS))
def test_slice_matches_jax_execute(golden, name, dtype, batch):
    atol, rtol = TOL[dtype]
    dx, dy, dz, qx, qy = _inputs(golden, batch, dtype)
    kw = dict(area=1.0, block_q=64, block_d=128, q_chunk=128, d_chunk=256)
    jp, plan = _build_both(name, dx, dy, dz, dtype, **kw)
    with enable_x64(dtype == np.float64):
        jz, ja, jstats = j_execute_with_stats(jp, jnp.asarray(qx), jnp.asarray(qy))
        jz, ja = np.asarray(jz), np.asarray(ja)
    z, a, stats = execute_with_stats(plan, qx, qy)
    assert z.dtype == a.dtype == plan.dtype and z.shape == a.shape == (qx.shape[0],)
    assert set(stats) == set(jstats)
    np.testing.assert_allclose(_np(a), ja, rtol=ALPHA_RTOL[dtype], atol=atol)
    np.testing.assert_allclose(_np(z), jz, rtol=rtol, atol=0)
    if name == "tiled_v2":
        assert stats["merge_fraction"].dtype == torch.float32
        n_pad = -(-qx.shape[0] // 64) * 64
        qp = [_t(_padded(q, 64, dtype, 0.0)) for q in (qx, qy)]
        near = _tiles_near_tau(*qp, plan.data[0], plan.data[1], block_q=64, tile_d=128, k=10)
        steps = (n_pad // 64) * (plan.data[0].shape[0] // 128)
        assert abs(float(stats["merge_fraction"]) - float(jstats["merge_fraction"])) * steps <= int(near.sum()) + 1e-3
        assert 0.0 < float(stats["merge_fraction"]) <= 1.0


@pytest.mark.parametrize("batch", ["uniform", "clustered"])
@pytest.mark.parametrize("name", EXACT)
def test_exact_impls_reproduce_golden(golden, name, batch):
    dx, dy, dz, qx, qy = _inputs(golden, batch, np.float32)
    k, area = int(golden["k"]), float(golden["area"])
    impl, extra = _impl(name)
    plan = build_plan(dx, dy, dz, params=AIDWParams(k=k, area=area), area=area, impl=impl, block_q=64,
                      block_d=128, device="cpu", **extra)
    z, a = execute(plan, qx, qy)
    np.testing.assert_allclose(_np(a), golden[f"{batch}_alpha"], rtol=RTOL, atol=ATOL, err_msg=f"{name} alpha drift")
    np.testing.assert_allclose(_np(z), golden[f"{batch}_z"], rtol=RTOL, atol=ATOL, err_msg=f"{name} z drift")


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_and_v2_give_tiled_bits(golden, dtype):
    """fused is tiled SoA's two passes in one launch; tiled_v2 keeps B1's
    k-smallest multiset, so its alpha and z are tiled's."""
    dx, dy, dz, qx, qy = _inputs(golden, "clustered", dtype)
    out = {}
    for impl in ("tiled", "fused", "tiled_v2"):
        plan = build_plan(dx, dy, dz, params=AIDWParams(**P), area=1.0, impl=impl, block_q=64, block_d=128,
                          device="cpu")
        out[impl] = execute(plan, qx, qy)
    for impl in ("fused", "tiled_v2"):
        assert torch.equal(out[impl][1], out["tiled"][1]), impl
        assert torch.equal(out[impl][0], out["tiled"][0]), impl


@pytest.mark.parametrize("knn", ["brute", "grid"])
def test_aidw_interpolate_equals_a_hand_built_chunked_plan(golden, knn):
    """``tests/engine/test_plan_execute.py::test_chunked_plan_matches_interpolate``
    for the port."""
    dx, dy, dz, qx, qy = _inputs(golden, "clustered", np.float32)
    p = AIDWParams(**P)
    plan = build_plan(dx, dy, dz, params=p, area=1.0, impl="chunked", knn=knn, q_chunk=128, d_chunk=256,
                      device="cpu")
    z1, a1 = execute(plan, qx, qy)
    z2, a2 = aidw_interpolate(_t(dx), _t(dy), _t(dz), _t(qx), _t(qy), p, area=1.0, q_chunk=128, d_chunk=256,
                              knn=knn, device="cpu")
    assert torch.equal(z1, z2) and torch.equal(a1, a2)
    # the chunk sizes move no result beyond the sum order
    z3, a3 = aidw_interpolate(_t(dx), _t(dy), _t(dz), _t(qx), _t(qy), p, area=1.0, knn=knn, device="cpu")
    assert torch.equal(a1, a3)
    np.testing.assert_allclose(_np(z3), _np(z1), rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_idw_equals_the_filled_weight_sweep(golden, dtype):
    dx, dy, dz, qx, qy = _inputs(golden, "uniform", dtype)
    plan = build_plan(dx, dy, dz, impl="idw", idw_alpha=3.3, block_q=64, block_d=128, device="cpu")
    z, a = execute(plan, qx, qy)
    qp = [_t(_padded(q, 64, dtype, 0.0)) for q in (qx, qy)]
    half = torch.full_like(qp[0], 3.3 * 0.5)
    want = weight_sweep(*qp, half, *plan.data, tile_d=128, eps=1e-18)[:qx.shape[0]]
    assert torch.equal(z, want) and bool((a == torch.tensor(3.3, dtype=a.dtype)).all())
    assert torch.equal(idw(dx, dy, dz, qx, qy, alpha=3.3, block_q=64, block_d=128, device="cpu"), z)


def test_aidw_v2_warns_and_returns_the_merge_fraction(golden):
    dx, dy, dz, qx, qy = _inputs(golden, "uniform", np.float32)
    kw = dict(params=AIDWParams(**P), area=1.0, block_q=64, block_d=128)
    with pytest.warns(DeprecationWarning, match="aidw_v2 is deprecated"):
        z, a, frac = aidw_v2(dx, dy, dz, qx, qy, device="cpu", **kw)
    plan = build_plan(dx, dy, dz, impl="tiled_v2", device="cpu", **kw)
    z2, a2, stats = execute_with_stats(plan, qx, qy)
    assert torch.equal(z, z2) and torch.equal(a, a2) and torch.equal(frac, stats["merge_fraction"])
    with pytest.warns(DeprecationWarning):
        _, _, jfrac = j_aidw_v2(dx, dy, dz, qx, qy, params=JParams(**P), area=1.0, block_q=64, block_d=128)
    qp = [_t(_padded(q, 64, np.float32, 0.0)) for q in (qx, qy)]
    near = _tiles_near_tau(*qp, plan.data[0], plan.data[1], block_q=64, tile_d=128, k=10)
    steps = (qp[0].shape[0] // 64) * (plan.data[0].shape[0] // 128)
    assert 0.0 < float(frac) <= 1.0 and abs(float(frac) - float(jfrac)) * steps <= int(near.sum()) + 1e-3


def _export(jp):
    p = jp.params
    statics = dict(impl=jp.impl, layout=jp.layout, m=jp.m, area=jp.area, block_q=jp.block_q, block_d=jp.block_d,
                   knn=jp.knn, q_chunk=jp.q_chunk, d_chunk=jp.d_chunk, idw_alpha=jp.idw_alpha,
                   params=dict(k=p.k, alpha_levels=tuple(p.alpha_levels), r_min=p.r_min, r_max=p.r_max,
                               area=p.area, exact_hit_eps=p.exact_hit_eps))
    arrays = {n: np.asarray(a) for n, a in zip(("dx", "dy", "dz"), jp.data)}
    if jp.grid is not None:
        g = jp.grid
        arrays.update(origin=np.asarray(g.origin), cell_size=np.asarray(g.cell_size), counts=np.asarray(g.counts),
                      cum=np.asarray(g.cum), starts=np.asarray(g.starts), pt_x=np.asarray(g.pt_x),
                      pt_y=np.asarray(g.pt_y), pt_z=np.asarray(g.pt_z))
    return statics, arrays


@pytest.mark.parametrize("name", list(IMPLS))
def test_plan_from_reference_executes_like_jax(golden, name):
    atol, rtol = TOL[np.float32]
    dx, dy, dz, qx, qy = _inputs(golden, "uniform", np.float32)
    jp, own = _build_both(name, dx, dy, dz, np.float32, area=1.0, block_q=128, block_d=128)
    carried = plan_from_reference(*_export(jp), device="cpu")
    for f in ("impl", "block_q", "block_d", "knn", "q_chunk", "d_chunk", "idw_alpha", "m", "area"):
        assert getattr(carried, f) == getattr(own, f), f
    for a, b in zip(carried.data, own.data, strict=True):
        assert torch.equal(a, b)
    jz, ja = j_execute(jp, jnp.asarray(qx), jnp.asarray(qy))
    z, a = execute(carried, qx, qy)
    np.testing.assert_allclose(_np(a), np.asarray(ja), rtol=ALPHA_RTOL[np.float32], atol=atol)
    np.testing.assert_allclose(_np(z), np.asarray(jz), rtol=rtol, atol=0)
    z2, a2 = execute(own, qx, qy)
    assert torch.equal(z, z2) and torch.equal(a, a2)


@pytest.mark.parametrize("name", list(IMPLS))
def test_nonfinite_queries_yield_nan(golden, name):
    dx, dy, dz, qx, qy = _inputs(golden, "uniform", np.float32)
    impl, extra = _impl(name)
    plan = build_plan(dx, dy, dz, params=AIDWParams(**P), area=1.0, impl=impl, block_q=64, block_d=128,
                      device="cpu", **extra)
    hx, hy = qx.copy(), qy.copy()
    hx[3], hy[7], hx[11] = np.nan, np.nan, np.inf
    bad = ~(np.isfinite(hx) & np.isfinite(hy))
    z, a = execute(plan, hx, hy)
    zd, ad = execute(plan, np.where(bad, 0, hx).astype(np.float32), np.where(bad, 0, hy).astype(np.float32))
    assert np.isnan(_np(z)[bad]).all() and np.isnan(_np(a)[bad]).all()
    np.testing.assert_array_equal(_np(z)[~bad], _np(zd)[~bad])
    np.testing.assert_array_equal(_np(a)[~bad], _np(ad)[~bad])


# ---------------------------------------------------- core and references
@pytest.mark.parametrize("dtype", DTYPES)
def test_idw_core_and_references_match_jax(dtype):
    _, rtol = TOL[dtype]
    dx, dy, dz, qx, qy = _inputs(None, "ragged", dtype)
    with enable_x64(dtype == np.float64):
        j = [jnp.asarray(v) for v in (dx, dy, dz, qx, qy)]
        want_ref = np.asarray(j_idw_reference(*j, alpha=2.5))
        want_int = np.asarray(j_idw_interpolate(*j, alpha=2.5, q_chunk=64, d_chunk=128))
        jz, ja = (np.asarray(v) for v in j_ref.aidw_ref(*j, JParams(**P), 1.0))
        jza, jaa = (np.asarray(v) for v in j_ref.aidw_ref_aoas(j_soa_to_aoas(*j[:3]), *j[3:], JParams(**P), 1.0))
        jidw = np.asarray(j_ref.idw_ref(*j, 2.5))
    t = [_t(v) for v in (dx, dy, dz, qx, qy)]
    np.testing.assert_allclose(_np(idw_reference(*t, alpha=2.5)), want_ref, rtol=rtol, atol=0)
    np.testing.assert_allclose(_np(idw_interpolate(*t, alpha=2.5, q_chunk=64, d_chunk=128)), want_int, rtol=rtol,
                               atol=0)
    np.testing.assert_allclose(_np(ref.idw_ref(*t, 2.5)), jidw, rtol=rtol, atol=0)
    for (z, a), (wz, wa) in ((ref.aidw_ref(*t, AIDWParams(**P), 1.0), (jz, ja)),
                             (ref.aidw_ref_aoas(t_core.soa_to_aoas(*t[:3]), *t[3:], AIDWParams(**P), 1.0),
                              (jza, jaa))):
        np.testing.assert_allclose(_np(a), wa, rtol=ALPHA_RTOL[dtype], atol=TOL[dtype][0])
        np.testing.assert_allclose(_np(z), wz, rtol=rtol, atol=0)
    assert _np(idw_reference(*t))[9] == dz[40]


def test_relative_rmse_and_pointset_match_jax():
    rng = np.random.default_rng(81)
    exact, approx = rng.random(300), rng.random(300)
    approx = exact + 1e-3 * approx
    with enable_x64(True):
        want = j_relative_rmse(jnp.asarray(approx), jnp.asarray(exact))
    assert relative_rmse(_t(approx), _t(exact)) == pytest.approx(want, rel=1e-12)
    assert relative_rmse(_t(exact.astype(np.float32)), _t(exact)) < 1e-7
    ps = PointSet(*(_t(v) for v in (exact, approx, exact)))
    assert ps.m == 300 and ps.astype(torch.float32).x.dtype == torch.float32


def test_core_exports_match_jax():
    """C1: ``repro_torch.core`` exports every name of ``repro.core``."""
    assert set(j_core.__all__) <= set(t_core.__all__)
    for name in ("UniformGrid", "build_grid", "grid_knn", "grid_r_obs", "soa_to_aoas", "aoas_to_soa", "PointSet",
                 "idw_reference", "idw_interpolate", "aidw_interpolate"):
        assert callable(getattr(t_core, name)), name


# ------------------------------------------------------ entry-point repairs
@pytest.mark.parametrize("phase2", ["exact", "farfield", "quadtree"])
def test_aidw_phase2_equals_build_plan_execute(golden, phase2):
    """C1: ``aidw(phase2=...)`` reaches the far-field arms and gives the bits
    of ``build_plan`` + ``execute`` with the same options."""
    dx, dy, dz = (golden[f"qtree_{n}"] for n in ("dx", "dy", "dz"))
    qx, qy = golden["qtree_qx"], golden["qtree_qy"]
    kw = dict(params=AIDWParams(**P), area=1.0, impl="grid", phase2=phase2, farfield_rtol=1e-2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # an unprovable rtol warns, in both calls alike
        z, a = aidw(dx, dy, dz, qx, qy, **kw)
        plan = build_plan(dx, dy, dz, **kw)
        z2, a2 = execute(plan, qx, qy)
        z3, a3 = aidw(dx, dy, dz, qx, qy, farfield_radius=2, **{**kw, "phase2": "farfield"})
    assert plan.phase2 == phase2
    assert torch.equal(z, z2) and torch.equal(a, a2)
    assert bool(torch.isfinite(z3).all()) and torch.equal(a3, a2)  # the radius moves Phase 2 only


def test_k_list_limit_on_the_card():
    """C2: the kernels take any k in 1..16; beyond it the wrappers raise a
    ``ValueError`` that names the limit, before any launch."""
    assert SUPPORTED_K == tuple(range(1, 17))
    for k in (1, 7, 16):
        check_k("t", k)
    for k in (0, 17, 32):
        with pytest.raises(ValueError, match=r"k in 1\.\.16 \(AIDW_K_LIST"):
            check_k("t", k)


def test_k7_paths_agree_on_the_cpu(golden):
    """C2: k = 7, outside the old (5, 10), runs through every dense impl and
    keeps their bits, as on the card (``chip_smoke.py`` phase 26)."""
    dx, dy, dz, qx, qy = _inputs(golden, "clustered", np.float32)
    p = AIDWParams(k=7, area=1.0)
    out = {impl: execute(build_plan(dx, dy, dz, params=p, area=1.0, impl=impl, block_q=64, block_d=128,
                                    device="cpu"), qx, qy) for impl in ("tiled", "naive", "fused", "tiled_v2")}
    for impl in ("naive", "fused", "tiled_v2"):
        assert torch.equal(out[impl][1], out["tiled"][1]), impl
    jz, ja = j_execute(j_build_plan(dx, dy, dz, params=JParams(k=7, area=1.0), area=1.0, impl="fused", block_q=64,
                                    block_d=128), jnp.asarray(qx), jnp.asarray(qy))
    np.testing.assert_allclose(_np(out["fused"][1]), np.asarray(ja), rtol=ALPHA_RTOL[np.float32], atol=1e-6)
    np.testing.assert_allclose(_np(out["fused"][0]), np.asarray(jz), rtol=1e-5, atol=0)


def test_x64_helper_takes_either_name(monkeypatch):
    """C3: the port's tests enter JAX's x64 context through one helper that
    takes ``jax.enable_x64`` where it exists, else the older
    ``jax.experimental.enable_x64``."""
    import jax
    import jax.experimental

    with enable_x64(True):
        assert jnp.asarray(1.0, jnp.float64).dtype == jnp.float64
    assert jnp.asarray(np.ones(1)).dtype == jnp.float32  # off again outside the context
    seen = []

    def older(on=True):
        seen.append(on)
        return "ctx"

    monkeypatch.delattr(jax, "enable_x64", raising=False)
    monkeypatch.setattr(jax.experimental, "enable_x64", older, raising=False)
    assert enable_x64(False) == "ctx" and seen == [False]


def test_build_dir_from_environment(monkeypatch, tmp_path):
    """C4: ``REPRO_TORCH_BUILD_DIR`` moves the libraries; unset, they stay
    in the checkout's ``build/repro_torch_kernels``."""
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR
    assert str(_build.DEFAULT_BUILD_DIR) == os.path.join(root, "build", "repro_torch_kernels")
    assert _build.library_path("fused").parent == _build.DEFAULT_BUILD_DIR
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert _build.build_dir() == tmp_path / "kernels"
    for name in _build.SOURCES:
        assert _build.library_path(name).parent == tmp_path / "kernels"


# ------------------------------------------------------------ wrapper rules
def test_new_wrappers_plain_on_cpu_refuse_the_rest():
    pads, qp = _kernel_inputs(np.float32)
    dx, dy, dz = map(_t, pads)
    qx, qy = map(_t, qp)
    kw = dict(params=AIDWParams(**P), area=1.0, m_real=500, block_q=64, block_d=128)
    assert {"fused", "knn_v2", "idw"} <= set(_build.LAUNCHES)
    before = dict(_build.LAUNCHES)
    aidw_fused_soa(dx, dy, dz, qx, qy, **kw)
    knn_alpha_v2(qx, qy, dx, dy, block_q=64, tile_d=128, params=AIDWParams(**P), area=1.0, m_real=500)
    idw_tiled_soa(dx, dy, dz, qx, qy, block_q=64, block_d=128)
    assert _build.LAUNCHES == before  # the plain versions launch nothing
    meta = torch.empty(512, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        aidw_fused_soa(meta, meta, meta, meta[:64], meta[:64], **kw)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        knn_alpha_v2(meta[:64], meta[:64], meta, meta, block_q=64, tile_d=128, params=AIDWParams(**P), area=1.0,
                     m_real=500)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        idw_tiled_soa(meta, meta, meta, meta[:64], meta[:64], block_q=64, block_d=128)
    with pytest.raises(ValueError, match="bad shapes"):
        aidw_fused_soa(dx, dy, dz, qx[:50], qy[:50], **kw)
    with pytest.raises(ValueError, match="bad shapes"):
        knn_alpha_v2(qx, qy, dx[:100], dy[:100], block_q=64, tile_d=128, params=AIDWParams(**P), area=1.0,
                     m_real=500)
    with pytest.raises(ValueError, match="bad shapes"):
        idw_tiled_soa(dx, dy, dz, qx, qy, block_q=48, block_d=128)
    # the knn pass the merge count rides on is B1: its bits on the CPU too
    a1 = knn_alpha(qx, qy, dx[None], dy[None], block_q=64, tile_d=128, params=AIDWParams(**P), area=1.0, m_real=500)
    a2, _ = knn_alpha_v2(qx, qy, dx, dy, block_q=64, tile_d=128, params=AIDWParams(**P), area=1.0, m_real=500)
    assert torch.equal(a1, a2)
