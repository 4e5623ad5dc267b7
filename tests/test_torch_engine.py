"""The port's plan/execute engine against the JAX package's, on the CPU.

Plan state (grid, CSR arrays, radii, capacities, seam level, rebuilds, padded
data) and per-batch state (candidate need, tile table, overflow mask, seam
layout) must be equal exactly; outputs agree with the JAX ``execute`` within
1e-6 absolute in alpha and 1e-5 relative in z (float32: the libraries' cos,
exp, log and sum orders differ by a few ulps).  Also: NaN/Inf hardening, the
stats dict and the persistent-overflow streak, and the validations.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as j_grid
from repro.core.aidw import AIDWParams as JParams
from repro.core.layouts import pad_tail as j_pad_tail
from repro.engine import build_plan as j_build_plan
from repro.engine import execute_with_stats as j_execute_with_stats
from repro.engine.execute import _seam_split_layout as j_seam_split
from repro.engine.execute import _tile_table as j_tile_table
from repro.kernels.aidw_grid import block_rectangles as j_block_rectangles
from repro.kernels.aidw_grid import gather_candidates_csr as j_gather
from repro_torch.core.aidw import AIDWParams, adaptive_alpha
from repro_torch.core.grid import grid_r_obs
from repro_torch.engine import (
    PERSISTENT_OVERFLOW_BATCHES,
    build_plan,
    execute,
    execute_with_stats,
)
from repro_torch.engine.execute import _grid_layout
from repro_torch.errors import CapacityOverflowWarning, PathologicalGridWarning
from repro_torch.kernels import aidw
from test_torch_core import enable_x64

ALPHA_ATOL, Z_RTOL = 1e-6, 1e-5
P = dict(k=10, area=1.0)
STATS_KEYS = {"grid_fallback", "cand_need_max", "overflow_blocks", "overflow_queries",
              "overflow_query_mask", "skipped_tile_fraction", "persistent_overflow"}


def _np(t):
    return t.detach().cpu().numpy()


def _dataset(kind, dtype=np.float32, m=3000, seed=30):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pts = rng.random((m, 2))
    elif kind == "clustered":
        centers = rng.random((max(2, m // 64), 2))
        pts = np.clip(centers[rng.integers(0, len(centers), m)] + rng.normal(0, 0.02, (m, 2)), 0, 1)
    elif kind == "corners":  # two tight clusters: the default resolution is pathological
        pts = np.concatenate([0.01 * rng.random((m // 2, 2)), 0.99 + 0.01 * rng.random((m - m // 2, 2))])
    else:  # "outliers": a few points far outside the bulk of the data
        pts = rng.random((m, 2))
        pts[:5] = [[-3.0, 2.0], [4.0, -1.5], [5.0, 5.0], [-2.0, -2.0], [0.5, 7.0]]
    dx, dy = pts[:, 0].astype(dtype), pts[:, 1].astype(dtype)
    dz = (np.sin(6 * pts[:, 0]) * np.cos(6 * pts[:, 1]) + 2.0).astype(dtype)
    return dx, dy, dz


def _plans(data, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=UserWarning)
        jp = j_build_plan(*data, params=JParams(**P), area=1.0, **kw)
        tp = build_plan(*data, params=AIDWParams(**P), area=1.0, device="cpu", **kw)
    return jp, tp


def _assert_plan_state_equal(jp, tp):
    for f in ("m", "block_q", "block_d", "cand_capacity", "cand_block_d", "seam_level",
              "grid_rebuilds", "pipeline", "area"):
        assert getattr(tp, f) == getattr(jp, f), f
    for a, b in zip(tp.data, jp.data):
        np.testing.assert_array_equal(_np(a), np.asarray(b).reshape(-1))
    if jp.grid is None:
        return
    assert (tp.grid.gx, tp.grid.gy, tp.grid.cap) == (jp.grid.gx, jp.grid.gy, jp.grid.cap)
    for f in ("origin", "cell_size", "counts", "cum", "starts", "pt_x", "pt_y", "pt_z",
              "cell_x", "cell_y", "cell_z"):
        np.testing.assert_array_equal(_np(getattr(tp.grid, f)), np.asarray(getattr(jp.grid, f)), err_msg=f)
    np.testing.assert_array_equal(_np(tp.r_need), np.asarray(jp.r_need))


# ------------------------------------------------------------------ plan state
@pytest.mark.parametrize("kind,dtype", [("uniform", np.float32), ("uniform", np.float64),
                                        ("clustered", np.float32), ("clustered", np.float64),
                                        ("corners", np.float32), ("outliers", np.float64)])
def test_grid_plan_state_equal(kind, dtype):
    kw = dict(target_occupancy=4.0) if kind == "corners" else {}
    m = 800 if kind == "corners" else 3000
    with enable_x64(dtype == np.float64):
        jp, tp = _plans(_dataset(kind, dtype, m=m), impl="grid", **kw)
    _assert_plan_state_equal(jp, tp)
    if kind == "corners":
        assert tp.grid_rebuilds > 0


def test_user_grid_is_kept_and_warned_about():
    from repro_torch.core.grid import build_grid

    dx, dy, dz = (torch.as_tensor(a) for a in _dataset("corners", m=800))
    g = build_grid(dx, dy, dz, gx=64, gy=64)
    with pytest.warns(PathologicalGridWarning):
        plan = build_plan(dx, dy, dz, params=AIDWParams(**P), area=1.0, impl="grid", grid=g, device="cpu")
    assert plan.grid is g and plan.grid_rebuilds == 0


# ---------------------------------------------------------------- batch state
def _seam_batch():
    rng = np.random.default_rng(42)
    qa = (0.05 + 0.03 * rng.random((256, 2))).astype(np.float32)  # tile-local
    t = np.linspace(0.02, 0.98, 256).astype(np.float32)           # seam diagonal
    return np.concatenate([qa[:, 0], t]), np.concatenate([qa[:, 1], t])


def _batch(name):
    rng = np.random.default_rng(43)
    if name == "uniform":
        return rng.random(300).astype(np.float32), rng.random(300).astype(np.float32)
    if name == "out_of_bbox":
        return (rng.random(300) * 6 - 3).astype(np.float32), (rng.random(300) * 6 - 3).astype(np.float32)
    return _seam_batch()


def _jax_batch_state(plan, qx, qy):
    """The JAX grid path up to its first kernel, step by step."""
    grid = plan.grid
    n = qx.shape[0]
    cx, cy = j_grid.cell_of(grid, qx, qy)
    order = jnp.argsort(j_grid.morton_ids(cx, cy), stable=True)
    n_pad = (-n) % plan.block_q
    qx_s, qy_s = j_pad_tail(qx[order], n_pad), j_pad_tail(qy[order], n_pad)
    cx_s, cy_s = j_grid.cell_of(grid, qx_s, qy_s)
    qx_v, qy_v, cx_v, cy_v, src, dest = j_seam_split(plan, qx_s, qy_s, cx_s, cy_s)
    r_safe = j_grid.safe_radius_from_need(grid, qx_v, qy_v, cx_v, cy_v, plan.r_need[cy_v, cx_v])
    rects = j_block_rectangles(grid, cx_v, cy_v, r_safe, plan.block_q)
    cand_x, _, need = j_gather(grid, *rects, plan.cand_capacity)
    over_v = jnp.repeat(need > plan.cand_capacity, plan.block_q)
    return dict(order=order, qx_v=qx_v, src=src, dest=dest, cand_x=cand_x, need=need,
                num_tiles=j_tile_table(need, plan.cand_capacity, plan.cand_block_d, "prefetch"),
                over_q=over_v if dest is None else over_v[dest])


@pytest.mark.parametrize("batch", ["uniform", "seam_overflow", "out_of_bbox"])
def test_batch_state_equal(batch):
    data = _dataset("uniform", m=4096, seed=42)
    kw = {"uniform": {}, "seam_overflow": dict(query_occupancy=64.0, seam_level=0),
          "out_of_bbox": dict(query_occupancy=64.0)}[batch]
    jp, tp = _plans(data, impl="grid", **kw)
    qx, qy = _batch(batch)
    ref = _jax_batch_state(jp, jnp.asarray(qx), jnp.asarray(qy))
    got = vars(_grid_layout(tp, torch.as_tensor(qx), torch.as_tensor(qy)))
    for key, val in ref.items():
        if val is None:
            assert got[key] is None, key
        else:
            np.testing.assert_array_equal(_np(got[key]), np.asarray(val), err_msg=key)
    if batch != "uniform":
        assert _np(got["over_q"]).any()


def test_overflow_stats_match_jax_and_ring_arm_is_exact():
    """On the seam-overflow batch, the stats and the overflow mask equal the
    JAX package's, the overflowed queries' alpha is the port's ring search
    bit for bit, and everything agrees with the JAX execute."""
    data = _dataset("uniform", m=4096, seed=42)
    jp, tp = _plans(data, impl="grid", query_occupancy=64.0, seam_level=0)
    qx, qy = _seam_batch()
    jz, ja, js = j_execute_with_stats(jp, jnp.asarray(qx), jnp.asarray(qy))
    z, a, stats = execute_with_stats(tp, qx, qy)
    assert set(stats) == STATS_KEYS == set(js)
    for key in STATS_KEYS - {"persistent_overflow", "skipped_tile_fraction"}:
        np.testing.assert_array_equal(_np(stats[key]), np.asarray(js[key]), err_msg=key)
    assert float(stats["skipped_tile_fraction"]) == pytest.approx(float(js["skipped_tile_fraction"]))
    mask = _np(stats["overflow_query_mask"])
    assert 0 < mask.sum() < mask.size and not bool(stats["grid_fallback"])
    ring = adaptive_alpha(grid_r_obs(tp.grid, torch.as_tensor(qx), torch.as_tensor(qy), 10), tp.m, 1.0,
                          tp.params)
    np.testing.assert_array_equal(_np(a)[mask], _np(ring)[mask])
    np.testing.assert_allclose(_np(a), np.asarray(ja), rtol=0, atol=ALPHA_ATOL)
    np.testing.assert_allclose(_np(z), np.asarray(jz), rtol=Z_RTOL, atol=0)


# ------------------------------------------------------------------ hardening
def _mixed_queries(n=64, seed=41):
    rng = np.random.default_rng(seed)
    qx, qy = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    qx[3], qy[7], qx[11] = np.nan, np.nan, np.inf
    qy[12], qx[20] = -np.inf, np.nan
    return qx, qy, ~(np.isfinite(qx) & np.isfinite(qy))


@pytest.mark.parametrize("impl", ["grid", "tiled"])
def test_nonfinite_queries_yield_nan_finite_untouched(impl):
    rng = np.random.default_rng(40)
    dx, dy = rng.random(512).astype(np.float32), rng.random(512).astype(np.float32)
    dz = (np.sin(3 * dx) + dy).astype(np.float32)
    plan = build_plan(dx, dy, dz, params=AIDWParams(k=5, area=1.0, r_max=64.0), impl=impl, device="cpu")
    qx, qy, bad = _mixed_queries()
    z, a = (_np(t) for t in execute(plan, qx, qy))
    assert np.isnan(z[bad]).all() and np.isnan(a[bad]).all()
    assert np.isfinite(z[~bad]).all() and np.isfinite(a[~bad]).all()
    z_ref, a_ref = (_np(t) for t in execute(plan, np.where(bad, 0.0, qx).astype(np.float32),
                                            np.where(bad, 0.0, qy).astype(np.float32)))
    np.testing.assert_array_equal(z[~bad], z_ref[~bad])
    np.testing.assert_array_equal(a[~bad], a_ref[~bad])


def test_nonfinite_data_rejected():
    dx, dy, dz = _dataset("uniform", m=256)
    for arr in (dx, dy, dz):
        bad = arr.copy()
        bad[17] = np.nan
        args = [bad if a is arr else a for a in (dx, dy, dz)]
        with pytest.raises(ValueError, match="non-finite"):
            build_plan(*args, params=AIDWParams(**P), impl="grid", device="cpu")


# ------------------------------------------------------- stats and streaks
def test_persistent_overflow_streak_and_warning():
    data = _dataset("uniform", m=4096, seed=44)
    plan = build_plan(*data, params=AIDWParams(k=10, area=1.0, r_max=64.0), impl="grid",
                      query_occupancy=64.0, device="cpu")
    rng = np.random.default_rng(45)
    far = ((rng.random(40) * 6 - 3).astype(np.float32), (rng.random(40) * 6 - 3).astype(np.float32))
    clean = tuple((0.05 + 0.03 * rng.random(128)).astype(np.float32) for _ in range(2))
    flags = []
    with pytest.warns(CapacityOverflowWarning):
        for _ in range(PERSISTENT_OVERFLOW_BATCHES):
            _, _, stats = execute_with_stats(plan, *far)
            flags.append(stats["persistent_overflow"])
    assert set(stats) == STATS_KEYS
    assert flags == [False] * (PERSISTENT_OVERFLOW_BATCHES - 1) + [True]
    assert bool(stats["grid_fallback"]) and int(stats["overflow_queries"]) == 40
    _, _, stats = execute_with_stats(plan, *clean)
    assert int(stats["overflow_queries"]) == 0 and stats["persistent_overflow"] is False
    assert 0.0 <= float(stats["skipped_tile_fraction"]) < 1.0


# ---------------------------------------------------------------- validations
def test_validations_and_unported_options():
    data = _dataset("uniform", m=256)
    kw = dict(params=AIDWParams(**P), device="cpu")
    # the last four impls of the reference build and run
    for impl in ("tiled_v2", "fused", "chunked", "idw"):
        z, a = execute(build_plan(*data, impl=impl, area=1.0, **kw), data[0][:9], data[1][:9])
        assert z.shape == a.shape == (9,) and bool(torch.isfinite(z).all() & torch.isfinite(a).all()), impl
    for bad in (dict(farfield_rtol=0.0), dict(farfield_rtol=-1e-3), dict(farfield_radius=0)):
        with pytest.raises(ValueError, match="farfield_r"):
            build_plan(*data, impl="grid", phase2="farfield", **bad, **kw)
    with pytest.raises(ValueError, match="quadtree"):
        build_plan(*data, impl="tiled", phase2="quadtree", **kw)
    with pytest.raises(ValueError, match="farfield_rtol"):
        build_plan(*data, impl="grid", phase2="quadtree", farfield_rtol=0.0, **kw)
    for impl in ("binned", "grid", "fused", "tiled_v2", "idw", "chunked"):
        with pytest.raises(ValueError, match="SoA-only"):
            build_plan(*data, impl=impl, layout="aoas", **kw)
    for bad in (dict(impl="bogus"), dict(pipeline="x"), dict(seam_level=9), dict(phase2="x"),
                dict(impl="tiled", phase2="farfield"), dict(layout="x")):
        with pytest.raises(ValueError):
            build_plan(*data, **{**dict(impl="grid"), **bad}, **kw)
    with pytest.raises(ValueError, match="at least k"):
        build_plan(*(a[:5] for a in data), impl="grid", **kw)
    with pytest.raises(ValueError, match="static area"):
        build_plan(*data, impl="tiled", device="cpu")
    plan = build_plan(*data, impl="tiled", **kw)
    with pytest.raises(ValueError, match="queries must be"):
        execute(plan, np.zeros(4), np.zeros(4))  # float64 queries against a float32 plan


@pytest.mark.parametrize("impl", ["grid", "tiled"])
def test_ops_aidw_matches_engine(impl):
    data = _dataset("clustered", m=600, seed=46)
    rng = np.random.default_rng(47)
    qx, qy = rng.random(70).astype(np.float32), rng.random(70).astype(np.float32)
    z, a = aidw(*data, qx, qy, params=AIDWParams(**P), area=1.0, impl=impl, device="cpu")
    plan = build_plan(*data, params=AIDWParams(**P), area=1.0, impl=impl, device="cpu")
    z2, a2 = execute(plan, qx, qy)
    np.testing.assert_array_equal(_np(z), _np(z2))
    np.testing.assert_array_equal(_np(a), _np(a2))
    for other in ("fused", "tiled_v2"):
        z3, a3 = aidw(*data, qx, qy, params=AIDWParams(**P), area=1.0, impl=other, device="cpu")
        z4, a4 = execute(build_plan(*data, params=AIDWParams(**P), area=1.0, impl=other, device="cpu"), qx, qy)
        assert torch.equal(z3, z4) and torch.equal(a3, a4), other
    for own_entry in ("idw", "chunked"):  # they have their own entry points, as in the reference
        with pytest.raises(ValueError, match="impl must be one of"):
            aidw(*data, qx, qy, area=1.0, impl=own_entry, device="cpu")
    with pytest.raises(ValueError, match="SoA-only"):
        aidw(*data, qx, qy, area=1.0, impl="binned", layout="aoas", device="cpu")
