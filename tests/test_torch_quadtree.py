"""The port's quadtree far field (``phase2="quadtree"``) against the JAX
package's, on the CPU, at the shapes of ``tests/engine/test_quadtree.py``
(4,000 points or fewer, ``block_q=64``, its ``_tight_data`` and ``_queries``).

* the aggregates: ``quadtree_aggregates`` against the JAX one, level shapes,
  counts and z-sums exactly, centroids, moments and bounds within 2 ulps
  (they come out bitwise), and the port's own re-aggregation invariants;
* plan state: radius, capacities, tiles and ``qt_levels`` exactly,
  ``farfield_bound`` and ``qt_tau`` within 1e-9 relative, the node arrays as
  the aggregates, the same warnings; the bound model's bisection bitwise;
* the walk: each level's node table and counts equal the JAX
  ``_quadtree_walk``'s exactly, also when the port walks in chunks;
* B6 (``_far_node_kernel``): the plain version against the Pallas kernel in
  interpret mode, sums within 1e-5 / 1e-12 on the ``max|.|`` scale, every
  level; sentinel slots add exactly 0;
* the slice: ``execute`` against the JAX ``execute`` on four query
  distributions (z within 1e-5 / 1e-12 of ``max|z|``, the stats within 1e-6,
  alpha bitwise the port's exact plan's), the golden ``qtree_*`` pin, the
  measured error within the proved bound in float32 and float64, the
  overflow arm bitwise the exact plan's, the validations.

The float64 JAX references are made under JAX's x64 context (``test_torch_core.enable_x64``).  The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import dataclasses
import importlib
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidw import AIDWParams as JParams
from repro.core.grid import build_grid as j_build_grid
from repro.core.grid import quadtree_aggregates as j_quadtree_aggregates
from repro.engine import build_plan as j_build_plan
from repro.engine import execute_with_stats as j_execute_with_stats
from repro.engine import plan as j_plan
from repro.kernels.aidw_grid import block_rectangles as j_block_rectangles
from repro.kernels.aidw_grid import phase2_far_nodes as j_far_nodes
from repro_torch.core import accuracy
from repro_torch.core.aidw import AIDWParams
from repro_torch.core.grid import build_grid, quadtree_aggregates, quadtree_level_count
from repro_torch.engine import build_plan, execute, execute_with_stats, plan_from_reference
from repro_torch.engine import plan as t_plan
from repro_torch.engine.execute import _grid_layout
from repro_torch.engine.plan import QT_ARRAYS
from repro_torch.errors import UnprovableRtolWarning
from repro_torch.kernels import _build
from repro_torch.kernels.aidw_grid import block_rectangles, phase2_far_nodes, phase2_far_nodes_plain
from test_torch_core import enable_x64

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "aidw_golden.npz")
DTYPES = [np.float32, np.float64]
REL = {np.float32: 1e-5, np.float64: 1e-12}  # sums and z
DISTRIBUTIONS = ("uniform", "clustered", "seam", "out_of_bbox")
P = dict(k=10, area=1.0)
j_execute_mod = importlib.import_module("repro.engine.execute")
t_execute_mod = importlib.import_module("repro_torch.engine.execute")


def _np(t):
    return t.detach().cpu().numpy()


def _x64(dtype):
    return enable_x64(dtype == np.float64)


def _field(x, y):
    return (np.sin(6 * x) * np.cos(6 * y) + 2.0).astype(x.dtype)


def _tight_data(seed, dtype=np.float32, gx=12, m=4000, sigma=1e-4, z_noise=0.0):
    """Per-cell clusters far below the cell scale (tests/engine/test_quadtree.py):
    the dipole bound proves rtol = 1e-3.  ``z_noise`` varies z inside the
    clusters, which the single-level model cannot prove 1e-3 under."""
    rng = np.random.default_rng(seed)
    centers = (np.stack(np.meshgrid(np.arange(gx), np.arange(gx)), -1).reshape(-1, 2) + 0.5) / gx
    pts = centers[rng.integers(0, gx * gx, m)] + rng.normal(0, sigma, (m, 2))
    pts = np.clip(pts, 0.0, 1.0).astype(dtype)
    dx, dy = pts[:, 0], pts[:, 1]
    dz = _field(dx, dy) + (z_noise * rng.standard_normal(m)).astype(dtype)
    return dx, dy, dz.astype(dtype)


def _uniform_data(seed=30, dtype=np.float32, m=3000):
    """Coarse data (dispersion about the cell size): not provable, so the
    plan warns, and its opening ratio is large enough to close coarse nodes."""
    rng = np.random.default_rng(seed)
    dx, dy = rng.random(m).astype(dtype), rng.random(m).astype(dtype)
    return dx, dy, _field(dx, dy)


def _queries(dist, nq, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        q = rng.random((nq, 2))
    elif dist == "clustered":
        q = 0.35 + 0.12 * rng.random((nq, 2))
    elif dist == "seam":
        t = np.linspace(0.02, 0.98, nq)
        q = np.stack([t, t], 1) + rng.normal(0, 0.01, (nq, 2))
    else:  # out_of_bbox
        q = rng.random((nq, 2)) * 6.0 - 3.0
    q = q.astype(dtype)
    return q[:, 0], q[:, 1]


def _jax_qt_plan(data, *, gx=12, block_q=64, **kw):
    dx, dy, dz = data
    g = j_build_grid(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz), gx=gx, gy=gx)
    return j_build_plan(dx, dy, dz, params=JParams(**P), area=1.0, impl="grid", grid=g, phase2="quadtree",
                        block_q=block_q, **kw)


def _qt_plan(data, *, gx=12, block_q=64, phase2="quadtree", **kw):
    dx, dy, dz = (torch.as_tensor(a) for a in data)
    g = build_grid(dx, dy, dz, gx=gx, gy=gx)
    return build_plan(dx, dy, dz, params=AIDWParams(**P), area=1.0, impl="grid", grid=g, phase2=phase2,
                      block_q=block_q, device="cpu", **kw)


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


def _record(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [(type(w.message).__name__, str(w.message)) for w in rec
                 if type(w.message).__name__ == "UnprovableRtolWarning"]


def _assert_ulps(got, want, dtype, ulps, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = ulps * np.finfo(dtype).eps * np.maximum(np.abs(want), np.finfo(dtype).tiny)
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{what}: {int(bad.sum())} values off by more than {ulps} ulps"


def _assert_scaled(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), np.finfo(np.float64).tiny)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{what}: {err} > {rel} on the max|.| scale"


# -------------------------------------------------------------- aggregates
def _assert_levels_equal(jq, tq, dtype):
    assert len(tq) == len(jq)
    for jl, tl in zip(jq, tq):
        assert (tl.nx, tl.ny, tl.step) == (jl.nx, jl.ny, jl.step)
        for name in ("count", "z_sum"):
            np.testing.assert_array_equal(_np(getattr(tl, name)), np.asarray(getattr(jl, name)), err_msg=name)
        for name in ("cent_x", "cent_y", "mx", "my", "e", "zd"):
            assert _np(getattr(tl, name)).dtype == dtype, name
            _assert_ulps(_np(getattr(tl, name)), np.asarray(getattr(jl, name)), dtype, 2, name)
        for name in ("e_max", "zd_max"):
            _assert_ulps(getattr(tl, name), getattr(jl, name), dtype, 2, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gx", [3, 5, 12])
def test_quadtree_aggregates_equal_jax(gx, dtype):
    data = _tight_data(seed=40 + gx, dtype=dtype, gx=max(gx, 2), m=500, sigma=0.01)
    with _x64(dtype):
        jq = j_quadtree_aggregates(j_build_grid(*(jnp.asarray(a) for a in data), gx=gx, gy=gx))
    tg = build_grid(*(torch.as_tensor(a) for a in data), gx=gx, gy=gx)
    tq = quadtree_aggregates(tg)
    assert len(tq) == quadtree_level_count(gx, gx)
    _assert_levels_equal(jq, tq, dtype)
    _assert_levels_consistent(tg, tq)


def _assert_levels_consistent(g, qt):
    """The port's own invariants, as ``tests/engine/test_quadtree.py``
    checks the JAX levels: combining level l's 2x2 children with the exact
    reductions gives level l+1 bit for bit; e and zd bound the raw points."""
    for a, b in zip(qt, qt[1:]):
        def kids(arr, lv=a):
            x = np.pad(_np(arr).reshape(lv.ny, lv.nx), ((0, lv.ny % 2), (0, lv.nx % 2)))
            return [x[oy::2, ox::2] for oy, ox in ((0, 0), (0, 1), (1, 0), (1, 1))]

        cnt, zs, cx, cy, mx, my = (kids(getattr(a, f)) for f in ("count", "z_sum", "cent_x", "cent_y", "mx", "my"))
        tot = ((cnt[0] + cnt[1]) + cnt[2]) + cnt[3]
        np.testing.assert_array_equal(_np(b.count).reshape(b.ny, b.nx), tot)
        np.testing.assert_array_equal(_np(b.z_sum).reshape(b.ny, b.nx), ((zs[0] + zs[1]) + zs[2]) + zs[3])
        bx, by = _np(b.cent_x).reshape(b.ny, b.nx), _np(b.cent_y).reshape(b.ny, b.nx)
        denom = np.maximum(tot, np.asarray(1.0, tot.dtype))
        wx = ((cnt[0] * cx[0] + cnt[1] * cx[1]) + cnt[2] * cx[2]) + cnt[3] * cx[3]
        wy = ((cnt[0] * cy[0] + cnt[1] * cy[1]) + cnt[2] * cy[2]) + cnt[3] * cy[3]
        np.testing.assert_array_equal(np.where(tot > 0, wx / denom, bx), bx)
        np.testing.assert_array_equal(np.where(tot > 0, wy / denom, by), by)
        np.testing.assert_array_equal(_np(b.mx).reshape(b.ny, b.nx),
                                      sum(mx[i] + zs[i] * (cx[i] - bx) for i in range(4)))
        np.testing.assert_array_equal(_np(b.my).reshape(b.ny, b.nx),
                                      sum(my[i] + zs[i] * (cy[i] - by) for i in range(4)))
    counts = _np(g.counts).reshape(-1)
    cell_x, cell_y, cell_z = _np(g.cell_x), _np(g.cell_y), _np(g.cell_z)
    for level in qt:
        for c in np.nonzero(counts)[0]:
            k = int(counts[c])
            iy, ix = divmod(int(c), g.gx)
            nid = (iy // level.step) * level.nx + ix // level.step
            d = np.hypot(cell_x[c, :k].astype(np.float64) - float(level.cent_x[nid]),
                         cell_y[c, :k].astype(np.float64) - float(level.cent_y[nid]))
            assert (d <= float(level.e[nid]) + 1e-5).all()
            zbar = float(level.z_sum[nid]) / float(level.count[nid])
            assert (np.abs(cell_z[c, :k].astype(np.float64) - zbar) <= float(level.zd[nid]) + 1e-4).all()


# -------------------------------------------------------------- plan state
PLAN_CASES = {
    "auto": dict(data=lambda d: _tight_data(seed=10, dtype=d)),
    "radius": dict(data=lambda d: _tight_data(seed=10, dtype=d), farfield_radius=3),
    "min_p2": dict(data=lambda d: _tight_data(seed=10, dtype=d), farfield_radius=1, min_p2_capacity=3000),
    "unprovable": dict(data=lambda d: _uniform_data(dtype=d)),
}


def _assert_qt_state_equal(jp, tp, dtype):
    for f in ("m", "block_q", "block_d", "cand_capacity", "cand_block_d", "seam_level", "phase2", "farfield_rtol",
              "farfield_radius", "p2_capacity", "p2_block_d", "p2_far_block_d", "qt_levels"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("farfield_bound", "qt_tau"):
        want = getattr(jp, f)
        if np.isfinite(want):
            np.testing.assert_allclose(getattr(tp, f), want, rtol=1e-9, atol=0, err_msg=f)
        else:
            assert getattr(tp, f) == want, f
    assert len(tp.far) == len(jp.far)
    for jl, tl in zip(jp.far, tp.far):
        arrays = dict(zip(QT_ARRAYS, tl))
        for name, ja in zip(QT_ARRAYS, jl):
            ja = np.asarray(ja)
            assert _np(arrays[name]).dtype == ja.dtype, name
            if name == "count":
                np.testing.assert_array_equal(_np(arrays[name]), ja, err_msg=name)
            else:
                _assert_ulps(_np(arrays[name]), ja, dtype, 2, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_quadtree_plan_state_equal(case, dtype):
    spec = dict(PLAN_CASES[case])
    data = spec.pop("data")(dtype)
    with _x64(dtype):
        jp, jw = _record(lambda: _jax_qt_plan(data, **spec))
    tp, tw = _record(lambda: _qt_plan(data, **spec))
    _assert_qt_state_equal(jp, tp, dtype)
    assert tw == jw
    if case == "unprovable":
        assert tw and tp.farfield_bound > 1e-3
    else:
        assert not tw and tp.farfield_bound <= 1e-3


def test_quadtree_bound_model_equals_jax():
    """The bisection and the bound core are the JAX package's float math,
    copied: the same bits; the bound is monotone as the opening ratio
    shrinks and the bisection inverts it."""
    for rtol in (1e-2, 1e-3, 1e-4):
        for a in (2.0, 4.0):
            tau = t_plan._quadtree_tau_required(a, rtol)
            assert tau == j_plan._quadtree_tau_required(a, rtol)
        tau = t_plan._quadtree_tau_required(4.0, rtol)
        assert t_plan._bound_from_tau(tau, 4.0, dipole=True) <= rtol
        assert t_plan._bound_from_tau(tau * 1.1, 4.0, dipole=True) > rtol
    taus = np.linspace(0.3, 1e-4, 60)
    bounds = [t_plan._bound_from_tau(float(t), 4.0, dipole=True) for t in taus]
    assert all(b1 >= b2 for b1, b2 in zip(bounds, bounds[1:]))
    assert t_plan._bound_from_tau(0.0, 4.0, dipole=True) == 0.0
    assert t_plan._bound_from_tau(1.0, 4.0, dipole=True) == np.inf
    for t in (0.01, 0.05, 0.1):
        assert t_plan._bound_from_tau(t, 4.0, dipole=True) < t_plan._bound_from_tau(t, 4.0, g=0.5)


def _export_qt(jp):
    p = jp.params
    statics = dict(impl="grid", m=jp.m, area=jp.area, block_q=jp.block_q, block_d=jp.block_d,
                   cand_capacity=jp.cand_capacity, cand_block_d=jp.cand_block_d, seam_level=jp.seam_level,
                   pipeline=jp.pipeline, grid_rebuilds=jp.grid_rebuilds, phase2=jp.phase2,
                   farfield_rtol=jp.farfield_rtol, farfield_radius=jp.farfield_radius,
                   farfield_bound=jp.farfield_bound, p2_capacity=jp.p2_capacity, p2_block_d=jp.p2_block_d,
                   qt_tau=jp.qt_tau, qt_levels=jp.qt_levels,
                   params=dict(k=p.k, alpha_levels=tuple(p.alpha_levels), r_min=p.r_min, r_max=p.r_max,
                               area=p.area, exact_hit_eps=p.exact_hit_eps))
    arrays = {n: np.asarray(a) for n, a in zip(("dx", "dy", "dz"), jp.data)}
    for n in ("origin", "cell_size", "counts", "cum", "starts", "pt_x", "pt_y", "pt_z"):
        arrays[n] = np.asarray(getattr(jp.grid, n))
    arrays["r_need"] = np.asarray(jp.r_need)
    for lv, level in enumerate(jp.far):
        for n, a in zip(QT_ARRAYS, level):
            arrays[f"qt{lv}_{n}"] = np.asarray(a)
    return statics, arrays


def test_plan_from_reference_carries_the_quadtree():
    """A JAX quadtree plan carried across equals the port's own plan of the
    same data and executes like it, bit for bit."""
    data = _tight_data(seed=10)
    jp = _jax_qt_plan(data)
    carried = plan_from_reference(*_export_qt(jp), device="cpu")
    own = _qt_plan(data)
    for f in dataclasses.fields(own):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        if f.name == "data":
            assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True)), f.name
        elif f.name == "far":
            assert all(torch.equal(x, y) for la, lb in zip(a, b, strict=True)
                       for x, y in zip(la, lb, strict=True)), f.name
        elif f.name not in ("grid", "r_need"):
            assert a == b, f.name
    qx, qy = _queries("uniform", 150, seed=3)
    for x, y in zip(execute(carried, qx, qy), execute(own, qx, qy)):
        assert torch.equal(x, y)


# ------------------------------------------------------------------- the walk
def _walk_case(dtype, dist, data_kind):
    data = _tight_data(seed=10, dtype=dtype) if data_kind == "tight" else _uniform_data(dtype=dtype)
    with _x64(dtype):
        jp = _quiet(lambda: _jax_qt_plan(data))
    tp = _quiet(lambda: _qt_plan(data))
    qx, qy = _queries(dist, 220, seed=11, dtype=dtype)
    lay = _grid_layout(tp, torch.as_tensor(qx), torch.as_tensor(qy))
    home = block_rectangles(tp.grid, lay.cx_v, lay.cy_v, torch.zeros_like(lay.cx_v), tp.block_q)
    return jp, tp, lay, home


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dist", DISTRIBUTIONS)
@pytest.mark.parametrize("data_kind", ["tight", "uniform"])
def test_walk_tables_equal_jax(data_kind, dist, dtype, monkeypatch):
    """Each level's node table, closed, opened and processed counts equal
    the JAX walk's exactly, for the engine's home rectangles of a batch;
    walked in chunks of a few blocks, the tables are the same."""
    jp, tp, lay, home = _walk_case(dtype, dist, data_kind)
    with _x64(dtype):
        jhome = j_block_rectangles(jp.grid, *(jnp.asarray(_np(c), jnp.int32) for c in (lay.cx_v, lay.cy_v)),
                                   jnp.zeros(lay.cx_v.shape, jnp.int32), jp.block_q)
        want = [[np.asarray(a) for a in level] for level in j_execute_mod._quadtree_walk(jp, *jhome)]
    for h, jh in zip(home, jhome):
        np.testing.assert_array_equal(_np(h), np.asarray(jh))
    got = t_execute_mod._quadtree_walk(tp, *home)
    monkeypatch.setattr(t_execute_mod, "_WALK_PAIRS", 3 * tp.grid.n_cells)
    chunked = t_execute_mod._quadtree_walk(tp, *home)
    assert home[0].shape[0] > 3, "the chunked walk takes several chunks"
    for lv, (w, g, c) in enumerate(zip(want, got, chunked)):
        for name, a, b, d in zip(("tbl", "n_closed", "n_opened", "n_proc"), w, g, c):
            np.testing.assert_array_equal(_np(b), a, err_msg=f"level {lv} {name}")
            assert _np(b).dtype == np.int32, name
            assert torch.equal(b, d), f"level {lv} {name} chunked"
    closed = np.stack([w[1] for w in want])
    assert closed.sum() > 0
    if data_kind == "uniform" and dist != "out_of_bbox":
        assert closed[1:].sum() > 0, "coarse levels close nodes"


# --------------------------------------------------------- B6 plain vs Pallas
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dist", ["uniform", "out_of_bbox"])
def test_far_nodes_plain_matches_pallas(dist, dtype):
    """B6: the plain version against ``_far_node_kernel`` in interpret mode
    on each level's tables, the Pallas kernel fed the gathered node values;
    alpha drawn from a seed (the kernel takes any alpha)."""
    _, tp, lay, home = _walk_case(dtype, dist, "uniform")
    ah = torch.as_tensor(np.random.default_rng(21).uniform(0.25, 2.0, lay.qx_v.shape[0]).astype(dtype))
    levels = t_execute_mod._quadtree_walk(tp, *home)
    for lv, (tbl, n_closed, _, _) in enumerate(levels):
        k_pad, tile = tp.qt_levels[lv][3:]
        nt = ((n_closed.clamp(max=k_pad) + tile - 1) // tile).to(torch.int32)
        nodes = tp.far[lv][:6]
        got = phase2_far_nodes(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, block_q=tp.block_q, tile_d=tile)
        with _x64(dtype):
            ref = j_far_nodes(*(jnp.asarray(_np(t)) for t in (lay.qx_v, lay.qy_v)), jnp.asarray(_np(ah))[:, None],
                              *(jnp.asarray(_np(a[tbl.long()])) for a in nodes), jnp.asarray(_np(nt)),
                              block_q=tp.block_q, block_d=tile, interpret=True)
            ref = [np.asarray(r)[:, 0] for r in ref]
        _assert_scaled(_np(got[0]), ref[0], REL[dtype], f"level {lv} sum_w")
        _assert_scaled(_np(got[1]), ref[1], REL[dtype], f"level {lv} sum_wz")
        assert (_np(got[0]) > 0).any() == bool((n_closed > 0).any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_far_node_sentinel_slots_add_zero(dtype):
    """A pad slot points at the sentinel node (coordinate sentinel, zero
    count, z-sum and moments): walking more pad tiles, or a table of pads
    alone, leaves the sums' bits unchanged, with no inf * 0."""
    _, tp, lay, home = _walk_case(dtype, "uniform", "uniform")
    ah = torch.as_tensor(np.random.default_rng(22).uniform(0.25, 2.0, lay.qx_v.shape[0]).astype(dtype))
    tbl, n_closed, _, _ = t_execute_mod._quadtree_walk(tp, *home)[0]
    k_pad, tile = tp.qt_levels[0][3:]
    nodes = tp.far[0][:6]
    n_nodes = nodes[0].shape[0] - 1
    assert _np(nodes[0])[-1] > 1e30 and all(float(a[-1]) == 0.0 for a in nodes[2:])
    nt = ((n_closed + tile - 1) // tile).to(torch.int32)
    kw = dict(block_q=tp.block_q, tile_d=tile)
    base = phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, **kw)
    wider = torch.cat([tbl, torch.full_like(tbl, n_nodes)], dim=1)
    every = torch.full_like(nt, 2 * k_pad // tile)
    for a, b in zip(base, phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, wider, every, nodes, **kw)):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    pads = torch.full_like(tbl, n_nodes)
    for s in phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, pads, every[:1].expand_as(nt).contiguous(), nodes,
                                    **kw):
        assert torch.equal(s, torch.zeros_like(s))


def test_far_nodes_wrapper_takes_plain_path_on_cpu_only():
    _, tp, lay, home = _walk_case(np.float32, "uniform", "uniform")
    ah = torch.full_like(lay.qx_v, 1.0)
    tbl, n_closed, _, _ = t_execute_mod._quadtree_walk(tp, *home)[0]
    k_pad, tile = tp.qt_levels[0][3:]
    nt = ((n_closed + tile - 1) // tile).to(torch.int32)
    args = (lay.qx_v, lay.qy_v, ah, tbl, nt, tp.far[0][:6])
    before = dict(_build.LAUNCHES)
    for a, b in zip(phase2_far_nodes(*args, block_q=tp.block_q, tile_d=tile),
                    phase2_far_nodes_plain(*args, block_q=tp.block_q, tile_d=tile)):
        assert torch.equal(a, b)
    assert _build.LAUNCHES == before and "far_node" in before
    with pytest.raises(ValueError, match="no kernel for device"):
        phase2_far_nodes(*(t.to("meta") for t in args[:5]), tuple(a.to("meta") for a in args[5]),
                         block_q=tp.block_q, tile_d=tile)
    with pytest.raises(ValueError, match="bad shapes"):
        phase2_far_nodes(*args, block_q=tp.block_q, tile_d=tile // 2 + 1)
    with pytest.raises(ValueError, match="bad shapes"):
        phase2_far_nodes(*args[:5], args[5][:5], block_q=tp.block_q, tile_d=tile)


# ------------------------------------------------------------------ the slice
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dist", DISTRIBUTIONS)
def test_slice_matches_jax_execute(dist, dtype):
    """``execute_with_stats`` on a quadtree plan: z within 1e-5 / 1e-12 of
    the JAX execute on the max|z| scale, the stats within 1e-6 of JAX's,
    alpha the port's exact plan's bit for bit (the plans share Phase 1)."""
    data = _tight_data(seed=10, dtype=dtype)
    qx, qy = _queries(dist, 220 if dtype == np.float32 else 150, seed=11, dtype=dtype)
    with _x64(dtype):
        jp = _jax_qt_plan(data)
        jz, _, js = j_execute_with_stats(jp, jnp.asarray(qx), jnp.asarray(qy))
        jz, js = np.asarray(jz), {k: np.asarray(v) for k, v in js.items()}
    plan = _qt_plan(data)
    z, a, stats = execute_with_stats(plan, qx, qy)
    assert z.dtype == a.dtype == plan.dtype and z.shape == (qx.shape[0],)
    _assert_scaled(_np(z), jz, REL[dtype], "z")
    _, a_exact = execute(_qt_plan(data, phase2="exact"), qx, qy)
    np.testing.assert_array_equal(_np(a), _np(a_exact))
    assert set(js) <= set(stats) and "farfield_rtol_bound" not in stats
    for key in ("cells_per_level", "opened_fraction", "far_cells_mean", "near_points_mean",
                "p2_overflow_queries", "quadtree_rtol_bound", "overflow_queries", "cand_need_max"):
        got, want = _np(stats[key]), js[key]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-6, atol=0,
                                   err_msg=key)
    assert stats["cells_per_level"].shape == (len(plan.qt_levels),)
    assert float(stats["cells_per_level"].sum()) == float(stats["far_cells_mean"])
    assert 0.0 <= float(stats["opened_fraction"]) <= 1.0
    assert float(stats["quadtree_rtol_bound"]) == np.asarray(plan.farfield_bound, dtype)


def test_golden_quadtree_pin():
    """The committed ``qtree_*`` batch at ``tests/test_golden.py``'s rules:
    the plan's bound equals the committed one within 1e-9, z within that
    bound plus the fp slack of the committed Kahan reference, alpha within
    RTOL 5e-4 / ATOL 5e-5."""
    with np.load(FIXTURE) as blob:
        g = {k: blob[k] for k in blob.files}
    dx, dy, dz, qx, qy = (g[f"qtree_{n}"] for n in ("dx", "dy", "dz", "qx", "qy"))
    gx = int(g["qtree_gx"])
    grid = build_grid(*(torch.as_tensor(a) for a in (dx, dy, dz)), gx=gx, gy=gx)
    plan = build_plan(dx, dy, dz, params=AIDWParams(k=int(g["k"]), area=float(g["area"])), area=float(g["area"]),
                      impl="grid", grid=grid, phase2="quadtree", block_q=64, device="cpu")
    bound = float(g["qtree_bound"])
    assert bound <= 1e-3
    np.testing.assert_allclose(plan.farfield_bound, bound, rtol=1e-9)
    z, a = execute(plan, qx, qy)
    scale = float(np.max(np.abs(dz)))
    fp_slack = accuracy.FP_SLACK_ULPS * float(np.finfo(np.float32).eps) * float(np.sqrt(dx.shape[0]))
    rel = float(np.max(np.abs(_np(z).astype(np.float64) - g["qtree_z"].astype(np.float64)))) / scale
    assert rel <= bound + fp_slack, (rel, bound, fp_slack)
    np.testing.assert_allclose(_np(a), g["qtree_alpha"], rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dist", DISTRIBUTIONS)
def test_measured_error_within_proved_bound(dist, dtype):
    """The port's ``farfield_error_report`` against its Kahan oracle: within
    the plan's proved bound (at most 1e-3 on this provable configuration,
    with no warning) plus the fp slack, in float32 and float64."""
    data = _tight_data(seed=10 if dtype == np.float32 else 12, dtype=dtype)
    qx, qy = _queries(dist, 220 if dtype == np.float32 else 150, seed=11 if dtype == np.float32 else 13,
                      dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan = _qt_plan(data)
    assert plan.farfield_bound <= 1e-3
    rep = accuracy.farfield_error_report(plan, qx, qy)
    assert rep["phase2"] == "quadtree" and rep["bound"] == plan.farfield_bound
    assert rep["n_queries"] == qx.shape[0] and rep["max_rel_err"] > 0.0
    assert rep["within_bound"], rep
    if dtype == np.float64:
        assert rep["max_rel_err"] <= plan.farfield_bound + 1e-12


def test_quadtree_proves_where_single_level_cannot():
    """z varying inside tight clusters costs the single-level model a
    first-order term that blocks 1e-3 at the quadtree's radius; the dipole
    model proves it, and the measured error honours it."""
    data = _tight_data(seed=20, z_noise=0.5)
    plan_q = _qt_plan(data)
    plan_f = _quiet(lambda: _qt_plan(data, phase2="farfield", farfield_radius=plan_q.farfield_radius))
    assert plan_q.farfield_bound <= 1e-3 < plan_f.farfield_bound
    qx, qy = _queries("uniform", 200, seed=21)
    assert accuracy.farfield_error_report(plan_q, qx, qy)["within_bound"]


def test_unprovable_config_warns_with_the_port_type():
    data = _uniform_data()
    with pytest.warns(UnprovableRtolWarning, match="quadtree model"):
        plan = _qt_plan(data)
    assert plan.farfield_bound > 1e-3
    qx, qy = _queries("uniform", 200, seed=31)
    assert accuracy.farfield_error_report(plan, qx, qy)["within_bound"]


# --------------------------------------------------------------- overflow arm
def test_overflow_falls_back_to_exact_bitwise():
    """An out-of-bbox batch overflowing the near capacity (the shape of
    ``tests/engine/test_quadtree.py``) takes the masked exact sweep: z and
    alpha are the exact plan's, bit for bit."""
    rng = np.random.default_rng(14)
    dx, dy = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    dz = _field(dx, dy)
    p = AIDWParams(k=10, area=1.0, r_max=64.0)
    qx = (rng.random(96) * 6 - 3).astype(np.float32)
    qy = (rng.random(96) * 6 - 3).astype(np.float32)
    kw = dict(params=p, area=1.0, impl="grid", query_occupancy=64.0, device="cpu")
    plan_qt = _quiet(lambda: build_plan(dx, dy, dz, phase2="quadtree", farfield_radius=1, **kw))
    plan_ex = build_plan(dx, dy, dz, **kw)
    assert plan_qt.p2_capacity < plan_qt.m
    z_qt, a_qt, stats = execute_with_stats(plan_qt, qx, qy)
    z_ex, a_ex = execute(plan_ex, qx, qy)
    assert int(stats["p2_overflow_queries"]) == 96
    np.testing.assert_array_equal(_np(z_qt), _np(z_ex))
    np.testing.assert_array_equal(_np(a_qt), _np(a_ex))


def test_node_table_overflow_takes_the_exact_arm():
    """A level table narrower than a block's closed nodes flags the block:
    its queries get the exact plan's z, bit for bit, and the other queries
    keep the quadtree's."""
    data = _uniform_data(m=4000)
    plan = _quiet(lambda: _qt_plan(data, gx=24))
    qx, qy = _queries("uniform", 200, seed=32)
    levels = list(plan.qt_levels)
    levels[0] = (*levels[0][:3], 32, 32)  # level 0 closes 13-48 nodes per block
    narrow = dataclasses.replace(plan, qt_levels=tuple(levels))
    z, a, stats = execute_with_stats(narrow, qx, qy)
    z_qt, a_qt, stats_qt = execute_with_stats(plan, qx, qy)
    z_ex, _ = execute(_qt_plan(data, gx=24, phase2="exact"), qx, qy)
    n_more = int(stats["p2_overflow_queries"]) - int(stats_qt["p2_overflow_queries"])
    assert n_more > 0 and torch.equal(a, a_qt)
    moved = z != z_qt
    assert 0 < int(moved.sum()) <= n_more and torch.equal(z[moved], z_ex[moved])
    assert int((z == z_ex).sum()) >= int(stats["p2_overflow_queries"])


# ---------------------------------------------------------------- validations
def test_quadtree_validations():
    dx, dy, dz = _tight_data(seed=7, m=256)
    kw = dict(params=AIDWParams(**P), area=1.0, device="cpu")
    with pytest.raises(ValueError, match="phase2"):
        build_plan(dx, dy, dz, impl="grid", phase2="bh", **kw)
    with pytest.raises(ValueError, match="quadtree"):
        build_plan(dx, dy, dz, impl="tiled", phase2="quadtree", **kw)
    with pytest.raises(ValueError, match="farfield_radius"):
        build_plan(dx, dy, dz, impl="grid", phase2="quadtree", farfield_radius=0, **kw)
    plan = build_plan(dx, dy, dz, impl="grid", **kw)
    assert plan.qt_levels == () and plan.qt_tau == 0.0
    ff = _quiet(lambda: build_plan(dx, dy, dz, impl="grid", phase2="farfield", **kw))
    assert ff.qt_levels == () and ff.qt_tau == 0.0
