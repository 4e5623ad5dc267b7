"""The port's far-field Phase 2 (``phase2="farfield"``) against the JAX
package's, on the CPU, at the shapes of ``tests/engine/test_farfield.py``
(4,000 clustered points or fewer, ``block_q=64``).

* plan state: the cell aggregates and the far-field plan equal the JAX
  plan's (radius, capacities, tiles, the far ``ix/iy/count`` arrays
  exactly; ``farfield_bound``, ``e_max`` and the centroids within 1e-6
  relative in float32, 1e-12 in float64), with the same warnings;
* B4 (``_near_weight_kernel``) and B5 (``_far_cell_kernel``): the plain
  versions against the Pallas kernels in interpret mode, sums within 1e-5 /
  1e-12 relative, the minimum and its z exactly;
* the slice: ``execute`` against the JAX ``execute`` on four query
  distributions, z within 1e-5 / 1e-12 of ``max|z|``, alpha bitwise the
  port's own exact plan's; the golden ``ffpin_*`` pin at
  ``tests/test_golden.py``'s tolerances; the measured error within the
  proved bound in float32 and float64; the overflow arm bitwise the exact
  plan's; the validations.

The float64 JAX references are made under ``jax.enable_x64(True)``.  The
CUDA kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``.
"""

import dataclasses
import importlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accuracy as j_accuracy
from repro.core.aidw import AIDWParams as JParams
from repro.core.grid import build_grid as j_build_grid
from repro.core.grid import cell_aggregates as j_cell_aggregates
from repro.engine import build_plan as j_build_plan
from repro.engine import execute as j_execute
from repro.engine import execute_with_stats as j_execute_with_stats
from repro.engine import plan as j_plan
from repro.kernels.aidw_grid import block_rectangles as j_block_rectangles
from repro.kernels.aidw_grid import gather_candidates_csr as j_gather
from repro.kernels.aidw_grid import phase2_far_aggregates as j_far
from repro.kernels.aidw_grid import phase2_near_weights as j_near
from repro_torch.core import accuracy
from repro_torch.core.aidw import AIDWParams
from repro_torch.core.grid import build_grid, cell_aggregates
from repro_torch.engine import build_plan, execute, execute_with_stats, plan_from_reference
from repro_torch.engine import plan as t_plan
from repro_torch.engine.execute import _grid_layout, _near_field, _tile_table
from repro_torch.engine.plan import FAR_ARRAYS
from repro_torch.errors import UnprovableRtolWarning
from repro_torch.kernels import _build
from repro_torch.kernels._common import SUM_RUN, run_sum
from repro_torch.kernels.aidw_grid import (
    phase2_far_aggregates,
    phase2_far_aggregates_plain,
    phase2_near_weights,
    phase2_near_weights_plain,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "aidw_golden.npz")
DTYPES = [np.float32, np.float64]
REL = {np.float32: 1e-5, np.float64: 1e-12}        # sums and z
STATE_REL = {np.float32: 1e-6, np.float64: 1e-12}  # bound, e_max, centroids
DISTRIBUTIONS = ("uniform", "clustered", "seam", "out_of_bbox")
P = dict(k=10, area=1.0)
t_execute_mod = importlib.import_module("repro_torch.engine.execute")


def _np(t):
    return t.detach().cpu().numpy()


def _x64(dtype):
    return jax.enable_x64(dtype == np.float64)


def _field(x, y):
    return (np.sin(6 * x) * np.cos(6 * y) + 2.0).astype(x.dtype)


def _cluster_data(seed, dtype=np.float32, gx=12, m=4000, sigma=0.003):
    """Tight clusters at the centres of a coarse grid's cells: the model
    proves a finite bound at small radii (tests/engine/test_farfield.py)."""
    rng = np.random.default_rng(seed)
    centers = (np.stack(np.meshgrid(np.arange(gx), np.arange(gx)), -1).reshape(-1, 2) + 0.5) / gx
    pts = centers[rng.integers(0, gx * gx, m)] + rng.normal(0, sigma, (m, 2))
    pts = np.clip(pts, 0.0, 1.0).astype(dtype)
    return pts[:, 0], pts[:, 1], _field(pts[:, 0], pts[:, 1])


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


def _jax_ff_plan(data, *, radius=None, gx=12, block_q=64, **kw):
    """The JAX far-field plan on a user ``gx x gx`` grid (``gx=None``: auto)."""
    dx, dy, dz = data
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="grid resolution")
        g = None if gx is None else j_build_grid(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz), gx=gx, gy=gx)
        return j_build_plan(dx, dy, dz, params=JParams(**P), area=1.0, impl="grid", grid=g,
                            phase2="farfield", farfield_radius=radius, block_q=block_q, **kw)


def _ff_plan(data, *, radius=None, gx=12, block_q=64, phase2="farfield", **kw):
    """The port's plan of the same configuration."""
    dx, dy, dz = (torch.as_tensor(a) for a in data)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="grid resolution")
        g = None if gx is None else build_grid(dx, dy, dz, gx=gx, gy=gx)
        extra = dict(farfield_radius=radius) if phase2 == "farfield" else {}
        return build_plan(dx, dy, dz, params=AIDWParams(**P), area=1.0, impl="grid", grid=g, phase2=phase2,
                          block_q=block_q, device="cpu", **extra, **kw)


def _assert_rel(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), np.finfo(np.float64).tiny)
    err = np.max(np.abs(got - want) / scale) if want.size else 0.0
    assert err <= rel, f"{what}: relative error {err} > {rel}"


def _assert_ff_state_equal(jp, tp, dtype):
    for f in ("m", "block_q", "block_d", "cand_capacity", "cand_block_d", "seam_level", "phase2",
              "farfield_radius", "p2_capacity", "p2_block_d", "p2_far_block_d"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.farfield_rtol == jp.farfield_rtol
    if np.isfinite(jp.farfield_bound):
        _assert_rel(tp.farfield_bound, jp.farfield_bound, STATE_REL[dtype], "farfield_bound")
    else:
        assert tp.farfield_bound == jp.farfield_bound
    far = dict(zip(FAR_ARRAYS, tp.far))
    jfar = dict(zip(FAR_ARRAYS, (np.asarray(a).reshape(-1) for a in jp.far)))
    for name in ("ix", "iy", "count"):
        np.testing.assert_array_equal(_np(far[name]), jfar[name], err_msg=name)
        assert _np(far[name]).dtype == jfar[name].dtype, name
    for name in ("cent_x", "cent_y", "z_sum"):
        _assert_rel(_np(far[name]), jfar[name], STATE_REL[dtype], name)


# ------------------------------------------------------------------ plan state
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gx", [6, 12, None])
def test_cell_aggregates_equal_jax(gx, dtype):
    """Counts and cell coordinates exactly; centroids, z-sums and the error
    model's maxima within 1e-6 / 1e-12 relative (they come out bitwise)."""
    data = _cluster_data(seed=17, dtype=dtype, m=2000 if gx else 4000, gx=gx or 12)
    with _x64(dtype):
        jg = j_build_grid(*(jnp.asarray(a) for a in data), gx=gx, gy=gx)
        ja = j_cell_aggregates(jg)
        ja = [np.asarray(v) for v in ja[:6]] + list(ja[6:])
    ta = cell_aggregates(build_grid(*(torch.as_tensor(a) for a in data), gx=gx, gy=gx))
    for i, name in enumerate(("cent_x", "cent_y", "count", "z_sum", "ix", "iy")):
        got = _np(ta[i])
        assert got.dtype == ja[i].dtype, name
        if name in ("count", "ix", "iy"):
            np.testing.assert_array_equal(got, ja[i], err_msg=name)
        else:
            _assert_rel(got, ja[i], STATE_REL[dtype], name)
    for i, name in ((6, "e_max"), (7, "z_dev_max"), (8, "z_abs_max")):
        _assert_rel(ta[i], ja[i], STATE_REL[dtype], name)


def _record(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [(type(w.message).__name__, str(w.message)) for w in rec
                 if type(w.message).__name__ == "UnprovableRtolWarning"]


PLAN_CASES = {
    # tight clusters on a 12x12 user grid, radius given or chosen by the model
    "radius2": dict(data=lambda d: _cluster_data(seed=10, dtype=d), radius=2),
    "radius3": dict(data=lambda d: _cluster_data(seed=10, dtype=d), radius=3),
    "auto_rtol": dict(data=lambda d: _cluster_data(seed=10, dtype=d), farfield_rtol=0.3),
    # uniform data on the auto grid, rtol unprovable: the model warns
    "unprovable": dict(data=lambda d: tuple(np.random.default_rng(5).random((2, 4096)).astype(d)),
                       gx=None, farfield_rtol=1e-6, block_q=256),
    # the near capacity floored by the caller
    "min_p2": dict(data=lambda d: _cluster_data(seed=10, dtype=d), radius=1, min_p2_capacity=3000),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_farfield_plan_state_equal(case, dtype):
    spec = dict(PLAN_CASES[case])
    data = spec.pop("data")(dtype)
    if len(data) == 2:
        data = (*data, _field(*data))
    with _x64(dtype):
        jp, jw = _record(lambda: _jax_ff_plan(data, **spec))
    tp, tw = _record(lambda: _ff_plan(data, **spec))
    _assert_ff_state_equal(jp, tp, dtype)
    assert tw == jw
    if case == "unprovable":
        assert tw and tw[0][0] == "UnprovableRtolWarning" and tp.farfield_bound > 1e-6


def test_unprovable_rtol_warns_with_the_port_type():
    rng = np.random.default_rng(5)
    dx, dy = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    with pytest.warns(UnprovableRtolWarning):
        plan = build_plan(dx, dy, _field(dx, dy), params=AIDWParams(**P), impl="grid", phase2="farfield",
                          farfield_rtol=1e-6, device="cpu")
    assert plan.farfield_radius >= 1 and plan.phase2 == "farfield"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan2 = _ff_plan(_cluster_data(seed=6), radius=3)
    assert np.isfinite(plan2.farfield_bound)


def test_bound_model_equals_jax():
    """The bound model is the JAX package's float math, copied: equal bits."""
    for args in ((3, 0.1, 4.0, 0.0, 0.5, 1.0), (1, 0.1, 4.0, 0.005, 0.1, 1.0), (4, 0.1, 4.0, 0.005, 0.5, 1.0),
                 (8, 0.05, 4.0, 0.01, 0.0, 2.0), (1, 0.1, 4.0, 0.2, 0.1, 1.0), (0, 0.1, 4.0, 0.01, 0.1, 1.0)):
        assert t_plan._farfield_bound_model(*args) == j_plan._farfield_bound_model(*args)
    for tau in (0.0, 0.01, 0.1, 0.3, 0.9, 1.0):
        for dipole in (False, True):
            assert (t_plan._bound_from_tau(tau, 4.0, 0.3, dipole=dipole)
                    == j_plan._bound_from_tau(tau, 4.0, 0.3, dipole=dipole))
    assert (t_plan._FALLBACK_BOUND_CEIL, t_plan._P2_TILE_ELEMS) == (j_plan._FALLBACK_BOUND_CEIL,
                                                                     j_plan._P2_TILE_ELEMS)


def _export_ff(jp):
    p = jp.params
    statics = dict(impl="grid", m=jp.m, area=jp.area, block_q=jp.block_q, block_d=jp.block_d,
                   cand_capacity=jp.cand_capacity, cand_block_d=jp.cand_block_d, seam_level=jp.seam_level,
                   pipeline=jp.pipeline, grid_rebuilds=jp.grid_rebuilds, phase2=jp.phase2,
                   farfield_rtol=jp.farfield_rtol, farfield_radius=jp.farfield_radius,
                   farfield_bound=jp.farfield_bound, p2_capacity=jp.p2_capacity, p2_block_d=jp.p2_block_d,
                   p2_far_block_d=jp.p2_far_block_d,
                   params=dict(k=p.k, alpha_levels=tuple(p.alpha_levels), r_min=p.r_min, r_max=p.r_max,
                               area=p.area, exact_hit_eps=p.exact_hit_eps))
    arrays = {n: np.asarray(a) for n, a in zip(("dx", "dy", "dz"), jp.data)}
    for n in ("origin", "cell_size", "counts", "cum", "starts", "pt_x", "pt_y", "pt_z"):
        arrays[n] = np.asarray(getattr(jp.grid, n))
    arrays["r_need"] = np.asarray(jp.r_need)
    for n, a in zip(FAR_ARRAYS, jp.far):
        arrays[f"far_{n}"] = np.asarray(a)
    return statics, arrays


def test_plan_from_reference_carries_the_far_field():
    """A JAX far-field plan carried across equals the port's own plan of the
    same data and executes like the JAX plan."""
    data = _cluster_data(seed=10)
    jp = _jax_ff_plan(data, radius=2)
    carried = plan_from_reference(*_export_ff(jp), device="cpu")
    own = _ff_plan(data, radius=2)
    for f in dataclasses.fields(own):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        if f.name in ("data", "far"):
            assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True)), f.name
        elif f.name not in ("grid", "r_need"):
            assert a == b, f.name
    qx, qy = _queries("uniform", 150, seed=3)
    jz, ja = j_execute(jp, jnp.asarray(qx), jnp.asarray(qy))
    z, a = execute(carried, qx, qy)
    np.testing.assert_array_equal(_np(a), _np(execute(own, qx, qy)[1]))
    assert np.max(np.abs(_np(z) - np.asarray(jz))) / np.abs(data[2]).max() <= REL[np.float32]


# --------------------------------------------------------- B4 / B5 plain vs Pallas
def _kernel_inputs(dtype, radius=2, dist="uniform", seed=21, gx=12):
    """The near and far kernels' inputs as the engine makes them: the port's
    blocked view of a batch, its near rectangles, the with-z gather and the
    tile table; alpha drawn from a seed (the kernels take any alpha)."""
    plan = _ff_plan(_cluster_data(seed=10, dtype=dtype), radius=radius, gx=gx)
    qx, qy = _queries(dist, 200, seed=seed, dtype=dtype)
    lay = _grid_layout(plan, torch.as_tensor(qx), torch.as_tensor(qy))
    near = _near_field(plan, lay.cx_v, lay.cy_v)
    ah = torch.as_tensor(np.random.default_rng(seed).uniform(0.25, 2.0, lay.qx_v.shape[0]).astype(dtype))
    return plan, lay, near, ah


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_with_z_equals_jax(dtype):
    plan, lay, near, _ = _kernel_inputs(dtype, dist="seam")
    with _x64(dtype):
        jp = _jax_ff_plan(_cluster_data(seed=10, dtype=dtype), radius=2)
        jrects = j_block_rectangles(jp.grid, jnp.asarray(_np(lay.cx_v), jnp.int32),
                                    jnp.asarray(_np(lay.cy_v), jnp.int32),
                                    jnp.full(lay.cx_v.shape, 2, jnp.int32), plan.block_q)
        ref = j_gather(jp.grid, *jrects, plan.p2_capacity, with_z=True)
    np.testing.assert_array_equal(_np(near.rects), np.stack([np.asarray(b) for b in jrects], axis=1))
    for a, b, name in zip((near.cand_x, near.cand_y, near.cand_z, near.need), ref, ("x", "y", "z", "need")):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
    assert (_np(near.cand_z)[_np(near.cand_x) > 1e30] == 0).all(), "sentinel slots carry z = 0"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_d", [None, 512])
def test_near_weights_plain_matches_pallas(dtype, tile_d):
    """B4: the plain version against ``_near_weight_kernel`` in interpret
    mode, on rows that walk fewer tiles than the row holds (``tile_d=512``)."""
    plan, lay, near, ah = _kernel_inputs(dtype)
    cx, cy, cz = near.cand_x, near.cand_y, near.cand_z
    tile_d = tile_d or plan.p2_block_d
    nt = _tile_table(near.need, plan.p2_capacity, tile_d)
    if tile_d == 512:
        assert (_np(nt) < plan.p2_capacity // 512).any() and (_np(nt) > 1).any()
    got = phase2_near_weights(lay.qx_v, lay.qy_v, ah, cx, cy, cz, nt, block_q=plan.block_q, tile_d=tile_d)
    with _x64(dtype):
        ref = j_near(*(jnp.asarray(_np(t)) for t in (lay.qx_v, lay.qy_v)), jnp.asarray(_np(ah))[:, None],
                     *(jnp.asarray(_np(t)) for t in (cx, cy, cz, nt)), block_q=plan.block_q, block_d=tile_d,
                     interpret=True)
        ref = [np.asarray(r)[:, 0] for r in ref]
    _assert_rel(_np(got[0]), ref[0], REL[dtype], "sum_w")
    _assert_rel(_np(got[1]), ref[1], REL[dtype], "sum_wz")
    # XLA's CPU backend contracts dx*dx + dy*dy into an FMA, where the port
    # (and its CUDA kernels) round each product: min d^2 differs by at most
    # one rounding, about an ulp; the point it picks, and its z, are the same
    _assert_rel(_np(got[2]), ref[2], 2 * np.finfo(dtype).eps, "min_d2")
    np.testing.assert_array_equal(_np(got[3]), ref[3], err_msg="hit_z")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dist", ["uniform", "out_of_bbox"])
def test_far_aggregates_plain_matches_pallas(dtype, dist):
    """B5: the plain version against ``_far_cell_kernel`` in interpret mode."""
    plan, lay, near, ah = _kernel_inputs(dtype, dist=dist)
    rects_t = near.rects
    got = phase2_far_aggregates(lay.qx_v, lay.qy_v, ah, rects_t, plan.far, block_q=plan.block_q,
                                tile_d=plan.p2_far_block_d)
    with _x64(dtype):
        far = tuple(jnp.asarray(_np(a))[None, :] for a in plan.far)
        ref = j_far(*(jnp.asarray(_np(t)) for t in (lay.qx_v, lay.qy_v)), jnp.asarray(_np(ah))[:, None],
                    jnp.asarray(_np(rects_t)), far, block_q=plan.block_q, block_d=plan.p2_far_block_d,
                    interpret=True)
        ref = [np.asarray(r)[:, 0] for r in ref]
    _assert_rel(_np(got[0]), ref[0], REL[dtype], "sum_w")
    _assert_rel(_np(got[1]), ref[1], REL[dtype], "sum_wz")
    assert (_np(got[0]) > 0).any(), "the far field is engaged"


def test_far_pad_and_empty_cells_add_zero():
    """Pad cells (sentinel centroid, count 0) and empty cells (count 0) add
    exactly 0: dropping them leaves the sums' bits unchanged."""
    plan, lay, near, ah = _kernel_inputs(np.float32, gx=36)
    rects_t = near.rects
    far = plan.far
    n_cells = plan.grid.n_cells
    assert (_np(far[2])[:n_cells] == 0).sum() > n_cells // 2, "empty cells"
    assert far[0].shape[0] > n_cells and _np(far[4])[-1] == -1, "pad cells"
    kw = dict(block_q=plan.block_q, tile_d=plan.p2_far_block_d)
    base = phase2_far_aggregates_plain(lay.qx_v, lay.qy_v, ah, rects_t, far, **kw)
    for s in base:
        assert torch.isfinite(s).all()
    keep = far[2] > 0
    # move the empty and pad cells to one far-away corner with weight 0 ...
    moved = list(far)
    moved[0] = torch.where(keep, far[0], torch.finfo(torch.float32).max / 4)
    moved[1] = torch.where(keep, far[1], torch.finfo(torch.float32).max / 4)
    again = phase2_far_aggregates_plain(lay.qx_v, lay.qy_v, ah, rects_t, tuple(moved), **kw)
    for a, b in zip(base, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_run_sum_takes_the_kernels_order(dtype):
    """``run_sum``, the order in which ``near.cu`` and ``far.cu`` sum a tile,
    bit for bit: each run of ``SUM_RUN`` terms left to right from 0, then the
    run sums left to right.  Both wrappers refuse a tile width that is not a
    multiple of ``SUM_RUN``."""
    rng = np.random.default_rng(5)
    t = (rng.random((3, 4 * SUM_RUN)) * 10.0 ** rng.integers(-6, 7, (3, 4 * SUM_RUN))).astype(dtype)
    want = np.zeros(3, dtype)
    for r in range(3):
        total = dtype(0)
        for j0 in range(0, t.shape[1], SUM_RUN):
            run = dtype(0)
            for v in t[r, j0:j0 + SUM_RUN]:
                run = dtype(run + v)
            total = dtype(total + run)
        want[r] = total
    np.testing.assert_array_equal(_np(run_sum(torch.as_tensor(t)))[:, 0], want)

    plan, lay, near, ah = _kernel_inputs(dtype)
    with pytest.raises(ValueError, match="bad shapes"):
        phase2_near_weights(lay.qx_v, lay.qy_v, ah, near.cand_x, near.cand_y, near.cand_z, near.num_tiles,
                            block_q=plan.block_q, tile_d=SUM_RUN // 2)
    with pytest.raises(ValueError, match="bad shapes"):
        phase2_far_aggregates(lay.qx_v, lay.qy_v, ah, near.rects, plan.far, block_q=plan.block_q,
                              tile_d=SUM_RUN // 2)


def test_kernel_wrappers_take_plain_path_on_cpu_only():
    """On CPU tensors the wrappers are their plain versions and launch
    nothing; any other device but CUDA, or a mix, is refused."""
    plan, lay, near, ah = _kernel_inputs(np.float32)
    args = (lay.qx_v, lay.qy_v, ah, near.cand_x, near.cand_y, near.cand_z, near.num_tiles)
    far_args = (lay.qx_v, lay.qy_v, ah, near.rects, plan.far)
    before = dict(_build.LAUNCHES)
    nk = dict(block_q=plan.block_q, tile_d=plan.p2_block_d)
    fk = dict(block_q=plan.block_q, tile_d=plan.p2_far_block_d)
    for a, b in zip(phase2_near_weights(*args, **nk), phase2_near_weights_plain(*args, **nk)):
        assert torch.equal(a, b)
    for a, b in zip(phase2_far_aggregates(*far_args, **fk), phase2_far_aggregates_plain(*far_args, **fk)):
        assert torch.equal(a, b)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device"):
        phase2_near_weights(*(t.to("meta") for t in args), block_q=plan.block_q, tile_d=plan.p2_block_d)
    with pytest.raises(ValueError, match="bad shapes"):
        phase2_near_weights(*args, block_q=plan.block_q, tile_d=999)
    with pytest.raises(ValueError, match="several devices"):
        phase2_far_aggregates(lay.qx_v.to("meta"), lay.qy_v, ah, near.rects, plan.far, block_q=plan.block_q,
                              tile_d=plan.p2_far_block_d)


# ------------------------------------------------------------------ the slice
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dist", DISTRIBUTIONS)
def test_slice_matches_jax_execute(dist, dtype):
    """``execute`` on a far-field plan: z within 1e-5 / 1e-12 of the JAX
    execute on the max|z| scale; alpha is the port's exact plan's, bit for
    bit (both plans share Phase 1); the far-field stats equal the JAX ones."""
    data = _cluster_data(seed=10, dtype=dtype)
    qx, qy = _queries(dist, 220 if dtype == np.float32 else 150, seed=11, dtype=dtype)
    with _x64(dtype):
        jp = _jax_ff_plan(data, radius=2)
        jz, ja, js = j_execute_with_stats(jp, jnp.asarray(qx), jnp.asarray(qy))
        jz, js = np.asarray(jz), {k: np.asarray(v) for k, v in js.items()}
    plan = _ff_plan(data, radius=2)
    z, a, stats = execute_with_stats(plan, qx, qy)
    assert z.dtype == a.dtype == plan.dtype and z.shape == (qx.shape[0],)
    err = np.max(np.abs(_np(z).astype(np.float64) - jz)) / np.abs(data[2]).max()
    assert err <= REL[dtype], err
    _, a_exact = execute(_ff_plan(data, phase2="exact"), qx, qy)
    np.testing.assert_array_equal(_np(a), _np(a_exact))
    for key in ("p2_overflow_queries", "overflow_queries", "cand_need_max", "farfield_rtol_bound"):
        np.testing.assert_array_equal(_np(stats[key]), js[key], err_msg=key)
    # float32 means of integer counts: XLA may divide by multiplying with the
    # reciprocal, one rounding more than the port's division
    for key in ("near_points_mean", "far_cells_mean"):
        _assert_rel(_np(stats[key]), js[key], 2 * np.finfo(np.float32).eps, key)
    assert set(js) <= set(stats)


@pytest.mark.parametrize("pipeline", ["prefetch", "dense"])
def test_pipelines_bitwise_equal_and_deterministic(pipeline):
    """The near tile table walks only tiles that hold candidates, so the
    dense walk gives the same bits; a second run gives them again."""
    data = _cluster_data(seed=10)
    qx, qy = _queries("seam", 220, seed=12)
    z0, a0 = execute(_ff_plan(data, radius=2, block_q=64, pipeline="prefetch"), qx, qy)
    z1, a1 = execute(_ff_plan(data, radius=2, block_q=64, pipeline=pipeline), qx, qy)
    assert torch.equal(z0, z1) and torch.equal(a0, a1)


def test_golden_farfield_pin():
    """The committed ``ffpin_*`` output at ``tests/test_golden.py``'s
    tolerances (alpha 1e-6 absolute, z 2e-6 relative and absolute)."""
    with np.load(FIXTURE) as blob:
        g = {k: blob[k] for k in blob.files}
    dx, dy, dz, qx, qy = (g[f"uniform_{n}"] for n in ("dx", "dy", "dz", "qx", "qy"))
    gx = int(g["ffpin_gx"])
    grid = build_grid(*(torch.as_tensor(a) for a in (dx, dy, dz)), gx=gx, gy=gx)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = build_plan(dx, dy, dz, params=AIDWParams(k=int(g["k"]), area=float(g["area"])),
                          area=float(g["area"]), impl="grid", grid=grid, phase2="farfield",
                          farfield_radius=int(g["ffpin_radius"]), block_q=64, device="cpu")
    z, a = execute(plan, qx, qy)
    np.testing.assert_allclose(_np(a), g["ffpin_alpha"], rtol=0, atol=1e-6, err_msg="farfield alpha drift")
    np.testing.assert_allclose(_np(z), g["ffpin_z"], rtol=2e-6, atol=2e-6, err_msg="farfield z drift")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("radius", [2, 3])
@pytest.mark.parametrize("dist", DISTRIBUTIONS)
def test_measured_error_within_proved_bound(dist, radius, dtype):
    """The port's ``farfield_error_report``: the measured error against the
    Kahan oracle stays within the plan's finite proved bound plus the fp
    slack; in float64 the error is genuinely tiny."""
    data = _cluster_data(seed=10 if dtype == np.float32 else 12, dtype=dtype)
    qx, qy = _queries(dist, 220 if dtype == np.float32 else 150, seed=11 if dtype == np.float32 else 13,
                      dtype=dtype)
    plan = _ff_plan(data, radius=radius)
    assert np.isfinite(plan.farfield_bound), "this configuration must be provable"
    rep = accuracy.farfield_error_report(plan, qx, qy)
    assert rep["bound"] == plan.farfield_bound and rep["phase2"] == "farfield"
    assert rep["n_queries"] == qx.shape[0] and rep["max_rel_err"] > 0.0
    assert rep["within_bound"], rep
    if dtype == np.float64:
        assert rep["max_rel_err"] <= plan.farfield_bound + 1e-12


@pytest.mark.parametrize("dtype", DTYPES)
def test_kahan_oracle_matches_jax(dtype):
    """``aidw_interpolate_kahan`` is the test oracle, plain torch: z within
    1e-5 / 1e-12 relative of the JAX oracle, alpha within 1e-6 / 1e-12."""
    data = _cluster_data(seed=12, dtype=dtype, m=1500)
    qx, qy = _queries("out_of_bbox", 100, seed=13, dtype=dtype)
    with _x64(dtype):
        jz, ja = j_accuracy.aidw_interpolate_kahan(*(jnp.asarray(a) for a in (*data, qx, qy)), JParams(**P),
                                                   area=1.0, q_chunk=64, d_chunk=256)
        jz, ja = np.asarray(jz), np.asarray(ja)
    z, a = accuracy.aidw_interpolate_kahan(*(torch.as_tensor(v) for v in (*data, qx, qy)), AIDWParams(**P),
                                           area=1.0, q_chunk=64, d_chunk=256)
    _assert_rel(_np(z), jz, REL[dtype], "z")
    np.testing.assert_allclose(_np(a), ja, rtol=0, atol=1e-6 if dtype == np.float32 else 1e-12)
    s, c = accuracy.kahan_add(torch.tensor(1.0, dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64),
                              torch.tensor(1e-17, dtype=torch.float64))
    assert float(s) == 1.0 and float(c) == -1e-17


# --------------------------------------------------------------- overflow arm
def _overflow_case(block_q=256):
    rng = np.random.default_rng(14)
    dx, dy = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    dz = _field(dx, dy)
    p = AIDWParams(k=10, area=1.0, r_max=64.0)
    qx = (rng.random(96) * 6 - 3).astype(np.float32)
    qy = (rng.random(96) * 6 - 3).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan_ff = build_plan(dx, dy, dz, params=p, area=1.0, impl="grid", phase2="farfield",
                             farfield_radius=1, query_occupancy=64.0, block_q=block_q, device="cpu")
        plan_ex = build_plan(dx, dy, dz, params=p, area=1.0, impl="grid", query_occupancy=64.0,
                             block_q=block_q, device="cpu")
    return plan_ff, plan_ex, qx, qy


def test_near_overflow_falls_back_to_exact_bitwise():
    """A batch sparser and wider than the near-capacity model assumed (the
    shape of ``tests/engine/test_farfield.py``): every overflowed query's z
    is the exact plan's, bit for bit."""
    plan_ff, plan_ex, qx, qy = _overflow_case()
    assert plan_ff.p2_capacity < plan_ff.m
    z_ff, a_ff, stats = execute_with_stats(plan_ff, qx, qy)
    z_ex, a_ex = execute(plan_ex, qx, qy)
    assert int(stats["p2_overflow_queries"]) == 96
    np.testing.assert_array_equal(_np(z_ff), _np(z_ex))
    np.testing.assert_array_equal(_np(a_ff), _np(a_ex))


def test_masked_exact_arm_sweeps_only_flagged_blocks(monkeypatch):
    """The overflow arm sweeps the flagged blocks in one call, each query
    with the bits of a whole-batch sweep, and a clean batch never calls the
    exact sweep."""
    plan_ff, plan_ex, qx, qy = _overflow_case(block_q=64)
    calls = []
    real = t_execute_mod.phase2_weights_full

    def spy(qx_s, *args, **kw):
        calls.append(qx_s.shape[0])
        return real(qx_s, *args, **kw)

    monkeypatch.setattr(t_execute_mod, "phase2_weights_full", spy)
    rng = np.random.default_rng(15)
    mixed_x = np.concatenate([qx[:20], (0.4 + 0.05 * rng.random(300)).astype(np.float32)])
    mixed_y = np.concatenate([qy[:20], (0.4 + 0.05 * rng.random(300)).astype(np.float32)])
    z_ff, _, stats = execute_with_stats(plan_ff, mixed_x, mixed_y)
    n_over = int(stats["p2_overflow_queries"])
    assert 0 < n_over < mixed_x.shape[0]
    # one call, for the flagged blocks only (5 blocks of 64 hold the batch)
    assert len(calls) == 1 and calls[0] % plan_ff.block_q == 0 and n_over <= calls[0] < 320
    z_ex, _ = execute(plan_ex, mixed_x, mixed_y)
    # the flagged queries carry the whole-batch sweep's bits; the rest are
    # approximations, equal to the exact z only by chance
    assert int((z_ff == z_ex).sum()) >= n_over
    calls.clear()
    clean = tuple((0.4 + 0.05 * rng.random(128)).astype(np.float32) for _ in range(2))
    _, _, stats = execute_with_stats(plan_ff, *clean)
    assert int(stats["p2_overflow_queries"]) == 0 and calls == []


# ---------------------------------------------------------------- validations
def test_farfield_validations():
    dx, dy, dz = _cluster_data(seed=7, m=256)
    kw = dict(params=AIDWParams(**P), area=1.0, device="cpu")
    with pytest.raises(ValueError, match="phase2"):
        build_plan(dx, dy, dz, impl="grid", phase2="fmm", **kw)
    with pytest.raises(ValueError, match="farfield"):
        build_plan(dx, dy, dz, impl="tiled", phase2="farfield", **kw)
    with pytest.raises(ValueError, match="farfield_rtol"):
        build_plan(dx, dy, dz, impl="grid", phase2="farfield", farfield_rtol=0.0, **kw)
    with pytest.raises(ValueError, match="farfield_radius"):
        build_plan(dx, dy, dz, impl="grid", phase2="farfield", farfield_radius=0, **kw)
    with pytest.raises(ValueError, match="min_p2_capacity"):
        build_plan(dx, dy, dz, impl="grid", phase2="farfield", min_p2_capacity=0, **kw)
    with pytest.raises(ValueError, match="quadtree"):
        build_plan(dx, dy, dz, impl="tiled", phase2="quadtree", **kw)
    with pytest.raises(ValueError, match="farfield_rtol"):
        build_plan(dx, dy, dz, impl="grid", phase2="quadtree", farfield_rtol=0.0, **kw)
    exact = build_plan(dx, dy, dz, impl="grid", **kw)
    assert exact.phase2 == "exact" and exact.far == () and exact.p2_capacity == 0
    with pytest.raises(ValueError, match="impl='grid'"):
        accuracy.farfield_error_report(build_plan(dx, dy, dz, impl="tiled", **kw), dx[:4], dy[:4])
