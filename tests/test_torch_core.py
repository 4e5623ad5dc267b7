"""The PyTorch port's math core, data, configs and grid against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  Tolerances:
alpha within 1e-6 absolute and z within 1e-5 relative in float32 (the two
libraries' cos/exp/log and sum orders differ by a few ulps); 1e-12 in
float64, with the float64 JAX reference made under JAX's x64 context
(:func:`enable_x64`, which the port's other test files import from here).
Integer and layout state (grid, radii, Morton ids, seam layouts) must be
equal exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import aidw as j_configs
from repro.core import aidw as j_aidw
from repro.core import grid as j_grid
from repro.core import knn as j_knn
from repro.core import layouts as j_layouts
from repro.data import spatial as j_spatial
from repro_torch.configs import aidw as t_configs
from repro_torch.core import aidw as t_aidw
from repro_torch.core import grid as t_grid
from repro_torch.core import knn as t_knn
from repro_torch.core import layouts as t_layouts
from repro_torch.data import spatial as t_spatial

SRC = Path(__file__).resolve().parents[1] / "src"
DTYPES = [np.float32, np.float64]
# (alpha atol, z rtol) per dtype
TOL = {np.float32: (1e-6, 1e-5), np.float64: (1e-12, 1e-12)}


def enable_x64(on: bool = True):
    """JAX's x64 context under either of its names: ``jax.enable_x64`` where
    the installed JAX has it, else ``jax.experimental.enable_x64`` (older
    releases, such as the one CI pins)."""
    ctx = getattr(jax, "enable_x64", None)
    if ctx is None:
        from jax.experimental import enable_x64 as ctx
    return ctx(on)


def _x64(dtype):
    return enable_x64(dtype == np.float64)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _points(m, seed, dtype, kind="uniform"):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pts = rng.random((m, 2))
    elif kind == "clustered":
        centers = rng.random((max(2, m // 64), 2))
        pts = np.clip(centers[rng.integers(0, len(centers), m)] + rng.normal(0, 0.02, (m, 2)), 0, 1)
    else:  # offset: a data minimum float32 cannot hold, so f32 origin rounding matters in f64
        pts = 0.1 + 1e-9 * np.pi + rng.random((m, 2)) * 0.7
    dx, dy = pts[:, 0].astype(dtype), pts[:, 1].astype(dtype)
    dz = (np.sin(6 * pts[:, 0]) * np.cos(6 * pts[:, 1]) + 2.0).astype(dtype)
    return dx, dy, dz


# ------------------------------------------------------------ package boundary
def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib, pkgutil\n"
        "import repro_torch, repro_torch.core, repro_torch.data, repro_torch.configs\n"
        "import repro_torch.engine, repro_torch.kernels, repro_torch.kernels.aidw_grid\n"
        "import repro_torch.kernels._build, repro_torch.errors\n"
        "import repro_torch.serving, repro_torch.serving.faults, repro_torch.serving.registry\n"
        "import repro_torch.serving.reestimator\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "assert 'repro_torch.kernels.ops' in sys.modules and 'repro_torch.serving.reestimator' in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.') or m.startswith('jax')]\n"
        "assert bad == ['jax'] and sys.modules['jax'] is None, bad\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


# the first exp/log over a large tensor in a fresh interpreter, with 8
# intra-op threads, through the port's CPU path: the inputs made by PyTorch
# arithmetic (as the plain versions make d^2), then exp, log or the plain
# versions' sq_dist_tile and pow_weight, op i % 6 first in interpreter i;
# every result compared bit for bit with a one-thread computation of the
# same call.  The interpreters start together but compute one at a time,
# behind a file lock: with the cores shared the fault hardly shows.
_FIRST_CALL_CODE = """
import fcntl, json, sys
import numpy as np
import repro_torch
import torch
from repro_torch.kernels._common import pow_weight, sq_dist_tile
i = int(sys.argv[1])
u_np = np.random.default_rng(i).random((4, 1 << 22))
ops = [("exp", torch.float32), ("log", torch.float32), ("exp", torch.float64), ("log", torch.float64),
       ("pow_weight", torch.float32), ("pow_weight", torch.float64)]
bad = {}
with open(sys.argv[2], "w") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    torch.set_num_threads(8)
    u = torch.as_tensor(u_np)
    x = u[0] * 20.0 - 10.0
    for name, dt in ops[i % 6:] + ops[:i % 6]:
        if name == "pow_weight":
            q, d = u[1:3, :2048].to(dt), u[1:3, 2048:4096].to(dt)
            ah = u[3, :2048, None].to(dt) * 2.25 + 0.25
            def fn(ah=ah, q=q, d=d):
                return pow_weight(sq_dist_tile(q[0, :, None], q[1, :, None], d[0, None], d[1, None]), ah)
        else:
            arg = (x.abs() + 1e-3 if name == "log" else x).to(dt)
            def fn(f=getattr(torch, name), arg=arg):
                return f(arg)
        torch.set_num_threads(8)
        first = fn()
        torch.set_num_threads(1)
        steady = fn()
        bad[f"{name} {str(dt)[6:]}"] = int((first != steady).sum())
print(json.dumps(bad))
"""


def test_first_cpu_exp_log_give_steady_bits(tmp_path):
    """The first ``torch.exp``/``torch.log`` over 2^22 elements in a process,
    on 8 threads, gives one thread's share of the result far off unless the
    port warms them up at import (``repro_torch/_cpu_warmup.py``): 24 fresh
    interpreters each compute exp, log and the plain versions'
    ``pow_weight`` in float32 and float64 and compare each with a one-thread
    computation, bit for bit.  Without the warm-up about one interpreter in
    eight shows the fault here, when nothing else loads the cores."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    lock = str(tmp_path / "compute.lock")
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL_CODE, str(i), lock], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(24)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    wrong = [(i, r) for i, r in enumerate(results) if any(r.values())]
    assert not wrong, wrong
    assert all(len(r) == 6 for r in results)


def test_build_plan_defaults_to_cuda():
    from repro_torch.engine import build_plan

    dx, dy, dz = _points(64, 0, np.float32)
    if torch.cuda.is_available():
        assert build_plan(dx, dy, dz, area=1.0).device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        build_plan(dx, dy, dz, area=1.0)


# --------------------------------------------------------------------- layouts
@pytest.mark.parametrize("dtype", DTYPES)
def test_sentinel_and_padding_match(dtype):
    with _x64(dtype):
        assert float(t_layouts.coord_sentinel(_t(np.zeros(1, dtype)).dtype)) == float(
            j_layouts.coord_sentinel(jnp.dtype(dtype)))
        x = np.arange(5, dtype=dtype)
        np.testing.assert_array_equal(_np(t_layouts.pad_to(_t(x), 4, 9.0)),
                                      np.asarray(j_layouts.pad_to(jnp.asarray(x), 4, 9.0)))
        np.testing.assert_array_equal(_np(t_layouts.pad_tail(_t(x), 3)),
                                      np.asarray(j_layouts.pad_tail(jnp.asarray(x), 3)))
    assert t_layouts.pad_to(_t(x[:4]), 4, 0.0).shape == (4,)


# ------------------------------------------------------------------------ knn
@pytest.mark.parametrize("dtype", DTYPES)
def test_running_k_best_matches_with_duplicates(dtype):
    rng = np.random.default_rng(1)
    best = np.sort(rng.random((16, 6)).astype(dtype), axis=1)
    best[3, 4:] = np.inf
    tile = rng.random((16, 40)).astype(dtype)
    tile[:, 7] = tile[:, 3]  # duplicates must both survive
    tile[5, :] = np.inf      # an all-sentinel row
    with _x64(dtype):
        ref = np.asarray(j_knn.running_k_best(jnp.asarray(best), jnp.asarray(tile)))
    np.testing.assert_array_equal(_np(t_knn.running_k_best(_t(best), _t(tile))), ref)
    np.testing.assert_array_equal(_np(t_knn.k_smallest(_t(tile), 6)), np.sort(tile, axis=1)[:, :6])


def test_paper_insertion_knn_oracle():
    d = np.random.default_rng(2).random(300)
    np.testing.assert_array_equal(t_knn.paper_insertion_knn(d, 10), j_knn.paper_insertion_knn(d, 10))
    np.testing.assert_array_equal(t_knn.paper_insertion_knn(d, 10), np.sort(d)[:10])


# ---------------------------------------------------------------- alpha chain
@pytest.mark.parametrize("dtype", DTYPES)
def test_alpha_chain_matches(dtype):
    atol = TOL[dtype][0]
    rng = np.random.default_rng(3)
    r_obs = np.concatenate([rng.random(4000) * 0.1, [0.0, 1e-9, 0.5, 10.0]]).astype(dtype)
    mu = np.concatenate([rng.random(4000), [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0]]).astype(dtype)
    pj = j_aidw.AIDWParams(k=7, r_min=0.1, r_max=1.7)
    pt = t_aidw.AIDWParams(k=7, r_min=0.1, r_max=1.7)
    assert t_aidw.expected_nn_distance(900, 2.0) == j_aidw.expected_nn_distance(900, 2.0)
    with _x64(dtype):
        a_ref = np.asarray(j_aidw.adaptive_alpha(jnp.asarray(r_obs), 900, 1.0, pj))
        mu_ref = np.asarray(j_aidw.fuzzy_membership(jnp.asarray(r_obs * 40), 0.1, 1.7))
        am_ref = np.asarray(j_aidw.alpha_from_mu(jnp.asarray(mu), (0.3, 1.1, 2.0, 2.5, 5.0)))
    a = _np(t_aidw.adaptive_alpha(_t(r_obs), 900, 1.0, pt))
    assert a.dtype == dtype
    np.testing.assert_allclose(a, a_ref, rtol=0, atol=atol)
    np.testing.assert_allclose(_np(t_aidw.fuzzy_membership(_t(r_obs * 40), 0.1, 1.7)), mu_ref,
                               rtol=0, atol=atol)
    np.testing.assert_allclose(_np(t_aidw.alpha_from_mu(_t(mu), (0.3, 1.1, 2.0, 2.5, 5.0))), am_ref,
                               rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_aidw_reference_matches(dtype, kind):
    atol, rtol = TOL[dtype]
    dx, dy, dz = _points(900, 4, dtype, kind)
    qx, qy, _ = _points(200, 5, dtype)
    qx[:3], qy[:3] = dx[:3], dy[:3]  # exact hits
    pj, pt = j_aidw.AIDWParams(k=10, area=1.0), t_aidw.AIDWParams(k=10, area=1.0)
    with _x64(dtype):
        z_ref, a_ref = j_aidw.aidw_reference(*map(jnp.asarray, (dx, dy, dz, qx, qy)), pj, area=1.0)
        r_ref = j_aidw.brute_r_obs(*map(jnp.asarray, (dx, dy, qx, qy)), 10, q_chunk=64, d_chunk=128)
    z, a = t_aidw.aidw_reference(*map(_t, (dx, dy, dz, qx, qy)), pt, area=1.0)
    np.testing.assert_allclose(_np(a), np.asarray(a_ref), rtol=0, atol=atol)
    np.testing.assert_allclose(_np(z), np.asarray(z_ref), rtol=rtol, atol=0)
    np.testing.assert_array_equal(_np(z)[:3], dz[:3])
    r = t_aidw.brute_r_obs(*map(_t, (dx, dy, qx, qy)), 10, q_chunk=64, d_chunk=128)
    np.testing.assert_allclose(_np(r), np.asarray(r_ref), rtol=rtol, atol=0)


# ------------------------------------------------------------ data and configs
def test_generators_and_configs_match():
    for fn in ("uniform_points", "clustered_points"):
        for a, b in zip(getattr(t_spatial, fn)(3000, seed=7), getattr(j_spatial, fn)(3000, seed=7)):
            np.testing.assert_array_equal(a, b)
    assert t_configs.PAPER_SIZES == j_configs.PAPER_SIZES
    assert set(t_configs.AIDW_WORKLOADS) == set(j_configs.AIDW_WORKLOADS)
    for name, w in t_configs.AIDW_WORKLOADS.items():
        ref = j_configs.AIDW_WORKLOADS[name]
        assert (w.m, w.n, w.k, w.mode, w.q_chunk, w.d_chunk) == (
            ref.m, ref.n, ref.k, ref.mode, ref.q_chunk, ref.d_chunk)
        assert (w.params.k, w.params.area) == (ref.params.k, ref.params.area)


# ------------------------------------------------------------------------ grid
GRID_FIELDS = ("origin", "cell_size", "cell_x", "cell_y", "cell_z", "counts", "cum",
               "pt_x", "pt_y", "pt_z", "starts")


def _grids(dx, dy, dz, dtype, **kw):
    with _x64(dtype):
        jg = j_grid.build_grid(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz), **kw)
    return jg, t_grid.build_grid(_t(dx), _t(dy), _t(dz), **kw)


def _assert_grids_equal(jg, tg):
    assert (tg.gx, tg.gy, tg.cap) == (jg.gx, jg.gy, jg.cap)
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tg, f)), np.asarray(getattr(jg, f)), err_msg=f)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["uniform", "clustered", "offset"])
def test_build_grid_equal(dtype, kind):
    dx, dy, dz = _points(2000, 6, dtype, kind)
    jg, tg = _grids(dx, dy, dz, dtype)
    _assert_grids_equal(jg, tg)
    # explicit resolution and bounds that leave points outside the grid
    _assert_grids_equal(*_grids(dx, dy, dz, dtype, gx=13, gy=7, bounds=(0.2, 0.6, 0.3, 0.9)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cell_ids_radii_and_morton_equal(dtype):
    dx, dy, dz = _points(3000, 8, dtype, "offset")
    jg, tg = _grids(dx, dy, dz, dtype)
    rng = np.random.default_rng(9)
    qx = np.concatenate([rng.random(500) * 1.6 - 0.3, dx[:200]]).astype(dtype)  # in, out, on edges
    qy = np.concatenate([rng.random(500) * 1.6 - 0.3, dy[:200]]).astype(dtype)
    with _x64(dtype):
        jcx, jcy = j_grid.cell_of(jg, jnp.asarray(qx), jnp.asarray(qy))
        j_need = j_grid.required_radius_table(jg, 10)
        j_static = j_grid.static_cell_radius(jg, j_need)
        j_rn = j_need[jcy, jcx]
        j_safe = j_grid.safe_radius_from_need(jg, jnp.asarray(qx), jnp.asarray(qy), jcx, jcy, j_rn)
        j_morton = j_grid.morton_ids(jcx, jcy)
        j_seg = j_grid.seam_segment_ids(jg, jcx, jcy, 2)
    tcx, tcy = t_grid.cell_of(tg, _t(qx), _t(qy))
    np.testing.assert_array_equal(_np(tcx), np.asarray(jcx))
    np.testing.assert_array_equal(_np(tcy), np.asarray(jcy))
    t_need = t_grid.required_radius_table(tg, 10)
    np.testing.assert_array_equal(_np(t_need), np.asarray(j_need))
    np.testing.assert_array_equal(_np(t_grid.static_cell_radius(tg, t_need)), np.asarray(j_static))
    t_safe = t_grid.safe_radius_from_need(tg, _t(qx), _t(qy), tcx, tcy, t_need[tcy, tcx])
    np.testing.assert_array_equal(_np(t_safe), np.asarray(j_safe))
    np.testing.assert_array_equal(_np(t_grid.morton_ids(tcx, tcy)), np.asarray(j_morton))
    np.testing.assert_array_equal(_np(t_grid.seam_segment_ids(tg, tcx, tcy, 2)), np.asarray(j_seg))


def test_morton_ids_at_full_resolution():
    c = np.arange(t_grid.MAX_CELLS_PER_AXIS, dtype=np.int32)
    cx, cy = np.meshgrid(c, c[::-1])
    ref = np.asarray(j_grid.morton_ids(jnp.asarray(cx.ravel()), jnp.asarray(cy.ravel())))
    got = _np(t_grid.morton_ids(_t(cx.ravel()), _t(cy.ravel())))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and got.max() < 2 ** 18


@pytest.mark.parametrize("level,block_q", [(1, 8), (2, 16), (3, 4)])
def test_seam_layout_equal(level, block_q):
    rng = np.random.default_rng(level)
    seg = np.sort(rng.integers(0, 4 ** level, 300)).astype(np.int32)
    n_slots = 300 + 4 ** level * block_q
    j_src, j_dest = j_grid.seam_layout(jnp.asarray(seg), 4 ** level, block_q, n_slots)
    t_src, t_dest = t_grid.seam_layout(_t(seg), 4 ** level, block_q, n_slots)
    np.testing.assert_array_equal(_np(t_src), np.asarray(j_src))
    np.testing.assert_array_equal(_np(t_dest), np.asarray(j_dest))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_knn_matches_with_active_mask(dtype):
    rtol = TOL[dtype][1] / 10
    dx, dy, dz = _points(1500, 10, dtype, "clustered")
    jg, tg = _grids(dx, dy, dz, dtype)
    rng = np.random.default_rng(11)
    qx = (rng.random(120) * 1.4 - 0.2).astype(dtype)
    qy = (rng.random(120) * 1.4 - 0.2).astype(dtype)
    active = rng.random(120) < 0.5
    with _x64(dtype):
        ref = np.asarray(j_grid.grid_r_obs(jg, jnp.asarray(qx), jnp.asarray(qy), 10,
                                           active=jnp.asarray(active)))
    got = _np(t_grid.grid_r_obs(tg, _t(qx), _t(qy), 10, active=_t(active)))
    assert np.isinf(got[~active]).all() and np.isinf(ref[~active]).all()
    np.testing.assert_allclose(got[active], ref[active], rtol=rtol, atol=0)
    brute = np.sqrt(np.sort((qx[:, None].astype(np.float64) - dx[None]) ** 2
                            + (qy[:, None].astype(np.float64) - dy[None]) ** 2, axis=1)[:, :10]).mean(1)
    np.testing.assert_allclose(got[active], brute[active], rtol=1e-5)


def test_ring_arm_runs_zero_iterations_when_inactive():
    dx, dy, dz = _points(800, 12, np.float32)
    tg = t_grid.build_grid(_t(dx), _t(dy), _t(dz))
    qx, qy, _ = _points(64, 13, np.float32)
    best, iters = t_grid._ring_search(tg, _t(qx), _t(qy), 5, active=torch.zeros(64, dtype=torch.bool))
    assert iters == 0 and torch.isinf(best).all()
    _, iters = t_grid._ring_search(tg, _t(qx), _t(qy), 5, active=torch.arange(64) == 3)
    assert iters > 0


def _ring_oracle(tg, qx, qy, k):
    """numpy model of the ring search: per query, the k smallest squared
    distances (rounded as the port rounds them, each product and sum once)
    over the cells within Chebyshev distance r of its clamped home cell,
    r = 0, 1, ... until ``best[k-1] <= (r cell_min)^2`` or ``r`` covers the
    grid.  Returns ``(best (n, k), rings walked by each query)``."""
    dtype = qx.dtype
    m = tg.n_points
    px, py = _np(tg.pt_x)[:m], _np(tg.pt_y)[:m]
    cid = np.repeat(np.arange(tg.n_cells), _np(tg.counts).reshape(-1))
    pcx, pcy = cid % tg.gx, cid // tg.gx
    hcx, hcy = (_np(c) for c in t_grid.cell_of(tg, _t(qx), _t(qy)))
    cell_min = dtype.type(min(_np(tg.cell_size)))
    best, rings = np.zeros((qx.shape[0], k), dtype), np.zeros(qx.shape[0], int)
    for q in range(qx.shape[0]):
        ddx, ddy = qx[q] - px, qy[q] - py
        d2 = ddx * ddx + ddy * ddy
        cheb = np.maximum(np.abs(pcx - hcx[q]), np.abs(pcy - hcy[q]))
        r_cover = max(hcx[q], tg.gx - 1 - hcx[q], hcy[q], tg.gy - 1 - hcy[q])
        r = 0
        while True:
            kb = np.sort(np.concatenate([d2[cheb <= r], np.full(k, np.inf, dtype)]))[:k]
            bound = dtype.type(r) * cell_min
            if kb[k - 1] <= bound * bound or r >= r_cover:
                break
            r += 1
        best[q], rings[q] = kb, r + 1
    return best, rings


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["in_bbox", "far_out_of_bbox"])
def test_ring_search_folds_whole_rings(where, dtype):
    """The ring search folds a whole ring per step and syncs once per ring:
    its k-best rows are the numpy model's bit for bit, and it reports the
    rings the last query walked.  Against the JAX ``grid_knn``: within one
    rounding of d^2, because XLA's CPU backend contracts ``dx*dx + dy*dy``
    into a fused multiply-add inside its ``while_loop`` where the port (and
    its CUDA kernels) round each product; in float32 the JAX rows are the
    model's with that contraction, bit for bit."""
    dx, dy, dz = _points(1500, 30, dtype, "clustered")
    jg, tg = _grids(dx, dy, dz, dtype)
    rng = np.random.default_rng(31)
    q = rng.random((64, 2)) * (6.0 if where == "far_out_of_bbox" else 1.0) - (3.0 if where == "far_out_of_bbox" else 0)
    qx, qy = q[:, 0].astype(dtype), q[:, 1].astype(dtype)
    got, rings = t_grid._ring_search(tg, _t(qx), _t(qy), 10)
    want, walked = _ring_oracle(tg, qx, qy, 10)
    np.testing.assert_array_equal(_np(got), want)
    assert rings == walked.max()
    if where == "far_out_of_bbox":  # no ring bound is met: the walk covers the grid
        assert rings == max(tg.gx, tg.gy)
    np.testing.assert_array_equal(_np(t_grid.grid_knn(tg, _t(qx), _t(qy), 10)), want)
    with _x64(dtype):
        ref = np.asarray(j_grid.grid_knn(jg, jnp.asarray(qx), jnp.asarray(qy), 10))
    np.testing.assert_allclose(_np(got), ref, rtol=2 * np.finfo(dtype).eps, atol=0)
    if dtype == np.float32:
        px, py = _np(tg.pt_x)[:tg.n_points], _np(tg.pt_y)[:tg.n_points]
        ddx, ddy = (qx[:, None] - px[None]).astype(np.float64), (qy[:, None] - py[None]).astype(np.float64)
        fused = (ddx * ddx + (ddy * ddy).astype(np.float32)).astype(np.float32)
        assert np.array_equal(ref, np.sort(fused, axis=1)[:, :10]) or np.array_equal(ref, want)
