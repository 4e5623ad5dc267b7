"""The port's kernel modules on the CPU: each plain version against its Pallas
kernel in interpret mode, on the same numpy inputs.

B1 is ``aidw_tiled.py:_knn_kernel_soa`` (shared data row and dense candidate
rows), B3 ``aidw_grid.py:_knn_kernel_skip`` (candidate rows with a partial
tile table), B2 ``aidw_tiled.py:_weight_kernel_soa``.  Tolerances: alpha
within 1e-6 absolute and z within 1e-5 relative in float32, 1e-12 in float64
(the float64 JAX reference under JAX's x64 context, ``test_torch_core.enable_x64``).  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``; here a CPU tensor takes the plain version and any other
non-CUDA tensor is refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidw import AIDWParams as JParams
from repro.core.grid import build_grid as j_build_grid
from repro.core.grid import cell_of as j_cell_of
from repro.kernels import _common as j_common
from repro.kernels.aidw_grid import block_rectangles as j_block_rectangles
from repro.kernels.aidw_grid import gather_candidates_csr as j_gather
from repro.kernels.aidw_grid import phase1_alpha_from_candidates as j_phase1
from repro.kernels.aidw_grid import phase2_weights_full as j_phase2
from repro.kernels.aidw_tiled import aidw_tiled_soa as j_tiled
from repro_torch.core.aidw import AIDWParams
from repro_torch.core.grid import build_grid, cell_of
from repro_torch.kernels import _build
from repro_torch.kernels import _common as t_common
from repro_torch.kernels.aidw_grid import (
    block_rectangles,
    gather_candidates_csr,
    phase1_alpha_from_candidates,
    phase2_weights_full,
)
from repro_torch.kernels.aidw_tiled import knn_alpha, weight_sweep
from test_torch_core import enable_x64

DTYPES = [np.float32, np.float64]
TOL = {np.float32: (1e-6, 1e-5), np.float64: (1e-12, 1e-12)}
P = dict(k=10, area=1.0)


def _x64(dtype):
    return enable_x64(dtype == np.float64)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _sentinel(dtype):
    return np.asarray(np.finfo(dtype).max / 4, dtype)


def _padded(v, mult, fill):
    pad = (-len(v)) % mult
    return np.concatenate([v, np.full(pad, fill, v.dtype)])


def _data(m, seed, dtype, mult=128):
    rng = np.random.default_rng(seed)
    dx, dy = rng.random(m).astype(dtype), rng.random(m).astype(dtype)
    dz = (np.sin(6 * dx) * np.cos(6 * dy) + 2.0).astype(dtype)
    big = _sentinel(dtype)
    return _padded(dx, mult, big), _padded(dy, mult, big), _padded(dz, mult, np.zeros((), dtype))


def _candidate_rows(dtype, block_d=128):
    """Three blocks of 64 queries; rows of 512 slots holding 500, 130 and 0
    real candidates, sentinel after them; tile table ceil(need / block_d)."""
    rng = np.random.default_rng(20)
    need = np.array([500, 130, 0])
    cx = np.full((3, 512), _sentinel(dtype))
    cy = np.full((3, 512), _sentinel(dtype))
    for i, c in enumerate(need):
        cx[i, :c], cy[i, :c] = rng.random(c), rng.random(c)
    qx, qy = rng.random(192).astype(dtype), rng.random(192).astype(dtype)
    qx[5], qy[5] = cx[0, 17], cy[0, 17]  # an exact hit
    nt = ((need + block_d - 1) // block_d).astype(np.int32)
    return qx, qy, cx.astype(dtype), cy.astype(dtype), nt


# ---------------------------------------------------------- shared semantics
@pytest.mark.parametrize("dtype", DTYPES)
def test_common_helpers_match(dtype):
    atol, rtol = TOL[dtype]
    rng = np.random.default_rng(21)
    qx, qy = rng.random((32, 1)).astype(dtype), rng.random((32, 1)).astype(dtype)
    dx, dy, dz = (rng.random((1, 96)).astype(dtype) for _ in range(3))
    dx[0, 90:] = _sentinel(dtype)
    dx[0, 11] = qx[4, 0]
    dy[0, 11] = qy[4, 0]
    best = np.full((32, 10), np.inf, dtype)
    ah = (rng.random((32, 1)) * 2 + 0.25).astype(dtype)
    with _x64(dtype):
        d2_j = j_common.sq_dist_tile(*map(jnp.asarray, (qx, qy, dx, dy)))
        best_j = j_common.merge_k_best(jnp.asarray(best), d2_j, data_axis=1)
        alpha_j = j_common.alpha_from_best(best_j, 900, 1.0, JParams(**P), data_axis=1)
        w_j = j_common.pow_weight(d2_j, jnp.asarray(ah))
        tile_j = j_common.weight_tile(d2_j, jnp.asarray(dz), jnp.asarray(ah), data_axis=1)
    d2 = t_common.sq_dist_tile(*map(_t, (qx, qy, dx, dy)))
    np.testing.assert_array_equal(_np(d2), np.asarray(d2_j))
    assert np.isinf(_np(d2)[:, 90:]).all()
    best_t = t_common.merge_k_best(_t(best), d2)
    np.testing.assert_array_equal(_np(best_t), np.asarray(best_j))
    np.testing.assert_allclose(_np(t_common.alpha_from_best(best_t, 900, 1.0, AIDWParams(**P))),
                               np.asarray(alpha_j), rtol=0, atol=atol)
    w = _np(t_common.pow_weight(d2, _t(ah)))
    np.testing.assert_allclose(w, np.asarray(w_j), rtol=rtol, atol=0)
    assert (w[:, 90:] == 0).all()
    for got, ref in zip(t_common.weight_tile(d2, _t(dz), _t(ah)), tile_j):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=rtol, atol=0)


# ------------------------------------------------------------- B1 and B2, tiled
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_passes_match_pallas(dtype):
    """B1 on one shared data row and B2, against ``aidw_tiled_soa``."""
    atol, rtol = TOL[dtype]
    dx, dy, dz = _data(1000, 22, dtype)
    rng = np.random.default_rng(23)
    qx, qy = rng.random(128).astype(dtype), rng.random(128).astype(dtype)
    qx[7], qy[7] = dx[3], dy[3]
    with _x64(dtype):
        z_ref, a_ref = j_tiled(jnp.asarray(dx)[None], jnp.asarray(dy)[None], jnp.asarray(dz)[None],
                               jnp.asarray(qx)[:, None], jnp.asarray(qy)[:, None],
                               params=JParams(**P), area=1.0, m_real=1000,
                               block_q=64, block_d=128, interpret=True)
    a = knn_alpha(_t(qx), _t(qy), _t(dx)[None], _t(dy)[None], block_q=64, tile_d=128,
                  params=AIDWParams(**P), area=1.0, m_real=1000)
    np.testing.assert_allclose(_np(a), np.asarray(a_ref)[:, 0], rtol=0, atol=atol)
    z = weight_sweep(_t(qx), _t(qy), a * 0.5, *map(_t, (dx, dy, dz)), tile_d=128, eps=1e-18)
    np.testing.assert_allclose(_np(z), np.asarray(z_ref)[:, 0], rtol=rtol, atol=0)
    assert _np(z)[7] == dz[3]


# -------------------------------------------------------- B1 dense rows and B3
@pytest.mark.parametrize("dtype", DTYPES)
def test_candidate_row_passes_match_pallas(dtype):
    """B1 over per-block candidate rows (dense walk) and B3 with a partial
    tile table (one block's row is entirely padding), against
    ``phase1_alpha_from_candidates``; the two port paths agree bit for bit."""
    atol = TOL[dtype][0]
    qx, qy, cx, cy, nt = _candidate_rows(dtype)
    kw = dict(area=1.0, m_real=900, block_q=64, block_d=128)
    with _x64(dtype):
        args = [jnp.asarray(a) for a in (qx, qy, cx, cy)]
        dense_ref = j_phase1(*args, params=JParams(**P), interpret=True, **kw)
        skip_ref = j_phase1(*args, params=JParams(**P), interpret=True, num_tiles=jnp.asarray(nt), **kw)
    targs = [_t(a) for a in (qx, qy, cx, cy)]
    dense = phase1_alpha_from_candidates(*targs, params=AIDWParams(**P), **kw)
    skip = phase1_alpha_from_candidates(*targs, params=AIDWParams(**P), num_tiles=_t(nt), **kw)
    np.testing.assert_allclose(_np(dense), np.asarray(dense_ref)[:, 0], rtol=0, atol=atol)
    np.testing.assert_allclose(_np(skip), np.asarray(skip_ref)[:, 0], rtol=0, atol=atol)
    np.testing.assert_array_equal(_np(skip), _np(dense))
    assert (_np(skip)[128:] == AIDWParams().alpha_levels[-1]).all()  # no candidates: +inf r_obs


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_phase2_matches_pallas(dtype):
    """B2 as ``phase2_weights_full`` calls it, with exact hits, duplicate
    nearest points and sentinel padding."""
    rtol = TOL[dtype][1]
    dx, dy, dz = _data(700, 24, dtype)
    dx[10], dy[10] = dx[11], dy[11]  # duplicate point: the first index wins
    rng = np.random.default_rng(25)
    qx, qy = rng.random(192).astype(dtype), rng.random(192).astype(dtype)
    qx[:4], qy[:4] = dx[[0, 11, 40, 699]], dy[[0, 11, 40, 699]]
    alpha = (rng.random(192) * 3.5 + 0.5).astype(dtype)
    with _x64(dtype):
        ref = j_phase2(jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(alpha)[:, None],
                       *(jnp.asarray(a)[None] for a in (dx, dy, dz)),
                       eps=1e-18, block_q=64, block_d=128, interpret=True)
    z = phase2_weights_full(_t(qx), _t(qy), _t(alpha), *map(_t, (dx, dy, dz)), eps=1e-18, block_d=128)
    np.testing.assert_allclose(_np(z), np.asarray(ref)[:, 0], rtol=rtol, atol=0)
    np.testing.assert_array_equal(_np(z)[:4], dz[[0, 10, 40, 699]])


# --------------------------------------------------------- gather plumbing
@pytest.mark.parametrize("capacity", [256, 2048])
def test_rectangles_and_csr_gather_equal(capacity):
    rng = np.random.default_rng(26)
    dx, dy = rng.random(3000).astype(np.float32), rng.random(3000).astype(np.float32)
    dz = rng.random(3000).astype(np.float32)
    qx = np.sort(rng.random(256)).astype(np.float32)
    qy = (rng.random(256) * 1.2 - 0.1).astype(np.float32)
    jg = j_build_grid(jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz))
    tg = build_grid(_t(dx), _t(dy), _t(dz))
    r = rng.integers(0, 3, 256)
    jcx, jcy = j_cell_of(jg, jnp.asarray(qx), jnp.asarray(qy))
    j_rect = j_block_rectangles(jg, jcx, jcy, jnp.asarray(r, jnp.int32), 32)
    j_cx, j_cy, j_need = j_gather(jg, *j_rect, capacity)
    tcx, tcy = cell_of(tg, _t(qx), _t(qy))
    t_rect = block_rectangles(tg, tcx, tcy, _t(r), 32)
    for a, b in zip(t_rect, j_rect):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    t_cx, t_cy, t_need = gather_candidates_csr(tg, *t_rect, capacity)
    np.testing.assert_array_equal(_np(t_need), np.asarray(j_need))
    np.testing.assert_array_equal(_np(t_cx), np.asarray(j_cx))
    np.testing.assert_array_equal(_np(t_cy), np.asarray(j_cy))
    assert (np.asarray(j_need) > capacity).any() == (capacity == 256)


# -------------------------------------------------------------- wrapper rules
def test_wrappers_take_plain_path_on_cpu_only():
    dx, dy, dz = (_t(a) for a in _data(200, 27, np.float32))
    q = torch.rand(64)
    before = dict(_build.LAUNCHES)
    a = knn_alpha(q, q, dx[None], dy[None], block_q=64, tile_d=128, params=AIDWParams(**P),
                  area=1.0, m_real=200)
    weight_sweep(q, q, a * 0.5, dx, dy, dz, tile_d=128, eps=1e-18)
    assert _build.LAUNCHES == before  # the plain versions launch nothing
    meta = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        knn_alpha(meta, meta, meta[None], meta[None], block_q=64, tile_d=64, params=AIDWParams(**P),
                  area=1.0, m_real=64)
    with pytest.raises(ValueError, match="several devices"):
        weight_sweep(q, q, q, dx, dy, meta.new_empty(dx.shape), tile_d=128, eps=1e-18)
    with pytest.raises(ValueError, match="bad shapes"):
        knn_alpha(q[:50], q[:50], dx[None], dy[None], block_q=64, tile_d=128,
                  params=AIDWParams(**P), area=1.0, m_real=200)


def test_tile_table_needs_one_row_per_block():
    """One candidate row with a tile table is a batch of a single query block
    (the grid path's smallest batch): accepted before the device dispatch,
    and its walk equals the dense walk; a data row shared by several blocks
    takes no tile table."""
    dx, dy, _ = (_t(a) for a in _data(256, 28, np.float32))
    q = torch.as_tensor(np.random.default_rng(29).random(64).astype(np.float32))
    kw = dict(block_q=64, tile_d=128, params=AIDWParams(**P), area=1.0, m_real=256)
    nt = torch.tensor([2], dtype=torch.int32)
    assert torch.equal(knn_alpha(q, q, dx[None], dy[None], num_tiles=nt, **kw),
                       knn_alpha(q, q, dx[None], dy[None], **kw))
    q2 = torch.cat([q, q])
    with pytest.raises(ValueError, match="one candidate row per query block"):
        knn_alpha(q2, q2, dx[None], dy[None], num_tiles=nt, **kw)


def test_kernel_build_flags_and_interface():
    cmd = _build.nvcc_command("knn", _build.build_dir() / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert {"-O3", "-shared", "-fPIC"} <= set(cmd)
    assert set(_build.SOURCES) == {"knn", "weight", "near", "far", "far_node", "naive", "fused"}
    for name, (lib, argtypes) in _build.ENTRY_POINTS.items():
        assert lib in _build.SOURCES
        assert (_build.CSRC / _build.SOURCES[lib]).read_text().count(name.rsplit("_", 1)[0]) >= 1
    src = "".join((_build.CSRC / f).read_text() for f in _build.SOURCES.values())
    assert "powf(" not in src and "atomicAdd" not in src
    assert str(_build.library_path("knn")).startswith(str(_build.build_dir()))
    if not _build.os.path.exists(_build.nvcc_path()):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_all()


def test_supported_k_matches_kernel_dispatch():
    from repro_torch.kernels.aidw_tiled import SUPPORTED_K

    src = (_build.CSRC / "knn.cu").read_text()
    assert "switch (k) {\n    AIDW_K_LIST(AIDW_K_CASE)" in src  # the cases come from the shared list
    assert SUPPORTED_K == tuple(range(1, 17)) and 10 in SUPPORTED_K and 5 in SUPPORTED_K
