"""Public names of the JAX package that the port keeps under the same name
and signature: ``core.grid.safe_radius``, ``core.aidw.MU_KNOTS`` and
``kernels.aidw_tiled_v2.aidw_knn_v2``, each held against the reference.

``safe_radius`` runs on the inputs of ``tests/test_grid_knn.py``'s radius
test (600 points, 250 queries, seed 11, in the box and stretched to
[-3, 3]^2); home cells and radii are integers and must be equal.
``aidw_knn_v2`` is held against the Pallas kernel in interpret mode: alpha
within ``test_torch_fused_v2_idw.py``'s tolerances and the merge counts
equal except on tiles with a d^2 within 2 ulps of a row's k-th best (XLA
contracts d^2 into an FMA there).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_points
from repro.core import aidw as j_aidw
from repro.core.aidw import AIDWParams as JParams
from repro.core.grid import build_grid as j_build_grid
from repro.core.grid import safe_radius as j_safe_radius
from repro.kernels import aidw_tiled_v2 as j_v2
from repro_torch.core import aidw as t_aidw
from repro_torch.core import grid as t_grid
from repro_torch.core.aidw import AIDWParams
from repro_torch.kernels import aidw_tiled_v2 as t_v2
from test_torch_core import enable_x64
from test_torch_fused_v2_idw import ALPHA_RTOL, DTYPES, P, TOL, _hold_merges, _kernel_inputs, _np, _t, _tiles_near_tau


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("far_queries", [False, True])
def test_safe_radius_matches_jax(clustered, far_queries):
    dx, dy, _, qx, qy = make_points(600, 250, seed=11, clustered=clustered)
    if far_queries:
        qx = (qx * 6.0 - 3.0).astype(np.float32)
        qy = (qy * 6.0 - 3.0).astype(np.float32)
    jc = j_safe_radius(j_build_grid(jnp.asarray(dx), jnp.asarray(dy)), jnp.asarray(qx), jnp.asarray(qy), 10)
    tc = t_grid.safe_radius(t_grid.build_grid(_t(dx), _t(dy)), _t(qx), _t(qy), 10)
    assert len(tc) == 3
    for got, want in zip(tc, jc):
        assert np.array_equal(_np(got), np.asarray(want))
    assert (_np(tc[2]) >= 1).all()


def test_safe_radius_is_required_radius_corrected():
    # the composition the reference documents: the home cell, its
    # occupancy-only radius, then the overhang correction
    dx, dy, _, qx, qy = make_points(600, 250, seed=11, clustered=True)
    qx, qy = _t(qx * 6.0 - 3.0), _t(qy * 6.0 - 3.0)
    g = t_grid.build_grid(_t(dx), _t(dy))
    cx, cy, r = t_grid.safe_radius(g, qx, qy, 10)
    cx2, cy2 = t_grid.cell_of(g, qx, qy)
    assert np.array_equal(_np(cx), _np(cx2)) and np.array_equal(_np(cy), _np(cy2))
    need = t_grid.required_radius(g, cx, cy, 10)
    assert np.array_equal(_np(r), _np(t_grid.safe_radius_from_need(g, qx, qy, cx, cy, need)))
    assert (_np(r) >= _np(need)).all()


def test_mu_knots_match_jax():
    assert t_aidw.MU_KNOTS == j_aidw.MU_KNOTS
    assert isinstance(t_aidw.MU_KNOTS, tuple)


def test_aidw_knn_v2_signature_is_the_reference():
    # data first, then queries; the same keywords and defaults, less the
    # reference's Pallas-only ``interpret`` (no wrapper of the port takes it)
    want = inspect.signature(j_v2.aidw_knn_v2).parameters
    got = inspect.signature(t_v2.aidw_knn_v2).parameters
    assert list(got) == [n for n in want if n != "interpret"]
    for name, p in got.items():
        assert p.kind == want[name].kind and p.default == want[name].default, name


@pytest.mark.parametrize("kind", ["ragged", "sorted"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_aidw_knn_v2_matches_jax(dtype, kind):
    atol, _ = TOL[dtype]
    pads, qp = _kernel_inputs(dtype, kind=kind)
    kw = dict(area=1.0, m_real=500 if kind == "ragged" else 2000, block_q=64, block_d=128)
    with enable_x64(dtype == np.float64):
        ja, jm = j_v2.aidw_knn_v2(*(jnp.asarray(p)[None] for p in pads[:2]), *(jnp.asarray(q)[:, None] for q in qp),
                                  params=JParams(**P), interpret=True, **kw)
    a, merges = t_v2.aidw_knn_v2(_t(pads[0]), _t(pads[1]), *map(_t, qp), params=AIDWParams(**P), **kw)
    np.testing.assert_allclose(_np(a), np.asarray(ja)[:, 0], rtol=ALPHA_RTOL[dtype], atol=atol)
    _hold_merges(merges, jm, _tiles_near_tau(*map(_t, qp), _t(pads[0]), _t(pads[1]), block_q=64, tile_d=128, k=10))
    # the thin wrapper: knn_alpha_v2's bits, queries first
    a2, m2 = t_v2.knn_alpha_v2(*map(_t, qp), _t(pads[0]), _t(pads[1]), block_q=64, tile_d=128,
                               params=AIDWParams(**P), area=1.0, m_real=kw["m_real"])
    assert np.array_equal(_np(a), _np(a2)) and np.array_equal(_np(merges), _np(m2))
