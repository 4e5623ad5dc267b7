"""The port's dense impls on the CPU against the JAX package's: ``naive``
(SoA and AoaS, ``aidw_naive.py:_naive_kernel_soa`` / ``_naive_kernel_aoas``),
``tiled`` AoaS (``aidw_tiled.py:_knn_kernel_aoas`` / ``_weight_kernel_aoas``)
and ``binned`` (``aidw_tiled.py:_knn_kernel_soa`` with ``nbins > 0``), each
kernel module's plain version against its Pallas kernel in interpret mode and
the slice through ``build_plan`` + ``execute`` against the JAX ``execute``.

Tolerances: alpha within 1e-6 absolute and z within 1e-5 relative in
float32; 1e-12 in float64, with the float64 JAX reference made under
JAX's x64 context (``test_torch_core.enable_x64``).  Plan data and ``block_q`` are equal exactly.  The
golden gate is the one of ``tests/test_golden.py``: RTOL 5e-4 / ATOL 5e-5.
``binned`` is approximate and meets the error envelope of
``tests/kernels/test_aidw_variants.py`` against the reference instead.
Inside the port, naive alpha equals tiled alpha and AoaS equals SoA, bit for
bit.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidw import AIDWParams as JParams
from repro.core.layouts import soa_to_aoas as j_soa_to_aoas
from repro.data.spatial import clustered_points as j_clustered
from repro.data.spatial import uniform_points as j_uniform
from repro.engine import build_plan as j_build_plan
from repro.engine import execute as j_execute
from repro.kernels.aidw_naive import aidw_naive_aoas as j_naive_aoas
from repro.kernels.aidw_naive import aidw_naive_soa as j_naive_soa
from repro.kernels.aidw_tiled import aidw_tiled_aoas as j_tiled_aoas
from repro.kernels.aidw_tiled import aidw_tiled_soa as j_tiled_soa
from repro.kernels.ref import aidw_ref as j_aidw_ref
from repro_torch.core.aidw import AIDWParams
from repro_torch.core.layouts import aoas_to_soa, soa_to_aoas
from repro_torch.engine import build_plan, execute, execute_with_stats, plan_from_reference
from repro_torch.engine.execute import binned_nbins
from repro_torch.kernels import _build, aidw
from repro_torch.kernels.aidw_naive import aidw_naive_aoas, aidw_naive_soa
from repro_torch.kernels.aidw_tiled import aidw_tiled_aoas, check_aoas, knn_alpha, weight_sweep
from test_torch_core import enable_x64

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "aidw_golden.npz")
RTOL, ATOL = 5e-4, 5e-5
DTYPES = [np.float32, np.float64]
TOL = {np.float32: (1e-6, 1e-5), np.float64: (1e-12, 1e-12)}
P = dict(k=10, area=1.0)
# (impl, layout) of this slice; the exact ones meet the golden gate
DENSE = [("naive", "soa"), ("naive", "aoas"), ("tiled", "aoas"), ("binned", "soa")]
EXACT = DENSE[:3]


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
    neither a multiple of its block."""
    if name == "ragged":
        rng = np.random.default_rng(60)
        dx, dy, qx, qy = rng.random(500), rng.random(500), rng.random(203), rng.random(203)
        dz = np.sin(6 * dx) * np.cos(6 * dy) + 2.0
        qx[9], qy[9] = dx[40], dy[40]  # an exact hit
        return [a.astype(dtype) for a in (dx, dy, dz, qx, qy)]
    return [golden[f"{name}_{n}"].astype(dtype) for n in ("dx", "dy", "dz", "qx", "qy")]


def _sentinel_padded(v, mult, dtype, fill=None):
    fill = np.finfo(dtype).max / 4 if fill is None else fill
    return np.concatenate([v, np.full((-len(v)) % mult, fill, dtype)]).astype(dtype)


# ---------------------------------------------------------------- layouts
@pytest.mark.parametrize("dtype", DTYPES)
def test_soa_aoas_transforms_match(dtype):
    rng = np.random.default_rng(61)
    x, y, z = (rng.random(37).astype(dtype) for _ in range(3))
    with enable_x64(dtype == np.float64):
        ref = np.asarray(j_soa_to_aoas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
        ref_noz = np.asarray(j_soa_to_aoas(jnp.asarray(x), jnp.asarray(y)))
    a = soa_to_aoas(_t(x), _t(y), _t(z))
    assert a.shape == (37, 4) and a.is_contiguous() and a.dtype == _t(x).dtype
    np.testing.assert_array_equal(_np(a), ref)
    np.testing.assert_array_equal(_np(soa_to_aoas(_t(x), _t(y))), ref_noz)
    for got, want in zip(aoas_to_soa(a), (x, y, z)):
        np.testing.assert_array_equal(_np(got), want)


# ------------------------------------------------- kernel modules vs Pallas
@pytest.mark.parametrize("dtype", DTYPES)
def test_naive_kernels_match_pallas(dtype):
    """B7 and B8's plain versions against ``aidw_naive_soa`` / ``_aoas``."""
    atol, rtol = TOL[dtype]
    dx, dy, dz, qx, qy = _inputs(None, "ragged", dtype)
    pads = [_sentinel_padded(dx, 128, dtype), _sentinel_padded(dy, 128, dtype),
            _sentinel_padded(dz, 128, dtype, 0.0)]
    qp = [_sentinel_padded(q, 64, dtype, 0.0) for q in (qx, qy)]
    kw = dict(area=1.0, m_real=500, block_q=64)
    with enable_x64(dtype == np.float64):
        jd = [jnp.asarray(p)[None] for p in pads]
        z_s, a_s = j_naive_soa(*jd, jnp.asarray(qp[0])[:, None], jnp.asarray(qp[1])[:, None],
                               params=JParams(**P), interpret=True, **kw)
        data = j_soa_to_aoas(*(jnp.asarray(p) for p in pads))
        z_a, a_a = j_naive_aoas(data, jnp.asarray(qp[0])[None], jnp.asarray(qp[1])[None],
                                params=JParams(**P), interpret=True, **kw)
    out_s = aidw_naive_soa(*map(_t, pads), *map(_t, qp), params=AIDWParams(**P), block_d=128, **kw)
    out_a = aidw_naive_aoas(_t(np.asarray(data)), *map(_t, qp), params=AIDWParams(**P), block_d=128, **kw)
    for (z, a), (jz, ja) in ((out_s, (z_s[:, 0], a_s[:, 0])), (out_a, (z_a[0], a_a[0]))):
        np.testing.assert_allclose(_np(a), np.asarray(ja), rtol=0, atol=atol)
        np.testing.assert_allclose(_np(z), np.asarray(jz), rtol=rtol, atol=0)
    assert _np(out_s[0])[9] == dz[40]  # the exact hit takes its point's z


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_aoas_and_binned_kernels_match_pallas(dtype):
    """B9 and B10's plain versions against ``aidw_tiled_aoas``, and B1 with
    ``nbins`` against ``aidw_tiled_soa(nbins=...)``."""
    atol, rtol = TOL[dtype]
    dx, dy, dz, qx, qy = _inputs(None, "ragged", dtype)
    pads = [_sentinel_padded(dx, 128, dtype), _sentinel_padded(dy, 128, dtype),
            _sentinel_padded(dz, 128, dtype, 0.0)]
    qp = [_sentinel_padded(q, 64, dtype, 0.0) for q in (qx, qy)]
    kw = dict(area=1.0, m_real=500, block_q=64, block_d=128)
    nbins = binned_nbins(10, 128)
    with enable_x64(dtype == np.float64):
        data = j_soa_to_aoas(*(jnp.asarray(p) for p in pads))
        z_a, a_a = j_tiled_aoas(data, jnp.asarray(qp[0])[None], jnp.asarray(qp[1])[None],
                                params=JParams(**P), interpret=True, **kw)
        z_b, a_b = j_tiled_soa(*(jnp.asarray(p)[None] for p in pads), jnp.asarray(qp[0])[:, None],
                               jnp.asarray(qp[1])[:, None], params=JParams(**P), interpret=True,
                               nbins=nbins, **kw)
    z, a = aidw_tiled_aoas(_t(np.asarray(data)), *map(_t, qp), params=AIDWParams(**P), **kw)
    np.testing.assert_allclose(_np(a), np.asarray(a_a)[0], rtol=0, atol=atol)
    np.testing.assert_allclose(_np(z), np.asarray(z_a)[0], rtol=rtol, atol=0)
    ab = knn_alpha(*map(_t, qp), _t(pads[0])[None], _t(pads[1])[None], block_q=64, tile_d=128, nbins=nbins,
                   params=AIDWParams(**P), area=1.0, m_real=500)
    np.testing.assert_allclose(_np(ab), np.asarray(a_b)[:, 0], rtol=0, atol=atol)
    zb = weight_sweep(*map(_t, qp), ab * 0.5, *map(_t, pads), tile_d=128, eps=1e-18)
    np.testing.assert_allclose(_np(zb), np.asarray(z_b)[:, 0], rtol=rtol, atol=0)
    # the prefilter drops a neighbour only where two share a bin of a tile
    exact = knn_alpha(*map(_t, qp), _t(pads[0])[None], _t(pads[1])[None], block_q=64, tile_d=128,
                      params=AIDWParams(**P), area=1.0, m_real=500)
    assert not torch.equal(ab, exact)


def test_binned_nbins_rule():
    """``execute.py: _execute_dense``'s rule of the JAX package."""
    assert binned_nbins(10, 512) == 32 and binned_nbins(10, 128) == 32
    assert binned_nbins(5, 512) == 16 and binned_nbins(16, 1024) == 64 and binned_nbins(10, 64) == 16


# ------------------------------------------------------------- plan state
@pytest.mark.parametrize("impl,layout", DENSE)
def test_plan_data_and_block_q_equal_jax(golden, impl, layout):
    for dtype in DTYPES:
        dx, dy, dz, _, _ = _inputs(golden, "ragged", dtype)
        kw = dict(area=1.0, impl=impl, layout=layout, block_q=256, block_d=128)
        with enable_x64(dtype == np.float64):
            jp = j_build_plan(dx, dy, dz, params=JParams(**P), **kw)
            jdata = [np.asarray(d) for d in jp.data]
        plan = build_plan(dx, dy, dz, params=AIDWParams(**P), device="cpu", **kw)
        assert plan.block_q == jp.block_q == (64 if impl == "naive" else 256)
        assert (plan.impl, plan.layout, plan.block_d, plan.m) == (impl, layout, jp.block_d, jp.m)
        assert len(plan.data) == len(jdata)
        for got, want in zip(plan.data, jdata):
            np.testing.assert_array_equal(_np(got), want.reshape(_np(got).shape))
            assert got.dtype == _t(want).dtype and got.is_contiguous()
        if layout == "aoas":
            assert plan.data[0].shape == (512, 4)


def test_soa_only_rejections_match_jax():
    dx, dy, dz, _, _ = _inputs(None, "ragged", np.float32)
    kw = dict(area=1.0, layout="aoas")
    for impl in ("binned", "grid", "fused", "tiled_v2", "idw", "chunked"):
        with pytest.raises(ValueError, match="SoA-only"):
            j_build_plan(dx, dy, dz, params=JParams(**P), impl=impl, **kw)
        with pytest.raises(ValueError, match="SoA-only"):
            build_plan(dx, dy, dz, params=AIDWParams(**P), impl=impl, device="cpu", **kw)
    for impl in ("fused", "tiled_v2", "idw", "chunked"):  # their SoA plans build and run
        plan = build_plan(dx, dy, dz, params=AIDWParams(**P), impl=impl, area=1.0, device="cpu")
        z, a = execute(plan, dx[:7], dy[:7])
        assert plan.layout == "soa" and z.shape == a.shape == (7,) and bool(torch.isfinite(z).all()), impl


# ------------------------------------------------------------ the slice
@pytest.mark.parametrize("batch", ["uniform", "clustered", "ragged"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl,layout", DENSE)
def test_dense_matches_jax_execute(golden, impl, layout, dtype, batch):
    atol, rtol = TOL[dtype]
    dx, dy, dz, qx, qy = _inputs(golden, batch, dtype)
    kw = dict(area=1.0, impl=impl, layout=layout, block_q=64, block_d=128)
    with enable_x64(dtype == np.float64):
        jp = j_build_plan(dx, dy, dz, params=JParams(**P), **kw)
        jz, ja = (np.asarray(v) for v in j_execute(jp, jnp.asarray(qx), jnp.asarray(qy)))
    plan = build_plan(dx, dy, dz, params=AIDWParams(**P), device="cpu", **kw)
    z, a, stats = execute_with_stats(plan, qx, qy)
    assert stats == {} and z.dtype == a.dtype == plan.dtype and z.shape == a.shape == (qx.shape[0],)
    np.testing.assert_allclose(a.numpy(), ja, rtol=0, atol=atol)
    np.testing.assert_allclose(z.numpy(), jz, rtol=rtol, atol=0)


@pytest.mark.parametrize("batch", ["uniform", "clustered"])
@pytest.mark.parametrize("impl,layout", EXACT)
def test_exact_dense_reproduce_golden(golden, impl, layout, batch):
    dx, dy, dz, qx, qy = _inputs(golden, batch, np.float32)
    k, area = int(golden["k"]), float(golden["area"])
    plan = build_plan(dx, dy, dz, params=AIDWParams(k=k, area=area), area=area, impl=impl, layout=layout,
                      block_q=64, block_d=128, device="cpu")
    z, a = execute(plan, qx, qy)
    np.testing.assert_allclose(a.numpy(), golden[f"{batch}_alpha"], rtol=RTOL, atol=ATOL,
                               err_msg=f"{impl}/{layout} alpha drift")
    np.testing.assert_allclose(z.numpy(), golden[f"{batch}_z"], rtol=RTOL, atol=ATOL,
                               err_msg=f"{impl}/{layout} z drift")


@pytest.mark.parametrize("dtype", DTYPES)
def test_variants_agree_bitwise_inside_the_port(golden, dtype):
    """naive and tiled keep the same k-smallest multiset, so the same alpha;
    the AoaS plain versions run the SoA ones on the struct columns."""
    dx, dy, dz, qx, qy = _inputs(golden, "clustered", dtype)
    out = {}
    for impl, layout in (("tiled", "soa"), *EXACT):
        plan = build_plan(dx, dy, dz, params=AIDWParams(**P), area=1.0, impl=impl, layout=layout,
                          block_q=64, block_d=128, device="cpu")
        out[impl, layout] = execute(plan, qx, qy)
    for key in EXACT:
        assert torch.equal(out[key][1], out["tiled", "soa"][1]), key
    for impl in ("naive", "tiled"):
        assert torch.equal(out[impl, "aoas"][0], out[impl, "soa"][0]), impl
        assert torch.equal(out[impl, "aoas"][1], out[impl, "soa"][1]), impl
    np.testing.assert_allclose(out["naive", "soa"][0].numpy(), out["tiled", "soa"][0].numpy(),
                               rtol=TOL[dtype][1], atol=0)


def test_binned_meets_the_reference_envelope():
    """``tests/kernels/test_aidw_variants.py::test_binned_prefilter_error_envelope``
    for the port: clustered m = 32768, 1,024 uniform queries, default blocks."""
    dx, dy, dz = j_clustered(32768, seed=1)
    qx, qy, _ = j_uniform(1024, seed=2)
    z_ref, a_ref = (np.asarray(v) for v in j_aidw_ref(dx, dy, dz, qx, qy, JParams(**P), 1.0))
    z, a = aidw(*(np.asarray(v) for v in (dx, dy, dz, qx, qy)), params=AIDWParams(**P), area=1.0,
                impl="binned", device="cpu")
    rel = np.abs(z.numpy() - z_ref) / (np.abs(z_ref) + 1e-9)
    da = np.abs(a.numpy() - a_ref)
    assert rel.mean() < 1e-4, rel.mean()
    assert rel.max() < 2e-2, rel.max()
    assert (da > 0.05).mean() < 0.02
    assert (da > 0).any()  # the prefilter is approximate: some alpha moved


def _export(jp):
    p = jp.params
    statics = dict(impl=jp.impl, layout=jp.layout, m=jp.m, area=jp.area, block_q=jp.block_q,
                   block_d=jp.block_d,
                   params=dict(k=p.k, alpha_levels=tuple(p.alpha_levels), r_min=p.r_min, r_max=p.r_max,
                               area=p.area, exact_hit_eps=p.exact_hit_eps))
    if jp.layout == "aoas":
        return statics, {"data": np.asarray(jp.data[0])}
    return statics, {n: np.asarray(a) for n, a in zip(("dx", "dy", "dz"), jp.data)}


@pytest.mark.parametrize("impl,layout", DENSE)
def test_plan_from_reference_executes_like_jax(golden, impl, layout):
    atol, rtol = TOL[np.float32]
    dx, dy, dz, qx, qy = _inputs(golden, "uniform", np.float32)
    kw = dict(area=1.0, impl=impl, layout=layout, block_q=128, block_d=128)
    jp = j_build_plan(dx, dy, dz, params=JParams(**P), **kw)
    carried = plan_from_reference(*_export(jp), device="cpu")
    own = build_plan(dx, dy, dz, params=AIDWParams(**P), device="cpu", **kw)
    assert (carried.impl, carried.layout, carried.block_q) == (own.impl, own.layout, own.block_q)
    for a, b in zip(carried.data, own.data, strict=True):
        assert torch.equal(a, b)
    jz, ja = j_execute(jp, jnp.asarray(qx), jnp.asarray(qy))
    z, a = execute(carried, qx, qy)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=atol)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=rtol, atol=0)


@pytest.mark.parametrize("impl,layout", EXACT)
def test_nonfinite_queries_yield_nan(golden, impl, layout):
    dx, dy, dz, qx, qy = _inputs(golden, "uniform", np.float32)
    plan = build_plan(dx, dy, dz, params=AIDWParams(**P), area=1.0, impl=impl, layout=layout,
                      block_q=64, block_d=128, device="cpu")
    hx, hy = qx.copy(), qy.copy()
    hx[3], hy[7], hx[11] = np.nan, np.nan, np.inf
    bad = ~(np.isfinite(hx) & np.isfinite(hy))
    z, a = execute(plan, hx, hy)
    zd, ad = execute(plan, np.where(bad, 0, hx).astype(np.float32), np.where(bad, 0, hy).astype(np.float32))
    assert np.isnan(z.numpy()[bad]).all() and np.isnan(a.numpy()[bad]).all()
    np.testing.assert_array_equal(z.numpy()[~bad], zd.numpy()[~bad])
    np.testing.assert_array_equal(a.numpy()[~bad], ad.numpy()[~bad])


# ------------------------------------------------------------ wrapper rules
def test_dense_wrappers_plain_on_cpu_refuse_the_rest():
    dx, dy, dz, qx, qy = (_t(_sentinel_padded(v, 128 if i < 3 else 64, np.float32, None if i < 2 else 0.0))
                          for i, v in enumerate(_inputs(None, "ragged", np.float32)))
    data = soa_to_aoas(dx, dy, dz)
    kw = dict(params=AIDWParams(**P), area=1.0, m_real=500, block_q=64, block_d=128)
    before = dict(_build.LAUNCHES)
    aidw_naive_soa(dx, dy, dz, qx, qy, **kw)
    aidw_naive_aoas(data, qx, qy, **kw)
    aidw_tiled_aoas(data, qx, qy, **kw)
    knn_alpha(qx, qy, dx[None], dy[None], block_q=64, tile_d=128, nbins=32, params=AIDWParams(**P), area=1.0,
              m_real=500)
    assert _build.LAUNCHES == before  # the plain versions launch nothing
    meta = torch.empty((512, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        aidw_naive_aoas(meta, meta[:64, 0], meta[:64, 1], **kw)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        aidw_tiled_aoas(meta, meta[:64, 0], meta[:64, 1], **kw)
    with pytest.raises(ValueError, match="bad shapes"):
        aidw_naive_soa(dx, dy, dz, qx[:50], qy[:50], **kw)
    with pytest.raises(ValueError, match="must divide"):
        knn_alpha(qx, qy, dx[None], dy[None], block_q=64, tile_d=128, nbins=48, params=AIDWParams(**P),
                  area=1.0, m_real=500)
    # a kernel loads a point as one 16-byte vector: an unaligned or strided view is refused
    check_aoas("t", data)
    flat = torch.zeros(4 * 512 + 1)
    with pytest.raises(ValueError, match="aligned"):
        check_aoas("t", flat[1:].view(512, 4))
    with pytest.raises(ValueError, match="contiguous"):
        check_aoas("t", data[::2])
    with pytest.raises(ValueError, match="contiguous"):
        check_aoas("t", data[:, :3])


def test_naive_and_knn_sources_instantiate_the_same_k():
    from repro_torch.kernels.aidw_tiled import SUPPORTED_K

    # knn.cu, naive.cu and fused.cu take their switch cases from the one list
    # of aidw_common.cuh, which SUPPORTED_K reads; no source names a k itself
    header = (_build.CSRC / "aidw_common.cuh").read_text()
    listed = re.search(r"#define AIDW_K_LIST\(X\)(.*)", header).group(1)
    assert SUPPORTED_K == tuple(int(k) for k in re.findall(r"X\((\d+)\)", listed)) == tuple(range(1, 17))
    for lib, case in (("knn", "AIDW_K_CASE"), ("naive", "AIDW_NAIVE_CASE"), ("fused", "AIDW_FUSED_CASE")):
        src = (_build.CSRC / _build.SOURCES[lib]).read_text()
        assert f"AIDW_K_LIST({case})" in src, lib
        assert not re.findall(rf"{case}\(\d+\)", src), lib
    for lib in ("knn", "weight", "naive"):
        text = (_build.CSRC / _build.SOURCES[lib]).read_text()
        assert '#include "aoas.cuh"' in text and "powf(" not in text
    assert {"naive_soa", "naive_aoas", "knn_aoas", "weight_aoas", "knn_binned"} <= set(_build.LAUNCHES)
