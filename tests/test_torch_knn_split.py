"""The split and grouped kNN walk of ``csrc/knn.cu`` on the CPU.

The kernel (B1, B3, B9, B12 and the binned prefilter) lets S threads share a
query: each sweeps its part of every stage of the row (``kernels/aidw_tiled.py:
knn_part``), and the S sorted k-best arrays are merged at the end; inside a
part it takes ``KNN_GROUP`` points at a time behind one compare of their
minimum.  Alpha keeps its bits only because the k-best set (the k smallest
d^2, duplicates kept, +inf and NaN never entering) does not depend on the
order of its inputs.  The kernel runs only on the card (``chip_smoke.py``
phases 2, 20, 25 and 31 hold it bitwise against its plain version); here:

* the k-best of a row equals the ``merge_k_best`` fold of S partial k-bests,
  split at the kernel's part boundaries inside each stage or bin, bit for
  bit, and so does ``alpha_from_best`` and the plain version
  ``knn_alpha_plain``, on rows with ties, duplicates at the k-th value,
  +inf sentinels, exact hits and a NaN query; the whole-row k-best is
  JAX's ``merge_k_best`` bit for bit and its alpha within the port's
  tolerances (1e-6 in float32, 1e-12 in float64);
* the launch rule ``knn_launch`` gives legal shapes for every ``block_q``;
* the wrappers take the plain version on CPU tensors, refuse a k outside
  ``AIDW_K_LIST`` before any launch, and pass the rule's threads and S to
  the kernel.
"""

import math
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidw import AIDWParams as JParams
from repro.kernels import _common as j_common
from repro_torch.core.aidw import AIDWParams
from repro_torch.core.layouts import soa_to_aoas
from repro_torch.kernels import _build, aidw_tiled, aidw_tiled_v2
from repro_torch.kernels._common import alpha_from_best, merge_k_best, sq_dist_tile
from repro_torch.kernels.aidw_tiled import (
    KNN_GROUP,
    KNN_STAGE_BYTES,
    knn_alpha,
    knn_alpha_aoas,
    knn_alpha_plain,
    knn_launch,
    knn_part,
    knn_stage_points,
)
from repro_torch.kernels.aidw_tiled_v2 import knn_alpha_v2
from test_torch_core import enable_x64

DTYPES = [np.float32, np.float64]
ALPHA_TOL = {np.float32: 1e-6, np.float64: 1e-12}
K = 10
M = 1536       # 1.5 float32 stages, 3 float64 stages
TILE = 128     # the plain version's tile
SUB = 16       # a bin of the binned prefilter: 8 bins a tile
N = 24


def _row(dtype):
    """Queries and one sentinel-padded data row on a coarse grid: many equal
    d^2, points repeated so that ties fall at the k-th value, exact hits,
    a NaN query."""
    rng = np.random.default_rng(31)
    dx = (rng.integers(0, 12, M) / 8).astype(dtype)
    dy = (rng.integers(0, 12, M) / 8).astype(dtype)
    dx[600:640], dy[600:640] = dx[100], dy[100]  # 40 copies of one point
    dx[1400:1460] = dy[1400:1460] = np.finfo(dtype).max / 4  # sentinels: d^2 = +inf
    dx[200:260] = dy[200:260] = np.finfo(dtype).max / 4
    qx = (rng.integers(0, 12, N) / 8).astype(dtype)
    qy = (rng.integers(0, 12, N) / 8).astype(dtype)
    qx[0], qy[0] = dx[100], dy[100]  # sits on the repeated point
    qx[1], qy[1] = dx[7], dy[7]
    qx[3] = np.nan
    return qx, qy, dx, dy


def _bins(d2, sub):
    return d2 if sub == 1 else d2.reshape(d2.shape[0], -1, sub).amin(dim=2)


def _split_best(d2, stage, splits, sub):
    """knn.cu's walk: each stage of ``stage`` points cut into ``splits``
    parts (``knn_part``, a part a whole number of bins of ``sub``), each
    part's points (or bin minima) folded into its own k-best, then the parts'
    k-bests folded into part 0's."""
    n = d2.shape[0]
    parts = [torch.full((n, K), math.inf, dtype=d2.dtype) for _ in range(splits)]
    for base in range(0, d2.shape[1], stage):
        cnt = min(stage, d2.shape[1] - base)
        for p in range(splits):
            lo, hi = knn_part(cnt, splits, p, sub if sub > 1 else KNN_GROUP)
            if hi > lo:
                parts[p] = merge_k_best(parts[p], _bins(d2[:, base + lo:base + hi], sub))
    best = parts[0]
    for other in parts[1:]:
        best = merge_k_best(best, other)
    return best


@pytest.mark.parametrize("binned", [False, True], ids=["stage", "bin"])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_k_best_is_the_whole_rows(dtype, splits, binned):
    qx, qy, dx, dy = (torch.as_tensor(a) for a in _row(dtype))
    d2 = sq_dist_tile(qx[:, None], qy[:, None], dx[None], dy[None])
    sub = SUB if binned else 1
    whole = merge_k_best(torch.full((N, K), math.inf, dtype=d2.dtype), _bins(d2, sub))
    params = AIDWParams(k=K, area=1.0)
    a_whole = alpha_from_best(whole, M, 1.0, params)[:, 0]
    a_plain = knn_alpha_plain(qx, qy, dx[None], dy[None], block_q=N, tile_d=TILE, nbins=TILE // sub if binned else 0,
                              params=params, area=1.0, m_real=M)
    # the rows hold what the check needs: ties at the k-th value, sentinels, a NaN query
    live = whole[~torch.isnan(qx)]
    assert bool((live[:, -1] == live[:, -2]).any()) and bool(torch.isinf(d2).any())
    assert binned or bool((whole[0] == 0).all())  # 41 exact hits fill the k-best
    assert bool(torch.isinf(whole[3]).all())  # NaN never enters
    for stage in (96, knn_stage_points(torch.float32 if dtype == np.float32 else torch.float64)):
        best = _split_best(d2, stage, splits, sub)
        assert torch.equal(best, whole), (stage, splits)
        a = alpha_from_best(best, M, 1.0, params)[:, 0]
        torch.testing.assert_close(a, a_whole, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(a, a_plain, rtol=0, atol=0, equal_nan=True)
    # the whole row against the JAX package (its merge lets a NaN query's NaN in; the port keeps +inf)
    ok = ~np.isnan(_row(dtype)[0])
    with enable_x64(dtype == np.float64):
        d2_j = j_common.sq_dist_tile(*(jnp.asarray(a) for a in (qx[:, None].numpy(), qy[:, None].numpy(),
                                                                 dx[None].numpy(), dy[None].numpy())))
        if binned:
            d2_j = d2_j.reshape(N, -1, SUB).min(axis=2)
        best_j = j_common.merge_k_best(jnp.full((N, K), jnp.inf, d2_j.dtype), d2_j, data_axis=1)
        alpha_j = j_common.alpha_from_best(best_j, M, 1.0, JParams(k=K, area=1.0), data_axis=1)
    np.testing.assert_array_equal(whole.numpy()[ok], np.asarray(best_j)[ok])
    np.testing.assert_allclose(a_whole.numpy()[ok], np.asarray(alpha_j)[ok, 0], rtol=0, atol=ALPHA_TOL[dtype])


def test_a_lost_part_moves_alpha():
    """The control of the bitwise check: a walk that drops the last of four
    parts of every stage gives other alphas."""
    qx, qy, dx, dy = (torch.as_tensor(a) for a in _row(np.float32))
    d2 = sq_dist_tile(qx[:, None], qy[:, None], dx[None], dy[None])
    stage = 96
    lost = d2.clone()
    for base in range(0, M, stage):
        lo, hi = knn_part(min(stage, M - base), 4, 3)
        lost[:, base + lo:base + hi] = math.inf
    params = AIDWParams(k=K, area=1.0)
    a = alpha_from_best(_split_best(d2, stage, 4, 1), M, 1.0, params)
    a_lost = alpha_from_best(_split_best(lost, stage, 4, 1), M, 1.0, params)
    assert int((a != a_lost).sum()) > 0


@pytest.mark.parametrize("cnt,splits,unit", [(2048, 4, 8), (100, 3, 8), (2048, 4, 48), (17, 8, 8), (0, 2, 8),
                                             (1024, 2, 16)])
def test_parts_cover_a_stage_once(cnt, splits, unit):
    ranges = [knn_part(cnt, splits, p, unit) for p in range(splits)]
    covered = [i for lo, hi in ranges for i in range(lo, hi)]
    assert covered == list(range(cnt))
    assert all(lo % unit == 0 for lo, hi in ranges if hi > lo)


def test_stage_and_group_match_the_sources():
    knn = (_build.CSRC / "knn.cu").read_text()
    common = (_build.CSRC / "aidw_common.cuh").read_text()
    assert re.search(r"constexpr int kKnnStageBytes = (\d+) \* 1024;", common).group(1) == str(KNN_STAGE_BYTES // 1024)
    assert re.search(r"constexpr int kKnnGroup = (\d+);", common).group(1) == str(KNN_GROUP)
    assert knn_stage_points(torch.float32) == 2048 and knn_stage_points(torch.float64) == 1024
    # every pair of the walk goes through knn_span's group, whose insertion stays behind one compare
    assert knn.count("knn_span<T, K,") == 2 and "kbest_insert(best, d2[u])" in common
    assert "if (MIN ? gmin < best[K - 1] : any_below(d2, best[K - 1]))" in common


BLOCK_QS = (8, 16, 32, 64, 128, 256, 512)


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("block_q", BLOCK_QS)
def test_knn_launch_rule(block_q, sms):
    for n in sorted({block_q, 2048, 8192, 65536, 1 << 20}):
        if n % block_q:
            continue
        for vote in (False, True):
            for bin_points in (0, 4, 16, 32, 12, 2048):
                threads, s = knn_launch(n, sms, block_q=block_q, vote=vote, bin_points=bin_points)
                q_cta = threads // s
                assert 0 < threads <= 1024 and threads % s == 0 and s in (1, 2, 4)
                assert block_q % q_cta == 0 and n % q_cta == 0  # a CUDA block inside one plan block (one row)
                if vote or bin_points in (12, 2048):
                    assert s == 1  # the vote's tau depends on order; a bin must not straddle a part
                if s > 1:
                    assert q_cta % 32 == 0 or q_cta == block_q  # a warp's lanes sweep one part
                    assert n * s // 2 < 768 * sms  # S doubles only while the batch is short of threads
    # on an H100 the serving batch takes two threads a query, a short batch four, 2^20 queries one
    assert knn_launch(65536, 132) == (256, 2) and knn_launch(2048, 132) == (256, 4)
    assert knn_launch(1 << 20, 132) == (256, 1)


def _knn_entries():
    src = (_build.CSRC / "knn.cu").read_text()
    for macro, names in (("AIDW_KNN_ENTRY", ("aidw_knn_alpha_f32", "aidw_knn_alpha_f64")),
                         ("AIDW_KNN_AOAS_ENTRY", ("aidw_knn_alpha_aoas_f32", "aidw_knn_alpha_aoas_f64")),
                         ("AIDW_KNN_V2_ENTRY", ("aidw_knn_alpha_v2_f32", "aidw_knn_alpha_v2_f64"))):
        sig = re.search(rf"#define {macro}\(NAME, T\).*?NAME\((.*?)\)\s*\{{", src, re.S).group(1)
        params = [p.strip() for p in sig.replace("\\", " ").split(",")]
        yield params, names


def test_knn_entry_points_match_their_signatures():
    for params, names in _knn_entries():
        assert [p.split()[-1] for p in params].index("splits") == [p.split()[-1] for p in params].index("threads") + 1
        kinds = ["p" if "*" in p else "d" if p.startswith("double") else "l" if p.startswith("long long") else "i"
                 for p in params]
        for name in names:
            got = ["p" if a is _build._P else "d" if a is _build._D else "l" if a is _build.ctypes.c_longlong
                   else "i" for a in _build.ENTRY_POINTS[name][1]]
            assert got == kinds, name


def _pretend_card(monkeypatch):
    """The card path of the kNN wrappers on CPU tensors: every tensor counts
    as on the card, the SM count is an H100's, and the kernel entries record
    their arguments in the returned list."""
    calls = []
    for module in (aidw_tiled, aidw_tiled_v2):
        monkeypatch.setattr(module, "_on_card", lambda name, *t: True)
    monkeypatch.setattr(aidw_tiled, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "entry", lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def _inputs(n=512, m=1024):
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.random(n).astype(np.float32))
    d = torch.as_tensor(rng.random(m).astype(np.float32))
    return q, d


def test_wrappers_plain_on_cpu_and_k_refused_before_a_launch(monkeypatch):
    q, d = _inputs()
    params = AIDWParams(k=K, area=1.0)
    kw = dict(block_q=256, tile_d=128, params=params, area=1.0, m_real=1024)
    before = dict(_build.LAUNCHES)
    a = knn_alpha(q, q, d[None], d[None], **kw)
    assert torch.equal(a, knn_alpha_plain(q, q, d[None], d[None], **kw)) and _build.LAUNCHES == before
    # on the card a k outside AIDW_K_LIST raises before the kernel's entry is reached
    calls = _pretend_card(monkeypatch)
    far = dict(kw, params=AIDWParams(k=17, area=1.0))
    aoas = soa_to_aoas(d, d, d)
    for run in (lambda: knn_alpha(q, q, d[None], d[None], **far), lambda: knn_alpha_aoas(q, q, aoas, **far),
                lambda: knn_alpha_v2(q, q, d, d, **far)):
        with pytest.raises(ValueError, match=r"k in 1\.\.16"):
            run()
    assert calls == []


def test_wrappers_pass_the_launch_rule(monkeypatch):
    calls = _pretend_card(monkeypatch)
    q, d = _inputs()
    params = AIDWParams(k=K, area=1.0)
    kw = dict(block_q=256, tile_d=128, params=params, area=1.0, m_real=1024)
    knn_alpha(q, q, d[None], d[None], **kw)
    knn_alpha(q, q, d[None], d[None], nbins=8, **kw)
    knn_alpha_aoas(q, q, soa_to_aoas(d, d, d), **kw)
    knn_alpha_v2(q, q, d, d, **kw)
    rule = knn_launch(512, 132, block_q=256)
    assert rule[1] == 4
    got = {name: args for name, args in calls}
    assert got["aidw_knn_alpha_f32"][12:14] == rule  # threads, splits after k
    assert got["aidw_knn_alpha_aoas_f32"][8:10] == rule
    assert got["aidw_knn_alpha_v2_f32"][9:11] == knn_launch(512, 132, block_q=256, vote=True) == (256, 1)
    assert _build.LAUNCHES["knn_soa"] == 1 and _build.LAUNCHES["knn_binned"] == 1
    assert _build.LAUNCHES["knn_aoas"] == 1 and _build.LAUNCHES["knn_v2"] == 1
