"""The split walk and the ordered tile fold of ``csrc/naive.cu`` on the CPU.

The naive kernel (B7 SoA, B8 AoaS) lets S threads of a CUDA block share a
query, one warp-aligned part each (``kernels/aidw_naive.py: naive_launch``).
In the kNN pass part p takes the groups p, p + S, ... of ``KNN_GROUP``
points (``naive_part``), and every part inserts the other parts' k-bests, taken
through shared memory; alpha keeps its bits only because the k-best set
does not depend on the order of its inputs.  In the weight pass part p sums
the tiles p, p + S, ... of each round from 0, and every thread folds the
round's S tile sums and first minima in tile order; z keeps its bits only
because that is the order of one thread sweeping the row.  The kernel runs
only on the card (``chip_smoke.py`` phases 20-24 and 35 hold it bitwise
against its plain version and the tiled kernels); here:

* the S partial k-bests of ``naive_part``'s split, each part merging the
  others', equal the whole row's k-best bit for bit, and so does alpha and
  the plain version's, on rows with ties, duplicates at the k-th value,
  +inf sentinels, exact hits and a NaN query; the whole row against JAX's
  ``merge_k_best``/``alpha_from_best``;
* the round-by-round fold of the tile sums and minima gives the plain
  version's z bit for bit, and a fold that takes one round out of order
  does not;
* the launch rule ``naive_launch`` gives legal shapes;
* the wrappers take the plain version on CPU tensors, refuse a k outside
  ``AIDW_K_LIST`` and misaligned SoA data before any launch, and pass the
  rule's threads and S to the kernel;
* ``naive.cu`` stages no data in shared memory and walks ``kKnnGroup``
  points a step.
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
from repro_torch.kernels import _build, aidw_naive
from repro_torch.kernels._common import alpha_from_best, merge_k_best, pow_weight, sq_dist_tile
from repro_torch.kernels.aidw_naive import (
    aidw_naive_aoas,
    aidw_naive_soa,
    aidw_naive_soa_plain,
    naive_launch,
    naive_part,
)
from repro_torch.kernels.aidw_tiled import KNN_GROUP, check_soa_aligned
from test_torch_core import enable_x64
from test_torch_knn_split import ALPHA_TOL, DTYPES, K, M, N, TILE, _row

SPLITS = [1, 2, 4, 8]


def _merged(parts):
    """The kernel's merge: every part inserts the other parts' k-bests in
    part order; returns every part's array."""
    out = []
    for p, best in enumerate(parts):
        for other in parts[:p] + parts[p + 1:]:
            best = merge_k_best(best, other)
        out.append(best)
    return out


@pytest.mark.parametrize("short", [0, 5, 11], ids=["whole_groups", "short_group", "short_group_11"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_k_best_is_the_whole_rows(dtype, splits, short):
    qx, qy, dx, dy = (torch.as_tensor(a) for a in _row(dtype))
    m = M - short  # a row whose last group is short
    dx, dy = dx[:m], dy[:m]
    d2 = sq_dist_tile(qx[:, None], qy[:, None], dx[None], dy[None])
    inf = torch.full((N, K), math.inf, dtype=d2.dtype)
    whole = merge_k_best(inf, d2)
    params = AIDWParams(k=K, area=1.0)
    a_whole = alpha_from_best(whole, m, 1.0, params)[:, 0]
    # the rows hold what the check needs: ties at the k-th value, sentinels, exact hits, a NaN query
    live = whole[~torch.isnan(qx)]
    assert bool((live[:, -1] == live[:, -2]).any()) and bool(torch.isinf(d2).any())
    assert bool((whole[0] == 0).all()) and bool(torch.isinf(whole[3]).all())
    taken = [naive_part(m, splits, p) for p in range(splits)]
    assert torch.equal(torch.sort(torch.cat(taken)).values, torch.arange(m))  # every point once
    for part, best in enumerate(_merged([merge_k_best(inf, d2[:, idx]) for idx in taken])):
        assert torch.equal(best, whole), (splits, part)
        a = alpha_from_best(best, m, 1.0, params)[:, 0]
        torch.testing.assert_close(a, a_whole, rtol=0, atol=0, equal_nan=True)
    if not short:  # the plain version takes whole tiles
        dz = torch.zeros_like(dx)
        _, a_plain = aidw_naive_soa_plain(dx, dy, dz, qx, qy, params=params, area=1.0, m_real=m, block_d=TILE)
        torch.testing.assert_close(a_plain, a_whole, rtol=0, atol=0, equal_nan=True)
    # the whole row against the JAX package (its merge lets a NaN query's NaN in; the port keeps +inf)
    ok = ~torch.isnan(qx).numpy()
    with enable_x64(dtype == np.float64):
        d2_j = j_common.sq_dist_tile(*(jnp.asarray(a) for a in (qx[:, None].numpy(), qy[:, None].numpy(),
                                                                 dx[None].numpy(), dy[None].numpy())))
        best_j = j_common.merge_k_best(jnp.full((N, K), jnp.inf, d2_j.dtype), d2_j, data_axis=1)
        alpha_j = j_common.alpha_from_best(best_j, m, 1.0, JParams(k=K, area=1.0), data_axis=1)
    np.testing.assert_array_equal(whole.numpy()[ok], np.asarray(best_j)[ok])
    np.testing.assert_allclose(a_whole.numpy()[ok], np.asarray(alpha_j)[ok, 0], rtol=0, atol=ALPHA_TOL[dtype])


def test_a_lost_group_moves_alpha():
    """The control of the bitwise check: a walk whose last part of four
    loses its points gives other alphas."""
    qx, qy, dx, dy = (torch.as_tensor(a) for a in _row(np.float32))
    d2 = sq_dist_tile(qx[:, None], qy[:, None], dx[None], dy[None])
    inf = torch.full((N, K), math.inf, dtype=d2.dtype)
    params = AIDWParams(k=K, area=1.0)
    parts = [merge_k_best(inf, d2[:, naive_part(M, 4, p)]) for p in range(4)]
    a = alpha_from_best(_merged(parts)[0], M, 1.0, params)
    a_lost = alpha_from_best(_merged(parts[:3] + [inf])[0], M, 1.0, params)
    assert int((a != a_lost).sum()) > 0


def _fold_inputs(dtype):
    """Random data over 12 tiles, queries with an exact hit and a NaN, and the
    plain version's alpha."""
    rng = np.random.default_rng(23)
    m, n = 12 * TILE, 64
    dx, dy, dz = (torch.as_tensor(rng.random(m).astype(dtype)) for _ in range(3))
    qx, qy = (torch.as_tensor(rng.random(n).astype(dtype)) for _ in range(2))
    qx[0], qy[0] = dx[700], dy[700]
    qx[5] = math.nan
    params = AIDWParams(k=K, area=1.0)
    z, alpha = aidw_naive_soa_plain(dx, dy, dz, qx, qy, params=params, area=1.0, m_real=m, block_d=TILE)
    return (dx, dy, dz, qx, qy), params, z, alpha


def _lane_fold(dx, dy, dz, qx, qy, alpha, splits, eps, swap_round=None):
    """The kernel's weight pass: each tile's sums and first minimum from 0 (as
    the plain version sums a tile), folded round by round, the round's S
    tiles (one a part) in tile order; ``swap_round`` folds that round's
    tiles backwards."""
    d2 = sq_dist_tile(qx[:, None], qy[:, None], dx[None], dy[None])
    w = pow_weight(d2, alpha[:, None] * 0.5)
    n, m = d2.shape
    tiles = m // TILE
    tile_w = w.reshape(n, tiles, TILE).sum(dim=2)
    tile_wz = (w * dz[None]).reshape(n, tiles, TILE).sum(dim=2)
    tile_min, first = torch.min(d2.reshape(n, tiles, TILE), dim=2)
    tile_z = dz.reshape(tiles, TILE).gather(1, first.T).T
    sum_w, sum_wz = torch.zeros_like(qx), torch.zeros_like(qx)
    min_d2, hit_z = torch.full_like(qx, math.inf), torch.zeros_like(qx)
    for r in range(0, tiles, splits):
        order = [r + s for s in range(splits) if r + s < tiles]
        for t in (order[::-1] if r // splits == swap_round else order):
            sum_w = sum_w + tile_w[:, t]
            sum_wz = sum_wz + tile_wz[:, t]
            better = tile_min[:, t] < min_d2
            min_d2 = torch.where(better, tile_min[:, t], min_d2)
            hit_z = torch.where(better, tile_z[:, t], hit_z)
    return torch.where(min_d2 <= eps, hit_z, sum_wz / sum_w)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_fold_gives_the_plain_z(dtype, splits):
    data, params, z_plain, alpha = _fold_inputs(dtype)
    z = _lane_fold(*data, alpha, splits, params.exact_hit_eps)
    torch.testing.assert_close(z, z_plain, rtol=0, atol=0, equal_nan=True)
    assert float(z[0]) == float(data[2][700])  # the exact hit takes its point's z


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_round_out_of_order_moves_z(dtype):
    """The control of the bitwise fold: folding the second round's four tiles
    backwards moves z."""
    data, params, z_plain, alpha = _fold_inputs(dtype)
    z = _lane_fold(*data, alpha, 4, params.exact_hit_eps, swap_round=1)
    live = ~torch.isnan(z_plain)
    assert int((z[live] != z_plain[live]).sum()) > 0


BLOCK_QS = (8, 16, 32, 64, 128, 256, 512)


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("block_q", BLOCK_QS)
def test_naive_launch_rule(block_q, sms):
    for n in sorted({block_q, 2048, 8192, 65536, 1 << 20}):
        if n % block_q:
            continue
        threads, s = naive_launch(n, sms)
        assert threads == (256 if n * s >= 256 * sms else 128) and s in (1, 2, 4)
        assert threads % s == 0 and (threads // s) % 32 == 0  # a warp works on one part
        assert s == 1 or n * s // 2 < 8192 * sms  # S doubles only while the batch is short of threads
        assert s == 4 or n * s >= 8192 * sms
    # on an H100 a short batch and the serving batch take four threads a query, 2^20 queries two
    assert naive_launch(8192, 132) == (128, 4)
    assert naive_launch(65536, 132) == (256, 4)
    assert naive_launch(1 << 20, 132) == (256, 2)


def test_naive_sources_stage_nothing_and_walk_groups():
    code = re.sub(r"//[^\n]*", "", (_build.CSRC / "naive.cu").read_text())
    common = re.sub(r"//[^\n]*", "", (_build.CSRC / "aidw_common.cuh").read_text())
    # shared memory holds only the parts' k-bests and tile sums: no staged data
    assert code.count("__shared__") == 1 and "cp_async" not in code and "load_group" not in code
    assert re.search(r"part_sums\[[^\]]*\] = best\[j\]", code) and "buf[(4 * part) * qc + qi] = tw;" in code
    assert code.count("knn_rows(") == 1 and code.count("weight_tile(") == 1
    walk = re.search(r"void knn_rows\(.*?\n\}", common, re.S).group(0)
    assert "constexpr int G = kKnnGroup;" in walk and "knn_group<T, K, G, true, false>(" in walk
    assert "kbest_insert" in code  # the parts' k-bests merged with the insertion
    assert "fetch_xy(rows, g * G, x, y);" in walk
    # SoA points come as 16-byte vectors: load_group for whole groups
    soa_xy = re.search(r"void fetch_xy\(const SoaRows<T>& r.*?\n\}", common, re.S).group(0)
    soa_xyz = re.search(r"void fetch_xyz\(const SoaRows<T>& r.*?\n\}", common, re.S).group(0)
    assert "load_group(r.x + j, x)" in soa_xy and "load_group(r.y + j, y)" in soa_xy
    assert "fetch_xy(r, j, x, y)" in soa_xyz and "load_group(r.z + j, z)" in soa_xyz
    assert re.search(r"constexpr int kKnnGroup = (\d+);", common).group(1) == str(KNN_GROUP)


def test_naive_entry_points_match_their_signatures():
    src = (_build.CSRC / "naive.cu").read_text()
    for macro, names in (("AIDW_NAIVE_SOA_ENTRY", ("aidw_naive_soa_f32", "aidw_naive_soa_f64")),
                         ("AIDW_NAIVE_AOAS_ENTRY", ("aidw_naive_aoas_f32", "aidw_naive_aoas_f64"))):
        sig = re.search(rf"#define {macro}\(NAME, T\).*?NAME\((.*?)\)\s*\{{", src, re.S).group(1)
        params = [p.strip() for p in sig.replace("\\", " ").split(",")]
        names_in = [p.split()[-1] for p in params]
        assert names_in.index("splits") == names_in.index("threads") + 1
        kinds = ["p" if "*" in p else "d" if p.startswith("double") else "i" for p in params]
        for name in names:
            got = ["p" if a is _build._P else "d" if a is _build._D else "i" for a in _build.ENTRY_POINTS[name][1]]
            assert got == kinds, name


def _pretend_card(monkeypatch):
    """The card path of the naive wrappers on CPU tensors: every tensor counts
    as on the card, the SM count is an H100's, and the kernel entries record
    their arguments in the returned list."""
    calls = []
    monkeypatch.setattr(aidw_naive, "_on_card", lambda name, *t: True)
    monkeypatch.setattr(aidw_naive, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "entry", lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def _inputs(n=512, m=1024):
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.random(n).astype(np.float32))
    d = torch.as_tensor(rng.random(m + 4).astype(np.float32))
    return q, d[:m]


def test_wrappers_plain_on_cpu_and_refusals_before_a_launch(monkeypatch):
    q, d = _inputs()
    kw = dict(params=AIDWParams(k=K, area=1.0), area=1.0, m_real=1024, block_q=64, block_d=128)
    before = dict(_build.LAUNCHES)
    z, a = aidw_naive_soa(d, d, d, q, q, **kw)
    z_p, a_p = aidw_naive_soa_plain(d, d, d, q, q, params=kw["params"], area=1.0, m_real=1024, block_d=128)
    assert torch.equal(z, z_p) and torch.equal(a, a_p) and _build.LAUNCHES == before
    calls = _pretend_card(monkeypatch)
    # a k outside AIDW_K_LIST raises before the kernel's entry is reached
    far = dict(kw, params=AIDWParams(k=17, area=1.0))
    for run in (lambda: aidw_naive_soa(d, d, d, q, q, **far), lambda: aidw_naive_aoas(soa_to_aoas(d, d, d), q, q, **far)):
        with pytest.raises(ValueError, match=r"k in 1\.\.16"):
            run()
    # SoA data that does not start on a 16-byte boundary is refused: the kernel reads 16-byte vectors
    full = torch.zeros(1024 + 4)
    sliced = full[1:1025]
    assert sliced.is_contiguous() and sliced.data_ptr() % 16
    for args in ((sliced, d, d), (d, sliced, d), (d, d, sliced)):
        with pytest.raises(ValueError, match="aligned to 16 bytes"):
            aidw_naive_soa(*args, q, q, **kw)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        check_soa_aligned("naive", d, sliced)
    check_soa_aligned("naive", d, full[4:1028])
    assert calls == []


def test_wrappers_pass_the_launch_rule(monkeypatch):
    calls = _pretend_card(monkeypatch)
    q, d = _inputs()
    kw = dict(params=AIDWParams(k=K, area=1.0), area=1.0, m_real=1024, block_q=64, block_d=128)
    aidw_naive_soa(d, d, d, q, q, **kw)
    aidw_naive_aoas(soa_to_aoas(d, d, d), q, q, **kw)
    rule = naive_launch(512, 132)
    assert rule == (128, 4)
    got = {name: args for name, args in calls}
    assert got["aidw_naive_soa_f32"][5:11] == (512, 1024, 128, K, *rule)  # n, m, tile_d, k, threads, splits
    assert got["aidw_naive_aoas_f32"][3:9] == (512, 1024, 128, K, *rule)
    assert _build.LAUNCHES["naive_soa"] == 1 and _build.LAUNCHES["naive_aoas"] == 1
