"""The split walk and the ordered tile fold of ``csrc/fused.cu`` on the CPU.

The fused kernel (B11) lets S threads of a CUDA block share a query, one
warp-aligned part each (``kernels/aidw_fused.py: fused_launch``).  In the kNN
pass part p sweeps its slice of every stage of the row, cut as ``knn.cu``
cuts it (``fused_part``), and every part inserts the other parts' k-bests,
taken through shared memory; alpha keeps its bits only because the k-best
set does not depend on the order of its inputs.  In the weight pass part p
sums the tiles p, p + S, ... of each round from 0, and every thread folds
the round's S tile sums and first minima in tile order; z keeps its bits
only because that is the order of one thread sweeping the row.  The kernel
runs only on the card (``chip_smoke.py`` phases 25, 26 and 36 hold it
bitwise against ``knn.cu`` and ``weight.cu`` at S = 1, 2 and 4); here:

* the S partial k-bests of ``fused_part``'s split, each part merging the
  others', equal the whole row's k-best bit for bit, and so does alpha and
  the plain version's, on rows with ties, duplicates at the k-th value, +inf
  sentinels, an exact hit and a NaN query; the whole row against JAX's
  ``merge_k_best``/``alpha_from_best`` and, with the fold below, against the
  Pallas fused kernel in interpret mode; a lost part moves alpha;
* the round-by-round fold of the tile sums and minima, stage by stage, gives
  ``weight_sweep_plain``'s z bit for bit, and a fold that takes one round out
  of order does not;
* the launch rule ``fused_launch`` gives legal shapes, and the kernel's
  shared memory (``fused_shared_bytes``) fits the card;
* the wrapper takes the plain version on CPU tensors, refuses a k outside
  ``AIDW_K_LIST`` before any launch, and passes the rule's threads and S to
  the kernel through the ``extern "C"`` signature;
* ``fused.cu`` stages with cp.async, walks with ``knn_span``, reads staged
  ``{x, y, z, pad}`` vectors, and has no ``powf``, no atomics and no 48 KiB
  cap.
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
from repro.kernels.aidw_fused import aidw_fused_soa as j_fused
from repro_torch.core.aidw import AIDWParams
from repro_torch.kernels import _build, aidw_fused
from repro_torch.kernels._common import alpha_from_best, merge_k_best, sq_dist_tile, weight_tile
from repro_torch.kernels.aidw_fused import STAGE_BYTES, aidw_fused_soa, aidw_fused_soa_plain, fused_launch, fused_part
from repro_torch.kernels.aidw_tiled import KNN_GROUP, KNN_STAGE_BYTES, knn_stage_points, weight_sweep_plain
from test_torch_core import enable_x64
from test_torch_knn_split import ALPHA_TOL, DTYPES, K, M, N, TILE, _row

SPLITS = [1, 2, 4, 8]
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


# csrc/aidw_common.cuh: kMaxSharedBytes, a block's dynamic shared memory on sm_90
MAX_SHARED_BYTES = 227 * 1024


def fused_stage_points(splits, block_d, dtype):
    """Points of a weight-pass stage of ``csrc/fused.cu`` (its
    ``shared_bytes``): whole rounds of ``splits`` tiles of ``block_d`` points
    of 4 values, ``STAGE_BYTES`` of them, or one round where a round is
    larger."""
    round_bytes = splits * block_d * 4 * (torch.finfo(dtype).bits // 8)
    return max(1, STAGE_BYTES // round_bytes) * splits * block_d


def fused_shared_bytes(threads, splits, block_d, k, dtype):
    """Dynamic shared memory of a launch of ``csrc/fused.cu`` (its
    ``shared_bytes``): the largest of pass 1's two kNN stages, the parts'
    k-bests (S > 1) and pass 2's stage with its two round buffers (S > 1)."""
    size = torch.finfo(dtype).bits // 8
    qc = threads // splits
    merge = splits * k * qc * size if splits > 1 else 0
    weight = (4 * fused_stage_points(splits, block_d, dtype) + (8 * splits * qc if splits > 1 else 0)) * size
    return max(2 * KNN_STAGE_BYTES, merge, weight)


def _merged(parts):
    """The kernel's merge: every part inserts the other parts' k-bests in
    part order; returns every part's array."""
    out = []
    for p, best in enumerate(parts):
        for other in parts[:p] + parts[p + 1:]:
            best = merge_k_best(best, other)
        out.append(best)
    return out


def _row_d2(dtype):
    qx, qy, dx, dy = (torch.as_tensor(a) for a in _row(dtype))
    return qx, qy, dx, dy, sq_dist_tile(qx[:, None], qy[:, None], dx[None], dy[None])


@pytest.mark.parametrize("stage", ["short", "kernel"])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_k_best_is_the_whole_rows(dtype, splits, stage):
    qx, qy, dx, dy, d2 = _row_d2(dtype)
    stage_d = 96 if stage == "short" else knn_stage_points(TORCH[dtype])  # M = 1.5 float32 stages, 3 float64
    inf = torch.full((N, K), math.inf, dtype=d2.dtype)
    whole = merge_k_best(inf, d2)
    params = AIDWParams(k=K, area=1.0)
    a_whole = alpha_from_best(whole, M, 1.0, params)[:, 0]
    # the row holds what the check needs: ties at the k-th value, sentinels, an exact hit, a NaN query
    live = whole[~torch.isnan(qx)]
    assert bool((live[:, -1] == live[:, -2]).any()) and bool(torch.isinf(d2).any())
    assert bool((whole[0] == 0).all()) and bool(torch.isinf(whole[3]).all())
    taken = [fused_part(M, stage_d, splits, p) for p in range(splits)]
    assert torch.equal(torch.sort(torch.cat(taken)).values, torch.arange(M))  # every point once
    for p, idx in enumerate(taken):  # each stage's slice starts on a group: its loads are vectors
        starts = idx[torch.cat([torch.tensor([True]), idx[1:] != idx[:-1] + 1])] if len(idx) else idx
        assert bool(((starts % stage_d) % KNN_GROUP == 0).all()), (splits, p)
    for part, best in enumerate(_merged([merge_k_best(inf, d2[:, idx]) for idx in taken])):
        assert torch.equal(best, whole), (splits, part)
        a = alpha_from_best(best, M, 1.0, params)[:, 0]
        torch.testing.assert_close(a, a_whole, rtol=0, atol=0, equal_nan=True)
    _, a_plain = aidw_fused_soa_plain(dx, dy, torch.zeros_like(dx), qx, qy, params=params, area=1.0, m_real=M,
                                      block_q=N, block_d=TILE)
    torch.testing.assert_close(a_plain, a_whole, rtol=0, atol=0, equal_nan=True)
    # the whole row against the JAX package (its merge lets a NaN query's NaN in; the port keeps +inf)
    ok = ~torch.isnan(qx).numpy()
    with enable_x64(dtype == np.float64):
        d2_j = j_common.sq_dist_tile(*(jnp.asarray(a) for a in (qx[:, None].numpy(), qy[:, None].numpy(),
                                                                 dx[None].numpy(), dy[None].numpy())))
        best_j = j_common.merge_k_best(jnp.full((N, K), jnp.inf, d2_j.dtype), d2_j, data_axis=1)
        alpha_j = j_common.alpha_from_best(best_j, M, 1.0, JParams(k=K, area=1.0), data_axis=1)
    np.testing.assert_array_equal(whole.numpy()[ok], np.asarray(best_j)[ok])
    np.testing.assert_allclose(a_whole.numpy()[ok], np.asarray(alpha_j)[ok, 0], rtol=0, atol=ALPHA_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_lost_part_moves_alpha(dtype):
    """The control of the bitwise check: a walk whose last part of four
    loses its points gives other alphas."""
    qx, _, _, _, d2 = _row_d2(dtype)
    inf = torch.full((N, K), math.inf, dtype=d2.dtype)
    params = AIDWParams(k=K, area=1.0)
    stage_d = knn_stage_points(TORCH[dtype])
    parts = [merge_k_best(inf, d2[:, fused_part(M, stage_d, 4, p)]) for p in range(4)]
    a = alpha_from_best(_merged(parts)[0], M, 1.0, params)
    a_lost = alpha_from_best(_merged(parts[:3] + [inf])[0], M, 1.0, params)
    assert int((a != a_lost).sum()) > 0


def _fold_inputs(dtype):
    """Random data over 12 tiles, queries with an exact hit and a NaN, and the
    plain version's z and alpha."""
    rng = np.random.default_rng(24)
    m, n = 12 * TILE, 64
    dx, dy, dz = (torch.as_tensor(rng.random(m).astype(dtype)) for _ in range(3))
    qx, qy = (torch.as_tensor(rng.random(n).astype(dtype)) for _ in range(2))
    qx[0], qy[0] = dx[700], dy[700]
    qx[5] = math.nan
    params = AIDWParams(k=K, area=1.0)
    z, alpha = aidw_fused_soa_plain(dx, dy, dz, qx, qy, params=params, area=1.0, m_real=m, block_q=n,
                                    block_d=TILE)
    return (dx, dy, dz, qx, qy), params, z, alpha


def _lane_fold(dx, dy, dz, qx, qy, alpha, splits, eps, swap_round=None):
    """The kernel's weight pass: stages of ``fused_stage_points`` points,
    each a whole number of rounds of S tiles; each tile's sums and first
    minimum from 0 (``_common.weight_tile``, as the plain version sums a
    tile), folded round by round, the round's S tiles (one a part) in tile
    order; ``swap_round`` folds that round's tiles backwards."""
    ah = alpha[:, None] * 0.5
    m = dx.shape[0]
    stage_d = fused_stage_points(splits, TILE, dx.dtype)
    sum_w, sum_wz = torch.zeros_like(qx), torch.zeros_like(qx)
    min_d2, hit_z = torch.full_like(qx, math.inf), torch.zeros_like(qx)
    r = 0
    for base in range(0, m, stage_d):
        cnt = min(stage_d, m - base)
        for t0 in range(0, cnt, splits * TILE):
            sums = []
            for p in range(splits):
                a = base + t0 + p * TILE
                if a < base + cnt:
                    d2 = sq_dist_tile(qx[:, None], qy[:, None], dx[None, a:a + TILE], dy[None, a:a + TILE])
                    sums.append([s[:, 0] for s in weight_tile(d2, dz[None, a:a + TILE], ah)])
            for tw, twz, tmin, thz in (sums[::-1] if r == swap_round else sums):
                sum_w = sum_w + tw
                sum_wz = sum_wz + twz
                better = tmin < min_d2
                min_d2 = torch.where(better, tmin, min_d2)
                hit_z = torch.where(better, thz, hit_z)
            r += 1
    return torch.where(min_d2 <= eps, hit_z, sum_wz / sum_w)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_fold_gives_the_plain_z(dtype, splits):
    data, params, z_plain, alpha = _fold_inputs(dtype)
    dx, dy, dz, qx, qy = data
    z = _lane_fold(*data, alpha, splits, params.exact_hit_eps)
    torch.testing.assert_close(z, z_plain, rtol=0, atol=0, equal_nan=True)
    z_b2 = weight_sweep_plain(qx, qy, alpha * 0.5, dx, dy, dz, tile_d=TILE, eps=params.exact_hit_eps)
    torch.testing.assert_close(z, z_b2, rtol=0, atol=0, equal_nan=True)
    assert float(z[0]) == float(dz[700])  # the exact hit takes its point's z


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_round_out_of_order_moves_z(dtype):
    """The control of the bitwise fold: folding the second round's four tiles
    backwards moves z."""
    data, params, z_plain, alpha = _fold_inputs(dtype)
    z = _lane_fold(*data, alpha, 4, params.exact_hit_eps, swap_round=1)
    live = ~torch.isnan(z_plain)
    assert int((z[live] != z_plain[live]).sum()) > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_and_fold_match_the_pallas_kernel(dtype):
    """The kernel's model, S = 4 parts in both passes, against the Pallas
    fused kernel in interpret mode on the tie-heavy row, as
    ``test_torch_fused_v2_idw.py::test_fused_plain_matches_pallas`` holds the
    plain version: alpha within the port's tolerance, z within 1e-5 (1e-12)
    relative."""
    qx, qy, dx, dy, d2 = _row_d2(dtype)
    dz = (torch.sin(6 * dx.double()) * torch.cos(6 * dy.double()) + 2.0).to(dx.dtype)
    dz = torch.where(dx > 100, torch.zeros_like(dz), dz)  # the sentinel points carry z = 0, as padding does
    params = AIDWParams(k=K, area=1.0)
    stage_d = knn_stage_points(TORCH[dtype])
    inf = torch.full((N, K), math.inf, dtype=d2.dtype)
    best = _merged([merge_k_best(inf, d2[:, fused_part(M, stage_d, 4, p)]) for p in range(4)])[0]
    alpha = alpha_from_best(best, M, 1.0, params)[:, 0]
    z = _lane_fold(dx, dy, dz, qx, qy, alpha, 4, params.exact_hit_eps)
    block_q = 32
    qp = [np.concatenate([q.numpy(), np.zeros(block_q - N, dtype)]) for q in (qx, qy)]
    with enable_x64(dtype == np.float64):
        jz, ja = j_fused(*(jnp.asarray(a.numpy())[None] for a in (dx, dy, dz)), *(jnp.asarray(q)[:, None] for q in qp),
                         params=JParams(k=K, area=1.0), area=1.0, m_real=M, block_q=block_q, block_d=TILE,
                         interpret=True)
    ok = ~torch.isnan(qx).numpy()
    atol, rtol = {np.float32: (1e-6, 1e-5), np.float64: (1e-12, 1e-12)}[dtype]
    np.testing.assert_allclose(alpha.numpy()[ok], np.asarray(ja)[:N, 0][ok], rtol=4 * float(np.finfo(dtype).eps),
                               atol=atol)
    np.testing.assert_allclose(z.numpy()[ok], np.asarray(jz)[:N, 0][ok], rtol=rtol, atol=0)
    assert float(z[0]) == float(dz[100])  # the exact hit on the repeated point takes its z


BLOCK_QS = (64, 256)
NS = (1, 64, 8192, 65536, 1 << 20)


@pytest.mark.parametrize("block_d", [128, 512, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("block_q", BLOCK_QS)
def test_fused_launch_rule(block_q, sms, dtype, block_d):
    tile_bytes = block_d * 4 * (torch.finfo(dtype).bits // 8)
    for n in NS:
        n_pad = -(-n // block_q) * block_q  # the wrapper's batch is padded to block_q
        threads, s = fused_launch(n_pad, sms, block_d, dtype)
        assert threads == 256 and threads % s == 0 and s in (1, 2, 4)
        if s > 1:
            assert (threads // s) % 32 == 0  # a warp works on one part: every shared load is a broadcast
            assert s * tile_bytes <= STAGE_BYTES  # a round of S tiles fits one stage
            assert n_pad * s // 2 < 8192 * sms  # S doubles only while the batch is short of threads
        for k in range(1, 17):
            assert fused_shared_bytes(threads, s, block_d, k, dtype) <= MAX_SHARED_BYTES, (n, k)
    # on an H100 at the plans' 512-point tile
    assert fused_launch(8192, 132, 512, torch.float32) == (256, 4)
    assert fused_launch(65536, 132, 512, torch.float32) == (256, 4)
    assert fused_launch(1 << 20, 132, 512, torch.float32) == (256, 2)
    assert fused_launch(65536, 132, 512, torch.float64) == (256, 2)  # four 16 KiB tiles pass a stage
    assert fused_launch(65536, 132, 4096, torch.float32) == (256, 1)  # past the first design's 48 KiB
    assert fused_shared_bytes(128, 1, 4096, 10, torch.float32) == 64 * 1024
    assert fused_shared_bytes(128, 1, 2048, 16, torch.float64) == 64 * 1024
    assert fused_shared_bytes(256, 4, 512, 10, torch.float32) == 32 * 1024 + 8 * 4 * 64 * 4


def _code(name):
    return re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())


def test_stage_constants_match_the_source():
    common = _code("aidw_common.cuh")
    assert re.search(r"constexpr size_t kStageBytes = (\d+) \* 1024;", common).group(1) == str(STAGE_BYTES // 1024)
    assert re.search(r"constexpr size_t kMaxSharedBytes = (\d+) \* 1024;", common).group(1) == \
        str(MAX_SHARED_BYTES // 1024)
    # the kernel's sizing is fused_shared_bytes': the stages, the k-bests, the stage and its round buffers
    size = re.search(r"size_t shared_bytes\(.*?\n\}", _code("fused.cu"), re.S).group(0)
    for term in ("2 * static_cast<size_t>(kKnnStageBytes)", "splits * k * qc * sizeof(T)",
                 "8 * splits * qc * sizeof(T)", "kStageBytes / round_bytes", "smem > kMaxSharedBytes"):
        assert term in size, term


def test_fused_source_stages_with_cp_async_and_walks_groups():
    code = _code("fused.cu")
    common = _code("aidw_common.cuh")
    # pass 1: knn.cu's helpers, shared from aidw_common.cuh and not copied
    assert code.count("stage_values(") == 2 and "cp_async_wait_all();" in code
    assert "void stage_values(" in common and "void stage_values(" not in code + _code("knn.cu")
    assert code.count("knn_span<T, K, true, false>(") == 1 and "kbest_insert(best, merge[" in code
    assert "kKnnStageBytes" in code and "kKnnGroup" in code
    # pass 2: staged {x, y, z, pad} vectors, one LDS.128 a point, through the one tile loop
    assert "stage_point(sp, i, dx[base + i], dy[base + i], dz[base + i])" in code
    assert "staged_xyz(sp, j, x, y, z)" in code and code.count("weight_tile(") == 1
    assert not re.search(r"\bs[xyz]\[", code)  # no scalar shared arrays
    # nothing the design leaves out: no powf, no atomics, no 48 KiB cap (past it, the attribute)
    assert "powf(" not in code and "atomic" not in code
    assert not re.search(r"48 \* 1024\)\s*return", code) and "cudaFuncSetAttribute" in code
    assert re.search(r"if \(smem > 48 \* 1024\) \{", code)
    # S threads a query: warp-aligned parts; threads past the batch meet every barrier
    assert "threads / splits % 32 != 0" in code and "const long long qq = live ? q : n - 1;" in code


def test_fused_entry_points_match_their_signatures():
    src = (_build.CSRC / "fused.cu").read_text()
    sig = re.search(r"#define AIDW_FUSED_ENTRY\(NAME, T\).*?NAME\((.*?)\)\s*\{", src, re.S).group(1)
    params = [p.strip() for p in sig.replace("\\", " ").split(",")]
    names_in = [p.split()[-1] for p in params]
    assert names_in.index("splits") == names_in.index("threads") + 1
    kinds = ["p" if "*" in p else "d" if p.startswith("double") else "i" for p in params]
    for name in ("aidw_fused_f32", "aidw_fused_f64"):
        got = ["p" if a is _build._P else "d" if a is _build._D else "i" for a in _build.ENTRY_POINTS[name][1]]
        assert got == kinds, name


def _pretend_card(monkeypatch):
    """The card path of the fused wrapper on CPU tensors: every tensor counts
    as on the card, the SM count is an H100's, and the kernel entry records
    its arguments in the returned list."""
    calls = []
    monkeypatch.setattr(aidw_fused, "_on_card", lambda name, *t: True)
    monkeypatch.setattr(aidw_fused, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "entry", lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def _inputs(n=512, m=1024, dtype=np.float32):
    rng = np.random.default_rng(5)
    return torch.as_tensor(rng.random(n).astype(dtype)), torch.as_tensor(rng.random(m).astype(dtype))


def test_wrapper_plain_on_cpu_and_k_refused_before_a_launch(monkeypatch):
    q, d = _inputs()
    kw = dict(params=AIDWParams(k=K, area=1.0), area=1.0, m_real=1024, block_q=64, block_d=128)
    before = dict(_build.LAUNCHES)
    z, a = aidw_fused_soa(d, d, d, q, q, **kw)
    z_p, a_p = aidw_fused_soa_plain(d, d, d, q, q, **kw)
    assert torch.equal(z, z_p) and torch.equal(a, a_p) and _build.LAUNCHES == before
    calls = _pretend_card(monkeypatch)
    with pytest.raises(ValueError, match=r"k in 1\.\.16"):
        aidw_fused_soa(d, d, d, q, q, **dict(kw, params=AIDWParams(k=17, area=1.0)))
    assert calls == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_passes_the_launch_rule(monkeypatch, dtype):
    calls = _pretend_card(monkeypatch)
    q, d = _inputs(dtype=dtype)
    for block_d in (128, 512):
        aidw_fused_soa(d, d, d, q, q, params=AIDWParams(k=K, area=1.0), area=1.0, m_real=1024, block_q=64,
                       block_d=block_d)
        rule = fused_launch(512, 132, block_d, TORCH[dtype])
        name, args = calls[-1]
        assert name == f"aidw_fused_{'f32' if dtype == np.float32 else 'f64'}"
        assert args[5:11] == (512, 1024, block_d, K, *rule)  # n, m, tile_d, k, threads, splits
    assert fused_launch(512, 132, 512, torch.float32) == (256, 4)
    assert _build.LAUNCHES["fused"] == 2
