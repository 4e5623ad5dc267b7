"""The float32 near-field (B4, ``csrc/near.cu``) and far-cell (B5,
``csrc/far.cu``) sweeps with their weights on the special-function units.

Both kernels take w from ``csrc/aidw_common.cuh: pow_weight``
(``lg2.approx.ftz.f32``, ``ex2.approx.ftz.f32``) in float32 and sum each tile
in ``run_sum``'s order; the plain versions keep ``torch.exp``/``torch.log``.
The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions within ``phase2_near_tolerance`` /
``phase2_far_tolerance``); here, on a small far-field plan:

* a numpy emulation of the float32 B4 and B5 loops in ``run_sum`` order,
  each unit's error drawn at its bound, stays within each query's tolerance
  of the plain versions, and the controls (a lost tile, a lost point, a
  lost cell, one more cell a block masked) exceed it 10x or more;
* B5's plain sweep with the rectangle applied where the kernel stages a
  cell (sentinel centroid, count = z_sum = 0) gives
  ``phase2_far_aggregates_plain``'s bits;
* the launch rule ``kernels/aidw_grid.py: row_launch``, B4's row order
  ``near_order`` (longest first) with near.cu's block-to-query map, and the
  two entry points' ctypes signatures.
"""

import re
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.aidw import AIDWParams
from repro_torch.core.grid import build_grid
from repro_torch.core.layouts import coord_sentinel
from repro_torch.engine import build_plan
from repro_torch.engine.execute import _grid_layout, _near_field, _tile_table
from repro_torch.kernels import _build
from repro_torch.kernels._common import SUM_RUN, pow_weight, run_sum, sq_dist_tile, tolerance_ratio
from repro_torch.kernels.aidw_grid import (
    phase2_far_aggregates_plain,
    phase2_far_tolerance,
    phase2_near_tolerance,
    phase2_near_weights_plain,
    near_order,
    row_launch,
)

F32 = np.float32
LG2_ABS = 2.0 ** -22.6        # lg2.approx.f32: absolute error in log2 x
EX2_REL = 2 * float(np.finfo(F32).eps)  # ex2.approx.f32: about 2 ulps
TINY = F32(1e-30)             # core/aidw.py: tiny_for(float32)
# (grid side, near radius, block_q, B4 tile: None for the plan's p2_block_d)
CASES = {"gx12": (12, 2, 64, None), "gx12-tile64": (12, 2, 64, 64), "gx40": (40, 3, 32, None),
         "gx40-tile128": (40, 3, 32, 128)}


def _np(t):
    return t.detach().cpu().numpy()


def _inputs(case, dtype=np.float32):
    """A far-field plan over tight clusters (as tests/test_torch_farfield.py
    builds them), 300 uniform queries in its blocked view, their near field
    and tile table at the case's tile, and alpha / 2 drawn from [0.25, 2.5]."""
    gx, radius, block_q, tile = CASES[case]
    rng = np.random.default_rng(10)
    centers = (np.stack(np.meshgrid(np.arange(12), np.arange(12)), -1).reshape(-1, 2) + 0.5) / 12
    pts = np.clip(centers[rng.integers(0, 144, 6000)] + rng.normal(0, 0.003, (6000, 2)), 0, 1).astype(dtype)
    dx, dy = torch.as_tensor(pts[:, 0]), torch.as_tensor(pts[:, 1])
    dz = torch.sin(6 * dx) * torch.cos(6 * dy) + 2.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = build_plan(dx, dy, dz, params=AIDWParams(k=10, area=1.0), area=1.0, impl="grid",
                          grid=build_grid(dx, dy, dz, gx=gx, gy=gx), phase2="farfield", farfield_radius=radius,
                          block_q=block_q, device="cpu")
    q = torch.as_tensor(np.random.default_rng(3).random((300, 2)).astype(dtype))
    lay = _grid_layout(plan, q[:, 0].contiguous(), q[:, 1].contiguous())
    near = _near_field(plan, lay.cx_v, lay.cy_v)
    tile = tile or plan.p2_block_d
    assert plan.p2_capacity % tile == 0
    nt = near.num_tiles if tile == plan.p2_block_d else _tile_table(near.need, plan.p2_capacity, tile)
    ah = torch.as_tensor(rng.uniform(0.25, 2.5, lay.qx_v.shape[0]).astype(dtype))
    near_args = (lay.qx_v, lay.qy_v, ah, near.cand_x, near.cand_y, near.cand_z, nt.to(torch.int32))
    return plan, lay, near, near_args, (lay.qx_v, lay.qy_v, ah, near.rects), tile


def _sfu_weight(d2, neg_ah, rng):
    """pow_weight's float32 form: lg2 and ex2 each off by its unit's bound
    with a random sign, the product rounded to float32, a subnormal result
    flushed to 0."""
    c = np.where(d2 > TINY, d2, TINY)
    lg2 = (np.log2(c.astype(np.float64)) + rng.choice([-1.0, 1.0], c.shape) * LG2_ABS).astype(F32)
    t = neg_ah * lg2
    w = (np.exp2(t.astype(np.float64)) * (1 + rng.choice([-1.0, 1.0], c.shape) * EX2_REL)).astype(F32)
    return np.where(w < F32(2.0 ** -126), F32(0), w)


def _run_sum32(t):
    """``run_sum`` in float32 numpy: runs of SUM_RUN left to right from 0
    (``np.cumsum`` accumulates in order), then the run sums."""
    n, m = t.shape
    part = np.cumsum(t.reshape(n, m // SUM_RUN, SUM_RUN), axis=2, dtype=F32)[:, :, -1]
    return np.cumsum(part, axis=1, dtype=F32)[:, -1]


def _emulate_near(args, block_q, tile_d, rng):
    """near.cu's float32 loop: each walked tile in run_sum order, the tile
    sums folded in order, the first minimum with a strict `<`."""
    qx, qy, ah, cx, cy, cz, nt = (_np(a) for a in args)
    nb = cx.shape[0]
    rows = np.repeat(np.arange(nb), block_q)
    neg_ah = (-ah)[:, None]
    sum_w, sum_wz, hit_z = (np.zeros(qx.shape[0], F32) for _ in range(3))
    min_d2 = np.full(qx.shape[0], np.inf, F32)
    for j in range(int(nt.max())):
        s = slice(j * tile_d, (j + 1) * tile_d)
        ddx, ddy = qx[:, None] - cx[rows, s], qy[:, None] - cy[rows, s]
        d2 = ddx * ddx + ddy * ddy
        w = _sfu_weight(d2, neg_ah, rng)
        live = j < nt[rows]
        sum_w = np.where(live, sum_w + _run_sum32(w), sum_w)
        sum_wz = np.where(live, sum_wz + _run_sum32(w * cz[rows, s]), sum_wz)
        tmin, first = d2.min(axis=1), d2.argmin(axis=1)
        better = live & (tmin < min_d2)
        hit_z = np.where(better, cz[rows, s][np.arange(qx.shape[0]), first], hit_z)
        min_d2 = np.where(better, tmin, min_d2)
    return sum_w, sum_wz, min_d2, hit_z


def _staged_cells(far, rects, block_q, flip=None):
    """The cells as far.cu stages them for each query's block: a cell inside
    the block's rectangle (or ``flip[block]``, one more cell a block) gets
    the sentinel centroid and count = z_sum = 0.  ``(n, ncp)`` each."""
    fx, fy, fcnt, fzs, fix, fiy = far
    r = rects.long()
    inside = ((fix[None] >= r[:, 0:1]) & (fix[None] <= r[:, 1:2]) & (fiy[None] >= r[:, 2:3])
              & (fiy[None] <= r[:, 3:4]))
    if flip is not None:
        inside[torch.arange(r.shape[0]), flip] = True
    inside = inside.repeat_interleave(block_q, dim=0)
    sent = coord_sentinel(fx.dtype)
    return (torch.where(inside, sent, fx[None]), torch.where(inside, sent, fy[None]),
            torch.where(inside, 0.0, fcnt[None]), torch.where(inside, 0.0, fzs[None]))


def _emulate_far(args, far, block_q, tile_d, rng, flip=None):
    """far.cu's float32 loop over the staged cells, tile by tile in
    run_sum order."""
    qx, qy, ah, rects = args
    sx, sy, sc, sz = (_np(a) for a in _staged_cells(far, rects, block_q, flip))
    qx, qy, neg_ah = _np(qx)[:, None], _np(qy)[:, None], (-_np(ah))[:, None]
    sum_w, sum_wz = np.zeros(qx.shape[0], F32), np.zeros(qx.shape[0], F32)
    with np.errstate(over="ignore", invalid="ignore"):
        for j in range(sx.shape[1] // tile_d):
            s = slice(j * tile_d, (j + 1) * tile_d)
            ddx, ddy = qx - sx[:, s], qy - sy[:, s]
            w = _sfu_weight(ddx * ddx + ddy * ddy, neg_ah, rng)
            sum_w = sum_w + _run_sum32(w * sc[:, s])
            sum_wz = sum_wz + _run_sum32(w * sz[:, s])
    return sum_w, sum_wz


def _flip_cells(plan, lay, rects):
    """For each block the occupied cell outside its rectangle nearest to its
    first query: what an off-by-one rectangle test would mask as well."""
    fx, fy, fcnt, _, fix, fiy = plan.far
    r = rects.long()
    inside = ((fix[None] >= r[:, 0:1]) & (fix[None] <= r[:, 1:2]) & (fiy[None] >= r[:, 2:3])
              & (fiy[None] <= r[:, 3:4]))
    q0 = torch.arange(r.shape[0]) * plan.block_q
    d2 = (fx[None] - lay.qx_v[q0, None]) ** 2 + (fy[None] - lay.qy_v[q0, None]) ** 2
    return torch.where((fcnt[None] > 0) & ~inside, d2, torch.inf).argmin(dim=1)


def _ratio(k, p, tol):
    return max(tolerance_ratio(torch.as_tensor(a), b, t) for a, b, t in zip(k, p, tol))


@pytest.mark.parametrize("case", sorted(CASES))
def test_near_sfu_sums_within_their_tolerance(case):
    plan, lay, near, args, _, tile = _inputs(case)
    kw = dict(block_q=plan.block_q, tile_d=tile)
    plain = phase2_near_weights_plain(*args, **kw)
    tol = phase2_near_tolerance(*args, **kw)
    if CASES[case][3]:
        assert int(args[6].max()) > 1 and bool((args[6] < plan.p2_capacity // tile).any()), "uneven tile walks"
    with np.errstate(over="ignore", invalid="ignore"):
        emu = _emulate_near(args, plan.block_q, tile, np.random.default_rng(7))
    assert _ratio(emu[:2], plain[:2], tol) <= 1.0
    # the minimum and its z do not depend on the weights: bit for bit
    np.testing.assert_array_equal(emu[2], _np(plain[2]))
    np.testing.assert_array_equal(emu[3], _np(plain[3]))
    # controls, each a plain sweep of the same inputs less a little, 10x
    # outside the tolerance: the first tile of each row, its first point
    sent = coord_sentinel(torch.float32)
    for drop in (slice(0, tile), slice(0, 1)):
        cx, cy = near.cand_x.clone(), near.cand_y.clone()
        cx[:, drop], cy[:, drop] = sent, sent
        lost = phase2_near_weights_plain(*args[:3], cx, cy, *args[5:], **kw)
        assert _ratio(lost[:2], plain[:2], tol) >= 10, drop


@pytest.mark.parametrize("case", ["gx12", "gx40"])
def test_far_sfu_sums_within_their_tolerance(case):
    plan, lay, near, _, args, _ = _inputs(case)
    kw = dict(block_q=plan.block_q, tile_d=plan.p2_far_block_d)
    plain = phase2_far_aggregates_plain(*args, plan.far, **kw)
    tol = phase2_far_tolerance(*args, plan.far, **kw)
    rng = np.random.default_rng(8)
    emu = _emulate_far(args, plan.far, plan.block_q, plan.p2_far_block_d, rng)
    assert _ratio(emu, plain, tol) <= 1.0
    # controls: the first tile of cells, the occupied cell of median count,
    # and one more cell a block masked (the emulated kernel itself)
    fcnt, fzs = plan.far[2], plan.far[3]
    occupied = torch.nonzero(fcnt > 0).reshape(-1)
    median_cell = occupied[torch.argsort(fcnt[occupied], stable=True)[occupied.numel() // 2]]
    for drop in (slice(0, plan.p2_far_block_d), median_cell):
        cnt, zs = fcnt.clone(), fzs.clone()
        cnt[drop], zs[drop] = 0.0, 0.0
        lost = phase2_far_aggregates_plain(*args, (*plan.far[:2], cnt, zs, *plan.far[4:]), **kw)
        assert _ratio(lost, plain, tol) >= 10, drop
    flipped = _emulate_far(args, plan.far, plan.block_q, plan.p2_far_block_d, rng,
                           flip=_flip_cells(plan, lay, near.rects))
    assert _ratio(flipped, plain, tol) >= 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["gx12", "gx40"])
def test_far_mask_applied_at_staging_is_bitwise_plain(case, dtype):
    """The rectangle applied once a cell, where far.cu stages it: an inside
    cell's term is exp(-inf) * 0 = +0 where the plain version's is 0 * count
    = +0 or 0 * z_sum = +-0, and a run that starts at +0 is never -0, so the
    sums keep their bits."""
    plan, lay, near, _, args, _ = _inputs(case, np.float32 if dtype == torch.float32 else np.float64)
    tile_d = plan.p2_far_block_d
    plain = phase2_far_aggregates_plain(*args, plan.far, block_q=plan.block_q, tile_d=tile_d)
    qx, qy, ah, rects = args
    sx, sy, sc, sz = _staged_cells(plan.far, rects, plan.block_q)
    assert bool(((sc == 0) & (plan.far[2][None] > 0)).any()), "occupied cells are masked"
    sum_w, sum_wz = torch.zeros_like(qx), torch.zeros_like(qx)
    for j in range(sx.shape[1] // tile_d):
        s = slice(j * tile_d, (j + 1) * tile_d)
        w = pow_weight(sq_dist_tile(qx[:, None], qy[:, None], sx[:, s], sy[:, s]), ah[:, None])
        sum_w = sum_w + run_sum(w * sc[:, s])[:, 0]
        sum_wz = sum_wz + run_sum(w * sz[:, s])[:, 0]
    assert torch.equal(sum_w, plain[0]) and torch.equal(sum_wz, plain[1])
    assert bool((plain[0] > 0).all())


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("block_q", [8, 32, 64, 96, 256, 512])
@pytest.mark.parametrize("sms", [1, 114, 132])
def test_row_launch_rule(block_q, sms, far):
    # both halve from 256 while the batch has fewer than 4 CUDA blocks a SM,
    # near.cu down to 64, far.cu down to 128
    blocks, fewest = (4, 128) if far else (4, 64)
    for n in (block_q, 8192, 65536, 81920, 1 << 20):
        if n % block_q:
            continue
        threads = row_launch(n, sms, block_q=block_q, far=far)
        assert block_q % threads == 0 and n % threads == 0  # a CUDA block inside one row
        t = 256
        while t > fewest and n < t * blocks * sms:
            t //= 2
        assert threads == np.gcd(block_q, t)
    # on an H100 (132 SMs), as phase 32 of chip_smoke.py measured: the
    # serving batch (81,920 queries after the seam split) takes 128 near and
    # far, a short one (12,288) 64 and 128, 2^20 queries 256 and 256
    assert [row_launch(n, 132) for n in (12288, 81920, 1 << 20)] == [64, 128, 256]
    assert [row_launch(n, 132, far=True) for n in (12288, 81920, 1 << 20)] == [128, 128, 256]


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
def test_near_order_deals_every_query_once_longest_row_first(threads):
    # near.cu: the CUDA blocks of a row are consecutive and the rows come in
    # near_order; each query of the batch is swept by exactly one thread
    block_q, nb = 256, 37
    nt = torch.as_tensor(np.random.default_rng(5).integers(0, 35, nb), dtype=torch.int32)  # 0-34
    nt[3] = nt[9] = nt[20] = 35  # ties keep their row order
    order = near_order(nt)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(nb))
    walks = nt[order.long()].tolist()
    assert walks == sorted(walks, reverse=True) and order[:3].tolist() == [3, 9, 20]
    per_row = block_q // threads
    seen, rows = [], []
    for block in range(nb * block_q // threads):
        row = int(order[block // per_row])
        rows.append(row)
        seen += [row * block_q + (block % per_row) * threads + t for t in range(threads)]
    assert sorted(seen) == list(range(nb * block_q))
    assert [nt[r] for r in rows[::per_row]] == walks
    src = (_build.CSRC / "near.cu").read_text()
    assert "const int slot = static_cast<int>(blockIdx.x) / per_row;" in src
    assert "const long long row = order ? order[slot] : slot;" in src
    assert ("row * block_q + static_cast<long long>(blockIdx.x % per_row) * blockDim.x + threadIdx.x" in src)


@pytest.mark.parametrize("source, macro, names", [
    ("near.cu", "AIDW_NEAR_ENTRY", ("aidw_near_weight_f32", "aidw_near_weight_f64")),
    ("far.cu", "AIDW_FAR_ENTRY", ("aidw_far_cell_f32", "aidw_far_cell_f64")),
])
def test_near_far_entry_points_match_their_signatures(source, macro, names):
    src = (_build.CSRC / source).read_text()
    sig = re.search(rf"#define {macro}\(NAME, T\).*?NAME\((.*?)\)\s*\{{", src, re.S).group(1)
    params = [p.strip() for p in sig.replace("\\", " ").split(",")]
    kinds = ["p" if "*" in p else "d" if p.startswith("double") else "i" for p in params]
    assert [p.split()[-1] for p in params].index("threads") == kinds.index("d") - 1  # threads, then tiny
    for name in names:
        argtypes = _build.ENTRY_POINTS[name][1]
        got = ["p" if a is _build._P else "d" if a is _build._D else "i" for a in argtypes]
        assert got == kinds, name
