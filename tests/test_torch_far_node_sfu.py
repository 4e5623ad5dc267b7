"""The float32 quadtree far-node sweep (B6, ``csrc/far_node.cu``) with its
weights on the special-function units.

In float32 the kernel takes w from ``csrc/aidw_common.cuh: pow_weight``
(``lg2.approx.ftz.f32``, ``ex2.approx.ftz.f32``) and the dipole's division
as a product with ``rcp.approx.ftz.f32``, splits a query's runs between S
threads and folds their run sums in ``run_sum``'s order, and stops each row
at its closed nodes rounded up to a run; the plain version keeps
``torch.exp``/``torch.log`` and the division and walks whole tiles.  The
CUDA kernel runs only on the card (``chip_smoke.py`` holds it against its
plain version within ``phase2_far_nodes_tolerance``); here, on a small
quadtree plan, every level:

* a numpy emulation of the float32 loop, each unit's error drawn at its
  bound, the walk cut at the closed nodes and the runs of S = 1, 2, 4 parts
  folded in order, stays within each query's tolerance of the plain version,
  and the controls (each row's first closed node dropped, the dipole moments
  dropped) exceed it 10x or more;
* the walk cut at the closed nodes gives the plain version's bits (float32
  and float64 with the plain version's own functions);
* the launch rule ``kernels/aidw_grid.py: far_node_launch``, the wrapper's
  card path (faked on CPU tensors: the rule's threads and S and the closed
  counts reach the kernel), and the entry points' ctypes signatures.
"""

import re
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.aidw import AIDWParams
from repro_torch.core.grid import build_grid
from repro_torch.engine import build_plan
from repro_torch.engine.execute import _grid_layout, _quadtree_walk
from repro_torch.kernels import _build, aidw_grid
from repro_torch.kernels._common import SUM_RUN, run_sum, tolerance_ratio
from repro_torch.kernels.aidw_grid import (
    block_rectangles,
    far_node_launch,
    far_node_terms,
    phase2_far_nodes,
    phase2_far_nodes_plain,
    phase2_far_nodes_tolerance,
)

F32 = np.float32
EPS32 = float(np.finfo(F32).eps)
LG2_ABS = 2.0 ** -22.6        # lg2.approx.f32: absolute error in log2 x
EX2_REL = 2 * EPS32           # ex2.approx.f32: about 2 ulps
RCP_REL = EPS32               # rcp.approx.f32: 1 ulp
TINY = F32(1e-30)             # core/aidw.py: tiny_for(float32)
FLUSH = F32(2.0 ** -126)      # .ftz: results below float32's normal range are 0


def _np(t):
    return t.detach().cpu().numpy()


def _wide(plan, nb, tile, seed):
    """A table over level 0's nodes with many tiles a row: row i holds
    n_closed[i] of the occupied nodes (ascending; 0 in the first row, all in
    the last), the sentinel after them, in tiles of ``tile``."""
    nodes = plan.far[0][:6]
    n_nodes = nodes[0].shape[0] - 1
    occupied = np.nonzero(_np(nodes[2][:-1]) > 0)[0]
    rng = np.random.default_rng(seed)
    n_closed = rng.integers(0, occupied.size + 1, nb)
    n_closed[0], n_closed[-1] = 0, occupied.size
    tbl = np.full((nb, -(-n_nodes // tile) * tile), n_nodes, np.int32)
    for i, c in enumerate(n_closed):
        tbl[i, :c] = np.sort(rng.choice(occupied, c, replace=False))
    nt = (n_closed + tile - 1) // tile
    return (torch.as_tensor(tbl), torch.as_tensor(nt.astype(np.int32)), torch.as_tensor(n_closed.astype(np.int32)),
            nodes, tile)


def _case(dtype=np.float32, seed=30, m=3000, nq=220):
    """A quadtree plan over coarse uniform data (dispersion about the cell
    size, so coarse levels close nodes and the dipoles are large), a batch
    of uniform queries in its blocked view, alpha / 2 drawn from [0.25,
    2.5], and per level ``(tbl, nt, n_closed, nodes, tile)`` as the engine
    makes them, then two wide tables (``_wide``, tiles of 32 and 64)."""
    rng = np.random.default_rng(seed)
    dx, dy = (torch.as_tensor(rng.random(m).astype(dtype)) for _ in range(2))
    dz = torch.sin(6 * dx) * torch.cos(6 * dy) + 2.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = build_plan(dx, dy, dz, params=AIDWParams(k=10, area=1.0), area=1.0, impl="grid",
                          grid=build_grid(dx, dy, dz, gx=12, gy=12), phase2="quadtree", block_q=64, device="cpu")
    q = np.random.default_rng(11).random((nq, 2)).astype(dtype)
    lay = _grid_layout(plan, torch.as_tensor(q[:, 0]), torch.as_tensor(q[:, 1]))
    home = block_rectangles(plan.grid, lay.cx_v, lay.cy_v, torch.zeros_like(lay.cx_v), plan.block_q)
    levels = []
    for lv, (tbl, n_closed, _, _) in enumerate(_quadtree_walk(plan, *home)):
        k_pad, tile = plan.qt_levels[lv][3:]
        nt = ((n_closed.clamp(max=k_pad) + tile - 1) // tile).to(torch.int32)
        levels.append((tbl, nt, n_closed, plan.far[lv][:6], tile))
    nb = lay.qx_v.shape[0] // plan.block_q
    levels += [_wide(plan, nb, 32, 13), _wide(plan, nb, 64, 14)]
    ah = torch.as_tensor(np.random.default_rng(12).uniform(0.25, 2.5, lay.qx_v.shape[0]).astype(dtype))
    return plan, lay, ah, levels


def _live(tbl, nt, n_closed, tile):
    """Slots each row's kernel walk takes: its nt tiles, cut at n_closed
    rounded up to a run."""
    walk = torch.clamp(nt.long() * tile, 0, tbl.shape[1])
    closed = torch.clamp(n_closed.long(), 0, tbl.shape[1])
    return torch.minimum(walk, (closed + SUM_RUN - 1) // SUM_RUN * SUM_RUN)


def _fold(run_a, run_b, live_runs, runs_per_tile):
    """The kernel's fold of a query's run sums, in run order: each run into
    the tile sum, the tile into the totals at its end and after the last
    walked run.  ``run_a, run_b (n, R)``, ``live_runs (n,)``."""
    zero = np.zeros_like(run_a[:, 0])
    sum_a, sum_b, tile_a, tile_b = zero, zero, zero, zero
    for g in range(run_a.shape[1]):
        live = g < live_runs
        tile_a = np.where(live, tile_a + run_a[:, g], tile_a)
        tile_b = np.where(live, tile_b + run_b[:, g], tile_b)
        end = live & ((g + 1) % runs_per_tile == 0)
        sum_a, sum_b = np.where(end, sum_a + tile_a, sum_a), np.where(end, sum_b + tile_b, sum_b)
        tile_a, tile_b = np.where(end, 0, tile_a).astype(run_a.dtype), np.where(end, 0, tile_b).astype(run_a.dtype)
    cut = live_runs % runs_per_tile != 0
    return np.where(cut, sum_a + tile_a, sum_a), np.where(cut, sum_b + tile_b, sum_b)


def _unit(x, rel, rng):
    """x (float64) off by its unit's relative bound with a random sign,
    rounded to float32, a subnormal result flushed to 0."""
    y = (x * (1 + rng.choice([-1.0, 1.0], x.shape) * rel)).astype(F32)
    return np.where(np.abs(y) < FLUSH, F32(0), y)


def _emulate(lay, ah, level, block_q, splits, rng, *, drop_dipole=False):
    """far_node.cu's float32 loop for one level: the walk cut at the closed
    nodes, w = ex2(-ah lg2 max(d^2, tiny)) and grad = ((2 ah) w) rcp(max(d^2,
    tiny)) with each unit's error at its bound, every product and sum
    rounded to float32; the runs of each row shared between ``splits``
    parts (part p takes runs p, p + S, ...) and their sums folded in run
    order."""
    tbl, nt, n_closed, nodes, tile = level
    fx, fy, fcnt, fzs, fmx, fmy = (_np(a) for a in nodes)
    if drop_dipole:
        fmx, fmy = np.zeros_like(fmx), np.zeros_like(fmy)
    nb, k_pad = tbl.shape
    rows = np.repeat(np.arange(nb), block_q)
    live = _np(_live(tbl, nt, n_closed, tile))[rows]
    width = int(live.max()) if live.size else 0
    ids = np.where((_np(tbl) < 0) | (_np(tbl) >= fx.shape[0]), fx.shape[0] - 1, _np(tbl))[rows, :width]
    qx, qy, a_half = _np(lay.qx_v)[:, None], _np(lay.qy_v)[:, None], _np(ah)[:, None]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        dqx, dqy = qx - fx[ids], qy - fy[ids]
        d2 = dqx * dqx + dqy * dqy
        d2c = np.maximum(d2, TINY)
        lg2 = (np.log2(d2c.astype(np.float64)) + rng.choice([-1.0, 1.0], d2c.shape) * LG2_ABS).astype(F32)
        w = _unit(np.exp2((-a_half * lg2).astype(np.float64)), EX2_REL, rng)
        rcp = _unit(1.0 / d2c.astype(np.float64), RCP_REL, rng)
        grad = ((F32(2) * a_half) * w) * rcp
        dip = grad * (dqx * fmx[ids] + dqy * fmy[ids])
        term_a = w * fcnt[ids]
        term_b = w * fzs[ids] + dip
    n_runs = width // SUM_RUN
    run_a, run_b = np.zeros((qx.shape[0], n_runs), F32), np.zeros((qx.shape[0], n_runs), F32)
    for part in range(splits):
        mine = np.arange(part, n_runs, splits)
        for r in mine:
            s = slice(r * SUM_RUN, (r + 1) * SUM_RUN)
            run_a[:, r] = np.cumsum(term_a[:, s], axis=1, dtype=F32)[:, -1]
            run_b[:, r] = np.cumsum(term_b[:, s], axis=1, dtype=F32)[:, -1]
    return _fold(run_a, run_b, live // SUM_RUN, tile // SUM_RUN)


@pytest.fixture(scope="module")
def case32():
    return _case()


def test_case_walks_several_levels_and_cut_tiles(case32):
    plan, lay, ah, levels = case32
    closed = [int(lv[2].sum()) for lv in levels[:-2]]
    assert len(closed) == len(plan.qt_levels) >= 3 and sum(c > 0 for c in closed) >= 3, closed
    for tbl, nt, n_closed, _, tile in levels[-2:]:  # several tiles a row, some cut inside a run, an empty row
        assert int(nt.max()) >= 3 and int(n_closed.min()) == 0
        assert bool(((n_closed % tile != 0) & (n_closed % SUM_RUN != 0)).any())


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_far_node_sfu_sums_within_their_tolerance(case32, splits):
    plan, lay, ah, levels = case32
    rng = np.random.default_rng(40 + splits)
    for lv, level in enumerate(levels):
        tbl, nt, n_closed, nodes, tile = level
        kw = dict(block_q=plan.block_q, tile_d=tile)
        plain = phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, **kw)
        tol = phase2_far_nodes_tolerance(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, **kw)
        emu = _emulate(lay, ah, level, plan.block_q, splits, rng)
        for k, p, t in zip(emu, plain, tol):
            assert tolerance_ratio(torch.as_tensor(k), p, t) <= 1.0, lv


def test_far_node_controls_exceed_the_tolerance(case32):
    """Each row's first closed node dropped, and the dipole moments dropped,
    each 10x or more outside the tolerance at the level where it shows
    most (chip_smoke.py phase 13 takes the same maximum)."""
    plan, lay, ah, levels = case32
    ratios = {"node": [], "dipole": []}
    for level in levels:
        tbl, nt, n_closed, nodes, tile = level
        kw = dict(block_q=plan.block_q, tile_d=tile)
        plain = phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, **kw)
        tol = phase2_far_nodes_tolerance(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, **kw)
        lost = tbl.clone()
        lost[:, 0] = nodes[0].shape[0] - 1
        no_node = phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, lost, nt, nodes, **kw)
        no_dip = (*nodes[:4], torch.zeros_like(nodes[4]), torch.zeros_like(nodes[5]))
        flat = phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, tbl, nt, no_dip, **kw)
        ratios["node"].append(max(tolerance_ratio(k, p, t) for k, p, t in zip(no_node, plain, tol)))
        ratios["dipole"].append(tolerance_ratio(flat[1], plain[1], tol[1]))
        if int(n_closed.max()) > 0:
            assert ratios["node"][-1] >= 10, ratios
    assert max(ratios["node"]) >= 10 and max(ratios["dipole"]) >= 10, ratios
    # the emulated kernel without its dipole fails too
    lv = int(np.argmax(ratios["dipole"]))
    tbl, nt, n_closed, nodes, tile = levels[lv]
    kw = dict(block_q=plan.block_q, tile_d=tile)
    plain = phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, **kw)
    tol = phase2_far_nodes_tolerance(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, **kw)
    emu = _emulate(lay, ah, levels[lv], plan.block_q, 4, np.random.default_rng(9), drop_dipole=True)
    assert tolerance_ratio(torch.as_tensor(emu[1]), plain[1], tol[1]) >= 10


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_walk_cut_at_closed_nodes_is_bitwise_plain(dtype):
    """The plain version's arithmetic with the kernel's walk: each row cut
    at its closed nodes rounded up to a run, the runs folded in order and a
    cut tile folded after its last walked run, gives
    ``phase2_far_nodes_plain``'s bits; so does a table whose rows all hold
    more tiles of pads."""
    plan, lay, ah, levels = _case(dtype)
    n = lay.qx_v.shape[0]
    for lv, (tbl, nt, n_closed, nodes, tile) in enumerate(levels):
        kw = dict(block_q=plan.block_q, tile_d=tile)
        plain = phase2_far_nodes_plain(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, **kw)
        live = _live(tbl, nt, n_closed, tile).repeat_interleave(plan.block_q)
        width = int(live.max())
        ids = tbl.long().repeat_interleave(plan.block_q, dim=0)[:, :width]
        _, _, ta, wz, dip = far_node_terms(lay.qx_v[:, None], lay.qy_v[:, None], ah[:, None], ids, nodes)
        tb = wz + dip
        runs_a = torch.stack([run_sum(ta[:, r:r + SUM_RUN])[:, 0] for r in range(0, width, SUM_RUN)], 1) \
            if width else torch.zeros((n, 0), dtype=ta.dtype)
        runs_b = torch.stack([run_sum(tb[:, r:r + SUM_RUN])[:, 0] for r in range(0, width, SUM_RUN)], 1) \
            if width else torch.zeros((n, 0), dtype=tb.dtype)
        got = _fold(_np(runs_a), _np(runs_b), _np(live) // SUM_RUN, tile // SUM_RUN)
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g, _np(p), err_msg=f"level {lv}")
        if lv == 0:
            assert bool((live < nt.long().repeat_interleave(plan.block_q) * tile).any()), "the cut skips slots"


def test_far_node_launch_rule():
    for sms in (1, 114, 132):
        for block_q in (8, 32, 64, 96, 256, 512):
            for n in (block_q, 8192, 65536, 81920, 1 << 20):
                if n % block_q:
                    continue
                threads, splits = far_node_launch(n, sms, block_q=block_q)
                nq = threads // splits
                assert threads % splits == 0 and block_q % nq == 0 and n % nq == 0  # inside one row
                assert splits in (1, 2, 4) and threads <= 128 and (splits == 1 or nq <= 128)
                s = 2
                while s < 4 and n * s < 1024 * sms:
                    s *= 2
                assert splits == s
    # on an H100 (132 SMs), as phase 33 of chip_smoke.py measured: a short
    # batch (12,288 queries after the seam split) takes four threads a
    # query, the serving batch (81,920) and 2^20 queries two
    assert [far_node_launch(n, 132) for n in (12288, 81920, 1 << 20)] == [(128, 4), (128, 2), (128, 2)]


def _pretend_card(monkeypatch):
    """The card path of ``phase2_far_nodes`` on CPU tensors: every tensor
    counts as on the card, the SM count is an H100's, and the kernel entry
    records its arguments in the returned list."""
    calls = []
    monkeypatch.setattr(aidw_grid, "_on_card", lambda name, *t: True)
    monkeypatch.setattr(aidw_grid, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "entry", lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def test_wrapper_passes_the_launch_rule_and_the_closed_counts(case32, monkeypatch):
    plan, lay, ah, levels = case32
    tbl, nt, n_closed, nodes, tile = levels[0]
    args = (lay.qx_v, lay.qy_v, ah, tbl, nt, nodes)
    calls = _pretend_card(monkeypatch)
    phase2_far_nodes(*args, block_q=plan.block_q, tile_d=tile, n_closed=n_closed)
    phase2_far_nodes(*args, block_q=plan.block_q, tile_d=tile)
    (name, with_nc), (_, without) = calls
    assert name == "aidw_far_node_f32" and _build.LAUNCHES["far_node"] == 2
    n = lay.qx_v.shape[0]
    assert with_nc[5] == n_closed.data_ptr() and without[5] is None  # nc after nt
    assert with_nc[17:19] == far_node_launch(n, 132, block_q=plan.block_q)  # threads, splits after n_nodes
    with pytest.raises(ValueError, match="contiguous int32"):
        phase2_far_nodes(*args, block_q=plan.block_q, tile_d=tile, n_closed=n_closed.long())
    with pytest.raises(ValueError, match="bad shapes"):
        phase2_far_nodes(*args, block_q=plan.block_q, tile_d=tile, n_closed=n_closed[:-1].contiguous())


def test_far_node_entry_points_match_their_signatures():
    src = (_build.CSRC / "far_node.cu").read_text()
    sig = re.search(r"#define AIDW_FAR_NODE_ENTRY\(NAME, T\).*?NAME\((.*?)\)\s*\{", src, re.S).group(1)
    params = [p.strip() for p in sig.replace("\\", " ").split(",")]
    names = [p.split()[-1].lstrip("*") for p in params]
    kinds = ["p" if "*" in p else "d" if p.startswith("double") else "i" for p in params]
    assert names.index("nc") == names.index("nt") + 1
    assert names[names.index("threads"):names.index("threads") + 3] == ["threads", "splits", "tiny"]
    for name in ("aidw_far_node_f32", "aidw_far_node_f64"):
        argtypes = _build.ENTRY_POINTS[name][1]
        got = ["p" if a is _build._P else "d" if a is _build._D else "i" for a in argtypes]
        assert got == kinds, name
