"""Execute: interpolate one query batch against a plan.  Counterpart of
``repro.engine.execute`` for every impl.

The dense impls run one kernel family over the whole padded data: ``naive``
(``csrc/naive.cu``, both phases in one launch), ``tiled`` (``csrc/knn.cu``
then ``csrc/weight.cu``), each in the SoA or AoaS layout, ``binned``
(``tiled`` SoA with the binned prefilter in ``knn.cu``), ``fused``
(``csrc/fused.cu``, both tiled passes in one launch) and ``tiled_v2``
(``knn.cu`` with the threshold-skip merge count, then ``weight.cu``).
``idw`` is ``weight.cu`` at one constant power.  ``chunked`` is plain
PyTorch on the plan's device: a brute-force or grid kNN, then a chunked
weight sweep, with no kernel of its own.

The grid path: Morton-sort the queries, split blocks at Morton seams,
per-query safe radii from the plan's ``required_radius`` table, the
static-capacity CSR candidate gather, Phase 1 over the candidate rows
(``csrc/knn.cu``), the per-query overflow blend with the exact ring search,
then Phase 2 and unsort.  Exactness is per block: the kernel's alpha is kept
where a block's candidates fit the plan's capacity, and queries of
overflowing blocks take the ring search's alpha.  Phase 2 is the exact sweep
over all data (``csrc/weight.cu``) or, on a far-field plan, the near field
swept exactly (``csrc/near.cu``) plus one aggregate term per far cell
(``csrc/far.cu``), or, on a quadtree plan, the same near field plus one
aggregate and dipole term per node that a Barnes-Hut walk of the cell
quadtree closes (``csrc/far_node.cu``, one launch per level).  Blocks whose
near field overflows the plan's capacity, or whose node table overflows a
level's width, are swept exactly instead.
"""

from __future__ import annotations

import threading
import types
import warnings
import weakref

import torch

from repro_torch.core.aidw import _interpolate_pass2, adaptive_alpha, brute_r_obs
from repro_torch.core.grid import (
    cell_of,
    grid_r_obs,
    morton_ids,
    safe_radius_from_need,
    seam_layout,
    seam_segment_ids,
)
from repro_torch.core.layouts import pad_tail, pad_to
from repro_torch.engine.plan import InterpolationPlan
from repro_torch.errors import CapacityOverflowWarning
from repro_torch.kernels.aidw_grid import (
    block_rectangles,
    gather_candidates_csr,
    phase1_alpha_from_candidates,
    phase2_far_aggregates,
    phase2_far_nodes,
    phase2_near_weights,
    phase2_weights_full,
)
from repro_torch.kernels.aidw_fused import aidw_fused_soa
from repro_torch.kernels.aidw_naive import aidw_naive_aoas, aidw_naive_soa
from repro_torch.kernels.aidw_tiled import aidw_tiled_aoas, aidw_tiled_soa
from repro_torch.kernels.aidw_tiled_v2 import aidw_tiled_v2_soa
from repro_torch.kernels.idw_tiled import idw_tiled_soa


def _seam_split_layout(plan: InterpolationPlan, qx_s, qy_s, cx_s, cy_s):
    """Regroup the Morton-sorted batch so no block straddles a Morton seam.

    The plan's ``seam_level`` is capped per batch so the worst-case padding
    (one block per occupied quadrant) stays small relative to the batch.
    Returns the blocked view ``(qx_v, qy_v, cx_v, cy_v)`` plus ``src`` (slot ->
    sorted index) and ``dest`` (sorted index -> slot), both ``None`` when
    splitting is off.
    """
    n_tot = qx_s.shape[0]
    level = plan.seam_level
    while level > 0 and (4 ** level) * plan.block_q > n_tot:
        level -= 1
    if level == 0:
        return qx_s, qy_s, cx_s, cy_s, None, None
    seg = seam_segment_ids(plan.grid, cx_s, cy_s, level)
    src, dest = seam_layout(seg, 4 ** level, plan.block_q, n_tot + (4 ** level) * plan.block_q)
    return qx_s[src], qy_s[src], cx_s[src], cy_s[src], src, dest


def _tile_table(need, capacity: int, block_d: int):
    """Per-block real-tile counts (int32) of pipeline "prefetch": each block
    walks only the tiles its capacity-covered candidates occupy.  The tiles
    it skips are all sentinel, so the dense walk (no table) gives the same
    alpha."""
    covered = need.clamp(max=capacity)
    return ((covered + block_d - 1) // block_d).to(torch.int32)


def _grid_layout(plan: InterpolationPlan, qx, qy):
    """Everything the grid path computes before its first kernel: the sorted
    batch, the seam-split view, the candidate rows and their true need, the
    prefetch tile table and the per-query overflow mask (sorted layout)."""
    grid = plan.grid
    n = qx.shape[0]
    # Morton-sort so each block's home cells form a compact patch; pad the
    # tail by repetition (adds no candidate cells)
    cx, cy = cell_of(grid, qx, qy)
    order = torch.argsort(morton_ids(cx, cy), stable=True)
    n_pad = (-n) % plan.block_q
    qx_s = pad_tail(qx[order], n_pad)
    qy_s = pad_tail(qy[order], n_pad)
    cx_s, cy_s = cell_of(grid, qx_s, qy_s)
    qx_v, qy_v, cx_v, cy_v, src, dest = _seam_split_layout(plan, qx_s, qy_s, cx_s, cy_s)

    # containment-safe radii: plan-time table + closed-form overhang term
    r_need = plan.r_need[cy_v, cx_v]
    r_safe = safe_radius_from_need(grid, qx_v, qy_v, cx_v, cy_v, r_need)
    rects = block_rectangles(grid, cx_v, cy_v, r_safe, plan.block_q)
    cand_x, cand_y, need = gather_candidates_csr(grid, *rects, plan.cand_capacity)
    over_b = need > plan.cand_capacity
    over_v = over_b.repeat_interleave(plan.block_q)
    return types.SimpleNamespace(
        order=order, qx_s=qx_s, qy_s=qy_s, qx_v=qx_v, qy_v=qy_v, cx_v=cx_v, cy_v=cy_v, src=src, dest=dest,
        cand_x=cand_x, cand_y=cand_y, need=need,
        num_tiles=_tile_table(need, plan.cand_capacity, plan.cand_block_d),
        over_b=over_b, over_q=over_v if dest is None else over_v[dest])


def _phase2_farfield(plan: InterpolationPlan, qx_v, qy_v, alpha_v, cx_v, cy_v):
    """Far-field Phase 2 over the blocked view (DESIGN.md section 7).

    Per block, the near rectangle is the home-cell bbox grown by the plan's
    near-field radius; its points are swept exactly (the with-z CSR gather at
    ``p2_capacity``, walked through the tile table), and every cell outside
    it adds one aggregate term.  Returns ``(z (n_tot,), need (nb,),
    rect_cells (nb,))``; ``need > p2_capacity`` flags blocks whose near
    gather was cut short, which the caller sweeps exactly instead (the bound
    assumes a complete near field).
    """
    near = _near_field(plan, cx_v, cy_v)
    ah = alpha_v * 0.5
    sw_n, swz_n, md_n, hz_n = phase2_near_weights(qx_v, qy_v, ah, near.cand_x, near.cand_y, near.cand_z,
                                                  near.num_tiles, block_q=plan.block_q, tile_d=plan.p2_block_d)
    sw_f, swz_f = phase2_far_aggregates(qx_v, qy_v, ah, near.rects, plan.far, block_q=plan.block_q,
                                        tile_d=plan.p2_far_block_d)
    z = torch.where(md_n <= plan.params.exact_hit_eps, hz_n, (swz_n + swz_f) / (sw_n + sw_f))
    return z, near.need, near.rect_cells


def _near_field(plan: InterpolationPlan, cx_v, cy_v):
    """The far-field Phase 2's inputs for the blocked view: each block's
    near rectangle (``rects (nb, 4)`` int32, inclusive ``xlo, xhi, ylo,
    yhi``), the with-z near gather at ``p2_capacity`` with its true ``need``,
    the near tile table and the rectangle's cell count."""
    r_near = torch.full(cx_v.shape, plan.farfield_radius, dtype=cx_v.dtype, device=cx_v.device)
    xlo, xhi, ylo, yhi = block_rectangles(plan.grid, cx_v, cy_v, r_near, plan.block_q)
    cand_x, cand_y, cand_z, need = gather_candidates_csr(plan.grid, xlo, xhi, ylo, yhi, plan.p2_capacity,
                                                         with_z=True)
    if plan.pipeline == "prefetch":
        num_tiles = _tile_table(need, plan.p2_capacity, plan.p2_block_d)
    else:
        num_tiles = torch.full(need.shape, plan.p2_capacity // plan.p2_block_d, dtype=torch.int32,
                               device=need.device)
    return types.SimpleNamespace(
        rects=torch.stack([xlo, xhi, ylo, yhi], dim=1).to(torch.int32), cand_x=cand_x, cand_y=cand_y,
        cand_z=cand_z, need=need, num_tiles=num_tiles, rect_cells=(xhi - xlo + 1) * (yhi - ylo + 1))


# (block, node) pairs one chunk of the quadtree walk holds at once: its
# temporaries (gaps, masks, positions) stay near 40 bytes a pair, under 1 GiB
_WALK_PAIRS = 1 << 24


def _walk_level(plan: InterpolationPlan, lv: int, home, proc, tau, cell_min):
    """One level of :func:`_quadtree_walk` for a chunk of blocks: returns
    ``(tbl, n_closed, n_opened, n_proc, opened)``."""
    grid = plan.grid
    dev = tau.device
    nx, ny, step, k_pad, _tile = plan.qt_levels[lv]
    n_nodes = nx * ny
    hxlo, hxhi, hylo, hyhi = home
    nbc = hxlo.shape[0]
    jx = torch.arange(nx, dtype=torch.int32, device=dev)
    jy = torch.arange(ny, dtype=torch.int32, device=dev)
    nxlo, nxhi = jx * step, ((jx + 1) * step).clamp(max=grid.gx) - 1
    nylo, nyhi = jy * step, ((jy + 1) * step).clamp(max=grid.gy) - 1
    gapx = torch.maximum(nxlo[None, :] - hxhi[:, None], hxlo[:, None] - nxhi[None, :]).clamp(min=0)
    gapy = torch.maximum(nylo[None, :] - hyhi[:, None], hylo[:, None] - nyhi[None, :]).clamp(min=0)
    gap = torch.maximum(gapy[:, :, None], gapx[:, None, :]).reshape(nbc, n_nodes)
    cnt, e = plan.far[lv][2][:n_nodes], plan.far[lv][6][:n_nodes]
    if proc is None:
        proc = torch.ones((nbc, n_nodes), dtype=torch.bool, device=dev)
    nonempty = (cnt > 0)[None, :]
    far_enough = gap >= plan.farfield_radius + 1
    if lv == 0:
        closed = proc & far_enough & nonempty
        opened = None
        n_opened = torch.zeros((nbc,), dtype=torch.int32, device=dev)
    else:
        # the reference's product order: tau rounded to the data dtype, times
        # (gap - 1), times cell_min
        tight = e[None, :] <= tau * (gap - 1).to(tau.dtype) * cell_min
        closed = proc & far_enough & tight & nonempty
        opened = proc & nonempty & ~(far_enough & tight)
        n_opened = opened.sum(dim=1, dtype=torch.int32)
    n_proc = (proc & nonempty).sum(dim=1, dtype=torch.int32)
    n_closed = closed.sum(dim=1, dtype=torch.int32)
    # compact the closed ids, ascending, into the static-width table; every
    # other (block, node) pair, and a closed node past k_pad, writes the dump
    # column k_pad, the only index written twice, which is sliced away
    pos = torch.cumsum(closed, dim=1, dtype=torch.int32) - 1
    col = torch.where(closed, pos.clamp(max=k_pad), k_pad).long()
    ids = torch.arange(n_nodes, dtype=torch.int32, device=dev).expand(nbc, n_nodes)
    tbl = torch.full((nbc, k_pad + 1), n_nodes, dtype=torch.int32, device=dev)
    tbl.scatter_(1, col, torch.where(closed, ids, n_nodes))
    return tbl[:, :k_pad], n_closed, n_opened, n_proc, opened


def _quadtree_walk(plan: InterpolationPlan, hxlo, hxhi, hylo, hyhi):
    """Barnes-Hut walk over the plan's quadtree, one node table per level.

    Per query block (home rectangle ``hxlo..hxhi x hylo..hyhi``, inclusive
    cell coordinates) and level, from the top down, every processed node is
    tested: it is CLOSED (one aggregate and dipole term) when its Chebyshev
    cell gap from the home rectangle is at least ``radius + 1`` and its
    dispersion fits the plan's opening ratio, ``e <= tau * (gap - 1) *
    cell_min``; a processed nonempty node that fails is OPENED and its four
    children are processed at the next finer level.  Level-0 cells are
    closed on the gap test alone.  Empty nodes are neither.  Every far cell
    is then counted by exactly one closed node, every near cell by none.

    The walk is masked arithmetic over all ``(block, node)`` pairs, in
    chunks of blocks of at most ``_WALK_PAIRS`` pairs at the finest level.
    Returns per level ``(tbl (nb, k_pad) int32, n_closed, n_opened,
    n_proc)`` (``(nb,)`` int32 each): the table holds each block's closed
    ids in ascending order, pad slots the sentinel node ``nx * ny``;
    ``n_closed > k_pad`` means the table overflowed and the block must take
    the exact sweep.
    """
    grid = plan.grid
    dtype = grid.pt_x.dtype
    dev = hxlo.device
    cell_min = torch.minimum(grid.cell_size[0], grid.cell_size[1]).to(dtype)
    tau = torch.tensor(plan.qt_tau, dtype=dtype, device=dev)
    home = [h.to(torch.int32) for h in (hxlo, hxhi, hylo, hyhi)]
    nb, n_lv = hxlo.shape[0], len(plan.qt_levels)
    step = max(1, _WALK_PAIRS // max(nx * ny for nx, ny, *_ in plan.qt_levels))
    parts = [[] for _ in range(n_lv)]
    for b0 in range(0, nb, step):
        chunk = [h[b0:b0 + step] for h in home]
        proc = None
        for lv in range(n_lv - 1, -1, -1):
            *out, opened = _walk_level(plan, lv, chunk, proc, tau, cell_min)
            parts[lv].append(out)
            if lv > 0:
                nx_p = plan.qt_levels[lv][0]
                nx, ny = plan.qt_levels[lv - 1][:2]
                jx = torch.arange(nx, device=dev)
                jy = torch.arange(ny, device=dev)
                proc = opened[:, ((jy[:, None] // 2) * nx_p + jx[None, :] // 2).reshape(-1)]
    return [tuple(torch.cat(p) for p in zip(*level)) for level in parts]


def _phase2_quadtree(plan: InterpolationPlan, qx_v, qy_v, alpha_v, cx_v, cy_v):
    """Quadtree far-field Phase 2 over the blocked view (DESIGN.md section 8).

    The near field is the far-field arm's (``_near_field``, ``csrc/near.cu``);
    beyond it :func:`_quadtree_walk` closes nodes level by level and one
    ``csrc/far_node.cu`` launch per level adds each block's closed nodes,
    level 0 first, to the near sums.  Returns ``(z (n_tot,), need (nb,),
    overflow (nb,), closed (n_levels, nb), opened (nb,), processed (nb,))``:
    ``overflow`` flags blocks whose near gather or any level's node table
    was cut short, which the caller sweeps exactly instead.
    """
    r_zero = torch.zeros_like(cx_v)
    home = block_rectangles(plan.grid, cx_v, cy_v, r_zero, plan.block_q)
    near = _near_field(plan, cx_v, cy_v)
    ah = alpha_v * 0.5
    sw, swz, md_n, hz_n = phase2_near_weights(qx_v, qy_v, ah, near.cand_x, near.cand_y, near.cand_z,
                                              near.num_tiles, block_q=plan.block_q, tile_d=plan.p2_block_d)
    overflow = near.need > plan.p2_capacity
    closed, opened_tot, proc_tot = [], 0, 0
    for lv, (tbl, n_closed, n_opened, n_proc) in enumerate(_quadtree_walk(plan, *home)):
        k_pad, tile = plan.qt_levels[lv][3:]
        nt = ((n_closed.clamp(max=k_pad) + tile - 1) // tile).to(torch.int32)
        sw_f, swz_f = phase2_far_nodes(qx_v, qy_v, ah, tbl, nt, plan.far[lv][:6], block_q=plan.block_q,
                                       tile_d=tile, n_closed=n_closed)
        sw = sw + sw_f
        swz = swz + swz_f
        overflow = overflow | (n_closed > k_pad)
        closed.append(n_closed)
        opened_tot = opened_tot + n_opened
        proc_tot = proc_tot + n_proc
    z = torch.where(md_n <= plan.params.exact_hit_eps, hz_n, swz / sw)
    return z, near.need, overflow, torch.stack(closed), opened_tot, proc_tot


def _phase2_exact_masked(plan: InterpolationPlan, qx_s, qy_s, alpha, over_q):
    """The masked exact Phase 2, the far-field plan's overflow arm: every
    ``block_q`` run (sorted layout) holding a flagged query gets the full
    sweep over all data, and the other blocks cost nothing.  The flagged
    blocks' queries are gathered into one batch and swept by one launch;
    the sweep runs one thread per query over the data in a fixed order, so
    each query gets the bits of a whole-batch sweep.  Unswept slots hold 0;
    callers blend with ``torch.where(over_q, ...)``."""
    bq = plan.block_q
    z = torch.zeros_like(qx_s)
    blocks = torch.nonzero(over_q.reshape(-1, bq).any(dim=1)).reshape(-1)
    if blocks.numel() == 0:
        return z
    idx = (blocks[:, None] * bq + torch.arange(bq, device=blocks.device)).reshape(-1)
    dxp, dyp, dzp = plan.data
    z[idx] = phase2_weights_full(qx_s[idx], qy_s[idx], alpha[idx], dxp, dyp, dzp,
                                 eps=plan.params.exact_hit_eps, block_d=plan.block_d)
    return z


def _execute_grid(plan: InterpolationPlan, qx, qy):
    grid, params = plan.grid, plan.params
    n = qx.shape[0]
    lay = _grid_layout(plan, qx, qy)

    # Phase 1 always runs the kernel; an overflowing block computes a
    # (discarded) alpha from its first cand_capacity candidates
    alpha_fast = phase1_alpha_from_candidates(
        lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, params=params, area=plan.area, m_real=plan.m,
        block_q=plan.block_q, block_d=plan.cand_block_d,
        num_tiles=lay.num_tiles if plan.pipeline == "prefetch" else None)
    if lay.dest is not None:
        alpha_fast = alpha_fast[lay.dest]

    # per-query overflow blend, in the sorted layout: the ring search runs
    # only for queries whose block overflowed (none in a clean batch)
    over_q = lay.over_q
    r_obs = grid_r_obs(grid, lay.qx_s, lay.qy_s, params.k, active=over_q)
    alpha_exact = adaptive_alpha(r_obs, plan.m, plan.area, params).to(qx.dtype)
    alpha = torch.where(over_q, alpha_exact, alpha_fast)

    if plan.phase2 in ("farfield", "quadtree"):
        # in the seam-split view (its rectangles must not straddle seams
        # either): alpha maps in through src, z back through dest; queries
        # of blocks whose near field (or quadtree node table) overflows take
        # the masked exact sweep
        alpha_v = alpha if lay.src is None else alpha[lay.src]
        if plan.phase2 == "quadtree":
            z_v, need2, over2_b, closed, opened_tot, proc_tot = _phase2_quadtree(
                plan, lay.qx_v, lay.qy_v, alpha_v, lay.cx_v, lay.cy_v)
        else:
            z_v, need2, rect_cells = _phase2_farfield(plan, lay.qx_v, lay.qy_v, alpha_v, lay.cx_v, lay.cy_v)
            over2_b = need2 > plan.p2_capacity
        over2_v = over2_b.repeat_interleave(plan.block_q)
        z_near, over2_s = (z_v, over2_v) if lay.dest is None else (z_v[lay.dest], over2_v[lay.dest])
        z_full = _phase2_exact_masked(plan, lay.qx_s, lay.qy_s, alpha, over2_s)
        zhat = torch.where(over2_s, z_full, z_near)
    else:
        dxp, dyp, dzp = plan.data
        zhat = phase2_weights_full(lay.qx_s, lay.qy_s, alpha, dxp, dyp, dzp,
                                   eps=params.exact_hit_eps, block_d=plan.block_d)
    inv = torch.empty_like(lay.order)
    inv[lay.order] = torch.arange(n, device=inv.device)

    # diagnostics count only blocks holding at least one real query
    need = lay.need
    nb = need.shape[0]
    if lay.dest is not None:
        real_slot = torch.zeros((nb * plan.block_q,), dtype=torch.bool, device=need.device)
        real_slot[lay.dest] = True
        real_b = real_slot.reshape(nb, plan.block_q).any(dim=1)
    else:
        real_b = torch.ones((nb,), dtype=torch.bool, device=need.device)
    n_tiles_static = plan.cand_capacity // plan.cand_block_d
    n_real_tiles = torch.clamp(real_b.sum() * n_tiles_static, min=1)
    stats = {
        # every real query took the ring path: the batch got no kernel help
        "grid_fallback": over_q[:n].all(),
        "cand_need_max": need.max(),
        "overflow_blocks": (lay.over_b & real_b).sum(),
        "overflow_queries": over_q[:n].sum(),
        "overflow_query_mask": over_q[:n][inv],
        "skipped_tile_fraction": 1.0 - torch.where(real_b, lay.num_tiles, 0).sum().to(torch.float32)
        / n_real_tiles,
    }
    if plan.phase2 in ("farfield", "quadtree"):
        n_real_b = real_b.sum().clamp(min=1).to(torch.float32)
        bound = torch.tensor(plan.farfield_bound, dtype=zhat.dtype, device=zhat.device)
        if plan.phase2 == "quadtree":
            # far work per block: the closed nodes summed over the levels
            per_level = torch.where(real_b[None, :], closed, 0).sum(dim=1).to(torch.float32)
            stats.update({
                "far_cells_mean": torch.where(real_b, closed.sum(dim=0), 0).sum().to(torch.float32) / n_real_b,
                "cells_per_level": per_level / n_real_b,
                "opened_fraction": torch.where(real_b, opened_tot, 0).sum().to(torch.float32)
                / torch.where(real_b, proc_tot, 0).sum().clamp(min=1).to(torch.float32),
                "quadtree_rtol_bound": bound,
            })
        else:
            stats.update({
                "far_cells_mean": torch.where(real_b, grid.n_cells - rect_cells, 0).sum().to(torch.float32)
                / n_real_b,
                "farfield_rtol_bound": bound,
            })
        stats.update({
            "near_points_mean": torch.where(real_b, need2, 0).sum().to(torch.float32) / n_real_b,
            "p2_overflow_queries": over2_s[:n].sum(),
        })
    return zhat[:n][inv], alpha[:n][inv], stats


def binned_nbins(k: int, block_d: int) -> int:
    """The binned prefilter's bins per tile: a power of two from 16 that
    doubles while ``2 * nbins <= min(6 k, block_d // 4)`` (the JAX package's
    rule, DESIGN.md section 3)."""
    nbins = 16
    while nbins * 2 <= min(6 * k, block_d // 4):
        nbins *= 2
    return nbins


def _execute_dense(plan: InterpolationPlan, qx, qy):
    n = qx.shape[0]
    qxp, qyp = pad_to(qx, plan.block_q, 0.0), pad_to(qy, plan.block_q, 0.0)
    kw = dict(params=plan.params, area=plan.area, m_real=plan.m, block_q=plan.block_q, block_d=plan.block_d)
    if plan.layout == "aoas":
        run = aidw_naive_aoas if plan.impl == "naive" else aidw_tiled_aoas  # build_plan rejects the rest
        z, a = run(*plan.data, qxp, qyp, **kw)
    elif plan.impl == "naive":
        z, a = aidw_naive_soa(*plan.data, qxp, qyp, **kw)
    elif plan.impl == "fused":
        z, a = aidw_fused_soa(*plan.data, qxp, qyp, **kw)
    elif plan.impl == "tiled_v2":
        z, a, merges = aidw_tiled_v2_soa(*plan.data, qxp, qyp, **kw)
        n_tiles = plan.data[0].shape[0] // plan.block_d
        # merges over (blocks x tiles), in float32 as the reference reports it
        frac = merges.sum().to(torch.float32) / (merges.shape[0] * n_tiles)
        return z[:n], a[:n], {"merge_fraction": frac}
    else:
        nbins = binned_nbins(plan.params.k, plan.block_d) if plan.impl == "binned" else 0
        z, a = aidw_tiled_soa(*plan.data, qxp, qyp, nbins=nbins, **kw)
    return z[:n], a[:n], {}


def _execute_idw(plan: InterpolationPlan, qx, qy):
    n = qx.shape[0]
    qxp, qyp = pad_to(qx, plan.block_q, 0.0), pad_to(qy, plan.block_q, 0.0)
    z = idw_tiled_soa(*plan.data, qxp, qyp, alpha=plan.idw_alpha, exact_hit_eps=plan.params.exact_hit_eps,
                      block_q=plan.block_q, block_d=plan.block_d)
    return z[:n], torch.full_like(qx, plan.idw_alpha), {}


def _execute_chunked(plan: InterpolationPlan, qx, qy):
    dx, dy, dz = plan.data
    params = plan.params
    if plan.knn == "grid":
        r_obs = grid_r_obs(plan.grid, qx, qy, params.k)
    else:
        r_obs = brute_r_obs(dx, dy, qx, qy, params.k, q_chunk=plan.q_chunk, d_chunk=plan.d_chunk)
    alpha = adaptive_alpha(r_obs, plan.m, plan.area, params)
    z = _interpolate_pass2(dx, dy, dz, qx, qy, alpha, params, q_chunk=plan.q_chunk, d_chunk=plan.d_chunk)
    return z, alpha, {}


def _as_queries(plan: InterpolationPlan, q):
    t = torch.as_tensor(q, device=plan.device)
    if t.dtype != plan.dtype or t.dim() != 1:
        raise ValueError(f"queries must be 1-D {plan.dtype}, got {tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def _execute(plan: InterpolationPlan, qx, qy):
    # Input hardening: a NaN/Inf query would flow through the kernel
    # min-reductions into a silently wrong finite alpha and z.  Compute with
    # an in-bbox dummy in its place and NaN-mask its outputs: NaN in, NaN out.
    qx, qy = _as_queries(plan, qx), _as_queries(plan, qy)
    bad = ~(torch.isfinite(qx) & torch.isfinite(qy))
    qx = torch.where(bad, 0.0, qx)
    qy = torch.where(bad, 0.0, qy)
    if plan.impl == "grid":
        z, a, stats = _execute_grid(plan, qx, qy)
    elif plan.impl == "idw":
        z, a, stats = _execute_idw(plan, qx, qy)
    elif plan.impl == "chunked":
        z, a, stats = _execute_chunked(plan, qx, qy)
    else:
        z, a, stats = _execute_dense(plan, qx, qy)
    nan = torch.tensor(float("nan"), dtype=z.dtype, device=z.device)
    return torch.where(bad, nan, z), torch.where(bad, nan, a), stats


def execute(plan: InterpolationPlan, qx, qy):
    """Interpolate one query batch on the plan's device.  Returns
    ``(z_hat, alpha)``, shape ``(n,)`` each, in caller order.  A query with a
    NaN/Inf coordinate yields NaN in both; the other queries are computed as
    if the bad slots held in-bbox dummies."""
    z, a, _ = _execute(plan, qx, qy)
    return z, a


# Persistent-overflow tracking: per plan object, the run of consecutive
# execute_with_stats batches with overflow_queries > 0.  At the threshold a
# one-shot warning suggests a re-plan; repro_torch.serving.CapacityReestimator
# turns the same streak into an automatic re-plan and swap.
PERSISTENT_OVERFLOW_BATCHES = 3
_overflow_streaks: dict[int, int] = {}
_overflow_lock = threading.Lock()


def _note_overflow(plan: InterpolationPlan, n_overflow: int) -> bool:
    key = id(plan)
    with _overflow_lock:
        if key not in _overflow_streaks:
            weakref.finalize(plan, _overflow_streaks.pop, key, None)
        streak = _overflow_streaks.get(key, 0) + 1 if n_overflow > 0 else 0
        _overflow_streaks[key] = streak
    if streak == PERSISTENT_OVERFLOW_BATCHES:
        warnings.warn(
            f"overflow_queries > 0 for {streak} consecutive batches against this plan: the static "
            "candidate capacity looks undersized for the serving workload (results stay exact via "
            "the ring-search blend, but at ring-search cost). Consider re-planning with a lower "
            "query_occupancy= or a coarser grid — or serve through "
            "repro_torch.serving.CapacityReestimator, which re-plans and swaps automatically.",
            CapacityOverflowWarning, stacklevel=3)
    return streak >= PERSISTENT_OVERFLOW_BATCHES


def execute_with_stats(plan: InterpolationPlan, qx, qy):
    """Like :func:`execute`, plus the impl's diagnostics.

    ``grid``: ``overflow_blocks`` / ``overflow_queries`` (how much of the batch
    exceeded the plan's candidate capacity and took the ring-search arm),
    ``overflow_query_mask`` (bool ``(n,)``, caller order),
    ``skipped_tile_fraction`` (share of Phase-1 candidate tiles the tile
    table skips), ``cand_need_max``, ``grid_fallback`` (every query
    overflowed) and ``persistent_overflow`` (overflow persisted for
    ``PERSISTENT_OVERFLOW_BATCHES`` consecutive batches against this plan;
    a :class:`CapacityOverflowWarning` fires when the streak is reached).
    A far-field plan adds ``near_points_mean`` (near candidates per block),
    ``far_cells_mean`` (far cells per block), ``p2_overflow_queries``
    (queries whose block's near field overflowed ``p2_capacity`` and took the
    exact sweep) and ``farfield_rtol_bound`` (the plan's proved bound), each
    counted over blocks holding a real query.  A quadtree plan reports the
    same near and overflow keys, with ``far_cells_mean`` the closed nodes
    per block summed over the levels, plus ``cells_per_level`` (its split
    by level, shape ``(n_levels,)``), ``opened_fraction`` (opened over
    processed nonempty nodes: how deep the walk descends) and
    ``quadtree_rtol_bound`` (the plan's proved bound); a block whose node
    table overflows a level's width counts among ``p2_overflow_queries``.
    ``tiled_v2``: ``merge_fraction``, the share of (query block, data tile)
    steps that ran the k-best merge.  The other impls report ``{}``.
    This entry syncs with the device to read ``overflow_queries``.
    """
    z, a, stats = _execute(plan, qx, qy)
    if plan.impl == "grid":
        stats["persistent_overflow"] = _note_overflow(plan, int(stats["overflow_queries"]))
    return z, a, stats
