"""Execute: interpolate one query batch against a plan.  Counterpart of
the ``tiled`` and exact ``grid`` branches of ``repro.engine.execute``.

The grid path: Morton-sort the queries, split blocks at Morton seams,
per-query safe radii from the plan's ``required_radius`` table, the
static-capacity CSR candidate gather, Phase 1 over the candidate rows
(``csrc/knn.cu``), the per-query overflow blend with the exact ring search,
exact Phase 2 over all data (``csrc/weight.cu``), unsort.  Exactness is per
block: the kernel's alpha is kept where a block's candidates fit the plan's
capacity, and queries of overflowing blocks take the ring search's alpha.
"""

from __future__ import annotations

import threading
import types
import warnings
import weakref

import torch

from repro_torch.core.aidw import adaptive_alpha
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
    phase2_weights_full,
)
from repro_torch.kernels.aidw_tiled import aidw_tiled_soa


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
        order=order, qx_s=qx_s, qy_s=qy_s, qx_v=qx_v, qy_v=qy_v, src=src, dest=dest,
        cand_x=cand_x, cand_y=cand_y, need=need,
        num_tiles=_tile_table(need, plan.cand_capacity, plan.cand_block_d),
        over_b=over_b, over_q=over_v if dest is None else over_v[dest])


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
    return zhat[:n][inv], alpha[:n][inv], stats


def _execute_dense(plan: InterpolationPlan, qx, qy):
    n = qx.shape[0]
    dx, dy, dz = plan.data
    z, a = aidw_tiled_soa(dx, dy, dz, pad_to(qx, plan.block_q, 0.0), pad_to(qy, plan.block_q, 0.0),
                          params=plan.params, area=plan.area, m_real=plan.m,
                          block_q=plan.block_q, block_d=plan.block_d)
    return z[:n], a[:n], {}


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
# one-shot warning suggests a re-plan.
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
            "query_occupancy= or a coarser grid.",
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
    This entry syncs with the device to read ``overflow_queries``.
    """
    z, a, stats = _execute(plan, qx, qy)
    if plan.impl == "grid":
        stats["persistent_overflow"] = _note_overflow(plan, int(stats["overflow_queries"]))
    return z, a, stats
