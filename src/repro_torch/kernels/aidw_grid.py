"""Grid-path kernel plumbing over a plan's CSR grid snapshot.  Counterpart
of the exact-path and far-field parts of ``repro.kernels.aidw_grid``.

* :func:`block_rectangles` - each query block's candidate rectangle (cell
  coords): the bbox of its home cells grown by the block's max safe radius.
* :func:`gather_candidates_csr` - each rectangle row ``(y, xlo..xhi)`` is one
  contiguous run of the CSR point arrays; a block's candidates are decoded
  into a static ``capacity``-wide row (sentinel-padded) by a batched
  ``searchsorted`` over the per-row prefix sums.  Also returns each block's
  true need, so the engine can route overflowing blocks to the exact ring
  search; ``with_z=True`` also gathers the z row (the far-field near field).
* :func:`phase1_alpha_from_candidates` - Phase 1 over the candidate rows:
  ``csrc/knn.cu`` with the per-block tile table (the port of
  ``_knn_kernel_skip``, pipeline "prefetch") or without it (the dense walk
  of ``_knn_kernel_soa``, pipeline "dense").
* :func:`phase2_weights_full` - exact Phase 2, ``csrc/weight.cu`` over all
  data points (the port of ``_weight_kernel_soa``).
* :func:`phase2_near_weights` - the far-field plan's near field,
  ``csrc/near.cu`` (the port of ``_near_weight_kernel``): the exact weight
  sums over each block's near candidate row, walked through its tile table,
  returned raw.
* :func:`phase2_far_aggregates` - the far field, ``csrc/far.cu`` (the port of
  ``_far_cell_kernel``): one aggregate term per cell outside the block's near
  rectangle.  :func:`row_launch` picks both kernels' threads a CUDA block.
* :func:`phase2_far_nodes` - one level of the quadtree far field,
  ``csrc/far_node.cu`` (the port of ``_far_node_kernel``): one aggregate and
  dipole term per closed node of each block's node table.
  :func:`far_node_launch` picks its threads a CUDA block and a query.

Each kernel wrapper runs its plain version (beside it, tile by tile as the
Pallas kernel sums) when given CPU tensors, and launches its kernel or
raises when given CUDA tensors.  In float32 the kernels of B4, B5 and B6
take their weights from the special-function units;
:func:`phase2_near_tolerance`, :func:`phase2_far_tolerance` and
:func:`phase2_far_nodes_tolerance` give the per-query tolerance of their
sums against the plain versions.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.aidw import AIDWParams, tiny_for
from repro_torch.core.grid import UniformGrid
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    EPS32,
    SUM_RUN,
    pow_weight,
    run_sum,
    sfu_sum_tolerance,
    sfu_term_budget,
    sfu_weight_eps,
    sq_dist_tile,
    weight_tile,
)
from repro_torch.kernels.aidw_tiled import _check_float, _on_card, _sm_count, _suffix, knn_alpha, weight_sweep

# row_launch halves a CUDA block's threads while the batch has fewer CUDA
# blocks a SM than this, down to 64 (near.cu) or 128 (far.cu) threads
_ROW_BLOCKS_PER_SM = 4
# far_node_launch doubles S from 2 to 4 while the batch has fewer threads a
# SM than this
_FAR_NODE_THREADS_PER_SM = 1024
_FAR_NODE_THREADS = 128  # threads a CUDA block of far_node.cu


def block_rectangles(grid: UniformGrid, cx, cy, r_safe, block_q: int):
    """Inclusive cell bounds ``(xlo, xhi, ylo, yhi)``, ``(nb,)`` each, of every
    block of ``block_q`` consecutive queries, clipped to the grid."""
    nb = cx.shape[0] // block_q
    cxb = cx.reshape(nb, block_q)
    cyb = cy.reshape(nb, block_q)
    rb = r_safe.reshape(nb, block_q).amax(dim=1)
    xlo = (cxb.amin(dim=1) - rb).clamp(0, grid.gx - 1)
    xhi = (cxb.amax(dim=1) + rb).clamp(0, grid.gx - 1)
    ylo = (cyb.amin(dim=1) - rb).clamp(0, grid.gy - 1)
    yhi = (cyb.amax(dim=1) + rb).clamp(0, grid.gy - 1)
    return xlo, xhi, ylo, yhi


def gather_candidates_csr(grid: UniformGrid, xlo, xhi, ylo, yhi, capacity: int, with_z: bool = False):
    """Per-block candidate rows of static width from the CSR snapshot.

    Returns ``(cand_x, cand_y, need)``: candidates ``(nb, capacity)`` and the
    true per-block candidate count ``need (nb,)``.  Slots past a block's count,
    and every slot past ``capacity`` when it overflows, read the CSR sentinel
    slot (index ``m``).  ``need > capacity`` means the row is incomplete.
    ``with_z=True`` also gathers the z rows (sentinel slots get z = 0,
    weightless) and returns ``(cand_x, cand_y, cand_z, need)``.
    """
    nb = xlo.shape[0]
    gx, gy = grid.gx, grid.gy
    dev = xlo.device
    rows = torch.arange(gy, device=dev)[None, :]
    ht = yhi - ylo + 1
    y = ylo[:, None] + rows
    row_ok = rows < ht[:, None]
    ysafe = y.clamp(max=gy - 1)
    c = grid.cum.long()
    x0 = xlo[:, None]
    x1 = xhi[:, None] + 1
    cnt = c[ysafe + 1, x1] - c[ysafe + 1, x0] - c[ysafe, x1] + c[ysafe, x0]
    cnt = torch.where(row_ok, cnt, 0)
    offs = torch.cat([torch.zeros((nb, 1), dtype=torch.long, device=dev), torch.cumsum(cnt, dim=1)], dim=1)
    need = offs[:, -1]

    s = torch.arange(capacity, device=dev)[None, :].expand(nb, capacity).contiguous()
    row = (torch.searchsorted(offs, s, right=True) - 1).clamp(0, gy - 1)
    within = s - torch.gather(offs, 1, row)
    base_cid = (ylo[:, None] + row) * gx + x0
    idx = grid.starts.long()[base_cid.clamp(0, grid.n_cells)] + within
    m = grid.n_points
    valid = s < need.clamp(max=capacity)[:, None]
    idx = torch.where(valid, idx.clamp(0, m - 1), m)  # m = sentinel slot
    if with_z:
        return grid.pt_x[idx], grid.pt_y[idx], grid.pt_z[idx], need
    return grid.pt_x[idx], grid.pt_y[idx], need


def phase1_alpha_from_candidates(qx_s, qy_s, cand_x, cand_y, *, params: AIDWParams, area: float,
                                 m_real: int, block_q: int, block_d: int, num_tiles=None):
    """Phase 1 over per-block candidate rows; returns alpha ``(n_tot,)``.

    ``num_tiles`` (int32 ``(nb,)``, ``ceil(covered_need / block_d)``) walks
    each block only through its own real tiles (pipeline "prefetch");
    ``None`` walks every tile (pipeline "dense").  Both merge the same
    non-sentinel candidates, so their alpha agrees bit for bit.
    """
    return knn_alpha(qx_s, qy_s, cand_x, cand_y, block_q=block_q, tile_d=block_d,
                     num_tiles=num_tiles, params=params, area=area, m_real=m_real)


def phase2_weights_full(qx_s, qy_s, alpha, dxp, dyp, dzp, *, eps: float, block_d: int):
    """Exact Phase 2 over all (sentinel-padded, ``block_d``-multiple) data
    points; returns z ``(n_tot,)``."""
    return weight_sweep(qx_s, qy_s, alpha * 0.5, dxp, dyp, dzp, tile_d=block_d, eps=eps)


def _check_blocks(name: str, n: int, block_q: int, rows: int) -> None:
    if block_q <= 0 or n % block_q or rows * block_q != n:
        raise ValueError(f"{name}: {n} queries do not make {rows} blocks of {block_q}")


def row_launch(n: int, sms: int, *, block_q: int = 256, far: bool = False) -> int:
    """Threads a CUDA block of the near-field kernel (``csrc/near.cu``) or,
    with ``far``, the far-cell kernel (``csrc/far.cu``), one query a thread,
    for a batch of ``n`` queries in plan blocks of ``block_q`` on a card with
    ``sms`` multiprocessors.  A CUDA block lies inside one plan block and
    sweeps that block's whole row (its near candidates, or every cell), so a
    batch of few plan blocks gives few CUDA blocks a SM: near rows differ in
    length (3 to 35 tiles in the 65,536 batch of ``aidw-pod-1m``), and equal
    far rows leave SMs idle when the blocks do not share evenly.  Smaller
    CUDA blocks spread the work more evenly; the far kernel, which restages
    every cell per CUDA block, stops at 128.  Halves from 256 while the batch
    has fewer than ``_ROW_BLOCKS_PER_SM`` CUDA blocks a SM, down to 64 or
    128 (``chip_smoke.py`` phase 32 times 64, 128 and 256); always a divisor
    of ``block_q``.  A query's sums do not depend on it."""
    fewest = 128 if far else 64
    threads = 256
    while threads > fewest and n < threads * _ROW_BLOCKS_PER_SM * sms:
        threads //= 2
    return math.gcd(block_q, threads)


def phase2_near_weights_plain(qx, qy, alpha_half, cand_x, cand_y, cand_z, num_tiles, *, block_q: int,
                              tile_d: int):
    """Plain version of :func:`phase2_near_weights`: ``weight_tile`` tile by
    tile, each tile summed in the kernel's order (``run_sum``) and folded
    into the running sums, a row left untouched past its tile count."""
    n = qx.shape[0]
    nb, c_tot = cand_x.shape
    zeros = torch.zeros((n, 1), dtype=qx.dtype, device=qx.device)
    sum_w, sum_wz, hit_z = zeros, zeros, zeros
    min_d2 = torch.full((n, 1), math.inf, dtype=qx.dtype, device=qx.device)
    qx3, qy3 = qx.reshape(nb, block_q, 1), qy.reshape(nb, block_q, 1)
    ah2 = alpha_half[:, None]
    steps = min(c_tot // tile_d, int(num_tiles.max()) if nb else 0)
    for j in range(steps):
        s = slice(j * tile_d, (j + 1) * tile_d)
        d2 = sq_dist_tile(qx3, qy3, cand_x[:, None, s], cand_y[:, None, s]).reshape(n, tile_d)
        dz = cand_z[:, None, s].expand(nb, block_q, tile_d).reshape(n, tile_d)
        sw, swz, tmin, thz = weight_tile(d2, dz, ah2, in_runs=True)
        live = (j < num_tiles).repeat_interleave(block_q)[:, None]
        sum_w = torch.where(live, sum_w + sw, sum_w)
        sum_wz = torch.where(live, sum_wz + swz, sum_wz)
        better = live & (tmin < min_d2)
        hit_z = torch.where(better, thz, hit_z)
        min_d2 = torch.where(better, tmin, min_d2)
    return sum_w[:, 0], sum_wz[:, 0], min_d2[:, 0], hit_z[:, 0]


def phase2_near_weights(qx, qy, alpha_half, cand_x, cand_y, cand_z, num_tiles, *, block_q: int,
                        tile_d: int):
    """Exact near-field weight sweep over per-block candidate rows.

    ``qx, qy, alpha_half (n,)`` with ``n = nb * block_q``; ``cand_x, cand_y,
    cand_z (nb, c)`` the near-rectangle candidates, ``c % tile_d == 0`` and
    ``tile_d % SUM_RUN == 0``;
    ``num_tiles (nb,)`` int32, row i walks its first ``num_tiles[i]`` tiles
    (the full tile count is a dense walk, the same bits: the skipped tiles
    are all sentinel).  Returns the raw ``(sum_w, sum_wz, min_d2, hit_z)``,
    ``(n,)`` each.
    """
    n = qx.shape[0]
    nb, c_tot = cand_x.shape
    _check_blocks("phase2_near_weights", n, block_q, nb)
    if (tile_d <= 0 or tile_d % SUM_RUN or c_tot % tile_d or not (cand_y.shape == cand_z.shape == cand_x.shape)
            or not (qy.shape == alpha_half.shape == qx.shape) or num_tiles.shape != (nb,)):
        raise ValueError(f"phase2_near_weights: bad shapes q={tuple(qx.shape)} cand={tuple(cand_x.shape)} "
                         f"num_tiles={tuple(num_tiles.shape)} tile_d={tile_d}")
    if not _on_card("phase2_near_weights", qx, qy, alpha_half, cand_x, cand_y, cand_z, num_tiles):
        return phase2_near_weights_plain(qx, qy, alpha_half, cand_x, cand_y, cand_z, num_tiles,
                                         block_q=block_q, tile_d=tile_d)
    _check_float("phase2_near_weights", qx, qy, alpha_half, cand_x, cand_y, cand_z)
    if num_tiles.dtype != torch.int32 or not num_tiles.is_contiguous():
        raise ValueError("phase2_near_weights: num_tiles must be a contiguous int32 tensor")
    out = [torch.empty_like(qx) for _ in range(4)]
    fn = _build.entry(f"aidw_near_weight_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), alpha_half.data_ptr(), cand_x.data_ptr(), cand_y.data_ptr(),
             cand_z.data_ptr(), num_tiles.data_ptr(), n, block_q, c_tot, tile_d,
             row_launch(n, _sm_count(qx.device.index), block_q=block_q), tiny_for(qx.dtype),
             *(o.data_ptr() for o in out), torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "phase2_near_weights launch")
    _build.LAUNCHES["near_weight"] += 1
    return tuple(out)


def phase2_near_tolerance(qx, qy, alpha_half, cand_x, cand_y, cand_z, num_tiles, *, block_q: int, tile_d: int):
    """Per-query tolerance ``(tol_w, tol_wz)``, float64 ``(n,)`` each, of
    the float32 kernel's ``sum_w`` and ``sum_wz`` (``csrc/near.cu``, weights
    on the special-function units) against :func:`phase2_near_weights_plain`
    on the same inputs: ``sfu_sum_tolerance`` of the terms ``w`` and ``w z``
    that each query's walked tiles hold (``kernels/_common.py``)."""
    n = qx.shape[0]
    nb, c_tot = cand_x.shape
    acc = torch.zeros((4, n), dtype=torch.float64, device=qx.device)
    qx3, qy3 = qx.reshape(nb, block_q, 1), qy.reshape(nb, block_q, 1)
    ah2 = alpha_half[:, None]
    tiles = torch.clamp(num_tiles.long(), 0, c_tot // tile_d)
    for j in range(int(tiles.max()) if nb else 0):
        s = slice(j * tile_d, (j + 1) * tile_d)
        d2 = sq_dist_tile(qx3, qy3, cand_x[:, None, s], cand_y[:, None, s]).reshape(n, tile_d)
        dz = cand_z[:, None, s].expand(nb, block_q, tile_d).reshape(n, tile_d)
        w, eps = pow_weight(d2, ah2), sfu_weight_eps(d2, ah2)
        live = (j < tiles).repeat_interleave(block_q)
        for i, term in ((0, w), (2, w * dz)):
            acc[i:i + 2] += torch.where(live, torch.stack(sfu_term_budget(term, eps)), 0.0)
    walked = tiles.repeat_interleave(block_q)
    return tuple(sfu_sum_tolerance(acc[i], acc[i + 1], tile_d, walked) for i in (0, 2))


def phase2_far_aggregates_plain(qx, qy, alpha_half, rects, far, *, block_q: int, tile_d: int):
    """Plain version of :func:`phase2_far_aggregates`, tile by tile, each
    tile summed in the kernel's order (``run_sum``)."""
    fx, fy, fcnt, fzs, fix, fiy = far
    n = qx.shape[0]
    zeros = torch.zeros((n,), dtype=qx.dtype, device=qx.device)
    sum_w, sum_wz = zeros, zeros
    rq = rects.long().repeat_interleave(block_q, dim=0)
    xlo, xhi, ylo, yhi = (rq[:, i:i + 1] for i in range(4))
    qx2, qy2, ah2 = qx[:, None], qy[:, None], alpha_half[:, None]
    for j in range(fx.shape[0] // tile_d):
        s = slice(j * tile_d, (j + 1) * tile_d)
        w = pow_weight(sq_dist_tile(qx2, qy2, fx[None, s], fy[None, s]), ah2)
        ix, iy = fix[None, s], fiy[None, s]
        inside = (ix >= xlo) & (ix <= xhi) & (iy >= ylo) & (iy <= yhi)
        w = torch.where(inside, 0.0, w)
        sum_w = sum_w + run_sum(w * fcnt[None, s])[:, 0]
        sum_wz = sum_wz + run_sum(w * fzs[None, s])[:, 0]
    return sum_w, sum_wz


def phase2_far_tolerance(qx, qy, alpha_half, rects, far, *, block_q: int, tile_d: int):
    """Per-query tolerance ``(tol_w, tol_wz)``, float64 ``(n,)`` each, of
    the float32 kernel's sums (``csrc/far.cu``, weights on the
    special-function units) against :func:`phase2_far_aggregates_plain` on
    the same inputs: ``sfu_sum_tolerance`` of the terms ``w count`` and ``w
    z_sum`` of the cells outside each block's rectangle
    (``kernels/_common.py``)."""
    fx, fy, fcnt, fzs, fix, fiy = far
    n = qx.shape[0]
    acc = torch.zeros((4, n), dtype=torch.float64, device=qx.device)
    rq = rects.long().repeat_interleave(block_q, dim=0)
    xlo, xhi, ylo, yhi = (rq[:, i:i + 1] for i in range(4))
    qx2, qy2, ah2 = qx[:, None], qy[:, None], alpha_half[:, None]
    tiles = fx.shape[0] // tile_d
    for j in range(tiles):
        s = slice(j * tile_d, (j + 1) * tile_d)
        d2 = sq_dist_tile(qx2, qy2, fx[None, s], fy[None, s])
        ix, iy = fix[None, s], fiy[None, s]
        outside = ~((ix >= xlo) & (ix <= xhi) & (iy >= ylo) & (iy <= yhi))
        w, eps = torch.where(outside, pow_weight(d2, ah2), 0.0), sfu_weight_eps(d2, ah2)
        for i, term in ((0, w * fcnt[None, s]), (2, w * fzs[None, s])):
            acc[i:i + 2] += torch.stack(sfu_term_budget(term, eps))
    return tuple(sfu_sum_tolerance(acc[i], acc[i + 1], tile_d, tiles) for i in (0, 2))


def phase2_far_aggregates(qx, qy, alpha_half, rects, far, *, block_q: int, tile_d: int):
    """Far-field aggregate sweep: every cell of the grid, one term each.

    ``rects (nb, 4)`` int32: each block's near rectangle (inclusive cell
    bounds ``xlo, xhi, ylo, yhi``), masked out of the far sum; ``far`` the
    plan's padded ``(ncp,)`` arrays ``(cent_x, cent_y, count, z_sum, ix,
    iy)``, ``ncp % tile_d == 0``, ``tile_d % SUM_RUN == 0``.  Returns ``(sum_w, sum_wz)``, ``(n,)`` each.
    """
    n = qx.shape[0]
    nb = rects.shape[0]
    _check_blocks("phase2_far_aggregates", n, block_q, nb)
    fx, fy, fcnt, fzs, fix, fiy = far
    ncp = fx.shape[0]
    if (tile_d <= 0 or tile_d % SUM_RUN or ncp % tile_d or rects.shape != (nb, 4)
            or any(a.shape != (ncp,) for a in far) or not (qy.shape == alpha_half.shape == qx.shape)):
        raise ValueError(f"phase2_far_aggregates: bad shapes q={tuple(qx.shape)} rects={tuple(rects.shape)} "
                         f"far={[tuple(a.shape) for a in far]} tile_d={tile_d}")
    if not _on_card("phase2_far_aggregates", qx, qy, alpha_half, rects, *far):
        return phase2_far_aggregates_plain(qx, qy, alpha_half, rects, far, block_q=block_q, tile_d=tile_d)
    _check_float("phase2_far_aggregates", qx, qy, alpha_half, fx, fy, fcnt, fzs)
    for name, a in (("rects", rects), ("ix", fix), ("iy", fiy)):
        if a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError(f"phase2_far_aggregates: {name} must be a contiguous int32 tensor")
    sum_w, sum_wz = torch.empty_like(qx), torch.empty_like(qx)
    fn = _build.entry(f"aidw_far_cell_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), alpha_half.data_ptr(), rects.data_ptr(),
             *(a.data_ptr() for a in far), n, block_q, ncp, tile_d,
             row_launch(n, _sm_count(qx.device.index), block_q=block_q, far=True), tiny_for(qx.dtype),
             sum_w.data_ptr(), sum_wz.data_ptr(), torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "phase2_far_aggregates launch")
    _build.LAUNCHES["far_cell"] += 1
    return sum_w, sum_wz


def far_node_launch(n: int, sms: int, *, block_q: int = 256) -> tuple[int, int]:
    """``(threads, S)`` of a launch of the quadtree kernel
    (``csrc/far_node.cu``) for a batch of ``n`` queries in plan blocks of
    ``block_q`` on a card with ``sms`` multiprocessors: S threads share a
    query and take every S-th run of its walk, and a CUDA block holds
    ``threads / S`` queries of one plan block.  One thread a query leaves an
    SM of a serving batch (81,920 queries after the seam split) about 620
    threads, too few to hide the gathers' and the special-function units'
    latency.  S = 2 was faster than S = 1 at every batch size measured, 2^20
    queries included, and S = 4 faster still where the batch gives fewer
    than ``_FAR_NODE_THREADS_PER_SM`` threads a SM at S = 2 (8,192 queries);
    128 threads a block was within 3% of the fastest block size
    (``chip_smoke.py`` phase 33 times S = 1, 2, 4 at 64, 128 and 256
    threads a block).  A query's sums do not depend on it."""
    splits = 2
    while splits < 4 and n * splits < _FAR_NODE_THREADS_PER_SM * sms:
        splits *= 2
    queries = math.gcd(block_q, _FAR_NODE_THREADS // splits)
    return queries * splits, splits


def far_node_terms(qx3, qy3, alpha_half3, ids, nodes):
    """The plain version's terms of one tile of node ids, each ``(nb,
    block_q, tile)`` for queries ``(nb, block_q, 1)`` and ids ``(nb, 1,
    tile)``: ``(d2, w, w count, w z_sum, dip)``, the aggregate term ``w
    count`` and the z term ``w z_sum + dip``, with ``dip = (((2 ah) w) /
    max(d^2, tiny)) (dqx mx + dqy my)``."""
    fx, fy, fcnt, fzs, fmx, fmy = nodes
    dqx = qx3 - fx[ids]
    dqy = qy3 - fy[ids]
    d2 = dqx * dqx + dqy * dqy
    w = pow_weight(d2, alpha_half3)
    grad = (2.0 * alpha_half3) * w / torch.clamp(d2, min=tiny_for(d2.dtype))
    dip = grad * (dqx * fmx[ids] + dqy * fmy[ids])
    return d2, w, w * fcnt[ids], w * fzs[ids], dip


def phase2_far_nodes_plain(qx, qy, alpha_half, tbl, num_tiles, nodes, *, block_q: int, tile_d: int):
    """Plain version of :func:`phase2_far_nodes`: the kernel's arithmetic tile
    by tile (:func:`far_node_terms`), each tile summed in the kernel's order
    (``run_sum``) and folded into the running sums, a row left untouched past
    its tile count.  It walks whole tiles, where the kernel may stop at the
    closed nodes: the same bits."""
    n = qx.shape[0]
    nb, k_pad = tbl.shape
    sum_w = torch.zeros((n,), dtype=qx.dtype, device=qx.device)
    sum_wz = torch.zeros_like(sum_w)
    qx3, qy3 = qx.reshape(nb, block_q, 1), qy.reshape(nb, block_q, 1)
    ah3 = alpha_half.reshape(nb, block_q, 1)
    ids_all = torch.where((tbl < 0) | (tbl >= nodes[0].shape[0]), nodes[0].shape[0] - 1, tbl).long()
    steps = min(k_pad // tile_d, int(num_tiles.max()) if nb else 0)
    for j in range(steps):
        _, _, a, wz, dip = far_node_terms(qx3, qy3, ah3, ids_all[:, None, j * tile_d:(j + 1) * tile_d], nodes)
        tile_w = run_sum(a.reshape(n, tile_d))[:, 0]
        tile_wz = run_sum((wz + dip).reshape(n, tile_d))[:, 0]
        live = (j < num_tiles).repeat_interleave(block_q)
        sum_w = torch.where(live, sum_w + tile_w, sum_w)
        sum_wz = torch.where(live, sum_wz + tile_wz, sum_wz)
    return sum_w, sum_wz


def phase2_far_nodes_tolerance(qx, qy, alpha_half, tbl, num_tiles, nodes, *, block_q: int, tile_d: int):
    """Per-query tolerance ``(tol_w, tol_wz)``, float64 ``(n,)`` each, of
    the float32 kernel's sums (``csrc/far_node.cu``: w from the
    special-function units, the dipole's division a product with
    ``rcp.approx``) against :func:`phase2_far_nodes_plain` on the same
    inputs, from the terms ``a = w count`` and ``b = w z_sum + dip`` of each
    query's walked tiles::

        tol_w  = sum |a| (eps + u) + slack(sum |a|)
        tol_wz = sum (|w z_sum| (eps + 2 u) + |dip| (eps + 5 u)) + slack(sum |b|)

    with ``u = 2^-23`` and ``eps`` w's own budget (``sfu_weight_eps``).
    ``u``: a product with count or z_sum, rounded on each side, half an ulp
    each.  The dipole, ``((2 ah) w) rcp(d^2)`` times the moment term against
    ``((2 ah) w) / d^2`` times the same moment term: w's error,
    ``rcp.approx``'s 1 ulp, and three roundings on each side, 4 u; the sum
    ``w z_sum + dip``, rounded on each side, u more on both of its parts.
    ``slack``: ``sfu_sum_tolerance``'s summation slack of ``run_sum``'s
    order, which the kernel keeps however many threads share a query (their
    run sums are folded in run order) and wherever it stops (a sentinel run
    adds +0 exactly).  A reciprocal or a weight below float32's normal range
    (d^2 > 2^126, or w < 2^-126) flushes to 0, outside this budget."""
    n = qx.shape[0]
    nb, k_pad = tbl.shape
    acc = torch.zeros((4, n), dtype=torch.float64, device=qx.device)
    qx3, qy3 = qx.reshape(nb, block_q, 1), qy.reshape(nb, block_q, 1)
    ah3 = alpha_half.reshape(nb, block_q, 1)
    ids_all = torch.where((tbl < 0) | (tbl >= nodes[0].shape[0]), nodes[0].shape[0] - 1, tbl).long()
    tiles = torch.clamp(num_tiles.long(), 0, k_pad // tile_d)
    for j in range(int(tiles.max()) if nb else 0):
        d2, _, a, wz, dip = far_node_terms(qx3, qy3, ah3, ids_all[:, None, j * tile_d:(j + 1) * tile_d], nodes)
        eps = sfu_weight_eps(d2, ah3)
        live = (j < tiles).repeat_interleave(block_q)

        def budget(term, e):
            return sfu_term_budget(term.reshape(n, tile_d), e.reshape(n, tile_d))[0]

        part = torch.stack([budget(a, eps + EPS32), a.double().abs().reshape(n, tile_d).sum(dim=1),
                            budget(wz, eps + 2 * EPS32) + budget(dip, eps + 5 * EPS32),
                            (wz + dip).double().abs().reshape(n, tile_d).sum(dim=1)])
        acc += torch.where(live, part, 0.0)
    walked = tiles.repeat_interleave(block_q)
    return tuple(sfu_sum_tolerance(acc[i], acc[i + 1], tile_d, walked) for i in (0, 2))


def phase2_far_nodes(qx, qy, alpha_half, tbl, num_tiles, nodes, *, block_q: int, tile_d: int, n_closed=None):
    """One quadtree level's far sweep over each block's closed-node table.

    ``qx, qy, alpha_half (n,)`` with ``n = nb * block_q``; ``tbl (nb, k_pad)``
    int32 node ids (pad slots hold the sentinel node's id ``n_nodes``; an id
    outside ``[0, n_nodes]`` is read as the sentinel), ``k_pad % tile_d ==
    0`` and ``tile_d % SUM_RUN == 0``; ``num_tiles (nb,)`` int32, row i walks
    its first ``num_tiles[i]`` tiles; ``nodes`` the level's ``(n_nodes + 1,)``
    arrays ``(cent_x, cent_y, count, z_sum, mx, my)``, the last entry the
    sentinel node.  ``n_closed``, optional ``(nb,)`` int32: row i holds the
    sentinel in every slot from ``n_closed[i]`` on (the walk's compacted
    tables), and the kernel stops there, rounded up to a run of ``SUM_RUN``;
    the plain version walks the whole tiles, and both give the same bits
    (a sentinel slot adds exactly +0).  Returns ``(sum_w, sum_wz)``, ``(n,)``
    each.
    """
    n = qx.shape[0]
    nb, k_pad = tbl.shape
    _check_blocks("phase2_far_nodes", n, block_q, nb)
    n_nodes = nodes[0].shape[0] - 1 if nodes else -1
    if (tile_d <= 0 or tile_d % SUM_RUN or k_pad % tile_d or len(nodes) != 6 or n_nodes < 0
            or any(a.shape != (n_nodes + 1,) for a in nodes) or not (qy.shape == alpha_half.shape == qx.shape)
            or num_tiles.shape != (nb,) or (n_closed is not None and n_closed.shape != (nb,))):
        raise ValueError(f"phase2_far_nodes: bad shapes q={tuple(qx.shape)} tbl={tuple(tbl.shape)} "
                         f"nodes={[tuple(a.shape) for a in nodes]} num_tiles={tuple(num_tiles.shape)} "
                         f"tile_d={tile_d}")
    counts = (num_tiles,) if n_closed is None else (num_tiles, n_closed)
    if not _on_card("phase2_far_nodes", qx, qy, alpha_half, tbl, *counts, *nodes):
        return phase2_far_nodes_plain(qx, qy, alpha_half, tbl, num_tiles, nodes, block_q=block_q, tile_d=tile_d)
    _check_float("phase2_far_nodes", qx, qy, alpha_half, *nodes)
    for name, a in (("tbl", tbl), ("num_tiles", num_tiles), ("n_closed", n_closed)):
        if a is not None and (a.dtype != torch.int32 or not a.is_contiguous()):
            raise ValueError(f"phase2_far_nodes: {name} must be a contiguous int32 tensor")
    sum_w, sum_wz = torch.empty_like(qx), torch.empty_like(qx)
    threads, splits = far_node_launch(n, _sm_count(qx.device.index), block_q=block_q)
    fn = _build.entry(f"aidw_far_node_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), alpha_half.data_ptr(), tbl.data_ptr(), num_tiles.data_ptr(),
             None if n_closed is None else n_closed.data_ptr(), *(a.data_ptr() for a in nodes), n, block_q, k_pad,
             tile_d, n_nodes, threads, splits, tiny_for(qx.dtype), sum_w.data_ptr(), sum_wz.data_ptr(),
             torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "phase2_far_nodes launch")
    _build.LAUNCHES["far_node"] += 1
    return sum_w, sum_wz
