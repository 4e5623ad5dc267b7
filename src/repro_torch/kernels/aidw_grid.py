"""Grid-path kernel plumbing over a plan's CSR grid snapshot.  Counterpart
of the exact-path part of ``repro.kernels.aidw_grid``.

* :func:`block_rectangles` - each query block's candidate rectangle (cell
  coords): the bbox of its home cells grown by the block's max safe radius.
* :func:`gather_candidates_csr` - each rectangle row ``(y, xlo..xhi)`` is one
  contiguous run of the CSR point arrays; a block's candidates are decoded
  into a static ``capacity``-wide row (sentinel-padded) by a batched
  ``searchsorted`` over the per-row prefix sums.  Also returns each block's
  true need, so the engine can route overflowing blocks to the exact ring
  search.
* :func:`phase1_alpha_from_candidates` - Phase 1 over the candidate rows:
  ``csrc/knn.cu`` with the per-block tile table (the port of
  ``_knn_kernel_skip``, pipeline "prefetch") or without it (the dense walk
  of ``_knn_kernel_soa``, pipeline "dense").
* :func:`phase2_weights_full` - exact Phase 2, ``csrc/weight.cu`` over all
  data points (the port of ``_weight_kernel_soa``).
"""

from __future__ import annotations

import torch

from repro_torch.core.aidw import AIDWParams
from repro_torch.core.grid import UniformGrid
from repro_torch.kernels.aidw_tiled import knn_alpha, weight_sweep


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


def gather_candidates_csr(grid: UniformGrid, xlo, xhi, ylo, yhi, capacity: int):
    """Per-block candidate rows of static width from the CSR snapshot.

    Returns ``(cand_x, cand_y, need)``: candidates ``(nb, capacity)`` and the
    true per-block candidate count ``need (nb,)``.  Slots past a block's count,
    and every slot past ``capacity`` when it overflows, read the CSR sentinel
    slot (index ``m``).  ``need > capacity`` means the row is incomplete.
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
