"""Uniform-grid spatial partition for the Phase-1 kNN search, and the
per-cell aggregates of the far-field Phase 2.  Counterpart of the exact-path
and single-level far-field parts of ``repro.core.grid``.

Points are bucketed into ``gx x gy`` cells and kept twice: a padded
``(n_cells + 1, cap)`` layout (sentinel-filled; the last row is all
sentinel, the gather target for masked cells) and a CSR twin (points sorted
by cell, one trailing sentinel slot, row pointers ``starts``).  A
``(gy+1, gx+1)`` integral image ``cum`` of the occupancy answers "how many
points in this cell block" in O(1).

Ring-search invariant: for a query whose clamped home cell is C, every point
in a cell at Chebyshev distance ``c`` from C lies at Euclidean distance
``>= (c - 1) * min(cell_w, cell_h)``, so once rings ``0..r`` are merged the
search may stop when ``kth_best^2 <= (r * cell_min)^2``.

Floating-point detail kept from the reference: ``origin`` and ``cell_size``
are float32, computed in Python float64 and cast.  ``build_grid`` offsets
by the exact data minimum, while :func:`cell_of` offsets by the float32
origin, promoted to the query dtype; both must be reproduced exactly, or cell
ids (and with them every capacity and overflow mask) differ at cell edges.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.aidw import mean_k, sqrt_rn
from repro_torch.core.knn import running_k_best
from repro_torch.core.layouts import coord_sentinel

# Default mean points per cell the auto-resolution aims for.
DEFAULT_OCCUPANCY = 16.0

# Cells per axis are clamped here (Morton ids then fit in 18 bits).
MAX_CELLS_PER_AXIS = 512

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1

# Squared distances one fold of the ring search holds at once (64 MiB in
# float32): ring cells are folded in chunks of this many query-point pairs.
_RING_FOLD_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """Padded uniform-grid bucketing of an attributed 2-D point set.

    ``gx, gy`` cells per axis; ``cap`` the max occupancy; ``origin`` and
    ``cell_size`` float32 ``(2,)``; ``cell_x/y/z`` the padded ``(gx*gy + 1,
    cap)`` layout; ``counts (gy, gx)`` and ``cum (gy+1, gx+1)`` int32;
    ``pt_x/y/z (m + 1,)`` the CSR points with a trailing sentinel slot and
    ``starts (gx*gy + 1,)`` int32 their row pointers.
    """

    gx: int
    gy: int
    cap: int
    origin: torch.Tensor
    cell_size: torch.Tensor
    cell_x: torch.Tensor
    cell_y: torch.Tensor
    cell_z: torch.Tensor
    counts: torch.Tensor
    cum: torch.Tensor
    pt_x: torch.Tensor
    pt_y: torch.Tensor
    pt_z: torch.Tensor
    starts: torch.Tensor

    @property
    def n_cells(self) -> int:
        return self.gx * self.gy

    @property
    def n_points(self) -> int:
        return self.pt_x.shape[0] - 1


def _padded_cells(cid_s, rank, n_cells, cap, vals, fill):
    out = torch.full((n_cells + 1, cap), fill, dtype=vals.dtype, device=vals.device)
    out[cid_s, rank] = vals
    return out


def grid_from_csr(gx, gy, origin, cell_size, counts, cum, pt_x, pt_y, pt_z, starts) -> UniformGrid:
    """Assemble a grid from its CSR arrays, rebuilding the padded layout."""
    n_cells = gx * gy
    m = pt_x.shape[0] - 1
    flat = counts.reshape(-1).long()
    cap = max(int(flat.max()), 1)
    cid_s = torch.repeat_interleave(torch.arange(n_cells, device=flat.device), flat)
    rank = torch.arange(m, device=flat.device) - starts.long()[cid_s]
    big = torch.finfo(pt_x.dtype).max / 4
    return UniformGrid(
        gx, gy, cap, origin, cell_size,
        _padded_cells(cid_s, rank, n_cells, cap, pt_x[:m], big),
        _padded_cells(cid_s, rank, n_cells, cap, pt_y[:m], big),
        _padded_cells(cid_s, rank, n_cells, cap, pt_z[:m], 0.0),
        counts, cum, pt_x, pt_y, pt_z, starts,
    )


def build_grid(dx, dy, dz=None, *, gx: int | None = None, gy: int | None = None,
               target_occupancy: float = DEFAULT_OCCUPANCY,
               bounds: tuple[float, float, float, float] | None = None) -> UniformGrid:
    """Bucket points into a uniform grid (both layouts, integral image).

    ``gx, gy`` default to ``ceil(sqrt(m / target_occupancy))`` per axis,
    clamped to [1, 512]; ``bounds = (x0, x1, y0, y1)`` defaults to the bbox.
    """
    m = int(dx.shape[0])
    dtype, dev = dx.dtype, dx.device
    if dz is None:
        dz = torch.zeros((m,), dtype=dtype, device=dev)
    if bounds is None:
        x0, x1 = float(dx.min()), float(dx.max())
        y0, y1 = float(dy.min()), float(dy.max())
    else:
        x0, x1, y0, y1 = map(float, bounds)
    if gx is None or gy is None:
        g = max(1, min(MAX_CELLS_PER_AXIS, math.ceil(math.sqrt(m / max(target_occupancy, 1e-9)))))
        gx = gx or g
        gy = gy or g
    # degenerate spans (all points on a line/point) still need a positive cell
    span_x = max(x1 - x0, 1e-12)
    span_y = max(y1 - y0, 1e-12)
    origin = torch.tensor([x0, y0], dtype=torch.float32, device=dev)
    cell_size = torch.tensor([span_x / gx, span_y / gy], dtype=torch.float32, device=dev)

    n_cells = gx * gy
    # offsets from the exact minimum (a dtype scalar), divided by the f32 size
    cx = _floor_to_cell((dx - x0) / cell_size[0].to(dtype), gx)
    cy = _floor_to_cell((dy - y0) / cell_size[1].to(dtype), gy)
    cid = cy * gx + cx

    counts_flat = torch.bincount(cid, minlength=n_cells)
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    starts = torch.searchsorted(cid_s, torch.arange(n_cells + 1, device=dev))
    counts = counts_flat.reshape(gy, gx).to(torch.int32)
    cum = torch.zeros((gy + 1, gx + 1), dtype=torch.int32, device=dev)
    cum[1:, 1:] = torch.cumsum(torch.cumsum(counts_flat.reshape(gy, gx), dim=0), dim=1).to(torch.int32)
    big = coord_sentinel(dtype, dev)
    pt_x = torch.cat([dx[order], big.reshape(1)])
    pt_y = torch.cat([dy[order], big.reshape(1)])
    pt_z = torch.cat([dz[order], torch.zeros((1,), dtype=dtype, device=dev)])
    return grid_from_csr(gx, gy, origin, cell_size, counts, cum, pt_x, pt_y, pt_z,
                         starts.to(torch.int32))


def _floor_i32(v):
    """``int32(floor(v))`` as int64, saturating the cast."""
    return torch.floor(v).clamp(_I32_MIN, _I32_MAX).long()


def _floor_to_cell(v, g: int):
    """``clip(int32(floor(v)), 0, g - 1)``."""
    return _floor_i32(v).clamp(0, g - 1)


def cell_of(grid: UniformGrid, x, y):
    """Clamped home-cell indices ``(cx, cy)`` (int64) for query coordinates."""
    o = grid.origin.to(x.dtype)
    s = grid.cell_size.to(x.dtype)
    return _floor_to_cell((x - o[0]) / s[0], grid.gx), _floor_to_cell((y - o[1]) / s[1], grid.gy)


def block_count(grid: UniformGrid, cx, cy, r):
    """Points inside the (2r+1)^2 cell block centred at ``(cx, cy)``."""
    xlo = (cx - r).clamp(0, grid.gx)
    xhi = (cx + r + 1).clamp(0, grid.gx)
    ylo = (cy - r).clamp(0, grid.gy)
    yhi = (cy + r + 1).clamp(0, grid.gy)
    c = grid.cum.long()
    return c[yhi, xhi] - c[ylo, xhi] - c[yhi, xlo] + c[ylo, xlo]


def cover_radius(grid: UniformGrid, cx, cy):
    """Ring radius at which the block around ``(cx, cy)`` covers the grid."""
    return torch.maximum(torch.maximum(cx, grid.gx - 1 - cx), torch.maximum(cy, grid.gy - 1 - cy))


def _ring_cell_offset(r, i):
    """Decode perimeter index ``i in [0, 8r)`` of Chebyshev ring ``r`` into a
    cell offset ``(ox, oy)``; ring 0 is the single home cell."""
    rr = torch.clamp(r, min=1)
    side = torch.div(i, 2 * rr, rounding_mode="floor")
    t = i - side * 2 * rr
    ox = torch.where(side == 0, -rr + t, torch.where(side == 1, rr, torch.where(side == 2, rr - t, -rr)))
    oy = torch.where(side == 0, -rr, torch.where(side == 1, -rr + t, torch.where(side == 2, rr, rr - t)))
    zero = torch.zeros_like(ox)
    return torch.where(r == 0, zero, ox), torch.where(r == 0, zero, oy)


def _ring_search(grid: UniformGrid, qx, qy, k: int, active=None):
    """Expanding ring search; returns ``(best (n, k), rings)``.

    Each iteration folds one whole Chebyshev ring around every live query's
    clamped home cell into its k-best set, then tests the stop rule once: a
    query stops when ``best[k-1] <= (r * cell_min)^2`` or ``r >= r_cover``.
    Every live query advances one ring per iteration, so all of them are at
    the same ``r`` and share ring r's ``8r`` cell offsets; the cells are
    folded in chunks of at most ``_RING_FOLD_ELEMS`` distances with no sync
    between chunks.  Cells outside the grid, and every cell of a ring the
    integral image shows empty, read the all-sentinel row (+inf, folded as
    nothing).  ``running_k_best`` keeps the k smallest values, duplicates
    included, so the result does not depend on the order of the folds: it
    has the bits of the JAX package's ``while_loop``, which folds one cell
    per step, wherever the two round d^2 alike.  The one sync per ring picks
    the queries that go on.  Only the ``active`` queries enter, so an
    all-inactive batch walks zero rings: on the serving path the search
    serves only queries whose block overflowed the plan's capacity.  It is
    plain tensor code, not a kernel; a kernel for it is later work.
    """
    n = qx.shape[0]
    dtype, dev = qx.dtype, qx.device
    out = torch.full((n, k), math.inf, dtype=dtype, device=dev)
    idx = torch.arange(n, device=dev) if active is None else torch.nonzero(active).reshape(-1)
    if idx.numel() == 0:
        return out, 0
    qx, qy = qx[idx], qy[idx]
    gx, gy = grid.gx, grid.gy
    cx, cy = cell_of(grid, qx, qy)
    cell_min = torch.minimum(grid.cell_size[0], grid.cell_size[1]).to(dtype)
    r_cover = cover_radius(grid, cx, cy)
    best = out[:idx.shape[0]].clone()
    live = torch.arange(idx.shape[0], device=dev)
    r = 0
    while True:
        lx, ly, lcx, lcy = qx[live, None], qy[live, None], cx[live, None], cy[live, None]
        lbest = best[live]
        inner = block_count(grid, lcx, lcy, r - 1) if r > 0 else 0
        filled = block_count(grid, lcx, lcy, r) - inner > 0
        ring_n = 1 if r == 0 else 8 * r
        step = max(1, _RING_FOLD_ELEMS // (live.shape[0] * grid.cap))
        for i0 in range(0, ring_n, step):
            i = torch.arange(i0, min(ring_n, i0 + step), device=dev)
            ox, oy = _ring_cell_offset(torch.full_like(i, r), i)
            ccx, ccy = lcx + ox, lcy + oy
            valid = filled & (ccx >= 0) & (ccx < gx) & (ccy >= 0) & (ccy < gy)
            cid = torch.where(valid, ccy * gx + ccx, grid.n_cells)  # sentinel row
            px = grid.cell_x[cid].reshape(cid.shape[0], -1)
            py = grid.cell_y[cid].reshape(cid.shape[0], -1)
            lbest = running_k_best(lbest, (lx - px) ** 2 + (ly - py) ** 2)  # pads overflow to +inf
        best[live] = lbest
        bound = torch.tensor(r, dtype=dtype, device=dev) * cell_min
        stop = (lbest[:, k - 1] <= bound * bound) | (r >= r_cover[live])
        live = live[~stop]
        if live.numel() == 0:
            break
        r += 1
    out[idx] = best
    return out, r + 1


def grid_knn(grid: UniformGrid, qx, qy, k: int, active=None):
    """Exact k nearest squared distances ``(n, k)``, ascending, by expanding
    ring search.  Inactive queries (``active`` bool ``(n,)``) keep +inf rows."""
    return _ring_search(grid, qx, qy, k, active)[0]


def grid_r_obs(grid: UniformGrid, qx, qy, k: int, active=None):
    """Mean distance to the k nearest data points; +inf for inactive queries."""
    return mean_k(sqrt_rn(grid_knn(grid, qx, qy, k, active)))


def required_radius(grid: UniformGrid, cx, cy, k: int):
    """Smallest ring radius whose (2r+1)^2 block holds >= k points (or the
    whole grid).  Occupancy only; a Python loop of integral-image lookups."""
    want = min(k, int(grid.cum[-1, -1]))
    r_cover = cover_radius(grid, cx, cy)
    r = torch.zeros_like(cx)
    found = torch.zeros(cx.shape, dtype=torch.bool, device=cx.device)
    while not bool(found.all()):
        ok = (block_count(grid, cx, cy, r) >= want) | (r >= r_cover)
        r = torch.where(found | ok, r, r + 1)
        found = found | ok
    return r


def _cell_coords(grid: UniformGrid):
    dev = grid.cum.device
    ys, xs = torch.meshgrid(torch.arange(grid.gy, device=dev), torch.arange(grid.gx, device=dev),
                            indexing="ij")
    return xs, ys


def required_radius_table(grid: UniformGrid, k: int):
    """``(gy, gx)`` int32 table of :func:`required_radius` for every cell."""
    xs, ys = _cell_coords(grid)
    r = required_radius(grid, xs.reshape(-1), ys.reshape(-1), k)
    return r.reshape(grid.gy, grid.gx).to(torch.int32)


def static_cell_radius(grid: UniformGrid, r_need_table):
    """Per-cell safe ring radius for a query anywhere inside the cell
    (overhang 0): the worst case the plan's static capacity must cover."""
    cw, ch = grid.cell_size[0], grid.cell_size[1]
    cmin = torch.minimum(cw, ch)
    rf = r_need_table.to(torch.float32) + 1.0
    slack = sqrt_rn((rf * cw) ** 2 + (rf * ch) ** 2)
    r_safe = _floor_i32(slack / cmin) + 1
    xs, ys = _cell_coords(grid)
    return torch.minimum(torch.maximum(r_safe, r_need_table.long()).clamp(min=0),
                         cover_radius(grid, xs, ys))


def safe_radius_from_need(grid: UniformGrid, qx, qy, cx, cy, r_need):
    """Containment-safe ring radius from the home cell and its
    ``required_radius``, corrected for the query's overhang beyond its
    clamped home cell (which keeps the bound sound outside the bbox)."""
    cw, ch = grid.cell_size[0], grid.cell_size[1]
    cmin = torch.minimum(cw, ch)
    # per-axis overhang beyond the clamped home cell's span (0 inside)
    x_lo = grid.origin[0] + cx.to(torch.float32) * cw
    y_lo = grid.origin[1] + cy.to(torch.float32) * ch
    ex = torch.clamp(torch.maximum(x_lo - qx, qx - (x_lo + cw)), min=0.0).to(torch.float32)
    ey = torch.clamp(torch.maximum(y_lo - qy, qy - (y_lo + ch)), min=0.0).to(torch.float32)
    rf = r_need.to(torch.float32) + 1.0
    dx_bound = ex + rf * cw
    dy_bound = ey + rf * ch
    slack = sqrt_rn(torch.clamp(dx_bound * dx_bound + dy_bound * dy_bound - ex * ex - ey * ey, min=0.0))
    r_safe = _floor_i32(slack / cmin) + 1
    return torch.minimum(torch.maximum(r_safe, r_need.long()).clamp(min=0), cover_radius(grid, cx, cy))


def morton_ids(cx, cy):
    """Morton (Z-order) interleave of cell indices, int32.  The interleave
    runs in int64: ids are at most 18 bits (512 cells per axis)."""

    def part1by1(v):
        v = v.long() & 0xFFFFFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555

    return (part1by1(cx) | (part1by1(cy) << 1)).to(torch.int32)


def seam_segment_ids(grid: UniformGrid, cx, cy, level: int):
    """Morton quadrant id (``0 .. 4**level - 1``) of each home cell: the top
    ``level`` bits of each axis, interleaved.  Nondecreasing along a
    Morton-sorted cell order."""
    if level <= 0:
        return torch.zeros(cx.shape, dtype=torch.int32, device=cx.device)
    nbits = max((max(grid.gx, grid.gy) - 1).bit_length(), level)
    shift = nbits - level
    return morton_ids(cx >> shift, cy >> shift)


def seam_layout(seg_sorted, n_segments: int, block_q: int, n_slots: int):
    """Block layout that never straddles a Morton seam: each seam segment is
    padded to a multiple of ``block_q`` (pad slots repeat the segment's last
    query).  Returns ``(src (n_slots,), dest (n_tot,))`` int64: ``src``
    gathers the sorted arrays into the split layout, ``dest`` is each sorted
    query's slot (``src[dest[i]] == i``)."""
    n_tot = seg_sorted.shape[0]
    dev = seg_sorted.device
    seg = seg_sorted.long()
    zero = torch.zeros((1,), dtype=torch.long, device=dev)
    counts = torch.bincount(seg, minlength=n_segments)
    starts = torch.cat([zero, torch.cumsum(counts, 0)])
    padded = torch.cat([zero, torch.cumsum((counts + block_q - 1) // block_q * block_q, 0)])
    d = torch.arange(n_slots, device=dev)
    seg_of = (torch.searchsorted(padded, d, right=True) - 1).clamp(0, n_segments - 1)
    within = d - padded[seg_of]
    src = starts[seg_of] + torch.minimum(within, (counts[seg_of] - 1).clamp(min=0))
    src = src.clamp(max=n_tot - 1)  # trailing slots (and empty tail segments)
    dest = padded[seg] + torch.arange(n_tot, device=dev) - starts[seg]
    return src, dest


def xla_row_sum(v):
    """Row sums of ``v (rows, n)`` in the order the reference's CPU backend
    (XLA) takes them, so the plan's aggregates have the reference's bits: a
    row of at most 32 terms is summed in column order; a longer row is
    zero-padded to a multiple of 32 (half the padding in front, the odd one
    behind), summed in windows of 32, and the window sums are summed the
    same way.  Elementwise adds only, so a card gives the same bits."""

    def in_order(t):
        s = torch.zeros_like(t[..., 0])
        for j in range(t.shape[-1]):
            s = s + t[..., j]
        return s

    while v.shape[1] > 32:
        pad = (-v.shape[1]) % 32
        v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        v = in_order(v.reshape(v.shape[0], -1, 32))
    return in_order(v)


class CellAggregates(NamedTuple):
    """Per-cell far-field aggregates over a grid's point set (plan time).

    One entry per cell: the point count (data dtype, a kernel operand), the
    z-sum, the centroid of the cell's points (the cell's geometric centre
    when it is empty: count and z-sum are 0 there, and a finite centroid
    keeps the far kernel's weight finite) and the cell's integer grid
    coordinates.  ``e_max`` is the largest point-to-centroid distance over
    all cells, ``z_dev_max`` the largest ``|z_j - cell z mean|``, ``z_abs_max``
    the largest ``|z_j|``: the plan-time inputs of the far-field error model
    (``engine.plan._choose_farfield_radius``).
    """

    cent_x: torch.Tensor  # (n_cells,) centroid x (cell centre when empty)
    cent_y: torch.Tensor  # (n_cells,)
    count: torch.Tensor   # (n_cells,) point count, data dtype
    z_sum: torch.Tensor   # (n_cells,) sum of z over the cell's points
    ix: torch.Tensor      # (n_cells,) int32 cell x index
    iy: torch.Tensor      # (n_cells,) int32 cell y index
    e_max: float
    z_dev_max: float
    z_abs_max: float


def cell_aggregates(grid: UniformGrid) -> CellAggregates:
    """:class:`CellAggregates` from the padded cell layout, rounded as the
    reference rounds them: row sums in :func:`xla_row_sum`'s order and the
    root through ``sqrt_rn``."""
    nc = grid.n_cells
    dtype, dev = grid.pt_x.dtype, grid.pt_x.device
    big = coord_sentinel(dtype, dev)
    cx_cells = grid.cell_x[:nc]  # (nc, cap), pad slots hold the sentinel
    cy_cells = grid.cell_y[:nc]
    z_cells = grid.cell_z[:nc]   # pad slots hold 0
    mask = cx_cells < big / 2
    cnt = grid.counts.reshape(-1).to(dtype)
    denom = torch.clamp(cnt, min=1.0)
    sum_x = xla_row_sum(torch.where(mask, cx_cells, 0.0))
    sum_y = xla_row_sum(torch.where(mask, cy_cells, 0.0))
    cid = torch.arange(nc, dtype=torch.int32, device=dev)
    ix = cid % grid.gx
    iy = torch.div(cid, grid.gx, rounding_mode="floor")
    o, s = grid.origin.to(dtype), grid.cell_size.to(dtype)
    centre_x = o[0] + (ix.to(dtype) + 0.5) * s[0]
    centre_y = o[1] + (iy.to(dtype) + 0.5) * s[1]
    cent_x = torch.where(cnt > 0, sum_x / denom, centre_x)
    cent_y = torch.where(cnt > 0, sum_y / denom, centre_y)
    z_sum = xla_row_sum(z_cells)
    ddx = cx_cells - cent_x[:, None]
    ddy = cy_cells - cent_y[:, None]
    dev2 = torch.where(mask, ddx * ddx + ddy * ddy, 0.0)
    e_max = float(sqrt_rn(dev2.max()))
    z_mean = z_sum / denom
    z_dev_max = float(torch.where(mask, (z_cells - z_mean[:, None]).abs(), 0.0).max())
    z_abs_max = float(torch.where(mask, z_cells.abs(), 0.0).max())
    return CellAggregates(cent_x, cent_y, cnt, z_sum, ix, iy, e_max, z_dev_max, z_abs_max)


class QuadtreeLevel(NamedTuple):
    """One level of the far-field quadtree (plan time, DESIGN.md section 8).

    Level 0 is the grid's cells; a level-``l`` node covers ``2**l x 2**l``
    cells (edge nodes the clipped remainder).  Each level is one flat set of
    ``nx * ny`` nodes in row-major order.  Per node: point ``count`` (data
    dtype), ``z_sum``, the points' centroid (the node's geometric centre
    when empty), the first z-moment about the centroid ``(mx, my) = sum_j
    z_j (p_j - cent)``, ``e`` (an upper bound on the point-to-centroid
    distance, exact at level 0) and ``zd`` (the same for ``|z_j - z mean|``).
    ``e_max`` / ``zd_max`` are their maxima over the nonempty nodes.
    """

    nx: int
    ny: int
    step: int             # cells per node side (2**level)
    cent_x: torch.Tensor  # (nx*ny,) centroid x (node centre when empty)
    cent_y: torch.Tensor
    count: torch.Tensor   # (nx*ny,) point count, data dtype
    z_sum: torch.Tensor
    mx: torch.Tensor      # (nx*ny,) first z-moment about the centroid, x
    my: torch.Tensor
    e: torch.Tensor       # (nx*ny,) dispersion radius (upper bound)
    zd: torch.Tensor      # (nx*ny,) z spread (upper bound)
    e_max: float
    zd_max: float


def quadtree_level_count(gx: int, gy: int) -> int:
    """Levels of :func:`quadtree_aggregates`: coarsen by 2 per level until at
    most 2 nodes remain per axis (a coarser root could never be closed)."""
    levels = 1
    g = max(gx, gy)
    while (g + 1) // 2 > 2 and (1 << (levels - 1)) < g:
        g = (g + 1) // 2
        levels += 1
    return levels


def _node_centres(grid: UniformGrid, nx: int, ny: int, step: int, dtype):
    """Geometric centres of a level's nodes, ``(ny, nx)`` each (empty nodes)."""
    dev = grid.origin.device
    jx = torch.arange(nx, device=dev)
    jy = torch.arange(ny, device=dev)
    x_mid = 0.5 * (jx * step + ((jx + 1) * step).clamp(max=grid.gx)).to(dtype)
    y_mid = 0.5 * (jy * step + ((jy + 1) * step).clamp(max=grid.gy)).to(dtype)
    o, s = grid.origin.to(dtype), grid.cell_size.to(dtype)
    cx = o[0] + x_mid * s[0]
    cy = o[1] + y_mid * s[1]
    return cx[None, :].expand(ny, nx), cy[:, None].expand(ny, nx)


def _pad_even(a, ny: int, nx: int):
    """Pad a ``(ny, nx)`` level image with zeros (empty nodes) to even sides."""
    return torch.nn.functional.pad(a, (0, nx % 2, 0, ny % 2))


def quadtree_aggregates(grid: UniformGrid) -> tuple[QuadtreeLevel, ...]:
    """Bottom-up quadtree of far-field aggregates, rounded as the reference
    rounds them.  Level 0 comes from the padded cell layout (row sums in
    :func:`xla_row_sum`'s order, roots through ``sqrt_rn``); each coarser
    level combines 2x2 children, one operation at a time, in the reference's
    association order: count, z-sum and the count-weighted centroid sums as
    ``((c00 + c01) + c10) + c11``, the moments as a sum from 0 over the
    children of ``m_c + s_c (cent_c - cent)`` (exact re-aggregation of the
    first moment), and the conservative bounds

        e  = max over nonempty children of |cent_c - cent| + e_c
        zd = max over nonempty children of |zbar_c - zbar| + zd_c.
    """
    nc = grid.n_cells
    dtype, dev = grid.pt_x.dtype, grid.pt_x.device
    big = coord_sentinel(dtype, dev)
    agg = cell_aggregates(grid)
    cx_cells = grid.cell_x[:nc]
    cy_cells = grid.cell_y[:nc]
    z_cells = grid.cell_z[:nc]
    mask = cx_cells < big / 2
    dev_x = torch.where(mask, cx_cells - agg.cent_x[:, None], 0.0)
    dev_y = torch.where(mask, cy_cells - agg.cent_y[:, None], 0.0)
    e0 = sqrt_rn((dev_x * dev_x + dev_y * dev_y).amax(dim=1))
    zm = torch.where(mask, z_cells, 0.0)
    mx0 = xla_row_sum(zm * dev_x)
    my0 = xla_row_sum(zm * dev_y)
    zbar0 = agg.z_sum / torch.clamp(agg.count, min=1.0)
    zd0 = torch.where(mask, (z_cells - zbar0[:, None]).abs(), 0.0).amax(dim=1)

    n_levels = quadtree_level_count(grid.gx, grid.gy)
    levels = []
    nx, ny, step = grid.gx, grid.gy, 1
    arrays = [a.reshape(ny, nx) for a in (agg.count, agg.z_sum, agg.cent_x, agg.cent_y, mx0, my0, e0, zd0)]
    for level in range(n_levels):
        cnt, zs, ctx, cty, mx, my, e, zd = arrays
        nonempty = cnt > 0
        levels.append(QuadtreeLevel(
            nx, ny, step, cent_x=ctx.reshape(-1), cent_y=cty.reshape(-1), count=cnt.reshape(-1),
            z_sum=zs.reshape(-1), mx=mx.reshape(-1), my=my.reshape(-1), e=e.reshape(-1), zd=zd.reshape(-1),
            e_max=float(torch.where(nonempty, e, 0.0).max()), zd_max=float(torch.where(nonempty, zd, 0.0).max())))
        if level == n_levels - 1:
            break
        ch = [[_pad_even(a, ny, nx)[oy::2, ox::2] for a in arrays] for oy, ox in ((0, 0), (0, 1), (1, 0), (1, 1))]
        nx, ny, step = (nx + 1) // 2, (ny + 1) // 2, step * 2
        cnt = ((ch[0][0] + ch[1][0]) + ch[2][0]) + ch[3][0]
        zs = ((ch[0][1] + ch[1][1]) + ch[2][1]) + ch[3][1]
        denom = torch.clamp(cnt, min=1.0)
        wsum_x = ((ch[0][0] * ch[0][2] + ch[1][0] * ch[1][2]) + ch[2][0] * ch[2][2]) + ch[3][0] * ch[3][2]
        wsum_y = ((ch[0][0] * ch[0][3] + ch[1][0] * ch[1][3]) + ch[2][0] * ch[2][3]) + ch[3][0] * ch[3][3]
        mid_x, mid_y = _node_centres(grid, nx, ny, step, dtype)
        ctx = torch.where(cnt > 0, wsum_x / denom, mid_x)
        cty = torch.where(cnt > 0, wsum_y / denom, mid_y)
        mx = sum(c[4] + c[1] * (c[2] - ctx) for c in ch)
        my = sum(c[5] + c[1] * (c[3] - cty) for c in ch)
        zbar = zs / denom
        e_terms, zd_terms = [], []
        for c in ch:
            dist = sqrt_rn((c[2] - ctx) ** 2 + (c[3] - cty) ** 2)
            e_terms.append(torch.where(c[0] > 0, dist + c[6], 0.0))
            zd_terms.append(torch.where(c[0] > 0, (c[1] / torch.clamp(c[0], min=1.0) - zbar).abs() + c[7], 0.0))
        e = torch.maximum(torch.maximum(e_terms[0], e_terms[1]), torch.maximum(e_terms[2], e_terms[3]))
        zd = torch.maximum(torch.maximum(zd_terms[0], zd_terms[1]), torch.maximum(zd_terms[2], zd_terms[3]))
        arrays = [cnt, zs, ctx, cty, mx, my, e, zd]
    return tuple(levels)
