"""Uniform-grid spatial partition for the Phase-1 kNN search.
Counterpart of the exact-path part of ``repro.core.grid``.

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

import torch

from repro_torch.core.aidw import mean_k, sqrt_rn
from repro_torch.core.knn import running_k_best
from repro_torch.core.layouts import coord_sentinel

# Default mean points per cell the auto-resolution aims for.
DEFAULT_OCCUPANCY = 16.0

# Cells per axis are clamped here (Morton ids then fit in 18 bits).
MAX_CELLS_PER_AXIS = 512

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


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
    """Expanding ring search; returns ``(best (n, k), iterations)``.

    Each iteration folds one cell of the current ring into every live
    query's k-best set; an empty ring completes in one step, and a query
    stops once the ring bound proves its k-best final.  The JAX package runs
    this as one ``while_loop``; here it is a Python loop over tensors, so
    every iteration syncs with the device to test the exit condition.  Only
    the ``active`` queries enter the loop, so an all-inactive batch runs
    zero iterations: on the serving path the loop serves only queries whose
    block overflowed the plan's capacity.  It is plain tensor code, not a
    kernel; a kernel for it is later work.
    """
    n = qx.shape[0]
    dtype, dev = qx.dtype, qx.device
    out = torch.full((n, k), math.inf, dtype=dtype, device=dev)
    idx = torch.arange(n, device=dev) if active is None else torch.nonzero(active).reshape(-1)
    if idx.numel() == 0:
        return out, 0
    qx, qy = qx[idx], qy[idx]
    na = idx.shape[0]
    gx, gy = grid.gx, grid.gy
    cx, cy = cell_of(grid, qx, qy)
    cell_min = torch.minimum(grid.cell_size[0], grid.cell_size[1]).to(dtype)
    r_cover = cover_radius(grid, cx, cy)
    qxc, qyc = qx[:, None], qy[:, None]
    best = out[:na].clone()
    r = torch.zeros((na,), dtype=torch.long, device=dev)
    i = torch.zeros_like(r)
    done = torch.zeros((na,), dtype=torch.bool, device=dev)
    iterations = 0
    while not bool(done.all()):
        iterations += 1
        ring_n = torch.where(r == 0, 1, 8 * r)
        inner = torch.where(r > 0, block_count(grid, cx, cy, r - 1), 0)
        ring_cnt = block_count(grid, cx, cy, r) - inner
        at_end = i >= ring_n
        skip = (ring_cnt == 0) & (i == 0)  # whole ring empty: complete in one step
        scan_now = ~done & ~at_end & ~skip

        ox, oy = _ring_cell_offset(r, i)
        ccx, ccy = cx + ox, cy + oy
        valid = scan_now & (ccx >= 0) & (ccx < gx) & (ccy >= 0) & (ccy < gy)
        cid = torch.where(valid, ccy * gx + ccx, grid.n_cells)  # sentinel row
        px, py = grid.cell_x[cid], grid.cell_y[cid]
        d2 = (qxc - px) ** 2 + (qyc - py) ** 2  # pad slots overflow to +inf
        best = torch.where(scan_now[:, None], running_k_best(best, d2), best)

        completing = ~done & (at_end | skip)
        bound = r.to(dtype) * cell_min
        stop = completing & ((best[:, k - 1] <= bound * bound) | (r >= r_cover))
        done = done | stop
        adv = completing & ~stop
        r = torch.where(adv, r + 1, r)
        i = torch.where(adv, 0, torch.where(scan_now, i + 1, i))
    out[idx] = best
    return out, iterations


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
