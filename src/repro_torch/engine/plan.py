"""Plan construction: every shape and occupancy decision, made once per
data set.  Counterpart of ``repro.engine.plan`` for every impl: the dense
kernel family (``naive``, ``tiled``, ``binned``, ``fused``, ``tiled_v2``),
constant-power ``idw``, the plain-PyTorch ``chunked`` path, and ``grid``
(``phase2="exact"``, ``"farfield"`` and ``"quadtree"``).

A plan holds the sentinel-padded data rows (SoA, or one ``(m_pad, 4)``
tensor of AoaS structs for ``layout="aoas"``; the ``chunked`` path keeps
the data unpadded, with a grid snapshot for ``knn="grid"``) and, for
``impl="grid"``, the grid snapshot (:class:`UniformGrid` with its CSR arrays), the per-cell
``required_radius`` table, and a static candidate capacity chosen from the
occupancy histogram, with its tile width, the Morton seam-split depth and
the rebuild on a pathological resolution.  A ``phase2="farfield"`` plan adds
the near-field radius chosen by the worst-case error model with its proved
bound, the near-field capacity and tiles, and the padded cell aggregates.
A ``phase2="quadtree"`` plan adds the same near field, with the radius and
the effective opening ratio chosen by the dipole bound model, and per level
of the cell quadtree the node aggregates and a static node-table width.
Its tensors live on one device (``"cuda"`` unless the caller asks for
another), where ``execute`` runs.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from repro_torch.core.aidw import AIDWParams
from repro_torch.core.grid import (
    DEFAULT_OCCUPANCY,
    UniformGrid,
    build_grid,
    cell_aggregates,
    grid_from_csr,
    quadtree_aggregates,
    required_radius_table,
    static_cell_radius,
)
from repro_torch.core.layouts import coord_sentinel, pad_to, soa_to_aoas
from repro_torch.errors import PathologicalGridWarning, UnprovableRtolWarning

VALID_IMPLS = ("naive", "tiled", "binned", "fused", "tiled_v2", "grid", "idw", "chunked")
# impls without an AoaS variant, as in the JAX package
_SOA_ONLY = ("binned", "fused", "grid", "tiled_v2", "idw", "chunked")

# A resolution is pathological when some cell needs a safe ring radius
# beyond this (candidate rows then approach a full sweep); a well-sized grid
# sits at 2-3.
_MAX_SAFE_RADIUS = 6
_MAX_REBUILDS = 3

# Far-field fallback: when the requested rtol is unprovable at any
# profitable radius, take the cheapest radius proving at least this bound.
_FALLBACK_BOUND_CEIL = 0.5

# Per-tile element budget of the Phase-2 near/far sweeps, kept from the JAX
# package (a ~1 MiB (block_q, tile) float32 tile in a TPU core's VMEM) so the
# plan's tiles equal the reference plan's; not re-derived for this card.
_P2_TILE_ELEMS = 64 * 4096


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class InterpolationPlan:
    """Everything needed to interpolate any number of query batches.

    ``data`` is the sentinel-padded ``(dx, dy, dz)``, each ``(m_pad,)`` with
    ``m_pad % block_d == 0``, or for ``layout="aoas"`` the one tensor
    ``(m_pad, 4)`` of ``(x, y, z, 0)`` structs; for ``impl="chunked"`` the
    unpadded ``(dx, dy, dz)``.  The grid fields are 0 / ``None`` for the
    dense impls.
    """

    impl: str
    layout: str               # "soa" | "aoas" (naive and tiled only)
    params: AIDWParams
    area: float
    m: int                    # real (unpadded) data-point count
    block_q: int
    block_d: int              # data-axis tile of the dense sweep / grid Phase 2
    knn: str                  # chunked: "brute" | "grid"
    q_chunk: int              # chunked: queries per chunk
    d_chunk: int              # chunked: data points per tile
    idw_alpha: float          # idw: the constant power
    cand_capacity: int        # grid: static candidate-row width (points)
    cand_block_d: int         # grid: Phase-1 candidate tile
    grid_rebuilds: int        # grid: coarsening rebuilds during planning
    seam_level: int           # grid: Morton quadrant split depth (0 = off)
    pipeline: str             # grid Phase 1: "prefetch" (tile table) | "dense"
    phase2: str               # grid Phase 2: "exact" (full sweep) | "farfield" | "quadtree"
    farfield_rtol: float      # farfield/quadtree: requested relative error
    farfield_radius: int      # farfield/quadtree: near-field radius (cells)
    farfield_bound: float     # farfield/quadtree: proved worst-case relative error
    p2_capacity: int          # farfield/quadtree: static near-field row width (points)
    p2_block_d: int           # farfield/quadtree: near-field sweep tile
    p2_far_block_d: int       # farfield: cell-aggregate sweep tile
    qt_tau: float             # quadtree: effective opening ratio tau_eff
    qt_levels: tuple          # quadtree: per level (nx, ny, step, k_pad, tile)
    data: tuple
    grid: UniformGrid | None
    r_need: torch.Tensor | None  # (gy, gx) int32 per-cell required_radius
    far: tuple                # farfield: padded (ncp,) cent_x, cent_y, count, z_sum, ix, iy
                              # quadtree: per level (n_nodes + 1,) cent_x, cent_y, count, z_sum, mx, my, e

    @property
    def device(self) -> torch.device:
        return self.data[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.data[0].dtype


def _choose_candidate_capacity(grid: UniformGrid, r_need, block_q: int, m: int,
                               query_occupancy: float | None):
    """Static candidate capacity (points) from the occupancy histogram.

    A block of ``block_q`` Morton-contiguous queries at ``query_occupancy``
    queries per cell spans a home-cell bbox of side about
    ``2 * ceil(sqrt(block_q / query_occupancy))``; grown by the grid-max
    in-cell safe radius it bounds the rectangle side, and the capacity is the
    densest such window.  The default assumes serving batches 4x sparser
    than the data.  Returns ``(capacity, r_static, window, side)``.
    """
    r_static = int(static_cell_radius(grid, r_need).max())
    occ_mean = max(m / max(grid.n_cells, 1), 1.0)
    if query_occupancy is None:
        query_occupancy = occ_mean / 4.0
    query_occupancy = max(query_occupancy, 0.5)
    side = 2 * math.ceil(math.sqrt(block_q / query_occupancy))
    window = min(side + 2 * r_static + 1, max(grid.gx, grid.gy))
    return _densest_window_count(grid, window), r_static, window, side


def _densest_window_count(grid: UniformGrid, window: int) -> int:
    """Max point count of any ``window x window`` cell block."""
    c = grid.cum.long()
    dev = c.device
    y0 = torch.arange(grid.gy, device=dev)
    x0 = torch.arange(grid.gx, device=dev)
    ys = (y0 + window).clamp(max=grid.gy)
    xs = (x0 + window).clamp(max=grid.gx)
    sums = (c[ys[:, None], xs[None, :]] - c[y0[:, None], xs[None, :]]
            - c[ys[:, None], x0[None, :]] + c[y0[:, None], x0[None, :]])
    return max(int(sums.max()), 1)


def _farfield_bound_model(radius: int, cell_min: float, a_max: float, e_max: float, z_dev_max: float,
                          z_abs_max: float):
    """Worst-case relative error of the far-field Phase 2 at a near-field
    radius (DESIGN.md section 7): every far cell's points lie at distance
    ``>= radius * cell_min`` from the query and within ``e_max`` of their
    centroid, so ``tau = e_max / (radius * cell_min)`` bounds each far
    cell's dispersion ratio; ``inf`` where nothing is provable."""
    if radius <= 0:
        return math.inf
    tau = e_max / (radius * cell_min) if cell_min > 0 else math.inf
    g = z_dev_max / z_abs_max if z_abs_max > 0 else 0.0
    return _bound_from_tau(tau, a_max, g)


def _bound_from_tau(tau: float, a_max: float, g: float = 0.0, dipole: bool = False):
    """The (tau, alpha) -> worst-case relative error core of the far-field
    models.  ``dipole=False``: the single-level budget, a second-order count
    term plus the first-order ``eta * g`` z-spread term (``g = z_dev_max /
    z_abs_max``); ``dipole=True``: the quadtree budget, both terms
    second-order.  Non-increasing as tau shrinks; ``inf`` where no guarantee
    exists."""
    if tau >= 1.0:
        return math.inf
    grow = (1.0 + tau) ** a_max
    eps2 = 0.5 * a_max * (a_max + 1.0) * tau * tau * (1.0 - tau) ** (-a_max - 2.0)
    eps2h = eps2 * grow
    if eps2h >= 1.0:
        return math.inf
    if dipole:
        return 2.0 * eps2 * grow / (1.0 - eps2h)
    eta = (1.0 - tau) ** (-a_max) - 1.0
    return (2.0 * eps2 + eta * g) * grow / (1.0 - eps2h)


def _bound_at_radius(grid: UniformGrid, params: AIDWParams, agg, radius: int):
    """Proved worst-case bound at a near radius, shared by the auto chooser
    and the ``farfield_radius=`` override.  A radius ``>= max(gx, gy)``
    leaves no far cell, so the bound is exactly 0 there."""
    if radius >= max(grid.gx, grid.gy):
        return 0.0
    cell_min = float(torch.minimum(grid.cell_size[0], grid.cell_size[1]))
    return _farfield_bound_model(radius, cell_min, float(max(params.alpha_levels)), agg.e_max,
                                 agg.z_dev_max, agg.z_abs_max)


def _choose_farfield_radius(grid: UniformGrid, params: AIDWParams, farfield_rtol: float, agg, *,
                            side: int, m: int):
    """Near-field radius from the worst-case error model and a cost cap.

    Returns ``(radius, bound)``: the smallest radius whose bound meets
    ``farfield_rtol``, as long as the modeled Phase-2 work (near window
    occupancy plus one term per cell) stays under ``m / 4``.  If the target
    is not provable under that cap, the cheapest radius whose bound is at
    most ``_FALLBACK_BOUND_CEIL`` (``r_cap`` if none is) is used and an
    :class:`UnprovableRtolWarning` reports the honest bound.
    """
    cover = max(grid.gx, grid.gy)
    occ_mean = max(m / max(grid.n_cells, 1), 1.0)

    def modeled_cost(radius):
        window = min(side + 2 * radius + 1, cover)
        return window * window * occ_mean + grid.n_cells

    def bound_at(radius):
        return _bound_at_radius(grid, params, agg, radius)

    r_cap = 1
    while r_cap + 1 < cover and modeled_cost(r_cap + 1) <= m / 4:
        r_cap += 1
    for radius in range(1, r_cap + 1):
        bound = bound_at(radius)
        if bound <= farfield_rtol:
            return radius, bound
    radius = r_cap
    for r in range(1, r_cap + 1):
        if bound_at(r) <= _FALLBACK_BOUND_CEIL:
            radius = r
            break
    bound = bound_at(radius)
    warnings.warn(
        f"farfield_rtol={farfield_rtol:g} is not provable within the profitable near-field budget "
        f"(radius <= {r_cap} of a {grid.gx}x{grid.gy} grid); using radius {radius} with worst-case "
        f"bound {bound:.3g}. Measured error is typically far below the bound — check "
        "farfield_error_report, or pass farfield_radius= / a coarser grid to trade speed for guarantee.",
        UnprovableRtolWarning, stacklevel=4)
    return radius, bound


def _plan_farfield(grid: UniformGrid, params: AIDWParams, *, block_q: int, m: int, side: int,
                   farfield_rtol: float, farfield_radius, min_p2_capacity):
    """Far-field plan fields: radius and bound, the near-field capacity (the
    densest-window model with the block's home bbox grown by the radius),
    the near and far tiles, and the padded cell aggregates: centroids padded
    with the coordinate sentinel, count and z-sum with 0, ix/iy with -1."""
    agg = cell_aggregates(grid)
    if farfield_radius is not None:  # user override: the radius as given
        radius = max(1, min(int(farfield_radius), max(grid.gx, grid.gy)))
        bound = _bound_at_radius(grid, params, agg, radius)
    else:
        radius, bound = _choose_farfield_radius(grid, params, farfield_rtol, agg, side=side, m=m)
    p2_capacity, p2_block_d, tile_cap = _near_capacity(grid, block_q=block_q, m=m, side=side, radius=radius,
                                                       min_p2_capacity=min_p2_capacity)
    far_bd = min(tile_cap, _round_up(grid.n_cells, 128))
    big = coord_sentinel(agg.cent_x.dtype, agg.cent_x.device)
    far = (pad_to(agg.cent_x, far_bd, big), pad_to(agg.cent_y, far_bd, big),
           pad_to(agg.count, far_bd, 0.0), pad_to(agg.z_sum, far_bd, 0.0),
           pad_to(agg.ix, far_bd, -1), pad_to(agg.iy, far_bd, -1))
    return dict(farfield_radius=radius, farfield_bound=float(bound),
                p2_capacity=p2_capacity, p2_block_d=p2_block_d, p2_far_block_d=far_bd,
                far=far)


def _near_capacity(grid: UniformGrid, *, block_q: int, m: int, side: int, radius: int, min_p2_capacity):
    """The near field's ``(p2_capacity, p2_block_d, tile_cap)``, shared by
    the far-field and quadtree plans: the densest-window model with the
    block's home bbox grown by the near radius, the widest tile within the
    per-tile element budget."""
    window2 = min(side + 2 * radius + 1, max(grid.gx, grid.gy))
    cap2 = min(_densest_window_count(grid, window2), m)
    if min_p2_capacity is not None:
        cap2 = min(max(cap2, int(min_p2_capacity)), m)
    tile_cap = max(512, _round_up(_P2_TILE_ELEMS // block_q, 128))
    p2_block_d = min(tile_cap, max(128, _round_up(cap2, 128)))
    return _round_up(cap2, p2_block_d), p2_block_d, tile_cap


def _quadtree_tau_required(a_max: float, rtol: float) -> float:
    """Largest opening ratio tau whose dipole bound still proves ``rtol``:
    bisection on the monotone :func:`_bound_from_tau` (60 steps, about an
    ulp).  To leading order ``sqrt(rtol / (2 a (a+1)))``, about 7e-3 at
    a = 4, rtol = 1e-3."""
    hi = 0.5
    if _bound_from_tau(hi, a_max, dipole=True) <= rtol:
        return hi
    lo = 0.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _bound_from_tau(mid, a_max, dipole=True) <= rtol:
            lo = mid
        else:
            hi = mid
    return lo


def _choose_quadtree_radius(grid: UniformGrid, params: AIDWParams, farfield_rtol: float, e0_max: float, *,
                            side: int, m: int):
    """Near-field radius and effective opening ratio of the quadtree arm;
    returns ``(radius, tau_eff, bound)``.

    Level-0 cells cannot be opened and are closed on the gap test alone, so
    ``tau_eff = max(tau_req, e0_max / (radius * cell_min))`` must cover the
    worst level-0 cell at the near boundary.  The smallest radius under the
    Phase-2 cost cap (near window occupancy under ``m / 4``) whose dipole
    bound at ``tau_eff`` meets ``farfield_rtol`` wins; otherwise the
    cheapest radius whose bound is at most ``_FALLBACK_BOUND_CEIL`` (``r_cap``
    if none is), with an :class:`UnprovableRtolWarning` giving the honest
    bound.
    """
    cover = max(grid.gx, grid.gy)
    occ_mean = max(m / max(grid.n_cells, 1), 1.0)
    tau_req = _quadtree_tau_required(float(max(params.alpha_levels)), farfield_rtol)

    def at_radius(radius):
        return _quadtree_bound_at(grid, params, farfield_rtol, e0_max, radius)

    def modeled_cost(radius):
        window = min(side + 2 * radius + 1, cover)
        return window * window * occ_mean

    r_cap = 1
    while r_cap + 1 < cover and modeled_cost(r_cap + 1) <= m / 4:
        r_cap += 1
    for radius in range(1, r_cap + 1):
        tau_eff, bound = at_radius(radius)
        if bound <= farfield_rtol:
            return radius, tau_eff, bound
    radius = r_cap
    for r in range(1, r_cap + 1):
        if at_radius(r)[1] <= _FALLBACK_BOUND_CEIL:
            radius = r
            break
    tau_eff, bound = at_radius(radius)
    warnings.warn(
        f"farfield_rtol={farfield_rtol:g} is not provable by the quadtree "
        f"model within the profitable near-field budget (radius <= {r_cap} "
        f"of a {grid.gx}x{grid.gy} grid): the worst cell's dispersion gives "
        f"opening ratio {tau_eff:.3g} > required {tau_req:.3g}. Using radius "
        f"{radius} with worst-case bound {bound:.3g}; measured error is "
        "typically far below it — check farfield_error_report, or use a "
        "coarser grid / sub-cell-clustered data for a provable target.",
        UnprovableRtolWarning, stacklevel=5)
    return radius, tau_eff, bound


def _quadtree_bound_at(grid: UniformGrid, params: AIDWParams, farfield_rtol: float, e0_max: float, radius: int):
    """``(tau_eff, bound)`` of the quadtree arm at a near radius, shared by the
    radius choice and the ``farfield_radius=`` override: ``tau_eff = max(tau_req,
    e0_max / (radius * cell_min))`` and its dipole bound; a radius ``>= max(gx,
    gy)`` leaves no far node (bound 0)."""
    a_max = float(max(params.alpha_levels))
    cell_min = float(torch.minimum(grid.cell_size[0], grid.cell_size[1]))
    tau_req = _quadtree_tau_required(a_max, farfield_rtol)
    if radius >= max(grid.gx, grid.gy):
        return tau_req, 0.0
    if cell_min <= 0:
        return math.inf, math.inf
    tau_eff = max(tau_req, e0_max / (radius * cell_min))
    return tau_eff, _bound_from_tau(tau_eff, a_max, dipole=True)


def _quadtree_level_statics(qt, radius: int, tau_eff: float, cell_min: float, side: int, tile_cap: int):
    """Static per-level ``(nx, ny, step, k_pad, tile)``: ``k_pad`` bounds the
    closed nodes one query block may emit at the level.  A level-``l`` node
    is closed only where its parent opened, and a parent at cell gap ``>=
    max(radius + 1, ceil(e_parent_max / (tau_eff cell_min)) + 1)`` never
    opens, so closed nodes lie in a bounded annulus of the block; the top
    level has no parent.  An undersized table is safe: the engine routes a
    block whose table overflows to the exact sweep."""
    out = []
    for lv, level in enumerate(qt):
        n_nodes = level.nx * level.ny
        if lv == len(qt) - 1:
            k_est = n_nodes
        else:
            parent = qt[lv + 1]
            if tau_eff > 0 and cell_min > 0 and math.isfinite(tau_eff):
                gcap = max(radius + 1, int(math.ceil(parent.e_max / (tau_eff * cell_min))) + 1)
            else:
                gcap = radius + 1
            span = (side + 2 * gcap) // parent.step + 2
            k_est = min(4 * span * span, n_nodes)
        k_est = max(k_est, 8)
        tile = min(tile_cap, max(128, _round_up(k_est, 128)))
        out.append((level.nx, level.ny, level.step, _round_up(k_est, tile), tile))
    return tuple(out)


def _plan_quadtree(grid: UniformGrid, params: AIDWParams, *, block_q: int, m: int, side: int,
                   farfield_rtol: float, farfield_radius, min_p2_capacity):
    """Quadtree plan fields: radius, ``tau_eff`` and the dipole bound, the
    near field shared with the far-field plan, the per-level statics, and
    per level the node arrays ``(cent_x, cent_y, count, z_sum, mx, my, e)``
    with one sentinel node appended at index ``nx * ny``: the coordinate
    sentinel as centroid (``d^2 = inf``, weight 0) and zero count, z-sum,
    moments and dispersion, the target of a node table's pad slots."""
    qt = quadtree_aggregates(grid)
    cell_min = float(torch.minimum(grid.cell_size[0], grid.cell_size[1]))
    if farfield_radius is not None:  # user override: the radius as given
        radius = max(1, min(int(farfield_radius), max(grid.gx, grid.gy)))
        tau_eff, bound = _quadtree_bound_at(grid, params, farfield_rtol, qt[0].e_max, radius)
    else:
        radius, tau_eff, bound = _choose_quadtree_radius(grid, params, farfield_rtol, qt[0].e_max, side=side,
                                                         m=m)
    p2_capacity, p2_block_d, tile_cap = _near_capacity(grid, block_q=block_q, m=m, side=side, radius=radius,
                                                       min_p2_capacity=min_p2_capacity)
    qt_levels = _quadtree_level_statics(qt, radius, tau_eff, cell_min, side, tile_cap)
    big = coord_sentinel(grid.pt_x.dtype, grid.pt_x.device).reshape(1)
    zero = torch.zeros_like(big)
    far = tuple(
        tuple(torch.cat([a, big if i < 2 else zero])
              for i, a in enumerate((lv.cent_x, lv.cent_y, lv.count, lv.z_sum, lv.mx, lv.my, lv.e)))
        for lv in qt)
    return dict(farfield_radius=radius, farfield_bound=float(bound), p2_capacity=p2_capacity,
                p2_block_d=p2_block_d, qt_tau=float(tau_eff), qt_levels=qt_levels, far=far)


def _choose_seam_level(grid: UniformGrid, window: int) -> int:
    """Morton seam-split depth: go as deep as quadrants stay comfortably
    larger than the expected candidate window (at most 4 levels)."""
    level = 0
    nbits = max(1, (max(grid.gx, grid.gy) - 1).bit_length())
    while level < min(nbits, 4) and (min(grid.gx, grid.gy) >> (level + 1)) >= max(window, 4):
        level += 1
    return level


def _pad_data(dx, dy, dz, mult: int):
    big = coord_sentinel(dx.dtype, dx.device)
    return (pad_to(dx, mult, big), pad_to(dy, mult, big), pad_to(dz, mult, 0.0))


def _plan_grid(dx, dy, dz, *, params, block_q, block_d, grid, target_occupancy,
               query_occupancy, seam_level, phase2, farfield_rtol, farfield_radius, min_cand_capacity,
               min_p2_capacity):
    """Grid-impl plan fields: snapshot, static capacity, tile widths, and
    for ``phase2="farfield"`` or ``"quadtree"`` the far-field fields."""
    m = int(dx.shape[0])
    user_grid = grid is not None
    occupancy = target_occupancy or DEFAULT_OCCUPANCY
    if grid is None:
        grid = build_grid(dx, dy, dz, target_occupancy=occupancy)

    rebuilds = 0
    while True:
        r_need = required_radius_table(grid, params.k)
        capacity, r_static, window, side = _choose_candidate_capacity(
            grid, r_need, block_q, m, query_occupancy)
        if not (grid.n_cells > 1 and r_static > _MAX_SAFE_RADIUS):
            break
        if user_grid or rebuilds >= _MAX_REBUILDS:
            warnings.warn(
                f"grid resolution {grid.gx}x{grid.gy} is pathological for this data (grid-max "
                f"safe radius {r_static}, static candidate window {window} cells); candidate "
                "rows approach a full sweep. Pass a coarser grid or higher target_occupancy.",
                PathologicalGridWarning, stacklevel=3)
            break
        # coarsen: 4x the occupancy halves the cells per axis
        occupancy *= 4.0
        grid = build_grid(dx, dy, dz, target_occupancy=occupancy)
        rebuilds += 1

    # a candidate tile no wider than the (128-aligned) capacity
    capacity = min(capacity, m)
    if min_cand_capacity is not None:
        capacity = min(max(capacity, int(min_cand_capacity)), m)
    cand_block_d = min(block_d, max(128, _round_up(capacity, 128)))
    if seam_level is None:
        seam_level = _choose_seam_level(grid, window)
    # Phase 2 sweeps all data: sentinel-pad to its own tile multiple
    # (kept on far-field plans: it is the exact arm of their overflow blend)
    bd2 = min(block_d, max(128, _round_up(m, 128)))
    fields = dict(block_d=bd2, cand_capacity=_round_up(capacity, cand_block_d),
                  cand_block_d=cand_block_d, grid_rebuilds=rebuilds, seam_level=int(seam_level),
                  data=_pad_data(dx, dy, dz, bd2), grid=grid, r_need=r_need)
    if phase2 in ("farfield", "quadtree"):
        arm = _plan_farfield if phase2 == "farfield" else _plan_quadtree
        fields.update(arm(grid, params, block_q=block_q, m=m, side=side, farfield_rtol=farfield_rtol,
                          farfield_radius=farfield_radius, min_p2_capacity=min_p2_capacity))
    return fields


def _as_data(x, device):
    # a copy, as the JAX package's plans own theirs: a plan neither pins the
    # caller's arrays (the plan memo's identity guards evict on their
    # collection) nor sees in-place edits of them
    t = torch.as_tensor(x, device=device)
    if t.dim() != 1:
        raise ValueError(f"data arrays must be 1-D, got shape {tuple(t.shape)}")
    return t.clone(memory_format=torch.contiguous_format)


def build_plan(dx, dy, dz, *, params: AIDWParams = AIDWParams(), area: float | None = None,
               impl: str = "tiled", layout: str = "soa", block_q: int = 256, block_d: int = 512,
               grid: UniformGrid | None = None, target_occupancy: float | None = None,
               query_occupancy: float | None = None, seam_level: int | None = None,
               pipeline: str = "prefetch", phase2: str = "exact", farfield_rtol: float = 1e-3,
               farfield_radius: int | None = None, min_cand_capacity: int | None = None,
               min_p2_capacity: int | None = None, knn: str = "brute",
               q_chunk: int = 1024, d_chunk: int = 4096, idw_alpha: float = 2.0,
               device=None) -> InterpolationPlan:
    """Build an :class:`InterpolationPlan` from a data set and configuration.

    ``impl``: "naive" (the paper's version without shared memory; the plan
    caps ``block_q`` at 64), "tiled" (the paper's shared-memory version),
    "binned" (tiled with the approximate binned prefilter in Phase 1),
    "fused" (both tiled passes in one launch), "tiled_v2" (tiled with the
    threshold-skip kNN pass and its merge count), "grid" (the main path:
    grid-accelerated Phase 1, exact Phase 2), "idw" (standard IDW at the
    constant power ``idw_alpha``: no kNN pass, no ``m >= k`` check, and no
    area needed) or "chunked" (plain PyTorch in chunks of ``q_chunk``
    queries and ``d_chunk`` points on unpadded data, Phase 1 by brute force
    or, with ``knn="grid"``, the grid ring search).
    ``layout`` is "soa" or, for naive and tiled, "aoas" (the data packed as
    ``(m_pad, 4)`` structs).  ``grid=`` supplies
    a prebuilt :class:`UniformGrid`; ``target_occupancy`` seeds the
    auto-resolution otherwise.  ``query_occupancy`` (grid) is the expected
    queries per cell of a serving batch that sizes the static candidate
    capacity (default: data occupancy / 4); queries in blocks beyond it stay
    exact through the ring-search blend.  ``grid=`` also serves
    ``knn="grid"``; without it a chunked plan builds one at the default
    occupancy.  ``seam_level`` (grid) is the Morton
    split depth (``None`` auto, 0 off).  ``pipeline`` (grid) is "prefetch"
    (per-block tile table) or "dense" (every tile; the same bits).
    ``phase2`` (grid) is "exact" (the full m-point sweep), "farfield"
    (exact weights only inside a near-field radius, one aggregate term per
    far cell beyond it) or "quadtree" (the same near field; beyond it a
    Barnes-Hut walk of the cell quadtree adds one aggregate and dipole term
    per closed node, DESIGN.md section 8).  Their proved worst-case relative
    error, against ``max|z_data|``, is ``plan.farfield_bound``.  ``farfield_rtol`` is the
    requested error; when it is not provable at a profitable radius the plan
    warns (:class:`UnprovableRtolWarning`) and reports the honest, larger
    bound.  ``farfield_radius`` overrides the radius choice (the bound is
    computed for it, possibly ``inf``).  ``min_cand_capacity`` (grid) floors
    the candidate capacity and ``min_p2_capacity`` the near-field capacity,
    each clamped to ``m`` (:func:`replan_with_capacity` passes both).
    ``device`` defaults to ``"cuda"`` and fails, as torch does, without a card.

    Data must be finite (``ValueError`` otherwise); non-finite queries are
    handled at execute time.
    """
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")
    if layout not in ("soa", "aoas"):
        raise ValueError(layout)
    if layout == "aoas" and impl in _SOA_ONLY:
        raise ValueError(f"impl={impl!r} is SoA-only (not available for layout=aoas)")
    uses_grid = impl == "grid" or (impl == "chunked" and knn == "grid")
    if grid is not None and not uses_grid:
        raise ValueError("grid= is only meaningful with impl='grid' or knn='grid'")
    if impl == "chunked" and knn not in ("brute", "grid"):
        raise ValueError(f"knn must be 'brute' or 'grid', got {knn!r}")
    if pipeline not in ("prefetch", "dense"):
        raise ValueError(f"pipeline must be 'prefetch' or 'dense', got {pipeline!r}")
    if seam_level is not None and not (0 <= int(seam_level) <= 8):
        raise ValueError(f"seam_level must be in [0, 8], got {seam_level!r}")
    if phase2 not in ("exact", "farfield", "quadtree"):
        raise ValueError(f"phase2 must be 'exact', 'farfield' or 'quadtree', got {phase2!r}")
    if phase2 != "exact" and impl != "grid":
        raise ValueError(f"phase2={phase2!r} requires impl='grid' (the cell aggregates live on the grid)")
    if not float(farfield_rtol) > 0.0:
        raise ValueError(f"farfield_rtol must be > 0, got {farfield_rtol!r}")
    if farfield_radius is not None and int(farfield_radius) < 1:
        raise ValueError(f"farfield_radius must be >= 1, got {farfield_radius!r}")
    for name, floor in (("min_cand_capacity", min_cand_capacity), ("min_p2_capacity", min_p2_capacity)):
        if floor is not None and int(floor) < 1:
            raise ValueError(f"{name} must be >= 1, got {floor!r}")

    device = torch.device("cuda" if device is None else device)
    dx, dy, dz = (_as_data(a, device) for a in (dx, dy, dz))
    for name, arr in (("dx", dx), ("dy", dy), ("dz", dz)):
        if arr.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 or float64, got {arr.dtype}")
        if not bool(torch.isfinite(arr).all()):
            raise ValueError(
                f"non-finite values in {name}: data points and z must be finite (NaN/Inf would "
                "silently poison the kernel distance reductions). Filter the dataset before planning.")
    if not (dx.dtype == dy.dtype == dz.dtype):
        raise TypeError("dx, dy and dz must share one dtype")

    m = int(dx.shape[0])
    if impl != "idw" and m < params.k:
        raise ValueError(f"need at least k={params.k} data points, got {m}")
    if area is None:
        area = params.area
    if area is None:
        if impl != "idw":  # constant-power IDW has no Eq. (2), no area
            raise ValueError("plans require a static area; pass area= or set params.area")
        area = 0.0
    params = dataclasses.replace(params, alpha_levels=tuple(params.alpha_levels))
    fields = dict(impl=impl, layout=layout, params=params, area=float(area), m=m, block_q=block_q,
                  block_d=block_d, knn=knn, q_chunk=q_chunk, d_chunk=d_chunk, idw_alpha=float(idw_alpha),
                  cand_capacity=0, cand_block_d=0, grid_rebuilds=0,
                  seam_level=0, pipeline=pipeline, phase2=phase2, farfield_rtol=float(farfield_rtol),
                  farfield_radius=0, farfield_bound=0.0, p2_capacity=0, p2_block_d=0, p2_far_block_d=0,
                  qt_tau=0.0, qt_levels=(), grid=None, r_need=None, far=())
    if impl == "grid":
        fields.update(_plan_grid(dx, dy, dz, params=params, block_q=block_q, block_d=block_d,
                                 grid=grid, target_occupancy=target_occupancy,
                                 query_occupancy=query_occupancy, seam_level=seam_level,
                                 phase2=phase2, farfield_rtol=float(farfield_rtol),
                                 farfield_radius=farfield_radius, min_cand_capacity=min_cand_capacity,
                                 min_p2_capacity=min_p2_capacity))
    elif impl == "chunked":
        if knn == "grid" and grid is None:
            grid = build_grid(dx, dy, dz, target_occupancy=target_occupancy or DEFAULT_OCCUPANCY)
        fields.update(data=(dx, dy, dz), grid=grid)
    else:  # the dense kernel family and idw: sentinel-pad the streamed data axis
        if impl == "naive":
            fields["block_q"] = min(block_q, 64)
        data = _pad_data(dx, dy, dz, block_d)
        fields.update(data=(soa_to_aoas(*data),) if layout == "aoas" else data)
    return InterpolationPlan(**fields)


def replan_with_capacity(plan: InterpolationPlan, *, min_cand_capacity: int | None = None,
                         min_p2_capacity: int | None = None) -> InterpolationPlan:
    """Rebuild a grid plan with floored capacities: the re-plan that the
    serving layer's capacity re-estimator runs on its background thread.

    Everything else is carried over from ``plan``: the unpadded data are the
    first ``plan.m`` entries of its padded rows, the grid snapshot is reused
    (the data did not change, the capacity model did), and the statics
    (params, area, blocks, seam, pipeline, phase2, rtol, an explicit radius so
    that it cannot drift, and the device) are passed through.  ``block_d`` is
    the plan's, already the Phase-2 tile, as in the JAX package, so the
    re-planned plan equals the reference's re-planned plan field for field.
    The capacities are chosen again at the default ``query_occupancy`` (a
    plan does not keep the one it was built with), then floored.  The result
    serves the same queries with the same exactness; only the static
    candidate widths and their tiles change.
    """
    if plan.impl != "grid":
        raise ValueError(f"replan_with_capacity requires impl='grid', got {plan.impl!r}")
    dx, dy, dz = (d[:plan.m] for d in plan.data)
    return build_plan(dx, dy, dz, params=plan.params, area=plan.area, impl="grid", block_q=plan.block_q,
                      block_d=plan.block_d, grid=plan.grid, seam_level=plan.seam_level, pipeline=plan.pipeline,
                      phase2=plan.phase2, farfield_rtol=plan.farfield_rtol,
                      farfield_radius=plan.farfield_radius or None, min_cand_capacity=min_cand_capacity,
                      min_p2_capacity=min_p2_capacity, device=plan.device)


# the far-field plan's padded cell-aggregate arrays, in the order of ``plan.far``
FAR_ARRAYS = ("cent_x", "cent_y", "count", "z_sum", "ix", "iy")
# a quadtree plan's node arrays of one level, in the order of ``plan.far[lv]``
QT_ARRAYS = ("cent_x", "cent_y", "count", "z_sum", "mx", "my", "e")


def plan_from_reference(statics: dict, arrays: dict, device=None) -> InterpolationPlan:
    """The port's plan from a JAX plan's exported state: the state carried
    across, as weights are carried across for a model.

    ``arrays`` (numpy): the padded data rows ``dx, dy, dz`` (for
    ``layout="aoas"`` instead the padded ``(m_pad, 4)`` structs ``data``;
    for a chunked plan the unpadded data) and, for a grid plan,
    ``origin, cell_size, counts, cum, starts, pt_x, pt_y, pt_z`` and
    ``r_need`` (a chunked plan with ``knn="grid"``: all but ``r_need``);
    for a far-field plan also the padded cell aggregates ``far_cent_x,
    far_cent_y, far_count, far_z_sum, far_ix, far_iy``; for a quadtree
    plan, per level ``lv`` (0 the cells), the node arrays with their
    appended sentinel node ``qt{lv}_cent_x, qt{lv}_cent_y, qt{lv}_count,
    qt{lv}_z_sum, qt{lv}_mx, qt{lv}_my, qt{lv}_e``.
    ``statics``: ``impl`` (any of :data:`VALID_IMPLS`, default "grid"),
    ``layout`` ("soa", the default, or "aoas"), ``m``, ``area``, ``params``
    (an :class:`AIDWParams` or a dict of its fields), ``block_q``,
    ``block_d``; for an idw plan ``idw_alpha``; for a chunked plan ``knn``,
    ``q_chunk`` and ``d_chunk``; for a grid plan ``cand_capacity``,
    ``cand_block_d``, ``seam_level``, ``pipeline`` and optionally
    ``grid_rebuilds``; for a far-field plan ``phase2="farfield"``, ``farfield_rtol``,
    ``farfield_radius``, ``farfield_bound``, ``p2_capacity``, ``p2_block_d``
    and ``p2_far_block_d``; for a quadtree plan ``phase2="quadtree"``,
    ``farfield_rtol``, ``farfield_radius``, ``farfield_bound``,
    ``p2_capacity``, ``p2_block_d``, ``qt_tau`` and ``qt_levels`` (one
    ``(nx, ny, step, k_pad, tile)`` per level).  The padded layout of the
    grid is rebuilt from the CSR arrays.
    """
    device = torch.device("cuda" if device is None else device)

    def t(name):
        return torch.tensor(arrays[name], device=device)

    params = statics["params"]
    if not isinstance(params, AIDWParams):
        params = AIDWParams(**params)
    params = dataclasses.replace(params, alpha_levels=tuple(params.alpha_levels))
    impl = statics.get("impl", "grid")
    layout = statics.get("layout", "soa")
    knn = statics.get("knn", "brute")
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")
    if layout == "aoas" and impl in _SOA_ONLY:
        raise ValueError(f"impl={impl!r} is SoA-only (not available for layout=aoas)")
    phase2 = statics.get("phase2", "exact")
    qt_levels = tuple(tuple(int(v) for v in lv) for lv in statics.get("qt_levels", ()))
    grid = r_need = None
    far = ()
    if phase2 == "farfield":
        far = tuple(t(f"far_{n}").reshape(-1) for n in FAR_ARRAYS)
    elif phase2 == "quadtree":
        far = tuple(tuple(t(f"qt{lv}_{n}").reshape(-1) for n in QT_ARRAYS) for lv in range(len(qt_levels)))
    if impl == "grid" or (impl == "chunked" and knn == "grid"):
        counts = t("counts").to(torch.int32)
        gy, gx = counts.shape
        grid = grid_from_csr(gx, gy, t("origin").to(torch.float32), t("cell_size").to(torch.float32),
                             counts, t("cum").to(torch.int32), t("pt_x"), t("pt_y"), t("pt_z"),
                             t("starts").to(torch.int32))
    if impl == "grid":
        r_need = t("r_need").to(torch.int32)
    if layout == "aoas":
        data = (t("data").reshape(-1, 4).contiguous(),)
    else:
        data = tuple(t(n).reshape(-1) for n in ("dx", "dy", "dz"))
    return InterpolationPlan(
        impl=impl, layout=layout, params=params, area=float(statics["area"]), m=int(statics["m"]),
        block_q=int(statics["block_q"]), block_d=int(statics["block_d"]), knn=knn,
        q_chunk=int(statics.get("q_chunk", 1024)), d_chunk=int(statics.get("d_chunk", 4096)),
        idw_alpha=float(statics.get("idw_alpha", 2.0)), cand_capacity=int(statics.get("cand_capacity", 0)),
        cand_block_d=int(statics.get("cand_block_d", 0)),
        grid_rebuilds=int(statics.get("grid_rebuilds", 0)),
        seam_level=int(statics.get("seam_level", 0)), pipeline=statics.get("pipeline", "prefetch"),
        phase2=phase2, farfield_rtol=float(statics.get("farfield_rtol", 1e-3)),
        farfield_radius=int(statics.get("farfield_radius", 0)),
        farfield_bound=float(statics.get("farfield_bound", 0.0)),
        p2_capacity=int(statics.get("p2_capacity", 0)), p2_block_d=int(statics.get("p2_block_d", 0)),
        p2_far_block_d=int(statics.get("p2_far_block_d", 0)), qt_tau=float(statics.get("qt_tau", 0.0)),
        qt_levels=qt_levels, data=data, grid=grid, r_need=r_need, far=far)
