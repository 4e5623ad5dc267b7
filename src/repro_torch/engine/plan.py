"""Plan construction: every shape and occupancy decision, made once per
data set.  Counterpart of the ``tiled`` and ``grid`` (``phase2="exact"``)
branches of ``repro.engine.plan``.

A plan holds the sentinel-padded data rows and, for ``impl="grid"``, the
grid snapshot (:class:`UniformGrid` with its CSR arrays), the per-cell
``required_radius`` table, and a static candidate capacity chosen from the
occupancy histogram, with its tile width, the Morton seam-split depth and
the rebuild on a pathological resolution.  Its tensors live on one device
(``"cuda"`` unless the caller asks for another), where ``execute`` runs.
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
    grid_from_csr,
    required_radius_table,
    static_cell_radius,
)
from repro_torch.core.layouts import coord_sentinel, pad_to
from repro_torch.errors import PathologicalGridWarning

# impls of the JAX package that this port does not run yet -> ROADMAP item
_NOT_PORTED = {
    "naive": "A8", "binned": "A8", "fused": "A8", "tiled_v2": "A8", "idw": "A8", "chunked": "A8",
}
_PHASE2_NOT_PORTED = {"farfield": "A6", "quadtree": "A7"}

# A resolution is pathological when some cell needs a safe ring radius
# beyond this (candidate rows then approach a full sweep); a well-sized grid
# sits at 2-3.
_MAX_SAFE_RADIUS = 6
_MAX_REBUILDS = 3


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class InterpolationPlan:
    """Everything needed to interpolate any number of query batches.

    ``data`` is the sentinel-padded ``(dx, dy, dz)``, each ``(m_pad,)`` with
    ``m_pad % block_d == 0``.  The grid fields are 0 / ``None`` for
    ``impl="tiled"``.
    """

    impl: str
    params: AIDWParams
    area: float
    m: int                    # real (unpadded) data-point count
    block_q: int
    block_d: int              # data-axis tile of the dense sweep / grid Phase 2
    cand_capacity: int        # grid: static candidate-row width (points)
    cand_block_d: int         # grid: Phase-1 candidate tile
    grid_rebuilds: int        # grid: coarsening rebuilds during planning
    seam_level: int           # grid: Morton quadrant split depth (0 = off)
    pipeline: str             # grid Phase 1: "prefetch" (tile table) | "dense"
    data: tuple
    grid: UniformGrid | None
    r_need: torch.Tensor | None  # (gy, gx) int32 per-cell required_radius

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
               query_occupancy, seam_level):
    """Grid-impl plan fields: snapshot, static capacity, tile widths."""
    m = int(dx.shape[0])
    user_grid = grid is not None
    occupancy = target_occupancy or DEFAULT_OCCUPANCY
    if grid is None:
        grid = build_grid(dx, dy, dz, target_occupancy=occupancy)

    rebuilds = 0
    while True:
        r_need = required_radius_table(grid, params.k)
        capacity, r_static, window, _side = _choose_candidate_capacity(
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
    cand_block_d = min(block_d, max(128, _round_up(capacity, 128)))
    if seam_level is None:
        seam_level = _choose_seam_level(grid, window)
    # Phase 2 sweeps all data: sentinel-pad to its own tile multiple
    bd2 = min(block_d, max(128, _round_up(m, 128)))
    return dict(block_d=bd2, cand_capacity=_round_up(capacity, cand_block_d),
                cand_block_d=cand_block_d, grid_rebuilds=rebuilds, seam_level=int(seam_level),
                data=_pad_data(dx, dy, dz, bd2), grid=grid, r_need=r_need)


def _as_data(x, device):
    t = torch.as_tensor(x, device=device)
    if t.dim() != 1:
        raise ValueError(f"data arrays must be 1-D, got shape {tuple(t.shape)}")
    return t.contiguous()


def build_plan(dx, dy, dz, *, params: AIDWParams = AIDWParams(), area: float | None = None,
               impl: str = "tiled", layout: str = "soa", block_q: int = 256, block_d: int = 512,
               grid: UniformGrid | None = None, target_occupancy: float | None = None,
               query_occupancy: float | None = None, seam_level: int | None = None,
               pipeline: str = "prefetch", phase2: str = "exact",
               device=None) -> InterpolationPlan:
    """Build an :class:`InterpolationPlan` from a data set and configuration.

    ``impl``: "tiled" (the paper's shared-memory version) or "grid" (the
    main path: grid-accelerated Phase 1, exact Phase 2).  ``grid=`` supplies
    a prebuilt :class:`UniformGrid`; ``target_occupancy`` seeds the
    auto-resolution otherwise.  ``query_occupancy`` (grid) is the expected
    queries per cell of a serving batch that sizes the static candidate
    capacity (default: data occupancy / 4); queries in blocks beyond it stay
    exact through the ring-search blend.  ``seam_level`` (grid) is the Morton
    split depth (``None`` auto, 0 off).  ``pipeline`` (grid) is "prefetch"
    (per-block tile table) or "dense" (every tile; the same bits).
    ``device`` defaults to ``"cuda"`` and fails, as torch does, without a card.

    Data must be finite (``ValueError`` otherwise); non-finite queries are
    handled at execute time.
    """
    valid_impls = ("tiled", "grid", *_NOT_PORTED)
    if impl not in valid_impls:
        raise ValueError(f"impl must be one of {valid_impls}, got {impl!r}")
    if impl in _NOT_PORTED:
        raise NotImplementedError(f"impl={impl!r} is not ported yet (ROADMAP item {_NOT_PORTED[impl]})")
    if layout not in ("soa", "aoas"):
        raise ValueError(layout)
    if layout == "aoas":
        raise NotImplementedError("layout='aoas' is not ported yet (ROADMAP item A8)")
    if grid is not None and impl != "grid":
        raise ValueError("grid= is only meaningful with impl='grid'")
    if pipeline not in ("prefetch", "dense"):
        raise ValueError(f"pipeline must be 'prefetch' or 'dense', got {pipeline!r}")
    if seam_level is not None and not (0 <= int(seam_level) <= 8):
        raise ValueError(f"seam_level must be in [0, 8], got {seam_level!r}")
    if phase2 not in ("exact", *_PHASE2_NOT_PORTED):
        raise ValueError(f"phase2 must be 'exact', 'farfield' or 'quadtree', got {phase2!r}")
    if phase2 != "exact":
        if impl != "grid":
            raise ValueError(f"phase2={phase2!r} requires impl='grid'")
        raise NotImplementedError(
            f"phase2={phase2!r} is not ported yet (ROADMAP item {_PHASE2_NOT_PORTED[phase2]})")

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
    if m < params.k:
        raise ValueError(f"need at least k={params.k} data points, got {m}")
    if area is None:
        area = params.area
    if area is None:
        raise ValueError("plans require a static area; pass area= or set params.area")
    params = dataclasses.replace(params, alpha_levels=tuple(params.alpha_levels))
    fields = dict(impl=impl, params=params, area=float(area), m=m, block_q=block_q,
                  block_d=block_d, cand_capacity=0, cand_block_d=0, grid_rebuilds=0,
                  seam_level=0, pipeline=pipeline, grid=None, r_need=None)
    if impl == "grid":
        fields.update(_plan_grid(dx, dy, dz, params=params, block_q=block_q, block_d=block_d,
                                 grid=grid, target_occupancy=target_occupancy,
                                 query_occupancy=query_occupancy, seam_level=seam_level))
    else:
        fields.update(data=_pad_data(dx, dy, dz, block_d))
    return InterpolationPlan(**fields)


def plan_from_reference(statics: dict, arrays: dict, device=None) -> InterpolationPlan:
    """The port's plan from a JAX plan's exported state: the state carried
    across, as weights are carried across for a model.

    ``arrays`` (numpy): the padded data rows ``dx, dy, dz`` and, for a grid
    plan, ``origin, cell_size, counts, cum, starts, pt_x, pt_y, pt_z`` and
    ``r_need``.  ``statics``: ``impl`` ("grid" or "tiled"), ``m``, ``area``,
    ``params`` (an :class:`AIDWParams` or a dict of its fields), ``block_q``,
    ``block_d`` and, for a grid plan, ``cand_capacity``, ``cand_block_d``,
    ``seam_level``, ``pipeline`` and optionally ``grid_rebuilds``.  The padded
    layout of the grid is rebuilt from the CSR arrays.
    """
    device = torch.device("cuda" if device is None else device)

    def t(name):
        return torch.tensor(arrays[name], device=device)

    params = statics["params"]
    if not isinstance(params, AIDWParams):
        params = AIDWParams(**params)
    params = dataclasses.replace(params, alpha_levels=tuple(params.alpha_levels))
    impl = statics.get("impl", "grid")
    if impl not in ("grid", "tiled"):
        raise NotImplementedError(f"impl={impl!r} is not ported yet")
    grid = r_need = None
    if impl == "grid":
        counts = t("counts").to(torch.int32)
        gy, gx = counts.shape
        grid = grid_from_csr(gx, gy, t("origin").to(torch.float32), t("cell_size").to(torch.float32),
                             counts, t("cum").to(torch.int32), t("pt_x"), t("pt_y"), t("pt_z"),
                             t("starts").to(torch.int32))
        r_need = t("r_need").to(torch.int32)
    return InterpolationPlan(
        impl=impl, params=params, area=float(statics["area"]), m=int(statics["m"]),
        block_q=int(statics["block_q"]), block_d=int(statics["block_d"]),
        cand_capacity=int(statics.get("cand_capacity", 0)),
        cand_block_d=int(statics.get("cand_block_d", 0)),
        grid_rebuilds=int(statics.get("grid_rebuilds", 0)),
        seam_level=int(statics.get("seam_level", 0)), pipeline=statics.get("pipeline", "prefetch"),
        data=tuple(t(n).reshape(-1) for n in ("dx", "dy", "dz")), grid=grid, r_need=r_need)
