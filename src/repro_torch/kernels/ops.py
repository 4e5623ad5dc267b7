"""Public convenience entry points: one call plans and executes.
Counterpart of ``repro.kernels.ops``: :func:`aidw` for ``impl`` in ("naive",
"tiled", "fused", "binned", "grid", "tiled_v2"), :func:`idw`, and the
deprecated :func:`aidw_v2`.

Repeated calls against the *same* data arrays reuse one memoized plan: the
memo is the process-default :class:`repro_torch.serving.PlanRegistry`
(bounded LRU, identity guards, counters), keyed on the data arrays' ids and
the static config, the device included, so a CPU plan and a CUDA plan of the
same arrays are two entries.  ``_PLAN_CACHE`` and ``_plan_cache_counters``
are read-only views of it and :func:`plan_cache_clear` empties it.  Callers
that interpolate many batches should still hold the plan themselves
(``repro_torch.engine.build_plan`` / ``execute``): it is explicit about
lifetime and survives array identity changes.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.core.aidw import AIDWParams
from repro_torch.serving.registry import default_registry, plan_key

IMPLS = ("naive", "tiled", "fused", "binned", "grid", "tiled_v2")


def plan_cache_clear():
    """Drop all memoized convenience-API plans and zero the counters: it
    clears the process-default :class:`~repro_torch.serving.PlanRegistry`."""
    default_registry().clear()


def _cached_build_plan(dx, dy, dz, **config):
    """The plan of the one-shot conveniences, memoized in the process-default
    serving registry: repeated aidw()/idw() calls against the same data
    arrays reuse one plan instead of paying the plan build (grid snapshot,
    required_radius table, capacity sweep) per call.  Keyed on the data
    arrays' ids and the static config with the device resolved; the
    registry's identity guards re-check the ids on every hit and evict the
    entry when a data array is collected.  Identity-based memoization cannot
    see in-place mutation of a cached array's contents: pass fresh arrays or
    call :func:`plan_cache_clear`."""
    from repro_torch.engine import build_plan  # lazy: kernels <-> engine

    device = config.get("device")
    config["device"] = str(torch.device("cuda" if device is None else device))
    key = plan_key(dx, dy, dz, config)
    if key is None:  # a prebuilt grid= (or another unhashable config): no caching
        return build_plan(dx, dy, dz, **config)
    return default_registry().get_or_build(key, lambda: build_plan(dx, dy, dz, **config), guards=(dx, dy, dz))


def __getattr__(name):
    # views of the serving registry: the entry dict (entries are (guards,
    # plan) tuples) and the hit and miss counters
    if name == "_PLAN_CACHE":
        return default_registry()._entries
    if name == "_plan_cache_counters":
        stats = default_registry().stats()
        return {"hits": stats["hits"], "misses": stats["misses"]}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def aidw(dx, dy, dz, qx, qy, *, params: AIDWParams = AIDWParams(), area: float, impl: str = "tiled",
         layout: str = "soa", block_q: int = 256, block_d: int = 512, grid=None, phase2: str = "exact",
         farfield_rtol: float = 1e-3, farfield_radius: int | None = None, device=None):
    """AIDW through the hand-written kernels.  ``impl`` is one of
    :data:`IMPLS`; ``layout`` "soa" or, for naive and tiled, "aoas";
    ``phase2``, ``farfield_rtol`` and ``farfield_radius`` (``impl="grid"``)
    select the far-field Phase 2, see :func:`repro_torch.engine.build_plan`.
    Returns ``(z_hat, alpha)``, shape ``(n,)`` each, on ``device`` (default
    ``"cuda"``).

    Repeat calls with the *same* ``dx/dy/dz`` objects reuse a memoized plan
    (keyed on identity, not contents): don't mutate data arrays in place
    between calls; pass fresh arrays, or call :func:`plan_cache_clear`."""
    from repro_torch.engine import execute  # lazy: kernels <-> engine

    if impl not in IMPLS:
        # the engine also plans "idw" and "chunked"; they have their own
        # entry points (idw(), core.aidw_interpolate())
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    plan = _cached_build_plan(dx, dy, dz, params=params, area=area, impl=impl, layout=layout, block_q=block_q,
                              block_d=block_d, grid=grid, phase2=phase2, farfield_rtol=farfield_rtol,
                              farfield_radius=farfield_radius, device=device)
    return execute(plan, qx, qy)


def aidw_v2(dx, dy, dz, qx, qy, *, params: AIDWParams = AIDWParams(), area: float, block_q: int = 256,
            block_d: int = 512, device=None):
    """Deprecated: use ``aidw(..., impl="tiled_v2")``, or
    ``repro_torch.engine.execute_with_stats`` for the merge fraction.
    Returns ``(z_hat, alpha, merge_fraction)``: the share of (query block,
    data tile) steps that ran the k-best merge."""
    warnings.warn("aidw_v2 is deprecated; use aidw(..., impl='tiled_v2') or "
                  "repro_torch.engine.execute_with_stats for the merge-fraction diagnostic",
                  DeprecationWarning, stacklevel=2)
    from repro_torch.engine import execute_with_stats  # lazy: kernels <-> engine

    plan = _cached_build_plan(dx, dy, dz, params=params, area=area, impl="tiled_v2", block_q=block_q,
                              block_d=block_d, device=device)
    z, a, stats = execute_with_stats(plan, qx, qy)
    return z, a, stats["merge_fraction"]


def idw(dx, dy, dz, qx, qy, *, alpha: float = 2.0, block_q: int = 256, block_d: int = 512, device=None):
    """Standard IDW at the constant power ``alpha`` through the hand-written
    sweep (SoA).  Returns z_hat ``(n,)`` on ``device`` (default ``"cuda"``).
    Plans are memoized on data-array identity (see :func:`aidw`)."""
    from repro_torch.engine import execute  # lazy: kernels <-> engine

    plan = _cached_build_plan(dx, dy, dz, impl="idw", idw_alpha=alpha, block_q=block_q, block_d=block_d,
                              device=device)
    z, _ = execute(plan, qx, qy)
    return z
