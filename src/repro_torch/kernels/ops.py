"""Public convenience entry points: one call builds a plan and executes it.
Counterpart of ``repro.kernels.ops``: :func:`aidw` for ``impl`` in ("naive",
"tiled", "fused", "binned", "grid", "tiled_v2"), :func:`idw`, and the
deprecated :func:`aidw_v2`.
Callers that interpolate many batches should hold the plan themselves
(``repro_torch.engine.build_plan`` / ``execute``); the plan memo of the JAX
package comes with the serving layer."""

from __future__ import annotations

import warnings

from repro_torch.core.aidw import AIDWParams

IMPLS = ("naive", "tiled", "fused", "binned", "grid", "tiled_v2")


def aidw(dx, dy, dz, qx, qy, *, params: AIDWParams = AIDWParams(), area: float, impl: str = "tiled",
         layout: str = "soa", block_q: int = 256, block_d: int = 512, grid=None, phase2: str = "exact",
         farfield_rtol: float = 1e-3, farfield_radius: int | None = None, device=None):
    """AIDW through the hand-written kernels.  ``impl`` is one of
    :data:`IMPLS`; ``layout`` "soa" or, for naive and tiled, "aoas";
    ``phase2``, ``farfield_rtol`` and ``farfield_radius`` (``impl="grid"``)
    select the far-field Phase 2, see :func:`repro_torch.engine.build_plan`.
    Returns ``(z_hat, alpha)``, shape ``(n,)`` each, on ``device`` (default
    ``"cuda"``)."""
    from repro_torch.engine import build_plan, execute  # lazy: kernels <-> engine

    if impl not in IMPLS:
        # the engine also plans "idw" and "chunked"; they have their own
        # entry points (idw(), core.aidw_interpolate())
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    plan = build_plan(dx, dy, dz, params=params, area=area, impl=impl, layout=layout, block_q=block_q,
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
    from repro_torch.engine import build_plan, execute_with_stats  # lazy: kernels <-> engine

    plan = build_plan(dx, dy, dz, params=params, area=area, impl="tiled_v2", block_q=block_q, block_d=block_d,
                      device=device)
    z, a, stats = execute_with_stats(plan, qx, qy)
    return z, a, stats["merge_fraction"]


def idw(dx, dy, dz, qx, qy, *, alpha: float = 2.0, block_q: int = 256, block_d: int = 512, device=None):
    """Standard IDW at the constant power ``alpha`` through the hand-written
    sweep (SoA).  Returns z_hat ``(n,)`` on ``device`` (default ``"cuda"``)."""
    from repro_torch.engine import build_plan, execute  # lazy: kernels <-> engine

    plan = build_plan(dx, dy, dz, impl="idw", idw_alpha=alpha, block_q=block_q, block_d=block_d, device=device)
    z, _ = execute(plan, qx, qy)
    return z
