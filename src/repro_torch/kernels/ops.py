"""Public convenience entry point: one call builds a plan and executes it.
Counterpart of ``repro.kernels.ops.aidw`` for ``impl`` in ("naive", "tiled",
"binned", "grid").
Callers that interpolate many batches should hold the plan themselves
(``repro_torch.engine.build_plan`` / ``execute``); the plan memo of the JAX
package comes with the serving layer."""

from __future__ import annotations

from repro_torch.core.aidw import AIDWParams


def aidw(dx, dy, dz, qx, qy, *, params: AIDWParams = AIDWParams(), area: float, impl: str = "tiled",
         layout: str = "soa", block_q: int = 256, block_d: int = 512, grid=None, device=None):
    """AIDW through the hand-written kernels.  ``impl`` is "naive", "tiled",
    "binned" or "grid"; ``layout`` "soa" or, for naive and tiled, "aoas".
    Returns ``(z_hat, alpha)``, shape ``(n,)`` each, on ``device`` (default
    ``"cuda"``)."""
    from repro_torch.engine import build_plan, execute  # lazy: kernels <-> engine

    plan = build_plan(dx, dy, dz, params=params, area=area, impl=impl, layout=layout, block_q=block_q,
                      block_d=block_d, grid=grid, device=device)
    return execute(plan, qx, qy)
