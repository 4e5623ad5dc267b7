"""Serving layer: plan registry, capacity re-estimator, fault injection.
Counterpart of ``repro.serving``.

``PlanRegistry`` owns plan lifetime (bounded LRU, identity guards, warmup,
atomic hot-swap); ``CapacityReestimator`` closes the loop from the engine's
``persistent_overflow`` streak to a background re-plan + swap, degrading
gracefully when growth is impossible; ``faults`` lets tests drive every path
of that state machine deterministically.
"""

from repro_torch.serving import faults
from repro_torch.serving.reestimator import CapacityReestimator
from repro_torch.serving.registry import PlanRegistry, default_registry, plan_key

__all__ = [
    "CapacityReestimator",
    "PlanRegistry",
    "default_registry",
    "faults",
    "plan_key",
]
