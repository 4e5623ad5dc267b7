"""Plan/execute engine: :func:`build_plan` once per data set, then
:func:`execute` per query batch; :func:`replan_with_capacity` rebuilds a grid
plan with floored capacities (the serving layer's re-plan)."""

from repro_torch.engine.execute import PERSISTENT_OVERFLOW_BATCHES, execute, execute_with_stats
from repro_torch.engine.plan import InterpolationPlan, build_plan, plan_from_reference, replan_with_capacity

__all__ = [
    "PERSISTENT_OVERFLOW_BATCHES", "InterpolationPlan", "build_plan", "execute",
    "execute_with_stats", "plan_from_reference", "replan_with_capacity",
]
