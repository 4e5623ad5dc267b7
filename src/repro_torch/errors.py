"""Typed warnings raised by the plan and execute code.

Counterpart of ``repro.errors`` for the warnings this package raises.  Each
keeps a stdlib category as its second base (``UserWarning`` at plan time,
``RuntimeWarning`` at serving time), so ``warnings`` filters and
``pytest.warns`` on either the type or the category work.  The serving
layer's terminal build failure, :class:`PlanBuildError`, is an exception.
"""

from __future__ import annotations


class ReproWarning(Warning):
    """Base class for every warning the port emits on purpose."""


class UnprovableRtolWarning(ReproWarning, UserWarning):
    """The requested ``farfield_rtol`` is not provable at a profitable
    near-field radius; the plan ships the honest (larger) worst-case bound."""


class PathologicalGridWarning(ReproWarning, UserWarning):
    """The grid resolution is pathological for the data: some cell's safe
    ring radius is so large that candidate rows approach a full sweep."""


class CapacityOverflowWarning(ReproWarning, RuntimeWarning):
    """``overflow_queries > 0`` persisted for the streak threshold against
    one plan: the static candidate capacity looks undersized for the serving
    workload (results stay exact via the ring-search blend)."""


class PlanDegradedWarning(ReproWarning, RuntimeWarning):
    """The capacity re-estimator exhausted its retries or its capacity cap
    and stopped re-planning; serving continues on the installed plan, exact
    through the ring-search / masked-exact blend arms."""


class PlanBuildError(RuntimeError):
    """A background re-plan failed terminally (carried as the cause on the
    re-estimator's degrade event; never raised into the serving thread)."""
