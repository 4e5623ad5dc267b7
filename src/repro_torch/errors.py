"""Typed warnings raised by the plan and execute code.

Counterpart of ``repro.errors`` for the warnings this package raises.  Each
keeps a stdlib category as its second base (``UserWarning`` at plan time,
``RuntimeWarning`` at serving time), so ``warnings`` filters and
``pytest.warns`` on either the type or the category work.
"""

from __future__ import annotations


class ReproWarning(Warning):
    """Base class for every warning the port emits on purpose."""


class PathologicalGridWarning(ReproWarning, UserWarning):
    """The grid resolution is pathological for the data: some cell's safe
    ring radius is so large that candidate rows approach a full sweep."""


class CapacityOverflowWarning(ReproWarning, RuntimeWarning):
    """``overflow_queries > 0`` persisted for the streak threshold against
    one plan: the static candidate capacity looks undersized for the serving
    workload (results stay exact via the ring-search blend)."""
