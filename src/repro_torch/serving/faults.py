"""Deterministic fault injection for the serving layer.  Counterpart of
``repro.serving.faults``, with its own table of armed faults: arming a fault
in one package never affects the other.

The registry/re-estimator state machine has paths that real workloads only
hit under rare, slow, or nondeterministic conditions: plan builds that
throw, builds that take seconds, overflow streaks that need pathological
query distributions, capacity caps that need near-OOM datasets.  This
module lets tests drive every one of those paths deterministically: the
serving code calls :func:`fire` at a small set of NAMED injection points,
and a test arms faults at those points with the :func:`inject` context
manager.  With nothing armed, ``fire`` is a dict lookup returning its
input — the production cost is negligible and there are no code-path
differences between tested and untested behaviour.

Injection points (the complete set — ``inject`` rejects unknown names so a
typo'd test arms nothing silently):

``reestimator.stats``
    Fired on every batch served through ``CapacityReestimator.execute``
    with the diagnostics dict as value, BEFORE the persistent-overflow
    streak is advanced.  A ``transform`` here fabricates synthetic
    overflow streaks (``overflow_queries`` / ``cand_need_max`` overrides)
    that flow through the REAL streak machinery.
``reestimator.build``
    Fired at the top of every background re-plan attempt.  ``error``
    simulates plan-build failures (drives the bounded-retry/backoff and
    degrade paths); ``delay``, or a ``transform`` that waits on a
    ``threading.Event``, simulates slow builds (drives the
    serve-during-replan path).
``reestimator.capacity``
    Fired with the proposed new candidate capacity as value before the
    re-plan.  A ``transform``/``value`` forcing it at or below the current
    capacity simulates capacity-cap exhaustion (the degrade-without-retry
    path).
``registry.swap``
    Fired inside the registry's swap critical section (value: the key).
    ``delay`` widens the swap window so concurrency tests can overlap
    readers with an in-flight swap.

Each armed fault applies, in order: ``delay`` (sleep), ``error`` (raise;
class or instance), then ``transform``/``value`` (replace the value).
``times=N`` disarms the fault after N firings — "fail the first two build
attempts, then succeed" is ``inject("reestimator.build", error=...,
times=2)``.  Faults nest (inner-most armed last fires last) and are
removed on context exit, so a crashed test cannot leak a fault into the
next one.
"""

from __future__ import annotations

import contextlib
import threading
import time

INJECTION_POINTS = (
    "reestimator.stats",
    "reestimator.build",
    "reestimator.capacity",
    "registry.swap",
)

_lock = threading.Lock()
_active: dict[str, list["_Fault"]] = {}


class _Fault:
    """One armed fault.  ``fired`` counts firings (tests assert on it)."""

    def __init__(self, point, *, error=None, delay=0.0, times=None,
                 value=None, transform=None):
        if point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {point!r}; known points: "
                f"{INJECTION_POINTS}"
            )
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1, got {times!r}")
        if value is not None and transform is not None:
            raise ValueError("pass value= or transform=, not both")
        self.point = point
        self.error = error
        self.delay = float(delay)
        self.times = times
        self.value = value
        self.transform = transform
        self.fired = 0

    def _take(self) -> bool:
        """Claim one firing (under the module lock). False once exhausted."""
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True

    def _apply(self, value):
        if self.delay > 0.0:
            time.sleep(self.delay)
        if self.error is not None:
            err = self.error() if isinstance(self.error, type) else self.error
            raise err
        if self.transform is not None:
            return self.transform(value)
        if self.value is not None:
            return self.value
        return value


@contextlib.contextmanager
def inject(point, *, error=None, delay=0.0, times=None, value=None,
           transform=None):
    """Arm a fault at ``point`` for the duration of the ``with`` block.

    Yields the fault object (its ``fired`` counter is the number of times
    the fault actually applied).  See the module docstring for the points
    and the per-firing semantics of ``error``/``delay``/``times``/
    ``value``/``transform``.
    """
    fault = _Fault(point, error=error, delay=delay, times=times, value=value,
                   transform=transform)
    with _lock:
        _active.setdefault(point, []).append(fault)
    try:
        yield fault
    finally:
        with _lock:
            _active[point].remove(fault)
            if not _active[point]:
                del _active[point]


def fire(point, value=None):
    """Apply every armed fault at ``point`` (in arming order) to ``value``.

    Called by the serving code at its injection points; returns the
    (possibly transformed) value.  Raises whatever error an armed fault
    carries.  With nothing armed this is a no-op returning ``value``.
    """
    if point not in INJECTION_POINTS:
        raise ValueError(
            f"unknown injection point {point!r}; known points: "
            f"{INJECTION_POINTS}"
        )
    with _lock:
        taken = [f for f in _active.get(point, ()) if f._take()]
    for fault in taken:
        value = fault._apply(value)
    return value


def active_points() -> tuple:
    """Names of points with at least one armed fault (diagnostic)."""
    with _lock:
        return tuple(sorted(_active))
