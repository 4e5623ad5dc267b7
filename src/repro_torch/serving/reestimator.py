"""Capacity re-estimator: the self-healing loop over the overflow streak.
Counterpart of ``repro.serving.reestimator``.

A grid plan's static candidate capacity is sized from an *assumed* serving
density (``query_occupancy``).  A workload that is persistently sparser or
clustered differently keeps paying the exact ring-search blend arm batch
after batch: correct, but at ring-search cost.  The engine counts the streak
(``engine/execute.py: _note_overflow``); this module responds to it:

``healthy``
    Every batch is served through the registry's current plan; the observed
    ``cand_need_max`` high-water mark is tracked.
``replanning``
    The streak reached ``PERSISTENT_OVERFLOW_BATCHES``: a background thread
    rebuilds the plan via ``engine.plan.replan_with_capacity`` with a
    geometrically bumped capacity floor, at least ``growth x`` the current
    capacity AND at least the observed ``cand_need_max``, hard-capped at
    ``min(m, capacity_cap)`` (capacity ``m`` provably cannot overflow: a
    candidate row never needs more than every data point).  Build failures
    retry with exponential backoff, at most ``max_retries`` attempts.
    Serving continues on the OLD plan throughout (exact via the blend) and
    the new plan is published by the registry's atomic
    :meth:`~repro_torch.serving.registry.PlanRegistry.swap`, optionally
    warmed first.
``degraded``
    The capacity cap left no room to grow, or every build attempt failed:
    re-planning stops, serving continues on the installed plan (results
    stay exact through the ring-search / masked-exact arms, at blend-arm
    cost), and ONE :class:`~repro_torch.errors.PlanDegradedWarning` is
    emitted on the serving thread, at the next
    :meth:`~CapacityReestimator.execute` (warnings raised on a background
    thread are invisible to standard warning filters and to
    ``pytest.warns``).  :meth:`reset` re-arms.

On the card the background build and warmup launch on the worker thread's
current stream, which for a fresh thread is the device's default stream, the
one the serving thread launches on: launches stay ordered, so a plan's
tensors are complete before the swap publishes it, while the host part of
the build overlaps serving.

Fault-injection points (``serving.faults``): ``reestimator.stats`` (per
batch, the diagnostics dict: fabricate synthetic overflow streaks),
``reestimator.build`` (top of every build attempt: inject failures or slow
builds), ``reestimator.capacity`` (the proposed capacity: force cap
exhaustion).
"""

from __future__ import annotations

import threading
import time
import warnings

import torch

from repro_torch.errors import PlanBuildError, PlanDegradedWarning
from repro_torch.serving import faults

HEALTHY = "healthy"
REPLANNING = "replanning"
DEGRADED = "degraded"


class CapacityReestimator:
    """Serve batches through a registry entry; re-plan + hot-swap on
    persistent overflow; degrade gracefully when re-planning cannot help.

    ``registry``/``key``: where the served plan lives (``plan`` is
    registered under ``key`` if absent).  ``growth``: geometric capacity
    bump per re-plan (> 1).  ``capacity_cap``: hard ceiling on the bumped
    candidate capacity (default: ``plan.m``, itself always an implicit
    cap).  ``max_retries`` / ``backoff``: bounded build retries with
    exponential backoff (``backoff * 2**attempt`` seconds between tries).
    ``warmup``: optional ``(qx, qy)`` batch run against every new plan
    before its swap becomes visible, which keeps first-use costs off the
    serving path.
    """

    def __init__(self, registry, key, plan, *, growth: float = 2.0, capacity_cap: int | None = None,
                 max_retries: int = 3, backoff: float = 0.05, warmup=None):
        if plan.impl != "grid":
            raise ValueError(f"CapacityReestimator requires a grid plan, got impl={plan.impl!r}")
        if not growth > 1.0:
            raise ValueError(f"growth must be > 1, got {growth!r}")
        if max_retries < 1:
            raise ValueError(f"max_retries must be >= 1, got {max_retries!r}")
        if backoff < 0.0:
            raise ValueError(f"backoff must be >= 0, got {backoff!r}")
        self.registry = registry
        self.key = key
        self.growth = float(growth)
        self.capacity_cap = None if capacity_cap is None else int(capacity_cap)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self._warmup = warmup
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._thread: threading.Thread | None = None
        self._pending_warning: str | None = None
        self._need_max = 0
        self.last_error: PlanBuildError | None = None
        self.counters = {"batches": 0, "triggers": 0, "replans": 0,
                         "build_failures": 0, "swaps": 0, "degraded": 0}
        if key not in registry:
            registry.register(key, plan)

    # ------------------------------------------------------------- serving
    @property
    def plan(self):
        """The currently installed plan (whatever the last swap published)."""
        plan = self.registry.get(self.key)
        if plan is None:
            raise KeyError(f"plan under key {self.key!r} is gone from the registry (evicted?); the "
                           "re-estimator cannot serve without it")
        return plan

    def execute(self, qx, qy):
        """Serve one batch; returns ``(z, alpha, stats)`` like
        ``engine.execute_with_stats``, with ``overflow_queries`` and
        ``cand_need_max`` as Python ints, read from the device in one sync.

        The overflow streak is advanced with the REAL ``_note_overflow``
        machinery (after the ``reestimator.stats`` injection point, so
        fault-injected synthetic streaks take the production path), and a
        streak trigger launches the background re-plan.  Results are
        whatever the installed plan computes, exact for every arm, so a
        batch served during a re-plan equals the same batch on the old
        plan, and a batch after the swap equals a fresh-plan reference.
        """
        from repro_torch.engine.execute import _execute, _note_overflow  # lazy: serving <-> engine

        plan = self.plan
        z, a, stats = _execute(plan, qx, qy)
        n_over, need = torch.stack([stats["overflow_queries"].long(), stats["cand_need_max"].long()]).tolist()
        stats = dict(faults.fire("reestimator.stats", dict(stats, overflow_queries=n_over, cand_need_max=need)))
        with self._lock:
            self.counters["batches"] += 1
            self._need_max = max(self._need_max, int(stats["cand_need_max"]))
        persistent = _note_overflow(plan, int(stats["overflow_queries"]))
        stats["persistent_overflow"] = persistent
        if persistent:
            self._maybe_replan(plan)
        self._deliver_pending()
        return z, a, stats

    # ------------------------------------------------------ replan machinery
    def _maybe_replan(self, plan):
        # stale evidence guard: a batch in flight while a swap lands carries
        # the OLD plan's streak; re-triggering on it would rebuild a plan
        # that was already replaced
        if self.registry.get(self.key) is not plan:
            return
        with self._lock:
            if self._state != HEALTHY:
                return
            self._state = REPLANNING
            self.counters["triggers"] += 1
            need = self._need_max
            t = threading.Thread(target=self._replan, args=(plan, need), name="repro-torch-capacity-replan",
                                 daemon=True)
            self._thread = t
        t.start()

    def _propose_capacity(self, plan, need: int) -> int:
        cap = plan.m
        if self.capacity_cap is not None:
            cap = min(cap, self.capacity_cap)
        return min(max(int(plan.cand_capacity * self.growth), need), cap)

    def _replan(self, plan, need: int):
        from repro_torch.engine.plan import replan_with_capacity  # lazy: serving <-> engine

        try:
            target = int(faults.fire("reestimator.capacity", self._propose_capacity(plan, need)))
            if target <= plan.cand_capacity:
                self._degrade(
                    f"capacity cap exhausted: current cand_capacity={plan.cand_capacity} already meets the "
                    f"bumped target {target} (cap {self.capacity_cap or plan.m}, m={plan.m})", None)
                return
            last_exc = None
            new_plan = None
            for attempt in range(self.max_retries):
                if attempt and self.backoff > 0.0:
                    time.sleep(self.backoff * (2 ** (attempt - 1)))
                try:
                    faults.fire("reestimator.build")
                    with self._lock:
                        self.counters["replans"] += 1
                    new_plan = replan_with_capacity(plan, min_cand_capacity=target, min_p2_capacity=target)
                    break
                except Exception as exc:  # noqa: BLE001 — any build failure retries
                    last_exc = exc
                    with self._lock:
                        self.counters["build_failures"] += 1
            if new_plan is None:
                self._degrade(
                    f"re-plan to cand_capacity>={target} failed after {self.max_retries} attempts "
                    f"({type(last_exc).__name__}: {last_exc})", last_exc)
                return
            self.registry.swap(self.key, new_plan, warmup=self._warmup)
            with self._lock:
                self.counters["swaps"] += 1
                self._state = HEALTHY
                self._need_max = 0
        except Exception as exc:  # noqa: BLE001 — swap/injection failures degrade too
            self._degrade(f"background re-plan crashed ({type(exc).__name__}: {exc})", exc)

    def _degrade(self, reason: str, cause):
        err = PlanBuildError(reason)
        if cause is not None:
            err.__cause__ = cause
        with self._lock:
            self._state = DEGRADED
            self.counters["degraded"] += 1
            self.last_error = err
            self._pending_warning = (
                f"capacity re-estimator degraded: {reason}. Serving continues on the installed plan — "
                "results stay exact through the ring-search / masked-exact blend arms, at blend-arm cost. "
                "Call reset() to re-arm after addressing the cause.")

    def _deliver_pending(self):
        with self._lock:
            msg, self._pending_warning = self._pending_warning, None
        if msg is not None:
            warnings.warn(msg, PlanDegradedWarning, stacklevel=3)

    # ------------------------------------------------------------ lifecycle
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def join(self, timeout: float | None = 10.0) -> str:
        """Wait for any in-flight background re-plan; returns the state."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
        return self.state

    def reset(self):
        """Re-arm a degraded (or mid-streak) re-estimator: back to healthy,
        high-water mark and pending warning cleared.  The installed plan and
        the registry entry are untouched."""
        self.join()
        with self._lock:
            self._state = HEALTHY
            self._need_max = 0
            self._pending_warning = None
            self.last_error = None

    def stats(self) -> dict:
        """Snapshot: counters + state + the installed plan's capacity."""
        with self._lock:
            out = dict(self.counters, state=self._state, need_max=self._need_max)
        out["cand_capacity"] = self.plan.cand_capacity
        return out
