"""Plan registry: the serving layer's source of truth for live plans.
Counterpart of ``repro.serving.registry``.

A :class:`PlanRegistry` maps hashable keys (by convention: data identity +
plan statics, see :func:`plan_key`) to :class:`InterpolationPlan` objects,
with the lifetime features a serving process needs:

* **bounded LRU**: at most ``max_plans`` entries; registering past the
  bound evicts the least-recently-used plan (a plan's padded dataset copy
  is the dominant cost, so the bound is a real memory cap);
* **identity guards**: an entry can hold weak references to the caller's
  data arrays; the entry is evicted when any guard dies (no pinned dataset
  copies) and a ``get`` whose live arrays don't match the guards is a miss
  (id reuse after GC cannot alias a stale plan);
* **counters**: ``hits`` / ``misses`` / ``evictions`` / ``swaps``, read
  via :meth:`stats`;
* **optional warmup**: ``register``/``swap`` accept a ``(qx, qy)`` batch
  and run ``execute`` on it, synchronized with the plan's card, *before*
  the plan becomes visible, so the first real request after a
  (re-)registration never pays the first-use costs (kernel libraries
  loaded, the caching allocator's blocks sized);
* **atomic hot-swap**: :meth:`swap` replaces the plan under a key in one
  lock-protected assignment.  Every build-side cost (plan construction,
  warmup) happens OUTSIDE the lock, so a serving thread calling :meth:`get`
  concurrently with a swap never blocks on a build: it gets either the old
  plan or the new one, both complete, never a torn state.  This is the
  re-estimator's publication point.

All mutation is under one re-entrant lock; the structure is safe to share
between a serving thread and background re-planners.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import OrderedDict

import torch

from repro_torch.serving import faults


def _plain(value) -> bool:
    """Whether a config value can enter a key: tensors hash by identity, not
    contents, so a value holding one (a prebuilt ``grid=``) cannot."""
    if isinstance(value, torch.Tensor):
        return False
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return all(_plain(getattr(value, f.name)) for f in dataclasses.fields(value))
    if isinstance(value, (tuple, list)):
        return all(_plain(v) for v in value)
    return True


def plan_key(dx, dy, dz, config: dict):
    """The conventional registry key for the convenience path: data-array
    identity + the static plan config.  Returns ``None`` when the config is
    unhashable or holds tensors (e.g. a prebuilt ``grid=``): callers should
    skip caching.

    Array ids are only trusted while the arrays stay alive and identical,
    which is exactly what the registry's identity guards enforce: always
    pass ``guards=(dx, dy, dz)`` alongside a ``plan_key`` key.
    """
    if not all(_plain(v) for v in config.values()):
        return None
    try:
        key = (id(dx), id(dy), id(dz), tuple(sorted(config.items())))
        hash(key)
    except TypeError:
        return None
    return key


class PlanRegistry:
    """Bounded, counter-instrumented, hot-swappable plan store."""

    def __init__(self, max_plans: int = 8):
        if max_plans < 1:
            raise ValueError(f"max_plans must be >= 1, got {max_plans!r}")
        self.max_plans = int(max_plans)
        # key -> (guards, plan); guards is a tuple of weakrefs (possibly
        # empty).  The tuple layout is load-bearing: kernels/ops.py exposes
        # this dict as ``_PLAN_CACHE``.
        self._entries: OrderedDict = OrderedDict()
        # RLock, not Lock: a guard's weakref eviction callback can fire
        # during a GC that happens to run inside a locked section on the
        # same thread
        self._lock = threading.RLock()
        self._counters = {"hits": 0, "misses": 0, "evictions": 0, "swaps": 0}

    # ------------------------------------------------------------- lookup
    def get(self, key, live=None):
        """The plan under ``key``, or ``None`` (counted as hit / miss).

        ``live``: the caller's current data arrays; when the entry has
        identity guards they must match ``live`` exactly (object identity),
        else the entry is dropped and the lookup is a miss.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                guards, plan = entry
                if self._guards_ok(guards, live):
                    self._counters["hits"] += 1
                    self._entries.move_to_end(key)
                    return plan
                del self._entries[key]
                self._counters["evictions"] += 1
            self._counters["misses"] += 1
            return None

    @staticmethod
    def _guards_ok(guards, live) -> bool:
        if not guards:
            return True
        if live is None:
            return all(ref() is not None for ref in guards)
        return len(guards) == len(live) and all(ref() is obj for ref, obj in zip(guards, live))

    # --------------------------------------------------------- population
    def register(self, key, plan, *, guards=(), warmup=None):
        """Insert (or replace) ``plan`` under ``key``; returns ``plan``.

        ``guards``: arrays whose identity/lifetime gate the entry: the entry
        is evicted when any of them is garbage-collected.  Arrays that don't
        support weak references make the entry unguardable; it is then NOT
        stored and the plan is simply returned.  ``warmup``: optional
        ``(qx, qy)`` batch run (outside the lock) before the entry becomes
        visible.
        """
        if warmup is not None:
            self._warm(plan, warmup)
        try:
            refs = tuple(weakref.ref(a, self._make_evictor(key)) for a in guards)
        except TypeError:  # unweakrefable guard (plain list, scalar)
            return plan
        with self._lock:
            self._entries[key] = (refs, plan)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_plans:
                self._entries.popitem(last=False)
                self._counters["evictions"] += 1
        return plan

    def get_or_build(self, key, build, *, guards=(), warmup=None):
        """``get(key)`` or build-register-return (the memoization shape).

        The build runs outside the lock; under a concurrent-build race the
        last registration wins: both plans are equivalent (same inputs).
        """
        plan = self.get(key, live=guards or None)
        if plan is not None:
            return plan
        return self.register(key, build(), guards=guards, warmup=warmup)

    # ----------------------------------------------------------- hot-swap
    def swap(self, key, plan, *, warmup=None):
        """Atomically replace the plan under ``key``; returns the old plan.

        The publication point for background re-plans: ``warmup`` (and the
        plan build the caller already did) run outside the lock, then the
        entry is replaced in one locked assignment, keeping the existing
        guards.  A warmup that raises leaves the old plan in place.  Raises
        ``KeyError`` if ``key`` is not registered: a swap against an evicted
        entry must fail loudly rather than resurrect a key the LRU already
        dropped.
        """
        if warmup is not None:
            self._warm(plan, warmup)
        with self._lock:
            if key not in self._entries:
                raise KeyError(key)
            faults.fire("registry.swap", key)
            guards, old = self._entries[key]
            self._entries[key] = (guards, plan)
            self._entries.move_to_end(key)
            self._counters["swaps"] += 1
            return old

    # -------------------------------------------------------------- misc
    @staticmethod
    def _warm(plan, batch):
        # on the card the batch's launches run on the calling thread's current
        # stream; the synchronize returns once they (and the plan's own
        # construction before them) are complete
        from repro_torch.engine import execute  # lazy: registry <-> engine

        qx, qy = batch
        execute(plan, qx, qy)
        if plan.device.type == "cuda":
            torch.cuda.synchronize(plan.device)

    def _make_evictor(self, key):
        def _evict(_ref):
            with self._lock:
                if self._entries.pop(key, None) is not None:
                    self._counters["evictions"] += 1

        return _evict

    def clear(self):
        """Drop every entry and zero the counters (test / memory hook)."""
        with self._lock:
            self._entries.clear()
            for k in self._counters:
                self._counters[k] = 0

    def stats(self) -> dict:
        """Snapshot: counters plus the current size."""
        with self._lock:
            return dict(self._counters, size=len(self._entries))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries


# Process-default registry: backs the convenience-API memoization in
# kernels/ops.py (plan_cache_clear()/_PLAN_CACHE are thin shims over it) and
# is the default home for serving loops.
_default: PlanRegistry | None = None
_default_lock = threading.Lock()


def default_registry() -> PlanRegistry:
    global _default
    with _default_lock:
        if _default is None:
            _default = PlanRegistry(max_plans=8)
        return _default
