"""The port's serving layer (``repro_torch.serving``) against the JAX
package's, on the CPU, at the reference tests' shapes (``tests/serving``:
m = 4,096, 64-query batches, the same data and seeds).

* plan state: ``replan_with_capacity`` gives the reference's integer plan
  state, exactly, for exact, far-field and quadtree plans, and the
  re-planned plans' outputs agree with the reference's within alpha 1e-6
  absolute and z 1e-5 relative in float32, 1e-12 in float64;
* the re-estimator: recovery, retries, degrade, cap exhaustion, synthetic
  streaks and the stale-evidence guard, each run through both packages on
  the same batches, outputs within those tolerances, overflow counts and
  ``stats()`` counters equal; inside the port every batch is bitwise equal
  to the port's own fresh plans (old plan before the swap, the re-planned
  one after);
* twins of every test of ``tests/serving`` (fault harness, registry,
  re-estimator); the slow re-plan is held open by a fault that waits on a
  ``threading.Event``, not by a sleep;
* the plan memo of ``repro_torch.kernels``: hits and misses, guard
  eviction, ``plan_cache_clear``, the two views, CPU and CUDA keys apart;
* the warnings' stack levels and the kernel libraries loaded once when two
  threads reach them first together.
"""

import ctypes
import gc
import threading
import time
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as j_serving
from repro.core.aidw import AIDWParams as JParams
from repro.engine import build_plan as j_build_plan
from repro.engine import execute as j_execute
from repro.engine import replan_with_capacity as j_replan
from repro.errors import CapacityOverflowWarning as JOverflowWarning
from repro.errors import PlanDegradedWarning as JDegradedWarning
from repro.serving import faults as j_faults
from repro_torch.core.aidw import AIDWParams
from repro_torch.engine import PERSISTENT_OVERFLOW_BATCHES, build_plan, execute, replan_with_capacity
from repro_torch.errors import CapacityOverflowWarning, PlanBuildError, PlanDegradedWarning
from repro_torch.kernels import _build, aidw, idw, ops
from repro_torch.serving import CapacityReestimator, PlanRegistry, default_registry, faults, plan_key
from repro_torch.serving.reestimator import DEGRADED, HEALTHY, REPLANNING
from test_torch_core import enable_x64

M = 4096
GROWTH = 2.0
P = dict(k=10, area=1.0, r_max=64.0)
# (alpha atol, z rtol) per dtype
TOL = {np.float32: (1e-6, 1e-5), np.float64: (1e-12, 1e-12)}
# the counters both re-estimators keep
COUNTERS = ("batches", "triggers", "replans", "build_failures", "swaps", "degraded", "state", "need_max",
            "cand_capacity")
# the integer plan state a re-plan sets
STATE = ("cand_capacity", "cand_block_d", "block_d", "p2_capacity", "p2_block_d", "seam_level",
         "farfield_radius", "qt_levels")


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _dataset(dtype=np.float32):
    rng = np.random.default_rng(19)
    dx = rng.random(M).astype(dtype)
    dy = rng.random(M).astype(dtype)
    dz = (np.sin(3 * dx) * np.cos(2 * dy)).astype(dtype)
    return dx, dy, dz


def _storm(seed=20, n=64, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.random(n) * 6 - 3).astype(dtype), (rng.random(n) * 6 - 3).astype(dtype)


def _clean(seed=21, n=64, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (0.4 + 0.05 * rng.random(n)).astype(dtype), (0.4 + 0.05 * rng.random(n)).astype(dtype)


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=UserWarning)
        return fn()


# One package's serving API, so that a scenario runs through either.
PORT = types.SimpleNamespace(
    name="port", params=AIDWParams(**P), build_plan=lambda *d, **kw: build_plan(*d, device="cpu", **kw),
    execute=execute, replan=replan_with_capacity, faults=faults, Registry=PlanRegistry,
    Reestimator=CapacityReestimator, asarray=torch.as_tensor, Overflow=CapacityOverflowWarning,
    Degraded=PlanDegradedWarning)
REF = types.SimpleNamespace(
    name="ref", params=JParams(**P), build_plan=j_build_plan, execute=j_execute, replan=j_replan,
    faults=j_faults, Registry=j_serving.PlanRegistry, Reestimator=j_serving.CapacityReestimator,
    asarray=jnp.asarray, Overflow=JOverflowWarning, Degraded=JDegradedWarning)


def _base_plan(pkg, data, **kw):
    # query_occupancy far denser than the serving batches: the capacity
    # model undersizes on purpose, so out-of-bbox batches overflow every time
    return _quiet(lambda: pkg.build_plan(*data, params=pkg.params, area=1.0, impl="grid", query_occupancy=64.0,
                                         **kw))


def _batch(pkg, q):
    return tuple(pkg.asarray(a) for a in q)


def _reestimator(pkg, data, **kw):
    plan = _base_plan(pkg, data)
    reg = pkg.Registry()
    kw.setdefault("backoff", 0.0)
    return reg, plan, pkg.Reestimator(reg, "serve", plan, **kw)


def _assert_close(port_out, ref_out, dtype=np.float32, what=""):
    a_tol, z_tol = TOL[dtype]
    (zp, ap), (zr, ar) = port_out, ref_out
    zp, ap, zr, ar = (_np(v).astype(np.float64) for v in (zp, ap, zr, ar))
    np.testing.assert_allclose(ap, ar, rtol=0, atol=a_tol, err_msg=f"{what} alpha")
    np.testing.assert_allclose(zp, zr, rtol=z_tol, atol=0, err_msg=f"{what} z")


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------------ plan state
def _replan_pair(phase2, dtype):
    data = _dataset(dtype)
    kw = {} if phase2 == "exact" else dict(phase2=phase2)
    with enable_x64(dtype == np.float64):
        jp = _base_plan(REF, data, **kw)
    tp = _base_plan(PORT, data, **kw)
    target = min(max(int(tp.cand_capacity * GROWTH), tp.cand_capacity + 1), M)
    with enable_x64(dtype == np.float64):
        jn = _quiet(lambda: j_replan(jp, min_cand_capacity=target, min_p2_capacity=target))
    tn = _quiet(lambda: replan_with_capacity(tp, min_cand_capacity=target, min_p2_capacity=target))
    return data, (jp, tp), (jn, tn), target


@pytest.mark.parametrize("phase2", ["exact", "farfield", "quadtree"])
def test_replan_state_equals_reference(phase2):
    _, (jp, tp), (jn, tn), target = _replan_pair(phase2, np.float32)
    for f in STATE:
        assert getattr(tp, f) == getattr(jp, f), f
        assert getattr(tn, f) == getattr(jn, f), f
    assert tn.cand_capacity >= target > tp.cand_capacity
    if phase2 != "exact":
        assert tn.p2_capacity >= min(target, M) and tn.farfield_radius == tp.farfield_radius
        assert tn.farfield_bound == tp.farfield_bound
    # the grid snapshot is reused and the data and statics carried over
    assert tn.grid is tp.grid and tn.device == tp.device and tn.m == tp.m
    for a, b in zip(tn.data, tp.data):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("phase2", ["exact", "farfield", "quadtree"])
def test_replanned_outputs_match_reference(phase2, dtype):
    data, (jp, tp), (jn, tn), _ = _replan_pair(phase2, dtype)
    for q in (_storm(dtype=dtype), _clean(dtype=dtype)):
        with enable_x64(dtype == np.float64):
            want_old = j_execute(jp, *_batch(REF, q))
            want_new = j_execute(jn, *_batch(REF, q))
        _assert_close(execute(tp, *_batch(PORT, q)), want_old, dtype, f"{phase2} old plan")
        _assert_close(execute(tn, *_batch(PORT, q)), want_new, dtype, f"{phase2} re-planned")


def test_min_cand_capacity_floors_and_validates():
    data = _dataset()
    plan = _base_plan(PORT, data)
    floored = _base_plan(PORT, data, min_cand_capacity=plan.cand_capacity + 1)
    assert floored.cand_capacity > plan.cand_capacity
    assert _base_plan(PORT, data, min_cand_capacity=10 * M).cand_capacity == M
    for bad in (0, -3):
        with pytest.raises(ValueError, match="min_cand_capacity"):
            _base_plan(PORT, data, min_cand_capacity=bad)
    dense = PORT.build_plan(*data, params=PORT.params, area=1.0, impl="tiled")
    with pytest.raises(ValueError, match="grid"):
        replan_with_capacity(dense, min_cand_capacity=M)


# ------------------------------------------------------------- re-estimator
def _run_recovery(pkg):
    """The recovery sequence: the storm to the trigger, join, one batch
    after the swap.  Returns each batch's (z, alpha), its overflow count,
    the target, the re-plan and the re-estimator's counters."""
    data = _dataset()
    reg, plan, re_ = _reestimator(pkg, data)
    qx, qy = _batch(pkg, _storm())
    outs, overflow, need_max = [], [], 0
    with pytest.warns(pkg.Overflow):
        for _ in range(PERSISTENT_OVERFLOW_BATCHES):
            z, a, st = re_.execute(qx, qy)
            outs.append((z, a))
            overflow.append(int(st["overflow_queries"]))
            need_max = max(need_max, int(st["cand_need_max"]))
    assert st["persistent_overflow"] is True
    assert re_.join() == HEALTHY
    z, a, st = re_.execute(qx, qy)
    outs.append((z, a))
    overflow.append(int(st["overflow_queries"]))
    target = min(max(int(plan.cand_capacity * GROWTH), need_max), M)
    return dict(outs=outs, overflow=overflow, target=target, plan=plan, new=re_.plan, re_=re_, reg=reg,
                stats={k: re_.stats()[k] for k in COUNTERS})


def test_recovery_proof_overflow_drops_to_zero_bitwise():
    """The headline criterion, in the port against its own fresh plans bit
    for bit, and every batch against the reference re-estimator's."""
    port, ref = _run_recovery(PORT), _run_recovery(REF)
    data = _dataset()
    qx, qy = _batch(PORT, _storm())
    ref_old = _base_plan(PORT, data)  # fresh, never-swapped reference build
    assert port["plan"].cand_capacity == ref_old.cand_capacity
    want_old = execute(ref_old, qx, qy)
    for out in port["outs"][:PERSISTENT_OVERFLOW_BATCHES]:
        _assert_bitwise(out, want_old)
    assert min(port["overflow"][:PERSISTENT_OVERFLOW_BATCHES]) > 0
    # the swapped plan equals a fresh build at the re-estimator's target
    ref_new = replan_with_capacity(ref_old, min_cand_capacity=port["target"], min_p2_capacity=port["target"])
    assert port["new"].cand_capacity == ref_new.cand_capacity > ref_old.cand_capacity
    _assert_bitwise(port["outs"][-1], execute(ref_new, qx, qy))
    # recovered on the first batch after the trigger batch
    recovered = next(i for i, n in enumerate(port["overflow"]) if n == 0) + 1
    assert 0 < recovered - PERSISTENT_OVERFLOW_BATCHES <= 2 * PERSISTENT_OVERFLOW_BATCHES
    assert (port["stats"]["triggers"], port["stats"]["swaps"], port["stats"]["degraded"]) == (1, 1, 0)
    assert port["reg"].stats()["swaps"] == 1
    # and against the reference, batch by batch
    for got, want in zip(port["outs"], ref["outs"]):
        _assert_close(got, want)
    assert port["overflow"] == ref["overflow"] and port["target"] == ref["target"]
    assert port["stats"] == ref["stats"]
    assert port["reg"].stats() == ref["reg"].stats()


def test_serving_continues_on_old_plan_during_slow_replan():
    """The re-plan is held open by a build fault that waits on an event: the
    batch served meanwhile is the old plan's, and the swap lands after."""
    data = _dataset()
    _, plan, re_ = _reestimator(PORT, data)
    ref_old = _base_plan(PORT, data)
    qx, qy = _batch(PORT, _storm())
    want_old = execute(ref_old, qx, qy)
    entered, release = threading.Event(), threading.Event()

    def hold(value):
        entered.set()
        assert release.wait(60.0), "the test never released the build"
        return value

    with faults.inject("reestimator.build", transform=hold) as fault:
        with pytest.warns(CapacityOverflowWarning):
            for _ in range(PERSISTENT_OVERFLOW_BATCHES):
                re_.execute(qx, qy)
        assert entered.wait(60.0)  # the worker is inside the build
        assert re_.state == REPLANNING
        z, a, st = re_.execute(qx, qy)  # served DURING the re-plan
        assert re_.state == REPLANNING and re_.plan is plan
        assert int(st["overflow_queries"]) > 0  # still the old plan...
        _assert_bitwise((z, a), want_old)
        release.set()
        assert re_.join(timeout=60.0) == HEALTHY  # ...and the swap still lands
    assert fault.fired == 1
    _, _, st2 = re_.execute(qx, qy)
    assert int(st2["overflow_queries"]) == 0


def _run_retry(pkg):
    data = _dataset()
    _, _, re_ = _reestimator(pkg, data, max_retries=3)
    qx, qy = _batch(pkg, _storm())
    with pkg.faults.inject("reestimator.build", error=RuntimeError("flaky build"), times=2) as fault:
        with pytest.warns(pkg.Overflow):
            for _ in range(PERSISTENT_OVERFLOW_BATCHES):
                re_.execute(qx, qy)
        assert re_.join() == HEALTHY
    assert fault.fired == 2
    z, a, st = re_.execute(qx, qy)
    return (z, a), int(st["overflow_queries"]), {k: re_.stats()[k] for k in COUNTERS}


def test_build_failures_retry_then_succeed():
    out, n_over, s = _run_retry(PORT)
    assert s["build_failures"] == 2 and s["swaps"] == 1 and s["degraded"] == 0
    assert n_over == 0
    ref_out, ref_over, ref_s = _run_retry(REF)
    _assert_close(out, ref_out)
    assert (n_over, s) == (ref_over, ref_s)


def _run_degrade(pkg):
    data = _dataset()
    _, plan, re_ = _reestimator(pkg, data, max_retries=2)
    qx, qy = _batch(pkg, _storm())
    # with backoff=0 the degrade can land DURING the trigger batch, so the
    # typed warning may surface on that execute or the next one: either way
    # exactly once, on the serving thread
    with pkg.faults.inject("reestimator.build", error=RuntimeError("broken build")) as fault, \
            warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(PERSISTENT_OVERFLOW_BATCHES):
            re_.execute(qx, qy)
        assert re_.join() == DEGRADED
        z, a, st = re_.execute(qx, qy)
    assert fault.fired == 2  # bounded: exactly max_retries attempts
    assert any(issubclass(w.category, pkg.Overflow) for w in rec)
    degr = [w for w in rec if issubclass(w.category, pkg.Degraded)]
    assert len(degr) == 1 and "degraded" in str(degr[0].message)
    return re_, plan, (z, a), int(st["overflow_queries"]), {k: re_.stats()[k] for k in COUNTERS}


def test_build_failure_exhausts_retries_and_degrades_with_typed_warning():
    re_, plan, out, n_over, s = _run_degrade(PORT)
    assert isinstance(re_.last_error, PlanBuildError)
    # the batch is still served exactly through the blend arm of the OLD plan
    assert n_over > 0 and re_.plan is plan
    qx, qy = _batch(PORT, _storm())
    _assert_bitwise(out, execute(_base_plan(PORT, _dataset()), qx, qy))
    # no re-warn, no re-trigger on further batches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        re_.execute(*_batch(PORT, _clean()))
    assert re_.state == DEGRADED
    assert re_.stats()["triggers"] == 1
    # reset re-arms the machine
    re_.reset()
    assert re_.state == HEALTHY and re_.last_error is None
    _, _, ref_out, ref_over, ref_s = _run_degrade(REF)
    _assert_close(out, ref_out)
    assert (n_over, s) == (ref_over, ref_s)


def _run_cap(pkg):
    data = _dataset()
    plan = _base_plan(pkg, data)
    re_ = pkg.Reestimator(pkg.Registry(), "serve", plan, backoff=0.0, capacity_cap=plan.cand_capacity)
    qx, qy = _batch(pkg, _storm())
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(PERSISTENT_OVERFLOW_BATCHES):
            re_.execute(qx, qy)
        assert re_.join() == DEGRADED
        re_.execute(qx, qy)
    degr = [w for w in rec if issubclass(w.category, pkg.Degraded)]
    assert len(degr) == 1 and "capacity cap" in str(degr[0].message)
    assert re_.plan is plan  # nothing was swapped
    return {k: re_.stats()[k] for k in COUNTERS}


def test_capacity_cap_exhaustion_degrades_without_build():
    s = _run_cap(PORT)
    assert s["replans"] == 0 and s["build_failures"] == 0  # never attempted
    assert s == _run_cap(REF)


def _run_capacity_override(pkg):
    _, plan, re_ = _reestimator(pkg, _dataset())
    qx, qy = _batch(pkg, _storm())
    with pkg.faults.inject("reestimator.capacity", value=plan.cand_capacity):
        with pytest.warns(pkg.Overflow):
            for _ in range(PERSISTENT_OVERFLOW_BATCHES):
                re_.execute(qx, qy)
        state = re_.join()
    return state, {k: re_.stats()[k] for k in COUNTERS}


def test_injected_capacity_override_forces_degrade():
    state, s = _run_capacity_override(PORT)
    assert state == DEGRADED and s["replans"] == 0
    assert (state, s) == _run_capacity_override(REF)


def _run_synthetic(pkg):
    """A CLEAN workload + a stats transform fabricating overflow: the real
    streak counter, trigger, re-plan and swap all run."""
    _, plan, re_ = _reestimator(pkg, _dataset())
    qx, qy = _batch(pkg, _clean())
    fake = dict(overflow_queries=7, cand_need_max=M)
    with pkg.faults.inject("reestimator.stats", transform=lambda s: dict(s, **fake),
                           times=PERSISTENT_OVERFLOW_BATCHES):
        with pytest.warns(pkg.Overflow):
            for _ in range(PERSISTENT_OVERFLOW_BATCHES):
                _, _, st = re_.execute(qx, qy)
                assert int(st["overflow_queries"]) == 7
    assert re_.join() == HEALTHY
    assert re_.plan.cand_capacity == M  # bumped to the injected need
    # injection exhausted: the next batch reports the true (clean) stats
    z, a, st = re_.execute(qx, qy)
    assert int(st["overflow_queries"]) == 0
    return (z, a), {k: re_.stats()[k] for k in COUNTERS}


def test_synthetic_streak_via_stats_injection_drives_real_machinery():
    out, s = _run_synthetic(PORT)
    assert s["swaps"] == 1
    ref_out, ref_s = _run_synthetic(REF)
    _assert_close(out, ref_out)
    assert s == ref_s


def _run_stale(pkg):
    """A batch in flight while the swap lands carries the OLD plan's
    streak; its trigger must not re-plan the already-replaced plan."""
    _, plan, re_ = _reestimator(pkg, _dataset())
    qx, qy = _batch(pkg, _storm())
    with pytest.warns(pkg.Overflow):
        for _ in range(PERSISTENT_OVERFLOW_BATCHES):
            re_.execute(qx, qy)
    assert re_.join() == HEALTHY
    assert re_.plan is not plan
    re_._maybe_replan(plan)  # the stale in-flight batch's trigger call
    assert re_.state == HEALTHY  # ignored: evidence is about a replaced plan
    return {k: re_.stats()[k] for k in COUNTERS}


def test_stale_plan_evidence_does_not_retrigger_after_swap():
    s = _run_stale(PORT)
    assert (s["triggers"], s["replans"], s["swaps"]) == (1, 1, 1)
    assert s == _run_stale(REF)


def test_constructor_validation():
    data = _dataset()
    plan = _base_plan(PORT, data)
    reg = PlanRegistry()
    with pytest.raises(ValueError, match="growth"):
        CapacityReestimator(reg, "k", plan, growth=1.0)
    with pytest.raises(ValueError, match="max_retries"):
        CapacityReestimator(reg, "k", plan, max_retries=0)
    with pytest.raises(ValueError, match="backoff"):
        CapacityReestimator(reg, "k", plan, backoff=-1.0)
    dense = PORT.build_plan(*data, params=PORT.params, area=1.0, impl="tiled")
    with pytest.raises(ValueError, match="grid plan"):
        CapacityReestimator(reg, "k", dense)


def test_stats_are_python_ints_and_warnings_point_at_the_caller():
    """The re-estimator reads overflow_queries and cand_need_max as ints;
    the overflow and degrade warnings name the caller of ``execute``."""
    _, _, re_ = _reestimator(PORT, _dataset(), max_retries=1)
    qx, qy = _batch(PORT, _storm())
    # the degrade may land during the trigger batch or be delivered on the
    # next one: record across both
    with faults.inject("reestimator.build", error=RuntimeError("broken build")), \
            pytest.warns(CapacityOverflowWarning) as rec:
        for _ in range(PERSISTENT_OVERFLOW_BATCHES):
            _, _, st = re_.execute(qx, qy)
        assert type(st["overflow_queries"]) is int and type(st["cand_need_max"]) is int
        assert re_.join() == DEGRADED
        re_.execute(qx, qy)
    ours = [w for w in rec if issubclass(w.category, (CapacityOverflowWarning, PlanDegradedWarning))]
    assert sorted(w.category.__name__ for w in ours) == ["CapacityOverflowWarning", "PlanDegradedWarning"]
    for w in ours:
        assert w.filename == __file__, (w.category, w.filename)


def test_warmup_swap_runs_on_the_worker_and_degrades_on_failure():
    """A re-plan's warmup batch runs before the swap; one that raises
    leaves the old plan installed and degrades."""
    _, plan, re_ = _reestimator(PORT, _dataset(), warmup=("not-an-array", None))
    qx, qy = _batch(PORT, _storm())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(PERSISTENT_OVERFLOW_BATCHES):
            re_.execute(qx, qy)
    assert re_.join() == DEGRADED and re_.plan is plan
    assert "crashed" in str(re_.last_error)
    _, plan2, re2 = _reestimator(PORT, _dataset(), warmup=_batch(PORT, _clean()))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(PERSISTENT_OVERFLOW_BATCHES):
            re2.execute(qx, qy)
    assert re2.join() == HEALTHY and re2.plan is not plan2


# ------------------------------------------------------------- fault harness
def test_fire_is_noop_when_nothing_armed():
    assert faults.fire("reestimator.build") is None
    sentinel = {"overflow_queries": 3}
    assert faults.fire("reestimator.stats", sentinel) is sentinel
    assert faults.active_points() == ()


def test_unknown_point_rejected_in_inject_and_fire():
    with pytest.raises(ValueError, match="unknown injection point"):
        with faults.inject("reestimator.typo"):
            pass
    with pytest.raises(ValueError, match="unknown injection point"):
        faults.fire("registry.typo")
    assert faults.INJECTION_POINTS == j_faults.INJECTION_POINTS


def test_error_injection_counts_and_disarms_on_exit():
    class Boom(RuntimeError):
        pass

    with faults.inject("reestimator.build", error=Boom) as fault:
        with pytest.raises(Boom):
            faults.fire("reestimator.build")
        assert fault.fired == 1
    assert faults.fire("reestimator.build") is None
    assert faults.active_points() == ()


def test_error_instance_carries_its_message():
    err = ValueError("specific message")
    with faults.inject("reestimator.build", error=err):
        with pytest.raises(ValueError, match="specific message"):
            faults.fire("reestimator.build")


def test_times_bounds_firings_then_passes_through():
    class Boom(RuntimeError):
        pass

    with faults.inject("reestimator.build", error=Boom, times=2) as fault:
        for _ in range(2):
            with pytest.raises(Boom):
                faults.fire("reestimator.build")
        assert faults.fire("reestimator.build") is None
        assert fault.fired == 2


def test_value_and_transform_override():
    for mod in (faults, j_faults):
        with mod.inject("reestimator.capacity", value=7):
            assert mod.fire("reestimator.capacity", 4096) == 7
        with mod.inject("reestimator.stats", transform=lambda s: dict(s, overflow_queries=99)):
            assert mod.fire("reestimator.stats", {"overflow_queries": 0})["overflow_queries"] == 99
        with pytest.raises(ValueError, match="not both"):
            with mod.inject("reestimator.capacity", value=1, transform=int):
                pass


def test_delay_sleeps_before_passthrough():
    t0 = time.monotonic()
    with faults.inject("registry.swap", delay=0.05):
        assert faults.fire("registry.swap", "key") == "key"
    assert time.monotonic() - t0 >= 0.05


def test_nested_faults_fire_in_arming_order():
    for mod in (faults, j_faults):
        with mod.inject("reestimator.capacity", transform=lambda v: v + 1):
            with mod.inject("reestimator.capacity", transform=lambda v: v * 10):
                assert mod.fire("reestimator.capacity", 1) == 20  # outer armed first: (1 + 1) * 10
            assert mod.fire("reestimator.capacity", 1) == 2


def test_crashing_with_block_still_disarms():
    with pytest.raises(KeyError):
        with faults.inject("reestimator.build", error=RuntimeError):
            raise KeyError("test crash inside the block")
    assert faults.active_points() == ()


def test_times_validation():
    with pytest.raises(ValueError, match="times"):
        with faults.inject("reestimator.build", error=RuntimeError, times=0):
            pass


def test_harnesses_are_separate():
    """Arming the reference's harness never arms the port's, and the other
    way round."""
    with j_faults.inject("reestimator.build", error=RuntimeError):
        assert faults.active_points() == ()
        assert faults.fire("reestimator.build") is None
    with faults.inject("registry.swap", value="other"):
        assert j_faults.active_points() == ()
        assert j_faults.fire("registry.swap", "key") == "key"
        assert faults.fire("registry.swap", "key") == "other"


# ------------------------------------------------------------------ registry
def _data(seed, m=64):
    rng = np.random.default_rng(seed)
    dx = rng.random(m).astype(np.float32)
    dy = rng.random(m).astype(np.float32)
    return dx, dy, (dx + dy).astype(np.float32)


def _plan(seed=0):
    # chunked: the cheapest real plan (no kernels, no grid snapshot)
    return build_plan(*_data(seed), params=AIDWParams(k=5, area=1.0), area=1.0, impl="chunked", device="cpu")


def test_register_get_hit_miss_counters():
    reg = PlanRegistry(max_plans=4)
    assert reg.get("absent") is None
    plan = _plan(0)
    assert reg.register("a", plan) is plan
    assert reg.get("a") is plan
    assert "a" in reg and "b" not in reg
    s = reg.stats()
    assert (s["hits"], s["misses"], s["size"]) == (1, 1, 1)


def test_lru_bound_evicts_oldest_and_get_refreshes_recency():
    reg = PlanRegistry(max_plans=2)
    plans = {k: _plan(i) for i, k in enumerate("abc")}
    reg.register("a", plans["a"])
    reg.register("b", plans["b"])
    assert reg.get("a") is plans["a"]  # refresh: "b" is now the LRU entry
    reg.register("c", plans["c"])
    assert len(reg) == 2
    assert reg.get("b") is None
    assert reg.get("a") is plans["a"] and reg.get("c") is plans["c"]
    assert reg.stats()["evictions"] == 1


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_guards_gc_evicts_entry(kind):
    reg = PlanRegistry()
    dx, dy, dz = _data(1)
    if kind == "torch":
        dx, dy, dz = (torch.as_tensor(a) for a in (dx, dy, dz))
    plan = build_plan(dx, dy, dz, params=AIDWParams(k=5, area=1.0), area=1.0, impl="chunked", device="cpu")
    reg.register("g", plan, guards=(dx, dy, dz))
    assert reg.get("g", live=(dx, dy, dz)) is plan
    del dx, dy, dz
    gc.collect()
    assert len(reg) == 0
    assert reg.stats()["evictions"] >= 1


def test_guard_identity_mismatch_is_miss():
    reg = PlanRegistry()
    dx, dy, dz = _data(2)
    plan = build_plan(dx, dy, dz, params=AIDWParams(k=5, area=1.0), area=1.0, impl="chunked", device="cpu")
    reg.register("g", plan, guards=(dx, dy, dz))
    assert reg.get("g", live=(dx.copy(), dy, dz)) is None
    assert len(reg) == 0  # the stale entry was dropped, not served


def test_get_or_build_builds_once():
    reg = PlanRegistry()
    calls = []

    def build():
        calls.append(1)
        return _plan(3)

    p1 = reg.get_or_build("k", build)
    p2 = reg.get_or_build("k", build)
    assert p1 is p2 and len(calls) == 1


def test_swap_replaces_atomically_and_counts():
    reg = PlanRegistry()
    old, new = _plan(4), _plan(5)
    reg.register("k", old)
    assert reg.swap("k", new) is old
    assert reg.get("k") is new
    assert reg.stats()["swaps"] == 1
    with pytest.raises(KeyError):
        reg.swap("absent", new)


def test_swap_with_failing_warmup_keeps_old_plan():
    reg = PlanRegistry()
    old, new = _plan(6), _plan(7)
    reg.register("k", old)
    with pytest.raises(Exception):
        # a warmup batch execute() cannot consume fails BEFORE publication
        reg.swap("k", new, warmup=("not-an-array", None))
    assert reg.get("k") is old
    assert reg.stats()["swaps"] == 0


def test_warmup_runs_execute_before_publish(monkeypatch):
    import repro_torch.engine as engine

    reg = PlanRegistry()
    plan = _plan(8)
    qx = np.linspace(0.1, 0.9, 16).astype(np.float32)
    seen = []
    real = engine.execute
    monkeypatch.setattr(engine, "execute", lambda p, x, y: seen.append((p, "k" in reg)) or real(p, x, y))
    reg.register("k", plan, warmup=(qx, qx))
    assert reg.get("k") is plan
    assert seen == [(plan, False)]  # ran once, before the entry was visible


def test_concurrent_readers_never_see_torn_state_during_swap():
    """Readers run while a swap is held inside its critical section (a fault
    at ``registry.swap`` that waits on an event): each sees a whole plan."""
    reg = PlanRegistry()
    old, new = _plan(9), _plan(10)
    reg.register("k", old)
    seen, stop = [], threading.Event()
    entered, release = threading.Event(), threading.Event()

    def reader():
        while not stop.is_set():
            seen.append(reg.get("k"))

    def hold(key):
        entered.set()
        assert release.wait(60.0)
        return key

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    with faults.inject("registry.swap", transform=hold):
        swapper = threading.Thread(target=reg.swap, args=("k", new))
        swapper.start()
        assert entered.wait(60.0)
        release.set()
        swapper.join(60.0)
    stop.set()
    for t in threads:
        t.join()
    assert seen and all(p is old or p is new for p in seen)
    assert reg.get("k") is new


def test_clear_resets_entries_and_counters():
    reg = PlanRegistry()
    reg.register("a", _plan(11))
    reg.get("a")
    reg.clear()
    s = reg.stats()
    assert (len(reg), s["hits"], s["misses"], s["evictions"], s["swaps"]) == (0, 0, 0, 0, 0)


def test_max_plans_validation():
    with pytest.raises(ValueError, match="max_plans"):
        PlanRegistry(max_plans=0)


def test_plan_key_hashable_and_unhashable_config():
    dx, dy, dz = _data(12)
    k1 = plan_key(dx, dy, dz, {"impl": "grid", "block_q": 64})
    k2 = plan_key(dx, dy, dz, {"impl": "grid", "block_q": 64})
    assert k1 == k2 and hash(k1) == hash(k2)
    assert plan_key(dx, dy, dz, {"grid": [1, 2]}) is None  # unhashable value
    # a prebuilt grid holds tensors, which hash by identity: no key, as the
    # reference's grid (of unhashable arrays) gives none
    grid = _quiet(lambda: _base_plan(PORT, _dataset())).grid
    assert plan_key(dx, dy, dz, {"grid": grid}) is None
    assert plan_key(dx, dy, dz, {"params": AIDWParams(**P)}) is not None


def test_default_registry_is_a_singleton_plan_registry():
    reg = default_registry()
    assert reg is default_registry()
    assert isinstance(reg, PlanRegistry)
    assert reg is not j_serving.default_registry()


# ---------------------------------------------------------------- plan memo
@pytest.fixture
def memo():
    ops.plan_cache_clear()
    yield default_registry()
    ops.plan_cache_clear()


def test_memo_hits_and_misses_and_shims(memo):
    data = tuple(torch.as_tensor(a) for a in _dataset())
    qx, qy = _batch(PORT, _clean())
    kw = dict(params=AIDWParams(**P), area=1.0, impl="grid", device="cpu")
    z1, a1 = aidw(*data, qx, qy, **kw)
    z2, a2 = aidw(*data, qx, qy, **kw)
    _assert_bitwise((z1, a1), (z2, a2))
    assert ops._plan_cache_counters == {"hits": 1, "misses": 1}
    assert len(ops._PLAN_CACHE) == 1 and ops._PLAN_CACHE is memo._entries
    (guards, plan), = ops._PLAN_CACHE.values()
    assert plan.impl == "grid" and all(g() is d for g, d in zip(guards, data))
    # another config is another entry; idw and aidw_v2 memoize too
    idw(*data, qx, qy, device="cpu")
    idw(*data, qx, qy, device="cpu")
    with pytest.warns(DeprecationWarning):
        ops.aidw_v2(*data, qx, qy, params=AIDWParams(**P), area=1.0, device="cpu")
        ops.aidw_v2(*data, qx, qy, params=AIDWParams(**P), area=1.0, device="cpu")
    assert ops._plan_cache_counters == {"hits": 3, "misses": 3} and len(memo) == 3
    with pytest.raises(AttributeError):
        ops._no_such_attribute  # noqa: B018
    ops.plan_cache_clear()
    assert len(ops._PLAN_CACHE) == 0 and ops._plan_cache_counters == {"hits": 0, "misses": 0}


def test_memo_matches_an_unmemoized_plan_and_the_reference(memo):
    data = _dataset()
    q = _clean()
    got = aidw(*data, *_batch(PORT, q), params=AIDWParams(**P), area=1.0, impl="grid", device="cpu")
    _assert_bitwise(got, execute(PORT.build_plan(*data, params=AIDWParams(**P), area=1.0, impl="grid"),
                                 *_batch(PORT, q)))
    _assert_close(got, j_execute(j_build_plan(*data, params=JParams(**P), area=1.0, impl="grid"),
                                 *_batch(REF, q)))


def test_memo_guard_evicts_on_del(memo):
    dx, dy, dz = (torch.as_tensor(a) for a in _dataset())
    aidw(dx, dy, dz, *_batch(PORT, _clean()), params=AIDWParams(**P), area=1.0, impl="grid", device="cpu")
    assert len(memo) == 1
    del dx, dy, dz
    gc.collect()
    assert len(memo) == 0 and memo.stats()["evictions"] == 1


def test_memo_skips_a_prebuilt_grid(memo):
    data = tuple(torch.as_tensor(a) for a in _dataset())
    grid = _base_plan(PORT, data).grid
    aidw(*data, *_batch(PORT, _clean()), params=AIDWParams(**P), area=1.0, impl="grid", grid=grid, device="cpu")
    assert len(memo) == 0 and ops._plan_cache_counters == {"hits": 0, "misses": 0}


def test_memo_keeps_cpu_and_cuda_apart(memo, monkeypatch):
    """The device is part of the key: a CPU plan and a CUDA plan of the same
    arrays are two entries (the CUDA build is faked: this checks the key)."""
    import repro_torch.engine as engine

    built = []
    real = engine.build_plan

    def fake_build(*d, device=None, **kw):
        built.append(device)
        return real(*d, device="cpu", **kw) if device == "cpu" else types.SimpleNamespace(device=device)

    monkeypatch.setattr(engine, "build_plan", fake_build)
    data = tuple(torch.as_tensor(a) for a in _dataset())
    kw = dict(params=AIDWParams(**P), area=1.0, impl="grid")
    p_cpu = ops._cached_build_plan(*data, device="cpu", **kw)
    p_cuda = ops._cached_build_plan(*data, device=None, **kw)
    assert ops._cached_build_plan(*data, device="cuda", **kw) is p_cuda  # None means "cuda"
    assert ops._cached_build_plan(*data, device=torch.device("cpu"), **kw) is p_cpu
    assert built == ["cpu", "cuda"] and len(memo) == 2
    keys = list(memo._entries)
    assert sorted(dict(k[3])["device"] for k in keys) == ["cpu", "cuda"] and keys[0][:3] == keys[1][:3]


# -------------------------------------------------------- libraries, threads
def test_kernel_libraries_load_once_from_two_threads(monkeypatch):
    """A warmup on the worker thread and a serving batch that reach the
    libraries first together build and load each once (``_build._lock``)."""
    builds, loads = [], []
    gate = threading.Barrier(2)

    def fake_build_all():
        builds.append(threading.current_thread().name)
        time.sleep(0.01)  # widen the window a racing second build would take
        return {name: f"lib{name}.so" for name in _build.SOURCES}

    class FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            return types.SimpleNamespace()

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    got = {}

    def first_use(fn_name):
        gate.wait(10.0)
        got[fn_name] = _build.entry(fn_name)

    threads = [threading.Thread(target=first_use, args=(fn,), name=fn)
               for fn in ("aidw_weight_f32", "aidw_knn_alpha_f32")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert len(builds) == 1 and sorted(loads) == sorted(f"lib{n}.so" for n in _build.SOURCES)
    assert set(got) == {"aidw_weight_f32", "aidw_knn_alpha_f32"}
