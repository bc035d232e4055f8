"""Fault tolerance of the port's ``repro_torch.serve`` against the
reference's suite (``tests/test_serve_faults.py``), case for case:
admission control, deadlines, the supervised stepper (retry / circuit
breaker / fallback degradation), the tenant-unpublish race, and the REAL
threaded collector/stepper pair — all driven by the deterministic
``FaultPlan`` seam. The contract everywhere: NO FUTURE IS EVER STRANDED.

Against the reference: the same ``FaultPlan`` scripts through both inline
front-ends on a ``FakeClock`` give the same outcome per future (its rows,
or its error's type and message), the same breaker trips and recoveries,
the same stats, clock sleeps and injection log.

The two faults the port does not copy: a threaded front-end whose drain
keeps failing backs off on the clock between drains (the reference's
collector spins on an expired deadline), and ``close(timeout)`` ends both
loop threads — every queued future fails with ``ServeClosedError`` and
neither ``serve-*`` thread is alive a second later, where the reference's
collector never exits (recorded, then released).
"""
import gc
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro_torch.serve as pserve  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BatchPolicy,
    CircuitBreaker,
    DeadlineExceededError,
    FakeClock,
    FaultContext,
    FaultPlan,
    FlushTimeout,
    InlineExecutor,
    QueueFullError,
    RequestQueue,
    ServeClosedError,
    ServeFrontend,
    ServeFuture,
    ServeStats,
    SupervisorPolicy,
    SystemClock,
    TenantUnpublishedError,
    ThreadExecutor,
    TransientDispatchError,
    WeightPlane,
)

POLICY = BatchPolicy(capacities=(1, 4, 8), flush_timeout=0.01)


@pytest.fixture(autouse=True, scope="module")
def _end_leaked_serve_threads():
    """The reference's ``test_serve_faults.py`` closes threaded front-ends
    whose drain it poisoned for good; their threads then spin for the rest
    of the process, growing in memory and slowing whatever file this worker
    runs next (ROADMAP, "Faults found"). Lift the poison from such closed
    front-ends so their loops drain and return."""
    frontend = sys.modules.get("repro.serve.frontend")
    if frontend is not None:
        for fe in [o for o in gc.get_objects() if type(o) is frontend.ServeFrontend]:
            h = fe.health()
            if h.closed and (h.collector_alive or h.stepper_alive):
                fe.faults = None
                fe.queue.notify_all()
                fe.executor.join(5.0)


class FakeSession:
    """Policy-logic stand-in: ``query`` returns ``scale * table[idx]`` so
    tenant and ENGINE routing are observable — a fallback instance can
    rescale its table. It has no ``out_shape``, so ``submit`` checks no
    ids (as for the reference's double)."""

    donate_params = False

    def __init__(self, num_targets=64, num_classes=3, table=None):
        if table is None:
            rng = np.random.default_rng(0)
            table = rng.normal(size=(num_targets, num_classes))
        self.table = table
        self.compiled = []
        self.served = []

    def compile_query(self, capacity):
        self.compiled.append(int(capacity))

    def query(self, params, idx):
        idx = np.asarray(idx)
        assert idx.shape[0] in self.compiled, (idx.shape, self.compiled)
        self.served.append(idx.shape[0])
        return float(params["scale"]) * self.table[idx]


def _inline(policy=POLICY, fallback=None, supervisor=None, faults=None,
            plane=None, session=None, serve=pserve):
    session = session if session is not None else FakeSession()
    clock = serve.FakeClock()
    fe = serve.ServeFrontend(
        session,
        plane if plane is not None else {"scale": np.float32(1.0)},
        policy=policy, clock=clock, executor=serve.InlineExecutor(),
        fallback=fallback, supervisor=supervisor, faults=faults,
    )
    return fe, session, clock


def _assert_all_resolved(futs):
    for f in futs:
        assert f.done(), "stranded future"
        f.exception(0)  # must not raise TimeoutError


# ---------------------------------------------------------------------------
# ServeFuture idempotency
# ---------------------------------------------------------------------------


def test_future_completion_is_idempotent_first_wins():
    f = ServeFuture()
    assert f.set_result(np.arange(3), via="primary")
    assert not f.set_exception(RuntimeError("late loser"))
    assert not f.set_result(np.zeros(3))
    np.testing.assert_array_equal(f.result(0), np.arange(3))
    assert f.exception(0) is None and f.via == "primary"

    g = ServeFuture()
    assert g.set_exception(TransientDispatchError("x"))
    assert not g.set_result(np.arange(3))
    with pytest.raises(TransientDispatchError):
        g.result(0)
    assert g.wait(0)


# ---------------------------------------------------------------------------
# admission control + deadlines
# ---------------------------------------------------------------------------


def test_bounded_queue_sheds_with_queue_full_error():
    q = RequestQueue(maxsize=2)
    q.put([1], "a", now=0.0, max_batch=8)
    q.put([2], "a", now=0.0, max_batch=8)
    with pytest.raises(QueueFullError, match="shedding"):
        q.put([3], "a", now=0.0, max_batch=8)
    assert len(q) == 2


def test_frontend_sheds_fast_and_counts():
    fe, sess, clock = _inline(
        policy=BatchPolicy(capacities=(1, 4, 8), flush_timeout=0.01, max_pending=4),
    )
    admitted = [fe.submit([i]) for i in range(4)]
    shed = 0
    for i in range(6):
        with pytest.raises(QueueFullError):
            fe.submit([i])
        shed += 1
    fe.pump(force=True)
    for i, f in enumerate(admitted):
        np.testing.assert_array_equal(f.result(0), sess.table[[i]])
    assert fe.stats.shed == shed == 6
    assert fe.stats.completed == 4
    assert fe.health().shed == 6


def test_deadline_expires_at_drain_not_served_dead():
    fe, sess, clock = _inline()
    live = fe.submit([1, 2], timeout=1.0)
    stale = fe.submit([3], timeout=0.005)
    clock.advance(0.02)
    n = fe.pump()
    assert n == 1
    np.testing.assert_array_equal(live.result(0), sess.table[[1, 2]])
    with pytest.raises(DeadlineExceededError, match="expired in queue"):
        stale.result(0)
    assert fe.stats.expired == 1 and fe.stats.completed == 1
    assert len(fe.queue) == 0
    _assert_all_resolved([live, stale])


def test_submit_rejects_nonpositive_timeout():
    fe, _, _ = _inline()
    with pytest.raises(ValueError, match="must be > 0"):
        fe.submit([1], timeout=0.0)


def test_next_deadline_includes_request_deadlines():
    q = RequestQueue()
    q.put([1], "a", now=0.0, max_batch=8, deadline=0.004)
    q.put([2], "a", now=0.0, max_batch=8)
    assert q.next_deadline(POLICY) == pytest.approx(0.004)
    (blk,) = q.drain(POLICY, now=0.02, force=True)
    assert blk.n_valid == 1


def test_force_drain_still_expires_stale_requests():
    q = RequestQueue()
    r = q.put([1], "a", now=0.0, max_batch=8, deadline=0.001)
    blocks = q.drain(POLICY, now=1.0, force=True)
    assert blocks == []
    with pytest.raises(DeadlineExceededError):
        r.future.result(0)


# ---------------------------------------------------------------------------
# ServeStats.qps regression (same-instant completions)
# ---------------------------------------------------------------------------


def test_qps_finite_when_all_completions_on_submit_instant():
    fe, _, clock = _inline()
    futs = [fe.submit([i, i + 1]) for i in range(4)]
    assert fe.pump() == 1
    assert all(f.done() for f in futs)
    q = fe.stats.qps()
    assert np.isfinite(q) and q == pytest.approx(4 / 1e-6)
    assert np.isfinite(fe.stats.summary()["qps"])
    assert np.isnan(ServeStats().qps())


# ---------------------------------------------------------------------------
# retry with capped exponential backoff on the injected clock
# ---------------------------------------------------------------------------


def test_transient_dispatch_retries_with_exact_backoff():
    plan = FaultPlan()
    plan.fail("dispatch", TransientDispatchError("flaky"), times=2)
    sup = SupervisorPolicy(max_retries=2, backoff_base=1e-3, backoff_cap=0.1)
    fe, sess, clock = _inline(supervisor=sup, faults=plan)
    futs = [fe.submit([i, i + 1]) for i in range(4)]
    assert fe.pump() == 1
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(0), sess.table[[i, i + 1]])
        assert f.via == "primary"
    assert fe.stats.retries == 2
    assert clock.sleeps == [1e-3, 2e-3]
    assert fe.breaker.state == CircuitBreaker.CLOSED
    assert fe.breaker.trips == 0


def test_retries_exhausted_fails_block_with_the_error():
    plan = FaultPlan()
    plan.fail("dispatch", TransientDispatchError("hard down"), times=2)
    sup = SupervisorPolicy(max_retries=1, backoff_base=1e-3)
    fe, sess, clock = _inline(supervisor=sup, faults=plan)
    bad = [fe.submit([i, i + 1]) for i in range(4)]
    assert fe.pump() == 1
    for f in bad:
        with pytest.raises(TransientDispatchError, match="hard down"):
            f.result(0)
    good = [fe.submit([i, i + 1]) for i in range(4)]
    clock.advance(POLICY.flush_timeout)
    fe.pump(force=True)
    for i, f in enumerate(good):
        np.testing.assert_array_equal(f.result(0), sess.table[[i, i + 1]])
    assert fe.stats.failed == 4 and fe.stats.failed_blocks == 1
    _assert_all_resolved(bad + good)


def test_backoff_is_capped():
    sup = SupervisorPolicy(max_retries=5, backoff_base=1e-2, backoff_cap=3e-2)
    assert [sup.backoff(a) for a in range(5)] == [1e-2, 2e-2, 3e-2, 3e-2, 3e-2]


# ---------------------------------------------------------------------------
# circuit breaker: trip → degraded fallback serving → half-open → recover
# ---------------------------------------------------------------------------


def _primary_and_fallback():
    primary = FakeSession()
    fallback = FakeSession(table=3.0 * primary.table)
    return primary, fallback


def test_breaker_trips_serves_fallback_and_recovers():
    primary, fallback = _primary_and_fallback()
    plan = FaultPlan()
    plan.fail("dispatch", RuntimeError("device lost"), engine="primary", times=3)
    sup = SupervisorPolicy(max_retries=0, breaker_threshold=3, breaker_cooldown=0.05)
    fe, _, clock = _inline(session=primary, fallback=fallback, supervisor=sup, faults=plan)
    futs = [fe.submit([i % 32, i % 32 + 1]) for i in range(20)]
    assert fe.pump() == 5
    for i, f in enumerate(futs):
        assert f.via == "fallback"
        np.testing.assert_array_equal(f.result(0), fallback.table[[i % 32, i % 32 + 1]])
    assert fe.breaker.state == CircuitBreaker.OPEN
    assert fe.breaker.trips == 1
    assert fe.stats.fallback_blocks == 5 and fe.stats.failed == 0
    h = fe.health()
    assert h.breaker_state == "open" and not h.healthy and h.live
    clock.advance(0.05)
    futs2 = [fe.submit([i, i + 1]) for i in range(8)]
    assert fe.pump() == 2
    for i, f in enumerate(futs2):
        assert f.via == "primary"
        np.testing.assert_array_equal(f.result(0), primary.table[[i, i + 1]])
    assert fe.breaker.state == CircuitBreaker.CLOSED
    assert fe.breaker.recoveries == 1
    assert fe.health().healthy
    _assert_all_resolved(futs + futs2)


def test_breaker_failed_probe_reopens():
    primary, fallback = _primary_and_fallback()
    plan = FaultPlan()
    plan.fail("dispatch", RuntimeError("still down"), engine="primary", times=4)
    sup = SupervisorPolicy(max_retries=0, breaker_threshold=3, breaker_cooldown=0.05)
    fe, _, clock = _inline(session=primary, fallback=fallback, supervisor=sup, faults=plan)
    for i in range(3):
        fe.submit([2 * i, 2 * i + 1], timeout=None)
        clock.advance(POLICY.flush_timeout)
        fe.pump(force=True)
    assert fe.breaker.state == CircuitBreaker.OPEN and fe.breaker.trips == 1
    clock.advance(0.05)
    f = fe.submit([1, 2])
    clock.advance(POLICY.flush_timeout)
    fe.pump(force=True)
    assert f.via == "fallback"
    assert fe.breaker.state == CircuitBreaker.OPEN
    assert fe.breaker.recoveries == 0
    clock.advance(0.05)
    g = fe.submit([3, 4])
    clock.advance(POLICY.flush_timeout)
    fe.pump(force=True)
    assert g.via == "primary"
    assert fe.breaker.state == CircuitBreaker.CLOSED
    assert fe.breaker.recoveries == 1


def test_failure_without_fallback_fails_block_but_keeps_serving():
    plan = FaultPlan()
    plan.fail("dispatch", RuntimeError("boom"), times=1)
    fe, sess, clock = _inline(faults=plan)
    bad = fe.submit([1, 2])
    clock.advance(POLICY.flush_timeout)
    fe.pump(force=True)
    with pytest.raises(RuntimeError, match="boom"):
        bad.result(0)
    good = fe.submit([3, 4])
    clock.advance(POLICY.flush_timeout)
    fe.pump(force=True)
    np.testing.assert_array_equal(good.result(0), sess.table[[3, 4]])
    assert fe.stats.failed == 1 and fe.stats.completed == 1


def test_fallback_ladder_is_prewarmed_at_construction():
    primary, fallback = _primary_and_fallback()
    fe, _, _ = _inline(session=primary, fallback=fallback)
    assert sorted(fallback.compiled) == list(POLICY.capacities)


# ---------------------------------------------------------------------------
# tenant-unpublish race
# ---------------------------------------------------------------------------


def test_tenant_unpublish_race_fails_block_not_stepper():
    sess = FakeSession()
    plane = WeightPlane({"scale": np.float32(1.0)})
    plane.publish("a", {"scale": np.float32(1.0)})
    plane.publish("b", {"scale": np.float32(2.0)})
    plan = FaultPlan()
    plan.call("checkout", lambda ctx: ctx.frontend.plane.unpublish("b"), tenant="b", times=1)
    fe, _, clock = _inline(session=sess, plane=plane, faults=plan)
    fa = [fe.submit([1, 2], tenant="a") for _ in range(2)]
    fb = [fe.submit([1, 2], tenant="b") for _ in range(2)]
    clock.advance(POLICY.flush_timeout)
    fe.pump(force=True)
    for f in fa:
        np.testing.assert_array_equal(f.result(0), sess.table[[1, 2]])
    for f in fb:
        with pytest.raises(TenantUnpublishedError, match="unknown tenant"):
            f.result(0)
    assert fe.breaker.consecutive_failures == 0
    assert fe.stats.failed == 2
    fe.plane.publish("b", {"scale": np.float32(2.0)})
    f2 = fe.submit([3], tenant="b")
    clock.advance(POLICY.flush_timeout)
    fe.pump(force=True)
    np.testing.assert_array_equal(f2.result(0), 2.0 * sess.table[[3]])
    _assert_all_resolved(fa + fb + [f2])


def test_plane_unpublish_unknown_tenant_raises():
    plane = WeightPlane({"scale": np.float32(1.0)})
    with pytest.raises(KeyError, match="unknown tenant"):
        plane.unpublish("ghost")


# ---------------------------------------------------------------------------
# collector supervision: poisoned drain
# ---------------------------------------------------------------------------


def test_inline_collector_survives_poisoned_drain():
    plan = FaultPlan()
    plan.fail("drain", RuntimeError("poisoned drain"), times=1)
    fe, sess, clock = _inline(faults=plan)
    f = fe.submit([5])
    clock.advance(POLICY.flush_timeout)
    assert fe.pump(force=True) == 0
    assert not f.done() and len(fe.queue) == 1
    assert fe.health().collector_errors == 1
    fe.pump(force=True)
    np.testing.assert_array_equal(f.result(0), sess.table[[5]])


def test_inline_flush_retries_transient_poison_then_raises_when_stuck():
    plan = FaultPlan()
    plan.fail("drain", RuntimeError("poisoned"), times=2)
    fe, sess, clock = _inline(faults=plan)
    f = fe.submit([7])
    fe.flush()
    np.testing.assert_array_equal(f.result(0), sess.table[[7]])
    plan2 = FaultPlan()
    plan2.fail("drain", RuntimeError("forever"), times=None)
    fe2, _, _ = _inline(faults=plan2)
    g = fe2.submit([1])
    with pytest.raises(FlushTimeout) as ei:
        fe2.flush()
    assert ei.value.pending == 1
    assert not g.done()


# ---------------------------------------------------------------------------
# flush / close semantics
# ---------------------------------------------------------------------------


def test_threaded_flush_shares_one_deadline_across_futures():
    plan = FaultPlan()
    plan.fail("drain", RuntimeError("wedged"), times=None)
    fe = ServeFrontend(
        FakeSession(), {"scale": np.float32(1.0)}, policy=POLICY,
        clock=SystemClock(), executor=ThreadExecutor(), faults=plan,
    ).start()
    futs = [fe.submit([i]) for i in range(8)]
    t0 = time.monotonic()
    with pytest.raises(FlushTimeout) as ei:
        fe.flush(timeout=0.3)
    elapsed = time.monotonic() - t0
    assert ei.value.pending == 8
    assert elapsed < 8 * 0.3 / 2, f"flush took {elapsed:.2f}s — budget is not shared"
    fe.close(timeout=1.0)
    for f in futs:
        assert f.done()


def test_close_never_started_threaded_serves_backlog_inline():
    sess = FakeSession()
    fe = ServeFrontend(
        sess, {"scale": np.float32(1.0)}, policy=POLICY,
        clock=SystemClock(), executor=ThreadExecutor(),
    )
    futs = [fe.submit([i]) for i in range(3)]
    fe.close()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(0), sess.table[[i]])
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit([1])


def test_close_fails_unserved_futures_with_typed_error():
    plan = FaultPlan()
    plan.fail("drain", RuntimeError("wedged"), times=None)
    fe = ServeFrontend(
        FakeSession(), {"scale": np.float32(1.0)}, policy=POLICY,
        clock=SystemClock(), executor=ThreadExecutor(), faults=plan,
    ).start()
    futs = [fe.submit([i]) for i in range(4)]
    fe.close(timeout=0.5)
    for f in futs:
        with pytest.raises((ServeClosedError, RuntimeError)):
            f.result(0)
    _assert_all_resolved(futs)


def test_wedged_threaded_close_ends_its_threads():
    """A threaded front-end whose drain fails for good: its collector
    backs off between drains instead of spinning, ``close(timeout=0.5)``
    returns, every future holds ``ServeClosedError``, and neither
    ``serve-*`` thread is alive one second later."""
    plan = FaultPlan()
    plan.fail("drain", RuntimeError("wedged"), times=None)
    fe = ServeFrontend(
        FakeSession(), {"scale": np.float32(1.0)}, policy=POLICY,
        clock=SystemClock(), executor=ThreadExecutor(), faults=plan,
    ).start()
    futs = [fe.submit([i]) for i in range(4)]
    t0 = time.monotonic()
    fe.close(timeout=0.5)
    assert time.monotonic() - t0 < 0.5 + 1.0 + fe.supervisor.backoff_cap + 0.5
    for f in futs:
        assert f.done()
        assert isinstance(f.exception(0), ServeClosedError)
    for t in fe.executor.threads:
        t.join(1.0)
    assert [t.name for t in fe.executor.threads] == ["serve-collector", "serve-stepper"]
    assert not any(t.is_alive() for t in fe.executor.threads)
    h = fe.health()
    assert not h.collector_alive and not h.stepper_alive and h.outstanding == 0
    # backed off: 1 + 2 + ... + 64 ms, then 100 ms a drain, over ~0.5 s
    assert 1 <= h.collector_errors < 40, h.collector_errors


def test_reference_wedged_collector_never_exits():
    """The reference's fault, recorded: after ``close(timeout=0.5)`` on a
    front-end whose drain fails for good, its collector is still alive a
    second later, draining with no pause (timeout 0 on an expired
    deadline). Released here by lifting the poison."""
    pytest.importorskip("jax")
    import repro.serve as rserve

    plan = rserve.FaultPlan()
    plan.fail("drain", RuntimeError("wedged"), times=None)
    fe = rserve.ServeFrontend(
        FakeSession(), {"scale": np.float32(1.0)}, policy=rserve.BatchPolicy((1, 4, 8), 0.01),
        clock=rserve.SystemClock(), executor=rserve.ThreadExecutor(), faults=plan,
    ).start()
    futs = [fe.submit([i]) for i in range(4)]
    try:
        fe.close(timeout=0.5)
        assert all(f.done() for f in futs)
        time.sleep(1.0)
        h = fe.health()
        assert h.collector_alive and h.collector_errors > 1000, h.collector_errors
    finally:
        fe.faults = None
        fe.queue.notify_all()
        fe.executor.join(5.0)
    assert not any(t.is_alive() for t in fe.executor.threads)


def test_threaded_collector_backs_off_between_failed_drains():
    """Each failed drain is followed by ``supervisor.backoff(n)`` on the
    front-end's clock (n counting consecutive failures); the first good
    drain serves the requests and resets the count."""

    class RecordingClock(SystemClock):
        def __init__(self):
            self.sleeps = []

        def sleep(self, dt):
            self.sleeps.append(dt)
            super().sleep(dt)

    plan = FaultPlan()
    plan.fail("drain", RuntimeError("poisoned"), times=3)
    clock = RecordingClock()
    sess = FakeSession()
    fe = ServeFrontend(
        sess, {"scale": np.float32(1.0)}, policy=POLICY, clock=clock,
        executor=ThreadExecutor(), faults=plan,
        supervisor=SupervisorPolicy(backoff_base=1e-3, backoff_cap=0.1),
    )
    with fe:
        futs = [fe.submit([i]) for i in range(3)]
        fe.flush(timeout=30.0)
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(1), sess.table[[i]])
    assert clock.sleeps[:3] == [1e-3, 2e-3, 4e-3]
    assert fe.health().collector_errors == 3
    for t in fe.executor.threads:
        t.join(5.0)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# health reporting
# ---------------------------------------------------------------------------


def test_health_snapshot_inline_lifecycle():
    fe, _, clock = _inline()
    h = fe.health()
    assert h.mode == "inline" and h.live and h.healthy
    assert h.queue_depth == 0 and h.outstanding == 0
    fe.submit([1])
    h = fe.health()
    assert h.queue_depth == 1 and h.outstanding == 1
    fe.close()
    assert not fe.health().live


def test_health_threaded_liveness():
    fe = ServeFrontend(
        FakeSession(), {"scale": np.float32(1.0)}, policy=POLICY,
        clock=SystemClock(), executor=ThreadExecutor(),
    )
    assert not fe.health().live
    fe.start()
    assert fe.health().live
    fe.close()
    h = fe.health()
    assert not h.live and not h.collector_alive and not h.stepper_alive


# ---------------------------------------------------------------------------
# FaultPlan determinism
# ---------------------------------------------------------------------------


def test_fault_rule_after_times_counting():
    plan = FaultPlan()
    rule = plan.fail("dispatch", TransientDispatchError("x"), after=2, times=2, label="window")
    fired = 0
    for _ in range(6):
        try:
            plan.fire("dispatch", FaultContext(site="dispatch", clock=FakeClock()))
        except TransientDispatchError:
            fired += 1
    assert fired == 2 and rule.hits == 6 and rule.fired == 2
    assert plan.injected == [("dispatch", "window")] * 2
    assert plan.count("dispatch") == 2 and plan.count("drain") == 0


def test_fault_rules_filter_by_tenant_and_engine():
    plan = FaultPlan()
    plan.fail("dispatch", TransientDispatchError("b only"), tenant="b", engine="primary", times=None)
    clock = FakeClock()
    plan.fire("dispatch", FaultContext(site="dispatch", clock=clock, tenant="a", engine="primary"))
    plan.fire("dispatch", FaultContext(site="dispatch", clock=clock, tenant="b", engine="fallback"))
    with pytest.raises(TransientDispatchError):
        plan.fire("dispatch", FaultContext(site="dispatch", clock=clock, tenant="b", engine="primary"))


def test_fault_delay_advances_fake_clock_only():
    plan = FaultPlan()
    plan.delay("dispatch", 0.25, times=1)
    fe, sess, clock = _inline(faults=plan)
    f = fe.submit([1, 2])
    clock.advance(POLICY.flush_timeout)
    t0 = clock.now()
    fe.pump(force=True)
    assert clock.now() - t0 == pytest.approx(0.25)
    np.testing.assert_array_equal(f.result(0), sess.table[[1, 2]])


# ---------------------------------------------------------------------------
# threaded crash-recovery: the REAL collector/stepper pair under faults
# ---------------------------------------------------------------------------


def _threaded(faults=None, fallback=None, supervisor=None):
    sess = FakeSession()
    fe = ServeFrontend(
        sess, {"scale": np.float32(1.0)},
        policy=BatchPolicy(capacities=(1, 4, 8), flush_timeout=2e-3),
        clock=SystemClock(), executor=ThreadExecutor(),
        faults=faults, fallback=fallback, supervisor=supervisor,
    )
    return fe, sess


def test_threaded_stepper_crash_mid_burst_fails_only_that_block():
    sess = FakeSession()
    plane = WeightPlane({"scale": np.float32(1.0)})
    plane.publish("good", {"scale": np.float32(1.0)})
    plane.publish("bad", {"scale": np.float32(1.0)})
    plan = FaultPlan()
    plan.fail("dispatch", RuntimeError("mid-burst crash"), tenant="bad", times=None)
    fe = ServeFrontend(
        sess, plane,
        policy=BatchPolicy(capacities=(1, 4, 8), flush_timeout=2e-3),
        clock=SystemClock(), executor=ThreadExecutor(), faults=plan,
    )
    with fe:
        good = [fe.submit([i, i + 1], tenant="good") for i in range(8)]
        bad = [fe.submit([i], tenant="bad") for i in range(4)]
        more = [fe.submit([i + 2, i + 3], tenant="good") for i in range(8)]
        fe.flush(timeout=30.0)
        for i, f in enumerate(good):
            np.testing.assert_array_equal(f.result(1), sess.table[[i, i + 1]])
        for f in bad:
            with pytest.raises(RuntimeError, match="mid-burst crash"):
                f.result(1)
        for i, f in enumerate(more):
            np.testing.assert_array_equal(f.result(1), sess.table[[i + 2, i + 3]])
        h = fe.health()
        assert h.live and h.stepper_alive
        assert h.failed == 4
    _assert_all_resolved(good + bad + more)


def test_threaded_collector_survives_poisoned_drain():
    plan = FaultPlan()
    plan.fail("drain", RuntimeError("poisoned drain"), times=1)
    fe, sess = _threaded(faults=plan)
    with fe:
        futs = [fe.submit([i]) for i in range(4)]
        fe.flush(timeout=30.0)
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(1), sess.table[[i]])
        h = fe.health()
        assert h.collector_alive and h.collector_errors >= 1
    _assert_all_resolved(futs)


def test_threaded_breaker_degradation_under_real_threads():
    primary = FakeSession()
    fallback = FakeSession(table=2.0 * primary.table)
    plan = FaultPlan()
    plan.fail("dispatch", RuntimeError("down"), engine="primary", times=None)
    fe = ServeFrontend(
        primary, {"scale": np.float32(1.0)},
        policy=BatchPolicy(capacities=(1, 4, 8), flush_timeout=2e-3),
        clock=SystemClock(), executor=ThreadExecutor(),
        faults=plan, fallback=fallback,
        supervisor=SupervisorPolicy(max_retries=0, breaker_threshold=2, breaker_cooldown=1e-3),
    )
    with fe:
        futs = [fe.submit([i, i + 1]) for i in range(8)]
        fe.flush(timeout=30.0)
        for i, f in enumerate(futs):
            assert f.via == "fallback"
            np.testing.assert_array_equal(f.result(1), fallback.table[[i, i + 1]])
        assert fe.breaker.trips >= 1
        assert fe.stats.failed == 0
    _assert_all_resolved(futs)


# ---------------------------------------------------------------------------
# against the reference: the same fault scripts, the same outcomes
# ---------------------------------------------------------------------------


def _scn_transient_retry(S):
    plan = S.FaultPlan()
    plan.fail("dispatch", S.TransientDispatchError("flaky"), times=2)
    fe, _, clock = _inline(supervisor=S.SupervisorPolicy(max_retries=2), faults=plan,
                           policy=S.BatchPolicy((1, 4, 8), 0.01), serve=S)
    futs = [fe.submit([i, i + 1]) for i in range(4)]
    fe.pump()
    return fe, clock, plan, futs


def _scn_retries_exhausted(S):
    plan = S.FaultPlan()
    plan.fail("dispatch", S.TransientDispatchError("hard down"), times=2)
    fe, _, clock = _inline(supervisor=S.SupervisorPolicy(max_retries=1), faults=plan,
                           policy=S.BatchPolicy((1, 4, 8), 0.01), serve=S)
    futs = [fe.submit([i, i + 1]) for i in range(4)]
    fe.pump()
    futs += [fe.submit([i, i + 1]) for i in range(4)]
    clock.advance(0.01)
    fe.pump(force=True)
    return fe, clock, plan, futs


def _scn_breaker(S, times):
    primary = FakeSession()
    fallback = FakeSession(table=3.0 * primary.table)
    plan = S.FaultPlan()
    plan.fail("dispatch", RuntimeError("device lost"), engine="primary", times=times)
    sup = S.SupervisorPolicy(max_retries=0, breaker_threshold=3, breaker_cooldown=0.05)
    fe, _, clock = _inline(session=primary, fallback=fallback, supervisor=sup, faults=plan,
                           policy=S.BatchPolicy((1, 4, 8), 0.01), serve=S)
    futs = [fe.submit([i % 32, i % 32 + 1]) for i in range(20)]
    fe.pump()
    for _ in range(3):
        clock.advance(0.05)
        futs += [fe.submit([i, i + 1]) for i in range(8)]
        fe.pump()
    return fe, clock, plan, futs


def _scn_unpublish(S):
    plane = S.WeightPlane({"scale": np.float32(1.0)})
    plane.publish("a", {"scale": np.float32(1.0)})
    plane.publish("b", {"scale": np.float32(2.0)})
    plan = S.FaultPlan()
    plan.call("checkout", lambda ctx: ctx.frontend.plane.unpublish("b"), tenant="b", times=1)
    fe, _, clock = _inline(plane=plane, faults=plan, policy=S.BatchPolicy((1, 4, 8), 0.01), serve=S)
    futs = [fe.submit([1, 2], tenant=t) for t in ("a", "b", "a", "b")]
    clock.advance(0.01)
    fe.pump(force=True)
    fe.plane.publish("b", {"scale": np.float32(2.0)})
    futs.append(fe.submit([3], tenant="b"))
    clock.advance(0.01)
    fe.pump(force=True)
    return fe, clock, plan, futs


def _scn_poisoned_drain(S):
    plan = S.FaultPlan()
    plan.fail("drain", RuntimeError("poisoned"), times=2)
    fe, _, clock = _inline(faults=plan, policy=S.BatchPolicy((1, 4, 8), 0.01), serve=S)
    futs = [fe.submit([7]), fe.submit([1, 2, 3])]
    fe.flush()
    return fe, clock, plan, futs


def _scn_deadlines_and_shedding(S):
    plan = S.FaultPlan()
    plan.delay("dispatch", 0.05, times=1)
    fe, _, clock = _inline(faults=plan, policy=S.BatchPolicy((1, 4, 8), 0.01, max_pending=6), serve=S)
    futs = []
    for i in range(10):
        try:
            futs.append(fe.submit([i, i + 1], timeout=0.02 if i % 2 else None))
        except S.QueueFullError as exc:
            futs.append(exc)
    fe.pump()  # one saturated block; its slow dispatch ages the rest
    for i in range(3):
        futs.append(fe.submit([i], timeout=0.03))
    clock.advance(0.01)
    fe.pump(force=True)
    return fe, clock, plan, futs


def _outcome(f):
    if isinstance(f, BaseException):
        return ("submit", type(f).__name__, str(f))
    exc = f.exception(0)
    if exc is not None:
        return ("error", type(exc).__name__, str(exc))
    return ("ok", f.via, np.asarray(f.result(0)).tolist())


def _trace(fe, clock, plan, futs):
    s = fe.stats.summary()
    return dict(
        outcomes=[_outcome(f) for f in futs],
        breaker=(fe.breaker.state, fe.breaker.trips, fe.breaker.recoveries, fe.breaker.consecutive_failures),
        stats={k: (None if isinstance(v, float) and np.isnan(v) else v) for k, v in s.items()},
        latencies=fe.stats.latencies,
        sleeps=clock.sleeps,
        injected=plan.injected,
        collector_errors=fe.health().collector_errors,
        queue=len(fe.queue),
    )


SCENARIOS = {
    "transient_retry": _scn_transient_retry,
    "retries_exhausted": _scn_retries_exhausted,
    "breaker_recovers": lambda S: _scn_breaker(S, 3),
    "breaker_failed_probe": lambda S: _scn_breaker(S, 4),
    "breaker_stays_open": lambda S: _scn_breaker(S, None),
    "tenant_unpublish": _scn_unpublish,
    "poisoned_drain": _scn_poisoned_drain,
    "deadlines_and_shedding": _scn_deadlines_and_shedding,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_outcomes_equal_reference(name):
    """The same fault script through the port's and the reference's
    inline front-ends on a fake clock: the same outcome per future (rows
    and engine, or the error's type and message), the same breaker state,
    trips and recoveries, stats, latencies, clock sleeps and injection
    log."""
    pytest.importorskip("jax")
    import repro.serve as rserve

    got = _trace(*SCENARIOS[name](pserve))
    want = _trace(*SCENARIOS[name](rserve))
    assert got == want
    assert got["injected"], "the script injected no fault"
