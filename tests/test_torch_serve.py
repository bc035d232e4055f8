"""The port's serving front-end (``repro_torch.serve``) against the
reference's load-test harness (``tests/test_serve.py``), case for case, and
against the reference itself on the same inputs.

Ported cases (the reference's names): the capacity ladder and policy, the
queue's saturation / timeout / force / FIFO packing, the clock and executor
seam, the front-end on a fake session (saturation, flush timeout, exact
latency accounting, tenant routing), seeded workloads, microbatched rows
bit for bit the full forward and the serial loop on HAN ACM, RGAT IMDB and
Simple-HGN DBLP under ``fused``, ``fused_kernel`` and the §4.3 bypass, the
amortization of forwards over requests, ``session.query``, two tenants
through one ``donate_params`` session and a streaming ``WeightPlane``, the
plane's spec check, the threaded collector/stepper pair, and the
``task.logits`` deprecation shim. ``BatchPolicy(ego=True)`` serves blocks
through ``session.query_ego`` (rows within 1e-5 of the full forward, a full
forward only for a fallback block), and a weight publish recomputes HAN's
injected β.

Against the reference (same inputs): the same requests through both
``RequestQueue``s give equal ``QueryBlock``s; ``make_workload`` is bit for
bit the reference's; ``tune_capacities`` equals it; ``ServeStats.summary()``
equals it on a ``FakeClock`` with fake sessions; on the three serve tasks,
from the reference's weights converted, the port's microbatched rows are
within 1e-5 of the reference's microbatched rows (the reference's kernel in
interpret mode for ``fused_kernel``) and bit for bit the port's own full
forward. Query ids out of range raise ``IndexError`` at ``submit``, before
the request is queued, where the reference's front-end serves wrapped or
clamped rows (recorded). No module of ``serve/`` but ``clock.py`` reads the
wall clock.

The ``cuda``-marked tests skip without a card. On one: two threads query
one captured session and get bit-exact rows; the threaded front-end over a
captured session serves bit-exact rows with no launch or dispatch counter
moving; a streaming plane checks out fresh device tensors from pinned host
copies; bad ids raise at submit and the same session then serves a block.
"""
import ast
import gc
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import flows, pipeline  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402
from repro_torch.core.hetgraph import autotune_bucket_sizes  # noqa: E402
from repro_torch.core.session import InferenceSession  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ops as fpa_ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BatchPolicy,
    FakeClock,
    InlineExecutor,
    RequestQueue,
    ServeFrontend,
    SystemClock,
    ThreadExecutor,
    WeightPlane,
    make_workload,
    run_serial,
    run_workload,
    tune_capacities,
)

ROOT = Path(__file__).resolve().parent.parent
TASKS = [("han", "acm"), ("rgat", "imdb"), ("simple_hgn", "dblp")]
POLICY = BatchPolicy(capacities=(1, 4, 8), flush_timeout=0.01)
ATOL = 1e-5


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


@pytest.fixture(scope="module")
def tasks():
    return {
        (m, d): pipeline.prepare(m, d, scale=0.04, max_degree=32, seed=0, device="cpu")
        for m, d in TASKS
    }


@pytest.fixture(scope="module")
def rgat_sess(tasks):
    task = tasks[("rgat", "imdb")]
    sess = task.compile(FlowConfig("fused", prune_k=8))
    return task, sess, sess(task.params).numpy()


@pytest.fixture(scope="module")
def ref_tasks():
    pytest.importorskip("jax")
    from repro.core import pipeline as jpipe

    return {
        (m, d): jpipe.prepare(m, d, scale=0.04, max_degree=32, seed=0)
        for m, d in TASKS
    }


class FakeSession:
    """Policy-logic stand-in: ``query`` returns ``scale * table[idx]`` so
    tenant routing is observable, and records every served capacity so
    the never-a-new-shape contract is checkable without a model."""

    donate_params = False

    def __init__(self, num_targets=64, num_classes=3):
        rng = np.random.default_rng(0)
        self.table = rng.normal(size=(num_targets, num_classes))
        self.compiled = []
        self.served = []

    def compile_query(self, capacity):
        self.compiled.append(int(capacity))

    def query(self, params, idx):
        idx = np.asarray(idx)
        assert idx.shape[0] in self.compiled, (idx.shape, self.compiled)
        self.served.append(idx.shape[0])
        return float(params["scale"]) * self.table[idx]


def _inline(session=None, params=None, policy=POLICY, clock=None, serve=None):
    """An inline front-end on a fake clock; ``serve`` picks the package
    (the port's by default, ``repro.serve`` for the reference)."""
    if serve is None:
        fe_cls, clock_cls, ex_cls = ServeFrontend, FakeClock, InlineExecutor
    else:
        fe_cls, clock_cls, ex_cls = serve.ServeFrontend, serve.FakeClock, serve.InlineExecutor
    session = session if session is not None else FakeSession()
    clock = clock if clock is not None else clock_cls()
    fe = fe_cls(
        session,
        params if params is not None else {"scale": np.float32(1.0)},
        policy=policy, clock=clock, executor=ex_cls(),
    )
    return fe, session, clock


def _dispatch_counts():
    return dict(flows.DISPATCH), dict(fpa_ops.LAUNCHES)


# ---------------------------------------------------------------------------
# capacity ladder / policy
# ---------------------------------------------------------------------------


def test_policy_capacity_for_picks_tightest():
    p = BatchPolicy(capacities=(1, 4, 8, 16))
    assert [p.capacity_for(n) for n in (1, 2, 4, 5, 16)] == [1, 4, 4, 8, 16]
    assert p.max_batch == 16
    with pytest.raises(AssertionError):
        p.capacity_for(17)


def test_policy_rejects_bad_ladders():
    with pytest.raises(AssertionError):
        BatchPolicy(capacities=(8, 4))
    with pytest.raises(AssertionError):
        BatchPolicy(capacities=())


def test_tune_capacities_is_the_degree_autotuner():
    """Query-batch bucketing reuses the degree-bucket DP verbatim: same
    optimizer, pointed at a batch-size histogram."""
    sizes = [1, 1, 1, 2, 3, 8, 8, 15, 16]
    assert tune_capacities(sizes, 3) == tuple(
        autotune_bucket_sizes(np.asarray(sizes), 3)
    )

    def padded(caps):
        caps = sorted(caps)
        tot = 0
        for s in sizes:
            tot += next(c for c in caps if c >= s) - s
        return tot

    tuned = tune_capacities(sizes, 3)
    assert padded(tuned) <= padded((4, 8, 16))
    p = BatchPolicy.tuned(sizes, 3, flush_timeout=0.5)
    assert p.capacities == tuned and p.flush_timeout == 0.5


# ---------------------------------------------------------------------------
# queue drain: saturation / timeout / force / FIFO packing
# ---------------------------------------------------------------------------


def test_drain_saturation_emits_full_blocks_immediately():
    q = RequestQueue()
    for i in range(5):  # 5 x 3 targets, max_batch 8 -> 2 full, 1 partial
        q.put(np.arange(3) + 10 * i, "default", now=0.0, max_batch=8)
    blocks = q.drain(POLICY, now=0.0)  # age 0: only saturated blocks emit
    assert [b.n_valid for b in blocks] == [6, 6]
    assert len(q) == 1
    assert all(b.capacity == 8 for b in blocks)


def test_drain_flush_timeout_gates_partial_blocks():
    q = RequestQueue()
    q.put([1, 2], "default", now=0.0, max_batch=8)
    assert q.drain(POLICY, now=0.005) == []
    assert len(q) == 1
    (blk,) = q.drain(POLICY, now=0.011)
    assert blk.n_valid == 2 and blk.capacity == 4
    assert len(q) == 0
    assert q.next_deadline(POLICY) is None


def test_drain_force_flushes_everything():
    q = RequestQueue()
    q.put([1], "a", now=0.0, max_batch=8)
    q.put([2], "b", now=0.0, max_batch=8)
    assert q.drain(POLICY, now=0.0) == []
    blocks = q.drain(POLICY, now=0.0, force=True)
    assert [b.tenant for b in blocks] == ["a", "b"]
    assert len(q) == 0


def test_drain_packs_fifo_never_splits_never_mixes_tenants():
    q = RequestQueue()
    r1 = q.put([1, 2, 3, 4, 5], "a", now=0.0, max_batch=8)
    r2 = q.put([6, 7, 8, 9], "a", now=0.0, max_batch=8)
    r3 = q.put([10], "b", now=0.0, max_batch=8)
    blocks = q.drain(POLICY, now=1.0, force=True)
    assert [b.tenant for b in blocks] == ["a", "a", "b"]
    b0, b1, b2 = blocks
    assert b0.requests[0][0] is r1 and b0.n_valid == 5
    np.testing.assert_array_equal(b0.idx[:5], [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(b0.idx[5:], [1, 1, 1])  # valid-id padding
    assert b1.requests[0][0] is r2 and b1.n_valid == 4 and b1.capacity == 4
    assert b2.requests[0][0] is r3 and b2.capacity == 1
    assert [s for _, s in b0.requests] == [slice(0, 5)]


def test_put_validates_requests():
    q = RequestQueue()
    with pytest.raises(ValueError, match="empty query"):
        q.put([], "default", now=0.0, max_batch=8)
    with pytest.raises(ValueError, match="exceeds the largest"):
        q.put(np.arange(9), "default", now=0.0, max_batch=8)


# ---------------------------------------------------------------------------
# clock / executor seam
# ---------------------------------------------------------------------------


def test_fake_clock_records_and_advances():
    c = FakeClock(t0=5.0)
    c.sleep(0.25)
    c.advance(0.75)
    assert c.now() == 6.0 and c.sleeps == [0.25]


def test_inline_executor_refuses_to_spawn():
    with pytest.raises(RuntimeError, match="pump"):
        InlineExecutor().spawn("x", lambda: None)


def test_only_the_clock_seam_reads_the_wall_clock():
    """The reference lints ``serve/`` for raw ``time.*`` calls
    (``tools/analyze/rules/serve_concurrency.py``, which scans only
    ``src/repro``); the port keeps the rule by hand: no module of its
    ``serve/`` but ``clock.py`` touches ``time``, and there each use sits
    under an ``allow(serve-wallclock)`` line."""
    serve_dir = ROOT / "src" / "repro_torch" / "serve"
    files = sorted(serve_dir.glob("*.py"))
    assert len(files) == 8
    for path in files:
        src = path.read_text()
        lines = src.splitlines()
        for node in ast.walk(ast.parse(src)):
            uses_time = (
                isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id == "time"
            ) or (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "Timer")
            if uses_time:
                assert path.name == "clock.py", f"{path.name}:{node.lineno} reads the wall clock"
                assert "allow(serve-wallclock)" in lines[node.lineno - 2], f"clock.py:{node.lineno}"


# ---------------------------------------------------------------------------
# front-end on the fake session: saturation, bucketing, timeout, stats
# ---------------------------------------------------------------------------


def test_frontend_prewarms_whole_ladder():
    fe, sess, _ = _inline()
    assert sorted(sess.compiled) == list(POLICY.capacities)


def test_frontend_saturation_microbatches():
    """A burst bigger than max_batch is served as full blocks with no
    timeout wait — and every served shape is a ladder capacity."""
    fe, sess, clock = _inline()
    futs = [fe.submit([i, i + 1]) for i in range(0, 20, 2)]
    n_blocks = fe.pump()
    assert n_blocks == 2 and sess.served == [8, 8]
    assert sum(f.done() for f in futs) == 8
    clock.advance(POLICY.flush_timeout)
    assert fe.pump() == 1
    assert sess.served == [8, 8, 4]
    assert all(f.done() for f in futs)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(
            f.result(0), sess.table[[2 * i, 2 * i + 1]]
        )
    assert set(sess.served) <= set(POLICY.capacities)


def test_frontend_flush_timeout_on_fake_clock():
    fe, sess, clock = _inline()
    f = fe.submit([3])
    assert fe.pump() == 0 and not f.done()
    clock.advance(0.009)
    assert fe.pump() == 0
    clock.advance(0.002)
    assert fe.pump() == 1 and f.done()
    np.testing.assert_array_equal(f.result(0), sess.table[[3]])


def test_frontend_latency_accounting_is_exact():
    """p50/p99/QPS are exact functions of the fake clock: requests
    submitted at t=0,1,2,3 all complete at t=10 -> latencies 10,9,8,7."""
    fe, _, clock = _inline()
    for i in range(4):
        clock.advance(0.0 if i == 0 else 1.0)
        fe.submit([i, i + 1])
    clock.advance(7.0)
    assert fe.pump() == 1
    s = fe.stats
    assert sorted(s.latencies) == [7.0, 8.0, 9.0, 10.0]
    assert s.percentile(50) == 8.5
    assert s.percentile(99) == pytest.approx(10.0 - 0.03)
    assert s.qps() == pytest.approx(4 / 10.0)
    assert s.summary()["mean_batch"] == 8.0
    assert s.summary()["pad_fraction"] == 0.0


def test_frontend_multi_tenant_routing_fake():
    fe, sess, clock = _inline()
    fe.plane.publish("b", {"scale": np.float32(2.0)})
    fa = fe.submit([1, 2], tenant="default")
    fb = fe.submit([1, 2], tenant="b")
    clock.advance(1.0)
    assert fe.pump() == 2
    np.testing.assert_array_equal(fa.result(0), sess.table[[1, 2]])
    np.testing.assert_array_equal(fb.result(0), 2.0 * sess.table[[1, 2]])
    with pytest.raises(KeyError, match="unknown tenant"):
        fe.submit([1], tenant="nope")


def test_workload_generator_is_seeded():
    a = make_workload(16, 50, rate=100.0, tenants=("x", "y"), seed=7)
    b = make_workload(16, 50, rate=100.0, tenants=("x", "y"), seed=7)
    assert len(a) == 16
    for wa, wb in zip(a, b):
        assert wa.t_offset == wb.t_offset and wa.tenant == wb.tenant
        np.testing.assert_array_equal(wa.targets, wb.targets)
    assert any(w.tenant == "x" for w in a) and any(w.tenant == "y" for w in a)
    offs = [w.t_offset for w in a]
    assert offs == sorted(offs) and offs[-1] > 0


def test_paced_workload_on_fake_clock_is_deterministic():
    def once():
        fe, sess, clock = _inline()
        wl = make_workload(12, 64, rate=200.0, size_range=(1, 3), seed=11)
        futs = run_workload(fe, wl)
        assert all(f.done() for f in futs)
        return sess.served, fe.stats.latencies, fe.stats.qps()

    assert once() == once()


@pytest.mark.parametrize("model,dataset", TASKS)
def test_ego_policy_routes_blocks_through_query_ego(tasks, model, dataset):
    """``BatchPolicy(ego=True)`` enables ego on the primary and serves each
    block through ``query_ego``, the ragged final block included: every row
    within 1e-5 of the full forward (``fused_kernel``, its plain versions
    here), one ego call or one counted fallback a block, and a full forward
    (``query``) only for a fallback block."""
    task = tasks[(model, dataset)]
    sess = InferenceSession(task.model, task.batch, FlowConfig("fused_kernel", prune_k=8), params=task.params)
    full = sess(task.params).numpy()
    fe, _, _ = _inline(session=sess, params=task.params,
                       policy=BatchPolicy(capacities=(1, 4, 8), flush_timeout=0.01, ego=True))
    assert BatchPolicy(ego=True).ego and sess.ego_planner is not None
    before = dict(flows.DISPATCH)
    wl = make_workload(13, task.batch.num_targets, size_range=(1, 3), seed=3)
    futs = run_workload(fe, wl)
    for w, f in zip(wl, futs):
        assert isinstance(f.result(0), np.ndarray)
        np.testing.assert_allclose(f.result(0), full[w.targets], rtol=0, atol=ATOL)
    d = {k: flows.DISPATCH[k] - before[k] for k in before}
    assert fe.stats.completed == len(wl) and fe.stats.blocks < len(wl)
    assert d["ego_calls"] + d["ego_fallback"] == fe.stats.blocks
    assert d["query_calls"] == d["ego_fallback"]


def test_ego_globals_recomputed_on_publish(tasks):
    """HAN's β is cached per tenant weight version: blocks of one version
    compute it once, and a publish (a new version token) recomputes it, so
    the new weights' rows are served within 1e-5 of their full forward."""
    task = tasks[("han", "acm")]
    sess = InferenceSession(task.model, task.batch, FlowConfig("fused", prune_k=8), params=task.params)
    other = {n: t * 0.5 for n, t in task.params.items()}
    plane = WeightPlane(task.params)
    plane.publish("t", task.params)
    fe, _, _ = _inline(session=sess, params=plane,
                       policy=BatchPolicy(capacities=(1, 4, 8), flush_timeout=0.01, ego=True))
    computed = []
    ego_globals = task.model.ego_globals

    def counted(*args, **kw):
        computed.append(1)
        return ego_globals(*args, **kw)

    task.model.ego_globals = counted
    try:
        wl = make_workload(9, task.batch.num_targets, size_range=(1, 3), tenants=("t",), seed=4)
        for params in (task.params, other):
            plane.publish("t", params)
            full = sess(params).numpy()
            for w, f in zip(wl, run_workload(fe, wl)):
                np.testing.assert_allclose(f.result(0), full[w.targets], rtol=0, atol=ATOL)
            beta = fe._ego_globals["t"][1]["sem_beta"]
            np.testing.assert_allclose(beta.numpy(), ego_globals(params, task.batch, sess.flow)["sem_beta"].numpy(),
                                       rtol=0, atol=0)
    finally:
        del task.model.ego_globals
    assert len(computed) == 2
    assert fe.stats.blocks > 2


# ---------------------------------------------------------------------------
# real sessions: microbatch == serial == full-forward slices, bit-exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,dataset", TASKS)
@pytest.mark.parametrize(
    "flow",
    [
        FlowConfig("fused", prune_k=8),
        FlowConfig("fused_kernel", prune_k=8),
        FlowConfig("fused", prune_k=64),
    ],
    ids=("fused", "fused_kernel", "fused_bypass"),
)
def test_microbatch_parity_sweep(tasks, model, dataset, flow):
    """Microbatched query blocks are bit-identical to one-at-a-time
    serial slices AND to full-forward slices, ragged final block
    included."""
    task = tasks[(model, dataset)]
    sess = task.compile(flow)
    full = sess(task.params).numpy()
    fe, _, clock = _inline(session=sess, params=task.params)
    wl = make_workload(13, task.batch.num_targets, size_range=(1, 3), seed=3)
    futs = run_workload(fe, wl)
    for w, f in zip(wl, futs):
        assert isinstance(f.result(0), np.ndarray)
        np.testing.assert_array_equal(f.result(0), full[w.targets])
    if flow.flow == "fused":
        serial, _ = run_serial(sess, task.params, wl, POLICY, FakeClock())
        for f, s in zip(futs, serial):
            np.testing.assert_array_equal(f.result(0), s)
    assert fe.stats.blocks < len(wl)
    assert fe.stats.completed == len(wl)


def test_serving_zero_python_dispatch(rgat_sess):
    """The amortization: one forward per block, not per request. On the
    CPU a session runs the eager forward, so each served block enters NA
    dispatch exactly as often as one forward does (zero on a card, where
    a block replays the captured graph: the ``cuda`` test below), and the
    query-call counter counts blocks."""
    task, sess, _ = rgat_sess
    fe, _, clock = _inline(session=sess, params=task.params)
    wl = make_workload(16, task.batch.num_targets, size_range=(2, 2), seed=5)
    run_workload(fe, wl)
    before = dict(flows.DISPATCH)
    sess(task.params)
    per_forward = flows.DISPATCH["graph_calls"] - before["graph_calls"]
    assert per_forward > 0
    blocks_before = fe.stats.blocks
    before = dict(flows.DISPATCH)
    wl2 = make_workload(16, task.batch.num_targets, size_range=(2, 2), seed=6)
    run_workload(fe, wl2)
    blocks = fe.stats.blocks - blocks_before
    assert flows.DISPATCH["query_calls"] - before["query_calls"] == blocks
    assert flows.DISPATCH["graph_calls"] - before["graph_calls"] == per_forward * blocks
    assert blocks < len(wl2)


def test_query_entry_matches_full_forward(rgat_sess):
    task, sess, full = rgat_sess
    idx = np.array([5, 0, 5, 2], np.int32)
    np.testing.assert_array_equal(sess.query(task.params, idx).numpy(), full[idx])
    assert 4 in sess.query_capacities
    with pytest.raises(ValueError, match="1-D"):
        sess.query(task.params, np.zeros((2, 2), np.int32))


def test_multi_tenant_streaming_real(rgat_sess):
    """Two param versions through ONE donate_params session: each
    tenant's rows match its own full forward, bit for bit."""
    task, sess, full_init = rgat_sess
    trained = pipeline.train_hgnn(task, steps=3, lr=5e-3)
    full_trained = sess(trained).numpy()
    sess_d = task.compile(FlowConfig("fused", prune_k=8), donate_params=True)
    assert sess_d.donate_params and sess_d is not sess
    assert sess_d is task.compile(FlowConfig("fused", prune_k=8), donate_params=True)
    plane = WeightPlane(task.params, stream=True)
    plane.publish("init", task.params)
    plane.publish("trained", trained)
    fe, _, clock = _inline(session=sess_d, params=plane)
    wl = make_workload(
        12, task.batch.num_targets, tenants=("init", "trained"), seed=9
    )
    futs = run_workload(fe, wl)
    ref = {"init": full_init, "trained": full_trained}
    for w, f in zip(wl, futs):
        np.testing.assert_array_equal(f.result(0), ref[w.tenant][w.targets])
    assert len(fe.session.query_capacities) <= len(POLICY.capacities)
    # a streamed checkout is a fresh copy; the caller's tensors stay valid
    a, b = plane.checkout("init"), plane.checkout("init")
    for name, t in task.params.items():
        assert torch.equal(a[name], t) and a[name].data_ptr() != b[name].data_ptr()
        assert a[name].data_ptr() != t.data_ptr()
    assert plane.version_token("init") == plane.version_token("init")


def test_donate_handle_shares_the_program(rgat_sess):
    """``compile(donate_params=True)`` next to a cached session that
    differs only in the flag is a second handle on the same program: the
    same model, batch and flow, its own ladder and forward count, and the
    same rows bit for bit."""
    task, sess, full = rgat_sess
    sess_d = task.compile(FlowConfig("fused", prune_k=8), donate_params=True)
    assert sess_d is not sess and sess_d.donate_params and not sess.donate_params
    assert (sess_d.model, sess_d.graph_batch, sess_d.flow) == (sess.model, sess.graph_batch, sess.flow)
    assert sess_d._graph is sess._graph
    sess_d.prewarm((5,))
    assert 5 in sess_d.query_capacities and 5 not in sess.query_capacities
    before = (sess.forwards, sess_d.forwards)
    np.testing.assert_array_equal(sess_d(task.params).numpy(), full)
    idx = np.array([4, 0, 4], np.int32)
    np.testing.assert_array_equal(sess_d.query(task.params, idx).numpy(), full[idx])
    assert (sess.forwards, sess_d.forwards) == (before[0], before[1] + 2)


def test_plane_rejects_incompatible_params(rgat_sess):
    task, _, _ = rgat_sess
    plane = WeightPlane(task.params)
    bad = {n: torch.zeros(tuple(t.shape) + (1,), dtype=t.dtype) for n, t in task.params.items()}
    with pytest.raises(ValueError, match="aval-compatible"):
        plane.publish("bad", bad)
    with pytest.raises(KeyError, match="unknown tenant"):
        plane.checkout("missing")


def test_donate_session_requires_streaming_plane(rgat_sess):
    task, _, _ = rgat_sess
    sess_d = task.compile(FlowConfig("fused", prune_k=8), donate_params=True)
    plane = WeightPlane(task.params, stream=False)
    plane.publish("default", task.params)
    with pytest.raises(ValueError, match="stream=True"):
        ServeFrontend(
            sess_d, plane, policy=POLICY, clock=FakeClock(),
            executor=InlineExecutor(),
        )


def test_threaded_frontend_smoke(rgat_sess):
    """The real collector/stepper pair, synchronized only by futures and
    condition variables: every request completes with bit-exact rows."""
    task, sess, full = rgat_sess
    policy = BatchPolicy(capacities=(1, 4, 8), flush_timeout=2e-3)
    with ServeFrontend(
        sess, task.params, policy=policy, clock=SystemClock(),
        executor=ThreadExecutor(),
    ) as fe:
        wl = make_workload(24, task.batch.num_targets, size_range=(1, 3), seed=4)
        futs = run_workload(fe, wl)
        for w, f in zip(wl, futs):
            np.testing.assert_array_equal(f.result(30), full[w.targets])
        assert fe.stats.completed == 24
    for t in fe.executor.threads:
        t.join(5.0)
        assert not t.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit([1])


# ---------------------------------------------------------------------------
# task.logits deprecation shim regression
# ---------------------------------------------------------------------------


def test_logits_shim_warns_once_and_stays_bit_identical():
    """Exactly ONE DeprecationWarning per task however many calls, and
    bit-identical to model.apply — per flow."""
    task = pipeline.prepare("rgat", "imdb", scale=0.03, max_degree=32, seed=0, device="cpu")
    flow = FlowConfig("fused", prune_k=8)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        a = task.logits(task.params, flow)
        b = task.logits(task.params)
    deps = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1 and "task.compile" in str(deps[0].message)
    assert torch.equal(a, task.model.apply(task.params, task.batch, flow))
    assert torch.equal(b, task.model.apply(task.params, task.batch, FlowConfig()))
    task2 = pipeline.prepare("rgat", "imdb", scale=0.03, max_degree=32, seed=1, device="cpu")
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        task2.logits(task2.params)
    assert sum(issubclass(w.category, DeprecationWarning) for w in rec2) == 1


# ---------------------------------------------------------------------------
# against the reference, on the same inputs
# ---------------------------------------------------------------------------


def _ref_serve():
    pytest.importorskip("jax")
    import repro.serve as rserve

    return rserve


QUEUE_CASES = [
    # (n_requests, size_range, tenants, rate, capacities, flush_timeout)
    (40, (1, 4), ("default",), None, (1, 4, 8, 16), 2e-3),
    (37, (1, 3), ("a", "b", "c"), 500.0, (1, 4, 8), 1e-2),
    (25, (2, 8), ("x", "y"), 50.0, (2, 8), 5e-3),
    (60, (1, 1), ("default",), 2000.0, (1, 2, 4, 8, 16), 1e-3),
]


@pytest.mark.parametrize("case", QUEUE_CASES, ids=[f"q{i}" for i in range(len(QUEUE_CASES))])
def test_query_blocks_equal_reference(case):
    """The same requests, put at the same clock times, drain into equal
    ``QueryBlock``s in both packages: idx, request slices (by sequence
    number), n_valid, tenant, oldest stamp, and the same requests left
    pending and expired."""
    rserve = _ref_serve()
    n, sizes, tenants, rate, caps, flush = case
    wl = make_workload(n, 300, rate=rate, size_range=sizes, tenants=tenants, seed=n)
    port_policy = BatchPolicy(caps, flush_timeout=flush)
    ref_policy = rserve.BatchPolicy(caps, flush_timeout=flush)
    queues = (RequestQueue(), rserve.RequestQueue())
    got = ([], [])
    for i, w in enumerate(wl):
        deadline = w.t_offset + 4 * flush if i % 5 == 0 else None
        for q in queues:
            q.put(w.targets, w.tenant, w.t_offset, port_policy.max_batch, deadline=deadline)
        now = w.t_offset + (flush if i % 3 == 0 else 0.0)
        for out, q, pol in zip(got, queues, (port_policy, ref_policy)):
            out.extend(q.drain(pol, now, force=(i == n - 1), on_expired=lambda r, out=out: out.append(("expired", r.seq))))
    assert len(got[0]) == len(got[1]) > 0
    for a, b in zip(*got):
        if isinstance(a, tuple):
            assert a == b
            continue
        np.testing.assert_array_equal(a.idx, b.idx)
        assert a.idx.dtype == b.idx.dtype == np.int32
        assert (a.tenant, a.n_valid, a.t_oldest, a.capacity) == (b.tenant, b.n_valid, b.t_oldest, b.capacity)
        assert [(r.seq, s) for r, s in a.requests] == [(r.seq, s) for r, s in b.requests]
    assert len(queues[0]) == len(queues[1]) == 0


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_requests=64, num_targets=4019, rate=None, size_range=(1, 4), seed=0),
        dict(n_requests=64, num_targets=4019, rate=2000.0, size_range=(1, 4), seed=0),
        dict(n_requests=33, num_targets=50, rate=100.0, size_range=(2, 7), tenants=("x", "y", "z"), seed=7),
        dict(n_requests=1, num_targets=1, rate=None, size_range=(1, 1), seed=123),
    ],
    ids=("saturation", "paced", "tenants", "single"),
)
def test_make_workload_bit_identical_to_reference(kw):
    rserve = _ref_serve()
    a, b = make_workload(**kw), rserve.make_workload(**kw)
    assert len(a) == len(b) == kw["n_requests"]
    for wa, wb in zip(a, b):
        assert wa.t_offset == wb.t_offset and wa.tenant == wb.tenant
        assert wa.targets.dtype == wb.targets.dtype == np.int32
        np.testing.assert_array_equal(wa.targets, wb.targets)


@pytest.mark.parametrize(
    "sizes,buckets",
    [
        ([1, 1, 1, 2, 3, 8, 8, 15, 16], 3),
        ([1, 1, 1, 2, 3, 8, 8, 15, 16], 1),
        ([4] * 10, 4),
        (list(range(1, 65)), 4),
        ([1, 2, 2, 3, 3, 3, 16, 16, 17, 30, 31, 64, 64, 64], 2),
    ],
    ids=("mixed3", "mixed1", "flat", "ramp", "skewed"),
)
def test_tune_capacities_equal_reference(sizes, buckets):
    rserve = _ref_serve()
    got, want = tune_capacities(sizes, buckets), rserve.tune_capacities(sizes, buckets)
    assert got == tuple(int(c) for c in want)
    assert BatchPolicy.tuned(sizes, buckets).capacities == rserve.BatchPolicy.tuned(sizes, buckets).capacities


def _summary_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("rate,seed", [(None, 0), (200.0, 11), (50.0, 3)], ids=("burst", "paced", "slow"))
def test_stats_summary_equal_reference(rate, seed):
    """The same paced workload through both inline front-ends on a fake
    clock, over equal fake sessions: equal ``ServeStats.summary()``,
    latencies, served capacities and rows."""
    rserve = _ref_serve()
    out = []
    for serve in (None, rserve):
        fe, sess, clock = _inline(serve=serve)
        fe.plane.publish("t2", {"scale": np.float32(2.0)})
        wl = (make_workload if serve is None else serve.make_workload)(
            30, 64, rate=rate, size_range=(1, 3), tenants=("default", "t2"), seed=seed
        )
        run = run_workload if serve is None else serve.run_workload
        futs = run(fe, wl)
        out.append((fe.stats.summary(), fe.stats.latencies, sess.served, [f.result(0) for f in futs]))
    (sa, la, va, ra), (sb, lb, vb, rb) = out
    _summary_equal(sa, sb)
    assert la == lb and va == vb
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("flow", [("fused", 8), ("fused_kernel", 8)], ids=("fused", "fused_kernel"))
@pytest.mark.parametrize("model,dataset", TASKS)
def test_microbatched_rows_match_reference(tasks, ref_tasks, model, dataset, flow):
    """On the reference's three serve tasks, from the reference's weights
    converted: the port's microbatched rows are within 1e-5 of the
    reference's microbatched rows (its kernel in interpret mode under
    ``fused_kernel``) and bit for bit the port's own full forward."""
    import jax
    from repro.core.flows import FlowConfig as JFlowConfig

    rserve = _ref_serve()
    tt, jt = tasks[(model, dataset)], ref_tasks[(model, dataset)]
    params = params_from_reference(jax.tree_util.tree_map(np.asarray, jt.params), device="cpu", model=tt.model)
    sess = tt.compile(FlowConfig(*flow), params=params)
    full = sess(params).numpy()
    jsess = jt.compile(JFlowConfig(*flow))
    wl = make_workload(13, tt.batch.num_targets, size_range=(1, 3), seed=3)
    fe, _, _ = _inline(session=sess, params=params)
    jfe, _, _ = _inline(session=jsess, params=jt.params, serve=rserve, policy=rserve.BatchPolicy((1, 4, 8), 0.01))
    futs, jfuts = run_workload(fe, wl), rserve.run_workload(jfe, wl)
    for w, f, jf in zip(wl, futs, jfuts):
        np.testing.assert_array_equal(f.result(0), full[w.targets])
        np.testing.assert_allclose(f.result(0), np.asarray(jf.result(0)), atol=ATOL, rtol=0)
    assert fe.stats.blocks == jfe.stats.blocks < len(wl)


def test_submit_out_of_range_ids_raise_before_queueing(rgat_sess, ref_tasks):
    """An id outside ``[0, num_targets)`` raises ``IndexError`` naming it
    at ``submit``: the request is never queued, no forward runs, and the
    front-end serves on. The reference's front-end accepts such ids and
    its gather wraps a negative id and clamps a large one (recorded)."""
    from repro.core.flows import FlowConfig as JFlowConfig

    rserve = _ref_serve()
    jt = ref_tasks[("rgat", "imdb")]
    jsess = jt.compile(JFlowConfig("fused", prune_k=8))
    jfull = np.asarray(jsess(jt.params))
    n = jfull.shape[0]
    jfe, _, _ = _inline(session=jsess, params=jt.params, serve=rserve, policy=rserve.BatchPolicy((1, 4, 8), 0.01))
    wrapped, clamped = jfe.submit([-1]), jfe.submit([n + 2, 0])
    jfe.flush()
    np.testing.assert_array_equal(np.asarray(wrapped.result(0)), jfull[[n - 1]])
    np.testing.assert_array_equal(np.asarray(clamped.result(0)), jfull[[n - 1, 0]])

    task, sess, full = rgat_sess
    assert sess.out_shape[0] == task.batch.num_targets == n
    fe, _, _ = _inline(session=sess, params=task.params)
    before = dict(flows.DISPATCH)
    for bad, named in (([-1], "-1"), ([n], str(n)), ([0, n + 2, -3], "-3")):
        with pytest.raises(IndexError, match=named):
            fe.submit(bad)
    assert len(fe.queue) == 0 and fe.stats.submitted == 0 and fe.health().outstanding == 0
    assert flows.DISPATCH == before
    good = fe.submit([n - 1, 0])
    fe.flush()
    np.testing.assert_array_equal(good.result(0), full[[n - 1, 0]])


# ---------------------------------------------------------------------------
# on a card: the captured session under concurrent callers and the stepper
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _cuda_task(dev):
    return pipeline.prepare("rgat", "imdb", scale=0.04, max_degree=32, seed=0, device=dev)


@pytest.mark.cuda
def test_cuda_two_threads_share_one_session(cuda_device):
    """Two threads query one captured session 200 times each, with
    different weight versions and ids: every block's rows are bit for bit
    the full forward's. One thread stays on the default stream, the other
    on a stream of its own, so calls keep switching streams: replays of
    one session are serialized on the card by its lock and a wait on the
    previous call's stream."""
    task = _cuda_task(cuda_device)
    sess = task.compile(FlowConfig("fused_kernel", prune_k=8))
    versions = [task.params, {n: t * 0.5 for n, t in task.params.items()}]
    fulls = [sess(p).cpu() for p in versions]
    n = sess.out_shape[0]
    errors = []

    def worker(k):
        try:
            rng = np.random.default_rng(k)
            stream = torch.cuda.Stream(cuda_device) if k else torch.cuda.current_stream(cuda_device)
            with torch.cuda.stream(stream):
                for _ in range(200):
                    idx = rng.integers(0, n, size=8)
                    rows = sess.query(versions[k], idx).cpu()
                    if not torch.equal(rows, fulls[k][idx]):
                        errors.append((k, idx))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errors, errors[:3]
    assert sess.forwards == len(versions) + 2 * 200


@pytest.mark.cuda
def test_cuda_threaded_frontend_over_captured_session(cuda_device):
    """The threaded front-end over a captured ``fused_kernel`` session:
    every row bit for bit the full forward's, no launch or NA dispatch
    counter moving while it serves (replays only), one query call a block,
    and both loop threads dead after ``close``."""
    task = _cuda_task(cuda_device)
    sess = task.compile(FlowConfig("fused_kernel", prune_k=8))
    full = sess(task.params).cpu().numpy()
    wl = make_workload(64, task.batch.num_targets, rate=2000.0, size_range=(1, 4), seed=0)
    before = _dispatch_counts()
    with ServeFrontend(
        sess, task.params, policy=BatchPolicy((1, 4, 8, 16), flush_timeout=2e-3),
        clock=SystemClock(), executor=ThreadExecutor(),
    ) as fe:
        futs = run_workload(fe, wl)
        for w, f in zip(wl, futs):
            np.testing.assert_array_equal(f.result(30), full[w.targets])
    for t in fe.executor.threads:
        t.join(5.0)
        assert not t.is_alive()
    after = _dispatch_counts()
    assert after[1] == before[1]
    assert {k: v for k, v in after[0].items() if k != "query_calls"} == {
        k: v for k, v in before[0].items() if k != "query_calls"}
    assert after[0]["query_calls"] - before[0]["query_calls"] == fe.stats.blocks < len(wl)


@pytest.mark.cuda
def test_cuda_streaming_plane_checks_out_from_pinned_memory(cuda_device):
    """Stream mode keeps one pinned host copy per tensor and checks out
    fresh device tensors equal to the published ones; two tenants through
    one ``donate_params`` session give their own full forwards' rows."""
    task = _cuda_task(cuda_device)
    primary = task.compile(FlowConfig("fused_kernel", prune_k=8))
    sess = task.compile(FlowConfig("fused_kernel", prune_k=8), donate_params=True)
    assert sess.captured and sess._graph is primary._graph and sess._serial is primary._serial
    other = {n: t * 0.5 for n, t in task.params.items()}
    plane = WeightPlane(task.params, stream=True)
    assert plane.device.type == "cuda"
    plane.publish("init", task.params)
    plane.publish("other", other)
    for snap in plane._versions["init"].values():
        assert snap.device.type == "cpu" and snap.is_pinned()
    a, b = plane.checkout("init"), plane.checkout("init")
    for name, t in task.params.items():
        assert a[name].is_cuda and torch.equal(a[name], t)
        assert a[name].data_ptr() not in (b[name].data_ptr(), t.data_ptr())
    fulls = {"init": sess(task.params).cpu().numpy(), "other": sess(other).cpu().numpy()}
    fe, _, _ = _inline(session=sess, params=plane, policy=BatchPolicy((1, 4, 8, 16), 2e-3))
    wl = make_workload(32, task.batch.num_targets, tenants=("init", "other"), seed=9)
    for w, f in zip(wl, run_workload(fe, wl)):
        np.testing.assert_array_equal(f.result(0), fulls[w.tenant][w.targets])
    assert sess.forwards == len(fulls) + fe.stats.blocks and primary.forwards == 0


@pytest.mark.cuda
def test_cuda_bad_ids_then_a_good_block(cuda_device):
    """Out-of-range ids raise at ``submit`` before any launch; the same
    captured session then serves a block bit for bit (the CUDA context
    is intact)."""
    task = _cuda_task(cuda_device)
    sess = task.compile(FlowConfig("fused_kernel", prune_k=8))
    full = sess(task.params).cpu().numpy()
    n = sess.out_shape[0]
    fe, _, _ = _inline(session=sess, params=task.params)
    before = _dispatch_counts()
    for bad in ([-1], [n]):
        with pytest.raises(IndexError):
            fe.submit(bad)
    assert _dispatch_counts() == before
    f = fe.submit([n - 1, 0, 3])
    fe.flush()
    np.testing.assert_array_equal(f.result(0), full[[n - 1, 0, 3]])
