"""The port's ego-subgraph serving (``repro_torch.core.ego``,
``InferenceSession.query_ego``) against the reference's (``repro.core.ego``)
and against its own contracts (``tests/test_ego.py``, the closure cache of
``tests/test_stream.py::TestClosureCache``), on the CPU.

At the reference's test sizes (``scale=0.04``, ``max_degree=32``; HAN on
ACM, RGAT on IMDB, Simple-HGN on DBLP), with the reference's weights
converted (``repro_torch.convert``):

  * ``slice_rows`` and ``row_lookup`` equal the reference's array for
    array, on bucketed and flat graphs, and raise where it raises;
  * ``EgoPlanner`` equals the reference's: tuned capacity ladders,
    closures, and every array ``extract`` builds (features, tables,
    ``out_rows``), the signature's fields and ``EgoStats``;
  * ``query_ego`` is within 1e-5 of the port's full forward and of the
    reference's ``query_ego`` under ``staged``, ``fused`` and
    ``fused_kernel`` (the plain versions of the kernels here; the
    reference's kernel in interpret mode);
  * every case of ``tests/test_ego.py``: dispatch accounting, one program
    per signature, the isolated target, the overflow fallback (bit for bit
    ``session.query``), all-bypass blocks, ``num_layers``, the ragged
    front-end block, no densified layout, memory-mapped features;
  * the closure LRU, ``invalidate``, ``carry_from`` and the
    ``adopt_ego_cache`` guard, as the reference's stream tests check them;
  * ids outside ``[0, num_targets)`` raise ``IndexError`` before any
    extraction, where the reference serves the last target for -1 and
    fails inside ``extract`` for ``num_targets`` (recorded).

The ``cuda``-marked tests skip without a card. On one, an ego signature is a
captured CUDA graph: a replay equals the eager ego forward on the card bit
for bit and ticks no counter, and an adopted graph serves the adopting
session's params.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import flows, pipeline  # noqa: E402
from repro_torch.core.ego import EgoPlanner  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402
from repro_torch.core.hetgraph import BucketedSemanticGraph, slice_rows  # noqa: E402
from repro_torch.core.session import InferenceSession  # noqa: E402
from repro_torch.data import datasets, sgb_cache  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ops as fpa_ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BatchPolicy,
    FakeClock,
    InlineExecutor,
    ServeFrontend,
    make_workload,
    run_workload,
)

TASKS = [("han", "acm"), ("rgat", "imdb"), ("simple_hgn", "dblp")]
FLOWS = [("staged", None), ("fused", 8), ("fused_kernel", 8)]
SCALE, MAX_DEGREE = 0.04, 32  # the reference's ego tests
TOL = 1e-5
PLANNER = dict(seed=0, sample=16, sample_sizes=(1, 4))
QUERY_SIZES = (1, 1, 3, 3, 5)


def _reset():
    for k in flows.DISPATCH:
        flows.DISPATCH[k] = 0


def _queries(n, seed=0, sizes=QUERY_SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, size=s) for s in sizes]


@pytest.fixture(scope="module")
def tasks():
    return {
        (m, d): pipeline.prepare(m, d, scale=SCALE, max_degree=MAX_DEGREE, seed=0, device="cpu")
        for m, d in TASKS
    }


@pytest.fixture(scope="module")
def ref_tasks():
    pytest.importorskip("jax")
    from repro.core import pipeline as jpipe

    return {
        (m, d): jpipe.prepare(m, d, scale=SCALE, max_degree=MAX_DEGREE, seed=0)
        for m, d in TASKS
    }


@pytest.fixture(scope="module")
def ref_params(tasks, ref_tasks):
    """The reference's weights, converted, per task."""
    import jax

    return {
        key: params_from_reference(
            jax.tree_util.tree_map(np.asarray, ref_tasks[key].params), device="cpu",
            model=tasks[key].model,
        )
        for key in TASKS
    }


@pytest.fixture(scope="module")
def ref_ego_rows(ref_tasks):
    """The reference's ``query_ego`` rows on ``_queries`` per (task, flow):
    one session each, built once for the module."""
    from repro.core.flows import FlowConfig as JFlowConfig

    out = {}
    for key in TASKS:
        jt = ref_tasks[key]
        for flow in FLOWS:
            sess = jt.compile(JFlowConfig(*flow))
            sess.enable_ego(**PLANNER)
            out[key, flow] = [
                np.asarray(sess.query_ego(jt.params, idx)) for idx in _queries(jt.batch.num_targets)
            ]
    return out


def _ego_sess(task, flow=None):
    sess = task.compile(flow or FlowConfig("fused", prune_k=8))
    sess.enable_ego(**PLANNER)
    return sess, sess(task.params).numpy()


def _sig_fields(sig):
    """An ``EgoSignature`` of either package as plain tuples."""
    return (sig.node_types, sig.caps, sig.label_type, sig.out_capacity,
            tuple(dataclasses.astuple(s) for s in sig.sgs), sig.global_keys,
            sig.total_nodes, sig.max_d_cap)


# ---------------------------------------------------------------------------
# host artifacts, bit for bit the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,dataset", TASKS)
def test_row_lookup_equals_reference(tasks, ref_tasks, model, dataset):
    for sg, jsg in zip(tasks[(model, dataset)].sgs, ref_tasks[(model, dataset)].sgs):
        assert isinstance(sg, BucketedSemanticGraph)
        got, want = sg.row_lookup(), jsg.row_lookup()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert sg.row_lookup() is got  # cached
        assert sg._flat is None


@pytest.mark.parametrize("layout", ["bucketed", "flat"])
def test_slice_rows_equals_reference(layout, tasks, ref_tasks):
    """``slice_rows`` on every semantic graph of the three tasks (the
    bucketed default and the flat build): rows with repeats, the default
    width and a wider one, the bytes read; the same errors."""
    from repro.core import hetgraph as jhet
    from repro.core import pipeline as jpipe

    if layout == "flat":
        pairs = []
        for m, d in TASKS:
            t = pipeline.prepare(m, d, scale=SCALE, max_degree=MAX_DEGREE, seed=0, bucket_sizes=None, device="cpu")
            jt = jpipe.prepare(m, d, scale=SCALE, max_degree=MAX_DEGREE, seed=0, bucket_sizes=None)
            pairs += list(zip(t.sgs, jt.sgs))
    else:
        pairs = [p for key in TASKS for p in zip(tasks[key].sgs, ref_tasks[key].sgs)]
    rng = np.random.default_rng(3)
    for sg, jsg in pairs:
        rows = rng.integers(0, sg.num_targets, size=17)
        for width in (None, sg.max_degree + 5):
            got = slice_rows(sg, rows, width=width)
            want = jhet.slice_rows(jsg, rows, width=width)
            for a, b in zip(got[:3], want[:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert got[3] == want[3] > 0
        if sg.max_degree > 1:  # too narrow for the flat table, or for a bucket of the rows
            narrow = sg.max_degree - 1
            with pytest.raises(ValueError, match="width"):
                slice_rows(sg, np.arange(sg.num_targets), width=narrow)
            with pytest.raises(ValueError, match="width"):
                jhet.slice_rows(jsg, np.arange(sg.num_targets), width=narrow)
        if layout == "bucketed":
            assert sg._flat is None


@pytest.mark.parametrize("model,dataset", TASKS)
def test_extract_equals_reference(tasks, ref_tasks, model, dataset):
    """Planner for planner: the tuned ladders, and on 12 queries (sizes 1-6,
    repeats included) the closures, every extracted array, the signature and
    the stats; a query past the top capacity is ``None`` in both."""
    from repro.core.ego import EgoPlanner as JEgoPlanner

    task, jt = tasks[(model, dataset)], ref_tasks[(model, dataset)]
    depth = task.model.num_layers
    assert depth == jt.model.num_layers
    p = EgoPlanner(task.batch, depth=depth, **PLANNER)
    jp = JEgoPlanner(jt.batch, depth=depth, **PLANNER)
    assert p.capacities == jp.capacities
    for idx in _queries(task.batch.num_targets, seed=7, sizes=(1, 2, 3, 4, 5, 6) * 2):
        for a, b in zip(p._closure(idx), jp._closure(idx)):
            assert sorted(a) == sorted(b)
            for t in a:
                np.testing.assert_array_equal(a[t], b[t])
        eb, jeb = p.extract(idx), jp.extract(idx)
        assert (eb is None) == (jeb is None)
        if eb is None:
            continue
        assert _sig_fields(eb.sig) == _sig_fields(jeb.sig)
        for t in task.batch.node_types:
            assert eb.features[t].dtype == jeb.features[t].dtype
            np.testing.assert_array_equal(eb.features[t], jeb.features[t])
        for tab, jtab in zip(eb.tables, jeb.tables):
            for a, b in zip(tab, jtab):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert eb.out_rows.dtype == jeb.out_rows.dtype
        np.testing.assert_array_equal(eb.out_rows, jeb.out_rows)
    assert p.stats.summary() == jp.stats.summary()
    small = {t: (1,) for t in task.batch.node_types}
    p1 = EgoPlanner(task.batch, depth=depth, capacities=small)
    jp1 = JEgoPlanner(jt.batch, depth=depth, capacities=small)
    assert p1.extract([0, 1, 2]) is None and jp1.extract([0, 1, 2]) is None
    assert p1.stats.summary() == jp1.stats.summary()


@pytest.mark.parametrize("flow", FLOWS, ids=[f for f, _ in FLOWS])
@pytest.mark.parametrize("model,dataset", TASKS)
def test_query_ego_matches_reference(tasks, ref_params, ref_ego_rows, model, dataset, flow):
    """On the reference's weights: the port's ``query_ego`` rows are within
    1e-5 of its own full forward and of the reference's ``query_ego``."""
    task = tasks[(model, dataset)]
    params = ref_params[(model, dataset)]
    sess = task.compile(FlowConfig(*flow), params=params)
    sess.enable_ego(**PLANNER)
    full = sess(params).numpy()
    for idx, want in zip(_queries(task.batch.num_targets), ref_ego_rows[(model, dataset), flow]):
        got = sess.query_ego(params, idx).numpy()
        np.testing.assert_allclose(got, full[idx], rtol=0, atol=TOL)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_han_ego_globals_equals_reference(tasks, ref_tasks, ref_params):
    """HAN's injected β: the full graph's semantic attention, within 1e-6 of
    the reference's; RGAT and Simple-HGN inject nothing."""
    key = ("han", "acm")
    got = tasks[key].model.ego_globals(ref_params[key], tasks[key].batch, FlowConfig("fused", prune_k=8))
    from repro.core.flows import FlowConfig as JFlowConfig

    jt = ref_tasks[key]
    want = jt.model.ego_globals(jt.params, jt.batch, JFlowConfig("fused", prune_k=8))
    assert sorted(got) == ["sem_beta"]
    np.testing.assert_allclose(got["sem_beta"].numpy(), np.asarray(want["sem_beta"]), rtol=0, atol=1e-6)
    for key in TASKS[1:]:
        assert tasks[key].model.ego_globals(tasks[key].params, tasks[key].batch) is None


# ---------------------------------------------------------------------------
# the reference's ego contracts (tests/test_ego.py), case for case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,dataset", TASKS)
def test_query_ego_matches_full_forward(tasks, model, dataset):
    """Ego queries of 1, 3 and 5 targets match the full forward within
    1e-5 (HAN through the injected β), and every query is one ego call or
    one counted fallback. In steady state no program is built, and only a
    fallback (the eager full forward on the CPU) enters bucketed NA
    dispatch: ego graphs are flat views."""
    task = tasks[(model, dataset)]
    sess, full = _ego_sess(task)
    before = dict(flows.DISPATCH)
    sess(task.params)
    per_forward = flows.DISPATCH["graph_calls"] - before["graph_calls"]
    queries = _queries(task.batch.num_targets)
    for idx in queries:  # warm: the programs and HAN's ego globals
        sess.query_ego(task.params, idx)
    _reset()
    for idx in queries:
        out = sess.query_ego(task.params, idx).numpy()
        np.testing.assert_allclose(out, full[idx], rtol=0, atol=TOL)
    d = flows.DISPATCH
    assert d["ego_calls"] + d["ego_fallback"] == len(queries)
    assert d["ego_traces"] == 0
    assert d["query_calls"] == d["ego_fallback"]
    assert d["graph_calls"] == per_forward * d["ego_fallback"]


def test_repeated_signature_shares_one_executable(tasks):
    """A repeated query reuses its signature's program: no new one is
    built, and the rows are equal."""
    task = tasks[("rgat", "imdb")]
    sess, _ = _ego_sess(task)
    idx = np.array([3], dtype=np.int32)
    a = sess.query_ego(task.params, idx).numpy()
    traces, exes = flows.DISPATCH["ego_traces"], len(sess._ego_exes)
    b = sess.query_ego(task.params, idx).numpy()
    assert flows.DISPATCH["ego_traces"] == traces
    assert len(sess._ego_exes) == exes
    np.testing.assert_array_equal(a, b)


def _isolate_vertex(g, v=0):
    """Drop every edge incident to label-type vertex ``v``."""
    edges = {}
    for (src_t, rel, dst_t) in g.relations:
        src, dst = g.edges[rel]
        keep = np.ones(src.shape[0], dtype=bool)
        if src_t == g.label_type:
            keep &= src != v
        if dst_t == g.label_type:
            keep &= dst != v
        edges[rel] = (src[keep], dst[keep])
    return dataclasses.replace(g, edges=edges)


def test_isolated_zero_in_degree_target():
    """A target with no incident edge: its closure is itself, every row
    masked, and its logits still match the full forward."""
    g, _, _ = datasets.resolve("imdb", scale=0.05, seed=0)
    task = pipeline.prepare("rgat", _isolate_vertex(g, v=0), max_degree=32, seed=0, device="cpu")
    sess, full = _ego_sess(task)
    for idx in ([0], [0, 5], [5, 0, 9]):
        out = sess.query_ego(task.params, np.asarray(idx)).numpy()
        assert np.all(np.isfinite(out))
        np.testing.assert_allclose(out, full[idx], rtol=0, atol=TOL)


def test_overflow_falls_back_to_full_forward(tasks):
    """A closure past the top capacity: ``extract`` says so, ``query_ego``
    serves the block through ``session.query`` bit for bit, counted."""
    task = tasks[("rgat", "imdb")]
    sess = InferenceSession(task.model, task.batch, FlowConfig("fused", prune_k=8), params=task.params)
    sess.enable_ego(capacities={t: (1,) for t in task.batch.node_types})
    idx = np.array([2, 7, 11], dtype=np.int32)
    assert sess.ego_planner.extract(idx) is None
    _reset()
    out = sess.query_ego(task.params, idx).numpy()
    d = flows.DISPATCH
    assert d["ego_fallback"] == 1 and d["ego_calls"] == 0 and d["ego_traces"] == 0
    assert d["query_calls"] == 1
    np.testing.assert_array_equal(out, sess.query(task.params, idx).numpy())
    assert sess.ego_planner.stats.fallbacks == 2  # the probe and query_ego's


def test_small_k_blocks_all_bypass(tasks):
    """prune_k at least every ego width: every block takes the §4.3 bypass,
    counted, and still matches the full forward."""
    task = tasks[("simple_hgn", "dblp")]
    sess, full = _ego_sess(task, FlowConfig("fused", prune_k=64))
    _reset()
    rng = np.random.default_rng(1)
    for _ in range(4):
        idx = rng.integers(0, task.batch.num_targets, size=2)
        np.testing.assert_allclose(sess.query_ego(task.params, idx).numpy(), full[idx], rtol=0, atol=TOL)
    d = flows.DISPATCH
    assert d["ego_calls"] > 0 and d["ego_bypass"] == d["ego_calls"]


def test_fused_kernel_bypass_launches_nothing(tasks, monkeypatch):
    """Under ``fused_kernel``, an ego forward whose tables are all at most
    K wide calls no kernel wrapper (the bypass), and a wider one calls the
    flat kernel's once per wide table and layer (its plain version here;
    the launches are counted on the card, in chip_smoke.py)."""
    task = tasks[("rgat", "imdb")]
    sess, full = _ego_sess(task, FlowConfig("fused_kernel", prune_k=8))
    calls = []
    wrapper = fpa_ops.fused_prune_aggregate

    def counted(*args, **kw):
        calls.append(args[3].shape)
        return wrapper(*args, **kw)

    monkeypatch.setattr(fpa_ops, "fused_prune_aggregate", counted)
    rng = np.random.default_rng(4)
    seen = set()
    for _ in range(12):
        idx = rng.integers(0, task.batch.num_targets, size=1)
        eb = sess.ego_planner.extract(idx, ego_globals={})
        if eb is None:
            continue
        wide = [(eb.num_nodes[s.dst_type], s.d_cap) for s in eb.sig.sgs if s.d_cap > 8]
        del calls[:]
        out = sess.query_ego(task.params, idx).numpy()
        assert sorted(tuple(c) for c in calls) == sorted(wide * task.model.num_layers)
        np.testing.assert_allclose(out, full[idx], rtol=0, atol=TOL)
        seen.add(bool(wide))
    assert seen == {True, False}


def test_enable_ego_requires_depth():
    """A model without ``num_layers`` cannot define the closure."""
    task = pipeline.prepare("rgat", "imdb", scale=0.03, max_degree=32, seed=0, device="cpu")
    sess = InferenceSession(task.model, task.batch, FlowConfig("fused", prune_k=8), params=task.params)
    sess.model = object()
    with pytest.raises(ValueError, match="num_layers"):
        sess.enable_ego()
    with pytest.raises(RuntimeError, match="enable_ego"):
        sess.query_ego(task.params, [0])


def test_frontend_ego_routing_ragged_final_block(tasks):
    """``BatchPolicy(ego=True)``: primary blocks through ``query_ego``, the
    ragged final block too, each request within 1e-5, and a full forward
    only for a fallback block."""
    task = tasks[("rgat", "imdb")]
    sess = InferenceSession(task.model, task.batch, FlowConfig("fused", prune_k=8), params=task.params)
    full = sess(task.params).numpy()
    fe = ServeFrontend(sess, task.params, policy=BatchPolicy(capacities=(1, 4, 8), flush_timeout=0.01, ego=True),
                       clock=FakeClock(), executor=InlineExecutor())
    assert sess.ego_planner is not None  # enabled by the front-end
    _reset()
    wl = make_workload(13, task.batch.num_targets, size_range=(1, 3), seed=3)
    futs = run_workload(fe, wl)
    for w, f in zip(wl, futs):
        np.testing.assert_allclose(f.result(0), full[w.targets], rtol=0, atol=TOL)
    d = flows.DISPATCH
    assert fe.stats.completed == len(wl)
    assert d["ego_calls"] + d["ego_fallback"] == fe.stats.blocks
    assert d["query_calls"] == d["ego_fallback"]


def test_extraction_never_densifies_bucketed_layouts(tasks):
    """Extraction slices bucket rows; it never builds a flat view."""
    task = tasks[("rgat", "imdb")]
    sess, full = _ego_sess(task)
    for sg in task.batch.sgs:
        sg._flat = None
    rng = np.random.default_rng(2)
    for _ in range(4):
        idx = rng.integers(0, task.batch.num_targets, size=2)
        np.testing.assert_allclose(sess.query_ego(task.params, idx).numpy(), full[idx], rtol=0, atol=TOL)
    assert all(sg._flat is None for sg in task.batch.sgs)


def test_planner_runs_off_mmap_feature_views(tmp_path):
    """``EgoPlanner(features=open_mmap_arrays(dump/features.npz))``: rows
    come straight off the dump, equal to the in-memory planner's."""
    g, _, _ = datasets.resolve("imdb", scale=0.05, seed=0)
    datasets.save_hetgraph(g, tmp_path / "imdb")
    views = sgb_cache.open_mmap_arrays(tmp_path / "imdb" / "features.npz")
    task = pipeline.prepare("rgat", g, max_degree=32, seed=0, device="cpu")
    for t in task.batch.node_types:
        assert not views[t].flags.writeable
        np.testing.assert_array_equal(views[t], np.asarray(g.features[t]))
    sess = InferenceSession(task.model, task.batch, FlowConfig("fused", prune_k=8), params=task.params)
    sess.enable_ego(features=views, seed=0, sample=8)
    assert all(sess.ego_planner.features[t] is views[t] for t in task.batch.node_types)
    full = sess(task.params).numpy()
    mem = EgoPlanner(task.batch, depth=task.model.num_layers, seed=0, sample=8)
    idx = np.array([1, 4], dtype=np.int32)
    np.testing.assert_allclose(sess.query_ego(task.params, idx).numpy(), full[idx], rtol=0, atol=TOL)
    eb_mm, eb_mem = sess.ego_planner.extract(idx), mem.extract(idx)
    for t in task.batch.node_types:
        np.testing.assert_array_equal(eb_mm.features[t], eb_mem.features[t])


# ---------------------------------------------------------------------------
# ids out of range: the port raises, the reference wraps or fails late
# ---------------------------------------------------------------------------


def test_query_ego_out_of_range_ids_raise_before_extraction(tasks, ref_tasks):
    """The port: -1, ``num_targets`` and a block holding one of them raise
    ``IndexError`` naming the bad ids, before any extraction or dispatch;
    the session then serves a good block. The reference (recorded): -1
    serves the last target's row, [0, -2] those of 0 and n - 2, and
    ``num_targets`` raises numpy's ``IndexError`` from inside ``extract``."""
    from repro.core.flows import FlowConfig as JFlowConfig

    jt = ref_tasks[("rgat", "imdb")]
    jsess = jt.compile(JFlowConfig("fused", prune_k=8))
    jsess.enable_ego(**PLANNER)
    jfull = np.asarray(jsess(jt.params))
    n = jfull.shape[0]
    np.testing.assert_allclose(np.asarray(jsess.query_ego(jt.params, [-1])), jfull[[n - 1]], rtol=0, atol=TOL)
    np.testing.assert_allclose(np.asarray(jsess.query_ego(jt.params, [0, -2])), jfull[[0, n - 2]], rtol=0, atol=TOL)
    with pytest.raises(IndexError) as info:
        jsess.query_ego(jt.params, [n])
    assert any(entry.name == "extract" for entry in info.traceback)

    task = tasks[("rgat", "imdb")]
    sess, full = _ego_sess(task)
    assert n == task.batch.num_targets
    queries = sess.ego_planner.stats.queries
    before = dict(flows.DISPATCH)
    for bad, named in (([-1], "-1"), ([n], str(n)), ([0, -2], "-2"), ([0, n + 3, 1], str(n + 3))):
        with pytest.raises(IndexError, match=named):
            sess.query_ego(task.params, np.asarray(bad))
    with pytest.raises(IndexError):
        sess.query_ego(task.params, torch.tensor([n]))
    assert sess.ego_planner.stats.queries == queries
    assert flows.DISPATCH == before
    np.testing.assert_allclose(sess.query_ego(task.params, [n - 1, 0]).numpy(), full[[n - 1, 0]], rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="1-D"):
        sess.query_ego(task.params, np.zeros((2, 2), np.int32))


# ---------------------------------------------------------------------------
# the closure cache (tests/test_stream.py::TestClosureCache) and adoption
# ---------------------------------------------------------------------------


FUSED4 = FlowConfig("fused", prune_k=4)


@pytest.fixture(scope="module")
def stream_task():
    # the reference's stream-test task: no degree cap
    return pipeline.prepare("rgat", "imdb", scale=0.05, max_degree=None, seed=0, device="cpu")


class TestClosureCache:
    def test_lru_hit_and_eviction(self, stream_task):
        planner = EgoPlanner(stream_task.batch, depth=2, closure_cache=2)
        st = planner.stats
        a = np.array([0, 1], dtype=np.int64)
        planner._cached_closure(a, st)
        planner._cached_closure(a, st)
        assert st.closure_hits == 1
        planner._cached_closure(np.array([2], dtype=np.int64), st)
        planner._cached_closure(np.array([3], dtype=np.int64), st)
        assert len(planner._closures) == 2  # `a` evicted
        planner._cached_closure(a, st)
        assert st.closure_hits == 1  # a miss after eviction

    def test_disabled_cache_never_stores(self, stream_task):
        planner = EgoPlanner(stream_task.batch, depth=2)
        planner._cached_closure(np.array([0], dtype=np.int64), planner.stats)
        assert len(planner._closures) == 0

    def test_invalidate_drops_only_touching_closures(self, stream_task):
        planner = EgoPlanner(stream_task.batch, depth=2, closure_cache=8)
        st = planner.stats
        full_a, _ = planner._cached_closure(np.array([0], dtype=np.int64), st)
        planner._cached_closure(np.array([1], dtype=np.int64), st)
        t = planner.label_type
        dropped = planner.invalidate({t: full_a[t][:1]})
        assert dropped >= 1
        assert len(planner._closures) < 2 or dropped == 2
        assert planner.invalidate({}) == 0

    def test_carry_from_rejects_mismatched_planner(self, stream_task):
        p1 = EgoPlanner(stream_task.batch, depth=2, closure_cache=4)
        p2 = EgoPlanner(stream_task.batch, depth=p1.depth + 1, closure_cache=4)
        with pytest.raises(ValueError, match="portable"):
            p2.carry_from(p1)

    def test_carry_from_skips_dirty(self, stream_task):
        p1 = EgoPlanner(stream_task.batch, depth=2, closure_cache=4)
        st = p1.stats
        full_a, _ = p1._cached_closure(np.array([0], dtype=np.int64), st)
        p1._cached_closure(np.array([1], dtype=np.int64), st)
        p2 = EgoPlanner(stream_task.batch, depth=2, closure_cache=4)
        t = p1.label_type
        carried = p2.carry_from(p1, {t: full_a[t][:1]})
        assert carried >= 1
        assert len(p2._closures) < len(p1._closures) or carried == 2

    def test_adopt_ego_cache_guard(self, stream_task):
        s1 = stream_task.compile(FUSED4)
        other = pipeline.prepare("rgat", "imdb", scale=0.05, max_degree=None, seed=0, device="cpu")
        s2 = other.compile(FUSED4)
        with pytest.raises(ValueError, match="portable"):
            s1.adopt_ego_cache(s2)
        with pytest.raises(ValueError, match="portable"):
            s1.adopt_ego_cache(stream_task.compile(FlowConfig("fused", prune_k=8)))


def test_closure_cache_and_invalidate_equal_reference(stream_task):
    """The same cache traffic through both planners: equal closures, hits,
    drops and carries."""
    pytest.importorskip("jax")
    from repro.core import pipeline as jpipe
    from repro.core.ego import EgoPlanner as JEgoPlanner

    jt = jpipe.prepare("rgat", "imdb", scale=0.05, max_degree=None, seed=0)
    p = EgoPlanner(stream_task.batch, depth=2, closure_cache=3, sample=8)
    jp = JEgoPlanner(jt.batch, depth=2, closure_cache=3, sample=8)
    for idx in ([0, 1], [2], [1, 0], [3], [4], [2]):
        a, b = p._cached_closure(np.asarray(idx), p.stats), jp._cached_closure(np.asarray(idx), jp.stats)
        for t in a[0]:
            np.testing.assert_array_equal(a[0][t], b[0][t])
            np.testing.assert_array_equal(a[1][t], b[1][t])
    assert list(p._closures) == list(jp._closures)
    t = p.label_type
    dirty = {t: np.array([2, 4])}
    q = EgoPlanner(stream_task.batch, depth=2, closure_cache=3, sample=8)
    jq = JEgoPlanner(jt.batch, depth=2, closure_cache=3, sample=8)
    assert q.carry_from(p, dirty) == jq.carry_from(jp, dirty)
    assert list(q._closures) == list(jq._closures)
    assert p.invalidate(dirty) == jp.invalidate(dirty)
    assert list(p._closures) == list(jp._closures)
    assert p.stats.summary() == jp.stats.summary()


def test_adopted_programs_serve_without_rebuilding(stream_task):
    """A second session over the same model and flow adopts the first's
    ego programs: nothing is rebuilt, entries present are kept, and its
    rows are its own params' (here on the CPU, eager programs)."""
    s1 = stream_task.compile(FUSED4).enable_ego(seed=0, sample=8)
    n = stream_task.batch.num_targets
    queries = _queries(n, seed=5, sizes=(1, 2, 3))
    for idx in queries:
        s1.query_ego(stream_task.params, idx)
    other = {k: v * 0.5 for k, v in stream_task.params.items()}
    s2 = InferenceSession(stream_task.model, stream_task.batch, FUSED4, params=other).enable_ego(seed=0, sample=8)
    adopted = s2.adopt_ego_cache(s1)
    assert adopted == len(s1._ego_exes) > 0
    assert s2.adopt_ego_cache(s1) == 0
    full = s2(other).numpy()
    traces = flows.DISPATCH["ego_traces"]
    for idx in queries:
        np.testing.assert_allclose(s2.query_ego(other, idx).numpy(), full[idx], rtol=0, atol=TOL)
    assert flows.DISPATCH["ego_traces"] == traces


def _han_beta_session():
    """HAN ACM under ``staged`` on a params mapping of its own, its ego
    rows 0 off the full rows for target 5 before any update."""
    task = pipeline.prepare("han", "acm", scale=SCALE, max_degree=MAX_DEGREE, seed=0, device="cpu")
    params = {n: t.detach().clone() for n, t in task.params.items()}
    sess = InferenceSession(task.model, task.batch, FlowConfig("staged"), params=params).enable_ego(**PLANNER)
    idx = np.array([5])
    assert np.abs(sess.query_ego(params, idx).numpy() - sess(params).numpy()[idx]).max() <= TOL
    return sess, params, idx


def _beta_keys(params):
    return [n for n in params if n.startswith(("attn.", "sem."))]


def test_ego_beta_follows_in_place_updates():
    """An in-place update of the tensors of the same params mapping (as an
    optimizer makes) moves HAN's β: the ego rows follow the full rows
    within 1e-5. Keyed on the params object alone, the cached β stayed the
    old one (0.053 off the full rows here, the full rows moving 0.131)."""
    sess, params, idx = _han_beta_session()
    before = sess(params).numpy()[idx]
    with torch.no_grad():
        for n in _beta_keys(params):
            params[n].mul_(3).add_(0.1)
    full = sess(params).numpy()[idx]
    assert np.abs(full - before).max() > 0.05
    np.testing.assert_allclose(sess.query_ego(params, idx).numpy(), full, rtol=0, atol=TOL)


def test_ego_beta_follows_reassigned_keys():
    """Keys of the same mapping reassigned to new tensors: the ego rows
    follow the full rows within 1e-5; a mapping with the same values after
    that reuses the cached β."""
    sess, params, idx = _han_beta_session()
    for n in list(params):
        params[n] = params[n] * 3 + 0.1
    full = sess(params).numpy()[idx]
    np.testing.assert_allclose(sess.query_ego(params, idx).numpy(), full, rtol=0, atol=TOL)
    cached = sess._ego_globals_cache
    sess.query_ego(params, idx)
    assert sess._ego_globals_cache is cached


def test_reference_ego_beta_stale_after_reassigned_keys():
    """Recorded: the reference caches β by the identity of the params tree,
    so reassigning every key of the same tree serves the old β: its ego
    rows end up 5.94 off its full rows (a fault of the reference, which
    stays as it is; the port is held to 1e-5 above)."""
    jax = pytest.importorskip("jax")

    from repro.core import pipeline as jpipe
    from repro.core.flows import FlowConfig as JFlowConfig

    jt = jpipe.prepare("han", "acm", scale=SCALE, max_degree=MAX_DEGREE, seed=0)
    sess = jt.compile(JFlowConfig("staged"))
    sess.enable_ego(**PLANNER)
    params = jt.params
    idx = np.array([5])
    assert np.abs(np.asarray(sess.query_ego(params, idx)) - np.asarray(sess(params))[idx]).max() <= TOL
    for key in list(params):  # every key of the same tree, reassigned
        params[key] = jax.tree_util.tree_map(lambda x: x * 3 + 0.1, params[key])
    err = np.abs(np.asarray(sess.query_ego(params, idx)) - np.asarray(sess(params))[idx]).max()
    assert err > 5.0, err  # 5.94 on this jax and numpy


# ---------------------------------------------------------------------------
# on a card: one captured CUDA graph per ego signature
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _counters():
    return dict(flows.DISPATCH), dict(fpa_ops.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("model,dataset", TASKS)
def test_cuda_replay_equals_eager_ego_forward(cuda_device, model, dataset):
    """Each signature is captured at its first query; every query's rows
    equal, bit for bit, the eager ego forward on the card on the same ego
    batch, and are within 1e-5 of the captured full forward; a second pass
    builds nothing and ticks no launch or NA dispatch counter."""
    task = pipeline.prepare(model, dataset, scale=SCALE, max_degree=MAX_DEGREE, seed=0, device=cuda_device)
    flow = FlowConfig("fused_kernel", prune_k=8)
    sess = task.compile(flow).enable_ego(**PLANNER)
    full = sess(task.params).cpu().numpy()
    gl = sess._ego_globals_for(task.params)
    queries = _queries(task.batch.num_targets)
    for idx in queries:
        sess.query_ego(task.params, idx)
    before = _counters()
    rows = [sess.query_ego(task.params, idx).cpu() for idx in queries]
    after = _counters()
    assert after[1] == before[1]
    moved = {k: after[0][k] - before[0][k] for k in after[0] if after[0][k] != before[0][k]}
    assert set(moved) <= {"ego_calls", "ego_bypass", "ego_fallback", "query_calls"}
    for idx, r in zip(queries, rows):
        np.testing.assert_allclose(r.numpy(), full[idx], rtol=0, atol=TOL)
        eb = sess.ego_planner.extract(idx, ego_globals=gl)
        if eb is None:
            continue
        with torch.inference_mode():
            b = eb.to(cuda_device)
            eager = task.model.apply(task.params, b, flow).index_select(0, b.out_rows).cpu()
        assert torch.equal(r, eager)


@pytest.mark.cuda
def test_cuda_adopted_graph_serves_adopters_params(cuda_device):
    """An adopted captured ego graph serves the adopting session's params,
    never the donor's, and the donor still serves its own."""
    task = pipeline.prepare("rgat", "imdb", scale=SCALE, max_degree=MAX_DEGREE, seed=0, device=cuda_device)
    flow = FlowConfig("fused_kernel", prune_k=8)
    s1 = task.compile(flow).enable_ego(**PLANNER)
    other = {k: v * 0.5 for k, v in task.params.items()}
    s2 = InferenceSession(task.model, task.batch, flow, params=other).enable_ego(**PLANNER)
    queries = _queries(task.batch.num_targets, sizes=(1, 3))
    for idx in queries:
        s1.query_ego(task.params, idx)
    assert s2.adopt_ego_cache(s1) == len(s1._ego_exes) > 0
    traces = flows.DISPATCH["ego_traces"]
    full1, full2 = s1(task.params).cpu().numpy(), s2(other).cpu().numpy()
    for idx in queries:
        np.testing.assert_allclose(s2.query_ego(other, idx).cpu().numpy(), full2[idx], rtol=0, atol=TOL)
        np.testing.assert_allclose(s1.query_ego(task.params, idx).cpu().numpy(), full1[idx], rtol=0, atol=TOL)
    assert flows.DISPATCH["ego_traces"] == traces


@pytest.mark.cuda
def test_cuda_bad_ids_then_a_good_ego_block(cuda_device):
    """Out-of-range ids raise before any launch on a captured session; a
    good block is then served."""
    task = pipeline.prepare("rgat", "imdb", scale=SCALE, max_degree=MAX_DEGREE, seed=0, device=cuda_device)
    sess = task.compile(FlowConfig("fused_kernel", prune_k=8)).enable_ego(**PLANNER)
    full = sess(task.params).cpu().numpy()
    n = task.batch.num_targets
    before = _counters()
    for bad in ([-1], [n]):
        with pytest.raises(IndexError):
            sess.query_ego(task.params, bad)
    assert _counters() == before
    np.testing.assert_allclose(sess.query_ego(task.params, [n - 1, 0, 3]).cpu().numpy(), full[[n - 1, 0, 3]],
                               rtol=0, atol=TOL)
