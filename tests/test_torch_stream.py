"""The port's streamed graph deltas (``repro_torch.stream``) against the
reference's (``repro.stream``) and against its own contracts
(``tests/test_stream.py``), on the CPU.

At the reference test's size (RGAT on IMDB, ``scale=0.05``,
``max_degree=None``; Simple-HGN and HAN on IMDB for the union and metapath
kinds, ``max_degree=4`` for the full-rebuild tier), the same ``prepare``
in both packages, the reference's weights converted
(``repro_torch.convert``) and the same delta arrays from a numpy seed go
through both ingestors. After every ingest:

  * ``validate_delta`` rejects the same batches with the same messages;
    ``DeltaLog`` sequences, ``structure_hash``, ``MergeStats`` and the
    ``dirty`` sets equal the reference's;
  * every bucket table, grouped tile stack, ``perm`` and ``row_lookup`` of
    the merged stack is the reference's bit for bit;
  * the successor's logits are within 1e-5 of the reference's session on
    that version, and bit for bit the port's own cold ``prepare`` of the
    version's graph;

in the absorb, spill, metapath-rebuild and full-rebuild tiers and for the
union kind's mid-row insertion. Every case of ``tests/test_stream.py`` is
here (the validation, hash, log, merge, plane, front-end, ego-continuity
and closure-cache cases), plus HAN's ego β after a delta, the builders'
``rng=`` / ``only=`` hooks and ``GraphBatch.from_graph(features=)``.

The ``cuda``-marked tests skip without a card. On one, a successor session
is a new CUDA graph: its replay is bit for bit a cold capture of the
version's graph, clean slices keep their predecessor's device tables and
dirty ones have their own, and zeroing the predecessor's dirty tables does
not change the successor's replay.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import flows, hetgraph, pipeline  # noqa: E402
from repro_torch.core.batch import GraphBatch  # noqa: E402
from repro_torch.core.ego import EgoPlanner  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402
from repro_torch.core.session import InferenceSession, sg_tensors  # noqa: E402
from repro_torch.data import datasets, sgb_cache  # noqa: E402
from repro_torch.serve import BatchPolicy, FakeClock, GraphPlane, InlineExecutor, ServeFrontend  # noqa: E402
from repro_torch.stream import DeltaLog, StreamIngestor, apply_to_graph, replay  # noqa: E402
from repro_torch.stream.merge import _CountingRng  # noqa: E402

SCALE = 0.05  # the reference's stream tests
FUSED = ("fused", 4)
KERNEL = ("fused_kernel", 4)
TOL = 1e-5
GROUPED_FIELDS = ("nbr", "msk", "ety", "step_row", "step_dt", "step_ndt", "step_bucket", "caps",
                  "caps_pad", "row_targets", "perm")


def _edges(rng, g, rel_names=None, n=6):
    out = {}
    for s_t, name, d_t in g.relations:
        if rel_names is not None and name not in rel_names:
            continue
        out[name] = (rng.integers(0, g.num_nodes[s_t], n), rng.integers(0, g.num_nodes[d_t], n))
    return out


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _stack_arrays(sgs, keys=None):
    """Every host array of a bucketed stack: the bucket tables, ``perm``,
    ``row_lookup`` and the grouped tile stacks of ``keys`` (default: the
    layouts the stack carries), by name."""
    out = {}
    for sg in sgs:
        for i, b in enumerate(sg.buckets):
            for f in ("targets", "nbr_idx", "nbr_mask", "edge_type"):
                out[sg.name, "bucket", i, f] = getattr(b, f)
        out[sg.name, "perm"] = sg.target_perm()
        out[sg.name, "bucket_of"], out[sg.name, "row_of"] = sg.row_lookup()
        for key in (sg._grouped if keys is None else keys):
            lay = sg.grouped(*key)
            for f in GROUPED_FIELDS:
                out[sg.name, key, f] = getattr(lay, f)
    return out


def _assert_same_stack(got_sgs, ref_sgs):
    """The port's merged stack equals the reference's array for array, on
    every grouped layout the port carries."""
    keys = sorted({k for sg in got_sgs for k in sg._grouped})
    got, ref = _stack_arrays(got_sgs, keys), _stack_arrays(ref_sgs, keys)
    assert list(got) == list(ref)
    for k in got:
        assert _same_bits(got[k], ref[k]), k


class Pair:
    """One task in both packages: the port's (CPU), the reference's, and
    the reference's weights converted for the port."""

    def __init__(self, model, max_degree=None):
        import jax

        from repro.core import pipeline as jpipe

        self.model, self.max_degree = model, max_degree
        self.task = pipeline.prepare(model, "imdb", scale=SCALE, max_degree=max_degree, seed=0, device="cpu")
        self.jtask = jpipe.prepare(model, "imdb", scale=SCALE, max_degree=max_degree, seed=0)
        self.params = params_from_reference(
            jax.tree_util.tree_map(np.asarray, self.jtask.params), device="cpu", model=self.task.model
        )

    def session(self, flow=FUSED):
        return InferenceSession(self.task.model, self.task.batch, FlowConfig(*flow), params=self.task.params)

    def jsession(self, flow=FUSED):
        from repro.core.flows import FlowConfig as JFlowConfig
        from repro.core.session import InferenceSession as JSession

        return JSession(self.jtask.model, self.jtask.batch, JFlowConfig(*flow), params=self.jtask.params)

    def ingestors(self, flow=FUSED, ego=None, **kw):
        """A port and a reference ingestor over fresh sessions, the port's
        run once; ``ego`` (a planner kwargs dict) enables ego on both."""
        from repro.stream import StreamIngestor as JStreamIngestor

        s, js = self.session(flow), self.jsession(flow)
        s(self.params)  # builds the lazy layouts, as a capture's warm-up does on a card
        if ego is not None:
            s.enable_ego(**ego)
            js.enable_ego(**ego)
        return StreamIngestor(self.task, s, **kw), JStreamIngestor(self.jtask, js, **kw)

    def cold_logits(self, graph, flow=FUSED):
        cold = pipeline.prepare(self.model, graph, max_degree=self.max_degree, seed=0,
                                metapaths=self.task.metapaths, device="cpu")
        return cold.compile(FlowConfig(*flow))(self.params).numpy()

    def ingest(self, ing, jing, edges, features=None, flow=FUSED):
        """One delta through both ingestors, held to the reference and to
        the port's cold rebuild (module docstring). Returns both reports."""
        rep = ing.ingest(edges, features)
        jrep = jing.ingest(edges, features)
        # the summary minus its times: seq, version, edges, dirty counts, carried, adopted, tiers
        assert {k: v for k, v in rep.summary().items() if not k.startswith("t_")} == {
            k: v for k, v in jrep.summary().items() if not k.startswith("t_")
        }
        assert rep.structure_hash == jrep.structure_hash
        assert dataclasses.asdict(rep.stats) == dataclasses.asdict(jrep.stats)
        assert sorted(rep.dirty) == sorted(jrep.dirty)
        for t in rep.dirty:
            assert _same_bits(rep.dirty[t], jrep.dirty[t]), t
        _assert_same_stack(ing.sgs, jing.sgs)
        got = ing.session(self.params).numpy()
        np.testing.assert_allclose(got, np.asarray(jing.session(self.jtask.params)), rtol=0, atol=TOL)
        assert _same_bits(got, self.cold_logits(ing.graph, flow))
        return rep, jrep


_PAIRS = {}


@pytest.fixture(scope="module")
def pair():
    pytest.importorskip("jax")

    def get(model="rgat", max_degree=None):
        key = (model, max_degree)
        if key not in _PAIRS:
            _PAIRS[key] = Pair(model, max_degree)
        return _PAIRS[key]

    yield get
    _PAIRS.clear()


@pytest.fixture()
def rgat(pair):
    return pair("rgat")


# --------------------------------------------------------------------------
# validate_delta: O(batch) accept/reject, the reference's messages
# --------------------------------------------------------------------------


def _rejects_alike(p, edges):
    """Both packages' ``validate_delta`` raise ``ValueError`` with the same
    message; returns it."""
    with pytest.raises(ValueError) as got:
        p.task.graph.validate_delta(edges)
    with pytest.raises(ValueError) as want:
        p.jtask.graph.validate_delta(edges)
    assert str(got.value) == str(want.value)
    return str(got.value)


class TestValidateDelta:
    def test_accepts_well_formed_batch(self, rgat):
        edges = _edges(np.random.default_rng(0), rgat.task.graph)
        assert rgat.task.graph.validate_delta(edges) is None
        rgat.jtask.graph.validate_delta(edges)

    def test_accepts_empty_arrays(self, rgat):
        _, rel, _ = rgat.task.graph.relations[0]
        empty = {rel: (np.zeros(0, np.int64), np.zeros(0, np.int64))}
        rgat.task.graph.validate_delta(empty)
        rgat.jtask.graph.validate_delta(empty)

    def test_rejects_unknown_relation(self, rgat):
        assert "not in graph relations" in _rejects_alike(rgat, {"NOPE": (np.array([0]), np.array([0]))})

    def test_rejects_length_mismatch(self, rgat):
        _, rel, _ = rgat.task.graph.relations[0]
        assert "length mismatch" in _rejects_alike(rgat, {rel: (np.array([0, 1]), np.array([0]))})

    def test_rejects_out_of_range_ids(self, rgat):
        g = rgat.task.graph
        _, rel, d_t = g.relations[0]
        bad = np.array([g.num_nodes[d_t]], dtype=np.int64)
        assert "out of range" in _rejects_alike(rgat, {rel: (np.array([0], dtype=np.int64), bad)})
        msg = _rejects_alike(rgat, {rel: (np.array([-1], dtype=np.int64), np.array([0], dtype=np.int64))})
        assert "out of range" in msg

    def test_rejects_float_and_2d_ids(self, rgat):
        _, rel, _ = rgat.task.graph.relations[0]
        msg = _rejects_alike(rgat, {rel: (np.array([0.5]), np.array([0], dtype=np.int64))})
        assert "not an integer type" in msg
        assert "must be 1-D" in _rejects_alike(rgat, {rel: (np.array([[0]]), np.array([0], dtype=np.int64))})

    def test_collects_every_violation(self, rgat):
        _, rel, _ = rgat.task.graph.relations[0]
        msg = _rejects_alike(rgat, {
            "NOPE": (np.array([0]), np.array([0])),
            rel: (np.array([0, 1]), np.array([0])),
        })
        assert "NOPE" in msg and "length mismatch" in msg

    def test_rejected_batch_leaves_ingestor_untouched(self, rgat):
        ing, jing = rgat.ingestors()
        for i in (ing, jing):
            v0, seq0, g0 = i.version, i.log.seq, i.graph
            with pytest.raises(ValueError):
                i.ingest({"NOPE": (np.array([0]), np.array([0]))})
            assert (i.version, i.log.seq) == (v0, seq0) == (0, 0)
            assert i.graph is g0


# --------------------------------------------------------------------------
# structure_hash: the reference's fingerprints, fresh on every version
# --------------------------------------------------------------------------


class TestStructureHash:
    def test_stable_on_same_graph(self, rgat):
        from repro.data import sgb_cache as jcache

        h = sgb_cache.structure_hash(rgat.task.graph)
        assert h == sgb_cache.structure_hash(rgat.task.graph) == jcache.structure_hash(rgat.jtask.graph)

    def test_delta_changes_hash_and_cache_key(self, rgat):
        from repro.data import sgb_cache as jcache
        from repro.stream import DeltaLog as JDeltaLog, apply_to_graph as japply

        g, jg = rgat.task.graph, rgat.jtask.graph
        edges = _edges(np.random.default_rng(1), g, n=3)
        g2 = apply_to_graph(g, DeltaLog().append(edges))
        jg2 = japply(jg, JDeltaLog().append(edges))
        assert sgb_cache.structure_hash(g2) != sgb_cache.structure_hash(g)
        assert sgb_cache.structure_hash(g2) == jcache.structure_hash(jg2)
        args = rgat.task.sgb_args
        k1 = sgb_cache.cache_key(g, rgat.task.sgb_kind, **args)
        k2 = sgb_cache.cache_key(g2, rgat.task.sgb_kind, **args)
        assert k1 != k2
        assert k2 == jcache.cache_key(jg2, rgat.jtask.sgb_kind, **rgat.jtask.sgb_args)

    def test_feature_only_delta_keeps_structure_hash(self, rgat):
        g = rgat.task.graph
        t = g.node_types[0]
        row = np.random.default_rng(2).normal(size=(1, g.features[t].shape[1])).astype(g.features[t].dtype)
        g2 = apply_to_graph(g, DeltaLog().append({}, {t: (np.array([0], dtype=np.int64), row)}))
        assert sgb_cache.structure_hash(g2) == sgb_cache.structure_hash(g)
        assert g2.features[t] is not g.features[t] and np.array_equal(g2.features[t][0], row[0])

    def test_every_ingest_reports_fresh_hash(self, rgat):
        ing, jing = rgat.ingestors()
        rng = np.random.default_rng(3)
        seen = {sgb_cache.structure_hash(ing.graph)}
        for _ in range(3):
            rep, _ = rgat.ingest(ing, jing, _edges(rng, ing.graph, n=2))
            assert rep.structure_hash not in seen
            assert rep.structure_hash == sgb_cache.structure_hash(ing.graph)
            seen.add(rep.structure_hash)


# --------------------------------------------------------------------------
# DeltaLog and apply_to_graph
# --------------------------------------------------------------------------


class TestDeltaLog:
    def test_seq_is_monotone_and_since_slices(self, rgat):
        from repro.stream import DeltaLog as JDeltaLog

        rng = np.random.default_rng(4)
        batches = [_edges(rng, rgat.task.graph, n=1), _edges(rng, rgat.task.graph, n=2)]
        log, jlog = DeltaLog(), JDeltaLog()
        d1, d2 = (log.append(b) for b in batches)
        for b in batches:
            jlog.append(b)
        assert (d1.seq, d2.seq) == (1, 2)
        assert log.seq == 2 and len(log) == 2
        assert [d.seq for d in log.since(1)] == [2]
        for d, jd in zip(log, jlog):
            assert d.seq == jd.seq and d.num_edges == jd.num_edges and list(d.edges) == list(jd.edges)
            for name in d.edges:
                assert all(_same_bits(a, b) for a, b in zip(d.edges[name], jd.edges[name]))
                assert d.edges[name][0].dtype == np.int64
            assert sorted(d.dirty_targets()) == sorted(jd.dirty_targets())

    def test_apply_to_graph_is_pure(self, rgat):
        from repro.stream import DeltaLog as JDeltaLog, apply_to_graph as japply

        g = rgat.task.graph
        _, rel, _ = g.relations[0]
        before = g.edges[rel][0].copy()
        edges = _edges(np.random.default_rng(5), g, rel_names=(rel,), n=4)
        g2 = apply_to_graph(g, DeltaLog().append(edges))
        np.testing.assert_array_equal(g.edges[rel][0], before)
        assert len(g2.edges[rel][0]) == len(before) + 4
        for _, name, _ in g.relations:
            if name != rel:
                assert g2.edges[name][0] is g.edges[name][0]
        jg2 = japply(rgat.jtask.graph, JDeltaLog().append(edges))
        for name in g.edges:
            assert all(_same_bits(a, b) for a, b in zip(g2.edges[name], jg2.edges[name])), name

    def test_unknown_relation_raises(self, rgat):
        delta = DeltaLog().append({})
        object.__setattr__(delta, "edges", {"NOPE": (np.array([0]), np.array([0]))})
        with pytest.raises(KeyError):
            apply_to_graph(rgat.task.graph, delta)


# --------------------------------------------------------------------------
# merge tiers: the reference's stacks, bit-parity against the cold rebuild
# --------------------------------------------------------------------------


class TestMergeParity:
    def test_absorb_tier_bit_parity(self, rgat):
        ing, jing = rgat.ingestors()
        rep, _ = rgat.ingest(ing, jing, _edges(np.random.default_rng(0), ing.graph, n=2))
        assert rep.stats.absorbed_slices >= 1
        assert not rep.stats.full_rebuild

    def test_spill_tier_bit_parity(self, rgat):
        ing, jing = rgat.ingestors()
        g = ing.graph
        s_t, rel, _ = g.relations[0]
        sg = next(s for s in ing.sgs if s.name == rel)
        n = int(max(sg.bucket_capacities)) + 8
        edges = {rel: (np.random.default_rng(1).integers(0, g.num_nodes[s_t], n), np.full(n, 0, dtype=np.int64))}
        rep, _ = rgat.ingest(ing, jing, edges)
        assert rep.stats.spilled_slices >= 1
        assert not rep.stats.full_rebuild

    def test_stacked_deltas_stay_exact(self, rgat):
        ing, jing = rgat.ingestors()
        rng = np.random.default_rng(2)
        for i in range(4):
            rels = (ing.graph.relations[i % 2][1],)
            rgat.ingest(ing, jing, _edges(rng, ing.graph, rels, n=3))
        assert ing.version == 4 and ing.log.seq == 4

    def test_clean_slices_are_same_objects(self, rgat):
        ing, jing = rgat.ingestors()
        _, rel, _ = ing.graph.relations[0]
        before = {s.name: s for s in ing.sgs}
        rep, _ = rgat.ingest(ing, jing, _edges(np.random.default_rng(3), ing.graph, rel_names=(rel,), n=2))
        assert rep.stats.clean_slices == len(ing.sgs) - 1
        for s in ing.sgs:
            assert (s is before[s.name]) == (s.name != rel)

    def test_patched_grouped_matches_rebuilt_grouped(self, rgat):
        # the absorb tier patches grouped tile stacks copy-on-write: equal
        # to a from-scratch grouping and to the reference's patched stacks
        ing, jing = rgat.ingestors(flow=KERNEL)
        old = {s.name: s for s in ing.sgs}
        rep, _ = rgat.ingest(ing, jing, _edges(np.random.default_rng(4), ing.graph, n=2), flow=KERNEL)
        assert rep.stats.absorbed_slices >= 1
        cold = pipeline.prepare("rgat", ing.graph, max_degree=None, seed=0, device="cpu")
        for got_sg, ref_sg in zip(ing.sgs, cold.sgs):
            assert got_sg._grouped
            for key, got in got_sg._grouped.items():
                ref = ref_sg.grouped(*key)
                for f in GROUPED_FIELDS:
                    assert _same_bits(getattr(got, f), getattr(ref, f)), f
                was = old[got_sg.name]._grouped[key]
                # a patched layout is a new object with a device cache of its own
                assert (got is was) == (got_sg is old[got_sg.name])
                assert (got._dev is was._dev) == (got is was)

    def test_feature_update_changes_logits_exactly(self, rgat):
        ing, jing = rgat.ingestors()
        g = ing.graph
        t = g.node_types[0]
        row = np.random.default_rng(5).normal(size=(1, g.features[t].shape[1])).astype(g.features[t].dtype)
        before = ing.session(rgat.params).numpy()
        old_feats = ing.session.graph_batch.features
        rgat.ingest(ing, jing, {}, {t: (np.array([0], dtype=np.int64), row)})
        assert not _same_bits(ing.session(rgat.params).numpy(), before)
        new_feats = ing.session.graph_batch.features
        for u in g.node_types:
            # untouched types keep the serving batch's tensors
            assert (new_feats[u] is old_feats[u]) == (u != t)


class TestMergeParityOtherKinds:
    def test_union_mid_row_ety_insertion(self, pair):
        # Simple-HGN's union slices are relation-major within a row: a delta
        # on one relation inserts slots mid-row
        p = pair("simple_hgn")
        ing, jing = p.ingestors()
        first_rel = ing.graph.relations[0][1]
        rep, _ = p.ingest(ing, jing, _edges(np.random.default_rng(6), ing.graph, rel_names=(first_rel,), n=3))
        assert not rep.stats.full_rebuild and rep.stats.absorbed_slices + rep.stats.spilled_slices >= 1

    def test_metapath_chain_rebuild(self, pair):
        # HAN composes metapaths: a delta on a base relation rebuilds every
        # slice whose chain holds it; untouched chains stay clean
        p = pair("han")
        ing, jing = p.ingestors()
        _, rel, _ = ing.graph.relations[0]
        rep, _ = p.ingest(ing, jing, _edges(np.random.default_rng(7), ing.graph, rel_names=(rel,), n=2))
        st = rep.stats
        assert st.rebuilt_slices + st.clean_slices >= 1 or st.full_rebuild

    def test_full_rebuild_fallback_parity(self, pair):
        # a capped degree: the spilled slice's rebuild draws RNG, so the
        # merge falls back to a full rebuild, which keeps parity
        p = pair("rgat", max_degree=4)
        ing, jing = p.ingestors()
        g = ing.graph
        s_t, rel, _ = g.relations[0]
        edges = {rel: (np.random.default_rng(8).integers(0, g.num_nodes[s_t], 64), np.full(64, 0, dtype=np.int64))}
        rep, _ = p.ingest(ing, jing, edges)
        assert rep.stats.full_rebuild and rep.stats.full_rebuild_reason


# --------------------------------------------------------------------------
# GraphPlane: versioned swap semantics
# --------------------------------------------------------------------------


class TestGraphPlane:
    def test_publish_bumps_version_and_checkout_pins(self, rgat):
        from repro.serve import GraphPlane as JGraphPlane

        for plane_cls, make in ((GraphPlane, rgat.session), (JGraphPlane, rgat.jsession)):
            s0 = make()
            plane = plane_cls(s0)
            assert plane.version == 0
            v, sess = plane.checkout()
            assert (v, sess) == (0, s0)
            s1 = make()
            assert plane.publish(s1) == 1
            assert plane.current() is s1 and sess is s0

    def test_out_shape_mismatch_rejected(self, rgat):
        from repro.serve import GraphPlane as JGraphPlane

        class Fake:
            out_shape = (1, 1)

        for plane_cls, make in ((GraphPlane, rgat.session), (JGraphPlane, rgat.jsession)):
            s0 = make()
            plane = plane_cls(s0)
            with pytest.raises(ValueError, match="additive-only"):
                plane.publish(Fake())
            assert plane.version == 0 and plane.current() is s0

    def test_frontend_swap_strands_nothing(self, rgat):
        from repro.serve import BatchPolicy as JBatchPolicy, FakeClock as JFakeClock
        from repro.serve import InlineExecutor as JInlineExecutor, ServeFrontend as JServeFrontend

        ing, jing = rgat.ingestors()
        fe = ServeFrontend(ing.plane, rgat.params, policy=BatchPolicy(capacities=(1, 4)),
                           clock=FakeClock(), executor=InlineExecutor())
        jfe = JServeFrontend(jing.plane, rgat.jtask.params, policy=JBatchPolicy(capacities=(1, 4)),
                             clock=JFakeClock(), executor=JInlineExecutor())
        assert fe.graphs is ing.plane
        rng = np.random.default_rng(9)
        n_tgt = rgat.task.batch.num_targets
        futs, jfuts = [], []
        for _ in range(3):
            for _ in range(2):
                q = rng.integers(0, n_tgt, 2)
                futs.append(fe.submit(q))
                jfuts.append(jfe.submit(q))
            fe.pump(force=True)
            jfe.pump(force=True)
            rgat.ingest(ing, jing, _edges(rng, ing.graph, n=2))
        last_q = rng.integers(0, n_tgt, 2)
        futs.append(fe.submit(last_q))
        jfuts.append(jfe.submit(last_q))
        fe.pump(force=True)
        jfe.pump(force=True)
        fe.close()
        jfe.close()
        st = fe.stats
        assert st.failed == 0 and st.shed == 0 and st.expired == 0
        assert st.completed == st.submitted == len(futs)
        assert all(f.done() for f in futs)
        for f, jf in zip(futs, jfuts):
            np.testing.assert_allclose(f.result(0), np.asarray(jf.result(0)), rtol=0, atol=TOL)
        # post-swap blocks are served by the new version, bit for bit its cold rebuild
        assert _same_bits(futs[-1].result(0), rgat.cold_logits(ing.graph)[last_q])

    def test_replay_helper(self, rgat):
        from repro.stream import replay as jreplay

        ing, jing = rgat.ingestors()
        rng = np.random.default_rng(10)
        deltas = [_edges(rng, ing.graph, n=1) for _ in range(2)]
        t = ing.graph.node_types[0]
        row = rng.normal(size=(1, ing.graph.features[t].shape[1])).astype(np.float32)
        deltas.append((_edges(rng, ing.graph, n=1), {t: (np.array([1], dtype=np.int64), row)}))
        reports, jreports = replay(ing, deltas), jreplay(jing, deltas)
        assert [r.version for r in reports] == [r.version for r in jreports] == [1, 2, 3]
        assert [r.structure_hash for r in reports] == [r.structure_hash for r in jreports]
        _assert_same_stack(ing.sgs, jing.sgs)
        got = ing.session(rgat.params).numpy()
        np.testing.assert_allclose(got, np.asarray(jing.session(rgat.jtask.params)), rtol=0, atol=TOL)
        assert _same_bits(got, rgat.cold_logits(ing.graph))


# --------------------------------------------------------------------------
# ego continuity: closures and ego programs survive version swaps
# --------------------------------------------------------------------------

EGO = dict(seed=0, sample_sizes=(1, 4))


def _warm(p, closure_cache=8):
    """Port and reference ingestors over fresh ego-enabled sessions whose
    planners keep ``closure_cache`` closures."""
    ing, jing = p.ingestors(ego=EGO, closure_cache=closure_cache)
    for i in (ing, jing):
        i.session.ego_planner.closure_cache = closure_cache
    return ing, jing


def _same_closure(a, b):
    assert sorted(a) == sorted(b)
    for t in a:
        assert _same_bits(a[t], b[t]), t


class TestEgoContinuity:
    def test_clean_closure_zero_retraces(self, rgat):
        from repro.core import flows as jflows

        ing, jing = _warm(rgat)
        sess = ing.session
        qa = np.arange(2, dtype=np.int32)
        want = sess.query_ego(rgat.params, qa).numpy()
        jing.session.query_ego(rgat.jtask.params, qa)
        full_a, _ = sess.ego_planner._closure(qa.astype(np.int64))
        _same_closure(full_a, jing.session.ego_planner._closure(qa.astype(np.int64))[0])
        g = ing.graph
        s_t, rel, d_t = g.relations[0]
        avoid = set(full_a.get(d_t, np.zeros(0, np.int64)).tolist())
        tgt = next(i for i in range(g.num_nodes[d_t]) if i not in avoid)
        traces0, jtraces0 = flows.DISPATCH["ego_traces"], jflows.DISPATCH["ego_traces"]
        edges = {rel: (np.random.default_rng(11).integers(0, g.num_nodes[s_t], 1), np.array([tgt], dtype=np.int64))}
        rep, _ = rgat.ingest(ing, jing, edges)
        assert rep.closures_carried >= 1 and rep.exes_adopted >= 1
        got = ing.session.query_ego(rgat.params, qa).numpy()
        jgot = np.asarray(jing.session.query_ego(rgat.jtask.params, qa))
        assert flows.DISPATCH["ego_traces"] == traces0 and jflows.DISPATCH["ego_traces"] == jtraces0
        assert ing.session.ego_planner.stats.closure_hits >= 1
        assert _same_bits(got, want)
        np.testing.assert_allclose(got, jgot, rtol=0, atol=TOL)
        # untouched types' host feature tables are the predecessor planner's
        for t in g.node_types:
            assert ing.session.ego_planner.features[t] is sess.ego_planner.features[t]

    def test_dirty_closure_recomputes(self, rgat):
        ing, jing = _warm(rgat)
        qa = np.arange(2, dtype=np.int32)
        ing.session.query_ego(rgat.params, qa)
        jing.session.query_ego(rgat.jtask.params, qa)
        full_a, _ = ing.session.ego_planner._closure(qa.astype(np.int64))
        g = ing.graph
        s_t, rel, d_t = g.relations[0]
        dirty_tgt = int(full_a[d_t][0])
        n = int(max(next(s for s in ing.sgs if s.name == rel).bucket_capacities)) + 8
        edges = {rel: (np.random.default_rng(12).integers(0, g.num_nodes[s_t], n),
                       np.full(n, dirty_tgt, dtype=np.int64))}
        rep, _ = rgat.ingest(ing, jing, edges)
        assert rep.stats.spilled_slices >= 1 and rep.closures_carried == 0
        got = ing.session.query_ego(rgat.params, qa).numpy()
        np.testing.assert_allclose(got, rgat.cold_logits(ing.graph)[qa], rtol=0, atol=TOL)
        np.testing.assert_allclose(got, np.asarray(jing.session.query_ego(rgat.jtask.params, qa)), rtol=0, atol=TOL)

    def test_interleaved_inserts_and_queries(self, rgat):
        ing, jing = _warm(rgat)
        qa = np.arange(2, dtype=np.int32)
        rng = np.random.default_rng(13)
        for _ in range(3):
            rgat.ingest(ing, jing, _edges(rng, ing.graph, n=2))
            got = ing.session.query_ego(rgat.params, qa).numpy()
            np.testing.assert_allclose(got, rgat.cold_logits(ing.graph)[qa], rtol=0, atol=TOL)
            jgot = np.asarray(jing.session.query_ego(rgat.jtask.params, qa))
            np.testing.assert_allclose(got, jgot, rtol=0, atol=TOL)

    def test_han_ego_beta_is_the_successors(self, pair):
        # HAN's ego forward takes β from the whole graph: after a delta on a
        # metapath's base relation the adopted ego program serves the
        # successor's β, within 1e-5 of the successor's full forward
        p = pair("han")
        ing, jing = _warm(p)
        qa = np.arange(3, dtype=np.int32)
        before = ing.session.query_ego(p.params, qa).numpy()
        beta0 = ing.session._ego_globals_for(p.params)
        jing.session.query_ego(p.jtask.params, qa)
        _, rel, _ = ing.graph.relations[0]
        rep, _ = p.ingest(ing, jing, _edges(np.random.default_rng(14), ing.graph, rel_names=(rel,), n=4))
        assert rep.stats.rebuilt_slices >= 1 or rep.stats.full_rebuild
        assert rep.exes_adopted >= 1
        traces = flows.DISPATCH["ego_traces"]
        got = ing.session.query_ego(p.params, qa).numpy()
        beta1 = ing.session._ego_globals_for(p.params)
        assert flows.DISPATCH["ego_traces"] == traces
        assert sorted(beta0) == sorted(beta1) and any(not torch.equal(beta0[k], beta1[k]) for k in beta0)
        assert not _same_bits(got, before)
        np.testing.assert_allclose(got, ing.session(p.params).numpy()[qa], rtol=0, atol=TOL)
        np.testing.assert_allclose(got, np.asarray(jing.session.query_ego(p.jtask.params, qa)), rtol=0, atol=TOL)


class TestClosureCache:
    """The planner's closure LRU, held to the reference's planner on the
    same batch (``tests/test_stream.py::TestClosureCache``)."""

    @staticmethod
    def _planners(p, **kw):
        from repro.core.ego import EgoPlanner as JEgoPlanner

        return EgoPlanner(p.task.batch, **kw), JEgoPlanner(p.jtask.batch, **kw)

    def test_lru_hit_and_eviction(self, rgat):
        for planner in self._planners(rgat, depth=2, closure_cache=2):
            st = planner.stats
            a = np.array([0, 1], dtype=np.int64)
            planner._cached_closure(a, st)
            planner._cached_closure(a, st)
            assert st.closure_hits == 1
            planner._cached_closure(np.array([2], dtype=np.int64), st)
            planner._cached_closure(np.array([3], dtype=np.int64), st)
            assert len(planner._closures) == 2  # `a` evicted
            planner._cached_closure(a, st)
            assert st.closure_hits == 1
        p, jp = self._planners(rgat, depth=2, closure_cache=2)
        for q in ([0, 1], [2], [0, 1]):
            p._cached_closure(np.array(q, dtype=np.int64), p.stats)
            jp._cached_closure(np.array(q, dtype=np.int64), jp.stats)
        assert list(p._closures) == list(jp._closures)
        for k in p._closures:
            _same_closure(p._closures[k][0], jp._closures[k][0])
            _same_closure(p._closures[k][1], jp._closures[k][1])

    def test_disabled_cache_never_stores(self, rgat):
        for planner in self._planners(rgat, depth=2):
            planner._cached_closure(np.array([0], dtype=np.int64), planner.stats)
            assert len(planner._closures) == 0

    def test_invalidate_drops_only_touching_closures(self, rgat):
        dropped = []
        for planner in self._planners(rgat, depth=2, closure_cache=8):
            st = planner.stats
            full_a, _ = planner._cached_closure(np.array([0], dtype=np.int64), st)
            planner._cached_closure(np.array([1], dtype=np.int64), st)
            t = planner.label_type
            dropped.append(planner.invalidate({t: full_a[t][:1]}))
            assert dropped[-1] >= 1
            assert len(planner._closures) < 2 or dropped[-1] == 2
        assert dropped[0] == dropped[1]

    def test_carry_from_rejects_mismatched_planner(self, rgat):
        p1, _ = self._planners(rgat, depth=2, closure_cache=4)
        p2, _ = self._planners(rgat, depth=3, closure_cache=4)
        with pytest.raises(ValueError, match="portable"):
            p2.carry_from(p1)

    def test_carry_from_skips_dirty(self, rgat):
        carried = []
        for p1, p2 in zip(self._planners(rgat, depth=2, closure_cache=4),
                          self._planners(rgat, depth=2, closure_cache=4)):
            full_a, _ = p1._cached_closure(np.array([0], dtype=np.int64), p1.stats)
            p1._cached_closure(np.array([1], dtype=np.int64), p1.stats)
            t = p1.label_type
            carried.append(p2.carry_from(p1, {t: full_a[t][:1]}))
            assert carried[-1] >= 1
            assert len(p2._closures) < len(p1._closures) or carried[-1] == 2
        assert carried[0] == carried[1]

    def test_adopt_ego_cache_guard(self, rgat):
        other = pipeline.prepare("rgat", "imdb", scale=SCALE, max_degree=None, seed=0, device="cpu")
        s2 = other.compile(FlowConfig(*FUSED))
        with pytest.raises(ValueError, match="portable"):
            rgat.session().adopt_ego_cache(s2)


# --------------------------------------------------------------------------
# the builders' hooks and GraphBatch.from_graph(features=)
# --------------------------------------------------------------------------


def _build(mod, kind, g, mps, **kw):
    if kind == "relation":
        return list(mod.build_relation_graphs(g, max_degree=4, bucket_sizes=(2, 4), **kw))
    if kind == "union":
        return list(mod.build_union_graph(g, max_degree=4, bucket_sizes=(2, 4), **kw).values())
    return list(mod.build_metapath_graphs(g, mps, max_degree=4, cap_fanout=16, bucket_sizes=(2, 4), **kw))


@pytest.mark.parametrize("kind", ["relation", "union", "metapath"])
def test_builder_rng_and_only_hooks(kind):
    """``rng=None`` builds the seeded tables; a given generator (a
    draw-counting one too) replaces the seed's, draw for draw; ``only=``
    builds the named relations alone: each array the reference's."""
    pytest.importorskip("jax")
    from repro.core import hetgraph as jhet
    from repro.data import datasets as jdatasets

    g, _, mps = datasets.resolve("imdb", scale=SCALE, seed=0)
    jg, _, _ = jdatasets.resolve("imdb", scale=SCALE, seed=0)

    def arrays(sgs):
        return _stack_arrays(sgs, [(8, 8)])

    seeded = arrays(_build(hetgraph, kind, g, mps, seed=0))
    for k, v in arrays(_build(jhet, kind, jg, mps, seed=0)).items():
        assert _same_bits(seeded[k], v), k
    crng = _CountingRng(np.random.default_rng(0))
    counted = arrays(_build(hetgraph, kind, g, mps, rng=crng))
    assert list(counted) == list(seeded) and all(_same_bits(counted[k], seeded[k]) for k in seeded)
    assert crng.draws > 0  # max_degree=4 (and the fanout cap) draw on this graph
    other = arrays(_build(hetgraph, kind, g, mps, rng=np.random.default_rng(7)))
    jother = arrays(_build(jhet, kind, jg, mps, rng=np.random.default_rng(7)))
    assert list(other) == list(jother) and all(_same_bits(other[k], jother[k]) for k in other)
    if kind == "relation":
        name = g.relations[-1][1]
        only = hetgraph.build_relation_graphs(g, max_degree=4, bucket_sizes=(2, 4), only=(name,))
        jonly = jhet.build_relation_graphs(jg, max_degree=4, bucket_sizes=(2, 4), only=(name,))
        assert [sg.name for sg in only] == [sg.name for sg in jonly] == [name]
        got, want = arrays(only), arrays(jonly)
        assert list(got) == list(want) and all(_same_bits(got[k], want[k]) for k in got)


def test_from_graph_takes_given_features_as_they_are(rgat):
    """``features=`` tensors are taken with no copy; without it every table
    is copied to the device as float32."""
    g, sgs = rgat.task.graph, rgat.task.sgs
    given = {t: torch.from_numpy(np.asarray(f, np.float32).copy()) for t, f in g.features.items()}
    b = GraphBatch.from_graph(g, sgs, torch.device("cpu"), features=given)
    assert all(b.features[t] is given[t] for t in g.node_types)
    assert all(x is y for x, y in zip(b.sgs, sgs)) and b.offsets == g.type_offsets() and b.label_type == g.label_type
    fresh = GraphBatch.from_graph(g, sgs, torch.device("cpu"))
    for t in g.node_types:
        assert fresh.features[t] is not given[t] and fresh.features[t].dtype == torch.float32
        assert torch.equal(fresh.features[t], given[t])


# --------------------------------------------------------------------------
# on the card: a successor is a new CUDA graph over its own tables
# --------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (successor sessions are captured CUDA graphs)")
    return torch.device("cuda")


def _device_ptrs(sg) -> set:
    return {t.data_ptr() for t in sg_tensors(sg)}


def _card_ingest(cuda_device, model="rgat", rel_index=0, n=3):
    task = pipeline.prepare(model, "imdb", scale=SCALE, max_degree=None, seed=0, device=cuda_device)
    ing = StreamIngestor(task, task.compile(FlowConfig(*KERNEL)))
    old = ing.session
    old_sgs = {sg.name: sg for sg in ing.sgs}
    _, rel, _ = task.graph.relations[rel_index]
    ing.ingest(_edges(np.random.default_rng(15), task.graph, rel_names=(rel,), n=n))
    return task, ing, old, old_sgs


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rgat", "han"])
def test_cuda_successor_is_its_cold_capture(cuda_device, model):
    """A successor session is a captured graph whose replay equals, bit for
    bit, a cold ``prepare`` of the version's graph captured the same way."""
    task, ing, _, _ = _card_ingest(cuda_device, model)
    assert ing.session.captured
    cold = pipeline.prepare(model, ing.graph, max_degree=None, seed=0, metapaths=task.metapaths, device=cuda_device)
    got = ing.session(task.params)
    assert torch.equal(got.view(torch.int32), cold.compile(FlowConfig(*KERNEL))(task.params).view(torch.int32))


@pytest.mark.cuda
def test_cuda_clean_tables_shared_dirty_tables_fresh(cuda_device):
    """Clean slices keep their predecessor's device tables (the same
    objects, the same pointers); dirty slices' tables are their own."""
    _, ing, _, old_sgs = _card_ingest(cuda_device)
    for sg in ing.sgs:
        old = old_sgs[sg.name]
        ptrs, old_ptrs = _device_ptrs(sg), _device_ptrs(old)
        assert ptrs and old_ptrs
        if sg is old:
            assert ptrs == old_ptrs
        else:
            assert not ptrs & old_ptrs


@pytest.mark.cuda
def test_cuda_zeroed_predecessor_tables_do_not_reach_the_successor(cuda_device):
    """Zeroing the predecessor's dirty device tables after the swap leaves
    the successor's replay bit for bit unchanged; zeroing the successor's
    own changes it (the check can see a table)."""
    task, ing, _, old_sgs = _card_ingest(cuda_device, "han")
    want = ing.session(task.params).clone()
    dirty = [sg for sg in ing.sgs if sg is not old_sgs[sg.name]]
    assert dirty
    for sg in dirty:
        for lay in old_sgs[sg.name]._grouped.values():
            for key, tables in lay._dev.items():
                if key[0] == "base":
                    for t in tables:
                        t.zero_()
    assert torch.equal(ing.session(task.params).view(torch.int32), want.view(torch.int32))
    lay = next(iter(dirty[0]._grouped.values()))
    msk = next(v for k, v in lay._dev.items() if k[0] == "base")[1]
    saved = msk.clone()
    msk.zero_()
    assert not torch.equal(ing.session(task.params).view(torch.int32), want.view(torch.int32))
    msk.copy_(saved)
    assert torch.equal(ing.session(task.params).view(torch.int32), want.view(torch.int32))
