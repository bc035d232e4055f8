"""The port's sharded grouped NA (``ShardedBucketLayout``, ``prepare(shards=)``,
the SGB cache's splits, the stream merge's split patches, ``flows``'s mesh
routing and ``ops.fused_prune_aggregate_grouped_sharded``) against the
reference and against the port's own single-device path, on the CPU.

  * every host array is the reference's bit for bit: ``shard_layout`` and
    ``.sharded`` at 1, 2, 3, 4 and 8 shards on the reference's sharding
    graphs (with every invariant of ``tests/test_sgb.py``'s
    ``test_shard_layout_partitions_blocks``) and on metapath, relation and
    union builds; ``prepare(shards=2)``; SGB cache entries with splits,
    written by either package and read by the other; a sharded absorb,
    against a cold rebuild and against the reference's ``apply_delta``;
  * ``shard_out`` for every shard of an n-way split, on one process, is
    the single-device grouped NA bit for bit at 1, 2, 4 and 8 shards, on a
    target count no split divides and on an all-bypass graph;
  * two and four ``gloo`` ranks (``tests/torch_sharding_ranks.py``, one
    spawn per world size): HAN, RGAT and Simple-HGN logits on IMDB under
    a ``("data",)`` device mesh are bit for bit the single-device ones,
    with one fused call per rank per semantic graph; no mesh and
    ``shard="off"`` change nothing; a session built under the mesh keeps
    it pinned (no lookup per call), a front-end over it serves the
    single-device rows, ego queries run unsharded, and an ingest's
    successor keeps the mesh with splits equal to a cold build's.

The reference's own claim (``tests/test_sharded.py``) needs 8 jax devices
and skips here; the port holds its sharded results to its single-device
ones, which the other port tests hold to the reference.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharding_ranks as ranks  # noqa: E402
from repro_torch.core import flows, hetgraph, pipeline  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402
from repro_torch.core.session import InferenceSession  # noqa: E402
from repro_torch.data import sgb_cache, synthetic  # noqa: E402
from repro_torch.distributed import sharding as dist  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ops  # noqa: E402
from repro_torch.stream import DeltaLog, apply_to_graph  # noqa: E402
from repro_torch.stream.merge import apply_delta  # noqa: E402

WAYS = (1, 2, 3, 4, 8)
KERNEL = FlowConfig("fused_kernel", prune_k=8)
GROUPED_FIELDS = ("nbr", "msk", "ety", "step_row", "step_dt", "step_ndt", "step_bucket", "caps",
                  "caps_pad", "row_targets", "perm")


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _assert_same_split(got, want):
    """Two ``ShardedBucketLayout``s (either package's) array for array."""
    assert (got.n_shards, got.t_tile, got.w) == (want.n_shards, want.t_tile, want.w)
    assert (got.num_rows_alloc, got.num_steps_max) == (want.num_rows_alloc, want.num_steps_max)
    assert _same_bits(got.perm, want.perm)
    assert len(got.shards) == len(want.shards)
    for s, (a, b) in enumerate(zip(got.shards, want.shards)):
        assert (a.t_tile, a.w, a.num_rows) == (b.t_tile, b.w, b.num_rows), s
        for f in GROUPED_FIELDS:
            assert _same_bits(getattr(a, f), getattr(b, f)), (s, f)


# --------------------------------------------------------------------------
# host layouts against the reference
# --------------------------------------------------------------------------


def _sharded_graphs():
    """``tests/test_sgb.py``'s sharding graphs, built by the port."""
    g = synthetic.DATASETS["imdb"](scale=0.08, seed=0)
    return hetgraph.build_relation_graphs(g, max_degree=48, seed=0, bucket_sizes=(4, 8, 16))


@pytest.fixture(scope="module")
def ref_sharded_graphs():
    pytest.importorskip("jax")
    from repro.core import hetgraph as jhg
    from repro.data import synthetic as jsyn

    g = jsyn.DATASETS["imdb"](scale=0.08, seed=0)
    return jhg.build_relation_graphs(g, max_degree=48, seed=0, bucket_sizes=(4, 8, 16))


@pytest.mark.parametrize("n_shards", WAYS)
def test_shard_layout_equals_reference(ref_sharded_graphs, n_shards):
    from repro.core import hetgraph as jhg

    for sg, jsg in zip(_sharded_graphs(), ref_sharded_graphs):
        _assert_same_split(hetgraph.shard_layout(sg.grouped(), n_shards),
                           jhg.shard_layout(jsg.grouped(), n_shards))
        _assert_same_split(sg.sharded(n_shards), jsg.sharded(n_shards))
        assert sg.sharded(n_shards) is sg.sharded(n_shards)  # cached per split


@pytest.mark.parametrize("n_shards", WAYS)
def test_shard_layout_partitions_blocks(n_shards):
    """The invariants of the reference's test of the same name, on the
    port's layouts: shards partition the row blocks, every target lands on
    one shard, block step runs move whole in stack order, per-shard
    metadata stays bucket-local."""
    for sg in _sharded_graphs():
        lay = sg.grouped()
        sl = hetgraph.shard_layout(lay, n_shards)
        assert len(sl.shards) == n_shards
        assert sum(s.num_steps for s in sl.shards) == lay.num_steps
        assert sum(s.num_rows for s in sl.shards) == lay.num_rows
        owner = sl.perm // sl.num_rows_alloc
        local = sl.perm % sl.num_rows_alloc
        assert owner.min() >= 0 and owner.max() < n_shards
        for s, sh in enumerate(sl.shards):
            mine = np.flatnonzero(owner == s)
            np.testing.assert_array_equal(sh.perm[mine], local[mine])
            assert (sh.perm[np.flatnonzero(owner != s)] == -1).all()
            assert len(np.unique(local[mine])) == mine.size
            assert local.max(initial=-1, where=owner == s) < sh.num_rows
            assert sh.num_rows <= sl.num_rows_alloc - sl.t_tile
            if mine.size:
                np.testing.assert_array_equal(sh.row_targets[sh.perm[mine[0]]], mine[0])
        seen = np.zeros(lay.num_steps, bool)
        for sh in sl.shards:
            for i in range(sh.num_steps):
                blk = sh.row_targets[sh.step_row[i] * sh.t_tile:(sh.step_row[i] + 1) * sh.t_tile]
                cand = np.flatnonzero((lay.step_bucket == sh.step_bucket[i]) & (lay.step_dt == sh.step_dt[i]))
                hits = [
                    g for g in cand
                    if not seen[g] and np.array_equal(
                        lay.row_targets[lay.step_row[g] * lay.t_tile:(lay.step_row[g] + 1) * lay.t_tile], blk)
                ]
                assert hits, "shard step has no unmatched original step"
                seen[hits[0]] = True
                np.testing.assert_array_equal(sh.nbr[i], lay.nbr[hits[0]])
                np.testing.assert_array_equal(sh.msk[i], lay.msk[hits[0]])
                np.testing.assert_array_equal(sh.ety[i], lay.ety[hits[0]])
                assert sh.step_ndt[i] == lay.step_ndt[hits[0]]
        assert seen.all()
        # LPT balance: no shard exceeds the lightest by more than one block
        slots = sl.padded_slots()
        max_block = int(lay.step_ndt.max(initial=0)) * lay.t_tile * lay.w
        assert slots.max() - slots.min() <= max(max_block, 0)
        assert sl.balance() >= 1.0
        assert sl.pad_block == sl.num_rows_alloc // sl.t_tile - 1


@pytest.fixture(scope="module")
def builds():
    """Metapath (HAN ACM), relation (RGAT IMDB) and union (Simple-HGN DBLP)
    builds at the reference's test scale, in both packages."""
    pytest.importorskip("jax")
    from repro.core import pipeline as jpipe

    out = {}
    for kind, (model, ds) in {"metapath": ("han", "acm"), "relation": ("rgat", "imdb"),
                              "union": ("simple_hgn", "dblp")}.items():
        kw = dict(scale=0.04, max_degree=32, seed=0)
        out[kind] = (pipeline.prepare(model, ds, device="cpu", **kw).sgs, jpipe.prepare(model, ds, **kw).sgs)
    return out


@pytest.mark.parametrize("kind", ("metapath", "relation", "union"))
def test_sharded_builds_equal_reference(builds, kind):
    sgs, jsgs = builds[kind]
    for sg, jsg in zip(sgs, jsgs):
        for n in WAYS:
            _assert_same_split(sg.sharded(n), jsg.sharded(n))


def test_empty_graph_split_equals_reference():
    """A graph with no grid steps splits into empty shards and a one-block
    allocation, as the reference's does."""
    pytest.importorskip("jax")
    from repro.core import hetgraph as jhg

    z = np.zeros((5, 4), np.int32)
    sg = hetgraph.bucketize("t", ("x",), "x", z, z.astype(bool), z, (4,))
    jsg = jhg.bucketize("t", ("x",), "x", z, z.astype(bool), z, (4,))
    for n in (1, 3):
        _assert_same_split(sg.sharded(n), jsg.sharded(n))


def test_prepare_shards_equals_reference():
    """``prepare(shards=2)`` splits every bucketed graph at the kernel's
    tile shape, as the reference's does; no split without a mesh or a
    count."""
    pytest.importorskip("jax")
    from repro.core import pipeline as jpipe

    kw = dict(scale=0.04, max_degree=32, seed=0, bucket_sizes=(4, 8, 16))
    task = pipeline.prepare("rgat", "imdb", device="cpu", shards=2, **kw)
    jtask = jpipe.prepare("rgat", "imdb", shards=2, **kw)
    key = (2, ops.T_TILE, ops.W_TILE)
    for sg, jsg in zip(task.sgs, jtask.sgs):
        assert list(sg._sharded) == [key]
        _assert_same_split(sg._sharded[key], jsg._sharded[key])
    assert all(not sg._sharded for sg in pipeline.prepare("rgat", "imdb", device="cpu", **kw).sgs)


@pytest.mark.parametrize("kind", ("relation", "union"))
def test_cache_splits_cross_packages(tmp_path, kind):
    """Entries with splits: the port's loads in the reference and the
    reference's in the port, every split array for array; a hit asking for
    a split the entry lacks adds it and keeps the others."""
    pytest.importorskip("jax")
    from repro.data import sgb_cache as jcache
    from repro.data import synthetic as jsyn

    g, jg = synthetic.DATASETS["acm"](scale=0.04, seed=0), jsyn.DATASETS["acm"](scale=0.04, seed=0)
    kw = dict(max_degree=64, seed=0, bucket_sizes=(4, 8, 16))
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    built, s = sgb_cache.build_or_load(g, kind, cache_dir=port_dir, shards=2, **kw)
    assert s == "miss"
    jbuilt, s = jcache.build_or_load(jg, kind, cache_dir=ref_dir, shards=2, **kw)
    assert s == "miss"
    (pf,), (rf,) = list(port_dir.iterdir()), list(ref_dir.iterdir())
    assert pf.name == rf.name

    def sgs(x):
        return list(x.values()) if isinstance(x, dict) else list(x)

    key = (2, 8, 8)
    for loaded, _ in (jcache.load_sgb(pf), sgb_cache.load_sgb(rf)):
        for a, b in zip(loaded, sgs(built)):
            _assert_same_split(a._sharded[key], b._sharded[key])
    # the port's hit adds a 3-way split to the reference's entry
    hit, s = sgb_cache.build_or_load(g, kind, cache_dir=ref_dir, shards=3, **kw)
    assert s == "hit"
    with np.load(rf) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    assert meta["shards"] == [2, 3]
    for a, b in zip(jcache.load_sgb(rf)[0], sgs(jbuilt)):
        _assert_same_split(a._sharded[key], b._sharded[key])
        _assert_same_split(a._sharded[(3, 8, 8)], b.sharded(3))
    # and a hit that has its split is not written back
    mtime = rf.stat().st_mtime_ns
    _, s = sgb_cache.build_or_load(g, kind, cache_dir=ref_dir, shards=2, **kw)
    assert s == "hit" and rf.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("model", ("rgat", "simple_hgn"))
def test_sharded_absorb_equals_cold_and_reference(model):
    """A delta absorbed into a stack carrying 2- and 3-way splits: every
    patched split equals a cold build's and the reference's patch array
    for array; a shard no delta row lands on keeps its object (and its
    device mirrors), a patched shard is a new object with an empty
    ``_dev``."""
    pytest.importorskip("jax")
    from repro.core import pipeline as jpipe
    from repro.stream import DeltaLog as JDeltaLog
    from repro.stream import apply_to_graph as japply
    from repro.stream.merge import apply_delta as japply_delta

    kw = dict(scale=0.05, max_degree=None, seed=0)
    task, jtask = pipeline.prepare(model, "imdb", device="cpu", **kw), jpipe.prepare(model, "imdb", **kw)
    for sgs in (task.sgs, jtask.sgs):
        for sg in sgs:
            sg.sharded(2), sg.sharded(3)
    for sg in task.sgs:
        sg._sharded[(3, 8, 8)].shards[0]._dev["marker"] = torch.zeros(1)
    g = task.graph
    s_t, rel, d_t = g.relations[0]
    rng = np.random.default_rng(11)
    edges = {rel: (rng.integers(0, g.num_nodes[s_t], 4), np.array([0, 1, 2, 3], np.int64))}
    d, jd = DeltaLog().append(edges), JDeltaLog().append(edges)
    ng, jng = apply_to_graph(g, d), japply(jtask.graph, jd)
    new, dirty, stats = apply_delta(task.sgs, g, ng, d, kind=task.sgb_kind, metapaths=task.metapaths,
                                    **task.sgb_args)
    jnew, _, jstats = japply_delta(jtask.sgs, jtask.graph, jng, jd, kind=jtask.sgb_kind,
                                   metapaths=jtask.metapaths, **jtask.sgb_args)
    assert stats.absorbed_slices >= 1 and not stats.full_rebuild
    assert (stats.absorbed_slices, stats.rebuilt_slices) == (jstats.absorbed_slices, jstats.rebuilt_slices)
    cold = pipeline.prepare(model, ng, max_degree=None, seed=0, device="cpu").sgs
    kept = 0
    for old, sg, jsg, csg in zip(task.sgs, new, jnew, cold):
        for key in ((2, 8, 8), (3, 8, 8)):
            _assert_same_split(sg._sharded[key], jsg._sharded[key])
            _assert_same_split(sg._sharded[key], csg.sharded(*key))
            for a, b in zip(old._sharded[key].shards, sg._sharded[key].shards):
                if a is b:
                    kept += 1
                else:
                    assert not b._dev and not np.array_equal(a.msk, b.msk)
    assert kept > 0  # some shard of a dirty slice (or a clean slice) kept its object
    assert any("marker" in sg._sharded[(3, 8, 8)].shards[0]._dev for sg in new)


# --------------------------------------------------------------------------
# shard_out: every shard of an n-way split on one process
# --------------------------------------------------------------------------


def _custom_graph(num_targets, num_src, num_edges, max_degree, seed=0):
    """``tests/test_sharded.py``'s custom graph, built by the port."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_src, size=num_edges).astype(np.int64)
    dst = rng.integers(0, num_targets, size=num_edges).astype(np.int64)
    nbr, msk, ety = hetgraph._pad_csc(src, dst, num_targets, max_degree, np.random.default_rng(seed + 1))
    return hetgraph.bucketize("t", ("x",), "x", nbr, msk, ety, (4, 8, 16))


def _na_inputs(sg, n_src, seed=0, rel=False):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return t(n_src, 4, 8), t(n_src, 4), t(sg.num_targets, 4), (t(3, 4) if rel else None)


def _stitched(sl, h, ts, td, rel, prune_k):
    outs = [ops.shard_out(sl, s, h, ts, td, theta_rel=rel, prune_k=prune_k) for s in range(sl.n_shards)]
    assert all(o.shape == (sl.num_rows_alloc,) + tuple(h.shape[1:]) for o in outs)
    return torch.cat(outs).index_select(0, torch.from_numpy(sl.perm.astype(np.int64)))


GRAPHS = {
    "nondivisible": dict(num_targets=37, num_src=50, num_edges=400, max_degree=24),
    "all_bypass": dict(num_targets=33, num_src=40, num_edges=80, max_degree=6),
    "wide": dict(num_targets=64, num_src=80, num_edges=900, max_degree=None),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("prune_k", (None, 2, 8))
def test_shard_out_stitches_single_device_bits(graph, prune_k):
    sg = _custom_graph(**GRAPHS[graph])
    if graph == "all_bypass":
        assert sg.max_degree <= 8
    h, ts, td, rel = _na_inputs(sg, GRAPHS[graph]["num_src"], rel=graph == "wide")
    ref = ops.fused_prune_aggregate_grouped(h, ts, td, sg, theta_rel=rel, prune_k=prune_k)
    _, _, k_s = ops.grouped_meta(sg.grouped(), prune_k)
    for n in (1, 2, 4, 8):
        sl = sg.sharded(n)
        assert ops.sharded_k_s(sl, prune_k) == k_s  # the unsharded launch's width
        if graph == "nondivisible":
            assert sg.num_targets % n or n == 1
        assert torch.equal(_stitched(sl, h, ts, td, rel, prune_k), ref), n
    # 8 shards of 5 row blocks: some shards are empty and give zeros
    if graph == "nondivisible":
        sl = sg.sharded(8)
        empty = [s for s in range(8) if sl.shards[s].num_steps == 0]
        assert empty
        assert not ops.shard_out(sl, empty[0], h, ts, td, prune_k=prune_k).any()


def test_shard_out_on_model_graphs_and_launch_count(monkeypatch):
    """Every bucketed graph of RGAT IMDB at its model's shapes: the stitched
    shards equal the single-device NA bit for bit, and each shard with
    grid steps makes exactly one grouped fused call."""
    task = pipeline.prepare("rgat", "imdb", scale=0.04, max_degree=32, seed=0, bucket_sizes=(4, 8, 16),
                            device="cpu")
    n_src = task.batch.total_nodes
    calls = []
    orig = ops.prune_aggregate

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    for i, sg in enumerate(task.sgs):
        h, ts, td, rel = _na_inputs(sg, n_src, seed=i, rel=True)
        ref = ops.fused_prune_aggregate_grouped(h, ts, td, sg, theta_rel=rel, prune_k=8)
        for n in (1, 2, 4, 8):
            sl = sg.sharded(n)
            monkeypatch.setattr(ops, "prune_aggregate", counted)
            calls.clear()
            got = _stitched(sl, h, ts, td, rel, 8)
            monkeypatch.setattr(ops, "prune_aggregate", orig)
            assert len(calls) == sum(1 for s in sl.shards if s.num_steps)
            assert torch.equal(got, ref), (sg.name, n)
    assert not ops.SHARD_LAUNCHES  # the CPU launches no kernel


# --------------------------------------------------------------------------
# mesh plumbing on one process
# --------------------------------------------------------------------------


class _FakeMesh:
    """The part of a ``DeviceMesh`` the lookups read."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, i):
        return self._sizes[i]


def test_graph_mesh_lookups():
    assert dist.ambient_mesh() is None and dist.graph_mesh() is None
    mesh = _FakeMesh(pod=2, data=4)
    with dist.set_mesh(mesh):
        assert dist.graph_mesh() == (mesh, "data", 4)
        assert dist.graph_shard_axis() == "data"
        with dist.axis_rules({"bucket_tiles": ("model",)}):
            assert dist.graph_mesh() is None
        with dist.axis_rules({"bucket_tiles": ("pod", "data")}):
            assert dist.graph_mesh() == (mesh, "pod", 2)
        with dist.set_mesh(None):
            assert dist.graph_mesh() is None
    assert dist.graph_mesh() is None
    graph_axes = {k: dist.DEFAULT_RULES[k] for k in ("bucket_tiles", "targets", "ntype_feat")}
    assert graph_axes == {"bucket_tiles": ("data",), "targets": (), "ntype_feat": ()}
    from repro.distributed.sharding import DEFAULT_RULES  # the whole table, the LM axes included

    assert dist.DEFAULT_RULES == DEFAULT_RULES
    with dist.set_mesh(_FakeMesh(model=8)):
        assert dist.graph_mesh() is None  # no bucket_tiles axis


def test_mesh_scope_resolves_once_and_pins():
    def reset():
        flows.DISPATCH["mesh_lookups"] = 0

    reset()
    assert flows._graph_mesh_once() is None and flows._graph_mesh_once() is None
    assert flows.DISPATCH["mesh_lookups"] == 2  # outside a scope: every call
    reset()
    with flows.mesh_scope():
        for _ in range(3):
            assert flows._graph_mesh_once() is None
        with flows.mesh_scope():  # nested lazy scope reuses the slot
            flows._graph_mesh_once()
    assert flows.DISPATCH["mesh_lookups"] == 1
    reset()
    pinned = ("m", "data", 3)
    with flows.mesh_scope(pinned=pinned):
        with flows.mesh_scope():  # the pinning caller wins
            assert flows._graph_mesh_once() == pinned
    assert flows.DISPATCH["mesh_lookups"] == 0
    with pytest.raises(ValueError):
        FlowConfig("fused_kernel", shard="on")


def test_no_mesh_no_change_and_session_pins_none():
    """No mesh: ``fused_kernel`` runs the single-device launch (no sharded
    call), one lookup per apply and none for a flow that never asks; a
    session resolves once at build and looks up nothing per call."""
    task = pipeline.prepare("han", "imdb", scale=0.04, max_degree=32, seed=0, device="cpu")
    for k in flows.DISPATCH:
        flows.DISPATCH[k] = 0
    ref = task.model.apply(task.params, task.batch, KERNEL)
    assert flows.DISPATCH["sharded_calls"] == 0 and flows.DISPATCH["mesh_lookups"] == 1
    flows.DISPATCH["mesh_lookups"] = 0
    task.model.apply(task.params, task.batch, FlowConfig("staged"))
    assert flows.DISPATCH["mesh_lookups"] == 0
    sess = task.compile(KERNEL)
    assert sess.mesh_info is None
    flows.DISPATCH["mesh_lookups"] = 0
    assert torch.equal(sess(task.params), ref)
    assert flows.DISPATCH["mesh_lookups"] == 0 and flows.DISPATCH["sharded_calls"] == 0
    pinned = InferenceSession(task.model, task.batch, KERNEL, params=task.params, mesh_info=None)
    with dist.set_mesh(_FakeMesh(data=2)):  # pinned to no mesh, the ambient one is not read
        assert torch.equal(pinned(task.params), ref)
    assert flows.DISPATCH["sharded_calls"] == 0


# --------------------------------------------------------------------------
# two and four gloo ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single():
    """The single-device logits the ranks are held to, computed here."""
    with torch.inference_mode():
        out = {}
        for m in ranks.MODELS:
            task = pipeline.prepare(m, "imdb", device="cpu", **ranks.TASK)
            out[m] = task.model.apply(task.params, task.batch, KERNEL).numpy()
        return out


@pytest.fixture(scope="module", params=(2, 4), ids=("2ranks", "4ranks"))
def world(request, tmp_path_factory):
    """One spawn of ``n`` gloo ranks running every multi-rank check."""
    n = request.param
    return n, ranks.spawn(n, str(tmp_path_factory.mktemp(f"gloo{n}")), timeout=240.0)


@pytest.mark.parametrize("model", ranks.MODELS)
def test_ranks_logits_bit_for_bit(world, single, model):
    n, results = world
    assert sorted(r["rank"] for r in results) == list(range(n))
    for r in results:
        assert _same_bits(r[model, "single"], single[model])
        assert _same_bits(r[model, "sharded"], single[model])
        assert _same_bits(r[model, "off"], single[model])


@pytest.mark.parametrize("model", ranks.MODELS)
def test_ranks_one_launch_per_shard_per_graph(world, model):
    n, results = world
    for r in results:
        sharded_calls, lookups, fused_calls, graph_calls = r[model, "sharded_counts"]
        assert sharded_calls == graph_calls > 0  # every bucketed NA dispatch sharded
        assert fused_calls == graph_calls  # one fused call per rank per graph
        assert lookups == 1  # one lookup per apply
        assert r[model, "single_counts"] == (0, 1)  # no mesh: no sharded call
        assert r[model, "off_counts"] == (0, 0)  # shard="off" never looks
        assert r[model, "staged_lookups"] == 0


def test_ranks_session_frontend_and_ego(world, single):
    n, results = world
    ref = single["rgat"]
    for r in results:
        assert r["compile_cached"] and r["compile_unsharded_differs"]
        assert r["session_mesh_n"] == n
        assert _same_bits(r["session"], ref)
        sharded_calls, lookups = r["session_counts"]
        assert sharded_calls > 0 and lookups == 0  # pinned at build
        query_calls, blocks, lookups, sharded = r["serve_counts"]
        assert query_calls == blocks > 0 and lookups == 0 and sharded > 0
        for t, rows in zip(r["serve_targets"], r["serve_rows"]):
            assert _same_bits(rows, ref[t])
        lookups, sharded, served = r["ego_counts"]
        assert (lookups, sharded, served) == (0, 0, len(r["ego_queries"]))
        for q, rows in zip(r["ego_queries"], r["ego_rows"]):
            np.testing.assert_allclose(rows, ref[q], rtol=0, atol=1e-5)


def test_ranks_deltas_keep_the_mesh(world):
    n, results = world
    for r in results:
        assert r["presplit"]
        absorbed, full = r["delta_tier"]
        assert absorbed >= 1 and not full
        assert r["successor_mesh"]
        assert any(r["clean_split_kept"].values())
        assert r["split_vs_cold"]
        assert _same_bits(r["delta_logits"], r["cold_logits"])
    assert all(_same_bits(r["delta_logits"], results[0]["delta_logits"]) for r in results)
