"""Port parity: host-side SGB artifacts are bit-identical to the reference.

The same ``(dataset, scale, seed)`` goes through ``repro.core.pipeline``
and ``repro_torch.core.pipeline``; every numpy artifact the port builds —
the generated graph, the metapath, relation and union SGB tables (bucketed
and flat), the grouped ``(8, 8)`` tile stack, the kernel metadata tables
and the splits — must equal the reference's array for array.
"""
import gc
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import hetgraph as jhg  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.hetgraph import DEFAULT_BUCKET_SIZES as J_BUCKETS  # noqa: E402
from repro.kernels.fused_prune_aggregate import ops as jops  # noqa: E402
from repro_torch.core import hetgraph as thg  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.hetgraph import DEFAULT_BUCKET_SIZES as T_BUCKETS  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ops as tops  # noqa: E402

DATASETS = ("acm", "imdb", "dblp")
LAYOUTS = ("default", None)
SCALE = 0.05


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
    cache = {}

    def get(ds, layout):
        key = (ds, layout)
        if key not in cache:
            kw = {} if layout == "default" else {"bucket_sizes": None}
            cache[key] = (
                jpipe.prepare("han", ds, scale=SCALE, seed=0, **kw),
                tpipe.prepare("han", ds, scale=SCALE, seed=0, device="cpu", **kw),
            )
        return cache[key]

    return get


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("ds", DATASETS)
def test_generated_graph_and_splits_identical(tasks, ds):
    jt, tt = tasks(ds, "default")
    jg, tg = jt.graph, tt.graph
    assert jg.node_types == tg.node_types
    assert jg.num_nodes == tg.num_nodes
    assert jg.relations == tg.relations
    assert (jg.label_type, jg.num_classes) == (tg.label_type, tg.num_classes)
    _eq(jg.labels, tg.labels, "labels")
    for t in jg.node_types:
        _eq(jg.features[t], tg.features[t], f"features[{t}]")
    for rel, (src, dst) in jg.edges.items():
        _eq(src, tg.edges[rel][0], f"{rel} src")
        _eq(dst, tg.edges[rel][1], f"{rel} dst")
    for k in ("train", "val", "test"):
        _eq(jt.splits[k], tt.splits[k], f"splits {k}")


@pytest.mark.parametrize("n", (1, 2, 3, 7, 100, 4057))
def test_splits_identical(n):
    js, ts = jpipe._splits(n, seed=3), tpipe._splits(n, seed=3)
    for k in ("train", "val", "test"):
        _eq(js[k], ts[k], k)


def _sgs_identical(jsgs, tsgs, layout):
    """Semantic graphs table for table: flat tables (``layout=None``) or
    the bucket tables of any bucketed build."""
    assert [sg.name for sg in jsgs] == [sg.name for sg in tsgs]
    for js, ts in zip(jsgs, tsgs):
        what = js.name
        assert type(js).__name__ == type(ts).__name__, what
        assert (js.src_types, js.dst_type, js.num_targets) == (
            ts.src_types, ts.dst_type, ts.num_targets
        ), what
        if layout is None:
            for f in ("nbr_idx", "nbr_mask", "edge_type"):
                _eq(getattr(js, f), getattr(ts, f), f"{what}.{f}")
            continue
        assert js.bucket_capacities == ts.bucket_capacities, what
        for i, (jb, tb) in enumerate(zip(js.buckets, ts.buckets)):
            for f in ("targets", "nbr_idx", "nbr_mask", "edge_type"):
                _eq(getattr(jb, f), getattr(tb, f), f"{what}.b{i}.{f}")
        _eq(js.target_perm(), ts.target_perm(), f"{what}.perm")
        _eq(js.concat_targets(), ts.concat_targets(), f"{what}.concat")


@pytest.mark.parametrize("layout", LAYOUTS, ids=("bucketed", "flat"))
@pytest.mark.parametrize("ds", DATASETS)
def test_metapath_sgb_tables_identical(tasks, ds, layout):
    assert tuple(T_BUCKETS) == tuple(J_BUCKETS)
    jt, tt = tasks(ds, layout)
    _sgs_identical(jt.sgs, tt.sgs, layout)


GROUPED_FIELDS = (
    "nbr", "msk", "ety", "step_row", "step_dt", "step_ndt", "step_bucket",
    "caps", "caps_pad", "row_targets", "perm",
)


@pytest.mark.parametrize("ds", DATASETS)
def test_grouped_layout_identical(tasks, ds):
    """The grouped (8, 8) tile stack, array for array."""
    jt, tt = tasks(ds, "default")
    for js, ts in zip(jt.sgs, tt.sgs):
        jl, tl = js.grouped(8, 8), ts.grouped(8, 8)
        assert (jl.t_tile, jl.w, jl.num_rows) == (tl.t_tile, tl.w, tl.num_rows)
        for f in GROUPED_FIELDS:
            _eq(getattr(jl, f), getattr(tl, f), f"{js.name}.grouped.{f}")


@pytest.mark.parametrize("prune_k", (None, 6, 8, 100))
@pytest.mark.parametrize("ds", DATASETS)
def test_grouped_meta_identical(tasks, ds, prune_k):
    """The kernel metadata tables; and the CUDA K1's per-row-block table
    carries exactly the per-step K1 metadata (every step of block b sits at
    blk.first + dt, with the block's n_dt/bypass/k_eff)."""
    jt, tt = tasks(ds, "default")
    for js, ts in zip(jt.sgs, tt.sgs):
        what = js.name
        jl, tl = js.grouped(8, 8), ts.grouped(8, 8)
        jm, ja, jk = jops.grouped_meta(jl, prune_k)
        tm, ta, tk = tops.grouped_meta(tl, prune_k)
        _eq(jm, tm, f"{what} k1 meta")
        _eq(ja, ta, f"{what} k2 meta")
        assert jk == tk, what
        blk = tops.block_table(tl, tm)
        step = blk[0, tm[0]] + tm[1]
        _eq(step, np.arange(tl.num_steps, dtype=step.dtype), f"{what} step order")
        for r in range(3):
            _eq(blk[r + 1, tm[0]], tm[r + 2], f"{what} blk row {r + 1}")


def _build(hg, g, kind, **kw):
    if kind == "relation":
        return hg.build_relation_graphs(g, **kw)
    built = hg.build_union_graph(g, **kw)
    assert list(built) == list(g.node_types)
    return list(built.values())


@pytest.mark.parametrize("max_degree", (256, 16), ids=("cap256", "cap16"))
@pytest.mark.parametrize("layout", LAYOUTS, ids=("bucketed", "flat"))
@pytest.mark.parametrize("kind", ("relation", "union"))
@pytest.mark.parametrize("ds", DATASETS)
def test_relation_union_sgb_identical(tasks, ds, kind, layout, max_degree):
    """RGAT's relation graphs and Simple-HGN's union graphs, table for
    table, with their grouped (8, 8) layouts and K1/K2 metadata; the
    ``max_degree=16`` case down-samples over-full rows (the cap's RNG)."""
    jt, tt = tasks(ds, "default")
    bucket_sizes = J_BUCKETS if layout == "default" else None
    kw = dict(max_degree=max_degree, seed=0, bucket_sizes=bucket_sizes)
    jsgs, tsgs = _build(jhg, jt.graph, kind, **kw), _build(thg, tt.graph, kind, **kw)
    _sgs_identical(jsgs, tsgs, layout)
    for js, ts in zip(jsgs, tsgs):
        assert js.num_edge_types == ts.num_edge_types, js.name
    if kind == "union":
        assert tsgs[0].num_edge_types == len(tt.graph.relations) + 1
    if max_degree == 16 and layout is None:
        uncapped = _build(thg, tt.graph, kind, max_degree=None, seed=0, bucket_sizes=None)
        assert any(sg.nbr_idx.shape[1] > 16 for sg in uncapped), "cap not hit"
    if layout is None:
        return
    for js, ts in zip(jsgs, tsgs):
        jl, tl = js.grouped(8, 8), ts.grouped(8, 8)
        for f in GROUPED_FIELDS:
            _eq(getattr(jl, f), getattr(tl, f), f"{js.name}.grouped.{f}")
        for a, b in zip(jops.grouped_meta(jl, 8), tops.grouped_meta(tl, 8)):
            _eq(a, b, f"{js.name} meta")


def _build_kind(hg, g, kind, ds, **kw):
    if kind == "metapath":
        from repro_torch.data.synthetic import METAPATHS

        return hg.build_metapath_graphs(g, METAPATHS[ds], **kw)
    return _build(hg, g, kind, **kw)


@pytest.mark.parametrize("max_degree", (256, 64, None), ids=("cap256", "cap64", "uncapped"))
@pytest.mark.parametrize("kind", ("metapath", "relation", "union"))
@pytest.mark.parametrize("ds", DATASETS)
def test_auto_sgb_identical(tasks, ds, kind, max_degree):
    """``bucket_sizes="auto"``: the autotuned capacities, the bucket
    tables, the grouped (8, 8) layouts and their K1/K2 metadata at K = 8,
    array for array."""
    jt, tt = tasks(ds, "default")
    kw = dict(max_degree=max_degree, seed=0, bucket_sizes="auto")
    jsgs, tsgs = _build_kind(jhg, jt.graph, kind, ds, **kw), _build_kind(thg, tt.graph, kind, ds, **kw)
    _sgs_identical(jsgs, tsgs, "auto")
    for js, ts in zip(jsgs, tsgs):
        caps = thg.autotune_bucket_sizes(ts.degrees())
        assert caps == jhg.autotune_bucket_sizes(js.degrees()), js.name
        assert ts.bucket_capacities == tuple(c for c in caps if 0 < c < caps[-1]) + (caps[-1],), js.name
        jl, tl = js.grouped(8, 8), ts.grouped(8, 8)
        assert (jl.num_rows, jl.num_steps) == (tl.num_rows, tl.num_steps), js.name
        for f in GROUPED_FIELDS:
            _eq(getattr(jl, f), getattr(tl, f), f"{js.name}.grouped.{f}")
        for a, b in zip(jops.grouped_meta(jl, 8), tops.grouped_meta(tl, 8)):
            _eq(a, b, f"{js.name} meta")


def test_unknown_bucket_sizes_spec_raises():
    nbr = np.zeros((3, 4), np.int32)
    msk = np.ones((3, 4), bool)
    for hg in (jhg, thg):
        with pytest.raises(ValueError, match="unknown bucket_sizes spec 'best'"):
            hg.bucketize("g", ("x",), "x", nbr, msk, nbr, "best")


@pytest.mark.parametrize("bucket_sizes", ("default", "auto"))
@pytest.mark.parametrize("kind", ("metapath", "relation", "union"))
@pytest.mark.parametrize("ds", DATASETS)
def test_flat_views_and_statistics_identical(tasks, ds, kind, bucket_sizes):
    """``to_flat``, the bucketed graph's flat views and its statistics, and
    the flat graph's ``max_degree``, against the reference's; ``to_flat``
    is edge for edge the flat build of the same graph; ``total_nodes``."""
    jt, tt = tasks(ds, "default")
    assert tt.graph.total_nodes == jt.graph.total_nodes == tt.batch.total_nodes
    sizes = T_BUCKETS if bucket_sizes == "default" else "auto"
    kw = dict(max_degree=256, seed=0)
    jsgs = _build_kind(jhg, jt.graph, kind, ds, bucket_sizes=sizes, **kw)
    tsgs = _build_kind(thg, tt.graph, kind, ds, bucket_sizes=sizes, **kw)
    flats = _build_kind(thg, tt.graph, kind, ds, bucket_sizes=None, **kw)
    for js, ts, tf in zip(jsgs, tsgs, flats):
        what = js.name
        jflat, tflat = js.to_flat(), ts.to_flat()
        assert type(tflat) is thg.SemanticGraph, what
        assert tflat.max_degree == jflat.max_degree == ts.max_degree == js.max_degree, what
        assert tflat.num_edge_types == ts.num_edge_types, what
        for f in ("nbr_idx", "nbr_mask", "edge_type"):
            _eq(getattr(jflat, f), getattr(tflat, f), f"{what}.to_flat.{f}")
            _eq(getattr(js, f), getattr(ts, f), f"{what}.{f} view")
            assert getattr(ts, f) is getattr(tflat, f), f"{what}.{f}: the flat view is not cached"
            # max_degree=256 caps the flat build as it caps the buckets
            _eq(getattr(tf, f), getattr(tflat, f), f"{what}.{f} vs the flat build")
        assert tf.max_degree == tflat.max_degree
        _eq(js.degrees(), ts.degrees(), f"{what}.degrees")
        _eq(ts.degrees(), tflat.degrees().astype(np.int64), f"{what}.degrees flat")
        assert (ts.num_edges, ts.padded_slots()) == (js.num_edges, js.padded_slots()), what
        assert tflat.padded_slots() == tflat.num_targets * tflat.max_degree >= ts.padded_slots(), what
