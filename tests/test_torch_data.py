"""Port parity: the SGB options and on-disk data against the reference.

``repro_torch.core.hetgraph.autotune_bucket_sizes``,
``repro_torch.data.datasets`` and ``repro_torch.data.sgb_cache`` are held
to ``repro``'s:

  * the autotuned capacities on random degree histograms (hypothesis),
    with ``max_buckets``, ``round_to`` and ``launch_cost``;
  * dataset dumps round-trip in npz and csv, each package reads the
    other's dumps, and a malformed dump raises the reference's error;
    ``resolve`` takes a name, a dump or a ``HetGraph`` and refuses a dump
    shadowed by a registered name, as the reference does;
  * the SGB cache computes the reference's key and writes the reference's
    entry, array for array and meta for meta, and each package loads the
    other's entries; a reference entry with sharded splits loads and is
    left untouched; hit equals miss, a corrupt entry is rebuilt, a flat
    build is not cached, ``$REPRO_SGB_CACHE`` is honoured;
  * ``prepare`` from a dump, a ``HetGraph`` with ``metapaths=``,
    ``bucket_sizes="auto"`` and a cache directory gives the reference's
    logits (1e-5) for HAN, RGAT and Simple-HGN under ``staged`` and
    ``fused_kernel`` (the plain versions on the CPU), with warnings as
    errors: a cache hit's read-only arrays never reach ``torch.from_numpy``.

The ``cuda``-marked test serves a cache-hit task (mmap-backed tables) with
all-bfloat16 parameters on the card; it skips without one.
"""
import gc
import hashlib
import json
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import hetgraph as thg  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402
from repro_torch.data import datasets as tds  # noqa: E402
from repro_torch.data import sgb_cache as tcache  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

SCALE = 0.05
MODELS = ("han", "rgat", "simple_hgn")
# model -> the dataset its logits depend on every NA of (HAN on DBLP, the
# reference's first HAN task; RGAT and Simple-HGN on ACM and IMDB)
MODEL_DS = {"han": "dblp", "rgat": "imdb", "simple_hgn": "acm"}
GROUPED_FIELDS = tcache._GROUPED_ARRAYS


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
def ref():
    """The reference's modules (imported only where a test compares)."""
    pytest.importorskip("jax")
    from repro.core import hetgraph
    from repro.core import pipeline
    from repro.data import datasets, sgb_cache

    class Ref:
        pass

    r = Ref()
    r.hetgraph, r.pipeline, r.datasets, r.sgb_cache = hetgraph, pipeline, datasets, sgb_cache
    return r


@pytest.fixture(scope="module")
def graphs(ref):
    """dataset -> (reference graph, port graph) at ``SCALE``, built once."""
    return {
        ds: (ref.datasets.resolve(ds, scale=SCALE, seed=0)[0], tds.resolve(ds, scale=SCALE, seed=0)[0])
        for ds in ("acm", "imdb", "dblp")
    }


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _graphs_equal(a, b):
    assert a.node_types == b.node_types
    assert a.num_nodes == b.num_nodes
    assert a.relations == b.relations
    assert (a.label_type, a.num_classes) == (b.label_type, b.num_classes)
    _eq(a.labels, b.labels, "labels")
    for t in a.node_types:
        _eq(a.features[t], b.features[t], f"features[{t}]")
    assert list(a.edges) == list(b.edges)
    for rel in a.edges:
        _eq(a.edges[rel][0], b.edges[rel][0], f"{rel} src")
        _eq(a.edges[rel][1], b.edges[rel][1], f"{rel} dst")


def _sgs_equal(a, b):
    """Two SGB stacks (lists or union dicts), bucket tables and grouped
    (8, 8) layouts, array for array."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        a, b = list(a.values()), list(b.values())
    assert [sg.name for sg in a] == [sg.name for sg in b]
    for x, y in zip(a, b):
        assert (x.src_types, x.dst_type, x.num_targets, x.num_edge_types) == (
            y.src_types, y.dst_type, y.num_targets, y.num_edge_types), x.name
        assert x.bucket_capacities == y.bucket_capacities, x.name
        for i, (bx, by) in enumerate(zip(x.buckets, y.buckets)):
            for f in ("targets", "nbr_idx", "nbr_mask", "edge_type"):
                _eq(getattr(bx, f), getattr(by, f), f"{x.name}.b{i}.{f}")
        _eq(x.target_perm(), y.target_perm(), f"{x.name}.perm")
        lx, ly = x.grouped(8, 8), y.grouped(8, 8)
        assert (lx.t_tile, lx.w, lx.num_rows) == (ly.t_tile, ly.w, ly.num_rows), x.name
        for f in GROUPED_FIELDS:
            _eq(getattr(lx, f), getattr(ly, f), f"{x.name}.grouped.{f}")


# ---------------------------------------------------------------------------
# autotune_bucket_sizes
# ---------------------------------------------------------------------------


@settings(max_examples=80, deadline=None, database=None)
@given(
    degrees=st.lists(st.integers(0, 300), min_size=0, max_size=400),
    max_buckets=st.integers(1, 6),
    round_to=st.sampled_from((1, 2, 8, 32)),
    launch_cost=st.sampled_from((0.0, 1.0, 37.5, 1e4)),
)
def test_autotune_matches_reference(degrees, max_buckets, round_to, launch_cost):
    pytest.importorskip("jax")
    from repro.core import hetgraph as jhg

    deg = np.asarray(degrees, np.int64)
    kw = dict(max_buckets=max_buckets, round_to=round_to, launch_cost=launch_cost)
    got = thg.autotune_bucket_sizes(deg, **kw)
    assert got == jhg.autotune_bucket_sizes(deg, **kw)
    assert all(type(c) is int for c in got)
    assert len(got) <= max(max_buckets, 1) or (launch_cost == 0.0 and len(set(deg.tolist())) <= max_buckets)


@pytest.mark.parametrize("degrees,kw,want", (
    ([], {}, (1,)),
    ([0, 0, 0], {}, (1,)),
    ([3, 1, 3, 7], {}, (1, 3, 7)),
    ([1] * 50 + [2] * 50 + [3] * 50 + [100] * 2 + [120], {"max_buckets": 2}, (3, 120)),
    # ties in the DP: argmin keeps the first (lowest) split
    ([1, 2, 3, 4], {"max_buckets": 2}, (2, 4)),
    ([1, 2, 3, 4], {"max_buckets": 2, "launch_cost": 100.0}, (4,)),
    # padded to 8: (1, 17) costs 8 + 2 x 24, (9, 17) 2 x 16 + 24, a tie
    ([1, 9, 17], {"max_buckets": 2, "round_to": 8}, (1, 17)),
    ([1, 9, 10, 17], {"max_buckets": 2, "round_to": 8}, (10, 17)),
))
def test_autotune_cases(ref, degrees, kw, want):
    assert thg.autotune_bucket_sizes(np.asarray(degrees), **kw) == want
    assert ref.hetgraph.autotune_bucket_sizes(np.asarray(degrees), **kw) == want


# ---------------------------------------------------------------------------
# dataset dumps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("edge_format,feature_format", (("npz", "npz"), ("csv", "npz"), ("npz", "csv"), ("csv", "csv")))
@pytest.mark.parametrize("ds", ("acm", "imdb", "dblp"))
def test_dump_round_trip_across_packages(tmp_path, ref, graphs, ds, edge_format, feature_format):
    """A dump the port writes equals the reference's dump file for file
    (meta.json byte for byte, arrays array for array); each package loads
    the other's dump into the registry graph."""
    jg, tg = graphs[ds]
    mps = tsyn.METAPATHS[ds]
    fmt = dict(edge_format=edge_format, feature_format=feature_format)
    tdir = tds.save_hetgraph(tg, tmp_path / "port", name=ds, metapaths=mps, **fmt)
    jdir = ref.datasets.save_hetgraph(jg, tmp_path / "ref", name=ds, metapaths=mps, **fmt)
    tfiles = sorted(p.relative_to(tdir).as_posix() for p in tdir.rglob("*") if p.is_file())
    jfiles = sorted(p.relative_to(jdir).as_posix() for p in jdir.rglob("*") if p.is_file())
    assert tfiles == jfiles
    for name in tfiles:
        a, b = tdir / name, jdir / name
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files, name
                for k in za.files:
                    _eq(za[k], zb[k], f"{name}:{k}")
        elif name.endswith(".npy"):
            _eq(np.load(a), np.load(b), name)
        else:
            assert a.read_bytes() == b.read_bytes(), name
    assert tds.read_meta(tdir)["metapaths"] == {k: list(v) for k, v in mps.items()}
    _graphs_equal(tds.load_hetgraph(jdir), tg)
    _graphs_equal(ref.datasets.load_hetgraph(tdir), jg)
    _graphs_equal(tds.load_hetgraph(tdir), tg)


def test_reexport_other_format_not_shadowed(tmp_path, graphs):
    _, g = graphs["imdb"]
    d = tmp_path / "d"
    tds.save_hetgraph(g, d, edge_format="csv", feature_format="csv")
    tds.save_hetgraph(g, d)
    assert not (d / "edges").exists() and not (d / "features").exists()
    _graphs_equal(tds.load_hetgraph(d), g)
    tds.save_hetgraph(g, d, edge_format="csv", feature_format="csv")
    assert not (d / "edges.npz").exists() and not (d / "features.npz").exists()
    _graphs_equal(tds.load_hetgraph(d), g)


def _malformed(d, case, g, save):
    save(g, d)
    meta = json.loads((d / "meta.json").read_text())
    if case == "no_meta":
        (d / "meta.json").unlink()
    elif case == "bad_json":
        (d / "meta.json").write_text("{not json")
    elif case == "bad_version":
        (d / "meta.json").write_text(json.dumps(dict(meta, format_version=2)))
    elif case.startswith("missing_"):
        key = case.removeprefix("missing_")
        (d / "meta.json").write_text(json.dumps({k: v for k, v in meta.items() if k != key}))
    elif case == "bad_edge_format":
        (d / "meta.json").write_text(json.dumps(dict(meta, edge_format="parquet")))
    elif case == "no_labels":
        (d / "labels.npy").unlink()
    elif case == "no_features":
        (d / "features.npz").unlink()
    elif case == "no_edges":
        (d / "edges.npz").unlink()
    elif case == "edge_arrays":
        with np.load(d / "edges.npz") as z:
            arrs = {k: z[k] for k in z.files if not k.startswith(g.relations[0][1] + "__")}
        np.savez(d / "edges.npz", **arrs)
    elif case == "feature_table":
        with np.load(d / "features.npz") as z:
            arrs = {k: z[k] for k in z.files if k != g.node_types[0]}
        np.savez(d / "features.npz", **arrs)
    elif case == "out_of_range":
        with np.load(d / "edges.npz") as z:
            arrs = {k: z[k] for k in z.files}
        key = g.relations[0][1] + "__src"
        arrs[key] = arrs[key] + 10**6
        np.savez(d / "edges.npz", **arrs)
    elif case == "csv_missing":
        save(g, d, edge_format="csv")
        (d / "edges" / f"{g.relations[0][1]}.csv").unlink()


MALFORMED = ("no_meta", "bad_json", "bad_version", "missing_node_types", "missing_num_classes",
             "bad_edge_format", "no_labels", "no_features", "no_edges", "edge_arrays", "feature_table",
             "out_of_range", "csv_missing")


@pytest.mark.parametrize("case", MALFORMED)
def test_malformed_dump_raises_reference_error(tmp_path, ref, graphs, case):
    """A malformed dump raises ``ValueError`` with the reference's message
    in both packages, at ingestion."""
    jg, tg = graphs["acm"]
    _malformed(tmp_path / "t", case, tg, tds.save_hetgraph)
    _malformed(tmp_path / "j", case, jg, ref.datasets.save_hetgraph)
    msgs = []
    for mod, d in ((tds, tmp_path / "t"), (ref.datasets, tmp_path / "j")):
        with pytest.raises(ValueError) as e:
            mod.load_hetgraph(d)
        msgs.append(str(e.value).replace(str(d), "<dump>"))
    assert msgs[0] == msgs[1]


def test_resolve_name_dump_hetgraph_and_collision(tmp_path, monkeypatch, graphs):
    _, g = graphs["acm"]
    got, name, mps = tds.resolve("acm", scale=SCALE, seed=0)
    _graphs_equal(got, g)
    assert (name, mps) == ("acm", tsyn.METAPATHS["acm"])
    d = tds.save_hetgraph(g, tmp_path / "dumped", name="acm-dump", metapaths=tsyn.METAPATHS["acm"])
    got, name, mps = tds.resolve(d)
    _graphs_equal(got, g)
    assert name == "acm-dump" and mps == {k: list(v) for k, v in tsyn.METAPATHS["acm"].items()}
    assert tds.resolve(g) == (g, "hetgraph", None)
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.resolve(str(tmp_path / "nowhere"))
    monkeypatch.chdir(tmp_path)
    tds.save_hetgraph(g, tmp_path / "acm")
    with pytest.raises(ValueError, match="both a registered generator and an on-disk dump"):
        tds.resolve("acm")
    _graphs_equal(tds.resolve(os.path.join(".", "acm"))[0], g)


def test_register_and_available(ref):
    assert tds.available() == ref.datasets.available() == ("acm", "dblp", "imdb")
    from repro_torch.core import models as tmodels

    assert tmodels.available() == ("han", "rgat", "simple_hgn")
    assert [tmodels.get_entry(m).needs_metapaths for m in MODELS] == [True, False, False]
    tds.register("tiny", lambda scale, seed: tsyn.make_imdb(scale=0.02, seed=seed))
    try:
        assert "tiny" in tds.available()
        assert tds.resolve("tiny", seed=1)[0].num_nodes == tsyn.make_imdb(scale=0.02, seed=1).num_nodes
    finally:
        tds.REGISTRY.pop("tiny")


# ---------------------------------------------------------------------------
# the SGB artifact cache
# ---------------------------------------------------------------------------

KEY_CASES = (
    ("metapath", dict(max_degree=256, bucket_sizes=(8, 32, 128))),
    ("metapath", dict(max_degree=None, bucket_sizes="auto")),
    ("relation", dict(max_degree=64, bucket_sizes="auto", seed=3)),
    ("relation", dict(max_degree=256, bucket_sizes=[2, 8, 32])),
    ("union", dict(max_degree=256, bucket_sizes="auto", t_tile=16, w=4)),
    ("union", dict(max_degree=None, bucket_sizes=None)),
)


@pytest.mark.parametrize("kind,kw", KEY_CASES)
@pytest.mark.parametrize("ds", ("acm", "imdb", "dblp"))
def test_cache_key_matches_reference(ref, graphs, ds, kind, kw):
    jg, tg = graphs[ds]
    mps = tsyn.METAPATHS[ds] if kind == "metapath" else None
    assert tcache.structure_hash(tg) == ref.sgb_cache.structure_hash(jg)
    assert tcache.cache_key(tg, kind, metapaths=mps, **kw) == ref.sgb_cache.cache_key(jg, kind, metapaths=mps, **kw)
    assert tcache._tile_constants() == ref.sgb_cache._tile_constants() == (8, 8)
    assert tcache.default_cache_dir() == ref.sgb_cache.default_cache_dir()


def test_fingerprint_ignores_features_and_tracks_edges(graphs):
    import dataclasses

    _, g = graphs["imdb"]
    feats = {t: f + 1.0 for t, f in g.features.items()}
    assert tcache.graph_fingerprint(dataclasses.replace(g, features=feats)) == tcache.graph_fingerprint(g)
    rel = g.relations[0][1]
    src, dst = g.edges[rel]
    edges = dict(g.edges, **{rel: (src[:-1], dst[:-1])})
    assert tcache.graph_fingerprint(dataclasses.replace(g, edges=edges)) != tcache.graph_fingerprint(g)


def _entry_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind,max_degree,sizes", (
    ("metapath", 256, "auto"), ("relation", 64, "auto"), ("union", 256, (8, 32, 128)),
))
@pytest.mark.parametrize("ds", ("acm", "imdb", "dblp"))
def test_cache_entry_matches_reference(tmp_path, ref, graphs, ds, kind, max_degree, sizes):
    """One graph and one set of build arguments: both packages write an
    entry under the same name, with the same members array for array
    (the embedded meta byte for byte); each loads the other's entry."""
    jg, tg = graphs[ds]
    kw = dict(metapaths=tsyn.METAPATHS[ds] if kind == "metapath" else None, max_degree=max_degree,
              seed=0, bucket_sizes=sizes)
    tout, ts = tcache.build_or_load(tg, kind, cache_dir=tmp_path / "port", **kw)
    jout, js = ref.sgb_cache.build_or_load(jg, kind, cache_dir=tmp_path / "ref", **kw)
    assert (ts, js) == ("miss", "miss")
    tfiles = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert tfiles == sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert tfiles == [f"sgb_{tcache.cache_key(tg, kind, **kw)}.npz"]
    ta, ja = _entry_arrays(tmp_path / "port" / tfiles[0]), _entry_arrays(tmp_path / "ref" / tfiles[0])
    assert list(ta) == list(ja)
    for k in ta:
        _eq(ta[k], ja[k], f"entry member {k}")
    assert json.loads(bytes(ta["__meta__"]).decode()) == json.loads(bytes(ja["__meta__"]).decode())
    _sgs_equal(jout, tout)
    # each package loads the other's entry: a hit, the same stacks
    t_hit, st_ = tcache.build_or_load(tg, kind, cache_dir=tmp_path / "ref", **kw)
    j_hit, sj = ref.sgb_cache.build_or_load(jg, kind, cache_dir=tmp_path / "port", **kw)
    assert (st_, sj) == ("hit", "hit")
    _sgs_equal(jout, t_hit)
    _sgs_equal(j_hit, tout)


def test_reference_sharded_entry_loads_untouched(tmp_path, ref, graphs):
    """An entry the reference wrote with sharded splits: the port loads its
    buckets and grouped layout (a hit, equal to its own build) and its
    2-way splits (equal to the port's own split of its build, array for
    array), and leaves the file as it was, asked for that split or for
    none."""
    jg, tg = graphs["acm"]
    kw = dict(max_degree=256, seed=0, bucket_sizes="auto")
    _, s = ref.sgb_cache.build_or_load(jg, "relation", cache_dir=tmp_path, shards=2, **kw)
    assert s == "miss"
    (path,) = list(tmp_path.iterdir())
    meta = json.loads(bytes(_entry_arrays(path)["__meta__"]).decode())
    assert meta["shards"] == [2] and all("sharded" in m for m in meta["sgs"])
    before = (hashlib.sha256(path.read_bytes()).hexdigest(), path.stat().st_mtime_ns)
    own = thg.build_relation_graphs(tg, **kw)
    for shards in (0, 2):
        got, s = tcache.build_or_load(tg, "relation", cache_dir=tmp_path, shards=shards, **kw)
        assert s == "hit"
        _sgs_equal(got, own)
        for sg, osg in zip(got, own):
            assert list(sg._sharded) == [(2, 8, 8)]
            sl, want = sg._sharded[(2, 8, 8)], osg.sharded(2)
            assert (sl.num_rows_alloc, sl.num_steps_max) == (want.num_rows_alloc, want.num_steps_max)
            assert sl.perm.dtype == want.perm.dtype and np.array_equal(sl.perm, want.perm)
            for a, b in zip(sl.shards, want.shards):
                assert a.num_rows == b.num_rows
                for f in GROUPED_FIELDS:
                    x, y = getattr(a, f), getattr(b, f)
                    assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (hashlib.sha256(path.read_bytes()).hexdigest(), path.stat().st_mtime_ns) == before
    assert list(tmp_path.iterdir()) == [path]


@pytest.mark.parametrize("kind", ("metapath", "relation", "union"))
def test_cache_hit_equals_miss(tmp_path, graphs, kind):
    _, g = graphs["imdb"]
    kw = dict(metapaths=tsyn.METAPATHS["imdb"] if kind == "metapath" else None, max_degree=256, seed=0,
              bucket_sizes="auto")
    miss, s1 = tcache.build_or_load(g, kind, cache_dir=tmp_path, **kw)
    (path,) = list(tmp_path.iterdir())
    mtime = path.stat().st_mtime_ns
    hit, s2 = tcache.build_or_load(g, kind, cache_dir=tmp_path, **kw)
    assert (s1, s2) == ("miss", "hit")
    assert type(hit) is type(miss)
    _sgs_equal(miss, hit)
    sgs = list(hit.values()) if isinstance(hit, dict) else hit
    # a hit hands out read-only views into the mapped entry, with the
    # grouped layout injected, and is never written back
    assert not sgs[0].buckets[0].nbr_idx.flags.writeable
    assert (8, 8) in sgs[0]._grouped
    assert path.stat().st_mtime_ns == mtime


def test_cache_corrupt_entry_rebuilt(tmp_path, graphs):
    _, g = graphs["acm"]
    kw = dict(max_degree=256, seed=0, bucket_sizes="auto")
    built, _ = tcache.build_or_load(g, "union", cache_dir=tmp_path, **kw)
    (path,) = list(tmp_path.iterdir())
    path.write_bytes(b"PK\x03\x04 torn")
    again, s = tcache.build_or_load(g, "union", cache_dir=tmp_path, **kw)
    assert s == "miss"
    _sgs_equal(built, again)
    hit, s = tcache.build_or_load(g, "union", cache_dir=tmp_path, **kw)
    assert s == "hit"
    _sgs_equal(built, hit)


def test_cache_flat_build_off_and_env_var(tmp_path, monkeypatch, graphs):
    _, g = graphs["acm"]
    out, s = tcache.build_or_load(g, "relation", cache_dir=tmp_path, max_degree=256, bucket_sizes=None)
    assert s == "off" and all(type(sg) is thg.SemanticGraph for sg in out)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.delenv("REPRO_SGB_CACHE", raising=False)
    assert tcache.build_or_load(g, "relation", max_degree=256, bucket_sizes="auto")[1] == "off"
    env = tmp_path / "env"
    monkeypatch.setenv("REPRO_SGB_CACHE", str(env))
    assert tcache.default_cache_dir() == env
    assert tcache.build_or_load(g, "relation", max_degree=256, bucket_sizes="auto")[1] == "miss"
    assert tcache.build_or_load(g, "relation", max_degree=256, bucket_sizes="auto")[1] == "hit"
    assert len(list(env.iterdir())) == 1


def test_open_mmap_arrays(tmp_path, graphs):
    _, g = graphs["imdb"]
    d = tds.save_hetgraph(g, tmp_path / "d")
    views = tcache.open_mmap_arrays(d / "features.npz")
    for t in g.node_types:
        _eq(views[t], g.features[t], t)
        assert not views[t].flags.writeable
    np.savez_compressed(tmp_path / "c.npz", a=np.arange(5))
    _eq(tcache.open_mmap_arrays(tmp_path / "c.npz")["a"], np.arange(5), "compressed")


# ---------------------------------------------------------------------------
# prepare from a dump, a HetGraph, "auto" and the cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dumps(tmp_path_factory, graphs):
    """dataset -> a dump of its port graph (npz, with metapaths)."""
    root = tmp_path_factory.mktemp("dumps")
    return {
        ds: tds.save_hetgraph(tg, root / ds, name=ds, metapaths=tsyn.METAPATHS[ds])
        for ds, (_, tg) in graphs.items()
    }


def _convert(jt, tt):
    import jax

    from repro_torch.convert import params_from_reference

    return params_from_reference(jax.tree_util.tree_map(np.asarray, jt.params), device="cpu", model=tt.model)


@pytest.mark.parametrize("source", ("dump", "hetgraph"))
@pytest.mark.parametrize("model", MODELS)
def test_prepare_matches_reference(tmp_path, ref, graphs, dumps, model, source):
    """``prepare`` with ``"auto"`` and a cache directory, from a dump or
    from a ``HetGraph`` with ``metapaths=``: the reference's SGB and
    logits (1e-5) under ``staged`` and ``fused_kernel`` K = 4, on the miss
    and on the hit, with warnings as errors on the port's side."""
    from repro.core.flows import FlowConfig as JFlowConfig

    ds = MODEL_DS[model]
    jg, tg = graphs[ds]
    spec_t, spec_j = (dumps[ds], dumps[ds]) if source == "dump" else (tg, jg)
    kw = dict(seed=0, max_degree=256, bucket_sizes="auto")
    mps = tsyn.METAPATHS[ds] if source == "hetgraph" and model == "han" else None
    jt = ref.pipeline.prepare(model, spec_j, sgb_cache_dir=tmp_path / "ref", metapaths=mps, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        miss = tpipe.prepare(model, spec_t, sgb_cache_dir=tmp_path / "port", metapaths=mps, device="cpu", **kw)
        hit = tpipe.prepare(model, spec_t, sgb_cache_dir=tmp_path / "port", metapaths=mps, device="cpu", **kw)
    assert miss.name == hit.name == jt.name
    assert (miss.sgb_kind, miss.sgb_args, miss.metapaths) == (jt.sgb_kind, jt.sgb_args, jt.metapaths)
    _sgs_equal(jt.sgs, miss.sgs)
    _sgs_equal(miss.sgs, hit.sgs)
    assert not hit.sgs[0].buckets[0].nbr_idx.flags.writeable
    params = _convert(jt, miss)
    for flow, k in (("staged", None), ("fused_kernel", 4)):
        want = np.asarray(jt.model.apply(jt.params, jt.batch, JFlowConfig(flow, prune_k=k)))
        cfg = FlowConfig(flow, prune_k=k)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            outs = [t.compile(cfg)(params).numpy() for t in (miss, hit)]
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_allclose(outs[0], want, atol=1e-5, rtol=0)
        # the same route on the loop dispatch, over the hit's mapped tables
        loop = hit.compile(FlowConfig(flow, prune_k=k, bucket_dispatch="loop"))(params).numpy()
        np.testing.assert_allclose(loop, want, atol=1e-5, rtol=0)


def test_prepare_han_hetgraph_needs_metapaths(graphs):
    _, g = graphs["acm"]
    with pytest.raises(ValueError, match="needs metapaths for dataset 'hetgraph'"):
        tpipe.prepare("han", g, device="cpu")


def test_prepare_cache_hit_tensors_own_their_memory(tmp_path):
    """A cache hit's tables are read-only views into the mapped entry; no
    device mirror (CPU tensors included) shares memory with them."""
    kw = dict(scale=SCALE, seed=0, bucket_sizes="auto", sgb_cache_dir=tmp_path, device="cpu")
    tpipe.prepare("simple_hgn", "imdb", **kw)
    task = tpipe.prepare("simple_hgn", "imdb", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for flow in (FlowConfig("staged"), FlowConfig("fused_kernel", prune_k=4),
                     FlowConfig("fused_kernel", prune_k=4, bucket_dispatch="loop")):
            task.compile(flow)(task.params)
    spans = []
    for sg in task.sgs:
        for b in sg.buckets:
            for a in (b.targets, b.nbr_idx, b.nbr_mask, b.edge_type):
                assert not a.flags.writeable
                lo = a.__array_interface__["data"][0]
                spans.append((lo, lo + a.nbytes))
        spans += [(a.__array_interface__["data"][0], a.__array_interface__["data"][0] + a.nbytes)
                  for a in (getattr(sg.grouped(8, 8), f) for f in GROUPED_FIELDS)]
    tensors = [t for sg in task.sgs for v in sg._device.values() for t in _flatten(v)]
    tensors += [t for sg in task.sgs for v in sg.grouped(8, 8)._dev.values() for t in _flatten(v)]
    assert tensors
    for t in tensors:
        p = t.data_ptr()
        assert not any(lo <= p < hi for lo, hi in spans), "a tensor shares memory with the mapped entry"


def _flatten(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _flatten(x)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model,ds", (("han", "acm"), ("simple_hgn", "imdb")))
def test_cuda_cache_hit_bf16_params_served(tmp_path, cuda_device, model, ds):
    """A cache-hit task (mmap-backed tables) served on the card with every
    parameter in bfloat16: a captured ``fused_kernel`` session whose
    logits are within 1e-4 of the CPU's and whose accuracy counts the
    CPU's rows right, on the grouped and the loop dispatch."""
    kw = dict(scale=SCALE, seed=0, bucket_sizes="auto", sgb_cache_dir=tmp_path)
    tpipe.prepare(model, ds, device="cpu", **kw)
    gpu = tpipe.prepare(model, ds, device=cuda_device, **kw)
    cpu = tpipe.prepare(model, ds, device="cpu", **kw)
    assert not gpu.sgs[0].buckets[0].nbr_idx.flags.writeable
    p_gpu = {n: p.to(torch.bfloat16) for n, p in gpu.params.items()}
    p_cpu = {n: p.to(torch.bfloat16) for n, p in cpu.params.items()}
    for dispatch in ("single", "loop"):
        flow = FlowConfig("fused_kernel", prune_k=8, bucket_dispatch=dispatch)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sess = gpu.compile(flow, params=p_gpu)
            got = sess(p_gpu)
        assert sess.captured and got.dtype == torch.float32
        want = cpu.compile(flow, params=p_cpu)(p_cpu)
        assert float((got.cpu() - want).abs().max()) <= 1e-4
        # the same rows right (a mean on the card may round an ulp apart)
        n = len(gpu.splits["test"])
        assert round(tpipe.accuracy(gpu, p_gpu, flow) * n) == round(tpipe.accuracy(cpu, p_cpu, flow) * n)
