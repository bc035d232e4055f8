"""The port's tracing (``repro_torch.trace``), the spans at its layer
boundaries, the NA slot counters, and the benchmark's readers of them.

On the CPU:

  * spans nest per thread (parents), cross threads without mixing, are
    recorded on and not off (build spans always), and are ranges of a
    ``torch`` profile while one records (a per-call span with tracing off
    that range alone); ``reset`` clears; the ring keeps the newest
    ``RING`` while the totals count every span;
  * ``prepare`` and ``compile`` on a small HAN task leave the build spans
    named and nested as ``core/pipeline.py`` and ``data/sgb_cache.py``
    document, with the SGB cache's status (miss, then hit);
  * 1,000 calls with tracing off take the untraced path and store no
    per-call span; on, every call stores its ``session.*`` spans; a
    recording profiler sees them as ranges with tracing off;
  * ``ops.NA_SLOTS`` and ``NA_SLOTS_BY_GRAPH`` (ticked by ``core/flows.py``)
    equal the arithmetic of the layouts the launches visit, on the grouped,
    per-bucket loop, flat and sharded dispatches, with ``prune_k=None``
    (``kept == valid``);
  * the benchmark's new readers give ``None`` on a CPU run and the
    program's numbers on a made-up card run.

The ``cuda``-marked tests skip without a card. On one: the warm-up and
capture spans with the kernel load and the device tables' upload inside,
every call's ``session.*`` spans, and, with device tracing, stages whose
device ms add up to the replay's within 5 % (without it ``stage_ms`` has
nothing to read).
"""
import importlib.util
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.core import flows, hetgraph  # noqa: E402
from repro_torch.core.attention import DecomposedScores  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PER_CALL = ("session.call", "session.check", "session.copy_in", "session.replay", "session.read_out")


@pytest.fixture(autouse=True)
def _fresh_trace():
    """Every test starts with tracing off, no spans and zero slot counters,
    and leaves it so."""
    def clear():
        trace.disable()
        trace.reset()
        for k in ops.NA_SLOTS:
            ops.NA_SLOTS[k] = 0
        ops.NA_SLOTS_BY_GRAPH.clear()

    clear()
    yield
    clear()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------


def test_spans_nest_and_total():
    trace.enable()
    with trace.span("a", x=1) as a:
        with trace.span("b"):
            pass
        with trace.span("b") as b2:
            b2.set(status="hit")
        a.set(y=2)
    got = _by_name(trace.spans())
    (sa,), (sb1, sb2) = got["a"], got["b"]
    assert sa.parent is None and sb1.parent == sa.id and sb2.parent == sa.id
    assert sa.attrs == {"x": 1, "y": 2} and sb2.attrs == {"status": "hit"}
    assert sa.start_ns <= sb1.start_ns <= sb1.end_ns <= sb2.start_ns <= sb2.end_ns <= sa.end_ns
    assert [s.name for s in trace.spans()] == ["b", "b", "a"]  # in closing order
    tot = trace.totals()
    assert tot["b"][0] == 2 and tot["a"][0] == 1
    assert tot["a"][1] >= tot["b"][1] >= 0 and tot["a"][1] == pytest.approx(sa.seconds)


def test_spans_across_threads_keep_their_own_parents():
    trace.enable()
    gate = threading.Barrier(2, timeout=30)

    def work(tag):
        with trace.span(f"outer.{tag}"):
            gate.wait()  # both outer spans are open at once
            with trace.span(f"inner.{tag}"):
                gate.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in trace.spans()}
    for tag in "xy":
        outer, inner = got[f"outer.{tag}"], got[f"inner.{tag}"]
        assert inner.parent == outer.id and outer.parent is None
        assert inner.thread == outer.thread
    assert got["outer.x"].thread != got["outer.y"].thread


def test_off_records_only_build_spans():
    assert not trace.enabled()
    with trace.span("per_call") as sp:
        sp.set(ignored=True)
    with trace.span("build", always=True):
        with trace.span("per_call_inside"):
            pass
    assert [s.name for s in trace.spans()] == ["build"] and set(trace.totals()) == {"build"}
    trace.enable()
    with trace.span("per_call"):
        pass
    trace.disable()
    with trace.span("per_call"):
        pass
    assert trace.totals()["per_call"][0] == 1


def test_reset_clears_spans_and_totals():
    with trace.span("x", always=True):
        pass
    trace.reset()
    assert trace.spans() == [] and trace.totals() == {}


def test_ring_keeps_the_newest_and_totals_count_all():
    trace.enable()
    for i in range(trace.RING + 10):
        with trace.span("tick", i=i):
            pass
    kept = trace.spans()
    assert len(kept) == trace.RING
    assert kept[0].attrs["i"] == 10 and kept[-1].attrs["i"] == trace.RING + 9
    assert trace.totals()["tick"][0] == trace.RING + 10


@pytest.mark.parametrize("on", (False, True))
def test_a_recording_profiler_sees_spans_as_ranges(on):
    """Under a profiler every span is a range of the profile; with
    tracing off a per-call span is that range alone, neither kept nor
    totalled, and a build span is still recorded."""
    from torch.profiler import ProfilerActivity, profile

    if on:
        trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled() is on
        with trace.span("prepare", always=True):
            with trace.span("session.call") as sp:
                sp.set(ignored=not on)
                with trace.span("session.check"):
                    torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"prepare", "session.call", "session.check"} <= names
    kept = ["session.check", "session.call", "prepare"] if on else ["prepare"]
    assert [s.name for s in trace.spans()] == kept and set(trace.totals()) == set(kept)


@pytest.mark.parametrize("value,want", (("1", "True"), ("0", "False")))
def test_environment_switch_at_import(value, want):
    code = "import repro_torch.trace as t; print(t.enabled())"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TORCH_TRACE=value)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == want


def test_marks_off_the_capture_record_nothing():
    trace.enable(device=True)
    with trace.stages_of_capture() as rec:
        trace.mark("project")  # not capturing: nothing recorded
    assert rec is not None and rec.marks == []
    trace.disable()
    with trace.stages_of_capture() as rec:
        assert rec is None
    trace.mark("project")


# ---------------------------------------------------------------------------
# spans at the layer boundaries
# ---------------------------------------------------------------------------


def test_build_spans_of_prepare_and_compile(tmp_path):
    for status in ("miss", "hit"):
        trace.reset()
        task = tpipe.prepare("han", "acm", scale=0.04, max_degree=48, seed=0, device="cpu",
                             sgb_cache_dir=tmp_path)
        task.compile(FlowConfig("fused_kernel", prune_k=8))
        spans = trace.spans()
        byid = {s.id: s for s in spans}
        got = _by_name(spans)
        (prep,), (sgb,), (comp,) = got["prepare"], got["sgb"], got["compile"]
        assert prep.parent is None and comp.parent is None and comp.attrs["flow"] == "fused_kernel"
        for name in ("prepare.resolve", "sgb", "model"):
            assert [byid[s.parent].name for s in got[name]] == ["prepare"], name
        (up,) = got["upload"]  # the features; NA's tables wait for a forward
        assert byid[up.parent].name == "prepare" and up.attrs["what"] == "features"
        assert up.attrs["bytes"] == sum(t.nbytes for t in task.batch.features.values())
        assert sgb.attrs == {"kind": "metapath", "status": status}
        under_sgb = [s.name for s in spans if s.parent == sgb.id]
        if status == "miss":
            assert under_sgb == ["sgb.fingerprint", "sgb.build", "sgb.save"]
            (build,) = got["sgb.build"]
            stages = [(s.name, s.attrs["graph"]) for s in spans if s.parent == build.id]
            assert stages == [("sgb.compose", "PAP"), ("sgb.pad", "PAP"), ("sgb.bucketize", "PAP"),
                              ("sgb.compose", "PSP"), ("sgb.pad", "PSP"), ("sgb.bucketize", "PSP"),
                              ("sgb.group", "PAP"), ("sgb.group", "PSP")]
        else:
            assert under_sgb == ["sgb.fingerprint", "sgb.load"]
        assert trace.totals()["sgb"][1] == pytest.approx(sgb.seconds)


def test_cache_off_is_one_build_span():
    hetgraph_g = tpipe.datasets.resolve("imdb", scale=0.04, seed=0)[0]
    from repro_torch.data import sgb_cache

    _, status = sgb_cache.build_or_load(hetgraph_g, "relation", max_degree=16, bucket_sizes=None)
    (sgb,) = [s for s in trace.spans() if s.name == "sgb"]
    assert status == "off" and sgb.attrs["status"] == "off"
    assert [s.name for s in trace.spans() if s.parent == sgb.id] == ["sgb.build"]


@pytest.fixture(scope="module")
def small_han():
    return tpipe.prepare("han", "acm", scale=0.02, max_degree=16, seed=0, device="cpu")


def test_per_call_spans_off_and_on(small_han, monkeypatch):
    # the session's span sites are the same on every flow: the cheapest one
    sess = small_han.compile(FlowConfig("staged", prune_k=4))
    params = small_han.params
    sess(params)  # the first forward fills NA's layouts (build spans)
    trace.reset()
    traced = type(sess)._run_traced

    def not_off(*a, **k):
        raise AssertionError("the traced path ran with tracing off")

    monkeypatch.setattr(type(sess), "_run_traced", not_off)  # off: one check, no span site
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: one thread is ~25x faster than many
    try:
        for _ in range(1000):
            sess(params)
    finally:
        torch.set_num_threads(threads)
    assert not any(s.name.startswith("session.") for s in trace.spans())
    assert not any(n.startswith("session.") for n in trace.totals())
    monkeypatch.setattr(type(sess), "_run_traced", traced)
    trace.enable()
    for _ in range(3):
        sess(params)
    sess.query(params, np.array([0, 1]))
    spans = trace.spans()
    calls = [s for s in spans if s.name == "session.call"]
    checks = [s for s in spans if s.name == "session.check"]
    assert len(calls) == len(checks) == 4
    assert [c.parent for c in checks] == [c.id for c in calls]
    # a CPU session runs the eager forward: no copy-in, replay or read-out
    assert {s.name for s in spans} == {"session.call", "session.check"}


def test_a_recording_profiler_names_the_calls_with_tracing_off(small_han):
    """Off, a profile still sees each call's ``session.*`` ranges, and
    nothing is kept."""
    from torch.profiler import ProfilerActivity, profile

    sess = small_han.compile(FlowConfig("staged", prune_k=4))
    sess(small_han.params)
    trace.reset()
    assert not trace.recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.recording()
        sess(small_han.params)
    names = [e.name for e in prof.events()]
    assert names.count("session.call") == 1 and names.count("session.check") == 1
    assert trace.spans() == [] and trace.totals() == {}


# ---------------------------------------------------------------------------
# NA slot counters
# ---------------------------------------------------------------------------


def _tile_degrees(layout):
    """Each held target's degree, read off the tile stack step by step."""
    deg = np.zeros(layout.num_rows, np.int64)
    for g in range(layout.num_steps):
        rows = layout.step_row[g] * layout.t_tile + np.arange(layout.t_tile)
        deg[rows] += layout.msk[g].sum(axis=1)
    return deg[layout.perm[layout.perm >= 0]]


def _expected(slots, deg, k):
    deg = np.asarray(deg, np.int64)
    kept = deg.sum() if k is None else np.minimum(deg, k).sum()
    bypass = deg.size if k is None else (deg <= k).sum()
    return {"slots": slots, "valid": int(deg.sum()), "kept": int(kept), "rows": deg.size,
            "bypass_rows": int(bypass)}


def _sum(counts):
    out = dict.fromkeys(ops.SLOT_FIELDS, 0)
    for c in counts:
        for k in out:
            out[k] += c[k]
    return out


def _forward(task, flow):
    with torch.inference_mode():
        return task.model.apply(task.params, task.batch, flow)


@pytest.mark.parametrize("prune_k", (None, 2, 8))
def test_na_slots_grouped(prune_k):
    task = tpipe.prepare("han", "acm", scale=0.04, max_degree=48, seed=0, device="cpu")
    _forward(task, FlowConfig("fused_kernel", prune_k=prune_k))
    want = {}
    for sg in task.sgs:
        lay = sg.grouped(ops.T_TILE, ops.W_TILE)
        want[sg.name] = _expected(lay.num_steps * lay.t_tile * lay.w, _tile_degrees(lay), prune_k)
        assert want[sg.name]["valid"] == int(lay.msk.sum())
    assert ops.NA_SLOTS_BY_GRAPH == want and ops.NA_SLOTS == _sum(want.values())
    if prune_k is None:
        assert ops.NA_SLOTS["kept"] == ops.NA_SLOTS["valid"]
        assert ops.NA_SLOTS["bypass_rows"] == ops.NA_SLOTS["rows"]
    # a second forward ticks them again: the ratio of two is one forward's
    _forward(task, FlowConfig("fused_kernel", prune_k=prune_k))
    assert ops.NA_SLOTS == {k: 2 * v for k, v in _sum(want.values()).items()}


@pytest.mark.parametrize("prune_k", (None, 8))
def test_na_slots_flat_and_loop(prune_k):
    """One flat launch per table wider than K (``prune_k=None``: every
    table), T × D slots each; the per-bucket loop the same per pruned
    bucket. Tables at most K wide take the plain bypass and count nothing."""
    flat = tpipe.prepare("han", "acm", scale=0.04, max_degree=48, seed=0, device="cpu", bucket_sizes=None)
    _forward(flat, FlowConfig("fused_kernel", prune_k=prune_k))
    want = {
        sg.name: _expected(sg.nbr_mask.size, sg.nbr_mask.sum(axis=1), prune_k)
        for sg in flat.sgs if prune_k is None or sg.max_degree > prune_k
    }
    assert want and ops.NA_SLOTS_BY_GRAPH == want and ops.NA_SLOTS == _sum(want.values())
    if prune_k is None:
        assert ops.NA_SLOTS["kept"] == ops.NA_SLOTS["valid"]

    for k in ops.NA_SLOTS:
        ops.NA_SLOTS[k] = 0
    ops.NA_SLOTS_BY_GRAPH.clear()
    task = tpipe.prepare("han", "acm", scale=0.04, max_degree=48, seed=0, device="cpu")
    _forward(task, FlowConfig("fused_kernel", prune_k=prune_k, bucket_dispatch="loop"))
    want = {}
    for sg in task.sgs:
        parts = [_expected(b.nbr_mask.size, b.nbr_mask.sum(axis=1), prune_k)
                 for b in sg.buckets if prune_k is None or b.capacity > prune_k]
        if parts:
            want[sg.name] = _sum(parts)
    assert want and ops.NA_SLOTS_BY_GRAPH == want and ops.NA_SLOTS == _sum(want.values())


def test_na_slots_other_flows_count_nothing():
    task = tpipe.prepare("han", "acm", scale=0.04, max_degree=48, seed=0, device="cpu")
    for flow in ("staged", "fused"):
        _forward(task, FlowConfig(flow, prune_k=8))
    assert not any(ops.NA_SLOTS.values()) and not ops.NA_SLOTS_BY_GRAPH


@pytest.mark.parametrize("prune_k", (None, 4))
@pytest.mark.parametrize("n", (2, 4))
def test_na_slots_sharded(monkeypatch, n, prune_k):
    """Each rank ticks its own shard's slots: over the ranks they add up to
    the single-device launch's, slots (every grid step once) included."""
    task = tpipe.prepare("rgat", "imdb", scale=0.04, max_degree=32, seed=0, bucket_sizes=(4, 8, 16),
                         device="cpu")
    sg = task.sgs[0]
    rank = {"r": 0}
    monkeypatch.setattr(flows, "_graph_mesh_once", lambda: (object(), "data", None))
    monkeypatch.setattr(ops.dist, "axis_size", lambda mesh, axis: n)
    monkeypatch.setattr(ops.dist, "shard_rank", lambda mesh, axis: rank["r"])
    monkeypatch.setattr(ops.dist, "replicate", lambda x, mesh, axis: torch.cat([x] * n))
    rng = np.random.default_rng(0)
    n_src = task.batch.total_nodes
    h = torch.from_numpy(rng.normal(size=(n_src, 4, 8)).astype(np.float32))
    ts = torch.from_numpy(rng.normal(size=(n_src, 4)).astype(np.float32))
    td = torch.from_numpy(rng.normal(size=(sg.num_targets, 4)).astype(np.float32))
    cfg = FlowConfig("fused_kernel", prune_k=prune_k)
    per_rank = []
    for r in range(n):
        rank["r"] = r
        before = dict(ops.NA_SLOTS)
        flows.run_aggregate_graph(cfg, h, DecomposedScores(ts, td), sg)
        per_rank.append({k: ops.NA_SLOTS[k] - before[k] for k in before})
        lay = sg.sharded(n).shards[r]
        if lay.num_steps:
            assert per_rank[-1] == _expected(lay.num_steps * lay.t_tile * lay.w, _tile_degrees(lay), prune_k)
    lay = sg.grouped(ops.T_TILE, ops.W_TILE)
    assert _sum(per_rank) == _expected(lay.num_steps * lay.t_tile * lay.w, _tile_degrees(lay), prune_k)
    assert ops.NA_SLOTS_BY_GRAPH == {sg.name: _sum(per_rank)}


def test_na_slots_empty_layout_counts_nothing():
    nbr = np.zeros((0, 4), np.int32)
    sg = hetgraph.bucketize("e", ("x",), "x", nbr, nbr.astype(bool), nbr, (2,))
    out = flows.run_aggregate_graph(FlowConfig("fused_kernel", prune_k=2), torch.zeros(3, 2, 4),
                                    DecomposedScores(torch.zeros(3, 2), torch.zeros(0, 2)), sg)
    assert out.shape == (0, 2, 4) and not any(ops.NA_SLOTS.values())


# ---------------------------------------------------------------------------
# the benchmark's readers of them
# ---------------------------------------------------------------------------


def _reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"test_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,span", (("sgb_s", "sgb"), ("upload_s", "upload"), ("warmup_s", "warmup")))
def test_span_readers(name, span):
    reader = _reader(name)
    assert reader.UNIT == "s"
    with trace.span(span, always=True):
        pass
    with trace.span(span, always=True):
        pass
    assert reader.read(types.SimpleNamespace(cuda=False)) is None
    assert reader.read(types.SimpleNamespace(cuda=True)) == pytest.approx(trace.totals()[span][1])
    trace.reset()
    assert reader.read(types.SimpleNamespace(cuda=True)) is None  # nothing recorded


def test_slot_use_reader():
    reader = _reader("na_slot_use_pct")
    assert reader.UNIT == "%"
    assert reader.read(types.SimpleNamespace(cuda=True)) is None  # no launch counted
    ops.NA_SLOTS.update(slots=400, valid=139, kept=80, rows=10, bypass_rows=3)
    assert reader.read(types.SimpleNamespace(cuda=False)) is None
    assert reader.read(types.SimpleNamespace(cuda=True)) == pytest.approx(34.75)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _cuda_task(dev, scale=0.04, max_degree=48):
    return tpipe.prepare("han", "acm", scale=scale, max_degree=max_degree, seed=0, device=dev)


@pytest.mark.cuda
def test_cuda_build_and_call_spans(cuda_device):
    task = _cuda_task(cuda_device)
    trace.reset()
    sess = task.compile(FlowConfig("fused_kernel", prune_k=8))
    spans = trace.spans()
    byid = {s.id: s for s in spans}
    got = _by_name(spans)
    (comp,), (warm,), (cap,) = got["compile"], got["warmup"], got["capture"]
    assert warm.parent == comp.id and cap.parent == comp.id and warm.end_ns <= cap.start_ns
    assert all(byid[s.parent].name == "warmup" for s in got.get("kernels.load", []))
    assert {s.attrs.get("status") for s in got.get("kernels.load", [])} <= {"built", "reused"}
    ups = got["upload"]
    assert ups and all(byid[s.parent].name == "warmup" for s in ups)
    assert sum(s.attrs.get("bytes", 0) for s in ups) > 0
    trace.enable()
    for _ in range(3):
        sess(task.params)
    torch.cuda.synchronize()
    per_call = [s for s in trace.spans() if s.name.startswith("session.")]
    assert [s.name for s in per_call].count("session.call") == 3
    calls = {s.id for s in per_call if s.name == "session.call"}
    for name in PER_CALL[1:]:
        parts = [s for s in per_call if s.name == name]
        assert len(parts) == 3 and {s.parent for s in parts} == calls, name


@pytest.mark.cuda
def test_cuda_device_stages_add_up_to_the_replay(cuda_device):
    """On HAN ACM at full scale with no degree cap (PSP 527 wide: a
    forward of some tenths of a ms), warm: the marked stages cover the
    replay but for the graph's launch and tail (a few µs), within 5 %, and
    with ``launch`` and ``tail`` exactly."""
    task = _cuda_task(cuda_device, scale=1.0, max_degree=None)
    flow = FlowConfig("fused_kernel", prune_k=8)
    plain = task.compile(flow)
    plain(task.params)
    assert trace.stage_ms(plain) is None  # captured without device tracing
    trace.enable(device=True)
    sess = tpipe.InferenceSession(task.model, task.batch, flow, params=task.params)
    assert trace.stage_ms(sess) is None  # not called yet
    for _ in range(3):
        out = sess(task.params)
    ms = trace.stage_ms(sess)
    stages = {k: v for k, v in ms.items() if k not in ("copy_in", "launch", "tail", "read_out", "replay")}
    assert set(stages) == {"project", "na.PAP", "na.PSP", "fuse", "readout"}
    assert all(v >= 0 for v in ms.values()) and ms["replay"] > 0
    assert sum(stages.values()) == pytest.approx(ms["replay"], rel=0.05)
    assert sum(stages.values()) + ms["launch"] + ms["tail"] == pytest.approx(ms["replay"], rel=1e-3)
    assert torch.equal(out, plain(task.params))  # the marks change no result
