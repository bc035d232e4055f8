"""One run of one cell: set-up, the measured (or traced) window, then the
reference and the comparison that decides ``correct``.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<name>.json`` with its
plain reference ``configs/<name>.py``, its traffic in
``traffic/<name>.json``, its limits in ``limits/<cell>.json`` and each
per-layer metric's reader in ``metrics/<metric>.py``. ``run.py`` is the
command line; :func:`run` takes the same arguments and a device, so the
tests drive it on the CPU.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> types.SimpleNamespace:
    """The cell ``workload``: its entry, configuration (with its reference
    module), traffic, limits and the metrics it reports."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    limits_path = HERE / "limits" / f"{workload}.json"
    return types.SimpleNamespace(
        name=workload,
        chips=int(cell["chips"]),
        cfg=json.loads((HERE / "configs" / f"{cell['config']}.json").read_text()),
        ref=load_module(HERE / "configs" / f"{cell['config']}.py", f"portbench_ref_{cell['config']}"),
        traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads(limits_path.read_text()) if limits_path.is_file() else None,
        end_to_end=[m["name"] for m in bench["end_to_end"] if mine(m)],
        per_layer=[m["name"] for m in bench["per_layer"] if mine(m)],
    )


def metric_reader(name: str):
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    or for ``<base>.<cells>`` (one quantity split by the end-to-end metric
    its cells report) ``metrics/<base>.py`` unless the split has its own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, f"portbench_metric_{name}")


def port_graph(graph: dict):
    """The generator's arrays as the program's ``HetGraph``. Features are
    zero tables of the right shapes: the run fills the program's device
    copies from ``--seed`` (``inputs.make_inputs``)."""
    import numpy as np

    from repro_torch.core.hetgraph import HetGraph

    lt = graph["label_type"]
    return HetGraph(
        node_types=tuple(graph["node_counts"]),
        num_nodes=dict(graph["node_counts"]),
        features={t: np.zeros((n, graph["feat_dims"][t]), np.float32) for t, n in graph["node_counts"].items()},
        relations=tuple(graph["relations"]),
        edges=dict(graph["edges"]),
        label_type=lt,
        labels=np.asarray(graph["comm"][lt], np.int32),
        num_classes=graph["num_classes"],
    )


def window(call: Callable, seconds: float, in_flight: int, cuda: bool, annotate: bool = False):
    """Call ``call()`` back to back for ``seconds`` (host clock), with at
    most ``in_flight`` results not yet done on the device; then wait for
    all. Each call is bracketed by CUDA events on the stream; the device
    time from the first call's start to the last call's end in which no
    call was on the stream (an end to the next start) is the idle the host
    leaves. Returns ``calls``, ``seconds`` (from the first call to the last
    result), ``host_s`` (host seconds inside the calls), ``idle_s`` and
    ``span_s`` (events; ``None`` off the card) and ``out`` (the last
    result)."""
    import torch

    span = torch.profiler.record_function if annotate else (lambda _: contextlib.nullcontext())
    pending = collections.deque()
    n, host, out = 0, 0.0, None
    idle, first, last = 0.0, None, None

    def settle(start, end):  # the oldest call's events, once it is done
        nonlocal idle, last
        end.synchronize()
        if last is not None:
            idle += last.elapsed_time(start)
        last = end

    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            first = start if first is None else first
        c = time.perf_counter()
        with span("session_call"):
            out = call()
        host += time.perf_counter() - c
        n += 1
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pending.append((start, end))
            if len(pending) > in_flight:
                with span("wait_result"):
                    settle(*pending.popleft())
        if time.perf_counter() >= deadline:
            break
    if cuda:
        torch.cuda.synchronize()
        while pending:
            settle(*pending.popleft())
    seconds = time.perf_counter() - t0
    span_s = first.elapsed_time(last) / 1e3 if cuda else None
    return types.SimpleNamespace(calls=n, seconds=seconds, host_s=host, out=out,
                                 idle_s=idle / 1e3 if cuda else None, span_s=span_s)


def build_program(cell, seed: int, dev, say=lambda msg: None) -> types.SimpleNamespace:
    """The program's set-up: the graph (cached), ``pipeline.prepare``, the
    run's weights and features made on the device from ``seed`` (features
    written into the program's own tables), and the session compiled."""
    import torch

    from portbench import inputs

    cfg, traffic = cell.cfg, cell.traffic
    graph, status = inputs.load_graph(traffic)
    say(f"graph {status}: " + ", ".join(f"{r} {len(graph['edges'][r][0])}" for _, r, _ in graph["relations"]))

    from repro_torch.core.flows import FlowConfig
    from repro_torch.core.pipeline import prepare

    sgb_dir = inputs.CACHE / "sgb"
    sgb_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    task = prepare(
        cfg["model"], port_graph(graph), max_degree=cfg["max_degree"], seed=traffic["sgb_seed"],
        bucket_sizes=tuple(cfg["bucket_sizes"]), sgb_cache_dir=sgb_dir,
        metapaths=traffic.get("metapaths"), device=dev,
    )
    prepare_s = time.perf_counter() - t0
    for key in ("heads", "dh", "num_layers"):
        if getattr(task.model, key) != cfg[key]:
            raise RuntimeError(f"the program's {cfg['model']} has {key}={getattr(task.model, key)}, "
                               f"the configuration {cfg[key]}")
    shapes = cell.ref.param_shapes(graph, cfg, traffic)
    params, _ = inputs.make_inputs(shapes, graph, traffic["graph"]["feat_noise"], seed, dev,
                                   features=task.batch.features)
    t0 = time.perf_counter()
    session = task.compile(FlowConfig(flow=cfg["flow"], prune_k=cfg["prune_k"]), params=params)
    capture_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return types.SimpleNamespace(graph=graph, shapes=shapes, task=task, session=session, params=params,
                                 prepare_s=prepare_s, capture_s=capture_s)


def reference(cell, graph: dict, shapes: dict, seed: int, dev, mode: str = "float32", margin_eps=1e-6):
    """The plain reference's logits of the run ``seed`` and its record
    (``refcore.Record``), with the inputs made again from ``seed``;
    ``mode`` ``"tf32"`` is the control."""
    import torch

    from portbench import inputs, refcore

    params, feats = inputs.make_inputs(shapes, graph, cell.traffic["graph"]["feat_noise"], seed, dev)
    graphs = [
        refcore.Graph(name, dst_t, src, dst, graph["node_counts"][dst_t], dev)
        for name, dst_t, src, dst in cell.ref.semantic_graphs(graph, cell.traffic, cell.cfg)
    ]
    with torch.no_grad(), refcore.precision(mode):
        return cell.ref.forward(params, feats, graph, graphs, cell.cfg, margin_eps)


ANNOTATIONS = ("session_call", "wait_result")


def traced_windows(call, cell, cuda: bool, ctx) -> Optional[dict]:
    """The traced part of a ``--trace 1`` run, after its untraced window:
    ``trace_seconds`` of calls under a device-only profile (device ms by
    kernel, the busy time, the window's length; the host is not slowed by
    host-side tracing there), then a short one under a host and device
    profile whose idle gaps are named by what the calling thread was doing.
    Fills ``ctx``; returns the breakdown."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import tracing

    length, in_flight = float(cell.traffic["trace_seconds"]), int(cell.traffic["in_flight"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w = window(call, length, in_flight, cuda)
        ctx.traced_forwards, ctx.trace_window_s = w.calls, w.seconds
    ctx.device_ms = tracing.device_ms(prof)
    dev_iv, _ = tracing.timeline(prof)
    if not dev_iv:
        return None
    busy, _ = tracing.busy_and_gaps(dev_iv, min(s for s, _ in dev_iv), max(e for _, e in dev_iv))
    ctx.busy_s = busy / 1e6
    ops = sorted(ctx.device_ms.items(), key=lambda kv: -kv[1])[:10]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctx.traced_forwards_host = window(call, min(length, 0.25), in_flight, cuda, annotate=True).calls
    dev_iv, host_iv = tracing.timeline(prof, skip=ANNOTATIONS)
    calls = [(s, th) for s, _, name, th in host_iv if name == "session_call"]
    gaps = []
    if dev_iv and calls:
        lo, main = min(calls)
        _, gaps = tracing.busy_and_gaps(dev_iv, lo, max(e for _, e in dev_iv))
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "device_ops": [[k[:80], v / 1e3] for k, v in ops],
        "idle_gaps": [[tracing.name_gap(host_iv, s, main), (e - s) / 1e6] for s, e in top],
    }


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, wrap: Optional[Callable] = None,
        cell: Optional[types.SimpleNamespace] = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``wrap(session, params) -> call`` replaces the timed call (the tests'
    planted faults); ``cell`` replaces the one ``BENCHMARK.json`` names."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from portbench import refcore

    cell = load_cell(workload) if cell is None else cell
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def say(msg):
        print(f"[portbench {cell.name}] {msg}", file=sys.stderr, flush=True)

    prog = build_program(cell, seed, dev, say)
    session, params = prog.session, prog.params
    call = (lambda: session(params)) if wrap is None else wrap(session, params)
    call()  # the clone's allocation and the first replay
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    say(f"set-up {setup_s:.3f} s (prepare {prog.prepare_s:.3f}, capture {prog.capture_s:.3f})")

    w = window(call, seconds, int(cell.traffic["in_flight"]), cuda)
    calls, window_s, host_s, got = w.calls, w.seconds, w.host_s, w.out
    forward_ms = window_s * 1e3 / calls
    say(f"window {window_s:.3f} s, {calls} forwards, {forward_ms:.6f} ms a forward, "
        f"host {host_s * 1e6 / calls:.2f} us a call"
        + (f", events {(w.span_s - w.idle_s) * 1e3 / calls:.6f} ms a call on the device, idle {w.idle_s:.6f} s"
           if cuda else ""))
    ctx = types.SimpleNamespace(
        cuda=cuda, forwards=calls, window_s=window_s, host_s=host_s, prepare_s=prog.prepare_s,
        capture_s=prog.capture_s, forward_ms=forward_ms, idle_s=w.idle_s, span_s=w.span_s, device_ms={}, busy_s=None,
        traced_forwards=0, traced_forwards_host=0,
    )
    breakdown = traced_windows(call, cell, cuda, ctx) if trace and cuda else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the reference, once the window has closed and the program's state is freed
    graph, shapes = prog.graph, prog.shapes
    del prog, session, params, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eps = cell.limits["margin_eps"] if cell.limits else 1e-6
    logits, rec = reference(cell, graph, shapes, seed, dev, "float32", eps)
    numbers = refcore.compare(got, logits, rec.tied_rows(graph["label_type"]))
    if cuda:
        torch.cuda.synchronize(dev)
    say(f"reference {time.perf_counter() - t0:.3f} s; " + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items()))

    checks = {}
    for name, limit in (cell.limits or {}).get("checks", {}).items():
        checks[name] = {"value": numbers[name], "limit": limit}
    correct = cell.limits is not None and all(c["value"] <= c["limit"] for c in checks.values())
    if cell.limits is None:
        say("no limits/<cell>.json: not correct")

    attempted = calls + ctx.traced_forwards + ctx.traced_forwards_host
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0, "metrics": {}}
    if not trace:
        # a metric named <base>.<cells> is its base's quantity in those cells
        e2e = {"setup_s": (setup_s, "s"), "forward_ms": (forward_ms, "ms"), "device_mem_gib": (peak / 2**30, "GiB")}
        for name in cell.end_to_end:
            base = name.split(".")[0]
            if cuda or base == "setup_s":  # a CPU run gives no device number
                result["metrics"][name] = {"value": e2e[base][0], "unit": e2e[base][1]}
    else:
        ctx.records = rec.entries
        ctx.model_flops = cell.ref.flops(graph, cell.cfg, cell.traffic, rec)
        for name in cell.per_layer:
            reader = metric_reader(name)
            value = reader.read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": reader.UNIT}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    if ctx.busy_s is not None:
        result["device"]["busy_s"] = ctx.busy_s
        result["device"]["window_s"] = ctx.trace_window_s
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
