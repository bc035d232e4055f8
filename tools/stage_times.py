"""Where a benchmark cell's time goes, from the program's own tracing
(``repro_torch.trace``): run on a machine with a card, from the root of a
checkout,

    python3 tools/stage_times.py --workload han.imdb --seed 7 --seconds 10 --stage-seconds 30

It builds the cell's program as ``portbench/run.py`` does
(``harness.build_program``; the set-up's stages on the host clock, beside
the program's build spans), captures a second session under
``trace.enable(device=True)``, then, on one process and one card:

  * ``--stage-seconds`` of a closed loop of the device-traced session
    (the benchmark's pacing) with every 8th call read by
    ``trace.stage_ms``, from right after the set-up: device ms by stage,
    the stages of the slowest and fastest thirds of the replays, and the
    median stages of each 5 s of the loop (a speed that changes with the
    process's age shows there);
  * NA's slot counters (``ops.NA_SLOTS_BY_GRAPH``) over that session's
    warm-up and capture, per forward and semantic graph: the candidate
    slots the grid visits, the valid, kept and bypass shares;
  * closed-loop windows (``portbench.harness.window``) of the session with
    tracing off, on (per-call spans) and on with device stages, in the
    order off, on, device, device, on, off: ms a forward and host µs a
    call of each, and host µs a call by span;
  * ``--stage-seconds`` of calls of the device-traced session, each
    waited for and read: the same tables.

Prints one JSON object as its last line.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0, help="each closed-loop window")
    ap.add_argument("--stage-seconds", type=float, default=30.0, help="the window of stage reads")
    args = ap.parse_args(argv)

    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - T_START

    import torch

    mark("import_torch")
    from portbench import harness
    from repro_torch import trace
    from repro_torch.core import flows
    from repro_torch.core.session import InferenceSession
    from repro_torch.kernels.fused_prune_aggregate import ops

    mark("import_program")
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    torch.cuda.init()
    mark("cuda_init")
    prog = harness.build_program(cell, args.seed, dev)
    mark("build_program")
    task, params, plain = prog.task, prog.params, prog.session
    marks.update(prepare_s=prog.prepare_s, capture_s=prog.capture_s)
    flow = plain.flow
    plain(params)
    torch.cuda.synchronize(dev)
    mark("first_call")
    byid = {sp.id: sp for sp in trace.spans()}
    build = [[sp.name, byid[sp.parent].name if sp.parent in byid else None, sp.seconds, sp.attrs]
             for sp in trace.spans()]

    for k in ops.NA_SLOTS:
        ops.NA_SLOTS[k] = 0
    ops.NA_SLOTS_BY_GRAPH.clear()
    graph_calls = flows.DISPATCH["graph_calls"]
    trace.enable(device=True)
    staged = InferenceSession(task.model, task.batch, flow, params=params)
    trace.disable()
    forwards = (flows.DISPATCH["graph_calls"] - graph_calls) / max(1, len(ops.NA_SLOTS_BY_GRAPH))

    def slot_row(c):
        return {**{k: v / forwards for k, v in c.items()},
                "slot_use_pct": 100.0 * c["valid"] / max(1, c["slots"]),
                "kept_pct_of_valid": 100.0 * c["kept"] / max(1, c["valid"]),
                "bypass_rows_pct": 100.0 * c["bypass_rows"] / max(1, c["rows"])}

    na_slots = {g: slot_row(c) for g, c in {**ops.NA_SLOTS_BY_GRAPH, "all": ops.NA_SLOTS}.items()}
    staged(params)
    torch.cuda.synchronize(dev)
    in_flight = int(cell.traffic["in_flight"])

    def loop_reads(seconds):
        """Every 8th call of a closed loop of the device-traced session
        (its predecessor still on the card when it was launched), read,
        with the seconds since the process started."""
        rows, pending, i = [], [], 0
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            staged(params)
            i += 1
            pending.append(torch.cuda.Event())
            pending[-1].record()
            if len(pending) > in_flight:
                pending.pop(0).synchronize()
            if i % 8 == 0:
                rows.append(dict(trace.stage_ms(staged), at_s=time.perf_counter() - T_START))
                pending.clear()
        return rows

    loop = loop_reads(args.stage_seconds)

    def measure(mode):
        sess = staged if mode == "device" else plain
        if mode == "off":
            trace.disable()
        else:
            trace.enable(device=mode == "device")
        trace.reset()
        w = harness.window(lambda: sess(params), args.seconds, in_flight, True)
        trace.disable()
        spans_us = {n: s * 1e6 / w.calls for n, (_, s) in trace.totals().items()}
        return {"forward_ms": w.seconds * 1e3 / w.calls, "host_call_us": w.host_s * 1e6 / w.calls,
                "calls": w.calls, "span_us": spans_us}

    modes = {}
    for mode in ("off", "on", "device", "device", "on", "off"):
        modes.setdefault(mode, []).append(measure(mode))

    reads = []
    t_end = time.perf_counter() + args.stage_seconds
    while time.perf_counter() < t_end:
        staged(params)
        reads.append(dict(trace.stage_ms(staged), at_s=time.perf_counter() - T_START))
    names = [n for n in reads[0] if n != "at_s"]

    def summary(rows, stat=statistics.fmean):
        return {n: stat([r[n] for r in rows]) for n in names}

    def table(rows):
        by_replay = sorted(rows, key=lambda r: r["replay"])
        third = max(1, len(rows) // 3)
        by_5s: dict = {}
        for r in rows:
            by_5s.setdefault(int(r["at_s"] // 5) * 5, []).append(r)
        return {
            "reads": len(rows),
            "median_ms": summary(rows, statistics.median),
            "fastest_third_ms": summary(by_replay[:third]),
            "slowest_third_ms": summary(by_replay[-third:]),
            "replay_ms_quantiles": statistics.quantiles([r["replay"] for r in rows], n=20),
            "median_ms_by_5s": {t: summary(rs, statistics.median) for t, rs in sorted(by_5s.items())},
        }

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "card": card,
        "setup_marks_s": marks, "build_spans": build, "na_slots": na_slots, "modes": modes,
        "stages_waited": table(reads), "stages_in_loop": table(loop),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
