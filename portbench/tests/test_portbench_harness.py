"""The harness: cells, configurations, traffic, limits and metric readers
found by name; the shape of the result line; and ``correct`` coming out
false when the timed path is broken underneath (the look for a card
skipped, everything else a run does)."""
import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, tiny

from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_parts_are_found_by_name(workload):
    cell = harness.load_cell(workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.cfg["name"] == entry["config"] and cell.traffic["name"] == entry["traffic"]
    assert callable(cell.ref.forward) and callable(cell.ref.flops)
    assert cell.limits is not None and set(cell.limits["checks"]) <= {"err_p99", "err_max_untied", "err_max"}
    mine = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    assert cell.end_to_end == [m["name"] for m in BENCH["end_to_end"] if mine(m)]
    assert cell.per_layer == [m["name"] for m in BENCH["per_layer"] if mine(m)]
    # every cell reports the set-up time, another end-to-end metric, and
    # per-layer metrics that move an end-to-end metric it reports
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2 and cell.per_layer
    moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    assert all(moves[n] in cell.end_to_end for n in cell.per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    reader = harness.metric_reader(metric)
    unit = next(m["unit"] for m in BENCH["per_layer"] if m["name"] == metric)
    assert reader.UNIT == unit and callable(reader.read)


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no.such.cell")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    cell = tiny("han.dblp")
    r = harness.run("han.dblp", 987654321987, 0.1, trace, "cpu", cell=cell)
    line = json.loads(json.dumps(r))
    assert list(line)[:3] == ["correct", "attempted", "failed"] and list(line)[-1] == "checks"
    assert {"metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        # a CPU run reads no device trace: only the host-clock metrics
        assert set(line["metrics"]) == {"host_call_us.small", "prepare_s", "capture_s"}
    else:
        assert set(line["metrics"]) == {"setup_s"}


def _no_forward(session, params):
    out = session(params)
    return lambda: torch.zeros_like(out)


def _half_left_out(session, params):
    def call():
        out = session(params).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return call


def _one_altered(session, params):
    def call():
        out = session(params).clone()
        out[0] = -out[0]
        return out
    return call


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_no_forward, _half_left_out, _one_altered])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    cell = tiny(workload)
    r = harness.run(workload, 5550001, 0.1, False, "cpu", cell=cell, wrap=fault)
    assert r["correct"] is False, r["checks"]


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "han.dblp", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


def test_cli_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "han.dblp", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
