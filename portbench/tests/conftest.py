"""Shared set-up of the benchmark's CPU tests: the program and the
benchmark importable, and small cells that run on the CPU in seconds.

Run from the repository root:

    python -m pytest -q portbench/tests

(``-m cuda`` selects the tests that need the card; they skip without one.)
"""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# the node counts of each cell's graph are scaled by this in the tests
SCALES = {"han.mag": 0.002, "han.dblp": 0.3, "han.imdb": 0.3}


def tiny(workload: str, scale: float = None, margin_eps: float = 1e-6):
    """The cell ``workload`` as ``BENCHMARK.json`` names it, at its graph's
    node counts times ``scale`` (the traffic renamed, so its cache entry is
    its own)."""
    from portbench import harness

    cell = harness.load_cell(workload)
    cell = copy.copy(cell)
    cell.traffic = copy.deepcopy(cell.traffic)
    s = SCALES[workload] if scale is None else scale
    g = cell.traffic["graph"]
    g["node_counts"] = {t: max(8, int(n * s)) for t, n in g["node_counts"].items()}
    cell.traffic["name"] = f"test-{cell.traffic['name']}"
    if cell.limits is not None:
        cell.limits = dict(cell.limits, margin_eps=margin_eps)
    return cell


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    """Graphs and SGB entries of a test go under its own temporary
    directory, not the checkout's ``build/``."""
    from portbench import inputs

    monkeypatch.setattr(inputs, "CACHE", tmp_path / "portbench")
