"""The control: the plain reference in the program's place, computed in
TF32 (the precision next below the configuration's float32 with TF32 off),
fails the cell's limits. TF32 exists on the card only, so this test needs
one (``-m cuda``); the full-size readings come from ``calibrate.py``."""
import pytest
import torch
from conftest import CELLS, tiny

from portbench import graphgen, harness, refcore


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control rounds through TF32, which needs a CUDA card")
    cell = tiny(workload, scale=0.05 if workload == "han.mag" else 1.0)
    dev = torch.device("cuda")
    graph = graphgen.make_graph(cell.traffic["graph"])
    shapes = cell.ref.param_shapes(graph, cell.cfg, cell.traffic)
    worst = 0.0
    for seed in (101, 202, 303):
        ref, rec = harness.reference(cell, graph, shapes, seed, dev, "float32", cell.limits["margin_eps"])
        ctrl, _ = harness.reference(cell, graph, shapes, seed, dev, "tf32", cell.limits["margin_eps"])
        numbers = refcore.compare(ctrl, ref, rec.tied_rows(graph["label_type"]))
        over = [n for n, lim in cell.limits["checks"].items() if numbers[n] > lim]
        assert over, numbers
        worst = max(worst, max(numbers[n] / cell.limits["checks"][n] for n in over))
    assert worst > 1
