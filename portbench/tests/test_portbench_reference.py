"""The plain reference against the program: the semantic graphs it works
out again, and the logits of whole runs on small graphs."""
import collections

import numpy as np
import pytest
from conftest import CELLS, tiny

from portbench import graphgen, harness, refcore


def _rows(src, dst):
    rows = collections.defaultdict(list)
    for s, d in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
        rows[d].append(s)
    return {d: sorted(v) for d, v in rows.items()}


def _port_rows(sg):
    nbr, msk = sg.nbr_idx, sg.nbr_mask
    return {d: sorted(nbr[d][msk[d]].tolist()) for d in range(nbr.shape[0]) if msk[d].any()}


@pytest.mark.parametrize("workload", CELLS)
def test_semantic_graphs_equal_the_programs_sgb(workload):
    from repro_torch.core import hetgraph

    cell = tiny(workload)
    graph = graphgen.make_graph(cell.traffic["graph"])
    g = harness.port_graph(graph)
    mine = cell.ref.semantic_graphs(graph, cell.traffic, cell.cfg)
    theirs = hetgraph.build_metapath_graphs(g, cell.traffic["metapaths"], seed=cell.traffic["sgb_seed"])
    assert [m[0] for m in mine] == [sg.name for sg in theirs]
    for (_, _, src, dst), sg in zip(mine, theirs):
        assert _rows(src, dst) == _port_rows(sg)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_the_programs_logits(workload):
    cell = tiny(workload)
    r = harness.run(workload, 2**31 + 12345, 0.1, False, "cpu", cell=cell)
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] < 1e-5, name


def test_topk_keeps_the_highest_and_measures_the_margin():
    import torch

    # destination 0: five candidates ranked 5,1,4,2,3 -> keeps 5,4,3 at k=3
    src = np.array([0, 1, 2, 3, 4, 5])
    dst = np.array([0, 0, 0, 0, 0, 1])
    g = refcore.Graph("g", "t", src, dst, 2, "cpu")
    rank = torch.tensor([5.0, 1.0, 4.0, 2.0, 3.0, 7.0])
    kept, margin = refcore.topk_edges(g, rank, 3)
    assert sorted(g.src[kept].tolist()) == [0, 2, 4, 5]
    assert margin[0].item() == pytest.approx(1.0)  # 3 kept against 2 dropped
    assert margin[1].item() == float("inf")
