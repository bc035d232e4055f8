"""The benchmark's frozen generator: the same arrays for a seed, the
program's generator edge for edge on the same draws, and each mix's edge
counts where its traffic file states them."""
import numpy as np
import pytest

from conftest import CELLS, SCALES

from portbench import graphgen, harness


def _spec(traffic, scale):
    g = dict(traffic["graph"])
    g["node_counts"] = {t: max(8, int(n * scale)) for t, n in g["node_counts"].items()}
    return g


@pytest.mark.parametrize("workload", CELLS)
def test_same_arrays_for_a_seed(workload):
    spec = _spec(harness.load_cell(workload).traffic, SCALES[workload])
    a, b = graphgen.make_graph(spec), graphgen.make_graph(spec)
    for rel in a["edges"]:
        for x, y in zip(a["edges"][rel], b["edges"][rel]):
            np.testing.assert_array_equal(x, y)
    for t in a["comm"]:
        np.testing.assert_array_equal(a["comm"][t], b["comm"][t])
    other = graphgen.make_graph(dict(spec, graph_seed=spec["graph_seed"] + 1))
    assert any(not np.array_equal(a["edges"][r][0], other["edges"][r][0]) for r in a["edges"])


@pytest.mark.parametrize("workload", CELLS)
def test_copy_draws_the_programs_edges(workload):
    """Relation by relation, the copy's draws are the program's generator's
    on the same stream (the program's has no degree cap: uncapped here)."""
    from repro_torch.data import synthetic

    spec = _spec(harness.load_cell(workload).traffic, SCALES[workload])
    counts, c = spec["node_counts"], spec["num_classes"]
    mine, theirs = np.random.default_rng(7), np.random.default_rng(7)
    comm = {t: mine.integers(0, c, size=n) for t, n in counts.items()}
    for t, n in counts.items():
        np.testing.assert_array_equal(theirs.integers(0, c, size=n), comm[t])
    for src_t, rel, dst_t in spec["relations"]:
        args = (counts[src_t], counts[dst_t], spec["mean_degrees"][rel], comm[src_t], comm[dst_t], spec["noise_edges"])
        a = graphgen.bipartite_edges(mine, *args)
        b = synthetic._bipartite_edges(theirs, *args)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("workload", ["han.dblp", "han.imdb"])
def test_edge_counts_land_on_the_published(workload):
    traffic = harness.load_cell(workload).traffic
    g = graphgen.make_graph(traffic["graph"])
    for rel, want in traffic["published_edges"].items():
        assert abs(len(g["edges"][rel][0]) - want) <= 0.005 * want, rel


def test_max_in_degree_truncates():
    spec = _spec(harness.load_cell("han.mag").traffic, SCALES["han.mag"])
    g = graphgen.make_graph(dict(spec, max_in_degree=3))
    for _, rel, dst_t in g["relations"]:
        deg = np.bincount(g["edges"][rel][1], minlength=g["node_counts"][dst_t])
        assert deg.max() <= 3
