"""The benchmark's graph generator: a frozen numpy copy of the port's
``repro_torch/data/synthetic.py`` (``_power_law_degrees`` lines 27-35,
``_bipartite_edges`` 38-87, ``make_hetg`` 90-133), so a traffic mix fixes
its graph whatever a later change does to the program's generator.

One parameter is added, read from the traffic file: ``max_in_degree``
truncates each destination's drawn degree (the ``dmax`` that
``_power_law_degrees`` already takes); ``None`` leaves it as the copy's
source does. The feature draws of ``make_hetg`` are left out: the features
the benchmark runs on are made on the device from the run's ``--seed``
(``inputs.make_inputs``).

The result is a plain dict of numpy arrays: ``comm`` (each vertex's
planted community, by type), ``edges`` (``{relation: (src, dst)}``, local
ids, int64) and the schema.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def power_law_degrees(rng, n, mean_deg, alpha=2.1, dmax=None):
    """Heavy-tailed integer degrees with the requested mean."""
    raw = rng.pareto(alpha, size=n) + 1.0
    raw = raw / raw.mean() * mean_deg
    deg = np.maximum(1, np.round(raw)).astype(np.int64)
    if dmax is not None:
        deg = np.minimum(deg, dmax)
    return deg


def bipartite_edges(rng, n_src, n_dst, mean_deg_dst, comm_src, comm_dst, noise_edges, dmax=None):
    """src->dst edges; each dst draws a heavy-tailed number of sources,
    mostly from its own community (uniform for the ``noise_edges``
    fraction and for an empty community pool); duplicates removed."""
    n_comm = int(max(comm_src.max(), comm_dst.max())) + 1
    deg = power_law_degrees(rng, n_dst, mean_deg_dst, dmax=dmax)
    total = int(deg.sum())
    dst = np.repeat(np.arange(n_dst, dtype=np.int64), deg)
    same = rng.random(total) >= noise_edges
    rand_picks = rng.integers(0, n_src, size=total)
    pool = np.argsort(comm_src, kind="stable")
    pool_sizes = np.bincount(comm_src, minlength=n_comm)
    pool_starts = np.concatenate([[0], np.cumsum(pool_sizes)[:-1]])
    ec = comm_dst[dst]
    sizes = pool_sizes[ec]
    offs = rng.integers(0, np.maximum(sizes, 1), size=total)
    same_picks = pool[np.minimum(pool_starts[ec] + offs, n_src - 1)]
    src = np.where(same & (sizes > 0), same_picks, rand_picks)
    key = src * n_dst + dst
    _, uniq = np.unique(key, return_index=True)
    return src[uniq].astype(np.int64), dst[uniq].astype(np.int64)


def make_graph(spec: dict) -> dict:
    """The graph of a traffic file's ``graph`` section (see the module
    docstring)."""
    node_counts: Dict[str, int] = {t: int(n) for t, n in spec["node_counts"].items()}
    num_classes = int(spec["num_classes"])
    feat_dims = {t: int(f) for t, f in spec["feat_dims"].items()}
    dmax: Optional[int] = spec.get("max_in_degree")
    rng = np.random.default_rng(int(spec["graph_seed"]))
    comm = {t: rng.integers(0, num_classes, size=n) for t, n in node_counts.items()}
    edges = {}
    for src_t, rel, dst_t in spec["relations"]:
        edges[rel] = bipartite_edges(
            rng, node_counts[src_t], node_counts[dst_t], float(spec["mean_degrees"][rel]),
            comm[src_t], comm[dst_t], float(spec.get("noise_edges", 0.15)), dmax,
        )
    return {
        "node_counts": node_counts,
        "relations": [tuple(r) for r in spec["relations"]],
        "label_type": spec["label_type"],
        "num_classes": num_classes,
        "feat_dims": feat_dims,
        "comm": comm,
        "edges": edges,
    }
