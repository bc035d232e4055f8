"""Schema-faithful synthetic ACM / IMDB / DBLP heterographs.

The port's copy of ``repro/data/synthetic.py``: the same numpy RNG streams,
so a graph generated here is bit-identical to the reference's for the same
``(scale, seed)``. The three benchmark HetGs keep the published
vertex/relation schema, planted community structure (so HGNN models have
signal to learn), and heavy-tailed degree distributions (so attention
disparity and pruning behave as in the paper — disparity needs high-degree
targets to matter).

Feature model: each community has a Gaussian centroid per node type; node
features are centroid + noise. Labels on the ``label_type`` equal community
id. Cross-community edges occur with probability ``noise_edges``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.hetgraph import HetGraph, Relation

# Generator contract version: graphs are deterministic per (seed, scale,
# GENERATOR_VERSION), and this matches the reference generator's version.
GENERATOR_VERSION = 2


def _power_law_degrees(rng, n, mean_deg, alpha=2.1, dmax=None):
    """Heavy-tailed integer degrees with the requested mean."""
    raw = rng.pareto(alpha, size=n) + 1.0
    raw = raw / raw.mean() * mean_deg
    deg = np.maximum(1, np.round(raw)).astype(np.int64)
    if dmax is not None:
        deg = np.minimum(deg, dmax)
    return deg


def _bipartite_edges(
    rng: np.random.Generator,
    n_src: int,
    n_dst: int,
    mean_deg_dst: float,
    comm_src: np.ndarray,
    comm_dst: np.ndarray,
    noise_edges: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """src->dst edges; each dst draws a heavy-tailed number of sources,
    mostly from its own community.

    Vectorized over all targets: destinations are a single ``repeat`` over
    the degree draw, source picks one batched draw per edge (a uniform slot
    into the destination's community pool, or a uniform global pick for the
    ``noise_edges`` fraction and for empty pools). Same degree model, same
    dedup semantics as the original per-target loop — the degree draw
    consumes the identical RNG stream, so per-target degrees match the loop
    build seed-for-seed; source picks are a different (but seed-stable)
    stream of the same distribution.
    """
    # both sides bound the community id range: a community may exist only
    # on the destination side (its source pool is then empty -> uniform
    # fallback), which indexed out of bounds in the per-target loop build
    n_comm = int(max(comm_src.max(), comm_dst.max())) + 1
    deg = _power_law_degrees(rng, n_dst, mean_deg_dst)
    total = int(deg.sum())
    dst = np.repeat(np.arange(n_dst, dtype=np.int64), deg)
    same = rng.random(total) >= noise_edges
    rand_picks = rng.integers(0, n_src, size=total)
    # community pools: src ids grouped by community (stable order, matching
    # np.where per community), indexed per edge via the pool's start + a
    # uniform offset
    pool = np.argsort(comm_src, kind="stable")
    pool_sizes = np.bincount(comm_src, minlength=n_comm)
    pool_starts = np.concatenate([[0], np.cumsum(pool_sizes)[:-1]])
    ec = comm_dst[dst]  # each edge's destination community
    sizes = pool_sizes[ec]
    offs = rng.integers(0, np.maximum(sizes, 1), size=total)
    # empty-pool lanes are discarded below; clip their gather index so the
    # vectorized lookup stays in bounds
    same_picks = pool[np.minimum(pool_starts[ec] + offs, n_src - 1)]
    # empty own-community pools fall back to the uniform draw
    src = np.where(same & (sizes > 0), same_picks, rand_picks)
    key = src * n_dst + dst
    _, uniq = np.unique(key, return_index=True)
    return src[uniq].astype(np.int64), dst[uniq].astype(np.int64)


def make_hetg(
    name: str,
    node_counts: Dict[str, int],
    relations: Sequence[Relation],
    mean_degrees: Dict[str, float],
    label_type: str,
    num_classes: int,
    feat_dims: Dict[str, int],
    noise_edges: float = 0.15,
    feat_noise: float = 1.0,
    seed: int = 0,
) -> HetGraph:
    rng = np.random.default_rng(seed)
    comm = {
        t: rng.integers(0, num_classes, size=n) for t, n in node_counts.items()
    }
    feats = {}
    for t, n in node_counts.items():
        f = feat_dims[t]
        centroids = rng.normal(size=(num_classes, f)).astype(np.float32)
        feats[t] = (
            centroids[comm[t]] + feat_noise * rng.normal(size=(n, f))
        ).astype(np.float32)
    edges = {}
    for (src_t, rel, dst_t) in relations:
        edges[rel] = _bipartite_edges(
            rng,
            node_counts[src_t],
            node_counts[dst_t],
            mean_degrees[rel],
            comm[src_t],
            comm[dst_t],
            noise_edges,
        )
    return HetGraph(
        node_types=tuple(node_counts),
        num_nodes=dict(node_counts),
        features=feats,
        relations=tuple(relations),
        edges=edges,
        label_type=label_type,
        labels=comm[label_type].astype(np.int32),
        num_classes=num_classes,
    )


def make_acm(scale: float = 1.0, seed: int = 0) -> HetGraph:
    """ACM: paper/author/subject; relations AP (author→paper), PP (cite),
    SP (subject→paper). Labels on papers, 3 classes. HAN metapaths PAP, PSP."""
    s = lambda n: max(8, int(n * scale))
    return make_hetg(
        "acm",
        node_counts={"paper": s(3025), "author": s(5959), "subject": s(56)},
        relations=(
            ("author", "AP", "paper"),
            ("paper", "PP", "paper"),
            ("subject", "SP", "paper"),
        ),
        mean_degrees={"AP": 3.0, "PP": 5.0, "SP": 1.0},
        label_type="paper",
        num_classes=3,
        feat_dims={"paper": 64, "author": 64, "subject": 64},
        seed=seed,
    )


def make_imdb(scale: float = 1.0, seed: int = 1) -> HetGraph:
    """IMDB: movie/director/actor; relations DM, AM. Labels on movies,
    3 classes. HAN metapaths MDM, MAM."""
    s = lambda n: max(8, int(n * scale))
    return make_hetg(
        "imdb",
        node_counts={"movie": s(4278), "director": s(2081), "actor": s(5257)},
        relations=(("director", "DM", "movie"), ("actor", "AM", "movie")),
        mean_degrees={"DM": 1.0, "AM": 3.0},
        label_type="movie",
        num_classes=3,
        feat_dims={"movie": 64, "director": 64, "actor": 64},
        seed=seed,
    )


def make_dblp(scale: float = 1.0, seed: int = 2) -> HetGraph:
    """DBLP: author/paper/term/venue; relations PA, PT_rev? we store
    natural directions: AP' as PA (paper→author messages flow A→P via AP).
    Labels on authors, 4 classes. HAN metapaths APA, APVPA.

    The real DBLP semantic graphs have >12M edges; at scale=1.0 this
    generator yields O(100k) base edges whose APVPA composition explodes the
    same way (venues are high-degree hubs), reproducing the disparity regime.
    """
    s = lambda n: max(8, int(n * scale))
    return make_hetg(
        "dblp",
        node_counts={
            "author": s(4057), "paper": s(14328), "term": s(7723), "venue": s(20)
        },
        relations=(
            ("author", "AP", "paper"),
            ("paper", "PV", "venue"),
            ("term", "TP", "paper"),
        ),
        mean_degrees={"AP": 2.8, "PV": 1.0, "TP": 4.0},
        label_type="author",
        num_classes=4,
        feat_dims={"author": 64, "paper": 64, "term": 64, "venue": 64},
        seed=seed,
    )


METAPATHS = {
    "acm": {"PAP": ("AP_rev", "AP"), "PSP": ("SP_rev", "SP")},
    "imdb": {"MDM": ("DM_rev", "DM"), "MAM": ("AM_rev", "AM")},
    "dblp": {"APA": ("AP", "AP_rev"), "APVPA": ("AP", "PV", "PV_rev", "AP_rev")},
}

DATASETS = {"acm": make_acm, "imdb": make_imdb, "dblp": make_dblp}
