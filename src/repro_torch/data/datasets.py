"""Dataset registry: ``pipeline.prepare(model, dataset)`` resolves its
``dataset`` name here to one of the synthetic ACM/IMDB/DBLP generators,
parameterized by ``scale``/``seed``. The generated graph is
schema-validated. On-disk dumps come with a later slice of the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.hetgraph import HetGraph
from repro_torch.data import synthetic

# name -> generator(scale: float, seed: int) -> HetGraph
REGISTRY = dict(synthetic.DATASETS)


def resolve(
    name: str,
    scale: float = 1.0,
    seed: int = 0,
) -> Tuple[HetGraph, Optional[Dict[str, Sequence[str]]]]:
    """Run the generator registered as ``name`` with ``scale``/``seed`` ->
    ``(validated graph, HAN metapath table or None)``."""
    if name not in REGISTRY:
        raise ValueError(
            f"unknown dataset {name!r}: registered names are {sorted(REGISTRY)} "
            "(on-disk dumps come with a later slice of the port)"
        )
    g = REGISTRY[name](scale=scale, seed=seed).validate()
    return g, synthetic.METAPATHS.get(name)
