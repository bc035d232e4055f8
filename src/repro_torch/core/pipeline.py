"""End-to-end HGNN task assembly: dataset → SGB → model → GraphBatch.

``prepare()`` is table-driven over the model registry
(``repro_torch.core.models.MODELS``): each architecture names its SGB kind
and factory. The returned ``HGNNTask`` serves inference through
``task.compile(flow)``, an :class:`~repro_torch.core.session.InferenceSession`
cached per flow, device and parameter names, shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hetgraph
from repro_torch.core.batch import GraphBatch, ModelSpec
from repro_torch.core.flows import FlowConfig
from repro_torch.core.models import get_entry
from repro_torch.core.session import InferenceSession, param_spec
from repro_torch.data import datasets


@dataclasses.dataclass
class HGNNTask:
    name: str
    model_name: str
    model: object
    graph: hetgraph.HetGraph
    batch: GraphBatch
    spec: ModelSpec
    params: Dict[str, torch.Tensor]
    labels: torch.Tensor
    splits: Dict[str, np.ndarray]
    sgs: list  # semantic graphs driving NA
    device: torch.device
    _sessions: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def compile(self, flow: FlowConfig = FlowConfig(), params=None) -> InferenceSession:
        """The serving entry: one session per (flow, device, parameter
        names with their shapes and dtypes), cached on the task, so repeated
        calls (``accuracy`` over splits, a serving loop) share one program.
        ``params`` only gives the example the session is built against
        (default: the task's own). The reference also keys on the mesh,
        which is not ported yet (ROADMAP §1 item 7), and takes
        ``donate_params``, which waits for ``serve/`` (§1 item 4), its only
        caller there."""
        if params is None:
            params = self.params
        key = (flow, self.device, param_spec(params))
        sess = self._sessions.get(key)
        if sess is None:
            sess = InferenceSession(self.model, self.batch, flow, params=params)
            self._sessions[key] = sess
        return sess


def _splits(n: int, seed: int = 0):
    """60/20/20 random split (the reference's, draw for draw). For
    ``n >= 3`` every split is non-empty; the three splits always form a
    disjoint union of ``range(n)``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_tr, n_va = int(0.6 * n), int(0.2 * n)
    if n >= 3:
        n_va = max(1, n_va)
        n_tr = max(1, min(n_tr, n - n_va - 1))
    out = {
        "train": perm[:n_tr],
        "val": perm[n_tr: n_tr + n_va],
        "test": perm[n_tr + n_va:],
    }
    cover = np.sort(np.concatenate(list(out.values())))
    if not np.array_equal(cover, np.arange(n)):
        raise AssertionError("splits must partition range(n)")
    return out


def prepare(
    model_name: str,
    dataset: str,
    scale: float = 0.1,
    max_degree: Optional[int] = 256,
    seed: int = 0,
    bucket_sizes: Optional[Sequence[int]] = hetgraph.DEFAULT_BUCKET_SIZES,
    device="cuda",
) -> HGNNTask:
    """Assemble dataset → SGB → model on ``device``.

    ``dataset`` is a registry name, generated with ``scale``/``seed``. The
    model's registry entry names its SGB kind: metapath graphs (HAN), one
    graph per relation (RGAT) or one union graph per node type
    (Simple-HGN). ``bucket_sizes`` selects the SGB layout: a capacity list
    gives the degree-bucketed build (the default), ``None`` the flat
    ``(T, D_max)`` one. The model's parameters are drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and then moved, so the same
    seed gives the same weights on every device. ``device`` defaults to
    the GPU and raises without one; pass ``device="cpu"`` for the CPU.
    """
    dev = resolve_device(device)
    entry = get_entry(model_name)
    g, mps = datasets.resolve(dataset, scale=scale, seed=seed)
    sgb_kw = dict(max_degree=max_degree, seed=seed, bucket_sizes=bucket_sizes)
    if entry.sgb_kind == "metapath":
        if not mps:
            raise ValueError(
                f"model {model_name!r} needs metapaths for dataset {dataset!r}"
            )
        built = hetgraph.build_metapath_graphs(g, mps, **sgb_kw)
    elif entry.sgb_kind == "relation":
        built = hetgraph.build_relation_graphs(g, **sgb_kw)
    else:
        built = hetgraph.build_union_graph(g, **sgb_kw)
    # a union build is keyed by destination type, in node_types order
    sgs = list(built.values()) if isinstance(built, dict) else list(built)
    batch = GraphBatch.from_graph(g, sgs, dev)
    spec = ModelSpec.from_graph(g, sgs)
    model = entry.factory(spec)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev)
    return HGNNTask(
        name=f"{model_name}/{dataset}",
        model_name=model_name,
        model=model,
        graph=g,
        batch=batch,
        spec=spec,
        params=dict(model.named_parameters()),
        labels=torch.from_numpy(g.labels.astype(np.int64)).to(dev),
        splits=_splits(g.num_nodes[g.label_type], seed),
        sgs=sgs,
        device=dev,
    )


def accuracy(task: HGNNTask, params, flow: FlowConfig = FlowConfig(), split="test") -> float:
    """Split accuracy through the task's cached session."""
    idx = torch.from_numpy(task.splits[split].astype(np.int64)).to(task.device)
    pred = task.compile(flow)(params)[idx].argmax(-1)
    return float((pred == task.labels[idx]).float().mean())
