"""``GraphBatch`` — the single input type every HGNN model consumes — and
``ModelSpec``, the shape-level facts a model's parameters are sized from.

A batch packs the per-type feature tensors (on the batch's device), the
semantic graphs driving NA (numpy layouts; device mirrors are cached on
them at first use), and the type offset/count metadata.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch import from_host, trace


class GraphBatch:
    """One heterograph's model input: features + semantic graphs + meta.

    ``features`` maps node type to an ``(N_t, F_t)`` float32 tensor; ``sgs``
    are the semantic graphs in model dispatch order; ``node_types`` is the
    global concatenation order; ``offsets``/``num_nodes`` are per-type row
    ranges in the global vertex table.
    """

    def __init__(
        self,
        features: Mapping[str, torch.Tensor],
        sgs: Sequence,
        node_types: Sequence[str],
        offsets: Mapping[str, int],
        num_nodes: Mapping[str, int],
        label_type: str,
    ):
        self.features = dict(features)
        self.sgs = tuple(sgs)
        self.node_types = tuple(node_types)
        self.offsets = dict(offsets)
        self.num_nodes = dict(num_nodes)
        self.label_type = label_type

    @classmethod
    def from_graph(cls, g, sgs, device: torch.device, features=None) -> "GraphBatch":
        """Build from a ``HetGraph`` + its SGB output, with the feature
        tables copied to ``device``. ``features`` overrides them: its
        tensors are taken as they are, with no copy (the stream ingestor
        hands a successor the serving batch's tensors of the node types a
        delta did not touch). The copy is the build span ``upload``."""
        if features is None:
            with trace.span("upload", always=True, what="features") as sp:
                features = {
                    t: from_host(np.asarray(f, np.float32), device)
                    for t, f in g.features.items()
                }
                sp.set(bytes=sum(f.nbytes for f in features.values()))
        return cls(
            features=features, sgs=sgs, node_types=g.node_types,
            offsets=g.type_offsets(), num_nodes=g.num_nodes,
            label_type=g.label_type,
        )

    @property
    def device(self) -> torch.device:
        return next(iter(self.features.values())).device

    @property
    def total_nodes(self) -> int:
        return sum(self.num_nodes[t] for t in self.node_types)

    @property
    def num_targets(self) -> int:
        """Rows of the labeled type — the logits' leading dim."""
        return self.num_nodes[self.label_type]

    @property
    def dst_offset(self) -> int:
        return self.offsets[self.label_type]

    @property
    def sg_by_dst(self) -> Dict[str, object]:
        """Semantic graphs keyed by destination type (union-graph models)."""
        return {sg.dst_type: sg for sg in self.sgs}

    def constrain(self, x: torch.Tensor, role: str) -> torch.Tensor:
        """Placement hook of the reference's sharded path: the identity.
        Its rules for the two roles (features, logits) are the
        ``ntype_feat`` and ``targets`` axes, and both are replicated
        (``distributed.sharding.DEFAULT_RULES``): NA reads arbitrary
        global source ids, so every rank needs the whole feature table,
        and semantic fusion's mean over all targets must see the same
        operands in the same order on every rank to stay bit for bit the
        single-device result. Sharded NA all-gathers its output, so every
        rank holds both whole already."""
        return x

    def __repr__(self):
        return (
            f"GraphBatch(types={self.node_types}, "
            f"sgs={[sg.name for sg in self.sgs]}, "
            f"label_type={self.label_type!r}, device={self.device})"
        )


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything a model needs to size its parameters. Hashable."""

    feat_dims: Tuple[Tuple[str, int], ...]  # (node type, feature dim)
    num_classes: int
    node_types: Tuple[str, ...]
    sg_names: Tuple[str, ...]  # semantic-graph (metapath / relation) names
    num_edge_types: int = 1

    @classmethod
    def from_graph(cls, g, sgs) -> "ModelSpec":
        return cls(
            feat_dims=tuple((t, g.features[t].shape[1]) for t in g.node_types),
            num_classes=g.num_classes,
            node_types=tuple(g.node_types),
            sg_names=tuple(sg.name for sg in sgs),
            num_edge_types=max((sg.num_edge_types for sg in sgs), default=1),
        )

    @property
    def feat_dim_map(self) -> Dict[str, int]:
        return dict(self.feat_dims)
