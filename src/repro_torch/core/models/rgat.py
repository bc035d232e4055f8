"""RGAT (Wang et al., ACL'20) — relation-based HGNN.

One GAT per relation semantic graph per layer; the per-type fusion is the
mean over the self projection and the incoming-relation messages, in
semantic-graph dispatch order. Paper settings: 8 heads × dh 8 = hidden 64,
3 layers.

``layer_steps`` yields one step per layer: ``project`` re-projects the
per-type carry into the global table, each ``na`` entry is one relation
graph's NA dispatch, ``fuse`` averages per destination type. Parameters
are ``layers.<l>.proj.<type>.{w,b}``, ``layers.<l>.attn.<relation>.{a_src,
a_dst}`` and ``out.{w,b}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import attention
from repro_torch.core.batch import GraphBatch, ModelSpec
from repro_torch.core.dtypes import matmul
from repro_torch.core.flows import FlowConfig, run_aggregate_graph
from repro_torch.core.models.base import (
    HGNNModel,
    LayerStep,
    Params,
    frozen,
    projection,
    reset_projection,
)
from repro_torch.core.projection import glorot_, project_features


class RGAT(HGNNModel):
    def __init__(self, spec: ModelSpec, heads: int = 8, dh: int = 8, num_layers: int = 3):
        super().__init__()
        self.heads, self.dh, self.num_layers = heads, dh, num_layers
        self.dim = heads * dh
        self.num_classes = spec.num_classes
        self.layers = nn.ModuleList([
            nn.ModuleDict({
                "proj": projection(
                    spec.feat_dims if l == 0 else [(t, self.dim) for t in spec.node_types],
                    self.dim,
                ),
                "attn": nn.ModuleDict({
                    rn: nn.ParameterDict({"a_src": frozen(heads, dh), "a_dst": frozen(heads, dh)})
                    for rn in spec.sg_names
                }),
            })
            for l in range(num_layers)
        ])
        self.out = nn.ParameterDict({
            "w": frozen(self.dim, spec.num_classes),
            "b": frozen(spec.num_classes),
        })

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform weights, zero biases, drawn layer by layer in a
        fixed order from ``generator`` (on the CPU; move the module
        afterwards)."""
        for layer in self.layers:
            reset_projection(layer["proj"], generator)
            for rn in layer["attn"]:
                glorot_(layer["attn"][rn]["a_src"], generator)
                glorot_(layer["attn"][rn]["a_dst"], generator)
        glorot_(self.out["w"], generator)
        self.out["b"].data.zero_()

    def layer_steps(self, params: Params, batch: GraphBatch, flow: FlowConfig = FlowConfig()):
        node_types = batch.node_types
        offsets, num_nodes = batch.offsets, batch.num_nodes

        for l in range(self.num_layers):
            pre = f"layers.{l}."

            def project(carry, pre=pre):
                return batch.constrain(
                    project_features(params, carry, node_types, self.heads, self.dh, pre),
                    "features",
                )

            def na_fn(sg, pre=pre):
                a_src = params[f"{pre}attn.{sg.name}.a_src"]
                a_dst = params[f"{pre}attn.{sg.name}.a_dst"]
                t = sg.dst_type
                dst_sl = slice(offsets[t], offsets[t] + num_nodes[t])

                def na(h):
                    sc = attention.decompose_scores(h, a_src, a_dst, dst_slice=dst_sl)
                    return run_aggregate_graph(flow, h, sc, sg)

                return na

            def fuse(carry, h, zs):
                # the self projection, then each relation's message in
                # semantic-graph dispatch order
                agg = {t: [h[offsets[t]: offsets[t] + num_nodes[t]]] for t in node_types}
                for sg in batch.sgs:
                    agg[sg.dst_type].append(zs[sg.name])
                return {
                    t: F.elu(torch.stack(agg[t]).mean(dim=0).reshape(num_nodes[t], self.dim))
                    for t in node_types
                }

            yield LayerStep(
                index=l,
                project=project,
                na=tuple((sg.name, na_fn(sg)) for sg in batch.sgs),
                fuse=fuse,
            )

    def readout(self, params: Params, batch: GraphBatch, carry) -> torch.Tensor:
        z = carry[batch.label_type]
        return batch.constrain(matmul(z, params["out.w"]) + params["out.b"], "logits")
