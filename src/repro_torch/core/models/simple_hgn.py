"""Simple-HGN (Lv et al., KDD'21) — GAT over the whole heterograph with
learnable edge-type embeddings in the attention logits.

θ_e = LeakyReLU(a_srcᵀh'_u + a_dstᵀh'_v + a_relᵀr_ψ(e)): the relation term
is per edge type, so the ADE decomposition still holds and the pruner
ranks by a_srcᵀh'_u + a_relᵀr_ψ(e), both target-independent. Paper
settings: 8 heads × dh 8 = hidden 64, 2 layers, rel_dim 8, residual
connections.

``layer_steps`` yields one step per layer whose ``na`` entries run one
union-graph NA dispatch per destination type (in ``node_types`` order; the
edge-type ids reach the kernels with θ_rel) and whose ``fuse`` adds the
residual projection ``carry[t] @ res[t]``. Parameters are
``layers.<l>.proj.<type>.{w,b}``, ``layers.<l>.{a_src,a_dst,a_rel}``,
``layers.<l>.rel_emb`` (R, H·rel_dim), ``layers.<l>.res.<type>`` and
``out.{w,b}``.
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


class _Layer(nn.Module):
    def __init__(self, in_dims, heads, dh, rel_dim, num_edge_types):
        super().__init__()
        dim = heads * dh
        self.proj = projection(in_dims, dim)
        self.a_src = frozen(heads, dh)
        self.a_dst = frozen(heads, dh)
        self.a_rel = frozen(heads, rel_dim)
        self.rel_emb = frozen(num_edge_types, heads * rel_dim)
        self.res = nn.ParameterDict({t: frozen(f, dim) for t, f in in_dims})


class SimpleHGN(HGNNModel):
    def __init__(
        self, spec: ModelSpec, heads: int = 8, dh: int = 8, num_layers: int = 2,
        rel_dim: int = 8,
    ):
        super().__init__()
        self.heads, self.dh, self.num_layers = heads, dh, num_layers
        self.rel_dim = rel_dim
        self.dim = heads * dh
        self.num_classes = spec.num_classes
        self.layers = nn.ModuleList([
            _Layer(
                spec.feat_dims if l == 0 else [(t, self.dim) for t in spec.node_types],
                heads, dh, rel_dim, spec.num_edge_types,
            )
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
            reset_projection(layer.proj, generator)
            for p in (layer.a_src, layer.a_dst, layer.a_rel, layer.rel_emb):
                glorot_(p, generator)
            for t in sorted(layer.res):
                glorot_(layer.res[t], generator)
        glorot_(self.out["w"], generator)
        self.out["b"].data.zero_()

    def layer_steps(self, params: Params, batch: GraphBatch, flow: FlowConfig = FlowConfig()):
        node_types = batch.node_types
        offsets, num_nodes = batch.offsets, batch.num_nodes
        by_dst = batch.sg_by_dst

        for l in range(self.num_layers):
            pre = f"layers.{l}."

            def project(carry, pre=pre):
                return batch.constrain(
                    project_features(params, carry, node_types, self.heads, self.dh, pre),
                    "features",
                )

            def na_fn(sg, pre=pre):
                t = sg.dst_type
                dst_sl = slice(offsets[t], offsets[t] + num_nodes[t])

                def na(h):
                    rel_emb = params[f"{pre}rel_emb"].reshape(-1, self.heads, self.rel_dim)
                    sc = attention.decompose_scores(
                        h, params[f"{pre}a_src"], params[f"{pre}a_dst"], dst_slice=dst_sl,
                        rel_emb=rel_emb, a_rel=params[f"{pre}a_rel"],
                    )
                    return run_aggregate_graph(flow, h, sc, sg)

                return na

            def fuse(carry, h, zs, pre=pre):
                return {
                    t: F.elu(
                        zs[by_dst[t].name].reshape(num_nodes[t], self.dim)
                        + matmul(carry[t], params[f"{pre}res.{t}"])
                    )
                    for t in node_types
                }

            yield LayerStep(
                index=l,
                project=project,
                na=tuple((by_dst[t].name, na_fn(by_dst[t])) for t in node_types),
                fuse=fuse,
            )

    def readout(self, params: Params, batch: GraphBatch, carry) -> torch.Tensor:
        z = carry[batch.label_type]
        return batch.constrain(matmul(z, params["out.w"]) + params["out.b"], "logits")
