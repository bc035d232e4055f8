"""HAN (Wang et al., WWW'19) — metapath-based HGNN.

Node-level attention: one GAT per metapath graph (decomposed per Eq. 2);
semantic-level attention fuses the per-metapath embeddings. Paper
settings: 8 heads × dh 8 = hidden 64, semantic-attention hidden 128, one
layer.

The forward pass is one ``LayerStep`` (``num_layers`` is 1, the depth an
ego closure expands to): ``project`` builds the global projected table,
each ``na`` entry runs one NA dispatch per metapath graph (one launch of
each fused kernel under ``fused_kernel``), and ``fuse`` is the
semantic-level attention. Its β is a mean over every target, which an ego
forward cannot compute from a neighborhood: ``ego_globals`` computes it on
the full graph and an ego batch injects it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import attention, flows, semantic_fusion
from repro_torch.core.batch import GraphBatch, ModelSpec
from repro_torch.core.dtypes import canonical, matmul
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


class HAN(HGNNModel):
    def __init__(self, spec: ModelSpec, heads: int = 8, dh: int = 8, sem_hidden: int = 128):
        super().__init__()
        self.heads, self.dh, self.num_layers = heads, dh, 1
        self.dim = heads * dh
        self.num_classes = spec.num_classes
        self.proj = projection(spec.feat_dims, self.dim)
        self.attn = nn.ModuleDict({
            mp: nn.ParameterDict({"a_src": frozen(heads, dh), "a_dst": frozen(heads, dh)})
            for mp in spec.sg_names
        })
        self.sem = nn.ParameterDict({
            "w": frozen(self.dim, sem_hidden),
            "b": frozen(sem_hidden),
            "q": frozen(sem_hidden),
        })
        self.out = nn.ParameterDict({
            "w": frozen(self.dim, spec.num_classes),
            "b": frozen(spec.num_classes),
        })

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform weights, zero biases, drawn in a fixed order from
        ``generator`` (on the CPU, so every device gets the same values;
        move the module afterwards)."""
        reset_projection(self.proj, generator)
        for mp in self.attn:
            glorot_(self.attn[mp]["a_src"], generator)
            glorot_(self.attn[mp]["a_dst"], generator)
        glorot_(self.sem["w"], generator)
        self.sem["b"].data.zero_()
        glorot_(self.sem["q"].data.view(-1, 1), generator)
        glorot_(self.out["w"], generator)
        self.out["b"].data.zero_()

    def layer_steps(self, params: Params, batch: GraphBatch, flow: FlowConfig = FlowConfig()):
        num_targets = batch.num_targets
        dst_sl = slice(batch.dst_offset, batch.dst_offset + num_targets)

        def project(carry):
            return batch.constrain(
                project_features(params, carry, batch.node_types, self.heads, self.dh),
                "features",
            )

        def na_fn(sg):
            a_src = params[f"attn.{sg.name}.a_src"]
            a_dst = params[f"attn.{sg.name}.a_dst"]

            def na(h):
                sc = attention.decompose_scores(h, a_src, a_dst, dst_slice=dst_sl)
                z = run_aggregate_graph(flow, h, sc, sg)
                return F.elu(z.reshape(num_targets, self.dim))

            return na

        def fuse(carry, h, zs):
            stack = torch.stack([zs[sg.name] for sg in batch.sgs])
            injected = getattr(batch, "ego_globals", None) or {}
            if "sem_beta" in injected:
                # an ego forward: β of the full graph, injected
                return semantic_fusion.fuse_with_beta(injected["sem_beta"], stack)
            return semantic_fusion.semantic_attention(params, stack)

        yield LayerStep(
            index=0,
            project=project,
            na=tuple((sg.name, na_fn(sg)) for sg in batch.sgs),
            fuse=fuse,
        )

    def readout(self, params: Params, batch: GraphBatch, carry) -> torch.Tensor:
        return batch.constrain(matmul(carry, params["out.w"]) + params["out.b"], "logits")

    def ego_globals(self, params: Params, batch: GraphBatch, flow: FlowConfig = FlowConfig()):
        """``{"sem_beta": β}``, the semantic attention over the FULL graph:
        one forward up to the fusion stage (on the card, under
        ``fused_kernel``, kernel #1 once per metapath), no readout. Callers
        cache it per weight version. It runs on one device, with no mesh
        (no lookup): an ego forward is replicated."""
        params = {n: canonical(p) for n, p in params.items()}
        step = next(iter(self.layer_steps(params, batch, flow)))
        with torch.inference_mode(), flows.mesh_scope(pinned=None):
            h = step.project(dict(batch.features))
            zs = {name: fn(h) for name, fn in step.na}
            stack = torch.stack([zs[sg.name] for sg in batch.sgs])
            return {"sem_beta": semantic_fusion.semantic_beta(params, stack)}
