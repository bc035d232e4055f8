"""Plain reference of the ``han`` configuration (HAN, Wang et al.,
arXiv:1903.07293, as the configuration file states it).

Node-level attention: the target type projected to H heads × dh (x W + b),
per metapath graph Eq. 2's scores and pruned NA (``refcore``), then ELU;
semantic attention: w_p = mean over targets of qᵀ tanh(W z_p + b), β =
softmax over metapaths, z = Σ_p β_p z_p; logits = z × W_out + b_out.
Parameter names follow the program's (``proj.<type>.{w,b}`` for every type,
``attn.<metapath>.{a_src,a_dst}``, ``sem.{w,b,q}``, ``out.{w,b}``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench import refcore

def param_shapes(graph: dict, cfg: dict, traffic: dict) -> Dict[str, tuple]:
    d = cfg["heads"] * cfg["dh"]
    out = {}
    for t, f in graph["feat_dims"].items():
        out[f"proj.{t}.w"] = (f, d)
        out[f"proj.{t}.b"] = (d,)
    for mp in traffic["metapaths"]:
        out[f"attn.{mp}.a_src"] = (cfg["heads"], cfg["dh"])
        out[f"attn.{mp}.a_dst"] = (cfg["heads"], cfg["dh"])
    out["sem.w"] = (d, cfg["sem_hidden"])
    out["sem.b"] = (cfg["sem_hidden"],)
    out["sem.q"] = (cfg["sem_hidden"],)
    out["out.w"] = (d, graph["num_classes"])
    out["out.b"] = (graph["num_classes"],)
    return out


def semantic_graphs(graph: dict, traffic: dict, cfg: dict):
    return refcore.metapath_graphs(graph, traffic["metapaths"], traffic["sgb_seed"])


def forward(params, feats, graph: dict, graphs, cfg: dict, margin_eps: float):
    """Logits (T, C) and the record of every NA (``refcore.Record``)."""
    heads, dh, k = cfg["heads"], cfg["dh"], cfg["prune_k"]
    counts = graph["node_counts"]
    lt = graph["label_type"]
    offs = refcore.type_offsets(counts)
    n_t = counts[lt]
    rec = refcore.Record(counts, margin_eps)
    # only the target type's rows are read: the table holds them at their
    # global offset, the other rows are never gathered
    h = torch.zeros((sum(counts.values()), heads, dh), dtype=feats[lt].dtype, device=feats[lt].device)
    h[offs[lt]: offs[lt] + n_t] = (feats[lt] @ params[f"proj.{lt}.w"] + params[f"proj.{lt}.b"]).reshape(-1, heads, dh)
    zs = []
    for g in graphs:
        th_src = refcore.theta(h, params[f"attn.{g.name}.a_src"])
        th_dst = refcore.theta(h[offs[lt]: offs[lt] + n_t], params[f"attn.{g.name}.a_dst"])
        z, kept, margin = refcore.pruned_na(h, th_src, th_dst, g, k)
        rec.na(0, g, kept, margin, th_src, h.shape)
        zs.append(F.elu(z.reshape(n_t, heads * dh)))
    rec.layer_done()
    stack = torch.stack(zs)
    e = torch.tanh(stack @ params["sem.w"] + params["sem.b"]) @ params["sem.q"]
    beta = torch.softmax(e.mean(dim=1), dim=0)
    fused = torch.einsum("p,ptd->td", beta, stack)
    return fused @ params["out.w"] + params["out.b"], rec


def flops(graph: dict, cfg: dict, traffic: dict, rec) -> int:
    """Model FLOPs of one forward: the target type's projection, Eq. 2's
    two contractions (2·D a target row each, a metapath), the aggregation
    (2·D a kept slot), the semantic attention's projection (2·T·D·S and
    2·T·S a metapath) and the readout (2·T·D·C). Elementwise work is not
    counted; nor are the other types' projections, which no output reads."""
    d, s = cfg["heads"] * cfg["dh"], cfg["sem_hidden"]
    lt = graph["label_type"]
    n_t = graph["node_counts"][lt]
    p = len(traffic["metapaths"])
    total = 2 * n_t * graph["feat_dims"][lt] * d
    total += p * (2 * 2 * n_t * d + 2 * n_t * d * s + 2 * n_t * s)
    total += 2 * rec.kept_slots() * d
    total += 2 * n_t * d * graph["num_classes"]
    return total
