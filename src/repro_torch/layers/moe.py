"""Mixture-of-Experts with GShard-style dense dispatch (the reference's
``repro/layers/moe.py``).

Tokens are flattened over (B·S), zero-padded to whole groups of
``sg = min(group_size, B·S)`` rows and routed per group: top-K experts by
a sequential argmax over the router's float32 probabilities, each expert
holding at most ``capacity`` tokens of a group, later tokens past it
dropped (standard GShard). A decode step routes its B tokens as one group.
The dispatch and combine tensors are the reference's (G, S, E, C) one-hot
slot maps, bit for bit, and the expert products are dense einsums over all
E experts, as the reference computes them: at decode that reads every
expert's weights, not only the routed ones.

Returns the load-balance plus router z-loss auxiliary loss as the reference
does; serving drops it. In a sharded train step each rank routes its own
rows as whole groups, and the two per-expert means the load-balance loss
multiplies are averaged over the ranks first (``sharding.batch_mean``), so
the loss is the whole batch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding


def moe_shapes(cfg):
    """``{"router": {"w": (d, E)}, "experts": {"wi", "wg": (E, d, f), "wo":
    (E, f, d)}}``, the reference's tree."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    return {
        "router": {"w": (d, e)},
        "experts": {"wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)},
    }


def capacity(cfg, sg: int) -> int:
    """Slots per expert in a group of ``sg`` tokens: the reference's
    expression, in its order of operations."""
    m = cfg.moe
    return max(int(sg * m.top_k / m.num_experts * m.capacity_factor + 0.5), m.top_k)


def _topk_dispatch(probs: torch.Tensor, top_k: int, capacity: int):
    """probs (G, S, E) -> dispatch (G, S, E, C) 0/1, combine (G, S, E, C)
    weights, in ``probs``' dtype.

    Ties go to the lowest expert (``argmax`` takes the first maximum). A
    token whose slot is at or past ``capacity`` gets a zero slot row
    (dropped), as ``jax.nn.one_hot`` gives for an index out of range."""
    g, s, e = probs.shape
    dt = probs.dtype
    slots = torch.arange(capacity, dtype=dt, device=probs.device)
    remaining = probs
    counts = torch.zeros((g, 1, e), dtype=dt, device=probs.device)
    dispatch = torch.zeros((g, s, e, capacity), dtype=dt, device=probs.device)
    gate_sum = torch.zeros((g, s), dtype=dt, device=probs.device)
    combine = torch.zeros((g, s, e, capacity), dtype=dt, device=probs.device)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)  # (G, S)
        mask = F.one_hot(idx, e).to(dt)  # (G, S, E)
        gate = (probs * mask).sum(-1)  # (G, S)
        pos = torch.cumsum(mask, dim=1) - mask + counts  # (G, S, E)
        pos_tok = (pos * mask).sum(-1)  # (G, S)
        keep = (pos_tok < capacity).to(dt)
        oh_c = (pos_tok[..., None] == slots).to(dt)  # zero row past capacity
        slotted = mask[..., None] * oh_c[:, :, None, :] * keep[..., None, None]
        dispatch = dispatch + slotted
        combine = combine + gate[..., None, None] * slotted
        gate_sum = gate_sum + gate * keep
        counts = counts + mask.sum(dim=1, keepdim=True)
        remaining = remaining * (1.0 - mask)
    combine = combine / torch.clamp(gate_sum, min=1e-9)[..., None, None]
    return dispatch, combine


def apply_moe(cfg, params, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d) in ``x``'s dtype, aux loss float32
    scalar). ``params["router"]["w"]`` is read in float32, the expert
    weights in ``cfg.dtype``."""
    m = cfg.moe
    dt = cfg.adtype
    b, s, d = x.shape
    sg = min(m.group_size, b * s)
    tokens = x.reshape(-1, d)
    pad = (-tokens.shape[0]) % sg
    if pad:  # pad to a full dispatch group; padded rows are sliced off below
        tokens = F.pad(tokens, (0, 0, 0, pad))
    ng = tokens.shape[0] // sg
    xs = tokens.reshape(ng, sg, d)

    logits = xs.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)  # (G, S, E) float32

    dispatch, combine = _topk_dispatch(probs, m.top_k, capacity(cfg, sg))
    dispatch_c, combine_c = dispatch.to(dt), combine.to(dt)

    ex = params["experts"]
    xe = torch.einsum("gsec,gsd->egcd", dispatch_c, xs.to(dt))  # (E, G, C, d)
    h = torch.einsum("egcd,edf->egcf", xe, ex["wi"].to(dt))
    gsig = torch.einsum("egcd,edf->egcf", xe, ex["wg"].to(dt))
    h = F.silu(gsig) * h
    ye = torch.einsum("egcf,efd->egcd", h, ex["wo"].to(dt))
    y = torch.einsum("gsec,egcd->gsd", combine_c, ye).reshape(-1, d)
    if pad:
        y = y[: b * s]

    # GShard load-balance aux + router z-loss
    me = sharding.batch_mean(probs.mean(dim=(0, 1)))  # (E,)
    ce = sharding.batch_mean(dispatch_c.float().sum(-1).mean(dim=(0, 1))) * (m.num_experts / m.top_k)
    lb_loss = m.num_experts * torch.sum(me * ce)
    z_loss = m.router_z_loss * torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return y.reshape(b, s, d).to(x.dtype), lb_loss + z_loss
