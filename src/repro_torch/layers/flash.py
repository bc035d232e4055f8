"""Chunked online-softmax attention with a flash backward: the reference's
flash attention (``repro/layers/flash.py``) in plain torch.

The (S, S) logit matrix is never formed: an outer loop over query chunks
and an inner online-softmax loop over KV chunks keep live memory at one
(chunk_q, chunk_kv) block per head. Sliding-window layers process a static
(window + chunk_q) KV span per query chunk, rounded up to whole KV chunks,
so the work scales with the window, not the sequence. Positions are the
global arange (train and prefill). GQA is native: kv heads are the
contraction batch, q heads live in a 'group' axis.

Training. Plain autograd through the chunk loops would keep every
(chunk_q, chunk_kv) probability block for the backward, O(S²) memory.
:class:`Flash`, the counterpart of the reference's ``jax.custom_vjp``,
saves only (q, k, v, out, row max m, row sum l) and its backward is the
reference's ``_flash_bwd`` operation for operation: ``D = rowsum(dO ⊙ O)``
in float32, each probability block recomputed chunk by chunk from m and l,
dq accumulated in q's dtype, dk and dv accumulated into the query chunk's
KV span in k's dtype. :func:`flash_attention` runs through it whenever
autograd records (grad enabled and an input requiring grad); prefill runs
the forward alone and keeps no residuals.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -2.3e38


def _block(q0: int, cq: int, lo: int, ckv: int, causal: bool, window: Optional[int], kv_len: int) -> str:
    """How the mask covers the block of queries q0..q0+cq-1 against keys
    lo..lo+ckv-1: ``"none"`` valid (a key below ``kv_len``, at or before
    the query when causal, within the window), ``"all"`` masked, else
    ``"some"``. A block masked whole adds nothing to the reference's
    result (its probabilities exp(NEG - m) are 0 once a row has met a valid
    key; what a window's leading blocks add before that, the next block's
    correction exp(NEG - m) zeroes), so the loops skip it; a block masked
    nowhere skips the mask. Either gives the reference's values."""
    q1, hi = q0 + cq - 1, lo + ckv - 1
    if lo >= kv_len or (causal and lo > q1) or (window is not None and hi <= q0 - window):
        return "all"
    if hi < kv_len and (not causal or hi <= q0) and (window is None or lo > q1 - window):
        return "none"
    return "some"


def _masked_logits(qc, kc, q_pos, kv_pos, causal, window, scale, kv_len, masked: str = "some"):
    """qc (B,cq,Hkv,g,hd), kc (B,ck,Hkv,hd) -> logits (B,Hkv,g,cq,ck) f32;
    ``masked`` is the block's ``_block``."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", qc, kc).float() * scale
    if masked == "none":
        return logits
    mask = (kv_pos[None, :] < kv_len).expand(qc.shape[1], kc.shape[1])
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    return torch.where(mask[None, None, None], logits, NEG)


def _span_start(q0: int, window: Optional[int], skv: int, span: int) -> int:
    if window is None:
        return 0
    return min(max(q0 - window, 0), skv - span)


def _round_up(x: int, m: int) -> int:
    return x + (-x) % m


def _span(skv: int, window: Optional[int], cq: int, ckv: int) -> int:
    return skv if window is None else min(skv, _round_up(window + cq, ckv))


def flash_fwd(q, k, v, causal: bool, window: Optional[int], scale: float, cq: int, ckv: int,
              kv_len: int, residuals: bool = False):
    """q (B,S,H,hd) with S a multiple of cq; k, v (B,Skv,Hkv,hd) with Skv a
    multiple of ckv; kv rows at or past ``kv_len`` are masked. Returns out
    (B,S,H,hd); with ``residuals`` also each query chunk's float32 row max
    and row sum, both (S/cq, B, Hkv, g, cq), as the reference's
    ``_flash_fwd_impl`` returns them."""
    b, s, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    nq = s // cq
    span = _span(skv, window, cq, ckv)
    nkv = span // ckv
    dev = q.device
    outs, ms, ls = [], [], []
    for i in range(nq):
        qc = q[:, i * cq:(i + 1) * cq].reshape(b, cq, hkv, g, hd)
        qp = torch.arange(i * cq, (i + 1) * cq, device=dev)
        start = _span_start(i * cq, window, skv, span)
        m = torch.full((b, hkv, g, cq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, hd), dtype=q.dtype, device=dev)
        for j in range(nkv):
            lo = start + j * ckv
            masked = _block(i * cq, cq, lo, ckv, causal, window, kv_len)
            if masked == "all":
                continue
            kc, vc = k[:, lo:lo + ckv], v[:, lo:lo + ckv]
            kp = torch.arange(lo, lo + ckv, device=dev)
            logits = _masked_logits(qc, kc, qp, kp, causal, window, scale, kv_len, masked)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            ex = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + ex.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", ex.to(vc.dtype), vc)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, cq, h, hd))
        ms.append(m)
        ls.append(l)
    out = torch.cat(outs, dim=1)
    if residuals:
        return out, torch.stack(ms), torch.stack(ls)
    return out


def flash_bwd(q, k, v, out, ms, ls, dout, causal: bool, window: Optional[int], scale: float, cq: int,
              ckv: int, kv_len: int):
    """The reference's ``_flash_bwd``: (dq, dk, dv) of ``flash_fwd`` at
    (q, k, v) given its out, row maxima ``ms`` and row sums ``ls`` and the
    output's gradient ``dout``."""
    b, s, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    nq = s // cq
    span = _span(skv, window, cq, ckv)
    nkv = span // ckv
    dev = q.device
    d_all = (dout.float() * out.float()).sum(-1)  # D_i = rowsum(dO ⊙ O), (B,S,H)
    d_all = d_all.reshape(b, nq, cq, hkv, g).permute(1, 0, 3, 4, 2)  # (nq,B,Hkv,g,cq)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    dqs = []
    for i in range(nq):
        qc = q[:, i * cq:(i + 1) * cq].reshape(b, cq, hkv, g, hd)
        doc = dout[:, i * cq:(i + 1) * cq].reshape(b, cq, hkv, g, hd)
        qp = torch.arange(i * cq, (i + 1) * cq, device=dev)
        m, l, dq_row = ms[i], ls[i], d_all[i]
        start = _span_start(i * cq, window, skv, span)
        dq = torch.zeros_like(qc)
        for j in range(nkv):
            lo = start + j * ckv
            masked = _block(i * cq, cq, lo, ckv, causal, window, kv_len)
            if masked == "all":
                continue
            kc, vc = k[:, lo:lo + ckv], v[:, lo:lo + ckv]
            kp = torch.arange(lo, lo + ckv, device=dev)
            logits = _masked_logits(qc, kc, qp, kp, causal, window, scale, kv_len, masked)
            p = torch.exp(logits - m[..., None]) / torch.clamp(l, min=1e-30)[..., None]
            dv[:, lo:lo + ckv] += torch.einsum("bkgqs,bqkgd->bskd", p.to(doc.dtype), doc)
            dp = torch.einsum("bqkgd,bskd->bkgqs", doc, vc).float()
            dsl = p * (dp - dq_row[..., None])
            dsl_k = dsl.to(kc.dtype)
            dsl_q = dsl_k if qc.dtype == kc.dtype else dsl.to(qc.dtype)
            dq = dq + torch.einsum("bkgqs,bskd->bqkgd", dsl_k, kc) * scale
            dk[:, lo:lo + ckv] += torch.einsum("bkgqs,bqkgd->bskd", dsl_q, qc) * scale
        dqs.append(dq.reshape(b, cq, h, hd))
    return torch.cat(dqs, dim=1), dk, dv


class Flash(torch.autograd.Function):
    """``flash_fwd`` with the flash backward (the reference's custom VJP):
    the forward saves (q, k, v, out, m, l) and nothing of its chunk loop."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, cq, ckv, kv_len):
        out, ms, ls = flash_fwd(q, k, v, causal, window, scale, cq, ckv, kv_len, residuals=True)
        ctx.save_for_backward(q, k, v, out, ms, ls)
        ctx.args = (causal, window, scale, cq, ckv, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, ms, ls = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, ms, ls, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(cfg, q, k, v, causal: bool = True, window: Optional[int] = None):
    """Public entry: pads to chunk multiples and runs the chunked forward,
    through :class:`Flash` when autograd records.

    Assumes q positions are 0..S-1 and kv positions 0..Skv-1 (train and
    prefill).
    """
    b, s, h, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5
    cq = min(cfg.attn_chunk_q, _round_up(s, 128))
    ckv = min(cfg.attn_chunk_kv, _round_up(skv, 128))
    sp = (-s) % cq
    kp = (-skv) % ckv
    if sp:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sp))
    if kp:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kp))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kp))
    # padded kv rows are excluded by the kv_len term of the mask.
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return Flash.apply(q, k, v, causal, window, scale, cq, ckv, skv)[:, :s]
    return flash_fwd(q, k, v, causal, window, scale, cq, ckv, skv)[:, :s]
