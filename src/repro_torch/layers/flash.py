"""Chunked online-softmax attention: the forward of the reference's flash
attention (``repro/layers/flash.py``, ``_flash_fwd_impl``) in plain torch.

The (S, S) logit matrix is never formed: an outer loop over query chunks
and an inner online-softmax loop over KV chunks keep live memory at one
(chunk_q, chunk_kv) block per head. Sliding-window layers process a static
(window + chunk_q) KV span per query chunk, rounded up to whole KV chunks,
so the work scales with the window, not the sequence. Positions are the
global arange (prefill). GQA is native: kv heads are the contraction batch,
q heads live in a 'group' axis. There is no backward here (training is a
later slice).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -2.3e38


def _masked_logits(qc, kc, q_pos, kv_pos, causal, window, scale, kv_len):
    """qc (B,cq,Hkv,g,hd), kc (B,ck,Hkv,hd) -> logits (B,Hkv,g,cq,ck) f32."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", qc, kc).float() * scale
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


def flash_fwd(q, k, v, causal: bool, window: Optional[int], scale: float, cq: int, ckv: int,
              kv_len: int) -> torch.Tensor:
    """q (B,S,H,hd) with S a multiple of cq; k, v (B,Skv,Hkv,hd) with Skv a
    multiple of ckv; kv rows at or past ``kv_len`` are masked."""
    b, s, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    nq = s // cq
    span = skv if window is None else min(skv, _round_up(window + cq, ckv))
    nkv = span // ckv
    dev = q.device
    outs = []
    for i in range(nq):
        qc = q[:, i * cq:(i + 1) * cq].reshape(b, cq, hkv, g, hd)
        qp = torch.arange(i * cq, (i + 1) * cq, device=dev)
        start = _span_start(i * cq, window, skv, span)
        m = torch.full((b, hkv, g, cq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, hd), dtype=q.dtype, device=dev)
        for j in range(nkv):
            lo = start + j * ckv
            kc, vc = k[:, lo:lo + ckv], v[:, lo:lo + ckv]
            kp = torch.arange(lo, lo + ckv, device=dev)
            logits = _masked_logits(qc, kc, qp, kp, causal, window, scale, kv_len)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            ex = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + ex.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", ex.to(vc.dtype), vc)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, cq, h, hd))
    return torch.cat(outs, dim=1)


def flash_attention(cfg, q, k, v, causal: bool = True, window: Optional[int] = None):
    """Public entry: pads to chunk multiples and runs the chunked forward.

    Assumes q positions are 0..S-1 and kv positions 0..Skv-1 (prefill).
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
    return flash_fwd(q, k, v, causal, window, scale, cq, ckv, skv)[:, :s]
