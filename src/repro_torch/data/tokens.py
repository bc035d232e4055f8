"""Deterministic synthetic token pipeline for LM training (the reference's
``repro/data/tokens.py``).

Sharded per data-parallel host slice and deterministic as a function of
(seed, step, shard), so restarts and elastic rescales resume exactly
(skip-ahead is O(1), no replay). The "corpus" is a Zipfian token source
with planted bigram structure, so cross entropy is learnable. The tokens
are drawn on the host with numpy, the reference's code line for line, and
are the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # elastic/data-parallel slicing: this host produces rows
    # [shard * global_batch // num_shards, (shard+1) * global_batch // num_shards)
    shard: int = 0
    num_shards: int = 1

    def _rows(self):
        per = self.global_batch // self.num_shards
        return per

    def batch_np(self, step: int) -> dict:
        """Deterministic batch for ``step`` (numpy, host-side)."""
        rows = self._rows()
        ss = np.random.SeedSequence([self.seed, step, self.shard])
        rng = np.random.default_rng(ss)
        # zipf-ish marginal with planted bigram structure:
        # tok[t+1] = (a * tok[t] + drift) % V with prob p, else zipf sample
        v = self.vocab_size
        zipf = rng.zipf(1.3, size=(rows, self.seq_len + 1)) % v
        toks = zipf.astype(np.int64)
        a = 31337 % v
        follow = (toks[:, :-1] * a + 7) % v
        use = rng.random((rows, self.seq_len)) < 0.5
        toks[:, 1:] = np.where(use, follow, toks[:, 1:])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def batch(self, step: int, device="cpu") -> dict:
        """``batch_np(step)`` as int32 tensors on ``device``."""
        return {k: torch.from_numpy(v).to(device) for k, v in self.batch_np(step).items()}
