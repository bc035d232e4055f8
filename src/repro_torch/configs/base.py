"""Model configuration schema shared by all assigned architectures.

A copy of the reference's ``repro/configs/base.py``, field for field, with
``adtype`` and ``pdtype`` returning torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    group_size: int = 512  # GShard dispatch group size (tokens)
    router_z_loss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # layer pattern: kinds repeated cyclically to length num_layers.
    #   A=global attn+mlp, L=local(sliding) attn+mlp, M=attn+moe,
    #   R=recurrent(RG-LRU)+mlp, W=rwkv(time+channel mix), C=cross-attn+mlp
    cycle: Tuple[str, ...] = ("A",)

    qkv_bias: bool = False
    rope_base: float = 10000.0
    rope_fraction: float = 1.0  # chatglm3: 0.5 (2d/partial rotary)
    rope_local_base: Optional[float] = None  # gemma3 local layers
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | geglu | gelu_mlp
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    moe: Optional[MoEConfig] = None

    # hybrid (RG-LRU) extras
    lru_width: Optional[int] = None
    conv_width: int = 4

    # ssm (rwkv6) extras
    rwkv_head_size: int = 64
    rwkv_chunk: int = 64

    # vlm / audio stub frontends
    num_img_tokens: int = 0  # >0: cross-attn K/V come from image embeddings
    num_audio_frames: int = 0  # >0: enc-dec; encoder input frames
    enc_layers: int = 0  # audio: encoder depth (decoder = num_layers)

    # ADE technique (the paper's contribution applied to this arch)
    attn_prune_k: Optional[int] = None  # top-K KV pruning during decode
    hier_topk: bool = False  # distributed retention domain: shard-local
    #   top-K then global merge over the cache_seq shards — turns the
    #   (B,H,S) logits gather into a (B,H,shards·K) one (§Perf).

    # execution
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    grad_accum: int = 4  # microbatches per train step (activation memory /4)
    attn_chunk_q: int = 1024  # flash-style chunking for long prefill
    attn_chunk_kv: int = 1024

    # sharding strategy keys (see distributed/sharding.py)
    fsdp: bool = False  # shard params over the data axis too (ZeRO-3)
    seq_shard_activations: bool = False  # Megatron-SP style: residual stream
    #   sharded over the model axis on seq; GSPMD all-gathers only at
    #   attention. Memory / (model axis) for the saved remat residuals.
    optimizer: str = "adamw"  # adamw | adafactor (arctic: AdamW won't fit)

    def __post_init__(self):
        assert self.family in ("dense", "moe", "hybrid", "ssm", "vlm", "audio")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def adtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def pdtype(self):
        return torch.bfloat16 if self.param_dtype == "bfloat16" else torch.float32

    def pattern(self) -> Tuple[str, ...]:
        reps = -(-self.num_layers // len(self.cycle))
        return (self.cycle * reps)[: self.num_layers]

    def layer_groups(self):
        """[(cycle, n_repeats)] covering the pattern; full cycles are scanned,
        the remainder (if any) forms a second single-repeat group."""
        p = self.pattern()
        n_full = len(p) // len(self.cycle)
        groups = []
        if n_full:
            groups.append((tuple(self.cycle), n_full))
        rem = p[n_full * len(self.cycle):]
        if rem:
            groups.append((tuple(rem), 1))
        return groups

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        hd, nh, nkv = self.hd, self.num_heads, self.num_kv_heads
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for kind in self.pattern():
            if kind in ("A", "L", "M", "C"):
                attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                total += attn
            if kind in ("A", "L", "C"):
                total += self._mlp_params(self.d_ff, d)
            if kind == "M":
                m = self.moe
                total += d * m.num_experts  # router
                total += m.num_experts * self._mlp_params(m.expert_d_ff, d)
                if m.dense_residual:
                    total += self._mlp_params(self.d_ff, d)
            if kind == "R":
                w = self.lru_width or d
                total += 2 * d * w + w * d + 3 * w + w * self.conv_width
                total += self._mlp_params(self.d_ff, d)
            if kind == "W":
                total += 6 * d * d  # wr wk wv wg wo + channel-mix receptance
                total += 2 * 64 * d  # data-dependent decay lora (rank 64)
                total += 2 * d * self.d_ff  # channel mix
        if self.family == "audio":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.enc_layers * (
                d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                + self._mlp_params(self.d_ff, d)
            )
            cross = self.num_layers * (
                d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            )
            total += enc + cross
        return total

    def _mlp_params(self, dff: int, d: int) -> int:
        if self.activation in ("swiglu", "geglu"):
            return 3 * d * dff
        return 2 * d * dff
