"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — data-dependent decay linear recurrence. [arXiv:2404.05892; hf]

No attention scores exist, so the paper's technique is inapplicable here;
the arch runs without it. Decode is O(1) a token through the recurrent
state.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=40,  # d_model / rwkv_head_size
        num_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        cycle=("W",),
        rwkv_head_size=64,
        rwkv_chunk=32,
        norm="layernorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        cycle=("W",),
        rwkv_head_size=16,
        rwkv_chunk=8,
        norm="layernorm",
        dtype="float32",
        remat=False,
    )
