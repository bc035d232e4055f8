"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
5:1 local:global attention, 128k context, head_dim 256, dual RoPE bases.
[hf:google/gemma-3-1b-pt; unverified]

`long_500k` runs for this arch: 5/6 of layers are O(window) sliding-window;
the global layers use the ADE top-K pruned decode attention (attn_prune_k),
making the per-token decode cost O(w·L_local + K·L_global).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        cycle=("L", "L", "L", "L", "L", "A"),
        sliding_window=1024,
        rope_base=1_000_000.0,
        rope_local_base=10_000.0,
        activation="geglu",
        tie_embeddings=True,
        logit_softcap=30.0,
        attn_prune_k=2048,  # ADE pruning on the global layers (decode)
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke",
        family="dense",
        num_layers=3,  # exercises the remainder-group path (cycle len 2)
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        cycle=("L", "A"),
        sliding_window=16,
        rope_base=1_000_000.0,
        rope_local_base=10_000.0,
        activation="geglu",
        tie_embeddings=True,
        attn_prune_k=8,
        dtype="float32",
        remat=False,
    )
