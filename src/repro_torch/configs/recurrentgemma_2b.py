"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — Griffin: RG-LRU recurrent blocks + local attention, 2:1.
[arXiv:2402.19427; hf]

Attention-free recurrent blocks make decode O(1) a token; the
local-attention layers keep a 2048-window cache.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        cycle=("R", "R", "L"),
        sliding_window=2048,
        lru_width=2560,
        conv_width=4,
        activation="geglu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        num_layers=4,  # R R L + remainder R
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        cycle=("R", "R", "L"),
        sliding_window=16,
        lru_width=64,
        conv_width=4,
        activation="geglu",
        tie_embeddings=True,
        dtype="float32",
        remat=False,
    )
