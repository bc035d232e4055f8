"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        cycle=("A",),
        qkv_bias=True,
        rope_base=1_000_000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke",
        family="dense",
        num_layers=2,
        d_model=48,
        num_heads=6,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        cycle=("A",),
        qkv_bias=True,
        tie_embeddings=True,
        dtype="float32",
        remat=False,
    )
