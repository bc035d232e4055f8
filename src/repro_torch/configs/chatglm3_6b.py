"""chatglm3-6b [dense] — 28L d4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
RoPE applied to half the head dims ("2d" partial rotary), GQA, QKV bias.
[arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        cycle=("A",),
        qkv_bias=True,
        rope_fraction=0.5,
        activation="swiglu",
        norm="rmsnorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        cycle=("A",),
        qkv_bias=True,
        rope_fraction=0.5,
        dtype="float32",
        remat=False,
    )
