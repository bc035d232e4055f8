"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA, QKV bias. [arXiv:2407.10671; hf]

72B params: FSDP (ZeRO-3) over the data axis + TP over the model axis;
bf16 params with f32 AdamW moments sharded the same way (the reference's
training plan). The port serves it on one card with its depth cut
(``chip_smoke.py`` phase 11: 8 of 80 layers at full width).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        cycle=("A",),
        qkv_bias=True,
        rope_base=1_000_000.0,
        param_dtype="bfloat16",
        fsdp=True,
        grad_accum=8,
        seq_shard_activations=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        cycle=("A",),
        qkv_bias=True,
        dtype="float32",
        remat=False,
    )
