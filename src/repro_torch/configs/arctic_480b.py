"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]

480B total / ~17B active. The training fields (bf16 params, FSDP,
Adafactor, sequence-sharded activations) are the reference's sharded
training plan; the port serves this config on one card only with its depth
cut (``chip_smoke.py`` phase 11: 1 of 35 layers at full width).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        cycle=("M",),
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            expert_d_ff=4864,
            dense_residual=True,
        ),
        param_dtype="bfloat16",
        fsdp=True,
        optimizer="adafactor",
        grad_accum=8,
        seq_shard_activations=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        cycle=("M",),
        moe=MoEConfig(
            num_experts=4, top_k=2, expert_d_ff=96,
            dense_residual=True, group_size=32,
        ),
        dtype="float32",
        remat=False,
        optimizer="adafactor",
    )
