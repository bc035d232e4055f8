"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16) d_ff=1024, MoE 64
experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        cycle=("M",),
        moe=MoEConfig(num_experts=64, top_k=8, expert_d_ff=1024),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=64,
        vocab_size=256,
        cycle=("M",),
        moe=MoEConfig(num_experts=8, top_k=4, expert_d_ff=64, group_size=32),
        dtype="float32",
        remat=False,
    )
