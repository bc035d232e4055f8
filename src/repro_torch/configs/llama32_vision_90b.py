"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — 80 self-attn + 20 gated cross-attn image layers (1:4).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend is a stub: the caller passes precomputed patch
embeddings (B, num_img_tokens, d_model) as ``prefill``'s ``context``, and
the gated cross-attention ("C") layers attend to them. ADE applies to the
cross-attention: with ``attn_prune_k`` set, the image tokens are the
neighbour set, pruned per query head through the top-K decode attention
kernel. The port serves it on one card with its depth cut
(``chip_smoke.py`` phase 11: 10 of 100 layers at full width, two whole
``A A A A C`` cycles; 171 GB in bfloat16 whole).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        cycle=("A", "A", "A", "A", "C"),
        rope_base=500_000.0,
        num_img_tokens=4096,
        param_dtype="bfloat16",
        fsdp=True,
        grad_accum=8,
        seq_shard_activations=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke",
        family="vlm",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        cycle=("A", "C"),
        num_img_tokens=16,
        dtype="float32",
        remat=False,
    )
