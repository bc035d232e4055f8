"""seamless-m4t-medium [audio] — enc-dec, 12L each, d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 — multimodal translation backbone.
[arXiv:2308.11596; hf]

The speech frontend is a stub: the caller passes precomputed fbank frame
embeddings (B, num_audio_frames, d_model) as ``prefill``'s ``context``,
which the "E" encoder layers encode once. Each "D" decoder layer runs a
self-attention, then a cross-attention over the encoded frames; with
``attn_prune_k`` set both prune during decode (ADE top-K), through the
top-K decode attention kernel.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        num_layers=12,  # decoder
        enc_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        cycle=("A",),
        qkv_bias=True,
        norm="layernorm",
        activation="gelu_mlp",
        num_audio_frames=1024,
        grad_accum=8,
        seq_shard_activations=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke",
        family="audio",
        num_layers=2,
        enc_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        cycle=("A",),
        qkv_bias=True,
        norm="layernorm",
        activation="gelu_mlp",
        num_audio_frames=16,
        dtype="float32",
        remat=False,
    )
