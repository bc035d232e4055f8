"""LM layers (the reference's ``repro/layers``): norms, RoPE, MLP, the
flash forward, GQA attention with the ADE-pruned decode branch and the
gated cross-attention, the MoE, the RG-LRU and RWKV-6 recurrences, and
the layer blocks. Functions over nested parameter dicts, as the reference's."""
