"""Architecture registry: ``get_config(name)`` / ``ARCHS``.

The reference's registry (``repro/configs/__init__.py``), names and
aliases included. One module per architecture that the port serves, each
with its exact public ``config()`` and a reduced ``smoke()`` of the same
family for CPU tests. An architecture whose layers are not ported yet
raises ``NotImplementedError`` naming its ROADMAP item; it never falls back
to another configuration.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "chatglm3_6b",
    "gemma3_4b",
    "qwen2_1_5b",
    "qwen2_72b",
    "arctic_480b",
    "olmoe_1b_7b",
    "recurrentgemma_2b",
    "llama32_vision_90b",
    "rwkv6_3b",
    "seamless_m4t_medium",
)

ALIASES = {
    "chatglm3-6b": "chatglm3_6b",
    "gemma3-4b": "gemma3_4b",
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen2-72b": "qwen2_72b",
    "arctic-480b": "arctic_480b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "rwkv6-3b": "rwkv6_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

PORTED = ("gemma3_4b", "qwen2_1_5b", "qwen2_72b", "chatglm3_6b", "arctic_480b", "olmoe_1b_7b",
          "recurrentgemma_2b", "rwkv6_3b")

# the ROADMAP item (section 1, "Slices left") that ports each remaining arch
_NOT_PORTED = {
    "llama32_vision_90b": "ROADMAP §1 LM-5 (cross-attention 'C' decode)",
    "seamless_m4t_medium": "ROADMAP §1 LM-6 (audio encoder-decoder 'E'/'D')",
}


def get_config(name: str, smoke: bool = False):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {sorted(ALIASES)}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{name} is not ported to repro_torch yet: {_NOT_PORTED[mod_name]}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke() if smoke else mod.config()
