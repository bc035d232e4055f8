"""Architecture registry: ``get_config(name)`` / ``ARCHS``.

The reference's registry (``repro/configs/__init__.py``), names and
aliases included. One module per architecture, each with its exact
public ``config()`` and a reduced ``smoke()`` of the same family for CPU
tests; the port serves all ten. An unknown name raises ``ValueError``.
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


def get_config(name: str, smoke: bool = False):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke() if smoke else mod.config()
