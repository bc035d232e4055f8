"""Parameters from the reference package's HAN tree.

The reference keeps HAN's parameters as a nested tree of arrays::

    {"proj": {type: {"w": (F, H·dh), "b": (H·dh,)}},
     "attn": {metapath: {"a_src": (H, dh), "a_dst": (H, dh)}},
     "sem":  {"w": (H·dh, hidden), "b": (hidden,), "q": (hidden,)},
     "out":  {"w": (H·dh, C), "b": (C,)}}

:func:`params_from_reference` takes that tree with numpy arrays as leaves
(convert the reference's arrays with ``np.asarray`` first) and returns the
port's flat parameter mapping, named as ``HAN.named_parameters()`` names
them (``"proj.paper.w"``, ``"attn.PAP.a_src"``, …). Weights keep the
reference's ``(in, out)`` layout — the port multiplies ``x @ w`` too — so no
tensor is transposed.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if "." in str(key):
            raise ValueError(f"parameter key {name!r} contains '.'")
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def params_from_reference(tree: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's nested HAN parameter tree (numpy leaves) as the
    port's flat float32 parameter mapping on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in _flatten(tree).items():
        if not isinstance(leaf, np.ndarray):
            raise TypeError(
                f"{name}: leaves must be numpy arrays (np.asarray the "
                f"reference's arrays), got {type(leaf).__name__}"
            )
        out[name] = torch.tensor(leaf, dtype=torch.float32, device=dev)
    return out
