"""ADE-HGNN in PyTorch with hand-written CUDA kernels for Hopper.

A port of the ``repro`` package's pruned HGNN inference path, of its LM
serving path (prefill + decode, ADE-pruned where a config sets
``attn_prune_k``; all ten archs of the registry, the cross-attention ones
with their stub image or audio context) and of its
standalone Pruner (``kernels/topk_select``). The module
layout follows ``repro`` one for one (``repro_torch/core/flows.py`` is the
counterpart of ``repro/core/flows.py``, ``repro_torch/models/lm.py`` of
``repro/models/lm.py``); inside, models are ``nn.Module``s and everything
else is plain functions on tensors.

Rules every module keeps:

  * entry points take an explicit ``device``, default ``"cuda"``, and raise
    when no GPU is present unless the caller passed ``device="cpu"``
    (:func:`resolve_device`) — nothing drops to the CPU on its own;
  * randomness comes from explicit ``torch.Generator``s or seeded numpy;
  * the HGNN path computes in the dtype the reference does (JAX's
    promotion, ``core/dtypes.py``: float32 for the published setup, and
    float32 features against bfloat16 weights stay float32); the LM path
    computes in ``cfg.dtype`` as the reference does (bfloat16 activations
    for the published configs); TF32 is off for matmuls and convolutions
    (set below, at import), so a float32 product on the card keeps full
    float32 precision.
"""
from __future__ import annotations

import numpy as np
import torch

# float32 means float32: no TF32 rounding in cuBLAS or cuDNN
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` without a GPU raises:
    the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def from_host(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. A read-only array (a view
    into a mapped file, as an SGB cache hit hands out) is copied first, so
    no tensor shares memory with the mapping; a writable one is shared on
    the CPU, as ``torch.from_numpy`` shares it."""
    if not a.flags.writeable:
        a = np.array(a)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
