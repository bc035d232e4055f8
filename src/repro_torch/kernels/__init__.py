"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

  * ``fused_prune_aggregate`` — ADE fused NA over a grouped bucket layout:
    K1 prune + softmax, K2 gather-aggregate (CUDA C++ in ``csrc/``).

A kernel package holds ``ops.py`` (the public wrapper: the plain version for
CPU tensors, the CUDA kernel for CUDA tensors, never a fallback between
them), ``ref.py`` (the plain version) and ``csrc/`` (the CUDA sources,
built with ``nvcc`` at first use by :mod:`repro_torch.kernels.build`).
"""
