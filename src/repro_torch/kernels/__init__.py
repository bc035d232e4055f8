"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

  * ``fused_prune_aggregate`` — ADE fused NA, K1 prune + softmax and K2
    gather-aggregate, as two pairs of CUDA C++ kernels in ``csrc/``: one
    over a grouped bucket layout (all buckets of a graph in one launch),
    one over a flat ``(T, D)`` padded-CSC table.
  * ``topk_decode_attention`` — ADE-pruned LM decode attention, K1 score +
    top-K retention + softmax and K2 value gather, as a pair of CUDA C++
    kernels in ``csrc/``.
  * ``topk_select`` — the standalone Pruner (paper §5.2): streaming top-k
    of masked (T, D) scores, values and slot ids, as one CUDA C++ kernel
    in ``csrc/``.

A kernel package holds ``ops.py`` (the public wrapper: the plain version for
CPU tensors, the CUDA kernel for CUDA tensors, never a fallback between
them), ``ref.py`` (the plain version) and ``csrc/`` (the CUDA sources,
built with ``nvcc`` at first use by :mod:`repro_torch.kernels.build`).
"""
