"""ADE fused NA: K1 prune + softmax and K2 gather-aggregate, over a grouped
bucket layout and over a flat padded-CSC table, as CUDA C++ kernels
(``csrc/``) beside their plain PyTorch versions (``ref.py``); ``ops.py`` is
the public wrapper."""
