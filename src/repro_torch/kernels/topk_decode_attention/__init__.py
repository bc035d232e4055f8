"""ADE top-K pruned decode attention: K1 score + prune + softmax and K2
value gather as CUDA C++ kernels (``csrc/``) beside their plain PyTorch
versions (``ref.py``); ``ops.py`` is the public wrapper."""
