"""The standalone Pruner (paper §5.2): streaming top-k of masked (T, D)
scores as a CUDA C++ kernel (``csrc/``) beside its plain PyTorch versions
(``ref.py``); ``ops.py`` is the public wrapper."""
from repro_torch.kernels.topk_select.ops import topk_select  # noqa: F401
