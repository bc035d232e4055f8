"""Port parity: LM training of the recurrent and cross-attention families
against the reference (float32 smoke configs, the same numpy-seeded inputs
through both packages, the port's weights converted from the reference's):
recurrentgemma-2b (RG-LRU "R" and windowed "L" blocks), rwkv6-3b ("W"),
llama-3.2-vision-90b (gated cross-attention "C" over image embeddings) and
seamless-m4t-medium (the audio encoder "E" and decoder "D" blocks).
``forward_train`` logits (1e-5), ``loss_fn`` (1e-5) and every gradient leaf
within 1e-4 of its largest magnitude; ``remat`` on and off give equal
gradients through the doubling scan and the encoder. The dense and MoE
archs are in ``tests/test_torch_lm_train.py``, with the flash backward, the
train step and the optimizers."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_lm_parity as P  # noqa: E402
# autouse fixtures of every module that imports them
from torch_lm_parity import end_leaked_serve_threads, one_intra_op_thread  # noqa: E402,F401

FAMILIES = ("recurrentgemma_2b", "rwkv6_3b", "llama32_vision_90b", "seamless_m4t_medium")


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_loss_and_grads_match_reference(arch):
    """See the module docstring (``torch_lm_parity.check_forward_train``)."""
    P.check_forward_train(arch)


@pytest.mark.parametrize("arch", ("recurrentgemma_2b", "seamless_m4t_medium"))
def test_remat_gives_equal_gradients(arch):
    """``remat`` on and off: loss and gradients bit for bit
    (``torch_lm_parity.check_remat``)."""
    P.check_remat(arch)
