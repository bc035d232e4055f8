"""Port parity: LM training of the dense and MoE archs against the
reference (float32 smoke configs, the same numpy-seeded inputs through both
packages, the port's weights converted from the reference's, with QKV
biases, norm scales, experts and routers redrawn so that each moves the
loss): qwen2-1.5b, qwen2-72b, chatglm3-6b, gemma3-4b, olmoe-1b-7b and
arctic-480b. ``forward_train`` logits (1e-5), the aux loss, ``loss_fn``
(1e-5) and every gradient leaf within 1e-4 of its largest magnitude, the
MoE aux loss included. The recurrent and cross-attention archs are in
``tests/test_torch_lm_train_families.py``."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_lm_parity as P  # noqa: E402
# autouse fixtures of every module that imports them
from torch_lm_parity import end_leaked_serve_threads, one_intra_op_thread  # noqa: E402,F401

DENSE_MOE = ("qwen2_1_5b", "qwen2_72b", "chatglm3_6b", "gemma3_4b", "olmoe_1b_7b", "arctic_480b")


@pytest.mark.parametrize("arch", DENSE_MOE)
def test_forward_train_loss_and_grads_match_reference(arch):
    """See the module docstring (``torch_lm_parity.check_forward_train``)."""
    P.check_forward_train(arch)
