"""Optimizers and learning-rate schedules, in the functional form of the
reference's ``repro.optim``: an optimizer is ``init(params) -> state`` and
``update(grads, state, params) -> (params, state)`` over flat name → tensor
mappings."""
from repro_torch.optim.adafactor import AdafactorState, FactoredSlot, adafactor  # noqa: F401
from repro_torch.optim.adamw import AdamWState, Optimizer, adamw  # noqa: F401
from repro_torch.optim.schedules import cosine_schedule, linear_warmup  # noqa: F401
