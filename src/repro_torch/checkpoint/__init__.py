"""Checkpoints (the reference's ``repro/checkpoint``)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    flatten_train_state,
    unflatten_train_state,
)
