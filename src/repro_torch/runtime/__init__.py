"""The training runtime (the reference's ``repro/runtime``)."""
from repro_torch.runtime.trainer import Trainer, TrainConfig  # noqa: F401
