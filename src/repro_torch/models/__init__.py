"""Language models: ``LM`` and ``build_model`` (the reference's
``repro/models``)."""
from repro_torch.models.lm import LM, build_model  # noqa: F401
