from repro_torch.core.models.base import (  # noqa: F401
    MODELS,
    HGNNModel,
    LayerStep,
    ModelEntry,
    get_entry,
    register_model,
)
from repro_torch.core.models.han import HAN  # noqa: F401

register_model("han", HAN, "metapath")
