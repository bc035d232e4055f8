from repro_torch.core.models.base import (  # noqa: F401
    MODELS,
    HGNNModel,
    LayerStep,
    ModelEntry,
    available,
    get_entry,
    register_model,
)
from repro_torch.core.models.han import HAN  # noqa: F401
from repro_torch.core.models.rgat import RGAT  # noqa: F401
from repro_torch.core.models.simple_hgn import SimpleHGN  # noqa: F401

register_model("han", HAN, "metapath")
register_model("rgat", RGAT, "relation")
register_model("simple_hgn", SimpleHGN, "union")
