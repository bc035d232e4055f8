from repro_torch.data.synthetic import (  # noqa: F401
    make_acm,
    make_dblp,
    make_hetg,
    make_imdb,
)
from repro_torch.data.datasets import (  # noqa: F401
    load_hetgraph,
    register,
    resolve,
    save_hetgraph,
)
from repro_torch.data.sgb_cache import build_or_load, graph_fingerprint  # noqa: F401
