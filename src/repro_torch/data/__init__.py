from repro_torch.data.datasets import resolve  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    make_acm,
    make_dblp,
    make_hetg,
    make_imdb,
)
