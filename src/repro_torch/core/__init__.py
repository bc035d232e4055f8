"""The paper's contribution in PyTorch: attention-disparity-exploiting HGNN
inference.

  * ``hetgraph``  — HetG container + Semantic Graph Build (SGB), numpy
  * ``attention`` — decomposed additive attention (Eq. 2), staged NA and
                    the fused NA (scan emulation or the flat kernel pair)
  * ``pruning``   — the staged_pruned flow's top-K keep-mask and the
                    streaming top-k (``lax.top_k``'s order)
  * ``flows``     — staged / staged_pruned / fused / fused_kernel flows
  * ``batch``     — ``GraphBatch``: the single model input
  * ``session``   — ``InferenceSession``: the serving entry
  * ``ego``       — ``EgoPlanner``/``EgoBatch``: a query's forward on its
                    targets' neighborhood
  * ``pipeline``  — dataset → SGB → model assembly
  * ``models``    — HAN, RGAT and Simple-HGN behind the ``HGNNModel``
                    protocol
"""
from repro_torch.core.batch import GraphBatch, ModelSpec  # noqa: F401
from repro_torch.core.ego import EgoBatch, EgoPlanner  # noqa: F401
from repro_torch.core.flows import FlowConfig  # noqa: F401
from repro_torch.core.session import InferenceSession  # noqa: F401
