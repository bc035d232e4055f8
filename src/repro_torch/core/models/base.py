"""The ``HGNNModel`` protocol: one interface for every HGNN architecture.

A model is an ``nn.Module`` whose parameters are registered under the
reference's tree paths (``proj.<type>.w``, ``attn.<metapath>.a_src``, …), so
``dict(model.named_parameters())`` is a flat parameter mapping in the same
naming as the reference's nested tree. The forward pass is functional over
such a mapping:

  * ``layer_steps(params, batch, flow)`` yields each layer's stages
    (FP -> NA per semantic graph -> fuse) as composable callables;
  * ``apply(params, batch, flow)`` is defined HERE as the fold of
    ``layer_steps`` and ``readout``, so running the stages by hand and
    calling ``apply`` are the same program;
  * ``forward(batch, flow)`` is ``apply`` over the module's own parameters.

Serving passes a mapping explicitly (``session(params)``), so one model
serves several weight versions.

``MODELS`` is the model registry: ``pipeline.prepare`` is table-driven over
it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Iterator, Mapping, Tuple

import torch
from torch import nn

from repro_torch import trace
from repro_torch.core import flows
from repro_torch.core.batch import GraphBatch, ModelSpec
from repro_torch.core.dtypes import canonical
from repro_torch.core.flows import FlowConfig
from repro_torch.core.projection import glorot_

Carry = object
Params = Mapping[str, torch.Tensor]


def frozen(*shape) -> nn.Parameter:
    """An inference-only parameter (no autograd state), zero until
    ``reset_parameters`` fills it."""
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


def projection(in_dims: Iterable[Tuple[str, int]], dim: int) -> nn.ModuleDict:
    """Feature-projection parameters ``<type>.w`` (F_t, dim) and
    ``<type>.b`` (dim,) for every ``(type, F_t)``."""
    return nn.ModuleDict({
        t: nn.ParameterDict({"w": frozen(f, dim), "b": frozen(dim)}) for t, f in in_dims
    })


def reset_projection(proj: nn.ModuleDict, generator: torch.Generator) -> None:
    """Glorot weights and zero biases, types in sorted order."""
    for t in sorted(proj):
        glorot_(proj[t]["w"], generator)
        proj[t]["b"].data.zero_()


@dataclasses.dataclass(frozen=True)
class LayerStep:
    """One layer's stages as independent callables.

    ``project(carry) -> h`` — the layer's Feature Projection to the
    (N, H, dh) global table. ``na`` — ``(semantic_graph_name, fn)`` pairs in
    dispatch order; ``fn(h) -> z`` runs that graph's score decomposition +
    NA. ``fuse(carry, h, zs) -> carry'`` closes the layer.
    """

    index: int
    project: Callable[[Carry], torch.Tensor]
    na: Tuple[Tuple[str, Callable[[torch.Tensor], torch.Tensor]], ...]
    fuse: Callable[[Carry, torch.Tensor, Dict[str, torch.Tensor]], Carry]


class HGNNModel(nn.Module):
    """Base class / protocol all HGNN models implement."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialization of every parameter from ``generator``."""
        raise NotImplementedError

    def layer_steps(
        self, params: Params, batch: GraphBatch, flow: FlowConfig = FlowConfig()
    ) -> Iterator[LayerStep]:
        raise NotImplementedError

    def readout(self, params: Params, batch: GraphBatch, carry: Carry) -> torch.Tensor:
        """Final carry -> (num_targets, num_classes) logits."""
        raise NotImplementedError

    def ego_globals(self, params: Params, batch: GraphBatch, flow: FlowConfig = FlowConfig()):
        """Graph-global quantities an ego forward (``core/ego.py``) cannot
        compute from a sliced neighborhood, as a mapping of tensors the
        ego batch injects; ``None`` for a model whose layers are row-local
        (RGAT, Simple-HGN)."""
        return None

    def apply(
        self, params: Params, batch: GraphBatch, flow: FlowConfig = FlowConfig()
    ) -> torch.Tensor:
        """The canonical forward pass: fold ``layer_steps`` then ``readout``.
        (Replaces ``nn.Module.apply``, which this protocol does not use.)
        float64 parameters compute as float32, as in the reference
        (``core/dtypes.py``). One ``flows.mesh_scope()`` around it resolves
        the ambient mesh at most once, however many NA dispatches run.
        Its stages (``project``, ``na.<graph>``: Eq. 2, NA and what the
        model does to NA's output, ``fuse``, ``readout``) are marked for
        ``trace.stage_ms``: CUDA events in a session captured under device
        tracing, nothing anywhere else."""
        params = {n: canonical(p) for n, p in params.items()}
        with flows.mesh_scope():
            carry: Carry = dict(batch.features)
            for step in self.layer_steps(params, batch, flow):
                trace.mark("project")
                h = step.project(carry)
                zs = {}
                for name, fn in step.na:
                    trace.mark(f"na.{name}")
                    zs[name] = fn(h)
                trace.mark("fuse")
                carry = step.fuse(carry, h, zs)
            trace.mark("readout")
            out = self.readout(params, batch, carry)
            trace.mark(None)
            return out

    def forward(self, batch: GraphBatch, flow: FlowConfig = FlowConfig()) -> torch.Tensor:
        return self.apply(dict(self.named_parameters()), batch, flow)


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """How ``pipeline.prepare`` assembles one architecture: ``factory(spec)``
    builds the module; ``sgb_kind`` names the Semantic Graph Build it
    consumes (``"metapath"`` for HAN, ``"relation"`` for RGAT, ``"union"``
    for Simple-HGN)."""

    name: str
    factory: Callable[[ModelSpec], HGNNModel]
    sgb_kind: str

    @property
    def needs_metapaths(self) -> bool:
        return self.sgb_kind == "metapath"


MODELS: Dict[str, ModelEntry] = {}


def register_model(
    name: str, factory: Callable[[ModelSpec], HGNNModel], sgb_kind: str
) -> None:
    """Register an architecture under ``name`` (overwrites)."""
    if sgb_kind not in ("metapath", "relation", "union"):
        raise ValueError(f"unknown sgb_kind {sgb_kind!r}")
    MODELS[name] = ModelEntry(name=name, factory=factory, sgb_kind=sgb_kind)


def get_entry(name: str) -> ModelEntry:
    try:
        return MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; registered: {sorted(MODELS)}"
        ) from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(MODELS))
