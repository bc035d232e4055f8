"""Adafactor (Shazeer & Stern, 2018) with factored second moments, the
reference's ``repro/optim/adafactor.py`` operation for operation.

``adafactor(lr)`` returns an :class:`Optimizer` (the one of
``optim/adamw.py``) with ``init(params) -> state`` and ``update(grads,
state, params) -> (params, state)`` over flat name → tensor mappings.
``update`` is pure: it returns new tensors and writes to none of its inputs.

Per leaf: ``g2 = g² + eps`` in float32; a leaf of two or more axes keeps a
factored second moment over its last two axes (``row``: the mean over the
last axis, ``col``: the mean over the one before, so an (E, d, f) expert
tensor keeps (E, d) rows and (E, f) columns), any other leaf a ``full`` one;
``beta = 1 - step^-decay``; ``u = g / sqrt(v + eps)`` (``eps`` added a
second time), divided by ``max(1, rms(u) / clip_threshold)`` over the leaf;
``p - lr · u`` in float32, cast back to the parameter's dtype.

Stacks. The reference stacks an LM's layers: each block leaf is one array
over a group's cycle repeats (``(n, ...)``), and its update is one leaf's.
That moves two things: the RMS clip is taken over all n layers together,
and a stacked vector (n, d) is factored (n rows, d columns shared by the
layers). ``stacks`` names those groups in the port's flat naming
(``models.lm.layer_stacks``); the update stacks each group's tensors along
a new first axis, updates them as one leaf and splits the result. Each
name keeps its own slice of the slots (``row`` and ``col`` of a stacked
matrix, ``row`` of a stacked vector, a 0-d one, ``full`` of a stacked
scalar); a stacked vector's columns belong to the whole group and each of
its names holds them (the update reads the first name's).

``update(..., reduce=)`` runs on one rank's shards of tensors split over a
device mesh (``launch/steps.py``'s sharded step): each mean over a leaf's
dims goes through ``reduce.mean(name, x, dim, leaf_dims, keepdim)``, which
completes it over the ranks that split those dims (``leaf_dims``: the
updated leaf's dims, counted from the end); the rest is elementwise.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.optim.adamw import Optimizer

Tensors = Dict[str, torch.Tensor]


class FactoredSlot(NamedTuple):
    row: Optional[torch.Tensor]  # (..., n) or None
    col: Optional[torch.Tensor]  # (..., m) or None
    full: Optional[torch.Tensor]  # unfactored, for a leaf of fewer than two axes


class AdafactorState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the params' device
    slots: Dict[str, FactoredSlot]


def _units(names: Sequence[str], stacks: Sequence[Sequence[str]]) -> List[List[str]]:
    """The update's leaves: each stack as one, every other name alone."""
    stacked = {n for group in stacks for n in group}
    return [list(g) for g in stacks] + [[n] for n in names if n not in stacked]


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def adafactor(
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    stacks: Sequence[Sequence[str]] = (),
) -> Optimizer:
    """Adafactor. ``lr`` is a number or a schedule called with the step
    tensor (1 at the first update); ``stacks`` groups names updated as one
    stacked leaf (see the module docstring)."""

    def init(params: Mapping[str, torch.Tensor]) -> AdafactorState:
        dev = next(iter(params.values())).device if params else None
        slots = {}
        stacked = {n for g in stacks for n in g}
        for unit in _units(list(params), stacks):
            group = unit[0] in stacked
            for name in unit:
                shape = tuple(params[name].shape)
                ndim = len(shape) + (1 if group else 0)
                if ndim < 2:
                    slots[name] = FactoredSlot(None, None, _zeros(shape, dev))
                elif group and len(shape) == 1:  # a stacked vector: columns shared
                    slots[name] = FactoredSlot(_zeros((), dev), _zeros(shape, dev), None)
                else:
                    slots[name] = FactoredSlot(_zeros(shape[:-1], dev), _zeros(shape[:-2] + shape[-1:], dev), None)
        return AdafactorState(step=torch.zeros((), dtype=torch.int32, device=dev), slots=slots)

    def plain_mean(x, dim, leaf_dims, keepdim=False):
        return torch.mean(x) if dim is None else x.mean(dim=dim, keepdim=keepdim)

    def upd(p, g, s: FactoredSlot, beta, lr_t, mean=plain_mean):
        g32 = g.to(torch.float32)
        g2 = torch.square(g32) + eps
        if s.full is not None:
            v = beta * s.full + (1 - beta) * g2
            u = g32 / torch.sqrt(v + eps)
            new_s = FactoredSlot(None, None, v)
        else:
            row = beta * s.row + (1 - beta) * mean(g2, -1, (-1,))
            col = beta * s.col + (1 - beta) * mean(g2, -2, (-2,))
            rfac = row / mean(row, -1, (-2,), keepdim=True)
            v = rfac[..., None] * col[..., None, :]
            u = g32 / torch.sqrt(v + eps)
            new_s = FactoredSlot(row, col, None)
        rms = torch.sqrt(mean(torch.square(u), None, None) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        new_p = (p.to(torch.float32) - lr_t * u).to(p.dtype)
        return new_p, new_s

    def update(grads: Mapping[str, torch.Tensor], state: AdafactorState, params: Mapping[str, torch.Tensor],
               reduce=None):
        step = state.step + 1
        beta = 1.0 - step.to(torch.float32) ** (-decay)
        lr_t = lr(step) if callable(lr) else lr
        new_params: Tensors = {}
        new_slots: Dict[str, FactoredSlot] = {}
        stacked = {n for g in stacks for n in g}
        for unit in _units(list(params), stacks):
            mean = plain_mean if reduce is None else (
                lambda x, dim, leaf_dims, keepdim=False, name=unit[0]: reduce.mean(name, x, dim, leaf_dims, keepdim))
            if unit[0] not in stacked:
                name = unit[0]
                new_params[name], new_slots[name] = upd(params[name], grads[name], state.slots[name], beta, lr_t, mean)
                continue
            first = state.slots[unit[0]]
            vector = first.row is not None and first.row.dim() == 0

            def stack(part):
                if getattr(first, part) is None:
                    return None
                if part == "col" and vector:
                    return first.col
                return torch.stack([getattr(state.slots[n], part) for n in unit])

            p, s = upd(torch.stack([params[n] for n in unit]), torch.stack([grads[n] for n in unit]),
                       FactoredSlot(stack("row"), stack("col"), stack("full")), beta, lr_t, mean)
            for r, name in enumerate(unit):
                new_params[name] = p[r]
                new_slots[name] = FactoredSlot(
                    None if s.row is None else s.row[r],
                    None if s.col is None else (s.col if vector else s.col[r]),
                    None if s.full is None else s.full[r],
                )
        names = list(params)
        return ({n: new_params[n] for n in names},
                AdafactorState(step=step, slots={n: new_slots[n] for n in names}))

    return Optimizer(init=init, update=update)
