"""AdamW in functional form, the reference's ``repro/optim/adamw.py``
operation for operation.

``adamw(lr)`` returns an :class:`Optimizer` with ``init(params) -> state``
and ``update(grads, state, params) -> (params, state)``, where ``params``,
``grads`` and the moments are flat name → tensor mappings with the same
names. ``update`` is pure: it returns new tensors and writes to none of its
inputs, so a caller that keeps state in place (a captured training step)
copies the results back itself. It runs on whatever device the tensors are
on, the step counter included, so it reads nothing back to the host.

The order of operations is the reference's, which ``torch.optim.AdamW``
does not follow: the global gradient norm over all leaves in float32, the
clip ``min(1, clip / (norm + 1e-9))``, bias corrections ``1 - b ** step``
in float32, ``update = (m / bc1) / (sqrt(v / bc2) + eps) + wd · p``, then
``p - lr · update`` cast back to ``p``'s dtype. The moments are stored in
``moment_dtype`` (bfloat16 halves the optimizer's memory).

``update(..., reduce=)`` runs on one rank's shards of tensors split over a
device mesh (``launch/steps.py``'s sharded step): ``reduce.sums(names,
sums)`` completes each leaf's local sum of squares over the ranks that
split it, the only reduction AdamW makes; everything else is elementwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Union

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the params' device
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def adamw(
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip_norm: Optional[float] = 1.0,
    moment_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """AdamW with global-norm clipping. ``lr`` is a number or a schedule
    called with the step tensor (1 at the first update)."""

    def init(params: Mapping[str, torch.Tensor]) -> AdamWState:
        dev = next(iter(params.values())).device if params else None
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={n: torch.zeros_like(p, dtype=moment_dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=moment_dtype) for n, p in params.items()},
        )

    def update(grads: Mapping[str, torch.Tensor], state: AdamWState, params: Mapping[str, torch.Tensor],
               reduce=None):
        names = list(params)
        step = state.step + 1
        g32 = [grads[n].to(torch.float32) for n in names]
        if grad_clip_norm is not None:
            sq = [torch.sum(torch.square(g)) for g in g32]
            if reduce is not None:
                sq = reduce.sums(names, sq)
            gnorm = torch.sqrt(sum(sq))
            # a division, as the reference's (a float over a tensor would
            # be a reciprocal and a product in torch)
            scale = torch.clamp(torch.full_like(gnorm, grad_clip_norm) / (gnorm + 1e-9), max=1.0)
            g32 = torch._foreach_mul(g32, scale)
        lr_t = lr(step) if callable(lr) else lr
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)
        p32 = [params[n].to(torch.float32) for n in names]
        # each temporary is written in place once made here and dropped once
        # read, the same operations as out of place: at most two lists of
        # float32 temporaries beside m, v and the update
        m32 = torch._foreach_mul([state.mu[n].to(torch.float32) for n in names], b1)
        tmp = torch._foreach_mul(g32, 1 - b1)
        torch._foreach_add_(m32, tmp)
        v32 = torch._foreach_mul([state.nu[n].to(torch.float32) for n in names], b2)
        tmp = torch._foreach_mul(g32, g32)
        torch._foreach_mul_(tmp, 1 - b2)
        torch._foreach_add_(v32, tmp)
        del tmp, g32
        den = torch._foreach_div(v32, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(m32, bc1)
        torch._foreach_div_(upd, den)
        del den
        if weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p32, weight_decay))
        torch._foreach_mul_(upd, lr_t)
        new_p = torch._foreach_sub(p32, upd)
        del upd
        return (
            {n: p.to(params[n].dtype) for n, p in zip(names, new_p)},
            AdamWState(
                step=step,
                mu={n: m.to(moment_dtype) for n, m in zip(names, m32)},
                nu={n: v.to(moment_dtype) for n, v in zip(names, v32)},
            ),
        )

    return Optimizer(init=init, update=update)
