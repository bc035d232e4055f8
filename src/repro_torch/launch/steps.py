"""Step functions and input specs for every (arch × shape) cell (the
reference's ``repro/launch/steps.py``, the parts one card has).

``input_specs``, ``state_specs`` and ``cache_specs`` give every model input,
the parameters and optimizer state, and the decode cache as tensors on the
``meta`` device (shapes and dtypes, no memory); ``make_train_step`` /
``make_prefill_step`` / ``make_decode_step`` build the step callables over
flat name → tensor parameters. The reference's sharding functions
(``data_shardings``, ``cache_shardings``, ``params_shardings``) wait for the
port's parameter sharding (ROADMAP §1 LM-8).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM, layer_stacks
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedules import cosine_schedule

Tensors = Dict[str, torch.Tensor]
META = torch.device("meta")


# ---------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention: run only for ssm/hybrid and the
# 5:1-local gemma3 (ADE-pruned global layers).
LONG_OK = {"rwkv6-3b", "recurrentgemma-2b", "gemma3-4b"}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name.split("-smoke")[0] not in LONG_OK:
        return False, "pure full-attention arch: 500k decode is skipped per assignment"
    return True, ""


def smoke_shape(shape: ShapeSpec) -> ShapeSpec:
    """Reduced copy for CPU tests."""
    return ShapeSpec(shape.name, shape.kind, min(shape.seq, 64), min(shape.global_batch, 8))


# ---------------------------------------------------------------- optimizer
def make_optimizer(cfg: ModelConfig):
    """The reference's: a cosine schedule (peak 3e-4, 200 warm-up steps,
    10,000 in all) under Adafactor (``cfg.optimizer == "adafactor"``, its
    leaves stacked as the reference's, ``models.lm.layer_stacks``) or AdamW
    with weight decay 0.1."""
    sched = cosine_schedule(3e-4, 200, 10_000)
    if cfg.optimizer == "adafactor":
        return adafactor(lr=sched, stacks=layer_stacks(cfg))
    return adamw(lr=sched, weight_decay=0.1)


# ---------------------------------------------------------------- specs
def _ctx_spec(cfg: ModelConfig, batch: int):
    n = cfg.num_img_tokens or cfg.num_audio_frames
    if n:
        return torch.empty((batch, n, cfg.d_model), dtype=cfg.adtype, device=META)
    return None


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Tensors:
    """``meta`` stand-ins for the step functions' data inputs."""
    b, s = shape.global_batch, shape.seq
    if shape.kind in ("train", "prefill"):
        out = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
        if shape.kind == "train":
            out["labels"] = torch.empty((b, s), dtype=torch.int32, device=META)
        ctx = _ctx_spec(cfg, b)
        if ctx is not None:
            out["context"] = ctx
        return out
    # decode: one new token against a seq-long cache
    return {
        "token": torch.empty((b, 1), dtype=torch.int32, device=META),
        "pos": torch.empty((), dtype=torch.int32, device=META),
    }


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The decode cache for ``shape`` on ``meta``."""
    return LM(cfg, device=META).init_cache(shape.global_batch, shape.seq)


def state_specs(cfg: ModelConfig, with_opt: bool):
    """(parameters, optimizer state or None) on ``meta``."""
    params = {n: p.detach() for n, p in LM(cfg, device=META).named_parameters()}
    if not with_opt:
        return params, None
    return params, make_optimizer(cfg).init(params)


# ---------------------------------------------------------------- steps
def grow_allocator_segments() -> None:
    """Have the CUDA caching allocator grow its segments
    (``expandable_segments``), from now on and process-wide, unless
    ``PYTORCH_CUDA_ALLOC_CONF`` chose its settings. A training step frees
    and asks again for (micro, S, vocab) float32 blocks of several GB among
    parameter-sized ones; fixed segments split those blocks for smaller
    requests, and the cache then holds free memory it cannot hand out
    (recurrentgemma-2b at 12 layers, S 4096: 7.81 GiB refused with 28.69
    GiB cached and free; NVIDIA H100 80GB HBM3, 700.00 W)."""
    if "PYTORCH_CUDA_ALLOC_CONF" in os.environ:
        return
    configure = getattr(torch._C, "_accelerator_setAllocatorSettings", None) or \
        torch.cuda.memory._set_allocator_settings
    configure("expandable_segments:True")


def make_train_step(cfg: ModelConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``, the reference's: with ``cfg.grad_accum`` a > 1 and the batch
    divisible by it, microbatch i is rows [i·b/a, (i+1)·b/a), whose
    gradients add into float32 zeros; loss and gradients are then divided by
    a; else one gradient of the whole batch. Then the optimizer's update.
    The step is pure: it returns new tensors and writes to none of its
    inputs (a failed step leaves the state as it was). Its first call on
    the card calls :func:`grow_allocator_segments`."""
    model = LM(cfg, device=META)
    opt = make_optimizer(cfg)
    on_card = []

    def value_and_grad(params: Mapping[str, torch.Tensor], batch):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = model.loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(params: Mapping[str, torch.Tensor], opt_state, batch: Mapping[str, torch.Tensor]):
        if not on_card and batch["tokens"].is_cuda:
            grow_allocator_segments()
            on_card.append(True)
        a = cfg.grad_accum
        b = batch["tokens"].shape[0]
        if a > 1 and b % a == 0:
            m = b // a
            dev = batch["tokens"].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
            for i in range(a):
                l, g = value_and_grad(params, {k: v[i * m:(i + 1) * m] for k, v in batch.items()})
                loss = loss + l
                for n, acc in grads.items():
                    acc.add_(g[n])  # acc + g in float32, into zeros this step owns
                del g
            loss = loss / a
            for acc in grads.values():
                acc.div_(a)
        else:
            loss, grads = value_and_grad(params, batch)
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, loss

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeSpec):
    """``prefill_step(params, batch) -> (last logits, decode cache for
    shape.seq positions)``."""
    model = LM(cfg, device=META)

    def prefill_step(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor]):
        with torch.no_grad():
            return model.prefill(batch["tokens"], max_len=shape.seq, context=batch.get("context"), params=params)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``, the
    cache updated in place."""
    model = LM(cfg, device=META)

    def decode_step(params: Mapping[str, torch.Tensor], token, pos, cache):
        with torch.no_grad():
            return model.decode_step(token, pos, cache, params=params)

    return decode_step
