"""Step functions and input specs for every (arch × shape) cell (the
reference's ``repro/launch/steps.py``, the parts one card has).

``input_specs``, ``state_specs`` and ``cache_specs`` give every model input,
the parameters and optimizer state, and the decode cache as tensors on the
``meta`` device (shapes and dtypes, no memory); ``make_train_step`` /
``make_prefill_step`` / ``make_decode_step`` build the step callables over
flat name → tensor parameters. ``data_shardings``, ``cache_shardings`` and
``params_shardings`` give each of those a ``sharding.Sharding`` on a mesh,
its spec entry for entry the reference's ``NamedSharding``'s (a per-layer
leaf of the port takes its stacked leaf's spec without the layer dim);
``make_train_step`` runs the sharded step when the parameters are DTensors
placed by them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_reference_path
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Sharding, shard_batch_dim  # noqa: F401 (the reference's name here)
from repro_torch.kernels.common import is_fake
from repro_torch.models.lm import LM, layer_stacks
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.adafactor import AdafactorState, FactoredSlot
from repro_torch.optim.adamw import AdamWState
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


# ---------------------------------------------------------------- sharding
_batch_axes = sharding.batch_axes  # the reference's name here


def data_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, Sharding]:
    """Shardings of the step functions' data inputs: rows over the batch
    axes, the rest replicated."""
    b = shape.global_batch
    bspec = sharding.spec_entry(_batch_axes(mesh, b))

    def ns(*spec):
        return Sharding(mesh, tuple(spec))

    if shape.kind in ("train", "prefill"):
        out = {"tokens": ns(bspec, None)}
        if shape.kind == "train":
            out["labels"] = ns(bspec, None)
        if _ctx_spec(cfg, b) is not None:
            out["context"] = ns(bspec, None, None)
        return out
    return {"token": ns(bspec, None), "pos": ns()}


def cache_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, cache_shapes):
    """Shardings of a decode cache of ``shape.global_batch`` rows
    (``sharding.cache_shardings``)."""
    return sharding.cache_shardings(cfg, shape.global_batch, mesh, cache_shapes)


def _stacked(n: Optional[int], shape) -> Tuple[int, ...]:
    return tuple(shape) if n is None else (n,) + tuple(shape)


def params_shardings(cfg: ModelConfig, mesh, params_shapes: Mapping[str, torch.Tensor], opt_shapes=None):
    """(parameter shardings by name, optimizer-state shardings in the
    state's structure, or ``None``). Specs come from the reference's name
    patterns on each leaf's reference path (``convert.lm_reference_path``)
    and stacked shape, with ``cfg.fsdp``; a per-layer leaf drops the layer
    dim's entry. AdamW's moments take their parameter's path under
    ``mu/`` / ``nu/``; Adafactor's slots ``slots/<path>/.row`` (``.col``,
    ``.full``), each at the stacked shape the reference's slot has (a
    stacked vector's shared columns are not stacked), so the anchored
    patterns miss them as the reference's do."""
    ref, want = {}, {}  # reference path -> stacked shape; key -> (path, layer dim dropped)

    def add(key, path, n, shape):
        ref[path] = _stacked(n, shape)
        want[key] = (path, n is not None)

    for name, t in params_shapes.items():
        path, n = lm_reference_path(cfg, name)
        add(("p", name), path, n, t.shape)
    if opt_shapes is not None:
        for name, t in params_shapes.items():
            path, n = lm_reference_path(cfg, name)
            if isinstance(opt_shapes, AdamWState):
                for part in ("mu", "nu"):
                    add((part, name), f"{part}/{path}", n, t.shape)
            else:
                slot = opt_shapes.slots[name]
                vector = n is not None and t.dim() == 1
                for part in ("row", "col", "full"):
                    leaf = getattr(slot, part)
                    if leaf is None:
                        continue
                    if n is not None and not (part == "col" and vector):
                        add((part, name), f"slots/{path}/.{part}", n, leaf.shape)
                    else:
                        add((part, name), f"slots/{path}/.{part}", None, leaf.shape)
    specs = sharding.param_sharding_tree(ref, mesh, fsdp=cfg.fsdp)

    def sh(key):
        path, dropped = want[key]
        spec = specs[path]
        return Sharding(mesh, spec[1:] if dropped else spec)

    p = {name: sh(("p", name)) for name in params_shapes}
    if opt_shapes is None:
        return p, None
    step = Sharding(mesh, ())
    if isinstance(opt_shapes, AdamWState):
        return p, AdamWState(step, {n: sh(("mu", n)) for n in params_shapes}, {n: sh(("nu", n)) for n in params_shapes})
    slots = {n: FactoredSlot(*(None if getattr(opt_shapes.slots[n], part) is None else sh((part, n))
                               for part in ("row", "col", "full")))
             for n in params_shapes}
    return p, AdafactorState(step, slots)


def place_tree(tree, shardings):
    """Each tensor of ``tree`` (a mapping, an optimizer state or a cache,
    the whole value on every rank) placed by the ``Sharding`` at its place
    in ``shardings`` (``sharding.place``: each rank keeps its chunk)."""
    if isinstance(tree, torch.Tensor):
        return sharding.place(tree, shardings)
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_tree(v, s) for v, s in zip(tree, shardings)]
    return type(tree)(*(place_tree(v, s) for v, s in zip(tree, shardings)))


# ---------------------------------------------------------------- steps
# the allocator setting :func:`grow_allocator_segments` put in effect, if any
ALLOCATOR_SETTING = {"set": None}


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
    ALLOCATOR_SETTING["set"] = "expandable_segments:True"


def _leaf(p: torch.Tensor) -> torch.Tensor:
    """A parameter as the sharded step differentiates it: a placed one
    whose local tensor is its whole value, gradient included
    (``sharding.whole_here``, a one-rank mesh), as that local tensor, so
    no DTensor enters the autograd graph; any other as it is."""
    if type(p).__name__ == "DTensor" and sharding.whole_here(p):
        p = p.to_local()
    return p.detach().requires_grad_()


def _grad_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient placed as its parameter (a local one wrapped)."""
    if type(p).__name__ == "DTensor" and type(g).__name__ != "DTensor":
        return _wrap(g, p.device_mesh, p.placements, p)
    return g


def _wrap(local: torch.Tensor, mesh, placements, like: torch.Tensor):
    """A DTensor of ``like``'s global shape from this rank's ``local``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False, shape=like.shape, stride=like.stride())


def _local_in(t, placements) -> torch.Tensor:
    """This rank's shard of DTensor ``t`` redistributed to ``placements``."""
    if list(t.placements) != list(placements):
        t = t.redistribute(t.device_mesh, placements)
    return t.to_local()


def _slot_placements(pl, ndim: int, part: str, shared_col: bool) -> list:
    """Where an Adafactor slot's shard lies when the update runs on the
    parameter's shard (placements ``pl``, ``ndim`` dims): ``row`` (the
    mean over the last dim) and ``col`` (over the one before) drop the
    split of the dim they average; ``full`` and a stacked vector's shared
    columns are laid out as the parameter."""
    from torch.distributed.tensor import Replicate, Shard

    if part == "full" or shared_col:
        return list(pl)
    out = []
    for p in pl:
        if not isinstance(p, Shard):
            out.append(p)
        elif part == "row":
            out.append(p if p.dim < ndim - 1 else Replicate())
        else:
            out.append(p if p.dim < ndim - 2 else (Replicate() if p.dim == ndim - 2 else Shard(ndim - 2)))
    return out


class _ShardReduce:
    """The optimizers' reductions completed across ranks: a leaf's local
    sum (or mean) over some of its dims is all-reduced over the mesh dims
    of more than one rank that split those dims. With no such mesh dim the
    plain operation runs, so a one-rank mesh computes the unsharded
    numbers bit for bit."""

    def __init__(self, mesh, placements: Mapping[str, list], ndims: Mapping[str, int]):
        self.mesh, self.placements, self.ndims = mesh, placements, ndims

    def _mesh_dims(self, name: str, leaf_dims) -> Tuple[int, ...]:
        from torch.distributed.tensor import Shard

        nd = self.ndims[name]
        # leaf_dims count from the end of the leaf updated, which may stack
        # the layers on a new first dim that no rank splits
        dims = set(range(nd)) if leaf_dims is None else {nd + d for d in leaf_dims if nd + d >= 0}
        return tuple(i for i, p in enumerate(self.placements[name])
                     if isinstance(p, Shard) and p.dim in dims and self.mesh.size(i) > 1)

    def _complete(self, t: torch.Tensor, mesh_dims) -> torch.Tensor:
        import torch.distributed as dist

        for i in mesh_dims:
            dist.all_reduce(t, group=self.mesh.get_group(i))
        return t

    def sums(self, names, sums):
        """Each leaf's local sum over all its dims, completed (one
        all-reduce for all leaves split alike)."""
        out, by = list(sums), {}
        for j, name in enumerate(names):
            dims = self._mesh_dims(name, None)
            if dims:
                by.setdefault(dims, []).append(j)
        for dims, js in by.items():
            t = self._complete(torch.stack([out[j] for j in js]), dims)
            for k, j in enumerate(js):
                out[j] = t[k]
        return out

    def mean(self, name: str, x: torch.Tensor, dim, leaf_dims, keepdim: bool = False) -> torch.Tensor:
        dims = self._mesh_dims(name, leaf_dims)
        if not dims:
            return torch.mean(x) if dim is None else x.mean(dim=dim, keepdim=keepdim)
        s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
        n = x.numel() if dim is None else x.shape[dim]
        for i in dims:
            n *= self.mesh.size(i)
        return self._complete(s, dims) / n


def _sharded_update(opt, cfg: ModelConfig, grads, opt_state, params):
    """``opt.update`` on this rank's shards: gradients, moments and slots
    brought to the parameter's layout (``_slot_placements`` for Adafactor's
    factored slots), the update run on local tensors with
    :class:`_ShardReduce` completing its reductions, the results placed
    back where the parameters and the state were."""
    mesh = next(iter(params.values())).device_mesh
    pl = {n: list(p.placements) for n, p in params.items()}
    local_p = {n: p.to_local() for n, p in params.items()}
    local_g = {n: _local_in(g, pl[n]) for n, g in grads.items()}
    step = opt_state.step.to_local() if type(opt_state.step).__name__ == "DTensor" else opt_state.step
    reduce = _ShardReduce(mesh, pl, {n: p.dim() for n, p in params.items()})
    if isinstance(opt_state, AdamWState):
        compute = {(part, n): pl[n] for part in ("mu", "nu") for n in params}
        local_s = AdamWState(step, {n: _local_in(opt_state.mu[n], pl[n]) for n in params},
                             {n: _local_in(opt_state.nu[n], pl[n]) for n in params})
    else:
        stacked = {n for group in layer_stacks(cfg) for n in group}
        compute = {(part, n): _slot_placements(pl[n], p.dim(), part, part == "col" and n in stacked and p.dim() == 1)
                   for n, p in params.items() for part in ("row", "col", "full")}
        local_s = AdafactorState(step, {n: FactoredSlot(*(None if t is None else _local_in(t, compute[part, n])
                                                          for part, t in zip(("row", "col", "full"), slot)))
                                        for n, slot in opt_state.slots.items()})
    new_p, new_s = opt.update(local_g, local_s, local_p, reduce=reduce)

    def back(t, part, n, old):
        t = _wrap(t, mesh, compute[part, n], old)
        return t if list(t.placements) == list(old.placements) else t.redistribute(mesh, old.placements)

    out_p = {n: _wrap(t, mesh, pl[n], params[n]) for n, t in new_p.items()}
    new_step = new_s.step
    if type(opt_state.step).__name__ == "DTensor":
        new_step = _wrap(new_step, mesh, opt_state.step.placements, opt_state.step)
    if isinstance(opt_state, AdamWState):
        return out_p, AdamWState(new_step, {n: back(t, "mu", n, opt_state.mu[n]) for n, t in new_s.mu.items()},
                                 {n: back(t, "nu", n, opt_state.nu[n]) for n, t in new_s.nu.items()})
    slots = {n: FactoredSlot(*(None if t is None else back(t, part, n, getattr(opt_state.slots[n], part))
                               for part, t in zip(("row", "col", "full"), slot)))
             for n, slot in new_s.slots.items()}
    return out_p, AdafactorState(new_step, slots)


def make_train_step(cfg: ModelConfig, grad_shardings: Optional[Mapping[str, Sharding]] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``, the reference's: with ``cfg.grad_accum`` a > 1 and the batch
    divisible by it, microbatch i is rows [i·b/a, (i+1)·b/a), whose
    gradients add into float32 zeros; loss and gradients are then divided by
    a; else one gradient of the whole batch. Then the optimizer's update.
    The step is pure: it returns new tensors and writes to none of its
    inputs (a failed step leaves the state as it was). Its first call on
    the card calls :func:`grow_allocator_segments` (a call on fake tensors,
    the dry-run's, does not).

    Sharded (the parameters are DTensors, placed by ``params_shardings``,
    and so is the optimizer state): SPMD written out. The batch is the
    whole batch on every rank; each rank takes its rows of each microbatch
    over the batch axes (:func:`shard_batch_dim`) and runs ``LM.loss_fn`` on
    them as plain tensors, gathering each layer's weights just before the
    layer runs (``LM.forward_train``). The gradients come back summed over
    the batch axes (the rank's loss divided by their rank count n first)
    in ``grad_shardings``' placements (default: the parameters'), and add
    into float32 zeros placed so. The loss is the mean of the ranks'. The
    optimizer then updates each rank's shards of the placed state, its
    reductions completed across the ranks that split them
    (:class:`_ShardReduce`), and each new tensor keeps its old placement.
    With n = 1 (a one-rank mesh) every number is the unsharded step's, bit
    for bit."""
    model = LM(cfg, device=META)
    opt = make_optimizer(cfg)
    on_card = []

    def value_and_grad(params: Mapping[str, torch.Tensor], batch, mesh, carry):
        """(loss, gradients) of one microbatch: of all its rows with no
        mesh; else of this rank's rows, the loss the mean of the ranks' and
        the gradients this rank's shards in ``carry``'s placements."""
        n, axes, split = 1, (), contextlib.nullcontext()
        if mesh is not None:
            with sharding.set_mesh(mesh):
                rows = {k: shard_batch_dim(v) for k, v in batch.items()}
            axes = sharding.spec_axes(sharding.spec_of(rows["tokens"])[0])
            for ax in axes:
                n *= sharding.mesh_axes(mesh)[ax]
            batch = {k: v.to_local() for k, v in rows.items()}
            split = sharding.batch_split(mesh, axes)
        with split:  # _leaf asks whether the split divides a leaf's gradient
            leaves = {k: _leaf(p) for k, p in params.items()}
            loss = model.loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss / n if n > 1 else loss, list(leaves.values()), allow_unused=True,
                                        materialize_grads=True)
        loss = loss.detach()
        if mesh is None:
            return loss, dict(zip(leaves, grads))
        if n > 1:
            import torch.distributed as dist

            for ax in axes:
                dist.all_reduce(loss, group=mesh.get_group(ax))
            loss = loss / n
        return loss, {k: _local_in(_grad_like(g, params[k]), carry[k]) for k, g in zip(leaves, grads)}

    def train_step(params: Mapping[str, torch.Tensor], opt_state, batch: Mapping[str, torch.Tensor]):
        if not on_card and batch["tokens"].is_cuda and not is_fake(batch["tokens"]):
            grow_allocator_segments()
            on_card.append(True)
        mesh = next((p.device_mesh for p in params.values() if type(p).__name__ == "DTensor"), None)
        carry = None if mesh is None else {
            k: grad_shardings[k].placements if grad_shardings is not None else list(p.placements)
            for k, p in params.items()}
        a = cfg.grad_accum
        b = batch["tokens"].shape[0]
        if a > 1 and b % a == 0:
            m = b // a
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = None
            for i in range(a):
                l, g = value_and_grad(params, {k: v[i * m:(i + 1) * m] for k, v in batch.items()}, mesh, carry)
                if grads is None:  # the carry: float32 zeros this step owns, laid out as the gradients
                    grads = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for k, t in g.items()}
                loss = loss + l
                for k, acc in grads.items():
                    acc.add_(g[k])  # acc + g in float32
                del g
            loss = loss / a
            for acc in grads.values():
                acc.div_(a)
        else:
            loss, grads = value_and_grad(params, batch, mesh, carry)
        if mesh is None:
            new_params, new_state = opt.update(grads, opt_state, params)
        else:
            grads = {k: _wrap(t, mesh, carry[k], params[k]) for k, t in grads.items()}
            new_params, new_state = _sharded_update(opt, cfg, grads, opt_state, params)
        return new_params, new_state, loss

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeSpec):
    """``prefill_step(params, batch) -> (last logits, decode cache for
    shape.seq positions)``. ``params`` may be placed by
    ``params_shardings`` (``LM.prefill`` gathers each layer at its use);
    under ``sharding.set_mesh`` each rank runs its rows and the cache comes
    back placed by ``cache_shardings``."""
    model = LM(cfg, device=META)

    def prefill_step(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor]):
        with torch.no_grad():
            return model.prefill(batch["tokens"], max_len=shape.seq, context=batch.get("context"), params=params)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``, the
    cache updated in place. ``params`` may be placed by
    ``params_shardings``, the cache by ``cache_shardings``."""
    model = LM(cfg, device=META)

    def decode_step(params: Mapping[str, torch.Tensor], token, pos, cache):
        with torch.no_grad():
            return model.decode_step(token, pos, cache, params=params)

    return decode_step
