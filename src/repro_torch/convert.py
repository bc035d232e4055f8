"""Parameters from the reference package's parameter trees.

The reference keeps a model's parameters as a nested tree of arrays, with
dicts and lists as inner nodes. HAN's::

    {"proj": {type: {"w": (F, H·dh), "b": (H·dh,)}},
     "attn": {metapath: {"a_src": (H, dh), "a_dst": (H, dh)}},
     "sem":  {"w": (H·dh, hidden), "b": (hidden,), "q": (hidden,)},
     "out":  {"w": (H·dh, C), "b": (C,)}}

RGAT's and Simple-HGN's hold one dict per layer in a list::

    {"layers": [{"proj": {...}, "attn": {relation: {...}}}, ...],   # RGAT
     "out": {...}}
    {"layers": [{"proj": {...}, "a_src": ..., "a_dst": ..., "a_rel": ...,
                 "rel_emb": (R, H·rel_dim), "res": {type: ...}}, ...],
     "out": {...}}                                                    # Simple-HGN

:func:`params_from_reference` takes such a tree with numpy arrays as leaves
(convert the reference's arrays with ``np.asarray`` first) and returns the
port's flat parameter mapping, named as the model's ``named_parameters()``
names them: dict keys and list positions joined by dots
(``"proj.paper.w"``, ``"layers.0.attn.AP.a_src"``, …). Weights keep the
reference's ``(in, out)`` layout — the port multiplies ``x @ w`` too — so
no tensor is transposed.

:func:`lm_params_from_reference` does the same for the reference's
language model, whose tree stacks the layers of each group of the layer
pattern (``ModelConfig.layer_groups``)::

    {"embed": {"table": (V, d)}, "final_norm": {"scale": (d,)},
     "lm_head": {"w": (d, V)},                      # untied heads only
     "groups": [(block tree of cycle position p, leaves stacked over the
                 group's repeats: (n, ...)) for p in the cycle], ...}

Layer ``i`` of the pattern is group ``gi``, repeat ``r``, position ``p``
with ``i = offset_gi + r·len(cycle_gi) + p``; its leaves go to
``layers.<i>.<path>`` (``layers.5.attn.wq``; an MoE block's nested
``moe.router.w`` and ``moe.experts.wi`` keep their paths, as do an "R"
block's ``lru.*`` and a "W" block's ``rwkv.*``, ``rwkv.ln_x.scale``
included, as do a "C" or "D" block's ``cross.*`` with its 0-dim ``gate``
and a "D" block's ``lnx.*``). gemma3-4b has
two groups, the cycle ``L L L L L A`` five times and a remainder
``L L L L`` (layers 30–33). An audio LM's tree also holds its encoder,
``{"encoder": {"stack": (an "E" block tree stacked over enc_layers),
"final_norm": ...}}``: ``encoder.stack.<path>`` row ``i`` goes to
``encoder.layers.<i>.<path>``, and ``encoder.final_norm.*`` keeps its name.

The standalone Pruner (``kernels/topk_select``) has no parameters, so
nothing here converts for it.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def _flatten(tree, prefix: str = "", is_leaf=lambda t: False) -> Dict[str, np.ndarray]:
    if is_leaf(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, np.ndarray] = {}
    for key, val in items:
        name = f"{prefix}{key}"
        if "." in str(key):
            raise ValueError(f"parameter key {name!r} contains '.'")
        out.update(_flatten(val, name + ".", is_leaf))
    return out


def params_from_reference(
    tree: Mapping, device="cuda", model: Optional[torch.nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """The reference's nested parameter tree (numpy leaves) as the port's
    flat float32 parameter mapping on ``device``. With ``model``, the names
    and shapes must equal ``model.named_parameters()``'s, or it raises."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in _flatten(tree).items():
        if not isinstance(leaf, np.ndarray):
            raise TypeError(
                f"{name}: leaves must be numpy arrays (np.asarray the "
                f"reference's arrays), got {type(leaf).__name__}"
            )
        out[name] = torch.tensor(leaf, dtype=torch.float32, device=dev)
    if model is not None:
        want = {n: tuple(p.shape) for n, p in model.named_parameters()}
        got = {n: tuple(t.shape) for n, t in out.items()}
        if got != want:
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            shapes = sorted(n for n in set(want) & set(got) if want[n] != got[n])
            raise ValueError(
                f"reference tree does not match {type(model).__name__}: missing "
                f"{missing}, unexpected {extra}, shapes differ for {shapes}"
            )
    return out


def lm_layout(cfg, tree: Mapping, is_leaf=lambda t: False) -> Iterator[Tuple[str, str, Optional[int]]]:
    """``(port name, reference path, repeat)`` for every leaf of the
    reference LM tree, one per layer for stacked leaves (``repeat`` indexes
    the stacking axis; ``None`` for the unstacked embedding and final
    norm and head). Leaves may be arrays or shape structs: only the tree
    is read; ``is_leaf`` marks other nodes as leaves (an optimizer's
    per-parameter slots)."""
    tops = ("embed", "final_norm", "lm_head")
    unknown = sorted(set(tree) - set(tops) - {"groups", "encoder"})
    if unknown:
        raise ValueError(f"unknown LM tree parts {unknown}")
    for top in (t for t in tops if t in tree):
        for path in _flatten(tree[top], f"{top}.", is_leaf):
            yield path, path, None
    if "encoder" in tree:
        enc = tree["encoder"]
        if sorted(enc) != ["final_norm", "stack"]:
            raise ValueError(f"encoder parts {sorted(enc)}, expected ['final_norm', 'stack']")
        for path in _flatten(enc["final_norm"], "encoder.final_norm.", is_leaf):
            yield path, path, None
        for path in _flatten(enc["stack"], "", is_leaf):
            for r in range(cfg.enc_layers):
                yield f"encoder.layers.{r}.{path}", f"encoder.stack.{path}", r
    offset = 0
    for gi, ((cycle, n), stacked) in enumerate(zip(cfg.layer_groups(), tree["groups"])):
        if len(stacked) != len(cycle):
            raise ValueError(f"group {gi}: {len(stacked)} cycle positions, expected {len(cycle)}")
        for p, block in enumerate(stacked):
            for path in _flatten(block, "", is_leaf):
                for r in range(n):
                    i = offset + r * len(cycle) + p
                    yield f"layers.{i}.{path}", f"groups.{gi}.{p}.{path}", r
        offset += n * len(cycle)
    if offset != cfg.num_layers:
        raise ValueError(f"the groups hold {offset} layers, the config {cfg.num_layers}")


def lm_reference_path(cfg, name: str) -> Tuple[str, Optional[int]]:
    """A port parameter name -> (the reference's '/'-joined tree path, the
    repeats its leaf is stacked over, or ``None`` for an unstacked leaf):
    ``layers.<i>.<path>`` -> ``groups/<gi>/<p>/<path>`` over the group's
    repeats, ``encoder.layers.<r>.<path>`` -> ``encoder/stack/<path>`` over
    ``enc_layers``, any other name its dots as slashes. The inverse of
    :func:`lm_layout`'s naming, without a reference tree."""
    parts = name.split(".")
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(["encoder", "stack"] + parts[3:]), cfg.enc_layers
    if parts[0] != "layers":
        return "/".join(parts), None
    i, offset = int(parts[1]), 0
    for gi, (cycle, n) in enumerate(cfg.layer_groups()):
        if i < offset + n * len(cycle):
            return "/".join(["groups", str(gi), str((i - offset) % len(cycle))] + parts[2:]), n
        offset += n * len(cycle)
    raise ValueError(f"{name}: layer {i} is past the config's {offset} layers")


def lm_params_from_reference(cfg, tree: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """The reference LM's parameter tree (numpy leaves) as the port's flat
    mapping on ``device``, each tensor in the dtype the LM stores it in
    (``models.lm.storage_dtype``: the reference's own, but for a layer's
    weight matrices when ``param_dtype`` and ``dtype`` are both bfloat16);
    ``LM.load_params`` (and ``build_model(cfg, params=...)``) checks its
    names and shapes. A bfloat16 leaf (numpy's ``ml_dtypes`` type) goes
    through float32, which holds it exactly."""
    from repro_torch.models.lm import storage_dtype

    dev = resolve_device(device)
    leaves = _flatten(tree)
    out = {}
    for name, path, r in lm_layout(cfg, tree):
        leaf = leaves[path]
        if not isinstance(leaf, np.ndarray):
            raise TypeError(
                f"{path}: leaves must be numpy arrays (np.asarray the "
                f"reference's arrays), got {type(leaf).__name__}"
            )
        leaf = leaf if r is None else leaf[r]
        if leaf.dtype.name == "bfloat16":
            leaf = leaf.astype(np.float32)
        out[name] = torch.tensor(leaf, dtype=storage_dtype(cfg, name, leaf.shape), device=dev)
    return out


def _host_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A reference numpy leaf as a tensor of its dtype (bfloat16 through
    float32, which holds it exactly)."""
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(np.asarray(a), device=device)


def opt_state_from_reference(cfg, opt_state, device="cuda"):
    """The reference's optimizer state for its LM (numpy leaves:
    ``jax.tree.map(np.asarray, state)``) as the port's, named as the port's
    parameters: an ``AdamWState`` (``mu`` and ``nu`` per layer, each leaf's
    row ``r`` of a stacked one) or an ``AdafactorState`` whose slots follow
    the port's stacked layout (``optim/adafactor.py``): a stacked matrix's
    row and column statistics row ``r``, a stacked vector's row ``r`` (0-d)
    and its shared columns, a stacked scalar's ``full[r]``. A state from
    ``launch.steps.make_optimizer(cfg)`` on the reference's side continues
    in the port's step (``make_train_step``)."""
    from repro_torch.optim.adafactor import AdafactorState, FactoredSlot
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(opt_state.step)), dtype=torch.int32, device=dev)
    if hasattr(opt_state, "mu"):
        def moments(tree):
            leaves = _flatten(tree)
            return {name: _host_tensor(leaves[path] if r is None else leaves[path][r], dev)
                    for name, path, r in lm_layout(cfg, tree)}

        return AdamWState(step=step, mu=moments(opt_state.mu), nu=moments(opt_state.nu))
    is_slot = lambda t: hasattr(t, "_fields")  # noqa: E731  the reference's FactoredSlot
    leaves = _flatten(opt_state.slots, "", is_slot)
    slots = {}
    for name, path, r in lm_layout(cfg, opt_state.slots, is_slot):
        row, col, full = leaves[path]
        if r is None:
            parts = (row, col, full)
        elif full is not None:
            parts = (None, None, full[r])
        elif row.ndim == 1:  # a stacked vector: its columns are the group's
            parts = (row[r], col, None)
        else:
            parts = (row[r], col[r], None)
        slots[name] = FactoredSlot(*(None if a is None else _host_tensor(a, dev) for a in parts))
    return AdafactorState(step=step, slots=slots)
