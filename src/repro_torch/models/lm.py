"""Language model assembled from layer blocks (the reference's
``repro/models/lm.py``) for every family: decoder-only over the block
cycle (dense, MoE, hybrid, ssm); a "vlm" whose gated cross-attention ("C")
layers attend to stub image embeddings; an "audio" encoder-decoder whose
"E" encoder layers encode stub frame embeddings once and whose "D"
decoder layers (self + cross) run over the text tokens. Serving: prefill,
then one token per ``decode_step``; training: :meth:`LM.forward_train` and
:meth:`LM.loss_fn` over a flat dict of master parameters (``launch/steps.py``
builds the step, ``runtime/trainer.py`` the loop).

The layers are a ``ModuleList`` in :attr:`LM.kinds` order: ``cfg.pattern()``
with an audio decoder's "A" blocks turned into "D" (the reference's
``_decoder_cycle``); an audio LM also has ``encoder.layers`` ("E") and
``encoder.final_norm``. The reference's ``lax.scan`` over stacked cycle
repeats is a Python loop here. Its sharding constraints steer GSPMD and
have no counterpart: on a device mesh the port computes on local tensors
(``forward_train`` gathers placed weights layer by layer; ``prefill`` and
``decode_step`` run each rank's batch rows over caches placed on the mesh,
``layers/attention.py`` the positions split across ranks). Parameter names follow the port's flat naming
(``embed.table``, ``layers.<i>.attn.wq``, ``layers.<i>.mlp.wi``,
``layers.<i>.moe.router.w``, ``layers.<i>.moe.experts.wi``,
``layers.<i>.lru.wa``, ``layers.<i>.rwkv.ln_x.scale``,
``layers.<i>.cross.gate``, ``layers.<i>.lnx.scale``,
``encoder.layers.<i>.attn.wq``, ``encoder.final_norm.scale``,
``final_norm.scale``, ``lm_head.w`` when the head is untied, …;
``convert`` maps the reference's stacked tree onto them). Weights keep the
reference's ``(in, out)`` layout.

Storage dtypes (:func:`storage_dtype`). The reference keeps the embedding
table and an untied head in ``param_dtype`` and every other leaf in
float32; so does the port, with one exception: a layer's weight matrices
are stored in bfloat16 when ``param_dtype`` and ``dtype`` are both
bfloat16 (qwen2-72b, arctic-480b), which is what each of the reference's
uses reads (one rounding to bfloat16) in half the bytes. Vectors (norm
scales, biases), the MoE router and RWKV's ``u``, ``decay_a`` and
``decay_b`` (which the reference reads in float32 at every use) stay
float32 whatever ``param_dtype`` says, and so does a cross-attention's
0-dim ``gate``.

Embeddings. As the reference does, a tied embedding is scaled by √d
(gemma-style) for every arch, qwen2-1.5b included, and an untied one is
not.

Compute dtype. The reference casts each float32 weight to ``cfg.dtype`` at
every use; the port casts every weight and the embedding table once
(:func:`compute_tree`), which gives the same values. Serving keeps those
copies (:meth:`LM.compute_params`) and builds them anew once the weights
were replaced (``load_params``, which the trainer hands each step's
parameters to) or, as the next prefill finds, written in place, so a
trained LM serves its trained weights; training casts on every step,
through autograd. With ``dtype="bfloat16"`` and float32 parameters that is
2 bytes more per parameter (7.8 GB for gemma3-4b's 3.88 B); with a
float32 ``dtype``, or parameters already in ``dtype``, the copies are the
parameters themselves. Vectors stay float32 (each use casts them, as the
reference's does), and so do an MoE router, the dtype the reference
routes in, and RWKV's float32 matrices.

Seeded init (:meth:`LM.reset_parameters`) draws glorot matrices and zero
vectors and gates, and inits every norm (``ln1``, ``ln2``, ``lnx``, the
encoder's and the final one) as a norm, but for the leaves the reference
inits otherwise (RG-LRU's ``ba``, ``lam`` and ``conv_w``; RWKV's ``mu_*``,
``w0``, decay LoRA and ``ln_x``: ``blocks.init_rules``).

Caches are a list per decoder layer of a ``KVCache`` (A, L, M; C, over the
context), a recurrent state (``LRUState`` for R, ``RWKVState`` for W) or a
``DecoderCache`` (D: a self and a cross ``KVCache``), updated in place by
``decode_step`` (the same list, holding the same tensors, comes back; a
context cache is only read). :func:`cache_tensors` and
:func:`clone_cache` walk any of them.

``LM.compile_decode(cache)`` is the counterpart of the reference's
``jax.jit(model.decode_step)``: a :class:`DecodeStep` bound to one cache,
which on the card replays one CUDA graph of the whole step for every
position. Prefill stays eager, as the reference does not jit it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.projection import glorot_
from repro_torch.core import session as _session
from repro_torch.distributed import sharding
from repro_torch.layers import blocks
from repro_torch.layers.attention import KVCache, position_tensor
from repro_torch.layers.blocks import DecoderCache
from repro_torch.layers.norms import apply_norm, norm_shapes
from repro_torch.layers.rglru import LRUState
from repro_torch.layers.rwkv import RWKVState

Cache = Union[KVCache, LRUState, RWKVState, DecoderCache]
_RECURRENT = (LRUState, RWKVState)
_NORMS = ("ln1", "ln2", "lnx")  # a block's norm parts
# matrices the reference reads in float32 whatever the compute dtype
_FLOAT32_MATRICES = ("router.w", "rwkv.u", "rwkv.decay_a", "rwkv.decay_b")


def storage_dtype(cfg: ModelConfig, name: str, shape) -> torch.dtype:
    """The dtype the port stores parameter ``name`` (a ``named_parameters()``
    name, or its tail from the part on) of ``shape`` in: ``param_dtype`` for
    the embedding table and an untied head, as the reference's; float32 for
    vectors (norm scales, biases), the MoE router and RWKV's ``u`` and decay
    LoRA, as the reference's; a layer's other weights in bfloat16 when
    ``param_dtype`` and ``dtype`` both are, else float32 (see the module
    docstring)."""
    if name in ("embed.table", "lm_head.w"):
        return cfg.pdtype
    if _stays_float32(name, shape):
        return torch.float32
    bf16 = cfg.pdtype == cfg.adtype == torch.bfloat16
    return torch.bfloat16 if bf16 else torch.float32


def _stays_float32(name: str, shape) -> bool:
    """A leaf the forward reads as stored, in float32: vectors and
    ``_FLOAT32_MATRICES``."""
    return len(shape) < 2 or name.endswith(_FLOAT32_MATRICES)


def compute_tree(cfg: ModelConfig, params: Mapping[str, torch.Tensor]) -> Dict:
    """Flat parameters (``named_parameters()`` names) as the forward reads
    them, in the reference's tree: ``{"embed", "final_norm", "layers":
    [per-layer dicts], "lm_head", "encoder": {"layers", "final_norm"}}``
    (the head only when untied, the encoder only for an audio LM), weights
    and the table cast to ``cfg.dtype``, vectors, an MoE router and RWKV's
    float32 matrices as given. The casts are recorded by autograd when the
    parameters require grad."""
    dt = cfg.adtype
    out: Dict = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t if _stays_float32(name, t.shape) else sharding.cast(t, dt)

    def lists(node):  # the "layers" dicts keyed "0", "1", … as lists
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)


def _params(cfg: ModelConfig, prefix: str, shapes: Mapping, device) -> nn.ParameterDict:
    """Inference-only parameters (no autograd state) named ``prefix`` +
    name, each in its :func:`storage_dtype`, zero until
    ``reset_parameters`` or ``load_params`` fills them."""
    return nn.ParameterDict({
        name: nn.Parameter(
            torch.zeros(shape, dtype=storage_dtype(cfg, prefix + name, shape), device=device),
            requires_grad=False,
        )
        for name, shape in shapes.items()
    })


def cache_tensors(cache) -> List[torch.Tensor]:
    """Every tensor of a cache (a list of per-layer caches, or one), nested
    ``DecoderCache`` parts included, in order."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    return [t for part in cache for t in cache_tensors(part)]


def clone_cache(cache):
    """A copy of a cache (a list of per-layer caches, or one) in storage of
    its own, of the same structure and types."""
    if isinstance(cache, torch.Tensor):
        return cache.clone()
    if isinstance(cache, list):
        return [clone_cache(c) for c in cache]
    return type(cache)(*(clone_cache(part) for part in cache))


def decoder_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The decoder's block kinds, layer by layer: ``cfg.pattern()``, with an
    audio decoder's "A" blocks turned into "D" (self + cross), as the
    reference's ``_decoder_cycle`` does."""
    if cfg.family == "audio":
        return tuple("D" if k == "A" else k for k in cfg.pattern())
    return cfg.pattern()


def layer_stacks(cfg: ModelConfig) -> List[List[str]]:
    """The LM's parameter names grouped as the reference stacks them: for
    each group of ``cfg.layer_groups()``, cycle position and leaf, the
    names of that leaf over the group's repeats (``layers.0.attn.wq``,
    ``layers.3.attn.wq``, … for a cycle of three); for an audio LM each
    encoder leaf over its layers. What the reference's Adafactor updates as
    one leaf (``optim/adafactor.py``'s ``stacks``)."""
    where = {}  # decoder layer -> (group, cycle position)
    offset = 0
    for gi, (cycle, n) in enumerate(cfg.layer_groups()):
        for i in range(n * len(cycle)):
            where[offset + i] = (gi, i % len(cycle))
        offset += n * len(cycle)
    stacks: Dict[tuple, List[str]] = {}
    for name, _ in LM(cfg, device="meta").named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            stacks.setdefault(("layers",) + where[int(parts[1])] + (".".join(parts[2:]),), []).append(name)
        elif parts[:2] == ["encoder", "layers"]:
            stacks.setdefault(("encoder", ".".join(parts[3:])), []).append(name)
    return list(stacks.values())


def _reset_norm(cfg, norm: nn.ParameterDict) -> None:
    """RMSNorm's (1 + scale) at zero; LayerNorm's scale one, bias zero."""
    norm["scale"].data.fill_(0.0 if cfg.norm == "rmsnorm" else 1.0)
    if "bias" in norm:
        norm["bias"].data.zero_()


class Nested(nn.Module):
    """A block part whose tree nests: its leaves as parameters, each inner
    dict as a ``ParameterDict`` child, under the reference's paths
    (``moe.router.w``, ``moe.experts.wi``, ``rwkv.mu_r``,
    ``rwkv.ln_x.scale``; ``nn.ParameterDict`` takes no dotted keys)."""

    def __init__(self, cfg: ModelConfig, part: str, shapes: Mapping, device):
        super().__init__()
        leaves = {n: s for n, s in shapes.items() if not isinstance(s, Mapping)}
        for name, param in _params(cfg, f"{part}.", leaves, device).items():
            self.register_parameter(name, param)
        for name, sub in shapes.items():
            if isinstance(sub, Mapping):
                setattr(self, name, _params(cfg, f"{part}.{name}.", sub, device))


class Block(nn.Module):
    """One layer's parameters, the reference's block tree: ``ln1``, ``ln2``
    and ``attn`` + ``mlp`` (A, L, E), ``attn`` + ``moe`` (M; ``mlp`` too with
    a dense residual), ``cross`` + ``mlp`` (C), ``attn`` + ``lnx`` + ``cross``
    + ``mlp`` (D), ``lru`` + ``mlp`` (R) or ``rwkv`` (W)."""

    def __init__(self, cfg: ModelConfig, kind: str, device):
        super().__init__()
        for part, shapes in blocks.block_shapes(cfg, kind).items():
            nested = any(isinstance(s, Mapping) for s in shapes.values())
            setattr(self, part, (Nested(cfg, part, shapes, device) if nested
                                 else _params(cfg, f"{part}.", shapes, device)))


class Encoder(nn.Module):
    """An audio LM's encoder: ``layers`` of kind "E" and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, "E", device) for _ in range(cfg.enc_layers))
        self.final_norm = _params(cfg, "encoder.final_norm.", norm_shapes(cfg), device)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family == "audio" and cfg.enc_layers < 1:
            raise ValueError(f"{cfg.name}: an audio LM needs enc_layers >= 1, got {cfg.enc_layers}")
        self.cfg = cfg
        self.kinds = decoder_kinds(cfg)
        self.device = resolve_device(device)
        self.embed = _params(cfg, "embed.", {"table": (cfg.vocab_size, cfg.d_model)}, self.device)
        self.layers = nn.ModuleList(Block(cfg, kind, self.device) for kind in self.kinds)
        self.final_norm = _params(cfg, "final_norm.", norm_shapes(cfg), self.device)
        if not cfg.tie_embeddings:
            self.lm_head = _params(cfg, "lm_head.", {"w": (cfg.d_model, cfg.vocab_size)}, self.device)
        if cfg.family == "audio":
            self.encoder = Encoder(cfg, self.device)
        self._compute: Optional[Dict] = None
        self._compute_key: Optional[List] = None
        self._param_list = list(self.parameters())  # fixed once built; walking the modules costs ~0.6 ms

    @property
    def ctx_len(self) -> int:
        """Rows of the context the cross-attentions attend to (image tokens
        or audio frames); 0 without one."""
        return self.cfg.num_img_tokens or self.cfg.num_audio_frames

    # ------------------------------------------------------------- params
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init in a fixed order from ``generator`` (on any device;
        values are drawn there and copied): the embedding normal × 0.02,
        glorot-uniform weights (fan-in the first dim: an expert tensor
        (E, d, f) takes E, as the reference's ``glorot`` does), QKV biases
        and cross-attention gates zero, every norm as the reference inits
        it (RMSNorm's scale at zero, LayerNorm's at one), the recurrent
        blocks' other leaves as the reference's (``blocks.init_rules``), an
        untied head normal × 0.02, then an audio LM's encoder layers and
        norm."""

        def fill(p: nn.Parameter, draw) -> None:
            buf = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
            draw(buf)
            p.data.copy_(buf)

        def reset_layers(layers, kinds) -> None:
            for layer, kind in zip(layers, kinds):
                rules = blocks.init_rules(self.cfg, kind)
                for part, module in layer.named_children():
                    if part in _NORMS:
                        _reset_norm(self.cfg, module)
                        continue
                    for name, p in module.named_parameters():  # else weights glorot, biases and gates zero
                        rule = rules.get(f"{part}.{name}")
                        if rule is not None:
                            fill(p, lambda t: rule(t, generator))
                        elif p.dim() < 2:
                            p.data.zero_()
                        else:
                            fill(p, lambda t: glorot_(t, generator))

        normal = lambda t: t.normal_(0.0, 1.0, generator=generator).mul_(0.02)  # noqa: E731
        fill(self.embed["table"], normal)
        reset_layers(self.layers, self.kinds)
        _reset_norm(self.cfg, self.final_norm)
        if not self.cfg.tie_embeddings:
            fill(self.lm_head["w"], normal)
        if self.cfg.family == "audio":
            reset_layers(self.encoder.layers, ("E",) * self.cfg.enc_layers)
            _reset_norm(self.cfg, self.encoder.final_norm)
        self._compute = None

    def load_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Take ``params`` (the names and shapes of ``named_parameters()``)
        as the model's parameters, each cast to its :func:`storage_dtype`; a
        tensor already on the model's device in that dtype is shared, not
        copied."""
        want = {n: tuple(p.shape) for n, p in self.named_parameters()}
        got = {n: tuple(t.shape) for n, t in params.items()}
        if got != want:
            missing = sorted(set(want) - set(got))
            extra = sorted(set(got) - set(want))
            shapes = sorted(n for n in set(want) & set(got) if want[n] != got[n])
            raise ValueError(
                f"parameters do not match the LM: missing {missing}, unexpected "
                f"{extra}, shapes differ for {shapes}"
            )
        for name, p in self.named_parameters():
            p.data = params[name].detach().to(self.device, p.dtype)
        self._compute = None

    def compute_params(self, check: bool = False) -> Dict:
        """The LM's own parameters as the forward uses them
        (:func:`compute_tree`, detached), built once and kept until
        ``load_params`` or ``reset_parameters`` replaces the weights. With
        ``check`` (each :meth:`prefill`, each capture of a
        :class:`DecodeStep`) they are also built anew when a parameter was
        written in place since (its storage or version counter moved, as
        ``with torch.no_grad(): p.copy_(t)`` moves it); a decode step reads
        them as they are, an O(1) test."""
        if check and self._compute is not None and self._param_key() != self._compute_key:
            self._compute = None
        if self._compute is None:
            self._compute = compute_tree(self.cfg, {n: p.detach() for n, p in self.named_parameters()})
            self._compute_key = self._param_key()
        return self._compute

    def _param_key(self) -> List:
        return [(p.data_ptr(), p._version) for p in self._param_list]

    def _tree(self, params: Optional[Mapping[str, torch.Tensor]], check: bool = False) -> Dict:
        return self.compute_params(check) if params is None else compute_tree(self.cfg, params)

    # ------------------------------------------------------------ helpers
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        # the gather of table[tokens]; its backward sums the rows of repeated
        # tokens by a sort on the card (deterministic), where advanced
        # indexing's walks each token's duplicates in one warp
        x = nn.functional.embedding(tokens, sharding.gather(params["embed"]["table"]))
        if not cfg.tie_embeddings:
            return x
        # gemma-style scaled embeddings (tied), the scale rounded to adtype; a
        # CPU scalar tensor, since a device one would be a synchronizing copy
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.adtype)

    def _encode(self, params, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """The audio encoder over stub frame embeddings (B, F, d): "E" blocks
        at positions 0..F-1 (with ``remat``, each recomputed in the
        backward), then the encoder's final norm."""
        cfg = self.cfg
        x = frames.to(cfg.adtype)
        positions = torch.arange(x.shape[1], device=x.device)
        split = sharding.current_split()
        for lp in params["encoder"]["layers"]:

            def layer(h, lp=lp):
                with sharding.split_scope(split):
                    return blocks.apply_block_train(cfg, "E", sharding.gather_tree(lp), h, positions)[0]

            x = _remat(layer, x) if remat else layer(x)
        return apply_norm(cfg, sharding.gather_tree(params["encoder"]["final_norm"]), x)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(cfg, sharding.gather_tree(params["final_norm"]), x)
        w = sharding.gather(params["embed"]["table"]).T if cfg.tie_embeddings else sharding.gather(params["lm_head"]["w"])
        logits = (x @ w).float()
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        return logits

    # -------------------------------------------------------------- train
    def cycle_repeats(self) -> Iterator[range]:
        """The layers of each cycle repeat, in order: the unit the reference
        scans over and rematerialises (``jax.checkpoint`` on the scan
        body)."""
        offset = 0
        for cycle, n in self.cfg.layer_groups():
            for r in range(n):
                yield range(offset + r * len(cycle), offset + (r + 1) * len(cycle))
            offset += n * len(cycle)

    def forward_train(self, params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                      context: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, S, V) float32, aux loss float32 scalar) of ``tokens``
        (B, S) under the flat master parameters ``params`` (any dtype;
        autograd records through them when they require grad). The LM's
        own parameters are not read. ``context``: a "vlm" LM's image
        embeddings, cast to ``cfg.dtype``, or an "audio" LM's frames, which
        the encoder encodes first. With ``cfg.remat`` each cycle repeat
        (each encoder layer) is recomputed in the backward
        (``torch.utils.checkpoint``, non-reentrant). ``aux`` sums the
        blocks' MoE auxiliary losses.

        Parameters placed as DTensors (``launch/steps.py``'s sharded step)
        are gathered whole just before their use: a layer's inside the
        remat body, so a recompute gathers them again and a rematerialized
        model never holds all its weights gathered at once; the embedding
        and the head at theirs. The body re-enters the step's batch split
        (``sharding.split_scope``) wherever the recompute runs."""
        cfg = self.cfg
        tree = compute_tree(cfg, params)
        if cfg.family == "audio":
            context = self._encode(tree, context, remat=cfg.remat)
        elif context is not None:
            context = context.to(cfg.adtype)
        x = self._embed(tree, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        split = sharding.current_split()
        for layers in self.cycle_repeats():

            def body(h, a, layers=layers):
                with sharding.split_scope(split):
                    for i in layers:
                        h, da, _ = blocks.apply_block_train(cfg, self.kinds[i], sharding.gather_tree(tree["layers"][i]),
                                                            h, positions, context=context)
                        if isinstance(da, torch.Tensor):  # an "M" block's; the others add 0.0
                            a = a + da
                    return h, a

            x, aux = _remat(body, x, aux) if cfg.remat else body(x, aux)
        return self._logits(tree, x), aux

    def loss_fn(self, params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The reference's loss: mean token cross entropy of ``batch``'s
        ``tokens`` against its ``labels`` (B, S), plus the aux loss; the
        row max taken without its gradient, the label's logit the value of
        the reference's masked sum over the vocabulary (:class:`_Pick`)."""
        logits, aux = self.forward_train(params, batch["tokens"], context=batch.get("context"))
        m = logits.detach().amax(dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
        nll = lse - _Pick.apply(logits, batch["labels"].long())
        return nll.mean() + aux

    # ------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> List[Cache]:
        """A zero decode cache for ``max_len`` positions; a context cache
        ("C", a "D" block's cross) ``ctx_len`` rows wide."""
        return [
            blocks.init_block_cache(self.cfg, kind, batch, max_len, self.device, self.ctx_len)
            for kind in self.kinds
        ]

    def decode_step(self, token: torch.Tensor, pos, cache: List[Cache],
                    params: Optional[Mapping[str, torch.Tensor]] = None):
        """One decode step: ``token`` (B, 1) at position ``pos`` (an ``int``
        or a 0-dim int64 tensor on the model's device; both give the same
        bits) -> (logits (B, V) float32, cache), the cache updated in
        place. ``params``: flat parameters to run with in place of the LM's
        own (``launch/steps.py``'s decode step).

        On a cache placed on a mesh (:meth:`prefill` under one) each rank
        runs its rows: ``token`` is the whole batch (this rank's rows are
        taken) or a DTensor of rows, and the logits come back a DTensor of
        rows (``full_tensor()`` gives them whole)."""
        mesh, entry = cache_rows(cache)
        if mesh is None:
            return self._decode_rows(token, pos, cache, params), cache
        logits = self._decode_rows(_local_rows(token, mesh, entry), pos, cache, params)
        return sharding.from_rows(logits, sharding.Sharding(mesh, (entry, None))), cache

    def _decode_rows(self, token: torch.Tensor, pos, cache: List[Cache],
                     params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        cfg, params = self.cfg, self._tree(params)
        x = self._embed(params, token)
        pos = position_tensor(pos, token.device)
        for i, kind in enumerate(self.kinds):
            x, cache[i] = blocks.apply_block_decode(cfg, kind, params["layers"][i], x, pos, cache[i])
        return self._logits(params, x)[:, 0]

    def compile_decode(self, cache: List[Cache]) -> "DecodeStep":
        """The decode step as one program, bound to ``cache`` and to the
        model's current weights (see :class:`DecodeStep`)."""
        return DecodeStep(self, cache)

    # ------------------------------------------------------------ prefill
    def prefill(self, tokens: torch.Tensor, max_len: int, context: Optional[torch.Tensor] = None,
                params: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, List[Cache]]:
        """Run the prompt (B, S), returning (last-token logits (B, V)
        float32, decode cache for ``max_len`` positions). ``context`` is a
        "vlm" LM's image embeddings (B, num_img_tokens, d), cast to
        ``cfg.dtype``, or an "audio" LM's frame embeddings
        (B, num_audio_frames, d), which the encoder encodes first; an LM
        with a context raises ``ValueError`` without one of ``ctx_len`` rows.

        The prefill attention emits each layer's K/V, re-laid-out into the
        decode cache: global layers left-aligned and zero-padded to
        ``max_len``, local layers in the ring layout of the last ``window``
        rows; a context cache (C, a "D" block's cross) as emitted. A
        recurrent layer emits its state after the last token. ``params``:
        flat parameters to run with in place of the LM's own.

        Under a mesh (``sharding.set_mesh``) each rank runs its rows of the
        prompt (``tokens`` the whole batch, or a DTensor of rows), then keeps
        its chunk of each cache as ``sharding.cache_shardings`` places it
        (positions over ``model`` where they divide): the logits and every
        cache tensor come back DTensors.
        Decode state other than KV caches (R, W; C, E / D) raises
        ``NotImplementedError`` under a mesh.
        """
        mesh = sharding.ambient_mesh()
        if mesh is not None:
            return self._prefill_on_mesh(mesh, tokens, max_len, context, params)
        cfg, params = self.cfg, self._tree(params, check=True)
        if self.ctx_len and (context is None or tuple(context.shape[1:]) != (self.ctx_len, cfg.d_model)):
            got = None if context is None else tuple(context.shape)
            raise ValueError(f"a {cfg.family!r} LM's prefill takes a context (B, {self.ctx_len}, {cfg.d_model}); "
                             f"got {got}")
        if cfg.family == "audio":
            context = self._encode(params, context)
        elif context is not None:
            context = context.to(cfg.adtype)
        s = tokens.shape[1]
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=tokens.device)
        caches = []
        for i, kind in enumerate(self.kinds):
            x, _, em = blocks.apply_block_train(
                cfg, kind, params["layers"][i], x, positions, context=context, emit_cache=True
            )
            caches.append(self._relayout_cache(kind, em, s, max_len))
        return self._logits(params, x[:, -1:, :])[:, 0], caches

    def _prefill_on_mesh(self, mesh, tokens, max_len, context, params):
        others = sorted(set(self.kinds) - {"A", "L", "M"})
        if others:
            raise NotImplementedError(
                f"{self.cfg.name}: decode state of kinds {others} under a mesh is not ported; KV caches only (A, L, M)")
        rows = sharding.shard_batch_dim(tokens)
        entry = sharding.spec_of(rows)[0]
        with sharding.set_mesh(None):
            logits, caches = self.prefill(rows.to_local(), max_len, context=context, params=params)
        specs = sharding.cache_shardings(self.cfg, rows.shape[0], mesh, caches)
        caches = [KVCache(*(sharding.from_rows(t, sh) for t, sh in zip(c, sp))) for c, sp in zip(caches, specs)]
        return sharding.from_rows(logits, sharding.Sharding(mesh, (entry, None))), caches

    def _relayout_cache(self, kind: str, em: Cache, s: int, max_len: int) -> Cache:
        """One layer's emitted (B, S, Hkv, hd) K/V -> its decode cache; a
        recurrent state passes through, each tensor copied into storage of
        its own (the emitted ones are views of whole-prompt tensors); a
        context cache (B, C, Hkv, hd) passes through as emitted."""
        cfg = self.cfg
        if kind == "C":
            return em
        if kind in ("R", "W"):
            return type(em)(*(t.clone(memory_format=torch.contiguous_format) for t in em))
        if kind == "D":
            return DecoderCache(self._relayout_cache("A", em.self, s, max_len),
                                self._relayout_cache("C", em.cross, s, max_len))
        if kind in ("A", "M"):
            pad = (0, 0, 0, 0, 0, max_len - s)
            return KVCache(k=nn.functional.pad(em.k, pad), v=nn.functional.pad(em.v, pad))
        w = min(cfg.sliding_window or s, max_len, s)
        slots = torch.remainder(torch.arange(s - w, s, device=em.k.device), w)
        width = min(cfg.sliding_window or max_len, max_len)
        out = []
        for t in (em.k, em.v):
            z = t.new_zeros((t.shape[0], width) + t.shape[2:])
            z[:, slots] = t[:, s - w:]
            out.append(z)
        return KVCache(k=out[0], v=out[1])


def cache_rows(cache) -> Tuple[Optional[object], object]:
    """(mesh, the spec entry of its batch rows) of a cache placed on a
    mesh, or (None, None) for a cache of plain tensors."""
    for t in cache_tensors(cache):
        if type(t).__name__ == "DTensor":
            return t.device_mesh, sharding.spec_of(t)[0]
    return None, None


def _local_rows(token: torch.Tensor, mesh, entry) -> torch.Tensor:
    """A DTensor's local rows, or this rank's rows of the whole batch."""
    if type(token).__name__ == "DTensor":
        return token.to_local()
    return sharding.take_rows(token, mesh, entry)


class _Pick(torch.autograd.Function):
    """The label's logit, ``logits[..., labels]`` (B, S): the value of the
    reference's masked sum over the vocabulary, which adds it to zeros. Its
    backward scatters the gradient into zeros and keeps only the labels: the
    masked sum would make a (B, S, V) mask and float32 temporary, and a
    ``gather`` keep the (B, S, V) logits until the backward, 8.4 GB each for
    recurrentgemma-2b's vocabulary at (2, 4096)."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(labels)
        ctx.shape = logits.shape
        return logits.gather(-1, labels[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (labels,) = ctx.saved_tensors
        return g.new_zeros(ctx.shape).scatter_(-1, labels[..., None], g[..., None]), None


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward rather
    than kept."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class DecodeStep:
    """``decode_step`` compiled once for every position, bound to one cache:
    ``step(token, pos)`` -> logits (B, V) float32, the cache updated in
    place, bit for bit an eager ``decode_step``.

    On the card the first call captures the step as a CUDA graph, with
    static ``token`` (B, 1) and ``pos`` tensors: one eager warm-up step (it
    fills the lazy state and builds the kernels), then the capture, both
    through ``session._capture_graph`` (one capture at a time, thread-local,
    the device's one warm-up stream). The warm-up writes the cache as a
    step does: the KV slot of its position, which the first replay writes
    again with the same bits, and the next recurrent state (R, W), which the
    replay would advance a second time. So the recurrent states are copied
    before the capture and put back after it, and the first call leaves the
    cache exactly as one eager step leaves it. Every call (the first
    included) copies the token and position into the static inputs and
    replays; the launch counters tick at the warm-up and
    the capture, never on a replay. A context cache (C, a "D" block's
    cross) is only read, so the warm-up leaves it as it was. The returned
    logits are the graph's
    static output, overwritten by the next call: read them (an ``argmax``)
    before calling again. A step that cannot be captured raises; loading
    new weights into the model makes the step raise too (build a new one),
    as does a prefill that found a parameter written in place since the
    capture (a replay itself tests only that, in O(1)).
    On the CPU every call is an eager ``decode_step``. On a cache placed on
    a mesh the graph holds this rank's rows (its collectives, too, where a
    cache's positions are split), and each call returns the static logits
    as a DTensor of rows.
    """

    def __init__(self, lm: LM, cache: List[Cache]):
        self.lm, self.cache = lm, cache
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._mesh, self._rows = cache_rows(cache)

    def _capture(self, token: torch.Tensor, pos) -> None:
        lm, dev = self.lm, self.lm.device
        self._params = lm.compute_params(check=True)
        self._token = token.detach().clone()
        self._pos = position_tensor(pos, dev).clone()
        states = [t for c in self.cache if isinstance(c, _RECURRENT) for t in c]
        before = [t.clone() for t in states]
        self._graph, self._logits = _session._capture_graph(
            lambda: lm._decode_rows(self._token, self._pos, self.cache), dev
        )
        with torch.inference_mode():  # undo the warm-up's step
            for t, saved in zip(states, before):
                t.copy_(saved)

    def __call__(self, token: torch.Tensor, pos) -> torch.Tensor:
        if self.lm.device.type != "cuda":
            with torch.inference_mode():
                return self.lm.decode_step(token, pos, self.cache)[0]
        if self._mesh is not None:
            token = _local_rows(token, self._mesh, self._rows)
        if self._graph is None:
            self._capture(token, pos)
        elif self.lm.compute_params() is not self._params:
            raise RuntimeError("the model's weights changed since the step was captured; compile a new step")
        if token.shape != self._token.shape:
            raise ValueError(
                f"token has shape {tuple(token.shape)}; the step was captured for "
                f"{tuple(self._token.shape)}"
            )
        with torch.inference_mode():
            self._token.copy_(token)
            if isinstance(pos, torch.Tensor):
                self._pos.copy_(pos)
            else:
                self._pos.fill_(int(pos))
            self._graph.replay()
        if self._mesh is not None:
            return sharding.from_rows(self._logits, sharding.Sharding(self._mesh, (self._rows, None)))
        return self._logits


def build_model(
    cfg: ModelConfig,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
) -> LM:
    """An ``LM`` for ``cfg`` on ``device``, with ``params`` (a flat mapping
    named as ``named_parameters()``, e.g. from
    ``convert.lm_params_from_reference``) or seeded weights drawn from
    ``generator`` (default: a CPU generator seeded 0)."""
    lm = LM(cfg, device)
    if params is not None:
        lm.load_params(params)
    else:
        lm.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
    return lm
