"""Port parity: the LM serving path (gemma3-4b) against the reference;
every ported arch's config, full layout and serving CLI (the dense and MoE
archs' own cases are in ``test_torch_lm_archs.py``).

The same numpy inputs and the reference's own parameters (converted with
``convert.lm_params_from_reference``) go through the reference's JAX
layers and LM and through the port's, on the CPU, in float32 (the smoke
config's dtype). Norms, RoPE, GeGLU and the flash forward agree within
1e-5; ``attention_decode`` (a sliding-window layer past its ring wrap, and
a global layer whose cache is wider than K, so the port's pruned branch
runs the plain version of kernel #4) within 1e-5; the gemma3 smoke
``prefill`` and 8 ``decode_step``s within 1e-4, the reference's own decode
tolerance (``tests/test_lm_archs.py``), with and without a logit softcap.
The pruned branches agree because the retained sets agree on float32
logits without ties (the reference keeps every logit at or above the K-th,
the port exactly K by the kernel's rule). The same prefill and decode in
bfloat16 give equal greedy tokens and logits within 4 bfloat16 ulps of
the logit scale.
"""
import dataclasses
import gc
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import blocks as tblocks  # noqa: E402
from repro_torch.layers import flash as tflash  # noqa: E402
from repro_torch.layers import mlp as tmlp  # noqa: E402
from repro_torch.layers import norms as tnorms  # noqa: E402
from repro_torch.layers import rope as trope  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402

ATOL_LAYER = 1e-5
ATOL_LOGITS = 1e-4  # the reference's decode-vs-forward tolerance
# every ported arch: config module name -> registry name
ARCHS = {"gemma3_4b": "gemma3-4b", "qwen2_1_5b": "qwen2-1.5b", "qwen2_72b": "qwen2-72b",
         "chatglm3_6b": "chatglm3-6b", "olmoe_1b_7b": "olmoe-1b-7b", "arctic_480b": "arctic-480b",
         "recurrentgemma_2b": "recurrentgemma-2b", "rwkv6_3b": "rwkv6-3b",
         "llama32_vision_90b": "llama-3.2-vision-90b", "seamless_m4t_medium": "seamless-m4t-medium"}


@pytest.fixture(autouse=True, scope="module")
def _end_leaked_serve_threads():
    """The reference's ``test_serve_faults.py`` closes threaded front-ends
    whose drain it poisoned for good; their threads then spin for the rest
    of the process, growing in memory and slowing whatever file this worker
    runs next (ROADMAP, "Faults found"). Lift the poison from such closed
    front-ends so their loops drain and return."""
    frontend = sys.modules.get("repro.serve.frontend")
    if frontend is not None:
        for fe in [o for o in gc.get_objects() if type(o) is frontend.ServeFrontend]:
            h = fe.health()
            if h.closed and (h.collector_alive or h.stepper_alive):
                fe.faults = None
                fe.queue.notify_all()
                fe.executor.join(5.0)


def _cfgs(**over):
    from repro.configs import get_config as jget

    j, t = jget("gemma3_4b", smoke=True), tget("gemma3-4b", smoke=True)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _t(tree):
    """A numpy tree as torch tensors (the same nesting)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    """Each ported arch's config is the reference's field for field, under
    its module name and its registry name."""
    from repro.configs import get_config as jget

    j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    fields = [f.name for f in dataclasses.fields(j)]
    assert fields == [f.name for f in dataclasses.fields(t)]
    for name in fields:
        jv, tv = getattr(j, name), getattr(t, name)
        if name == "moe" and jv is not None:  # each package's own MoEConfig class
            jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
        assert jv == tv, name
    assert (j.moe is None) == (t.moe is None)
    assert j.layer_groups() == t.layer_groups() and j.pattern() == t.pattern()
    assert j.param_count() == t.param_count()
    if not smoke:
        assert tget(ARCHS[arch]) == t
    if arch == "gemma3_4b" and not smoke:
        assert t.param_count() == 3_879_731_200
        assert t.adtype == torch.bfloat16 and t.pdtype == torch.float32


def test_unported_arch_and_kind_raise():
    """Every arch of the registry is ported; an unknown arch, an unknown
    block kind and an unknown activation raise ``ValueError`` (in the
    registry, in ``block_shapes`` and when an LM is built)."""
    from repro_torch.configs import ARCHS as ALL

    assert sorted(ALL) == sorted(ARCHS)
    for arch in ALL:
        for smoke in (False, True):
            assert tget(arch, smoke=smoke).name.startswith(ARCHS[arch])
    with pytest.raises(ValueError, match="unknown architecture"):
        tget("no-such-arch")
    smoke = tget("gemma3-4b", smoke=True)
    with pytest.raises(ValueError, match="unknown block kind"):
        tblocks.block_shapes(smoke, "Z")
    with pytest.raises(ValueError, match="unknown block kind"):
        LM(dataclasses.replace(smoke, cycle=("A", "Z")), device="meta")
    with pytest.raises(ValueError, match="unknown activation"):
        LM(dataclasses.replace(smoke, activation="relu"), device="meta")


@pytest.mark.parametrize("norm", ("rmsnorm", "layernorm"))
def test_norms_match_reference(norm):
    from repro.layers import norms as jnorms

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=(64,)).astype(np.float32), "bias": rng.normal(size=(64,)).astype(np.float32)}
    if norm == "rmsnorm":
        want, got = jnorms.rmsnorm(p, x), tnorms.rmsnorm(_t(p), torch.from_numpy(x))
    else:
        want, got = jnorms.layernorm(p, x), tnorms.layernorm(_t(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_LAYER, rtol=0)


@pytest.mark.parametrize("fraction", (1.0, 0.5))
def test_rope_matches_reference(fraction):
    import jax.numpy as jnp
    from repro.layers import rope as jrope

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    pos = np.arange(1000, 1040)
    rot = int(16 * fraction)
    cj, sj = jrope.rope_angles(jnp.asarray(pos), rot, 10_000.0)
    ct, st = trope.rope_angles(torch.from_numpy(pos), rot, 10_000.0)
    np.testing.assert_allclose(ct.numpy(), _np(cj), atol=ATOL_LAYER, rtol=0)
    want = jrope.apply_rope(jnp.asarray(x), cj, sj, fraction)
    got = trope.apply_rope(torch.from_numpy(x), ct, st, fraction)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_LAYER, rtol=0)
    if fraction < 1.0:
        np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


def test_geglu_matches_reference():
    from repro.layers import mlp as jmlp

    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    p = {n: (rng.normal(size=s) * 0.2).astype(np.float32) for n, s in tmlp.mlp_shapes(tcfg).items()}
    want = jmlp.apply_mlp(jcfg, p, x)
    got = tmlp.apply_mlp(tcfg, _t(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_LAYER, rtol=0)


@pytest.mark.parametrize("window", (None, 12))
def test_flash_forward_matches_reference(window):
    """Chunks of 8 (q and kv), S = 37 (not a multiple), GQA group 2, with
    and without a sliding window."""
    import jax.numpy as jnp
    from repro.layers import flash as jflash

    jcfg, tcfg = _cfgs(attn_chunk_q=8, attn_chunk_kv=8)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 37, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 37, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 37, 2, 16)).astype(np.float32)
    want = jflash.flash_attention(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, window)
    got = tflash.flash_attention(tcfg, *(torch.from_numpy(a) for a in (q, k, v)), True, window)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_LAYER, rtol=0)


@pytest.mark.parametrize("kind,pos", (("L", 37), ("A", 29)))
def test_attention_decode_matches_reference(kind, pos):
    """'L': a ring cache of window 16 at pos 37 (wrapped twice); 'A': a
    global cache of 32 rows, 30 valid, with prune_k 8 < 32, so the port's
    pruned branch runs kernel #4's plain version."""
    import jax.numpy as jnp
    from repro.layers import attention as jattn

    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(4)
    p = {n: (rng.normal(size=s) * 0.2).astype(np.float32) for n, s in tattn.attention_shapes(tcfg).items()}
    c = 16 if kind == "L" else 32
    ck = rng.normal(size=(2, c, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(2, c, 2, 16)).astype(np.float32)
    if kind == "A":
        ck[:, pos + 1:] = 0.0
        cv[:, pos + 1:] = 0.0
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    want, wc = jattn.attention_decode(
        jcfg, p, jnp.asarray(x), pos, jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)), kind=kind
    )
    got, gc_ = tattn.attention_decode(
        tcfg, _t(p), torch.from_numpy(x), pos,
        tattn.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())), kind=kind,
    )
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL_LAYER, rtol=0)
    np.testing.assert_allclose(gc_.k.numpy(), _np(wc.k), atol=ATOL_LAYER, rtol=0)
    np.testing.assert_allclose(gc_.v.numpy(), _np(wc.v), atol=ATOL_LAYER, rtol=0)


@pytest.mark.parametrize("kind,pos", (("L", 37), ("L", 5), ("A", 29)))
def test_attention_decode_tensor_pos_is_int_pos(kind, pos):
    """``pos`` as a 0-dim int64 tensor (what a captured decode step replays
    with) gives the ``int`` position's output and cache bit for bit: a ring
    cache of window 16 at pos 37 (wrapped twice) and at pos 5 (not yet
    full), and a global cache of 32 rows whose pruned branch runs kernel
    #4's plain version."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    p = {n: torch.from_numpy((rng.normal(size=s) * 0.2).astype(np.float32))
         for n, s in tattn.attention_shapes(tcfg).items()}
    c = 16 if kind == "L" else 32
    ck, cv = (torch.from_numpy(rng.normal(size=(2, c, 2, 16)).astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.normal(size=(2, 1, 64)).astype(np.float32))
    outs = []
    for p_arg in (pos, torch.tensor(pos)):
        cache = tattn.KVCache(ck.clone(), cv.clone())
        outs.append(tattn.attention_decode(tcfg, p, x, p_arg, cache, kind=kind))
    (o_i, c_i), (o_t, c_t) = outs
    assert torch.equal(o_t, o_i)
    assert torch.equal(c_t.k, c_i.k) and torch.equal(c_t.v, c_i.v)
    assert not torch.equal(c_i.k, ck)  # the step wrote its slot


def test_decode_step_tensor_pos_is_int_pos():
    """The smoke LM (layers L A L, window 16, prune_k 8): 10 decode steps
    from one prefill, with ``int`` and with tensor positions, past the
    ring's wrap, give the same logits and caches bit for bit; so does the
    compiled step, which runs eagerly on the CPU."""
    _, tcfg = _cfgs()
    tm = tbuild(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tcfg.vocab_size, size=(2, 30)))
    _, cache = tm.prefill(toks[:, :20], max_len=30)
    caches = [[tattn.KVCache(c.k.clone(), c.v.clone()) for c in cache] for _ in range(3)]
    step = tm.compile_decode(caches[2])
    for pos in range(20, 30):
        tok = toks[:, pos:pos + 1]
        l_i, caches[0] = tm.decode_step(tok, pos, caches[0])
        l_t, caches[1] = tm.decode_step(tok, torch.tensor(pos), caches[1])
        l_c = step(tok, torch.tensor(pos) if pos % 2 else pos)
        assert torch.equal(l_t, l_i) and torch.equal(l_c, l_i), pos
    for a, b, c in zip(*caches):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
        assert torch.equal(a.k, c.k) and torch.equal(a.v, c.v)


def test_decode_step_captures_through_the_session_capture(monkeypatch):
    """``DecodeStep._capture`` goes through ``session._capture_graph`` (one
    capture at a time, thread-local, the device's one warm-up stream) under
    inference mode: one eager warm-up step, then the captured one, whose
    logits it keeps. A step writes only its position's slot, so the cache
    is left as one eager step leaves it. Recorded with a stand-in for the
    capture that runs the step it is given twice, as the real one does."""
    from repro_torch.core import session as tsession
    from repro_torch.models.lm import DecodeStep

    _, tcfg = _cfgs()
    tm = tbuild(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tcfg.vocab_size, size=(2, 24)))
    _, cache = tm.prefill(toks[:, :20], max_len=24)
    ref_cache = [tattn.KVCache(c.k.clone(), c.v.clone()) for c in cache]
    ref, ref_cache = tm.decode_step(toks[:, 20:21], 20, ref_cache)
    calls = []

    def capture(forward, device, inference=True):
        calls.append((device, inference))
        forward()
        return "graph", forward()

    monkeypatch.setattr(tsession, "_capture_graph", capture)
    step = DecodeStep(tm, cache)
    step._capture(toks[:, 20:21], 20)
    assert calls == [(tm.device, True)]
    assert step._graph == "graph" and torch.equal(step._logits, ref)
    for a, b in zip(cache, ref_cache):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


@pytest.mark.parametrize("softcap", (None, 30.0))
def test_compiled_decode_matches_reference(softcap):
    """8 steps of the compiled decode step (eager on the CPU) with tensor
    positions, after the reference's prefill state, within 1e-4 of the
    reference's ``decode_step``."""
    import jax.numpy as jnp

    jcfg, tcfg = _cfgs(logit_softcap=softcap)
    jm, params, tree = _reference_lm(jcfg)
    tm = tbuild(tcfg, device="cpu", params=convert.lm_params_from_reference(tcfg, tree, device="cpu"))
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, size=(2, 32))
    _, cj = jm.prefill(params, jnp.asarray(toks[:, :24]), max_len=32)
    _, ct = tm.prefill(torch.from_numpy(toks[:, :24]), max_len=32)
    step = tm.compile_decode(ct)
    for pos in range(24, 32):
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, pos:pos + 1]), pos, cj)
        lt = step(torch.from_numpy(toks[:, pos:pos + 1]), torch.tensor(pos))
        np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL_LOGITS, rtol=0)


def _reference_lm(jcfg, seed=0):
    import jax
    from repro.models import build_model as jbuild

    model = jbuild(jcfg)
    params = model.init(jax.random.PRNGKey(seed))
    return model, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("softcap", (None, 30.0))
def test_lm_prefill_and_decode_match_reference(softcap):
    """gemma3 smoke (layers L A L: a remainder group; window 16; prune_k 8):
    prefill of 24 tokens, then 8 decode steps at positions 24..31, where
    the global layer prunes 25..32 cached rows to 8 and the local layer's
    ring has wrapped."""
    import jax.numpy as jnp

    jcfg, tcfg = _cfgs(logit_softcap=softcap)
    jm, params, tree = _reference_lm(jcfg)
    tm = tbuild(tcfg, device="cpu", params=convert.lm_params_from_reference(tcfg, tree, device="cpu"))
    rng = np.random.default_rng(5)
    b, t, gen = 2, 24, 8
    toks = rng.integers(0, tcfg.vocab_size, size=(b, t + gen))
    lj, cj = jm.prefill(params, jnp.asarray(toks[:, :t]), max_len=t + gen)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :t]), max_len=t + gen)
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL_LOGITS, rtol=0)
    assert [(c.k.shape, c.k.dtype) for c in tm.init_cache(b, t + gen)] == [(c.k.shape, c.k.dtype) for c in ct]
    for pos in range(t, t + gen):
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, pos:pos + 1]), pos, cj)
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, pos:pos + 1]), pos, ct)
        np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL_LOGITS, rtol=0)
    if softcap:
        assert float(lt.abs().max()) < softcap


def test_lm_params_round_trip_smoke():
    """Every reference leaf maps to exactly one port parameter of the same
    shape, and back: layer i's leaf is the stacked leaf's row r."""
    jcfg, tcfg = _cfgs()
    _, _, tree = _reference_lm(jcfg)
    port = tbuild(tcfg, device="cpu", params=convert.lm_params_from_reference(tcfg, tree, device="cpu"))
    named = dict(port.named_parameters())
    leaves = convert._flatten(tree)
    seen = set()
    for name, path, r in convert.lm_layout(tcfg, tree):
        leaf = leaves[path] if r is None else leaves[path][r]
        assert (path, r) not in seen
        seen.add((path, r))
        np.testing.assert_array_equal(named[name].numpy(), leaf)
    assert len(seen) == len(named) == sum(
        leaves[p].shape[0] if p.startswith("groups.") else 1 for p in leaves
    )


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_layout_full_config_shapes(arch):
    """The published config, on shapes only (``jax.eval_shape`` of the
    reference's init; the port's LM on the meta device): every leaf, the
    untied head and the nested MoE and RWKV trees included, maps to one
    parameter of the same shape, and the count is the config's analytic
    one. gemma3's remainder group ("L" × 4) lands at pattern layers 30–33,
    recurrentgemma's ("R" R L × 8, then R R) at 24–25."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    jcfg, tcfg = jget(arch), tget(arch)
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    leaves = convert._flatten(shapes)
    port = {n: tuple(p.shape) for n, p in LM(tcfg, device="meta").named_parameters()}
    names = {}
    for name, path, r in convert.lm_layout(tcfg, shapes):
        want = tuple(leaves[path].shape) if r is None else tuple(leaves[path].shape[1:])
        assert port[name] == want, name
        assert name not in names
        names[name] = (path, r)
    assert set(names) == set(port)
    assert ("lm_head.w" in port) == (not tcfg.tie_embeddings)
    if tcfg.moe is not None:
        assert port["layers.0.moe.router.w"] == (tcfg.d_model, tcfg.moe.num_experts)
        assert port[f"layers.{tcfg.num_layers - 1}.moe.experts.wo"] == (
            tcfg.moe.num_experts, tcfg.moe.expert_d_ff, tcfg.d_model)
    # the analytic count leaves out the biases and the norms, the
    # cross-attentions' gates, RG-LRU's gate matrices wa and wi and one of its
    # four vectors a layer (it counts 3·w), and RWKV's lerps mu_*, its w0 and u
    def left_out(name):
        part, leaf = name.split(".")[-2:]
        return (leaf in ("bq", "bk", "bv", "scale", "bias", "gate") or (part == "lru" and leaf in ("wa", "wi"))
                or (part == "rwkv" and (leaf.startswith("mu_") or leaf in ("w0", "u"))))

    extra = sum(int(np.prod(s)) for n, s in port.items() if left_out(n))
    extra += tcfg.pattern().count("R") * (tcfg.lru_width or tcfg.d_model)
    assert sum(int(np.prod(s)) for s in port.values()) - extra == tcfg.param_count()
    if arch == "gemma3_4b":
        for i in range(30, 34):
            path, r = names[f"layers.{i}.attn.wq"]
            assert path.startswith("groups.1.") and r == 0
            assert path == f"groups.1.{i - 30}.attn.wq"
        assert names["layers.29.attn.wq"] == ("groups.0.5.attn.wq", 4)
        assert tcfg.pattern()[29] == "A" and set(tcfg.pattern()[30:]) == {"L"}
    if arch == "recurrentgemma_2b":
        assert names["layers.25.lru.wa"] == ("groups.1.1.lru.wa", 0)
        assert names["layers.23.attn.wq"] == ("groups.0.2.attn.wq", 7)
        assert port["layers.0.lru.conv_w"] == (4, 2560)
    if arch == "rwkv6_3b":
        assert names["layers.31.rwkv.ln_x.scale"] == ("groups.0.0.rwkv.ln_x.scale", 31)
        assert port["layers.31.rwkv.u"] == (40, 64) and port["layers.0.rwkv.decay_a"] == (2560, 64)
    if arch == "llama32_vision_90b":  # cycle A A A A C: layer 99 is group 0's position 4, repeat 19
        assert names["layers.99.cross.gate"] == ("groups.0.4.cross.gate", 19)
        assert port["layers.99.cross.gate"] == () and port["layers.99.cross.wk"] == (8192, 1024)
        assert "layers.98.cross.wq" not in port and "layers.99.attn.wq" not in port
    if arch == "seamless_m4t_medium":  # decoder "D" blocks; the encoder's stack over enc_layers
        assert names["encoder.layers.11.attn.bq"] == ("encoder.stack.attn.bq", 11)
        assert names["encoder.final_norm.bias"] == ("encoder.final_norm.bias", None)
        assert names["layers.11.lnx.scale"] == ("groups.0.0.lnx.scale", 11)
        assert port["layers.0.cross.gate"] == () and "layers.0.mlp.wg" not in port
        # 13 leaves an "E" block: two LayerNorms' scale and bias, wq wk wv wo, bq bk bv, wi wo
        assert sum(n.startswith("encoder.layers.") for n in port) == 12 * 13


@pytest.mark.parametrize("arch", ("gemma3-4b", "qwen2-1.5b", "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-3b",
                                  "llama-3.2-vision-90b", "seamless-m4t-medium"))
def test_serve_cli_on_cpu(arch, capsys):
    """The serving CLI on gemma3 (pruned), an LM-1, an MoE, the two
    recurrent smoke archs and the two cross-attention ones (with their stub
    context, pruned by ``--prune-k 8``)."""
    from repro_torch.launch import serve

    extra = ["--prune-k", "8"] if arch in ("llama-3.2-vision-90b", "seamless-m4t-medium") else []
    toks = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "20", "--gen", "4", *extra])
    assert tuple(toks.shape) == (4, 5)
    out = capsys.readouterr().out
    prune_k = 8 if extra else tget(arch, smoke=True).attn_prune_k
    assert f"[serve] arch={arch}-smoke prune_k={prune_k}" in out and "[serve] decode 4 steps" in out


def test_lm_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild(tget("gemma3-4b", smoke=True))


def _bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at magnitude
    ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def test_lm_bfloat16_prefill_and_decode_match_reference():
    """The inputs of ``test_lm_prefill_and_decode_match_reference`` in
    bfloat16, the dtype gemma3-4b serves in: greedy tokens equal on every
    (batch, step) row, and logits within 4 bfloat16 ulps of the logit
    scale (the largest |logit| of the reference's run: 0.742, where one
    ulp is 2**-8 and the largest difference measured was 7.1e-3, 1.8
    ulps). The two packages round at different places (the port forms α
    and α·V in float32 and then casts; the reference casts α before its
    product), so the bound is stated in ulps, not as the float32 test's
    1e-4."""
    import jax.numpy as jnp

    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jm, params, tree = _reference_lm(jcfg)
    tm = tbuild(tcfg, device="cpu", params=convert.lm_params_from_reference(tcfg, tree, device="cpu"))
    rng = np.random.default_rng(5)
    b, t, gen = 2, 24, 8
    toks = rng.integers(0, tcfg.vocab_size, size=(b, t + gen))
    lj, cj = jm.prefill(params, jnp.asarray(toks[:, :t]), max_len=t + gen)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :t]), max_len=t + gen)
    pairs = [(lt.float().numpy(), _np(lj.astype(jnp.float32)))]
    for pos in range(t, t + gen):
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, pos:pos + 1]), pos, cj)
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, pos:pos + 1]), pos, ct)
        pairs.append((lt.float().numpy(), _np(lj.astype(jnp.float32))))
    bound = 4 * _bf16_ulp(max(float(np.abs(want).max()) for _, want in pairs))
    for got, want in pairs:
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=bound, rtol=0)
