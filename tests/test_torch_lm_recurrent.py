"""Port parity: the recurrent LM archs (recurrentgemma-2b's RG-LRU "R"
blocks, rwkv6-3b's RWKV-6 "W" blocks) against the reference. (Each arch's
config, its full parameter layout and the serving CLI are held in
``test_torch_lm.py``, with the other archs'.)

On the CPU, in float32 (the smoke configs' dtype), the same numpy inputs
and the reference's own parameters (converted with
``convert.lm_params_from_reference``) go through both packages, with the
leaves the reference inits to constants redrawn so that each moves the
output: RG-LRU's ``ba``, ``bi``, ``conv_b`` and ``lam`` (decays from 0.98
to e^-5.5 a step), RWKV's ``u``, ``w0`` (log-decays on both sides of the
-2.7 clamp), the ``mu_*`` lerps, the norm scales and biases and
``ln_x``. The RG-LRU block agrees within 2e-5 (outputs and states, train
and decode), the RWKV mixes within 1e-4 at a prompt of 21 tokens (not a
multiple of the smoke chunk, 8), ``groupnorm_heads`` within 1e-6, and each
smoke LM's prefill of 24 tokens plus 8 decode steps, eager and through
``compile_decode``, within 1e-4 on logits; in bfloat16 the greedy tokens
equal the reference's. The reference's conv state fault on prompts
shorter than ``conv_width - 1`` is recorded, and the port's repair held;
so is ``DecodeStep``'s warm-up, which must not advance a recurrent state.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.layers import norms as tnorms  # noqa: E402
from repro_torch.layers import rglru as trglru  # noqa: E402
from repro_torch.layers import rwkv as trwkv  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402

ARCHS = ("recurrentgemma_2b", "rwkv6_3b")
ATOL_LRU = 2e-5
ATOL_RWKV = 1e-4
ATOL_NORM = 1e-6
ATOL_LOGITS = 1e-4  # the reference's decode-vs-forward tolerance
ATOL_SHORT = 1e-5


def _cfgs(arch, **over):
    from repro.configs import get_config as jget

    j, t = jget(arch, smoke=True), tget(arch, smoke=True)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _redraw(tree, rng, path=()):
    """The reference's numpy tree with the constant-initialised leaves
    redrawn (see the module docstring)."""
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_redraw(v, rng, path + (i,)) for i, v in enumerate(tree))
    name, shape = path[-1], tree.shape
    draw = {
        "ba": lambda: rng.normal(size=shape),
        "bi": lambda: rng.normal(size=shape) * 0.1,
        "conv_b": lambda: rng.normal(size=shape) * 0.1,
        "lam": lambda: rng.uniform(-6.0, 0.0, size=shape),
        "u": lambda: rng.normal(size=shape) * 0.5,
        "w0": lambda: rng.uniform(-4.0, 1.0, size=shape),
        "bias": lambda: rng.normal(size=shape) * 0.1,
        # LayerNorm's scale (ones) about one, RMSNorm's (1 + scale) about zero
        "scale": lambda: (tree.ravel()[0] + rng.normal(size=shape) * 0.3),
    }.get(name)
    if name.startswith("mu_"):
        draw = lambda: rng.uniform(0.0, 1.0, size=shape)  # noqa: E731
    return tree if draw is None else draw().astype(np.float32)


def _reference(jcfg, seed=0):
    import jax
    from repro.models import build_model as jbuild

    model = jbuild(jcfg)
    tree = _redraw(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed))), np.random.default_rng(seed))
    return model, tree


def _port(tcfg, tree):
    return tbuild(tcfg, device="cpu", params=convert.lm_params_from_reference(tcfg, tree, device="cpu"))


def _clone(cache):
    return [type(c)(*(t.clone() for t in c)) for c in cache]


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _layer_params(tree, part):
    """Layer 0's ``part`` leaves of the reference LM tree (group 0, cycle
    position 0, repeat 0) as numpy arrays."""
    block = tree["groups"][0][0][part]
    return {k: ({n: a[0] for n, a in v.items()} if isinstance(v, dict) else v[0]) for k, v in block.items()}


def _assert_close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32), atol=atol, rtol=0,
                               err_msg=msg)


@pytest.mark.parametrize("seq", (5, 21, 77))
def test_rglru_train_and_decode_match_reference(seq):
    """``apply_recurrent_train`` with its emitted state, then 4 decode
    steps from that state, within 2e-5 of the reference's outputs and
    states (the doubling scan against ``associative_scan``)."""
    import jax.numpy as jnp
    from repro.layers import rglru as jrglru

    jcfg, tcfg = _cfgs("recurrentgemma_2b")
    _, tree = _reference(jcfg)
    p = _layer_params(tree, "lru")
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(2, seq + 4, tcfg.d_model)).astype(np.float32)
    want, js = jrglru.apply_recurrent_train(jcfg, p, jnp.asarray(x[:, :seq]), emit_state=True)
    got, ts = trglru.apply_recurrent_train(tcfg, _t(p), torch.from_numpy(x[:, :seq]), emit_state=True)
    _assert_close(got, want, ATOL_LRU, "train output")
    _assert_close(ts.h, js.h, ATOL_LRU, "state h")
    assert ts.conv.shape == js.conv.shape
    _assert_close(ts.conv, js.conv, ATOL_LRU, "conv window")
    for i in range(seq, seq + 4):
        want, js = jrglru.apply_recurrent_decode(jcfg, p, jnp.asarray(x[:, i:i + 1]), js)
        got, ts = trglru.apply_recurrent_decode(tcfg, _t(p), torch.from_numpy(x[:, i:i + 1]), ts)
        _assert_close(got, want, ATOL_LRU, f"decode {i}")
        _assert_close(ts.h, js.h, ATOL_LRU, f"decode {i} h")
        _assert_close(ts.conv, js.conv, ATOL_LRU, f"decode {i} conv")


def test_linear_scan_is_the_sequential_recurrence():
    """The doubling scan against a plain loop h_t = a_t·h_{t-1} + b_t in
    float64, at lengths around powers of two."""
    rng = np.random.default_rng(4)
    for s in (1, 2, 3, 8, 9, 100):
        a = rng.uniform(0.5, 1.0, size=(2, s, 3))
        b = rng.normal(size=(2, s, 3))
        want, h = np.zeros_like(b), np.zeros((2, 3))
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want[:, t] = h
        got = trglru.linear_scan(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12, err_msg=str(s))


def test_rwkv_mixes_match_reference():
    """Time-mix and channel-mix at a prompt of 21 tokens (chunks of 8: a
    padded last chunk), the final state and both shifts, then 4 decode
    steps from them, within 1e-4 of the reference."""
    import jax.numpy as jnp
    from repro.layers import rwkv as jrwkv

    jcfg, tcfg = _cfgs("rwkv6_3b")
    _, tree = _reference(jcfg)
    p = _layer_params(tree, "rwkv")
    tp = _t(p)
    rng = np.random.default_rng(21)
    s = 21
    x = rng.normal(size=(2, s + 4, tcfg.d_model)).astype(np.float32)
    assert s % tcfg.rwkv_chunk
    want, js = jrwkv.time_mix_train(jcfg, p, jnp.asarray(x[:, :s]), emit_state=True)
    got, ts = trwkv.time_mix_train(tcfg, tp, torch.from_numpy(x[:, :s]), emit_state=True)
    _assert_close(got, want, ATOL_RWKV, "time-mix")
    _assert_close(ts, js, ATOL_RWKV, "state")
    _assert_close(trwkv.channel_mix_train(tcfg, tp, torch.from_numpy(x[:, :s])),
                  jrwkv.channel_mix_train(jcfg, p, jnp.asarray(x[:, :s])), ATOL_RWKV, "channel-mix")
    jstate = jrwkv.RWKVState(s=js, shift_t=jnp.asarray(x[:, s - 1]), shift_c=jnp.asarray(x[:, s - 1] * 0.5))
    tstate = trwkv.RWKVState(s=ts, shift_t=torch.from_numpy(x[:, s - 1]), shift_c=torch.from_numpy(x[:, s - 1] * 0.5))
    for i in range(s, s + 4):
        xi = x[:, i:i + 1]
        jo, js_new, jshift = jrwkv.time_mix_decode(jcfg, p, jnp.asarray(xi), jstate)
        to, ts_new, tshift = trwkv.time_mix_decode(tcfg, tp, torch.from_numpy(xi), tstate)
        _assert_close(to, jo, ATOL_RWKV, f"time-mix decode {i}")
        _assert_close(ts_new, js_new, ATOL_RWKV, f"state {i}")
        _assert_close(tshift, jshift, 0.0, f"shift_t {i}")
        jc, jshift_c = jrwkv.channel_mix_decode(jcfg, p, jnp.asarray(xi), jstate)
        tc, tshift_c = trwkv.channel_mix_decode(tcfg, tp, torch.from_numpy(xi), tstate)
        _assert_close(tc, jc, ATOL_RWKV, f"channel-mix decode {i}")
        jstate = jrwkv.RWKVState(s=js_new, shift_t=jshift, shift_c=jshift_c)
        tstate = trwkv.RWKVState(s=ts_new, shift_t=tshift, shift_c=tshift_c)


def test_rwkv_chunk_padding_leaves_the_state():
    """A prompt cut at a chunk boundary and the same prompt padded within
    its last chunk carry the same state: zero padding rows change nothing
    (``_chunked_gla`` at 16 and at 13 + 3 zero rows)."""
    rng = np.random.default_rng(3)
    r, k, v = (torch.from_numpy(rng.normal(size=(1, 13, 2, 4)).astype(np.float32)) for _ in range(3))
    log_w = torch.from_numpy(rng.uniform(-2.7, 0.0, size=(1, 13, 2, 4)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(2, 4)).astype(np.float32))
    out, state = trwkv._chunked_gla(r, k, v, log_w, u, 8)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 3))  # noqa: E731
    out16, state16 = trwkv._chunked_gla(pad(r), pad(k), pad(v), pad(log_w), u, 8)
    assert torch.equal(out16[:, :13], out) and torch.equal(state16, state)


def test_groupnorm_heads_matches_reference():
    import jax.numpy as jnp
    from repro.layers import norms as jnorms

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 5, 4, 16)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32), "bias": rng.normal(size=64).astype(np.float32)}
    want = jnorms.groupnorm_heads(p, jnp.asarray(x))
    got = tnorms.groupnorm_heads(_t(p), torch.from_numpy(x))
    assert tuple(got.shape) == (2, 5, 64)
    _assert_close(got, want, ATOL_NORM)
    bf = tnorms.groupnorm_heads(_t(p), torch.from_numpy(x).bfloat16())
    assert bf.dtype == torch.bfloat16


def _runs(jcfg, tcfg, b=2, t=24, gen=8, seed=5):
    """Logits of the reference and of the port (eager, then compiled) over
    a prefill of ``t`` tokens and ``gen`` decode steps, teacher-forced on
    one seeded token stream; with the port's final caches."""
    import jax
    import jax.numpy as jnp

    jm, tree = _reference(jcfg)
    tm = _port(tcfg, tree)
    toks = np.random.default_rng(seed).integers(0, tcfg.vocab_size, size=(b, t + gen))
    prefill = jax.jit(jm.prefill, static_argnums=2)
    decode = jax.jit(jm.decode_step)
    lj, cj = prefill(tree, jnp.asarray(toks[:, :t]), t + gen)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :t]), max_len=t + gen)
    cc = _clone(ct)
    step = tm.compile_decode(cc)
    runs = {"reference": [np.asarray(lj.astype(jnp.float32))], "eager": [lt.float().numpy()]}
    runs["compiled"] = list(runs["eager"])
    for pos in range(t, t + gen):
        tok = toks[:, pos:pos + 1]
        lj, cj = decode(tree, jnp.asarray(tok), pos, cj)
        lt, ct = tm.decode_step(torch.from_numpy(tok), pos, ct)
        runs["reference"].append(np.asarray(lj.astype(jnp.float32)))
        runs["eager"].append(lt.float().numpy())
        runs["compiled"].append(step(torch.from_numpy(tok), torch.tensor(pos)).float().numpy())
    return runs, ct, cc


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_reference(arch):
    """Prefill of 24 tokens at batch 2, then 8 decode steps at 24..31,
    eager and through the compiled step (eager on the CPU), within 1e-4 of
    the reference's logits. recurrentgemma's smoke layers are R R L R (its
    local layer's window, 16, wraps); rwkv6's are W W. The compiled step's
    caches end bit for bit the eager loop's."""
    jcfg, tcfg = _cfgs(arch)
    runs, eager, compiled = _runs(jcfg, tcfg)
    for i, want in enumerate(runs["reference"]):
        np.testing.assert_allclose(runs["eager"][i], want, atol=ATOL_LOGITS, rtol=0, err_msg=f"call {i}")
        np.testing.assert_array_equal(runs["compiled"][i], runs["eager"][i])
    assert all(torch.equal(a, b) for ca, cb in zip(eager, compiled) for a, b in zip(ca, cb))
    kinds = {type(c).__name__ for c in eager}
    assert kinds == ({"LRUState", "KVCache"} if arch == "recurrentgemma_2b" else {"RWKVState"})


def _bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at magnitude
    ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_bfloat16_greedy_tokens_match_reference(arch):
    """The same run in bfloat16 (float32 parameters; RWKV's ``u`` and decay
    LoRA read in float32, its decode casting the attention output before
    ``ln_x``): the greedy token of every (batch, call) row equals the
    reference's, and every state keeps the reference's dtype.

    One row flips on a near-tie: in rwkv6's prefill, batch row 0, the
    reference's top two logits are 0.375 and 0.373, one bfloat16 ulp apart,
    and its order is the reverse of its own float32 run's (0.3759 and
    0.3736), which the port's follows.
    The two packages' bfloat16 logits differ by rounding (the time-mix's
    r, k, v, g and decays are bit for bit the reference's, its state
    within 1e-6), so on a row whose reference top two lie within one ulp of
    the logit scale the port's token must be one of those two and equal
    the float32 run's token (2 of rwkv6's 18 rows, the other one equal);
    every other row is held exactly."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    runs, eager, _ = _runs(jcfg, tcfg)
    runs32, _, _ = _runs(*_cfgs(arch))
    ulp = _bf16_ulp(max(float(np.abs(r).max()) for r in runs["reference"]))
    near = []
    for i, want in enumerate(runs["reference"]):
        assert np.array_equal(runs["compiled"][i], runs["eager"][i])
        top2 = np.argsort(-want, axis=-1, kind="stable")[:, :2]
        for row, (got, f32) in enumerate(zip(runs["eager"][i].argmax(-1), runs32["reference"][i].argmax(-1))):
            a, b = top2[row]
            if want[row, a] - want[row, b] <= ulp:
                near.append((i, row))
                assert got in (a, b) and got == f32, (i, row)
            else:
                assert got == a, (i, row)
    assert len(near) <= 2, near
    for c in eager:
        if isinstance(c, trglru.LRUState):
            assert c.h.dtype == torch.float32 and c.conv.dtype == torch.bfloat16
        elif isinstance(c, trwkv.RWKVState):
            assert c.s.dtype == torch.float32 and c.shift_t.dtype == c.shift_c.dtype == torch.bfloat16


def test_short_prompt_conv_state():
    """The reference's fault (``src/repro/layers/rglru.py:78``): a prompt
    of 1 or 2 tokens leaves a conv state of 1 row (``u[:, s - cw + 1:]``
    with a negative start) where the decode step
    needs ``conv_width - 1`` = 3, and the step raises ``ValueError``; at 3
    tokens it runs. The port pads the state with the conv's causal zeros,
    so its ``prefill(s)`` plus one step equals its ``prefill(s + 1)``
    within 1e-5 at s = 1 and 2 (logits and every recurrent state)."""
    import jax.numpy as jnp

    jcfg, tcfg = _cfgs("recurrentgemma_2b")
    jm, tree = _reference(jcfg)
    tm = _port(tcfg, tree)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, size=(2, 4))
    for s in (1, 2, 3):
        _, cj = jm.prefill(tree, jnp.asarray(toks[:, :s]), 8)
        if s < tcfg.conv_width - 1:
            assert cj[0][0].conv.shape[2] == 1  # u[:, s - 3:] wraps to the last row
            with pytest.raises(ValueError, match="Size of label"):
                jm.decode_step(tree, jnp.asarray(toks[:, s:s + 1]), s, cj)
        else:
            jm.decode_step(tree, jnp.asarray(toks[:, s:s + 1]), s, cj)
    for s in (1, 2):
        _, ct = tm.prefill(torch.from_numpy(toks[:, :s]), max_len=8)
        assert all(c.conv.shape[1] == tcfg.conv_width - 1 for c in ct if isinstance(c, trglru.LRUState))
        got, ct = tm.decode_step(torch.from_numpy(toks[:, s:s + 1]), s, ct)
        want, cw = tm.prefill(torch.from_numpy(toks[:, :s + 1]), max_len=8)
        _assert_close(got, want.numpy(), ATOL_SHORT, f"prefill({s}) + a step")
        for a, b in zip(ct, cw):
            if isinstance(a, trglru.LRUState):
                _assert_close(a.h, b.h.numpy(), ATOL_SHORT)
                _assert_close(a.conv, b.conv.numpy(), ATOL_SHORT)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_warm_up_advances_the_state_once(arch, monkeypatch):
    """``DecodeStep``'s first call on the card warms the step up eagerly,
    captures it and replays it. With a stand-in for
    ``session._capture_graph`` that runs the step eagerly and returns a
    graph whose ``replay`` runs it again, the first call (and the next)
    leaves every R and W state, and the logits, equal to eager
    ``decode_step``s: the warm-up's advance is undone."""
    from repro_torch.core import session as tsession

    _, tcfg = _cfgs(arch)
    tm = tbuild(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tcfg.vocab_size, size=(2, 12)))
    _, cache = tm.prefill(toks[:, :10], max_len=12)
    eager = _clone(cache)

    class Replay:
        def __init__(self, forward, out):
            self.forward, self.out = forward, out

        def replay(self):
            self.out.copy_(self.forward())

    def capture(forward, device, inference=True):
        with torch.inference_mode():
            out = forward()  # the warm-up
            return Replay(forward, out), out

    monkeypatch.setattr(tsession, "_capture_graph", capture)
    monkeypatch.setattr(tm, "device", torch.device("cuda"))  # take the capturing path
    step = tm.compile_decode(cache)
    for pos in (10, 11):
        got = step(toks[:, pos:pos + 1], torch.tensor(pos))
        want, eager = tm.decode_step(toks[:, pos:pos + 1], pos, eager)
        assert torch.equal(got, want), pos
        for a, b in zip(cache, eager):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (pos, type(a).__name__)
    assert isinstance(step._graph, Replay)


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_follows_the_reference(arch):
    """The port's seeded init gives each recurrent leaf the reference's
    init (``init_recurrent``, ``init_rwkv``): the constants (``ba`` 4.0,
    ``lam``, the ``mu_*`` at 0.5, ``w0`` at -2.0, ``ln_x`` scale one and bias
    zero) equal the reference's leaves within 1e-6 (``lam``'s linspace,
    ``expm1`` and ``log`` round an ulp apart), and the scaled glorot leaves
    (``conv_w``, ``decay_a``, ``decay_b``) stay within a tenth of the glorot
    limit and reach past nine tenths of that."""
    import math

    jcfg, tcfg = _cfgs(arch)
    import jax
    from repro.models import build_model as jbuild

    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    ref = convert.lm_params_from_reference(tcfg, tree, device="cpu")
    port = dict(tbuild(tcfg, device="cpu", generator=torch.Generator().manual_seed(1)).named_parameters())
    const = ("lru.ba", "lru.lam", "lru.bi", "lru.conv_b", "rwkv.w0", "rwkv.ln_x.scale", "rwkv.ln_x.bias")
    scaled = ("lru.conv_w", "rwkv.decay_a", "rwkv.decay_b")
    seen = set()
    for name, p in port.items():
        leaf = name.split(".", 2)[-1] if name.startswith("layers.") else name
        if leaf in const or leaf.startswith("rwkv.mu_"):
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
            seen.add(leaf)
        elif leaf in scaled:
            lim = 0.1 * math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            top = float(p.abs().max())
            assert 0.9 * lim < top <= lim, name
            seen.add(leaf)
    want = {"recurrentgemma_2b": {"lru.ba", "lru.lam", "lru.bi", "lru.conv_b", "lru.conv_w"},
            "rwkv6_3b": {"rwkv.w0", "rwkv.ln_x.scale", "rwkv.ln_x.bias", "rwkv.decay_a", "rwkv.decay_b"}
            | {f"rwkv.mu_{n}" for n in ("r", "k", "v", "g", "w", "k2", "r2")}}[arch]
    assert seen == want


def test_rwkv_float32_leaves_in_bfloat16():
    """With ``param_dtype`` and ``dtype`` bfloat16, RWKV's ``u``, ``decay_a``
    and ``decay_b`` stay float32 in storage and in ``compute_params`` (the
    reference reads them in float32 at every use), as do the vectors; its
    other matrices are bfloat16."""
    from repro_torch.models.lm import LM

    _, tcfg = _cfgs("rwkv6_3b", dtype="bfloat16", param_dtype="bfloat16")
    lm = LM(tcfg, device="cpu")
    stored = {n.split(".", 2)[-1]: p.dtype for n, p in lm.named_parameters() if n.startswith("layers.0.")}
    cp = lm.compute_params()["layers"][0]["rwkv"]
    for name in ("u", "decay_a", "decay_b", "w0", "mu_k"):
        assert stored[f"rwkv.{name}"] == cp[name].dtype == torch.float32, name
    assert cp["ln_x"]["scale"].dtype == torch.float32
    assert stored["rwkv.wr"] == cp["wr"].dtype == torch.bfloat16
