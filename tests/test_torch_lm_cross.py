"""Port parity: the cross-attention LM archs (llama-3.2-vision-90b's gated
"C" blocks, seamless-m4t-medium's "E" encoder and "D" decoder blocks with
the plain-GELU MLP) against the reference. (Each arch's config, its full
parameter layout and the serving CLI are held in ``test_torch_lm.py``,
with the other archs'.)

On the CPU, in float32 (the smoke configs' dtype), the same numpy inputs
and the reference's own parameters (converted with
``convert.lm_params_from_reference``) go through both packages. The
reference inits every cross-attention ``gate`` to zero, which silences the
cross path (``tanh(0) = 0``), and every QKV bias to zero; both are redrawn
away from zero here, as are the norm scales and biases, so that each
moves the output (a case below shows that with the gates at zero the
context changes nothing, and with the redrawn gates it does).

Non-causal flash over a context of 19 rows (not a multiple of the chunk,
8), ``attention_train`` with a context and ``cross_attention_decode``
dense and pruned (1 and 2 q-heads per kv-head, K < C: the port's pruned
branch runs the plain version of kernel #4) agree within 2e-5; the MLP
and the "E", "C" and "D" blocks, train and decode, within 1e-5; each
smoke LM's prefill of 12 tokens with its 16-row context plus 8 decode
steps, eager and through ``compile_decode``, within 1e-4 on logits with
``attn_prune_k`` None and 8 (K = 8 prunes the cross-attention over 16
rows and the self-attention past 8 cached positions); in bfloat16 the
greedy tokens equal the reference's on every row that is not a near-tie
(see that test). The cross-attention's tie rule is
recorded: for logits [1, 1, 2] at K = 2 the reference's ``top_k`` keeps
rows {0, 2}, the port (the kernel's rule) {1, 2}.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import blocks as tblocks  # noqa: E402
from repro_torch.layers import flash as tflash  # noqa: E402
from repro_torch.layers import mlp as tmlp  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models.lm import cache_tensors, clone_cache  # noqa: E402

ARCHS = ("llama32_vision_90b", "seamless_m4t_medium")
ATOL_ATTN = 2e-5
ATOL_BLOCK = 1e-5
ATOL_LOGITS = 1e-4  # the reference's decode-vs-forward tolerance
CTX = 19  # context rows of the layer cases: not a multiple of the chunk


def _cfgs(arch, **over):
    from repro.configs import get_config as jget

    j, t = jget(arch, smoke=True), tget(arch, smoke=True)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _redraw(tree, rng, path=()):
    """The reference's numpy tree with its zero-initialised gates and QKV
    biases, and its norms, redrawn (see the module docstring)."""
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_redraw(v, rng, path + (i,)) for i, v in enumerate(tree))
    name, shape = path[-1], tree.shape
    draw = {
        "gate": lambda: rng.uniform(0.5, 1.5, size=shape) * rng.choice((-1.0, 1.0), size=shape),
        "bq": lambda: rng.normal(size=shape) * 0.2,
        "bk": lambda: rng.normal(size=shape) * 0.2,
        "bv": lambda: rng.normal(size=shape) * 0.2,
        "bias": lambda: rng.normal(size=shape) * 0.1,
        # LayerNorm's scale (ones) about one, RMSNorm's (1 + scale) about zero
        "scale": lambda: tree.ravel()[0] + rng.normal(size=shape) * 0.3,
    }.get(name)
    return tree if draw is None else np.asarray(draw(), dtype=np.float32)


def _reference(jcfg, seed=0):
    import jax
    from repro.models import build_model as jbuild

    model = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    return model, _redraw(tree, np.random.default_rng(seed))


def _port(tcfg, tree):
    return tbuild(tcfg, device="cpu", params=convert.lm_params_from_reference(tcfg, tree, device="cpu"))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _block(tree, arch, kind):
    """One block's leaves of the reference LM tree (repeat 0) as numpy
    arrays: llama's "C" is group 0's cycle position 1, seamless's "D" its
    position 0, and an "E" block the encoder stack's first row."""
    stack = tree["encoder"]["stack"] if kind == "E" else tree["groups"][0][1 if arch.startswith("llama") else 0]

    def first(node):
        return {k: first(v) for k, v in node.items()} if isinstance(node, dict) else node[0]

    return first(stack)


def _context(rng, tcfg, b=2, c=CTX):
    return rng.normal(size=(b, c, tcfg.d_model)).astype(np.float32)


def _assert_close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32), atol=atol, rtol=0,
                               err_msg=msg)


@pytest.mark.parametrize("groups", (1, 2))
def test_flash_over_a_context_matches_reference(groups):
    """Non-causal flash, 13 query rows over a context of 19 kv rows, chunks
    of 8 (both padded), 1 and 2 q-heads per kv-head."""
    import jax.numpy as jnp
    from repro.layers import flash as jflash

    jcfg, tcfg = _cfgs("llama32_vision_90b", attn_chunk_q=8, attn_chunk_kv=8)
    rng = np.random.default_rng(groups)
    q = rng.normal(size=(2, 13, 2 * groups, 16)).astype(np.float32)
    k = rng.normal(size=(2, CTX, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, CTX, 2, 16)).astype(np.float32)
    want = jflash.flash_attention(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    got = tflash.flash_attention(tcfg, *(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    _assert_close(got, want, ATOL_ATTN)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_train_with_a_context_matches_reference(arch):
    """``attention_train`` with a 19-row context (no RoPE, not causal, the
    output gated, seamless's biases on K and V): the output and the
    emitted context K/V within 2e-5; at 1 (seamless) and 2 (llama) q-heads
    per kv-head."""
    import jax.numpy as jnp
    from repro.layers import attention as jattn

    jcfg, tcfg = _cfgs(arch, attn_chunk_q=8, attn_chunk_kv=8)
    _, tree = _reference(jcfg)
    p = _block(tree, arch, "C")["cross"]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 13, tcfg.d_model)).astype(np.float32)
    ctx = _context(rng, tcfg)
    pos = np.arange(13)
    want, wc = jattn.attention_train(jcfg, p, jnp.asarray(x), jnp.asarray(pos), context=jnp.asarray(ctx),
                                     emit_cache=True)
    got, gc = tattn.attention_train(tcfg, _t(p), torch.from_numpy(x), torch.from_numpy(pos),
                                    context=torch.from_numpy(ctx), emit_cache=True)
    _assert_close(got, want, ATOL_ATTN, "output")
    _assert_close(gc.k, wc.k, ATOL_ATTN, "context K")
    _assert_close(gc.v, wc.v, ATOL_ATTN, "context V")
    assert float(np.abs(np.asarray(want)).max()) > 0.1  # the gate passes the branch


@pytest.mark.parametrize("prune_k", (None, 8, CTX))
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_decode_matches_reference(arch, prune_k):
    """``cross_attention_decode`` against a 19-row context cache: dense
    (``attn_prune_k`` None, and K = C, which is dense too) and pruned to
    K = 8 < C, where the port runs the plain version of kernel #4 with
    every row valid; 1 and 2 q-heads per kv-head; within 2e-5. The cache
    is only read."""
    import jax.numpy as jnp
    from repro.layers import attention as jattn

    jcfg, tcfg = _cfgs(arch, attn_prune_k=prune_k)
    _, tree = _reference(jcfg)
    p = _block(tree, arch, "C")["cross"]
    rng = np.random.default_rng(12)
    hkv, hd = tcfg.num_kv_heads, tcfg.hd
    ck, cv = (rng.normal(size=(2, CTX, hkv, hd)).astype(np.float32) for _ in range(2))
    for step in range(3):
        x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        want = jattn.cross_attention_decode(jcfg, p, jnp.asarray(x), jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)))
        cache = tattn.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
        got = tattn.cross_attention_decode(tcfg, _t(p), torch.from_numpy(x), cache)
        _assert_close(got, want, ATOL_ATTN, f"step {step}")
        assert np.array_equal(cache.k.numpy(), ck) and np.array_equal(cache.v.numpy(), cv)


def test_cross_attention_tie_rule_recorded():
    """Logits [1, 1, 2] over a 3-row context at K = 2 (one head, hd 4, q =
    e_0, V row j = e_j, ``wq`` and ``wo`` the identity): the reference's
    ``top_k`` keeps rows {0, 2}, the port, by the kernel's rule (first
    minimum evicted, strictly greater inserted), rows {1, 2}. Each output
    is the softmax of [1, 2] over its two rows."""
    import jax.numpy as jnp
    from repro.layers import attention as jattn

    jcfg, tcfg = _cfgs("llama32_vision_90b", d_model=4, num_heads=1, num_kv_heads=1, attn_prune_k=2)
    eye = np.eye(4, dtype=np.float32)
    p = {"wq": eye, "wk": eye, "wv": eye, "wo": eye, "gate": np.float32(np.arctanh(0.5))}
    ck = np.zeros((1, 3, 1, 4), np.float32)
    ck[0, :, 0, 0] = np.array([1.0, 1.0, 2.0]) * 2.0  # × hd ** -0.5 = 0.5
    cv = np.zeros((1, 3, 1, 4), np.float32)
    cv[0, [0, 1, 2], 0, [0, 1, 2]] = 1.0
    x = eye[None, :1]  # (1, 1, 4): q = e_0
    want = np.asarray(jattn.cross_attention_decode(jcfg, p, jnp.asarray(x), jattn.KVCache(jnp.asarray(ck),
                                                                                         jnp.asarray(cv))))
    got = tattn.cross_attention_decode(tcfg, _t(p), torch.from_numpy(x),
                                       tattn.KVCache(torch.from_numpy(ck), torch.from_numpy(cv))).numpy()
    lo, hi = np.exp(1.0) / (np.exp(1.0) + np.exp(2.0)) * 0.5, np.exp(2.0) / (np.exp(1.0) + np.exp(2.0)) * 0.5
    np.testing.assert_allclose(want[0, 0], [lo, 0.0, hi, 0.0], atol=1e-6)
    np.testing.assert_allclose(got[0, 0], [0.0, lo, hi, 0.0], atol=1e-6)


def test_gelu_mlp_matches_reference():
    """The plain-GELU MLP (tanh GELU, ``wi`` and ``wo`` only) within
    1e-5."""
    from repro.layers import mlp as jmlp

    jcfg, tcfg = _cfgs("seamless_m4t_medium")
    assert set(tmlp.mlp_shapes(tcfg)) == {"wi", "wo"}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    p = {n: (rng.normal(size=s) * 0.2).astype(np.float32) for n, s in tmlp.mlp_shapes(tcfg).items()}
    _assert_close(tmlp.apply_mlp(tcfg, _t(p), torch.from_numpy(x)), jmlp.apply_mlp(jcfg, p, x), ATOL_BLOCK)


@pytest.mark.parametrize("arch,kind", (("seamless_m4t_medium", "E"), ("llama32_vision_90b", "C"),
                                       ("seamless_m4t_medium", "D")))
def test_blocks_match_reference(arch, kind):
    """An "E", "C" or "D" block over 13 positions (a 19-row context for C
    and D), with its emitted cache, then 3 decode steps from that cache
    (C and D): outputs and every cache tensor within 1e-5. A "C" step
    leaves its context cache as it was; a "D" step writes its self slot."""
    import jax.numpy as jnp
    from repro.layers import blocks as jblocks

    jcfg, tcfg = _cfgs(arch, attn_chunk_q=8, attn_chunk_kv=8)
    _, tree = _reference(jcfg)
    p = _block(tree, arch, kind)
    tp = _t(p)
    rng = np.random.default_rng(13)
    s, gen, max_len = 13, 3, 16
    x = rng.normal(size=(2, s + gen, tcfg.d_model)).astype(np.float32)
    ctx = _context(rng, tcfg)
    pos = np.arange(s)
    want, _, jc = jblocks.apply_block_train(jcfg, kind, p, jnp.asarray(x[:, :s]), jnp.asarray(pos),
                                            context=jnp.asarray(ctx), emit_cache=kind != "E")
    got, _, tc = tblocks.apply_block_train(tcfg, kind, tp, torch.from_numpy(x[:, :s]), torch.from_numpy(pos),
                                           context=torch.from_numpy(ctx), emit_cache=kind != "E")
    _assert_close(got, want, ATOL_BLOCK, "train")
    if kind == "E":
        assert tc is None and jc is None
        return
    if kind == "C":
        emitted = [(tc.k, jc.k), (tc.v, jc.v)]
        jcache, tcache = jc, tc
    else:
        emitted = [(tc.self.k, jc["self"].k), (tc.self.v, jc["self"].v),
                   (tc.cross.k, jc["cross"].k), (tc.cross.v, jc["cross"].v)]
        jcache = {"self": _jpadded(jc["self"], max_len - s), "cross": jc["cross"]}
        tcache = tblocks.DecoderCache(
            tattn.KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, max_len - s)) for t in tc.self)), tc.cross)
    for i, (g, w) in enumerate(emitted):
        _assert_close(g, w, ATOL_BLOCK, f"emitted cache tensor {i}")
    ctx_before = [t.clone() for t in (tcache if kind == "C" else tcache.cross)]
    for i in range(s, s + gen):
        want, jcache = jblocks.apply_block_decode(jcfg, kind, p, jnp.asarray(x[:, i:i + 1]), i, jcache)
        got, tcache = tblocks.apply_block_decode(tcfg, kind, tp, torch.from_numpy(x[:, i:i + 1]), i, tcache)
        _assert_close(got, want, ATOL_BLOCK, f"decode {i}")
    if kind == "D":
        _assert_close(tcache.self.k, jcache["self"].k, ATOL_BLOCK, "self K")
        _assert_close(tcache.self.v, jcache["self"].v, ATOL_BLOCK, "self V")
    after = tcache if kind == "C" else tcache.cross
    assert all(torch.equal(a, b) for a, b in zip(after, ctx_before))


def _jpadded(cache, pad):
    """A reference ``KVCache`` zero-padded by ``pad`` positions."""
    import jax.numpy as jnp
    from repro.layers import attention as jattn

    widths = ((0, 0), (0, pad), (0, 0), (0, 0))
    return jattn.KVCache(k=jnp.pad(cache.k, widths), v=jnp.pad(cache.v, widths))


def _runs(jcfg, tcfg, b=2, t=12, gen=8, seed=5):
    """Logits of the reference and of the port (eager, then compiled) over
    a prefill of ``t`` tokens with a seeded context and ``gen`` decode
    steps, teacher-forced on one seeded token stream; with the port's
    final caches (eager and compiled)."""
    import jax
    import jax.numpy as jnp

    jm, tree = _reference(jcfg)
    tm = _port(tcfg, tree)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tcfg.vocab_size, size=(b, t + gen))
    ctx = rng.normal(size=(b, tm.ctx_len, tcfg.d_model)).astype(np.float32)
    prefill = jax.jit(lambda p, x, c: jm.prefill(p, x, t + gen, context=c))
    decode = jax.jit(jm.decode_step)
    lj, cj = prefill(tree, jnp.asarray(toks[:, :t]), jnp.asarray(ctx))
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :t]), max_len=t + gen, context=torch.from_numpy(ctx))
    cc = clone_cache(ct)
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


@pytest.mark.parametrize("prune_k", (None, 8))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_reference(arch, prune_k):
    """Prefill of 12 tokens at batch 2 with a 16-row context, then 8 decode
    steps at 12..19, eager and through the compiled step (eager on the
    CPU), within 1e-4 of the reference's logits. llama's smoke layers are
    A C A C, seamless's D D over a 2-layer encoder; with K = 8 the cross-
    attentions prune 16 rows to 8 and the self-attentions 13..20 cached
    positions to 8. The compiled step's caches end bit for bit the eager
    loop's, and the context caches as prefill left them."""
    jcfg, tcfg = _cfgs(arch, attn_prune_k=prune_k)
    runs, eager, compiled = _runs(jcfg, tcfg)
    for i, want in enumerate(runs["reference"]):
        np.testing.assert_allclose(runs["eager"][i], want, atol=ATOL_LOGITS, rtol=0, err_msg=f"call {i}")
        np.testing.assert_array_equal(runs["compiled"][i], runs["eager"][i])
    assert all(torch.equal(a, b) for a, b in zip(cache_tensors(eager), cache_tensors(compiled)))
    kinds = {type(c).__name__ for c in eager}
    assert kinds == ({"KVCache"} if arch.startswith("llama") else {"DecoderCache"})
    ctx_rows = [c.k.shape[1] for c in eager[1::2]] if arch.startswith("llama") else [c.cross.k.shape[1]
                                                                                       for c in eager]
    assert set(ctx_rows) == {16}


def _bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at magnitude
    ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("prune_k", (None, 8))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_bfloat16_greedy_tokens_match_reference(arch, prune_k):
    """The same run in bfloat16, float32 parameters: the greedy token of
    every (batch, call) row whose reference top two logits lie more than 2
    bfloat16 ulps of the logit scale apart equals the reference's; on the
    other rows (near-ties: the smoke vocabulary's 256 logits all lie
    within about 0.5, and the reference itself ties exactly on some rows)
    the port's token is one of the reference's within 2 ulps of its
    largest logit. Dense, the logits lie within 4 ulps of the reference's
    (2.25 measured). Pruned, they move further (17 ulps measured, llama):
    the reference ranks the rows by logits rounded to bfloat16 (its
    einsum's output), the port by float32 logits of the bfloat16 cache
    (kernel #4's), so the two can retain a different K-th row. The gates
    stay float32 in storage and in ``compute_params``; the caches are
    bfloat16."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16", attn_prune_k=prune_k)
    runs, eager, _ = _runs(jcfg, tcfg)
    ulp = _bf16_ulp(max(float(np.abs(r).max()) for r in runs["reference"]))
    near, rows = [], 0
    for i, want in enumerate(runs["reference"]):
        assert np.array_equal(runs["compiled"][i], runs["eager"][i])
        top2 = np.sort(want, axis=-1)[:, -2:]
        for row, got in enumerate(runs["eager"][i].argmax(-1)):
            rows += 1
            if top2[row, 1] - top2[row, 0] > 2 * ulp:
                assert got == want[row].argmax(), (i, row)
            else:
                near.append((i, row))
                assert want[row, got] >= top2[row, 1] - 2 * ulp, (i, row)
        if prune_k is None:
            np.testing.assert_allclose(runs["eager"][i], want, atol=4 * ulp, rtol=0, err_msg=f"call {i}")
    assert len(near) <= rows // 3, near
    assert all(t.dtype == torch.bfloat16 for t in cache_tensors(eager))
    lm = tbuild(tcfg, device="cpu")
    layer = lm.compute_params()["layers"][1 if arch.startswith("llama") else 0]
    assert layer["cross"]["gate"].dtype == torch.float32 and layer["cross"]["gate"].dim() == 0
    assert layer["cross"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_path_moves_the_logits_only_with_gates(arch):
    """Not vacuous: with the reference's zero gates the logits (prefill and
    3 decode steps) are the same bit for bit for two different contexts,
    as those of an LM with no cross path; with the redrawn gates they
    differ by more than 1e-3."""
    jcfg, tcfg = _cfgs(arch)
    _, redrawn = _reference(jcfg)
    zeroed = _redraw_gates_to_zero(redrawn)
    rng = np.random.default_rng(21)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, size=(2, 15)))
    ctxs = [torch.from_numpy(rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)) for _ in range(2)]
    for tree, moves in ((zeroed, False), (redrawn, True)):
        tm = _port(tcfg, tree)
        runs = []
        for ctx in ctxs:
            lg, cache = tm.prefill(toks[:, :12], max_len=15, context=ctx)
            out = [lg]
            for pos in range(12, 15):
                lg, cache = tm.decode_step(toks[:, pos:pos + 1], pos, cache)
                out.append(lg)
            runs.append(torch.stack(out))
        if moves:
            assert float((runs[0] - runs[1]).abs().max()) > 1e-3
        else:
            assert torch.equal(runs[0], runs[1])


def _redraw_gates_to_zero(tree):
    if isinstance(tree, dict):
        return {k: (np.zeros_like(v) if k == "gate" else _redraw_gates_to_zero(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_redraw_gates_to_zero(v) for v in tree)
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_follows_the_reference(arch):
    """The port's seeded init gives the leaves the reference inits to
    constants the reference's values: every ``gate`` zero (0-dim, float32),
    every norm as a norm (llama's RMSNorm scales zero; seamless's
    LayerNorm scales one and biases zero, ``lnx`` and the encoder's norms
    included), QKV biases zero; and each glorot matrix within its limit."""
    import math

    import jax
    from repro.models import build_model as jbuild

    jcfg, tcfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    ref = convert.lm_params_from_reference(tcfg, tree, device="cpu")
    port = dict(tbuild(tcfg, device="cpu", generator=torch.Generator().manual_seed(1)).named_parameters())
    assert set(port) == set(ref)
    seen = set()
    for name, p in port.items():
        leaf = name.rsplit(".", 2)[-2:]
        if p.dim() < 2:
            assert p.dtype == torch.float32, name
            np.testing.assert_array_equal(p.numpy(), ref[name].numpy(), err_msg=name)
            seen.add(".".join(leaf) if leaf[0] in ("lnx", "final_norm") or leaf[1] == "gate" else leaf[1])
        elif name != "embed.table" and name != "lm_head.w":
            lim = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            assert 0.9 * lim < float(p.abs().max()) <= lim, name
    want = {"cross.gate", "scale", "final_norm.scale"}
    if arch.startswith("seamless"):
        want |= {"bias", "final_norm.bias", "lnx.scale", "lnx.bias", "bq", "bk", "bv"}
        assert float(port["layers.1.lnx.scale"].min()) == 1.0
        assert float(port["encoder.final_norm.scale"].min()) == 1.0
        assert float(port["encoder.layers.0.ln1.scale"].min()) == 1.0
    assert seen == want


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip_smoke(arch):
    """Every reference leaf (the encoder's stack and norm, the gates and
    ``lnx`` included) maps to exactly one port parameter of the same
    values, and back."""
    jcfg, tcfg = _cfgs(arch)
    _, tree = _reference(jcfg)
    named = dict(_port(tcfg, tree).named_parameters())
    leaves = convert._flatten(tree)
    seen = set()
    for name, path, r in convert.lm_layout(tcfg, tree):
        leaf = leaves[path] if r is None else leaves[path][r]
        assert (path, r) not in seen
        seen.add((path, r))
        np.testing.assert_array_equal(named[name].numpy(), leaf)
    stacked = ("groups.", "encoder.stack.")
    assert len(seen) == len(named) == sum(
        leaves[p].shape[0] if p.startswith(stacked) else 1 for p in leaves
    )
    if arch.startswith("seamless"):
        assert {n.split(".")[0] for n in named} == {"embed", "layers", "final_norm", "lm_head", "encoder"}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_without_its_context_raises(arch):
    """An LM with a context refuses a prefill without one, or with one of
    another width than ``ctx_len`` rows of ``d_model`` (the reference runs
    a "vlm" LM's C layers as a self-attention over the tokens then)."""
    tcfg = tget(arch, smoke=True)
    lm = tbuild(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    assert lm.ctx_len == 16
    for ctx in (None, torch.zeros((1, lm.ctx_len - 1, tcfg.d_model)), torch.zeros((1, lm.ctx_len, 8))):
        with pytest.raises(ValueError, match="takes a context"):
            lm.prefill(tokens, max_len=8, context=ctx)
    logits, _ = lm.prefill(tokens, max_len=8, context=torch.zeros((1, lm.ctx_len, tcfg.d_model)))
    assert logits.shape == (1, tcfg.vocab_size)
