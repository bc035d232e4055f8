"""Port parity: LM training math against the reference (float32, smoke
configs, the same numpy-seeded inputs through both packages; the port's
weights come from the reference's through ``convert.lm_params_from_reference``).

  * The flash backward (``layers/flash.py``'s ``Flash``) against
    ``jax.grad`` of the reference's ``flash_attention``: causal, window 12,
    non-causal over a 19-row context, GQA at 2 and 3 q-heads a kv-head, a
    padded S; 5e-5, the reference's own tolerance (``tests/test_attention.py``).
  * ``LM.forward_train`` and ``LM.loss_fn`` of every arch of the registry
    against the reference's are in ``tests/test_torch_lm_train_dense.py``
    (dense and MoE) and ``tests/test_torch_lm_train_families.py``
    (recurrent and cross-attention), through ``tests/torch_lm_parity.py``.
  * ``remat`` on and off give equal gradients; prefill's last logits equal
    ``forward_train``'s (the aux loss changes no output).
  * ``make_train_step`` at ``grad_accum`` 1 and 2 under AdamW and Adafactor:
    loss, parameters and optimizer state after a step from the init and
    after a second step from the reference's state
    (``convert.opt_state_from_reference``), 1e-5.
  * Adafactor's ``update`` on 1-D, 2-D and (E, d, f) leaves and on stacked
    leaves against the reference's (1e-6), and the reference's quadratic
    convergence test.
  * Repair: serving an ``LM`` after its weights moved (``load_params``, an
    in-place write through a parameter) reads the new weights.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as P  # noqa: E402
# autouse fixtures of every module that imports them
from torch_lm_parity import end_leaked_serve_threads, one_intra_op_thread  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.layers import flash as tflash  # noqa: E402
from repro_torch.models.lm import LM, build_model, cache_tensors, layer_stacks  # noqa: E402
from repro_torch.optim import adafactor as tadafactor  # noqa: E402

ATOL = P.ATOL


# ------------------------------------------------------------- flash backward
def _graph_nodes(fn) -> set:
    """The names of the autograd nodes reachable from ``fn``."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or type(f).__name__ in seen:
            continue
        seen.add(type(f).__name__)
        todo.extend(nxt for nxt, _ in f.next_functions)
    return seen


FLASH_CFG = types.SimpleNamespace(attn_chunk_q=16, attn_chunk_kv=16)
FLASH_CASES = {
    # name: (b, sq, skv, h, hkv, hd, causal, window)
    "causal": (2, 40, 40, 4, 2, 8, True, None),
    "window12": (2, 40, 40, 4, 2, 8, True, 12),
    "cross19": (1, 16, 19, 4, 2, 8, False, None),
    "gqa3": (1, 32, 32, 6, 2, 8, True, None),
    "padded": (2, 37, 37, 4, 1, 8, True, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_reference(case):
    """dq, dk, dv of a weighted sum of the flash output: the port's
    ``Flash`` against ``jax.grad`` through the reference's custom VJP,
    within 5e-5; the forward within 2e-5."""
    from repro.configs.base import ModelConfig
    from repro.layers.flash import flash_attention as jflash

    b, sq, skv, h, hkv, hd, causal, window = FLASH_CASES[case]
    jcfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=32, num_heads=h, num_kv_heads=hkv,
                       d_ff=64, vocab_size=64, dtype="float32", attn_chunk_q=16, attn_chunk_kv=16)
    rng = np.random.default_rng(sq * 7 + h)
    q, k, v = (rng.normal(size=(b, n, hh, hd)).astype(np.float32) for n, hh in ((sq, h), (skv, hkv), (skv, hkv)))
    w = rng.normal(size=(hd,)).astype(np.float32)

    def jloss(q, k, v):
        return (jflash(jcfg, q, k, v, causal=causal, window=window) * w).sum()

    want = P.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tflash.flash_attention(FLASH_CFG, tq, tk, tv, causal=causal, window=window)
    assert "FlashBackward" in _graph_nodes(out.grad_fn)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for name, g, wnt in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=5e-5, rtol=0, err_msg=f"d{name}")
    fwd = jflash(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(fwd), atol=2e-5, rtol=0)
    with torch.no_grad():  # prefill's path keeps no residuals and gives the same bits
        plain = tflash.flash_attention(FLASH_CFG, tq, tk, tv, causal=causal, window=window)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_flash_saves_no_probability_block():
    """What the autograd graph keeps of a flash call is (q, k, v, out, m,
    l), O(S·d): no (chunk_q, chunk_kv) probability block."""
    s, h, hd = 64, 4, 8
    q, k, v = (torch.randn(1, s, h, hd, requires_grad=True) for _ in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = tflash.flash_attention(FLASH_CFG, q, k, v)
    nq = s // 16
    assert sorted(saved) == sorted([(1, s, h, hd)] * 4 + [(nq, 1, h, 1, 16)] * 2), saved
    out.sum().backward()


# ------------------------------------------------------ forward_train, loss_fn
def test_remat_gives_equal_gradients():
    """``remat`` recomputes each cycle repeat in the backward: loss and
    gradients bit for bit those without it (``torch_lm_parity.check_remat``)."""
    P.check_remat("qwen2_1_5b")


def test_label_pick_equals_masked_sum_and_keeps_no_logits():
    """``loss_fn``'s label pick (``lm._Pick``) gives the reference's masked
    sum over the vocabulary bit for bit, value and gradient, and its graph
    keeps only the labels, no (B, S, V) tensor."""
    from repro_torch.models.lm import _Pick

    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(2, 9, 33)).astype(np.float32) * 30)
    labels = torch.from_numpy(rng.integers(0, 33, (2, 9)))
    g = torch.from_numpy(rng.normal(size=(2, 9)).astype(np.float32))
    x = logits.clone().requires_grad_()
    iota = torch.arange(33)
    want = torch.sum(torch.where(iota == labels[..., None], x, 0.0), dim=-1)
    (want_grad,) = torch.autograd.grad(want, x, g)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        got = _Pick.apply(x, labels)
    (got_grad,) = torch.autograd.grad(got, x, g)
    assert torch.equal(got, want.detach()) and torch.equal(got_grad, want_grad)
    assert saved == [(2, 9)]


def test_moe_prefill_equal_train_forward():
    """olmoe's prefill logits equal forward_train's last row: the aux loss
    that forward_train now returns changes no output."""
    jcfg, tcfg = P.cfgs("olmoe_1b_7b")
    _, tree = P.reference(jcfg, tcfg)
    params = convert.lm_params_from_reference(tcfg, tree, device="cpu")
    lm = build_model(tcfg, device="cpu", params=params)
    toks = torch.from_numpy(P.make_batch(tcfg)["tokens"])
    logits, aux = lm.forward_train(params, toks)
    last, _ = lm.prefill(toks, max_len=32)
    assert float(aux) > 0
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), atol=1e-6, rtol=0)


# ------------------------------------------------------------ make_train_step
def _state_leaves(cfg, state):
    """An optimizer state as name -> tensor (``opt.step`` apart)."""
    from repro_torch.checkpoint import flatten_train_state

    flat = flatten_train_state({}, state)
    flat.pop("opt.step")
    return flat


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
@pytest.mark.parametrize("accum", (1, 2))
def test_train_step_matches_reference(optimizer, accum):
    """One ``make_train_step`` step from the init, then a second from the
    reference's state after its first (through ``opt_state_from_reference``):
    loss, parameters and optimizer state within 1e-5 (state leaves of their
    largest magnitude), batch 4 in ``accum`` microbatches."""
    from repro.launch import steps as jsteps

    jcfg, tcfg = P.cfgs("qwen2_1_5b", optimizer=optimizer, grad_accum=accum)
    jm, tree = P.reference(jcfg, tcfg)
    jopt = jsteps.make_optimizer(jcfg)
    jstep = P.jit(jsteps.make_train_step(jcfg))
    tstep = tsteps.make_train_step(tcfg)
    topt = tsteps.make_optimizer(tcfg)
    jparams, jstate = jax.tree.map(jnp.asarray, tree), jopt.init(jax.tree.map(jnp.asarray, tree))
    params = convert.lm_params_from_reference(tcfg, tree, device="cpu")
    state = topt.init(params)
    for step in range(2):
        batch = P.make_batch(tcfg, b=4, s=16, seed=10 + step)
        jparams, jstate, jloss = jstep(jparams, jstate, P.as_jax(batch))
        inputs = params
        before = {n: p.clone() for n, p in inputs.items()}
        params, state, loss = tstep(params, state, P.as_torch(batch))
        assert all(torch.equal(before[n], p) for n, p in inputs.items())  # the step wrote no input
        np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
        prev = jax.tree.map(np.asarray, jparams)
        want = convert.lm_params_from_reference(tcfg, prev, device="cpu")
        for n, p in params.items():
            np.testing.assert_allclose(p.numpy(), want[n].numpy(), atol=ATOL, rtol=0, err_msg=n)
        jconv = convert.opt_state_from_reference(tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
        assert int(state.step) == int(jconv.step) == step + 1
        P.assert_leaves(_state_leaves(tcfg, state), _state_leaves(tcfg, jconv), ATOL, "state")
        # continue from the reference's own parameters and state
        params, state = want, jconv


# ------------------------------------------------------------------ Adafactor
def _leaf(rng, shape, scale=1.0):
    return np.asarray(rng.normal(size=shape) * scale, dtype=np.float32)


@pytest.mark.parametrize("shape", ((7,), (12, 5), (3, 6, 4), ()))
def test_adafactor_leaf_matches_reference(shape):
    """Four updates of one leaf (1-D and 0-d full, 2-D and (E, d, f)
    factored) against the reference's Adafactor, 1e-6; the slots' shapes
    are the reference's."""
    from repro.optim import adafactor as jadafactor

    rng = np.random.default_rng(len(shape))
    p = _leaf(rng, shape)
    jopt, topt = jadafactor(lr=0.05), tadafactor(lr=0.05)
    jp, js = {"w": jnp.asarray(p)}, None
    js = jopt.init(jp)
    tp = {"w": torch.from_numpy(p)}
    ts = topt.init(tp)
    for _ in range(4):
        g = _leaf(rng, shape, 0.3)
        jp, js = jopt.update({"w": jnp.asarray(g)}, js, jp)
        tp, ts = topt.update({"w": torch.from_numpy(g)}, ts, tp)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), atol=1e-6, rtol=0)
        for part in ("row", "col", "full"):
            a, b = getattr(ts.slots["w"], part), getattr(js.slots["w"], part)
            assert (a is None) == (b is None), part
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6, err_msg=part)
    if len(shape) == 3:
        assert ts.slots["w"].row.shape == (3, 6) and ts.slots["w"].col.shape == (3, 4)


def test_adafactor_stacks_match_reference_stacked_leaf():
    """Layers the reference stacks into one leaf update as that leaf: a
    stacked matrix (one RMS clip over the group) and a stacked vector
    (factored, its columns shared), 1e-6 over four updates."""
    from repro.optim import adafactor as jadafactor

    rng = np.random.default_rng(5)
    shapes = {"m": (4, 6), "v": (5,), "s": ()}
    n = 3
    p = {k: _leaf(rng, (n,) + s) for k, s in shapes.items()}
    jopt = jadafactor(lr=0.05)
    topt = tadafactor(lr=0.05, stacks=[[f"{k}.{r}" for r in range(n)] for k in shapes])
    jp, tp = {k: jnp.asarray(a) for k, a in p.items()}, {f"{k}.{r}": torch.tensor(a[r])
                                                          for k, a in p.items() for r in range(n)}
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.slots["v.1"].row.shape == () and ts.slots["v.1"].col.shape == (5,) and ts.slots["s.0"].full.shape == ()
    for _ in range(4):
        g = {k: _leaf(rng, a.shape, 3.0) for k, a in p.items()}  # large enough that the clip acts
        jp, js = jopt.update({k: jnp.asarray(a) for k, a in g.items()}, js, jp)
        tp, ts = topt.update({f"{k}.{r}": torch.tensor(a[r]) for k, a in g.items() for r in range(n)},
                             ts, tp)
        for k in shapes:
            got = torch.stack([tp[f"{k}.{r}"] for r in range(n)]).numpy()
            np.testing.assert_allclose(got, np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)


def test_adafactor_converges_quadratic():
    """The reference's ``test_adafactor_converges_quadratic`` on the port."""
    opt = tadafactor(lr=0.3)
    params = {"w": torch.zeros((4, 4)), "v": torch.zeros((7,))}
    state = opt.init(params)

    def loss(p):
        return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["v"] - 1.0) ** 2)

    for _ in range(300):
        leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss(leaves), list(leaves.values()))))
        params, state = opt.update(grads, state, params)
    assert float(loss(params)) < 5e-2


def test_layer_stacks_follow_reference_groups():
    """``layer_stacks`` groups the port's names as the reference stacks its
    leaves: per group, cycle position and leaf over the repeats, the
    encoder's over its layers."""
    cfg = dataclasses.replace(tget("recurrentgemma_2b", smoke=True), num_layers=7)  # R R L twice, then R
    assert cfg.layer_groups() == [(("R", "R", "L"), 2), (("R",), 1)]
    stacks = layer_stacks(cfg)
    assert ["layers.0.lru.wa", "layers.3.lru.wa"] in stacks and ["layers.2.attn.wq", "layers.5.attn.wq"] in stacks
    assert ["layers.6.lru.wa"] in stacks and ["layers.1.ln1.scale", "layers.4.ln1.scale"] in stacks
    names = [n for n, _ in LM(cfg, device="meta").named_parameters() if n.startswith("layers.")]
    assert sorted(n for s in stacks for n in s) == sorted(names)
    enc = layer_stacks(tget("seamless_m4t_medium", smoke=True))
    assert ["encoder.layers.0.attn.wq", "encoder.layers.1.attn.wq"] in enc


# ----------------------------------------------------------------- repair (a)
def test_serving_reads_weights_after_training():
    """Repair of ``compute_params``' stale copies: an LM whose weights moved
    after it served (a train step's parameters through ``load_params``; a
    write through a parameter in place, here with bfloat16 compute so the
    served copies are casts) serves the new weights, as a fresh LM does."""
    _, tcfg = P.cfgs("qwen2_1_5b")
    lm = build_model(tcfg, device="cpu")
    toks = torch.from_numpy(P.make_batch(tcfg)["tokens"])
    before, _ = lm.prefill(toks, max_len=32)
    params = {n: p.detach() for n, p in lm.named_parameters()}
    opt = tsteps.make_optimizer(tcfg)
    step = tsteps.make_train_step(dataclasses.replace(tcfg, grad_accum=1))
    batch = P.as_torch(P.make_batch(tcfg))
    new, _, _ = step(params, opt.init(params), batch)
    lm.load_params(new)
    after, _ = lm.prefill(toks, max_len=32)
    fresh, _ = build_model(tcfg, device="cpu", params=new).prefill(toks, max_len=32)
    assert not torch.equal(after, before) and torch.equal(after, fresh)

    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    lm = build_model(bf, device="cpu", params=params)
    lm.prefill(toks, max_len=32)
    with torch.no_grad():
        for n, p in lm.named_parameters():
            p.copy_(new[n])
    after, _ = lm.prefill(toks, max_len=32)
    fresh, _ = build_model(bf, device="cpu", params=new).prefill(toks, max_len=32)
    assert torch.equal(after, fresh)
    step = lm.compile_decode(lm.init_cache(2, 32))  # a compiled step reads the model's weights at each call
    assert step(toks[:, :1], 0).shape == (2, tcfg.vocab_size)


# ------------------------------------------------------------- launch/steps
@pytest.mark.parametrize("arch", ("gemma3_4b", "seamless_m4t_medium"))
def test_specs_match_reference(arch):
    """``input_specs`` / ``cache_specs`` / ``state_specs`` on ``meta``
    against the reference's ``ShapeDtypeStruct`` trees: every input's shape,
    every parameter's shape (through ``convert.lm_layout``) and every
    optimizer slot's, the decode cache's per-layer shapes (the reference's
    stacked over each group's repeats); ``cell_supported`` and
    ``smoke_shape`` as the reference's."""
    from repro.launch import steps as jsteps

    jcfg, tcfg = P.cfgs(arch, optimizer="adafactor")
    for name, shape in tsteps.SHAPES.items():
        jshape = jsteps.SHAPES[name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert tsteps.cell_supported(tcfg, shape) == jsteps.cell_supported(jcfg, jshape)
        assert tsteps.smoke_shape(shape) == tsteps.ShapeSpec(*dataclasses.astuple(jsteps.smoke_shape(jshape)))
        small = tsteps.smoke_shape(shape)
        got = tsteps.input_specs(tcfg, small)
        want = jsteps.input_specs(jcfg, jsteps.smoke_shape(jshape))
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    params, state = tsteps.state_specs(tcfg, with_opt=True)
    jparams, jstate = jsteps.state_specs(jcfg, with_opt=True)
    layout = list(convert.lm_layout(tcfg, jparams))
    flat = convert._flatten(jparams)
    want = {n: tuple(flat[path].shape[(0 if r is None else 1):]) for n, path, r in layout}
    assert {n: tuple(p.shape) for n, p in params.items()} == want
    slots = convert._flatten(jstate.slots, "", lambda t: hasattr(t, "_fields"))
    for n, path, r in layout:
        ref = slots[path]
        for part in ("row", "col", "full"):
            mine, theirs = getattr(state.slots[n], part), getattr(ref, part)
            assert (mine is None) == (theirs is None), (n, part)
            if mine is not None:
                shape = tuple(theirs.shape) if r is None or (part == "col" and len(ref.row.shape) == 1) \
                    else tuple(theirs.shape[1:])
                assert tuple(mine.shape) == shape, (n, part)
    shape = tsteps.ShapeSpec("d", "decode", 24, 2)
    cache = tsteps.cache_specs(tcfg, shape)
    assert all(t.device.type == "meta" for t in cache_tensors(cache))
    jcache = jsteps.cache_specs(jcfg, jsteps.ShapeSpec("d", "decode", 24, 2))
    assert len(cache) == tcfg.num_layers and len(jcache) == len(tcfg.layer_groups())


def test_prefill_and_decode_steps_match_the_lm():
    """``make_prefill_step`` / ``make_decode_step`` on flat parameters give
    the ``LM``'s own prefill and decode logits bit for bit."""
    _, tcfg = P.cfgs("qwen2_1_5b")
    lm = build_model(tcfg, device="cpu")
    params = {n: p.detach() for n, p in lm.named_parameters()}
    shape = tsteps.ShapeSpec("p", "prefill", 20, 2)
    toks = torch.from_numpy(P.make_batch(tcfg, s=12)["tokens"])
    got, cache = tsteps.make_prefill_step(tcfg, shape)(params, {"tokens": toks})
    want, wcache = lm.prefill(toks, max_len=20)
    assert torch.equal(got, want)
    step = tsteps.make_decode_step(tcfg)
    tok = want.argmax(-1)[:, None]
    got, _ = step(params, tok, 12, cache)
    want, _ = lm.decode_step(tok, 12, wcache)
    assert torch.equal(got, want)
