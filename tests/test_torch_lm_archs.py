"""Port parity: the dense and MoE LM archs (qwen2-1.5b, qwen2-72b,
chatglm3-6b, olmoe-1b-7b, arctic-480b) against the reference. (Each
arch's config, its full parameter layout and the serving CLI are held in
``test_torch_lm.py``, with gemma3-4b's.)

On the CPU, each ``smoke()`` LM gets the reference's own parameters
(converted with ``convert.lm_params_from_reference``), with the QKV
biases, norm scales, expert weights and router redrawn so that each of
them moves the output and routing spreads over the experts (the reference
inits biases and scales at zero, and its expert glorot takes E as the
fan-in, which makes the experts' output tiny); the reference's
zero-initialised parameters would leave the bias add and the expert
products unchecked. Prefill and 8 decode steps, eager and through
``compile_decode``, agree with the reference's ``LM`` within 1e-4 in
float32, the reference's own decode tolerance. The same runs in bfloat16
give the reference's greedy tokens, which holds the bias cast to the
compute dtype. With ``param_dtype="bfloat16"`` (qwen2-72b's and
arctic-480b's published setting) the reference keeps only the embedding
and the head in bfloat16; the port's run agrees within 1e-4 in float32
and routes every token as the reference does, which holds the float32
norm scales, biases and router.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402

ARCHS = ("qwen2_1_5b", "qwen2_72b", "chatglm3_6b", "olmoe_1b_7b", "arctic_480b")
ATOL_LOGITS = 1e-4


def _cfgs(arch, **over):
    from repro.configs import get_config as jget

    j, t = jget(arch, smoke=True), tget(arch, smoke=True)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _redraw(tree, rng, path=()):
    """The reference's numpy tree with biases, norm scales and expert
    weights redrawn (see the module docstring)."""
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_redraw(v, rng, path + (i,)) for i, v in enumerate(tree))
    name = path[-1]
    if name in ("bq", "bk", "bv", "scale"):
        return (rng.normal(size=tree.shape) * 0.3).astype(np.float32)
    if "experts" in path:
        return (rng.normal(size=tree.shape) * tree.shape[-2] ** -0.5).astype(np.float32)
    if "router" in path:  # logits spread by about 2.4 on a normed input
        return (rng.normal(size=tree.shape) * 2.4 * tree.shape[-2] ** -0.5).astype(np.float32)
    return tree


def _reference(jcfg, seed=0):
    import jax
    from repro.models import build_model as jbuild

    model = jbuild(jcfg)
    tree = _redraw(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed))), np.random.default_rng(seed))
    return model, tree


def _runs(jcfg, tcfg, b=2, t=24, gen=8, seed=5):
    """Logits of the reference and of the port (eager, then compiled) over
    a prefill of ``t`` tokens and ``gen`` decode steps, teacher-forced on
    one seeded token stream."""
    import jax
    import jax.numpy as jnp

    jm, tree = _reference(jcfg)
    tm = tbuild(tcfg, device="cpu", params=convert.lm_params_from_reference(tcfg, tree, device="cpu"))
    toks = np.random.default_rng(seed).integers(0, tcfg.vocab_size, size=(b, t + gen))
    prefill = jax.jit(jm.prefill, static_argnums=2)
    decode = jax.jit(jm.decode_step)
    lj, cj = prefill(tree, jnp.asarray(toks[:, :t]), t + gen)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :t]), max_len=t + gen)
    step = tm.compile_decode([tattn.KVCache(c.k.clone(), c.v.clone()) for c in ct])
    runs = {"reference": [np.asarray(lj.astype(jnp.float32))], "eager": [lt.float().numpy()]}
    runs["compiled"] = list(runs["eager"])
    for pos in range(t, t + gen):
        tok = toks[:, pos:pos + 1]
        lj, cj = decode(tree, jnp.asarray(tok), pos, cj)
        lt, ct = tm.decode_step(torch.from_numpy(tok), pos, ct)
        runs["reference"].append(np.asarray(lj.astype(jnp.float32)))
        runs["eager"].append(lt.float().numpy())
        runs["compiled"].append(step(torch.from_numpy(tok), torch.tensor(pos)).float().numpy())
    return runs


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_bfloat16_leaves_convert_exactly(dtype):
    """A reference tree with ``param_dtype="bfloat16"`` (qwen2-72b's and
    arctic-480b's published setting) holds bfloat16 numpy leaves only for
    the embedding and the untied head; they convert bit for bit. Norm
    scales, QKV biases and the router stay float32 leaves, and convert
    bit for bit into float32. A layer's weight matrices convert exactly in
    float32 compute, and round to bfloat16 as each of the reference's uses
    rounds them in bfloat16 compute. The LM's own parameters take the same
    dtypes."""
    import jax.numpy as jnp

    jcfg, tcfg = _cfgs("arctic_480b", param_dtype="bfloat16", dtype=dtype)
    _, tree = _reference(jcfg)
    leaves = convert._flatten(tree)
    bf16 = {p for p, leaf in leaves.items() if leaf.dtype.name == "bfloat16"}
    assert bf16 == {"embed.table", "lm_head.w"}
    port = convert.lm_params_from_reference(tcfg, tree, device="cpu")
    matrix = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jmatrix = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for name, path, r in convert.lm_layout(tcfg, tree):
        leaf = leaves[path] if r is None else leaves[path][r]
        if path in bf16 or leaf.ndim < 2 or name.endswith("router.w"):
            assert port[name].dtype == (torch.bfloat16 if path in bf16 else torch.float32), name
            np.testing.assert_array_equal(port[name].float().numpy(), leaf.astype(np.float32))
        else:
            assert port[name].dtype == matrix, name
            want = np.asarray(jnp.asarray(leaf).astype(jmatrix))
            np.testing.assert_array_equal(port[name].float().numpy(), want.astype(np.float32))
    assert port["layers.1.moe.router.w"].dtype == port["layers.1.ln2.scale"].dtype == torch.float32
    lm = tbuild(tcfg, device="cpu", params=port)
    assert {n: p.dtype for n, p in LM(tcfg, device="meta").named_parameters()} == {n: t.dtype for n, t in port.items()}
    assert all(p.dtype == port[n].dtype for n, p in lm.named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_reference(arch):
    """Prefill of 24 tokens at batch 2, then 8 decode steps at 24..31,
    eager and through the compiled step (eager on the CPU), within 1e-4 of
    the reference's logits. olmoe's and arctic's prefill routes 48 tokens
    in a group of 32 and a padded one; each decode step routes its 2 tokens
    as one group."""
    jcfg, tcfg = _cfgs(arch)
    runs = _runs(jcfg, tcfg)
    for i, want in enumerate(runs["reference"]):
        np.testing.assert_allclose(runs["eager"][i], want, atol=ATOL_LOGITS, rtol=0, err_msg=f"call {i}")
        np.testing.assert_array_equal(runs["compiled"][i], runs["eager"][i])


def _recorded_dispatch(monkeypatch):
    """Every dispatch tensor either package's ``_topk_dispatch`` returns,
    in call order: ``{"reference": [...], "port": [...]}`` (the
    reference's through an ordered callback, read after
    ``jax.effects_barrier()``)."""
    import jax
    from repro.layers import moe as jmoe
    from repro_torch.layers import moe as tmoe

    seen = {"reference": [], "port": []}
    jreal, treal = jmoe._topk_dispatch, tmoe._topk_dispatch

    def jrecord(probs, top_k, cap):
        d, c = jreal(probs, top_k, cap)
        jax.debug.callback(lambda v: seen["reference"].append(np.asarray(v)), d, ordered=True)
        return d, c

    def trecord(probs, top_k, cap):
        d, c = treal(probs, top_k, cap)
        seen["port"].append(d.numpy())
        return d, c

    monkeypatch.setattr(jmoe, "_topk_dispatch", jrecord)
    monkeypatch.setattr(tmoe, "_topk_dispatch", trecord)
    return seen


@pytest.mark.parametrize("arch", ("qwen2_72b", "arctic_480b"))
def test_lm_bfloat16_params_match_reference(arch, monkeypatch):
    """The smoke LM with ``param_dtype="bfloat16"``, computing in float32:
    the reference keeps its layers' weights, norm scales, biases and router
    in float32 (only the embedding and the head are bfloat16), so the
    port's prefill and 8 decode steps agree within 1e-4, and every arctic
    layer's dispatch (prefill, each eager and each compiled step) equals
    the reference's bit for bit. A bfloat16 router or norm scale moves the
    logits past the bound."""
    import jax

    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    seen = _recorded_dispatch(monkeypatch)
    runs = _runs(jcfg, tcfg)
    jax.effects_barrier()
    for i, want in enumerate(runs["reference"]):
        np.testing.assert_allclose(runs["eager"][i], want, atol=ATOL_LOGITS, rtol=0, err_msg=f"call {i}")
        np.testing.assert_array_equal(runs["compiled"][i], runs["eager"][i])
    ref, port = seen["reference"], seen["port"]
    n = tcfg.num_layers if tcfg.moe is not None else 0
    gen = len(runs["reference"]) - 1
    assert len(ref) == n * (1 + gen) and len(port) == n * (1 + 2 * gen)
    # the port's calls: prefill, then per step the eager one and the compiled one
    eager = port[:n] + [d for i in range(gen) for d in port[n + 2 * n * i:n + 2 * n * i + n]]
    compiled = [d for i in range(gen) for d in port[2 * n + 2 * n * i:2 * n + 2 * n * i + n]]
    for i, (got, want) in enumerate(zip(eager, ref)):
        np.testing.assert_array_equal(got, want, err_msg=f"dispatch {i}")
    for got, want in zip(compiled, eager[n:]):
        np.testing.assert_array_equal(got, want)
    if n:  # routing spreads: every expert takes tokens in the prefill
        assert (np.concatenate(ref[:n]).sum(axis=(0, 1, 3)) > 0).all()


@pytest.mark.parametrize("arch", ("qwen2_1_5b", "olmoe_1b_7b"))
def test_lm_bfloat16_greedy_tokens_match_reference(arch):
    """The same run in bfloat16 (float32 parameters): the greedy token of
    every (batch, call) row equals the reference's. An uncast float32 bias
    would promote q, k and v to float32, which changes qwen2's tokens; the
    router's float32 is held directly (``test_torch_moe.py``) and by
    ``test_lm_bfloat16_params_match_reference``."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    runs = _runs(jcfg, tcfg)
    for i, want in enumerate(runs["reference"]):
        assert np.array_equal(runs["eager"][i].argmax(-1), want.argmax(-1)), i
        assert np.array_equal(runs["compiled"][i], runs["eager"][i])


def test_qkv_bias_is_cast_to_the_compute_dtype():
    """In bfloat16, q/k/v stay bfloat16 with float32 biases, and equal the
    reference's."""
    import jax.numpy as jnp
    from repro.layers import attention as jattn

    jcfg, tcfg = _cfgs("qwen2_1_5b", dtype="bfloat16")
    rng = np.random.default_rng(9)
    p = {n: (rng.normal(size=s) * 0.3).astype(np.float32) for n, s in tattn.attention_shapes(tcfg).items()}
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    got = tattn._project_qkv(tcfg, {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x))
    want = jattn._project_qkv(jcfg, p, jnp.asarray(x), jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), atol=2 ** -6, rtol=2 ** -7)


def test_swiglu_matches_reference():
    from repro.layers import mlp as jmlp
    from repro_torch.layers import mlp as tmlp

    jcfg, tcfg = _cfgs("chatglm3_6b")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    p = {n: (rng.normal(size=s) * 0.2).astype(np.float32) for n, s in tmlp.mlp_shapes(tcfg).items()}
    want = jmlp.apply_mlp(jcfg, p, x)
    got = tmlp.apply_mlp(tcfg, {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ("qwen2_1_5b", "chatglm3_6b"))
def test_embedding_scaled_only_when_tied(arch):
    """Both packages scale a tied embedding by √d, qwen2-1.5b's included
    (the published Qwen2 does not scale: a fault of the reference, which the
    port follows), and leave an untied one as it is."""
    import jax.numpy as jnp

    jcfg, tcfg = _cfgs(arch)
    jm, tree = _reference(jcfg)
    tm = tbuild(tcfg, device="cpu", params=convert.lm_params_from_reference(tcfg, tree, device="cpu"))
    toks = np.array([[1, 2, 3]])
    table = tree["embed"]["table"][toks]
    scale = np.float32(tcfg.d_model ** 0.5) if tcfg.tie_embeddings else np.float32(1.0)
    got = tm._embed(tm.compute_params(), torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, table * scale)
    np.testing.assert_array_equal(np.asarray(jm._embed(tree, jnp.asarray(toks))), got)
    assert tcfg.tie_embeddings == (arch == "qwen2_1_5b")


def test_expert_glorot_takes_experts_as_fan_in():
    """Both inits draw an (E, d, f) expert tensor with limit sqrt(6 / (E +
    d·f)), E taken as the fan-in (a fault of the reference's ``glorot``,
    recorded and followed): 0.0017 for olmoe-1b-7b's experts, against 0.044
    for a (d, f) matrix. Checked at the smoke width (E 8, d 64, f 64)."""
    import jax
    from repro.layers import moe as jmoe

    jcfg, tcfg = _cfgs("olmoe_1b_7b")
    lim = (6.0 / (8 + 64 * 64)) ** 0.5
    tm = tbuild(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    for w in (tm.layers[0].moe.experts["wi"], jp["experts"]["wi"]):
        top = float(np.abs(np.asarray(w)).max())
        assert 0.95 * lim < top <= lim
    full = tget("olmoe_1b_7b")
    assert abs((6.0 / (64 + 2048 * 1024)) ** 0.5 - 0.0017) < 1e-4 and full.moe.num_experts == 64
