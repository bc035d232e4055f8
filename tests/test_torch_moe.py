"""Port parity: the GShard MoE layer (``layers/moe.py``) and the "M" block
against the reference, on the CPU in float32.

The same numpy inputs go through the reference's ``repro.layers.moe`` and
the port's. ``_topk_dispatch`` must give the reference's dispatch and
combine bit for bit: on the reference's own property grid (seeds 0-4,
top_k 1/2/4, E 4/8), and on inputs that reach its edges: a capacity small
enough that tokens overflow and are dropped, all-equal rows (ties go to
the lowest expert), and the zero-padded rows of a partial group, whose
router probabilities are uniform. ``apply_moe``'s output and aux loss, and
a whole "M" block in prefill and decode (with and without arctic's dense
residual), agree within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import blocks as tblocks  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402

ATOL = 1e-5


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _softmax(logits: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


def _same_dispatch(probs: np.ndarray, top_k: int, cap: int):
    """Both packages' dispatch and combine on ``probs``, held bit for bit;
    returns the port's."""
    import jax.numpy as jnp
    from repro.layers import moe as jmoe

    dj, cj = jmoe._topk_dispatch(jnp.asarray(probs), top_k, cap)
    dt, ct = tmoe._topk_dispatch(torch.from_numpy(probs.copy()), top_k, cap)
    assert dt.dtype == ct.dtype == torch.float32
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(ct.numpy().view(np.uint32), np.asarray(cj).view(np.uint32))
    return dt.numpy(), ct.numpy()


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("num_experts", [4, 8])
def test_topk_dispatch_bitwise_on_the_reference_grid(seed, top_k, num_experts):
    """The reference's ``test_moe_dispatch_properties`` inputs, and its
    properties on the port's output."""
    rng = np.random.default_rng(seed)
    g, s = 2, 16
    probs = _softmax(rng.normal(size=(g, s, num_experts)))
    cap = max(int(s * top_k / num_experts * 1.25 + 0.5), top_k)
    d, c = _same_dispatch(probs, top_k, cap)
    assert (d.sum(axis=1) <= 1 + 1e-6).all()
    assert (d.sum(axis=(2, 3)) <= top_k + 1e-6).all()
    assert (c.sum(axis=(2, 3)) <= 1 + 1e-5).all()
    assert ((c > 0) <= (d > 0)).all()


@pytest.mark.parametrize("case", ("overflow", "all_equal", "pad_rows", "one_hot_router"))
def test_topk_dispatch_bitwise_at_its_edges(case):
    """``overflow``: 24 tokens, 4 experts, top-2, capacity 3: most picks
    land past the capacity and are dropped (a zero slot row, not a clamped
    one); ``all_equal``: every row uniform, so each pick is the lowest
    expert left; ``pad_rows``: a group whose last 9 rows are the zero pad,
    routed from zero router logits; ``one_hot_router``: rows that put all
    their weight on one expert, whose later picks are ties at zero."""
    rng = np.random.default_rng(11)
    e, top_k, cap = 4, 2, 3
    if case == "overflow":
        probs = _softmax(rng.normal(size=(2, 24, e)) * 3)
    elif case == "all_equal":
        probs = _softmax(np.zeros((2, 16, e)))
    elif case == "pad_rows":
        logits = rng.normal(size=(1, 16, e))
        logits[:, 7:] = 0.0
        probs, cap = _softmax(logits), 8
    else:
        probs = np.zeros((1, 12, e), np.float32)
        probs[0, np.arange(12), rng.integers(0, e, 12)] = 1.0
    d, _ = _same_dispatch(probs.astype(np.float32), top_k, cap)
    picks = d.sum(axis=(2, 3))
    if case == "overflow":
        assert (picks < top_k).any() and (d.sum(axis=1) <= 1).all()
    if case == "all_equal":
        kept = d.sum(axis=3)  # (G, S, E): experts 0 and 1 until they fill
        assert (kept[:, :cap, :2] == 1).all() and (kept[..., 2:] == 0).all()


def _moe_cfgs(arch, **over):
    from repro.configs import get_config as jget

    j, t = jget(arch, smoke=True), tget(arch, smoke=True)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _moe_params(tcfg, rng):
    """Unit-scale weights (normal / sqrt(fan-in) of each product, so y is
    O(1)) and a router whose logits spread by about 2.4."""
    shapes = tmoe.moe_shapes(tcfg)
    return {part: {n: (rng.normal(size=s) * (0.3 if part == "router" else s[-2] ** -0.5)).astype(np.float32)
                   for n, s in leaves.items()}
            for part, leaves in shapes.items()}


@pytest.mark.parametrize("arch", ("olmoe_1b_7b", "arctic_480b"))
@pytest.mark.parametrize("bs", ((2, 16), (3, 13), (1, 5)))
def test_apply_moe_matches_reference(arch, bs):
    """y and the aux loss within 1e-5: B·S = 32 (one whole group of 32),
    39 (a group and a padded one) and 5 (one group of 5)."""
    import jax
    from repro.layers import moe as jmoe

    jcfg, tcfg = _moe_cfgs(arch)
    rng = np.random.default_rng(21)
    p = _moe_params(tcfg, rng)
    x = rng.normal(size=bs + (tcfg.d_model,)).astype(np.float32)
    yj, aj = jax.jit(lambda p, x: jmoe.apply_moe(jcfg, p, x))(p, x)
    yt, at = tmoe.apply_moe(tcfg, _t(p), torch.from_numpy(x))
    assert yt.shape == x.shape and yt.dtype == torch.float32 and at.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(at), float(aj), atol=ATOL, rtol=0)


def test_capacity_is_the_reference_expression():
    _, tcfg = _moe_cfgs("olmoe_1b_7b")
    for name, sg, want in (("olmoe_1b_7b", 512, 80), ("olmoe_1b_7b", 4, 8), ("arctic_480b", 512, 10),
                           ("arctic_480b", 4, 2)):
        m = tget(name).moe
        assert tmoe.capacity(tget(name), sg) == max(int(sg * m.top_k / m.num_experts * m.capacity_factor + 0.5),
                                                    m.top_k) == want
    assert tmoe.capacity(tcfg, 32) == 20  # smoke: 8 experts, top-4


@pytest.mark.parametrize("arch", ("olmoe_1b_7b", "arctic_480b"))
def test_m_block_matches_reference(arch):
    """One "M" block (arctic's with its dense residual MLP): prefill of 20
    tokens with the emitted K/V, then a decode step at 20 from that cache,
    within 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.layers import blocks as jblocks

    jcfg, tcfg = _moe_cfgs(arch)
    p = jax.tree.map(np.asarray, jblocks.init_block(jax.random.PRNGKey(3), jcfg, "M"))
    p["ln2"]["scale"] = np.random.default_rng(4).normal(size=p["ln2"]["scale"].shape).astype(np.float32)
    assert ("mlp" in p) == (arch == "arctic_480b")
    assert jax.tree.map(np.shape, p) == jax.tree.map(tuple, tblocks.block_shapes(tcfg, "M"),
                                                     is_leaf=lambda t: isinstance(t, tuple))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 20, tcfg.d_model)).astype(np.float32)
    pos = np.arange(20)
    xj, aj, cj = jax.jit(lambda p, x: jblocks.apply_block_train(jcfg, "M", p, x, jnp.asarray(pos), emit_cache=True))(
        p, x)
    xt, at, ct = tblocks.apply_block_train(tcfg, "M", _t(p), torch.from_numpy(x), torch.from_numpy(pos),
                                           emit_cache=True)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(at), float(aj), atol=ATOL, rtol=ATOL)  # the block's aux loss
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), atol=ATOL, rtol=0)
    pad = ((0, 0), (0, 4), (0, 0), (0, 0))
    kj, vj = (jnp.pad(c, pad) for c in (cj.k, cj.v))
    kt, vt = (torch.from_numpy(np.pad(np.asarray(c), pad)) for c in (cj.k, cj.v))
    x1 = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    oj, _ = jax.jit(lambda p, x, c: jblocks.apply_block_decode(jcfg, "M", p, x, 20, c))(p, x1, tattn.KVCache(kj, vj))
    ot, _ = tblocks.apply_block_decode(tcfg, "M", _t(p), torch.from_numpy(x1), 20, tattn.KVCache(kt, vt))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=0)
    c = tblocks.init_block_cache(tcfg, "M", 2, 24, "cpu")
    assert tuple(c.k.shape) == (2, 24, tcfg.num_kv_heads, tcfg.hd)


def test_m_block_attention_prunes_as_a_global_layer(monkeypatch):
    """An "M" block's decode attention runs as kind "A", so a config with
    ``attn_prune_k`` below the cache width takes ADE's pruned branch there."""
    _, tcfg = _moe_cfgs("olmoe_1b_7b", attn_prune_k=4)
    calls = []
    real = tattn.topk_decode_attention

    def record(*args):
        calls.append(args[4])
        return real(*args)

    monkeypatch.setattr(tattn, "topk_decode_attention", record)
    rng = np.random.default_rng(6)
    p = {part: {n: torch.from_numpy((rng.normal(size=s) * 0.2).astype(np.float32)) for n, s in leaves.items()}
         for part, leaves in tblocks.block_shapes(tcfg, "M").items() if part != "moe"}
    p["moe"] = _t(_moe_params(tcfg, rng))
    cache = tblocks.init_block_cache(tcfg, "M", 2, 16, "cpu")
    tblocks.apply_block_decode(tcfg, "M", p, torch.from_numpy(rng.normal(size=(2, 1, 64)).astype(np.float32)),
                               9, cache)
    assert calls == [4]


def test_router_runs_in_float32(monkeypatch):
    """In bfloat16 the router still routes in float32, as the reference's
    does: the probabilities handed to ``_topk_dispatch`` are float32 and
    within float32 rounding of the reference's, the dispatch equal; the LM
    keeps its router weights float32 among bfloat16 expert copies."""
    import jax.numpy as jnp
    from repro.layers import moe as jmoe
    from repro_torch.models import build_model

    jcfg, tcfg = _moe_cfgs("olmoe_1b_7b", dtype="bfloat16")
    rng = np.random.default_rng(31)
    p = _moe_params(tcfg, rng)
    x = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
    seen = {}

    def spy(name, real):
        def record(probs, top_k, cap):
            d, c = real(probs, top_k, cap)
            seen[name] = (np.asarray(probs), np.asarray(d))
            return d, c
        return record

    monkeypatch.setattr(jmoe, "_topk_dispatch", spy("reference", jmoe._topk_dispatch))
    monkeypatch.setattr(tmoe, "_topk_dispatch", spy("port", tmoe._topk_dispatch))
    jmoe.apply_moe(jcfg, p, jnp.asarray(x, jnp.bfloat16))
    tmoe.apply_moe(tcfg, _t(p), torch.from_numpy(x).to(torch.bfloat16))
    (pj, dj), (pt, dt) = seen["reference"], seen["port"]
    assert pt.dtype == pj.dtype == np.float32
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(dt, dj)
    cp = build_model(tcfg, device="cpu").compute_params()["layers"][0]["moe"]
    assert cp["router"]["w"].dtype == torch.float32 and cp["experts"]["wi"].dtype == torch.bfloat16
