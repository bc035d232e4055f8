"""Port parity: parameters in another dtype than float32.

The reference computes a product of mixed operands in
``jnp.result_type`` of them (64-bit types off): float32 features against
bfloat16 weights compute in float32, two bfloat16 operands stay bfloat16,
a float64 parameter computes as float32. The port's HGNN path does the
same (``repro_torch.core.dtypes``). With every parameter in bfloat16,
float16 or float64 (values exact in float32), HAN, RGAT and Simple-HGN
give the reference's logits (1e-5) and ``accuracy`` under ``staged`` and
``fused_kernel`` (the plain versions on the CPU, which take θ_rel in
float32 as the CUDA kernels do).
"""
import gc
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dtypes  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402

SCALE = 0.04
DTYPES = ("bfloat16", "float16", "float64")
TASKS = (("han", "acm"), ("rgat", "imdb"), ("simple_hgn", "acm"))


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


@pytest.mark.parametrize("a", ("float32", "bfloat16", "float16", "float64"))
@pytest.mark.parametrize("b", ("float32", "bfloat16", "float16", "float64"))
def test_result_type_is_jax_default_mode(a, b):
    jnp = pytest.importorskip("jax.numpy")
    import warnings

    ta, tb = torch.zeros(2, 2, dtype=getattr(torch, a)), torch.zeros(2, 2, dtype=getattr(torch, b))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # float64 is truncated to float32
        want = jnp.result_type(jnp.zeros(2, getattr(jnp, a)), jnp.zeros(2, getattr(jnp, b)))
    got = dtypes.result_type(ta, tb)
    assert str(got).removeprefix("torch.") == str(want)
    assert dtypes.matmul(ta, tb).dtype == got
    assert dtypes.einsum("ij,jk->ik", ta, tb).dtype == got


@pytest.fixture(scope="module")
def tasks():
    """(model, dataset) -> (reference task, port task, reference params),
    built once; ``convert`` turns a reference tree into the port's float32
    mapping."""
    pytest.importorskip("jax")
    import jax

    from repro.core import pipeline as jpipe
    from repro_torch.convert import params_from_reference

    cache = {}

    def get(model, ds):
        if (model, ds) not in cache:
            jt = jpipe.prepare(model, ds, scale=SCALE, seed=0)
            tt = tpipe.prepare(model, ds, scale=SCALE, seed=0, device="cpu")
            cache[model, ds] = (jt, tt, jt.params)
        return cache[model, ds]

    get.convert = lambda tree, tt: params_from_reference(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu", model=tt.model
    )
    return get


@pytest.mark.parametrize("flow,k", (("staged", None), ("fused_kernel", 4)))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,ds", TASKS)
def test_param_dtype_matches_reference(tasks, model, ds, dtype, flow, k):
    import jax
    import jax.numpy as jnp

    from repro.core import pipeline as jpipe
    from repro.core.flows import FlowConfig as JFlowConfig

    jt, tt, jparams = tasks(model, ds)
    # the values: the reference's weights rounded to the narrower type, so
    # both packages hold exactly the same numbers (and float64 holds float32's)
    narrow = jnp.float32 if dtype == "float64" else getattr(jnp, dtype)
    jp = jax.tree_util.tree_map(lambda x: x.astype(narrow), jparams)
    f32 = tasks.convert(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp), tt)
    params = {n: p.to(getattr(torch, dtype)) for n, p in f32.items()}
    jflow, tflow = JFlowConfig(flow, prune_k=k), FlowConfig(flow, prune_k=k)
    want = np.asarray(jt.model.apply(jp, jt.batch, jflow))
    got = tt.compile(tflow, params=params)(params)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for split in ("test", "val"):
        # the same rows right: the two means of one count may round apart
        # by an ulp (float32 sum orders differ)
        n = len(tt.splits[split])
        got_acc = tpipe.accuracy(tt, params, tflow, split=split)
        want_acc = jpipe.accuracy(jt, jp, jflow, split=split)
        assert round(got_acc * n) == round(want_acc * n), (split, got_acc, want_acc)
        assert abs(got_acc - want_acc) <= 1e-7


def test_bf16_rel_scores_stay_bf16_and_reach_kernels_in_f32(tasks, monkeypatch):
    """Simple-HGN with bfloat16 parameters: θ_rel = rel_emb · a_rel is
    bfloat16 (two bfloat16 operands), as in the reference; the fused
    kernels' wrappers still get float32 (their checks are unchanged)."""
    import jax.numpy as jnp

    from repro_torch.core import attention
    from repro_torch.kernels.fused_prune_aggregate import ops

    _, tt, _ = tasks("simple_hgn", "acm")
    gen = torch.Generator().manual_seed(0)
    rel = torch.randn(5, 8, 4, generator=gen).to(torch.bfloat16)
    a = torch.randn(8, 4, generator=gen).to(torch.bfloat16)
    h, a_src, a_dst = (torch.randn(*s, generator=gen) for s in ((6, 8, 4), (8, 4), (8, 4)))
    sc = attention.decompose_scores(h, a_src, a_dst, rel_emb=rel, a_rel=a)
    assert sc.theta_src.dtype == torch.float32 and sc.theta_rel.dtype == torch.bfloat16
    want = jnp.einsum("rhd,hd->rh", jnp.asarray(rel.float().numpy(), jnp.bfloat16), jnp.asarray(a.float().numpy(), jnp.bfloat16))
    assert np.array_equal(sc.theta_rel.float().numpy(), np.asarray(want.astype(jnp.float32)))
    seen = []
    real = ops.prune_aggregate

    def spy(*args, **kw):
        seen.append(args[4].dtype)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "prune_aggregate", spy)
    params = {n: p.to(torch.bfloat16) for n, p in tt.params.items()}
    with torch.inference_mode():
        tt.model.apply(params, tt.batch, FlowConfig("fused_kernel", prune_k=4))
    assert seen and set(seen) == {torch.float32}
