"""The port's ``InferenceSession`` against the reference's session contracts
(``tests/test_session.py``), and its captured program on a card.

On the CPU, for HAN on ACM, RGAT on IMDB and Simple-HGN on DBLP (the
reference's session tasks and sizes):

  * ``session(params)`` is ``model.apply`` bit for bit, and within 1e-5 of
    the reference's ``task.compile(flow)(params)`` on the same converted
    weights, under ``staged``, ``fused`` and ``fused_kernel``;
  * ``batch`` equals separate calls; the task's cache is keyed on the flow
    and on the parameters' names, shapes and dtypes; ``query_capacities``
    is ascending; there is no ``cost_analysis()`` (a CUDA graph carries no
    compiler estimate); a session needs example params; a params mapping that
    differs from the session's program raises; a query id outside the rows
    raises ``IndexError`` before any forward, where the reference wraps or
    clamps it.

The ``cuda``-marked tests skip without a card. On one, a session is a
captured CUDA graph: its forward is the eager ``model.apply`` bit for bit
on the bucketed, per-bucket loop and flat routes; replays tick no
dispatch or launch counter; new params give the new weights' logits; an
earlier result is unchanged by a later call; a forward that cannot be
captured raises; out-of-range ids on the card raise before any launch. The LM's compiled decode step gives the eager loop's
tokens, logits and cache bit for bit.
"""
import gc
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import flows as tflows  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402
from repro_torch.core.session import InferenceSession  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ops as fpa_ops  # noqa: E402

TASKS = (("han", "acm"), ("rgat", "imdb"), ("simple_hgn", "dblp"))
SCALE, MAX_DEGREE = 0.04, 48  # the reference's session tests
FLOWS = (("staged", None), ("fused", 8), ("fused_kernel", 8))
ROUTES = ("bucketed", "loop", "flat")
ATOL = 1e-5


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


def _prepare(model, ds, device="cpu", route="bucketed"):
    kw = {"bucket_sizes": None} if route == "flat" else {}
    return tpipe.prepare(model, ds, scale=SCALE, max_degree=MAX_DEGREE, seed=0, device=device, **kw)


def _flow(flow="fused_kernel", k=8, route="bucketed"):
    return FlowConfig(flow, prune_k=k, bucket_dispatch="loop" if route == "loop" else "single")


def _scaled(params, factor):
    """Another weight version: every parameter times ``factor``."""
    return {n: t * factor for n, t in params.items()}


@pytest.fixture(scope="module")
def port_tasks():
    return {key: _prepare(*key) for key in TASKS}


@pytest.fixture(scope="module")
def ref_tasks():
    pytest.importorskip("jax")
    from repro.core import pipeline as jpipe

    return {(m, d): jpipe.prepare(m, d, scale=SCALE, max_degree=MAX_DEGREE, seed=0) for m, d in TASKS}


@pytest.mark.parametrize("flow,k", FLOWS)
@pytest.mark.parametrize("model,ds", TASKS)
def test_session_matches_apply_and_reference(port_tasks, ref_tasks, model, ds, flow, k):
    """The port's session is ``model.apply`` bit for bit and within 1e-5 of
    the reference's compiled session, on the reference's converted
    weights."""
    import jax
    from repro.core.flows import FlowConfig as JFlowConfig

    tt, jt = port_tasks[(model, ds)], ref_tasks[(model, ds)]
    params = params_from_reference(jax.tree_util.tree_map(np.asarray, jt.params), device="cpu", model=tt.model)
    cfg = FlowConfig(flow, prune_k=k)
    sess = tt.compile(cfg, params=params)
    assert sess is tt.compile(cfg) and not sess.captured
    got = sess(params)
    with torch.inference_mode():
        assert torch.equal(got, tt.model.apply(params, tt.batch, cfg))
    want = np.asarray(jt.compile(JFlowConfig(flow, prune_k=k))(jt.params))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_session_batch_equals_separate_calls(port_tasks):
    tt = port_tasks[("han", "acm")]
    sess = tt.compile(_flow())
    versions = [tt.params, _scaled(tt.params, 0.5), tt.params]
    outs = sess.batch(versions)
    assert len(outs) == 3
    for out, p in zip(outs, versions):
        assert torch.equal(out, sess(p))
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], outs[1])


def test_session_cache_keyed_on_flow_and_params(port_tasks):
    """One session per (flow, device, parameter names, shapes and dtypes):
    the same key gives the same object, another ``prune_k`` or another
    shape or dtype a new one."""
    tt = port_tasks[("rgat", "imdb")]
    a = tt.compile(_flow(k=8))
    assert a is tt.compile(_flow(k=8)) and a is tt.compile(_flow(k=8), params=tt.params)
    assert a is tt.compile(_flow(k=8), params=_scaled(tt.params, 2.0))  # values are not part of the key
    assert tt.compile(_flow(k=4)) is not a
    wider = dict(tt.params, **{"out.b": torch.zeros(tt.params["out.b"].shape[0] + 1)})
    assert tt.compile(_flow(k=8), params=wider) is not a
    double = dict(tt.params, **{"out.b": tt.params["out.b"].double()})
    b = tt.compile(_flow(k=8), params=double)
    assert b is not a and b is tt.compile(_flow(k=8), params=double)
    n = len(tt._sessions)
    for split in ("val", "test"):
        assert 0.0 <= tpipe.accuracy(tt, tt.params, _flow(k=6), split=split) <= 1.0
    assert len(tt._sessions) == n + 1  # both splits share one session


def test_query_capacities_and_cost_analysis(port_tasks):
    tt = port_tasks[("simple_hgn", "dblp")]
    sess = InferenceSession(tt.model, tt.batch, _flow(k=5), params=tt.params)
    assert sess.query_capacities == ()
    assert sess.prewarm([64, 1, 8]) is sess
    assert sess.query_capacities == (1, 8, 64)
    rows = sess.query(tt.params, np.array([3, 0, 3, 2, 1]))
    assert torch.equal(rows, sess(tt.params)[torch.tensor([3, 0, 3, 2, 1])])
    assert sess.query_capacities == (1, 5, 8, 64)
    assert not hasattr(sess, "cost_analysis")  # no compiler estimate to give
    with pytest.raises(ValueError, match="example params"):
        InferenceSession(tt.model, tt.batch, _flow())


def test_query_out_of_range_ids_raise(port_tasks, ref_tasks):
    """The reference's gather (``out[idx]`` under ``jax.jit``) wraps a
    negative id and clamps a large one: on n rows, ids [-1, n + 1, 0] give
    rows [n - 1, n - 1, 0] (on 4 rows, [-1, 5, 0] give [3, 3, 0]), with no
    error. The port raises ``IndexError`` naming the bad ids, before any
    forward runs, for ids on the host in any form."""
    from repro.core.flows import FlowConfig as JFlowConfig

    jt = ref_tasks[("han", "acm")]
    jsess = jt.compile(JFlowConfig("staged"))
    full = np.asarray(jsess(jt.params))
    n = full.shape[0]
    got = np.asarray(jsess.query(jt.params, np.array([-1, n + 1, 0], np.int32)))
    np.testing.assert_array_equal(got, full[[n - 1, n - 1, 0]])

    tt = port_tasks[("han", "acm")]
    calls = []

    class Counting:
        num_classes = tt.model.num_classes

        def apply(self, params, batch, flow):
            calls.append(flow)
            return tt.model.apply(params, batch, flow)

    sess = InferenceSession(Counting(), tt.batch, FlowConfig("staged"), params=tt.params)
    queries = tflows.DISPATCH["query_calls"]
    for bad in ([-1, n + 1, 0], np.array([0, n]), torch.tensor([-2, 3])):
        with pytest.raises(IndexError, match=r"outside \[0, %d\)" % n) as err:
            sess.query(tt.params, bad)
        assert all(str(i) in str(err.value) for i in torch.as_tensor(bad).tolist() if not 0 <= i < n)
    assert calls == [] and sess.query_capacities == () and tflows.DISPATCH["query_calls"] == queries
    rows = sess.query(tt.params, [n - 1, 0])
    assert torch.equal(rows, sess(tt.params)[[n - 1, 0]]) and tflows.DISPATCH["query_calls"] == queries + 1


def test_mismatched_params_raise(port_tasks):
    """A params mapping with other names, shapes or dtypes than the
    session's program raises ``ValueError`` on every entry point."""
    tt = port_tasks[("han", "acm")]
    sess = tt.compile(_flow())
    name = next(iter(tt.params))
    bad = {
        "missing": {n: t for n, t in tt.params.items() if n != name},
        "unexpected": dict(tt.params, extra=torch.zeros(1)),
        "shape": dict(tt.params, **{name: tt.params[name][:1]}),
        "dtype": dict(tt.params, **{name: tt.params[name].double()}),
    }
    for params in bad.values():
        for call in (lambda: sess(params), lambda: sess.query(params, [0]), lambda: sess.batch([params])):
            with pytest.raises(ValueError, match="do not match the session"):
                call()


# ---------------------------------------------------------------------------
# on a card: the captured program
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _eager(task, params, flow):
    with torch.inference_mode():
        return task.model.apply(params, task.batch, flow)


def _counters():
    return dict(tflows.DISPATCH), dict(fpa_ops.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("model,ds", (("han", "acm"), ("rgat", "imdb"), ("simple_hgn", "imdb")))
def test_cuda_captured_forward_is_eager(cuda_device, model, ds, route):
    """The captured forward equals the eager ``model.apply`` bit for bit,
    for the example params and for another weight version; three replays
    tick no dispatch or launch counter; an earlier result is unchanged by
    a later call; query rows are the full rows."""
    task = _prepare(model, ds, cuda_device, route)
    flow = _flow(route=route)
    sess = task.compile(flow)
    assert sess.captured
    other = _scaled(task.params, 0.5)
    first = sess(task.params)
    kept = first.clone()
    before = _counters()
    outs = [sess(task.params), sess(other), sess.query(other, torch.arange(5, device=cuda_device))]
    torch.cuda.synchronize()
    assert _counters() == (dict(before[0], query_calls=before[0]["query_calls"] + 1), before[1])
    assert torch.equal(first, _eager(task, task.params, flow)) and torch.equal(outs[0], first)
    assert torch.equal(outs[1], _eager(task, other, flow)) and not torch.equal(outs[1], first)
    assert torch.equal(outs[2], outs[1][:5])
    assert torch.equal(first, kept)  # a later call never writes to an earlier result


@pytest.mark.cuda
def test_cuda_replays_tick_nothing(cuda_device):
    """The counters tick at the build (warm-up and capture), never on a
    replay: the reference's zero Python dispatch on repeated calls."""
    task = _prepare("rgat", "imdb", cuda_device)
    for key in fpa_ops.LAUNCHES:
        fpa_ops.LAUNCHES[key] = 0
    sess = task.compile(_flow(k=4))
    assert fpa_ops.LAUNCHES["prune_aggregate"] > 0
    before = _counters()
    for _ in range(3):
        sess(task.params)
    torch.cuda.synchronize()
    assert _counters() == before


@pytest.mark.cuda
def test_cuda_query_out_of_range_ids_raise(cuda_device):
    """Ids on the card are checked with one reduction and one synchronize:
    an id outside the rows raises ``IndexError`` before any launch (and
    never trips a device-side assert), and the card serves on."""
    task = _prepare("han", "acm", cuda_device)
    sess = task.compile(_flow())
    n = sess.out_shape[0]
    before = _counters()
    with pytest.raises(IndexError, match=str(n)):
        sess.query(task.params, torch.tensor([0, n], device=cuda_device))
    with pytest.raises(IndexError, match="-1"):
        sess.query(task.params, torch.tensor([-1, 1], device=cuda_device, dtype=torch.int32))
    assert _counters() == before
    idx = torch.tensor([n - 1, 0], device=cuda_device)
    assert torch.equal(sess.query(task.params, idx), sess(task.params)[idx])


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda_device):
    """A forward that synchronizes with the host cannot be captured: the
    session raises at construction and never serves the eager forward."""
    task = _prepare("han", "acm", cuda_device)

    class Syncing:
        num_classes = task.model.num_classes

        def apply(self, params, batch, flow):
            out = task.model.apply(params, batch, flow)
            return out * float(out.sum())  # a host read: not capturable

    with pytest.raises(RuntimeError):
        InferenceSession(Syncing(), task.batch, _flow(), params=task.params)
    # the card still serves a captured session afterwards
    assert torch.equal(task.compile(_flow())(task.params), _eager(task, task.params, _flow()))


@pytest.mark.cuda
def test_cuda_compiled_decode_step_is_eager(cuda_device):
    """Greedy steps through ``LM.compile_decode`` give the eager loop's
    tokens, logits and cache bit for bit (the smoke config, past the local
    ring's wrap and with the global layer pruning)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.layers.attention import KVCache
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("gemma3-4b", smoke=True), dtype="float32")
    lm = build_model(cfg, device=cuda_device, generator=torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    logits, cache = lm.prefill(prompt, max_len=32)
    eager = [KVCache(c.k.clone(), c.v.clone()) for c in cache]
    step = lm.compile_decode(cache)
    tok_e = tok_c = logits.argmax(-1)[:, None]
    for pos in range(20, 32):
        l_e, eager = lm.decode_step(tok_e, pos, eager)
        l_c = step(tok_c, pos)
        assert torch.equal(l_c, l_e), pos
        tok_e, tok_c = l_e.argmax(-1)[:, None], l_c.argmax(-1)[:, None]
        assert torch.equal(tok_c, tok_e)
    for a, b in zip(cache, eager):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
