"""The port's HGNN training against the reference's (``pipeline.train_hgnn``,
``HGNNTask._train_step``, ``optim.adamw``, ``optim.schedules``).

On the CPU, on fig9's settings (``benchmarks/fig9_accuracy.py``: ACM at
``scale=0.06``, ``max_degree=96``, 60 steps at lr 5e-3, weight decay 1e-4),
for HAN, RGAT and Simple-HGN, from the reference's initial parameters
converted:

  * every step's loss within 1e-5 of the reference's ``_train_step``'s
    (2.1e-7 measured);
  * trained logits within 1e-3 (1.9e-4 measured on logits up to 31);
  * test accuracy equal to the reference's under ``staged`` and under
    ``fused`` at K = 2, 5, 10, 20 and 50;
  * Simple-HGN's last layer does not use its ``res`` projections: their
    gradient is zero, as JAX gives, and weight decay and the moments step
    them as the reference's do.

``adamw.update`` alone is held to the reference's within 1e-7 over 10
steps (with and without clipping, weight decay 0 and 1e-4, bfloat16
moments, a schedule as ``lr``), the schedules at steps 0, 1, warmup, total
and beyond, and the semantic graphs' statistics (``num_edges``,
``degrees()``, ``padded_slots()``, ``max_degree``) equal the reference's on
the metapath, relation and union builds, flat and bucketed. Then the
pipeline's contracts: training after a compiled session (whose device
caches were filled under ``torch.inference_mode()``), ``task.params`` left
as they were, two runs equal through one cached step, ``fused_kernel``
refused, and ``accuracy`` building a session for the params it is given.

The ``cuda``-marked tests skip without a card. On one, the captured step
gives the eager step's losses and parameters, and a session's replay is
unchanged by training on the same task.
"""
import gc
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import optim as toptim  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.flows import FlowConfig  # noqa: E402

MODELS = ("han", "rgat", "simple_hgn")
FIG9 = dict(scale=0.06, max_degree=96)  # benchmarks/fig9_accuracy.py
STEPS, LR = 60, 5e-3
KS = (2, 5, 10, 20, 50)
ATOL_LOSS, ATOL_LOGITS, ATOL_ADAMW = 1e-5, 1e-3, 1e-7


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


def _accuracies(acc, task, params, flow_cls):
    """Test accuracy under ``staged`` and under ``fused`` at each of KS, as
    counts of correct test nodes."""
    n = len(task.splits["test"])
    flows = [flow_cls("staged")] + [flow_cls("fused", prune_k=k) for k in KS]
    return [round(acc(task, params, f) * n) for f in flows]


@pytest.fixture(scope="module")
def fig9_runs():
    """Per model, fig9's training in both packages from the same initial
    parameters: the per-step losses, the trained parameters and logits, and
    the test accuracies. Built once per model, on first use."""
    pytest.importorskip("jax")
    import jax
    from repro.core import pipeline as jpipe
    from repro.core.flows import FlowConfig as JFlowConfig

    runs = {}

    def get(model):
        if model in runs:
            return runs[model]
        jt = jpipe.prepare(model, "acm", **FIG9)
        step_fn, opt = jt._train_step(JFlowConfig(), LR)
        jp, state, jl = jt.params, opt.init(jt.params), []
        for _ in range(STEPS):
            jp, state, loss = step_fn(jp, state)
            jl.append(float(loss))
        tt = tpipe.prepare(model, "acm", device="cpu", **FIG9)
        tt.params = params_from_reference(
            jax.tree_util.tree_map(np.asarray, jt.params), device="cpu", model=tt.model
        )
        step = tt._train_step(FlowConfig(), LR)
        step.reset(tt.params)
        tl = [float(step()) for _ in range(STEPS)]
        trained = step.params()
        with torch.no_grad():
            t_logits = tt.model.apply(trained, tt.batch, FlowConfig()).numpy()
        runs[model] = dict(
            jt=jt, tt=tt, ref_losses=jl, losses=tl, ref_params=jax.tree_util.tree_map(np.asarray, jp),
            params=trained, ref_logits=np.asarray(jt.model.apply(jp, jt.batch, JFlowConfig())),
            logits=t_logits,
            ref_acc=_accuracies(jpipe.accuracy, jt, jp, JFlowConfig),
            acc=_accuracies(tpipe.accuracy, tt, trained, FlowConfig),
        )
        return runs[model]

    return get


@pytest.mark.parametrize("model", MODELS)
def test_train_losses_match_reference(fig9_runs, model):
    run = fig9_runs(model)
    np.testing.assert_allclose(run["losses"], run["ref_losses"], atol=ATOL_LOSS, rtol=0)
    assert run["losses"][-1] < run["losses"][0]


@pytest.mark.parametrize("model", MODELS)
def test_trained_logits_match_reference(fig9_runs, model):
    run = fig9_runs(model)
    assert np.isfinite(run["logits"]).all()
    np.testing.assert_allclose(run["logits"], run["ref_logits"], atol=ATOL_LOGITS, rtol=0)


@pytest.mark.parametrize("model", MODELS)
def test_pruned_accuracy_matches_reference(fig9_runs, model):
    """fig9's sweep: the number of correct test nodes under ``staged`` and
    under ``fused`` at K = 2, 5, 10, 20, 50 equals the reference's."""
    run = fig9_runs(model)
    assert run["acc"] == run["ref_acc"]


def test_simple_hgn_unused_params_decay_as_reference(fig9_runs):
    """``layers.1.res.author`` and ``layers.1.res.subject`` do not reach the
    loss: their gradient is zero, so only weight decay moves them (the
    moments stay zero), exactly as in the reference."""
    from repro_torch.convert import _flatten

    run = fig9_runs("simple_hgn")
    ref = _flatten(run["ref_params"])
    init = run["tt"].params
    unused = [n for n in init if n.startswith(("layers.1.res.author", "layers.1.res.subject"))]
    assert unused  # the last layer keeps only the labeled type, paper
    for name in unused:
        got = run["params"][name].numpy()
        np.testing.assert_allclose(got, ref[name], atol=ATOL_ADAMW, rtol=0)
        assert not np.array_equal(got, init[name].numpy())  # decayed
        want = init[name].numpy()
        for _ in range(STEPS):  # the moments stay zero: p ← p − lr·(0 + wd·p), in float32
            want = want - np.float32(LR) * (np.float32(0) + np.float32(1e-4) * want)
        np.testing.assert_allclose(got, want, atol=ATOL_ADAMW, rtol=0)


# ---------------------------------------------------------------------------
# the optimizer and the schedules
# ---------------------------------------------------------------------------

SHAPES = {"a.w": (5, 3), "a.b": (3,), "b.q": (7,), "c": (2, 2, 4)}


def _schedule(pkg, name):
    if name == "warmup":
        return pkg.linear_warmup(1e-2, 4)
    if name == "cosine":
        return pkg.cosine_schedule(1e-2, 3, 8)
    return None


@pytest.mark.parametrize("clip,wd,moments,lr", (
    (1.0, 0.0, "float32", None),      # clipping (the gradients' norm is above 1)
    (None, 0.0, "float32", None),     # no clipping
    (1.0, 1e-4, "float32", None),
    (None, 1e-4, "float32", None),
    (1.0, 1e-4, "bfloat16", None),
    (1.0, 1e-4, "float32", "warmup"),
    (1.0, 1e-4, "float32", "cosine"),
))
def test_adamw_update_matches_reference(clip, wd, moments, lr):
    """Ten updates from the same numpy params and gradients: params,
    moments and step within 1e-7 of the reference's ``adamw().update``;
    the update is pure (its inputs unchanged)."""
    import jax.numpy as jnp
    from repro import optim as joptim

    rng = np.random.default_rng(3)
    p0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (2.0 * rng.standard_normal(s)).astype(np.float32) for n, s in SHAPES.items()} for _ in range(10)]
    jlr, tlr = (_schedule(joptim, lr), _schedule(toptim, lr)) if lr else (3e-3, 3e-3)
    jopt = joptim.adamw(lr=jlr, weight_decay=wd, grad_clip_norm=clip, moment_dtype=getattr(jnp, moments))
    topt = toptim.adamw(lr=tlr, weight_decay=wd, grad_clip_norm=clip, moment_dtype=getattr(torch, moments))
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for g in grads:
        tg = {n: torch.from_numpy(a) for n, a in g.items()}
        before = [t.clone() for t in (*tp.values(), *tg.values(), *ts.mu.values(), ts.step)]
        jp, js = jopt.update({n: jnp.asarray(a) for n, a in g.items()}, js, jp)
        new_tp, new_ts = topt.update(tg, ts, tp)
        after = [*tp.values(), *tg.values(), *ts.mu.values(), ts.step]
        assert all(torch.equal(a, b) for a, b in zip(before, after))  # pure
        tp, ts = new_tp, new_ts
        assert int(ts.step) == int(js.step)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), atol=ATOL_ADAMW, rtol=0)
            for tm, jm in ((ts.mu[n], js.mu[n]), (ts.nu[n], js.nu[n])):
                assert tm.dtype == getattr(torch, moments)
                np.testing.assert_allclose(
                    tm.float().numpy(), np.asarray(jm.astype(jnp.float32)), atol=ATOL_ADAMW, rtol=0
                )


@pytest.mark.parametrize("name", ("warmup", "cosine"))
def test_schedules_match_reference(name):
    """At steps 0, 1, the end of warmup, the total and beyond."""
    import jax.numpy as jnp
    from repro import optim as joptim

    warmup, total = 10, 100
    args = (5e-3, warmup) if name == "warmup" else (5e-3, warmup, total)
    jf = getattr(joptim, "linear_warmup" if name == "warmup" else "cosine_schedule")(*args)
    tf = getattr(toptim, "linear_warmup" if name == "warmup" else "cosine_schedule")(*args)
    for s in (0, 1, warmup, total, 3 * total):
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jf(jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# semantic-graph statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ("bucketed", "flat"))
@pytest.mark.parametrize("model", MODELS)  # metapath, relation and union builds
def test_graph_statistics_match_reference(model, layout):
    from repro.core import hetgraph as jhet
    from repro.core import pipeline as jpipe

    from repro_torch.core import hetgraph as thet

    kw = dict(scale=0.04, max_degree=48, seed=0)
    if layout == "flat":
        kw["bucket_sizes"] = None
    jt, tt = jpipe.prepare(model, "acm", **kw), tpipe.prepare(model, "acm", device="cpu", **kw)
    assert tt.num_edges == jt.num_edges > 0
    want_cls = thet.SemanticGraph if layout == "flat" else thet.BucketedSemanticGraph
    for j, t in zip(jt.sgs, tt.sgs, strict=True):
        assert type(t) is want_cls and type(j).__name__ == want_cls.__name__ and t.name == j.name
        assert t.num_edges == j.num_edges
        assert t.padded_slots() == j.padded_slots()
        np.testing.assert_array_equal(t.degrees(), j.degrees())
        assert t.degrees().dtype == j.degrees().dtype
        if isinstance(j, jhet.BucketedSemanticGraph):
            assert t.max_degree == j.max_degree


# ---------------------------------------------------------------------------
# the pipeline's contracts
# ---------------------------------------------------------------------------


def _small(model="rgat", device="cpu"):
    return tpipe.prepare(model, "acm", scale=0.04, max_degree=48, seed=0, device=device)


def test_train_after_compiled_session():
    """A session fills the SGB tables' device caches under
    ``torch.inference_mode()``; training the same task afterwards must
    still differentiate through them (it raised "Inference tensors cannot
    be saved for backward" before the caches were built as normal
    tensors), on every route and flow that trains."""
    for bucket_sizes, dispatch in (((8, 32, 128), "single"), ((8, 32, 128), "loop"), (None, "single")):
        task = tpipe.prepare("rgat", "acm", scale=0.04, seed=0, bucket_sizes=bucket_sizes, device="cpu")
        for flow in ("staged", "fused"):
            cfg = FlowConfig(flow, prune_k=4 if flow == "fused" else None, bucket_dispatch=dispatch)
            task.compile(cfg)(task.params)
            task.compile(FlowConfig("fused_kernel", prune_k=4, bucket_dispatch=dispatch))(task.params)
            trained = tpipe.train_hgnn(task, steps=2, flow=cfg)
            assert all(bool(torch.isfinite(t).all()) for t in trained.values())
            assert any(not torch.equal(trained[n], task.params[n]) for n in trained)


def test_train_step_captures_through_the_session_capture(monkeypatch):
    """``TrainStep._capture`` goes through ``session._capture_graph`` (one
    capture at a time, thread-local, the device's one warm-up stream) with
    grad mode on, and its warm-up is one eager step before the captured
    one, as before. Recorded here with a stand-in for the capture, which
    runs the forward it is given twice, as the real one does."""
    from repro_torch.core import session as tsession

    task = _small()
    step = task._train_step(FlowConfig("staged"), 5e-3)
    calls, eager = [], []
    orig = step.eager

    def counted():
        eager.append(torch.is_grad_enabled())
        return orig()

    def capture(forward, device, inference=True):
        calls.append((device, inference))
        forward()
        return "graph", forward()

    monkeypatch.setattr(step, "eager", counted)
    monkeypatch.setattr(tsession, "_capture_graph", capture)
    step._capture()
    assert calls == [(task.device, False)]
    assert eager == [True, True]  # the warm-up step, then the captured one
    assert step._graph == "graph" and step._loss_out.dim() == 0


def test_train_hgnn_leaves_task_params_and_returns_plain_copies():
    task = _small()
    before = {n: t.clone() for n, t in task.params.items()}
    trained = tpipe.train_hgnn(task, steps=3)
    assert all(torch.equal(task.params[n], before[n]) for n in before)
    assert set(trained) == set(before)
    for name, t in trained.items():
        assert not t.requires_grad and t.dtype == before[name].dtype and t.shape == before[name].shape
    # a later run does not change an earlier result
    kept = {n: t.clone() for n, t in trained.items()}
    tpipe.train_hgnn(task, steps=5)
    assert all(torch.equal(trained[n], kept[n]) for n in kept)
    # the trained params serve through a session
    assert tpipe.accuracy(task, trained, FlowConfig("fused_kernel", prune_k=4)) >= 0.0


@pytest.fixture()
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for one test, so a
    bit-for-bit comparison of two runs rests on no kernel that adds in
    thread order (advanced indexing's backward did on the CPU, by an ulp
    from run to run)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def test_train_hgnn_twice_equal_through_one_cached_step(capsys, deterministic):
    """Two runs from ``task.params`` through the one cached step give the
    same params bit for bit (deterministic algorithms on), and the
    ``log_every`` lines are the reference's."""
    task = _small()
    a = tpipe.train_hgnn(task, steps=4, log_every=2)
    step = task._train_step(FlowConfig(), 5e-3)
    b = tpipe.train_hgnn(task, steps=4)
    assert task._train_step(FlowConfig(), 5e-3) is step and len(task._steps) == 1
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert task._train_step(FlowConfig(), 1e-3) is not step  # another lr, another step
    assert task._train_step(FlowConfig(), 5e-3, weight_decay=0.0) is not step
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["step", "0"], ["step", "2"], ["step", "3"]]
    assert all(ln.split()[2] == "loss" and np.isfinite(float(ln.split()[3])) for ln in lines)


def test_fused_kernel_training_raises():
    task = _small()
    with pytest.raises(ValueError, match="fused_kernel"):
        tpipe.train_hgnn(task, steps=1, flow=FlowConfig("fused_kernel", prune_k=4))
    assert not task._steps


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float64))
def test_accuracy_builds_a_session_for_its_params(dtype):
    """``accuracy`` compiles for the params it is given (the reference's
    ``task.compile(flow, params=params)``): params whose dtypes differ from
    the task's get a session of their own, where the task's session raised
    ``ValueError``. The readout bias is the parameter held in ``dtype``
    (zeros at init, so the accuracy is the same); the port's matmuls do
    not promote mixed dtypes as JAX's do (ROADMAP §3)."""
    task = _small("han")
    flow = FlowConfig("fused", prune_k=4)
    base = tpipe.accuracy(task, task.params, flow)
    n = len(task._sessions)
    other = dict(task.params, **{"out.b": task.params["out.b"].to(dtype)})
    with pytest.raises(ValueError, match="do not match the session"):
        task.compile(flow)(other)
    assert tpipe.accuracy(task, other, flow) == base
    assert len(task._sessions) == n + 1
    assert task.compile(flow, params=other) is not task.compile(flow)


# ---------------------------------------------------------------------------
# on a card: the captured step
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_cuda_captured_step_matches_eager(cuda_device, model):
    """From the same params, 10 captured steps give the eager step's losses
    within 1e-5 and parameters within 1e-4 (the index backward adds with
    atomics, so not bit for bit), and the losses of the CPU's steps."""
    task = _small(model, cuda_device)
    step = task._train_step(FlowConfig(), LR)
    step.reset(task.params)
    captured = [float(step()) for _ in range(10)]
    p_captured = step.params()
    step.reset(task.params)
    eager = [float(step.eager()) for _ in range(10)]
    p_eager = step.params()
    np.testing.assert_allclose(captured, eager, atol=1e-5, rtol=0)
    for n in p_eager:
        torch.testing.assert_close(p_captured[n], p_eager[n], atol=1e-4, rtol=0)
    cpu = _small(model)
    cpu_step = cpu._train_step(FlowConfig(), LR)
    cpu_step.reset({n: t.cpu() for n, t in task.params.items()})
    np.testing.assert_allclose([float(cpu_step()) for _ in range(3)], captured[:3], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_session_unchanged_by_training(cuda_device):
    """A captured session built before training replays the same bits after
    ``train_hgnn`` ran on the same task (whose device caches the session
    built), and training after the session works."""
    task = _small("rgat", cuda_device)
    flow = FlowConfig("fused_kernel", prune_k=4)
    sess = task.compile(flow)
    before = sess(task.params)
    trained = tpipe.train_hgnn(task, steps=5)
    assert torch.equal(sess(task.params), before)
    assert not torch.equal(sess(trained), before)
    assert all(bool(torch.isfinite(t).all()) for t in trained.values())
