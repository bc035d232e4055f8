"""Port parity: HAN logits on the CPU against the reference, and the
serving contracts of the port's session.

The reference's initialized parameter tree goes through
``repro_torch.convert.params_from_reference``; both packages then run the
same graph (bit-identical SGB, see ``test_torch_sgb.py``) under
``staged``, ``staged_pruned``, ``fused`` and ``fused_kernel`` (grouped,
per-bucket loop and flat routes). Logits agree within 1e-5, the
reference's own flat-vs-bucketed logit tolerance.
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

SCALE = 0.05
DATASETS = ("acm", "dblp", "imdb")
FLOWS = (("staged", None), ("staged_pruned", 4), ("fused_kernel", 4), ("fused_kernel", 8))


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


@pytest.fixture(scope="module")
def port_tasks():
    return {
        ds: tpipe.prepare("han", ds, scale=SCALE, seed=0, device="cpu") for ds in DATASETS
    }


@pytest.fixture(scope="module")
def ref_tasks():
    pytest.importorskip("jax")
    from repro.core import pipeline as jpipe

    return {ds: jpipe.prepare("han", ds, scale=SCALE, seed=0) for ds in DATASETS}


@pytest.mark.parametrize("flow,k", FLOWS)
@pytest.mark.parametrize("ds", DATASETS)
def test_han_logits_match_reference(port_tasks, ref_tasks, ds, flow, k):
    import jax
    from repro.core.flows import FlowConfig as JFlowConfig

    jt, tt = ref_tasks[ds], port_tasks[ds]
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jt.params), device="cpu", model=tt.model
    )
    want = np.asarray(jt.model.apply(jt.params, jt.batch, JFlowConfig(flow, prune_k=k)))
    got = tt.compile(FlowConfig(flow, prune_k=k))(params).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# prune_k 1, 2, 16 and 300 (past the default max_degree 256) and
# max_degree 16, which the cases above do not reach: (dataset, max_degree,
# prune_k)
HAN_COVERAGE = (("acm", 256, 1), ("dblp", 256, 2), ("acm", 256, 300), ("acm", 16, 16), ("imdb", 16, 2))


@pytest.mark.parametrize("ds,max_degree,k", HAN_COVERAGE)
def test_han_coverage_matches_reference(ds, max_degree, k):
    pytest.importorskip("jax")
    import jax
    from repro.core import pipeline as jpipe
    from repro.core.flows import FlowConfig as JFlowConfig

    jt = jpipe.prepare("han", ds, scale=SCALE, seed=0, max_degree=max_degree)
    tt = tpipe.prepare("han", ds, scale=SCALE, seed=0, device="cpu", max_degree=max_degree)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jt.params), device="cpu", model=tt.model
    )
    want = np.asarray(jt.model.apply(jt.params, jt.batch, JFlowConfig("fused_kernel", prune_k=k)))
    got = tt.compile(FlowConfig("fused_kernel", prune_k=k))(params).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_session_is_model_apply(port_tasks):
    """``session(params)`` is ``model.apply`` (and ``model(batch)``, and the
    stages run by hand) bit for bit; accuracy is a fraction."""
    tt = port_tasks["acm"]
    flow = FlowConfig("fused_kernel", prune_k=4)
    with torch.inference_mode():
        direct = tt.model.apply(tt.params, tt.batch, flow)
        via_forward = tt.model(tt.batch, flow)
        carry = dict(tt.batch.features)
        for step in tt.model.layer_steps(tt.params, tt.batch, flow):
            h = step.project(carry)
            zs = {name: fn(h) for name, fn in step.na}
            carry = step.fuse(carry, h, zs)
        manual = tt.model.readout(tt.params, tt.batch, carry)
    sess = tt.compile(flow)
    assert sess is tt.compile(flow)
    assert torch.equal(sess(tt.params), direct)
    assert torch.equal(via_forward, direct)
    assert torch.equal(manual, direct)
    assert sess.out_shape == tuple(direct.shape)
    acc = tpipe.accuracy(tt, tt.params, flow)
    assert 0.0 <= acc <= 1.0


def test_query_rows_are_full_rows(port_tasks):
    """Query blocks at capacities 1, 8, 64 are the full forward's rows bit
    for bit, one counted query call each; bad blocks and capacities raise."""
    tt = port_tasks["dblp"]
    sess = tt.compile(FlowConfig("fused_kernel", prune_k=8))
    assert sess.prewarm([1, 8, 64]) is sess
    with pytest.raises(ValueError, match="capacity"):
        sess.prewarm([8, 0])
    full = sess(tt.params)
    rng = np.random.default_rng(0)
    for capacity in (1, 8, 64):
        idx = rng.integers(0, full.shape[0], size=capacity)
        before = tflows.DISPATCH["query_calls"]
        rows = sess.query(tt.params, idx)
        assert tflows.DISPATCH["query_calls"] == before + 1
        assert torch.equal(rows, full[torch.from_numpy(idx)])
    with pytest.raises(ValueError, match="1-D"):
        sess.query(tt.params, idx.reshape(1, -1))


def test_default_device_raises_without_gpu():
    """Entry points default to CUDA and never drop to the CPU by
    themselves: with no GPU present they raise."""
    from repro_torch import resolve_device

    tree = {"out": {"w": np.zeros((2, 2), np.float32), "b": np.zeros(2, np.float32)}}
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.prepare("han", "acm", scale=SCALE)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_reference(tree)
    assert params_from_reference(tree, device="cpu")["out.w"].device.type == "cpu"
    with pytest.raises(ValueError, match="unknown dataset"):
        tpipe.prepare("han", "no-such-dataset", scale=SCALE, device="cpu")


@pytest.mark.parametrize("flow", (
    FlowConfig("fused", prune_k=4),
    FlowConfig("fused_kernel", prune_k=4, bucket_dispatch="loop"),
), ids=("fused", "loop"))
def test_ported_flows_match_reference(port_tasks, ref_tasks, flow):
    """The scan emulation (``fused``) and the per-bucket dispatch (``loop``,
    one flat-kernel launch pair per pruned bucket) against the reference's
    own ``fused`` and ``fused_kernel`` on the bucketed ACM build."""
    import jax
    from repro.core.flows import FlowConfig as JFlowConfig

    jt, tt = ref_tasks["acm"], port_tasks["acm"]
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jt.params), device="cpu", model=tt.model
    )
    want = np.asarray(jt.model.apply(jt.params, jt.batch, JFlowConfig(flow.flow, prune_k=4)))
    before = tflows.DISPATCH["bucket_calls"]
    got = tt.compile(flow)(params).numpy()
    loops = tflows.DISPATCH["bucket_calls"] - before
    assert loops == (sum(len(sg.buckets) for sg in tt.sgs) if flow.bucket_dispatch == "loop" else 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_flat_sgb(port_tasks, ref_tasks):
    """On a flat SGB, ``fused_kernel`` (flat kernel pair) matches the
    reference's flat Pallas route, and ``staged_pruned`` matches the
    bucketed build."""
    import jax
    from repro.core import pipeline as jpipe
    from repro.core.flows import FlowConfig as JFlowConfig

    tt = port_tasks["acm"]
    flat = tpipe.prepare("han", "acm", scale=SCALE, seed=0, device="cpu", bucket_sizes=None)
    jflat = jpipe.prepare("han", "acm", scale=SCALE, seed=0, bucket_sizes=None)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jflat.params), device="cpu", model=flat.model
    )
    want = np.asarray(jflat.model.apply(jflat.params, jflat.batch, JFlowConfig("fused_kernel", prune_k=4)))
    got = flat.compile(FlowConfig("fused_kernel", prune_k=4))(params).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    flow = FlowConfig("staged_pruned", prune_k=4)
    torch.testing.assert_close(
        flat.compile(flow)(flat.params), tt.compile(flow)(tt.params), atol=1e-5, rtol=0,
    )
