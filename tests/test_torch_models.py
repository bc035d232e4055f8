"""Port parity: RGAT and Simple-HGN logits on the CPU against the reference.

The reference's initialized parameter trees go through
``repro_torch.convert.params_from_reference``; both packages then run the
same graphs (bit-identical relation and union SGB, see
``test_torch_sgb.py``) on ACM and IMDB, where the labeled type receives
every relation, so the logits depend on every NA. (On DBLP the labeled
type ``author`` is the destination of no relation, and logits say nothing
about NA.) Every flow and route of the port is held within 1e-5 of the
reference:

  * ``staged``, ``staged_pruned`` K=4 and ``fused`` K=4 on the bucketed
    build, against the same flows of the reference;
  * ``fused_kernel`` K=4 on the grouped single dispatch, against the
    reference's grouped Pallas kernel;
  * ``fused_kernel`` K=4 on the per-bucket loop, which runs the flat kernel
    pair per pruned bucket, against the reference's grouped kernel (the
    same function: the reference's loop route runs its flat kernel per
    bucket with the same rule);
  * ``fused_kernel`` K=4 and unpruned on the flat build, against the
    reference's flat Pallas kernel.

Each task and each reference result is built once per module.
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
MODELS = ("rgat", "simple_hgn")
DATASETS = ("acm", "imdb")
# (flow, prune_k, route); the route picks the SGB layout and the dispatch
CASES = (
    ("staged", None, "single"),
    ("staged_pruned", 4, "single"),
    ("fused", 4, "single"),
    ("fused_kernel", 4, "single"),
    ("fused_kernel", 4, "loop"),
    ("fused_kernel", 4, "flat"),
    ("fused_kernel", None, "flat"),
)


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
def tasks():
    """(model, dataset, flat) -> (reference task, port task, converted
    parameters), built once."""
    pytest.importorskip("jax")
    import jax
    from repro.core import pipeline as jpipe

    cache = {}

    def get(model, ds, flat, **prep):
        key = (model, ds, flat, tuple(sorted(prep.items())))
        if key not in cache:
            kw = dict(prep, bucket_sizes=None) if flat else dict(prep)
            jt = jpipe.prepare(model, ds, scale=SCALE, seed=0, **kw)
            tt = tpipe.prepare(model, ds, scale=SCALE, seed=0, device="cpu", **kw)
            params = params_from_reference(
                jax.tree_util.tree_map(np.asarray, jt.params), device="cpu", model=tt.model
            )
            cache[key] = (jt, tt, params)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def reference():
    """(model, dataset, flow, prune_k, flat) -> the reference's logits,
    computed once."""
    from repro.core.flows import FlowConfig as JFlowConfig

    cache = {}

    def get(tasks, model, ds, flow, k, flat, **prep):
        key = (model, ds, flow, k, flat, tuple(sorted(prep.items())))
        if key not in cache:
            jt, _, _ = tasks(model, ds, flat, **prep)
            cache[key] = np.asarray(jt.model.apply(jt.params, jt.batch, JFlowConfig(flow, prune_k=k)))
        return cache[key]

    return get


@pytest.mark.parametrize("flow,k,route", CASES)
@pytest.mark.parametrize("ds", DATASETS)
@pytest.mark.parametrize("model", MODELS)
def test_logits_match_reference(tasks, reference, model, ds, flow, k, route):
    flat = route == "flat"
    _, tt, params = tasks(model, ds, flat)
    want = reference(tasks, model, ds, flow, k, flat)
    cfg = FlowConfig(flow, prune_k=k, bucket_dispatch="loop" if route == "loop" else "single")
    before = tflows.DISPATCH["bucket_calls"]
    got = tt.compile(cfg)(params).numpy()
    n_buckets = 0 if flat else sum(len(sg.buckets) for sg in tt.sgs)
    layers = tt.model.num_layers
    assert tflows.DISPATCH["bucket_calls"] - before == (layers * n_buckets if route == "loop" else 0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# Configurations the cases above do not reach: prune_k 1, 2, 16 and 300
# (past the default max_degree 256: every bucket takes the §4.3 bypass),
# max_degree 16 and None, bucket_sizes (2, 8, 32), and a flat Simple-HGN
# with max_degree 16; (model, dataset, prepare options, flow, prune_k, route)
COVERAGE = (
    ("rgat", "acm", (), "fused_kernel", 1, "single"),
    ("rgat", "acm", (), "fused_kernel", 2, "loop"),
    ("rgat", "acm", (), "fused_kernel", 16, "single"),
    ("rgat", "acm", (), "fused_kernel", 300, "single"),
    ("rgat", "acm", (), "staged_pruned", 16, "single"),
    ("simple_hgn", "imdb", (), "fused_kernel", 1, "flat"),
    ("simple_hgn", "imdb", (), "fused_kernel", 300, "loop"),
    ("rgat", "acm", (("max_degree", None),), "fused_kernel", 8, "single"),
    ("rgat", "acm", (("max_degree", None),), "fused_kernel", 8, "loop"),
    ("rgat", "imdb", (("max_degree", 16),), "fused_kernel", 16, "single"),
    ("simple_hgn", "imdb", (("bucket_sizes", (2, 8, 32)),), "fused_kernel", 4, "single"),
    ("simple_hgn", "imdb", (("bucket_sizes", (2, 8, 32)),), "fused", 4, "single"),
    ("simple_hgn", "acm", (("max_degree", 16),), "fused_kernel", 4, "flat"),
    ("simple_hgn", "acm", (("max_degree", 16),), "fused_kernel", None, "flat"),
)


@pytest.mark.parametrize("model,ds,prep,flow,k,route", COVERAGE)
def test_coverage_logits_match_reference(tasks, reference, model, ds, prep, flow, k, route):
    flat = route == "flat"
    prep = dict(prep)
    _, tt, params = tasks(model, ds, flat, **prep)
    want = reference(tasks, model, ds, flow, k, flat, **prep)
    cfg = FlowConfig(flow, prune_k=k, bucket_dispatch="loop" if route == "loop" else "single")
    got = tt.compile(cfg)(params).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


@pytest.mark.parametrize("model", MODELS)
def test_convert_round_trip(tasks, model):
    """Every leaf of the reference's tree (lists of layers included) lands
    under the model's own parameter name, bit for bit; a tree that does not
    match the model raises."""
    import jax

    jt, tt, params = tasks(model, "acm", False)
    tree = jax.tree_util.tree_map(np.asarray, jt.params)
    assert set(params) == {n for n, _ in tt.model.named_parameters()}
    assert len(params) == len(jax.tree_util.tree_leaves(tree))
    for name, p in params.items():
        np.testing.assert_array_equal(p.numpy(), _leaf(tree, name))
    del tree["layers"][-1]["proj"]
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(tree, device="cpu", model=tt.model)
    tree["out"]["b"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shapes differ"):
        params_from_reference(tree, device="cpu", model=tt.model)


@pytest.mark.parametrize("model", MODELS)
def test_query_rows_are_full_rows(tasks, model):
    """Query blocks are the full forward's rows bit for bit, on every
    fused_kernel route."""
    rng = np.random.default_rng(0)
    for flat, dispatch in ((False, "single"), (False, "loop"), (True, "single")):
        _, tt, params = tasks(model, "imdb", flat)
        sess = tt.compile(FlowConfig("fused_kernel", prune_k=4, bucket_dispatch=dispatch))
        full = sess(params)
        for capacity in (1, 8, 64):
            idx = rng.integers(0, full.shape[0], size=capacity)
            assert torch.equal(sess.query(params, idx), full[torch.from_numpy(idx)])


def test_flat_tables_cached_on_device(tasks):
    """A flat graph's table is copied to the device once: a second forward
    reuses the cached tensors (the same objects) and adds no cache entry."""
    _, tt, params = tasks("simple_hgn", "acm", True)
    sess = tt.compile(FlowConfig("fused_kernel", prune_k=4))
    sess(params)
    first = {sg.name: dict(sg._device) for sg in tt.sgs}
    assert all(first.values()), "every flat graph caches its table"
    sess(params)
    for sg in tt.sgs:
        assert sg._device.keys() == first[sg.name].keys()
        for key, tables in sg._device.items():
            assert all(a is b for a, b in zip(tables, first[sg.name][key])), (sg.name, key)
