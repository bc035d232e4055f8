"""Port parity: the fused prune+aggregate op against the reference kernel.

On the CPU the port's ``fused_prune_aggregate_grouped`` runs the plain
versions of its CUDA kernels (``ref.py``). It is held against the
reference's grouped Pallas kernel, run as the reference's own tests run it
(``interpret=True``), on the parametrisations of the reference's grouped
kernel tests, at the reference's own kernel-vs-oracle tolerance (2e-5).

The tie tests pin the retention rule: the fused kernels evict the FIRST
minimum slot and insert only on a strictly greater score, which is not
``lax.top_k``'s rule; the port's fused path must follow the kernel, its
``staged_pruned`` path must follow ``top_k``.

The test marked ``cuda`` holds the CUDA kernels against the plain versions
on a card; it skips without one.
"""
import gc
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hetgraph as thg  # noqa: E402
from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ops as tops  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ref as tref  # noqa: E402

ATOL = 2e-5  # the reference's grouped kernel-vs-oracle tolerance


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


def _edges(rng, t, n, num_etypes=1, edges=600):
    src = rng.integers(0, n, size=edges).astype(np.int64)
    # heavy-tailed destination draw so every degree bucket gets targets
    dst = np.minimum((t * rng.random(edges) ** 3).astype(np.int64), t - 1)
    ety = rng.integers(0, num_etypes, size=edges).astype(np.int64)
    return src, dst, ety


def _bucketed(hg, src, dst, ety, t, d, caps, num_etypes=1):
    nbr, msk, et = hg._pad_csc(src, dst, t, d, np.random.default_rng(7), ety)
    return hg.bucketize("g", ("x",), "x", nbr, msk, et, caps, num_edge_types=num_etypes)


def _both(rng, t, d, n, caps, num_etypes=1, edges=600):
    """The same random bucketed graph built by the reference and the port."""
    from repro.core import hetgraph as jhg

    src, dst, ety = _edges(rng, t, n, num_etypes, edges)
    return (
        _bucketed(jhg, src, dst, ety, t, d, caps, num_etypes),
        _bucketed(thg, src, dst, ety, t, d, caps, num_etypes),
    )


def _run_both(sg_j, sg_t, hp, ts, td, prune_k, tr=None):
    import jax.numpy as jnp
    from repro.kernels.fused_prune_aggregate.ops import fused_prune_aggregate_grouped

    out_j = fused_prune_aggregate_grouped(
        jnp.asarray(hp), jnp.asarray(ts), jnp.asarray(td), sg_j,
        theta_rel=None if tr is None else jnp.asarray(tr), prune_k=prune_k,
    )
    out_t = tops.fused_prune_aggregate_grouped(
        torch.from_numpy(hp), torch.from_numpy(ts), torch.from_numpy(td), sg_t,
        theta_rel=None if tr is None else torch.from_numpy(tr), prune_k=prune_k,
    )
    return np.asarray(out_j), out_t.numpy()


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


GROUPED_CASES = (
    ((4, 8, 16), 6),  # multi-bucket, pruned + bypass mix
    ((5, 13), 7),  # capacities not multiples of the tile width 8
    ((64,), 6),  # one bucket covers everything
    ((4, 8), 100),  # all-bypass: every capacity <= K
    ((4, 8, 16), None),  # no pruning at all
)


@pytest.mark.parametrize("caps,k", GROUPED_CASES)
def test_grouped_matches_reference_kernel(caps, k):
    """The five grouped-kernel parametrisations of the reference's tests."""
    pytest.importorskip("jax")
    rng = np.random.default_rng(0)
    t, d, n, h, dh = 30, 40, 50, 4, 8
    sg_j, sg_t = _both(rng, t, d, n, caps)
    hp, ts, td = _normal(rng, n, h, dh), _normal(rng, n, h), _normal(rng, t, h)
    out_j, out_t = _run_both(sg_j, sg_t, hp, ts, td, k)
    assert out_t.shape == (t, h, dh)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_rel_term_matches_reference_kernel():
    pytest.importorskip("jax")
    rng = np.random.default_rng(1)
    t, d, n, h, dh, r = 24, 32, 40, 4, 8, 5
    sg_j, sg_t = _both(rng, t, d, n, (4, 12), num_etypes=r)
    hp, ts, td = _normal(rng, n, h, dh), _normal(rng, n, h), _normal(rng, t, h)
    tr = _normal(rng, r, h)
    out_j, out_t = _run_both(sg_j, sg_t, hp, ts, td, 6, tr=tr)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_empty_bucket_and_empty_graph():
    pytest.importorskip("jax")
    from repro.core import hetgraph as jhg

    rng = np.random.default_rng(2)
    n, h, dh = 30, 4, 8
    hp, ts = _normal(rng, n, h, dh), _normal(rng, n, h)
    sg_j, sg_t = _both(rng, 12, 16, n, (4, 8), edges=120)

    def with_empty(hg, sg):
        empty = hg.DegreeBucket(
            targets=np.zeros(0, np.int32),
            nbr_idx=np.zeros((0, 6), np.int32),
            nbr_mask=np.zeros((0, 6), bool),
            edge_type=np.zeros((0, 6), np.int32),
        )
        return hg.BucketedSemanticGraph(
            "e", ("x",), "x", sg.num_targets, (empty,) + sg.buckets
        )

    td = _normal(rng, 12, h)
    out_j, out_t = _run_both(
        with_empty(jhg, sg_j), with_empty(thg, sg_t), hp, ts, td, 5
    )
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)

    # zero-edge graph: every target degree 0 -> all-zero output
    z = [np.zeros((5, 1), np.int32), np.zeros((5, 1), bool), np.zeros((5, 1), np.int32)]
    td5 = _normal(rng, 5, h)
    out_j, out_t = _run_both(
        jhg.bucketize("z", ("x",), "x", *z, (2,)),
        thg.bucketize("z", ("x",), "x", *z, (2,)), hp, ts, td5, 3,
    )
    assert out_t.shape == (5, h, dh)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t, 0.0)

    # a graph with no buckets has no grid steps: zeros without a launch
    sg_none = thg.BucketedSemanticGraph("none", ("x",), "x", 5, ())
    assert sg_none.grouped(8, 8).num_steps == 0
    out_none = tops.fused_prune_aggregate_grouped(
        torch.from_numpy(hp), torch.from_numpy(ts), torch.from_numpy(td5), sg_none,
        prune_k=3,
    )
    assert out_none.shape == (5, h, dh) and torch.count_nonzero(out_none) == 0


def _tie_graph(hg):
    """One target whose candidates a, b, c (ids 0, 1, 2) arrive in that
    slot order, in a pruned bucket (capacity 3 > K = 2); a second target
    keeps the tile non-trivial."""
    nbr = np.array([[0, 1, 2], [3, 1, 0]], np.int32)
    msk = np.array([[True, True, True], [True, True, False]])
    return hg.bucketize("tie", ("x",), "x", nbr, msk, np.zeros_like(nbr), ())


def test_tie_follows_kernel_rule_not_top_k():
    """rank(a) = rank(b) < rank(c): the kernel puts a, b in slots 0, 1, then
    c evicts the first minimum, slot 0 — it keeps {b, c}; ``top_k`` keeps
    {a, c}. h'[a] != h'[b], so the outputs differ. The port follows the
    kernel."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import hetgraph as jhg
    from repro.kernels.fused_prune_aggregate.ref import fused_prune_aggregate_grouped_ref

    rng = np.random.default_rng(3)
    n, h, dh = 4, 4, 8
    ts = _normal(rng, n, h)
    ts[1] = ts[0]  # a and b tie, with distinct feature rows
    ts[2] = ts[0] + 1.0  # c ranks above both
    hp, td = _normal(rng, n, h, dh), _normal(rng, 2, h)
    sg_j, sg_t = _tie_graph(jhg), _tie_graph(thg)
    out_j, out_t = _run_both(sg_j, sg_t, hp, ts, td, 2)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)
    out_topk = np.asarray(fused_prune_aggregate_grouped_ref(
        jnp.asarray(hp), jnp.asarray(ts), jnp.asarray(td), sg_j, prune_k=2
    ))
    assert np.abs(out_topk[0] - out_j[0]).max() > 1e-2, "top_k oracle should differ"

    # the retained ids themselves: slots {1: b, 0: c}
    layout = sg_t.grouped(tops.T_TILE, tops.W_TILE)
    (nbr, msk, ety, rt, _), (blk, k_s) = tops._layout_device(layout, 2, torch.device("cpu"))
    _, ids = tref.prune_plain(
        nbr, msk, None, torch.from_numpy(ts), None, torch.from_numpy(td), rt,
        blk, k_s, 0.2,
    )
    assert ids[layout.perm[0]].tolist() == [2, 1]


def test_min_replace_matches_reference_rule():
    """The torch min_replace step equals the reference's on integer-valued
    domains full of ties, and [1, 1, 2] at K = 2 keeps slots {1, 2}."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import common as jcommon

    rng = np.random.default_rng(4)
    rd = rng.integers(0, 4, size=(64, 6)).astype(np.float32)
    aux = rng.integers(0, 100, size=(64, 6)).astype(np.int32)
    cur = rng.integers(0, 5, size=64).astype(np.float32)
    cur_aux = rng.integers(100, 200, size=64).astype(np.int32)
    jv, (ja,) = jcommon.min_replace(
        jnp.asarray(rd), [(jnp.asarray(aux), jnp.asarray(cur_aux))], jnp.asarray(cur), None
    )
    tv, (ta,) = tcommon.min_replace(
        torch.from_numpy(rd), [(torch.from_numpy(aux), torch.from_numpy(cur_aux))],
        torch.from_numpy(cur),
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))

    vals = torch.full((1, 2), tcommon.NEG)
    ids = torch.full((1, 2), -1)
    for slot, score in enumerate([1.0, 1.0, 2.0]):
        vals, (ids,) = tcommon.min_replace(
            vals, [(ids, torch.tensor([slot]))], torch.tensor([score])
        )
    assert sorted(ids[0].tolist()) == [1, 2]


@pytest.mark.parametrize("k", (1, 3, 5, 11))
def test_topk_keep_mask_ties_follow_top_k(k):
    """staged_pruned's keep mask follows ``top_k`` on scores full of ties."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import pruning as jpruning

    rng = np.random.default_rng(5)
    scores = rng.integers(0, 3, size=(40, 12)).astype(np.float32)
    mask = rng.random((40, 12)) < 0.8
    want = np.asarray(jpruning.topk_keep_mask(jnp.asarray(scores), jnp.asarray(mask), k))
    got = tpruning.topk_keep_mask(torch.from_numpy(scores), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_cpu_only_and_uncounted():
    """CPU tensors run the plain versions and count no launch; tensors on
    any other non-CUDA device raise."""
    rng = np.random.default_rng(6)
    src, dst, ety = _edges(rng, 20, 30)
    sg = _bucketed(thg, src, dst, ety, 20, 24, (4, 8))
    hp, ts, td = _normal(rng, 30, 4, 8), _normal(rng, 30, 4), _normal(rng, 20, 4)
    before = dict(tops.LAUNCHES)
    tops.fused_prune_aggregate_grouped(
        torch.from_numpy(hp), torch.from_numpy(ts), torch.from_numpy(td), sg, prune_k=3
    )
    assert tops.LAUNCHES == before
    meta_dev = torch.device("meta")
    with pytest.raises(ValueError, match="kernels run on CUDA tensors"):
        tops.aggregate(
            torch.empty((8, 4, 4), device=meta_dev), torch.empty((8, 4), device=meta_dev),
            torch.empty((30, 4, 8), device=meta_dev), torch.zeros((4, 1), dtype=torch.int32),
        )


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("caps,k", (((4, 8, 16), 6), ((4, 8), 100), ((4, 8, 16), None)))
def test_cuda_kernels_match_plain(cuda_device, caps, k):
    rng = np.random.default_rng(0)
    t, d, n, h, dh = 30, 40, 50, 4, 8
    src, dst, ety = _edges(rng, t, n)
    sg = _bucketed(thg, src, dst, ety, t, d, caps)
    layout = sg.grouped(tops.T_TILE, tops.W_TILE)
    (nbr, msk, _, rt, _), (blk, k_s) = tops._layout_device(layout, k, cuda_device)
    hp = torch.from_numpy(_normal(rng, n, h, dh)).to(cuda_device)
    ts = torch.from_numpy(_normal(rng, n, h)).to(cuda_device)
    td = torch.from_numpy(_normal(rng, t, h)).to(cuda_device)
    a_k, i_k = tops.prune(nbr, msk, None, ts, None, td, rt, blk, k_s)
    a_p, i_p = tref.prune_plain(nbr, msk, None, ts, None, td, rt, blk, k_s, 0.2)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(a_k, a_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(
        tops.aggregate(a_p, i_p, hp, blk), tref.aggregate_plain(a_p, i_p, hp, blk),
        atol=1e-5, rtol=0,
    )
