"""Port parity: the fused prune+aggregate op against the reference kernel.

On the CPU the port's ``fused_prune_aggregate_grouped`` and flat
``fused_prune_aggregate`` run the plain versions of their CUDA kernels
(``ref.py``). They are held against the reference's grouped and flat
Pallas kernels, run as the reference's own tests run them
(``interpret=True``), on the parametrisations of the reference's kernel
tests, at the reference's own kernel-vs-oracle tolerance (2e-5).

The tie tests pin the retention rules: the fused kernels evict the FIRST
minimum slot and insert only on a strictly greater score, which is not
``lax.top_k``'s rule; the port's ``fused_kernel`` path must follow the
kernel, its ``staged_pruned`` path ``top_k``, and its ``fused`` scan
emulation ``top_k`` over [domain, tile] as the reference's does.

The fused step wrappers ``prune_aggregate`` and ``flat_prune_aggregate``
(one launch: K1, then K2's aggregation in the same warp) must return what
their pair of step wrappers returns, bit for bit.

The tests marked ``cuda`` hold the CUDA kernels against the plain versions,
and each fused launch against its kernel pair, on a card; they skip without
one.
"""
import gc
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import attention as tattention  # noqa: E402
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


# --- the CUDA K1s' retention domains, emulated in numpy --------------------

# k_s the layout gets: (caps, prune_k, targets, sources, edges); pruned and
# bypass buckets; k_s 8 by a bypass bucket's w-aligned capacity, so the
# pruned rows park slots 7 and 8 at POS; k_s 33 and 256 past a warp's width
# (registers); 257, 300 and 528 past 256 (shared memory), 528 with a bypass
# bucket of capacity 300 in it
KS_CASES = {
    1: ((4, 8, 16), 1, 30, 50, 600),
    8: ((5, 13), 7, 30, 50, 600),
    32: ((8, 32, 64), 32, 30, 50, 600),
    33: ((8, 16, 64), 33, 30, 50, 600),
    256: ((8, 64, 400), 256, 20, 600, 4000),
    257: ((8, 64, 400), 257, 40, 600, 6000),
    300: ((8, 64, 400), 300, 40, 600, 6000),
    528: ((8, 300, 600), 528, 20, 600, 6000),
}


def _ks_graph(rng, k_s):
    """A heavy-tailed random bucketed graph for ``KS_CASES[k_s]``: (graph,
    prune_k, N); k_s 256 and above need rows of degree above 256."""
    caps, k, t, n, edges = KS_CASES[k_s]
    src, dst, ety = _edges(rng, t, n, num_etypes=3, edges=edges)
    return _bucketed(thg, src, dst, ety, t, max(caps) + 8, caps, num_etypes=3), k, n


def _order_key(v):
    u = np.ascontiguousarray(v, np.float32).view(np.uint32).copy()
    u[(u & np.uint32(0x7FFFFFFF)) == 0] = 0
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _reg_first_min(rk, k_s):
    """The domain's first minimum, in registers or in shared memory alike:
    lane l holds slots l, l+32, ...; each lane's least key (its lowest slot
    among equals), then __reduce_min_sync over the lanes on the key, then on
    the slot among lanes holding that key."""
    key = _order_key(rk)
    lk, ls = [], []
    for lane in range(32):
        slots = np.arange(lane, k_s, 32)
        if len(slots):
            j = int(np.argmin(key[slots]))
            lk.append(int(key[slots[j]]))
            ls.append(int(slots[j]))
        else:
            lk.append(0xFFFFFFFF)
            ls.append(k_s)
    mk = min(lk)
    mi = min(sl for kl, sl in zip(lk, ls) if kl == mk)
    return rk[mi], mi


def _rank(ts, tr, i, e):
    """A candidate's rank: the left-to-right float32 head sum of θ_u*[i]
    (+ θ_rel[e])."""
    r = np.float32(0)
    for hh in range(ts.shape[1]):
        x = ts[i, hh] if tr is None else np.float32(ts[i, hh] + tr[e, hh])
        r = x if hh == 0 else np.float32(r + x)
    return r


def _nth_set_bit(m, n):
    return [i for i in range(32) if m >> i & 1][n]


class _Domain:
    """One warp's retention domain as the CUDA K1s keep it: k_s ranks, ids
    and edge types, slots >= k_eff parked at POS. ``fill`` is the flat K1's
    and the grouped shared-memory path's insert_batch (the first
    candidates ranked above NEG fill the empty slots in lane order); without
    it every candidate goes through the chain, as on the grouped register
    path."""

    def __init__(self, k_s, k_eff, fill):
        f32 = np.float32
        self.k_s, self.k_eff = k_s, k_eff
        self.rk = np.where(np.arange(k_s) < k_eff, f32(tcommon.NEG), f32(tcommon.POS)).astype(f32)
        self.rid = np.full(k_s, -1, np.int64)
        self.rety = np.zeros(k_s, np.int64)
        self.filled = 0 if fill else k_eff
        self.mv, self.mi = (f32(tcommon.NEG), 0) if fill else _reg_first_min(self.rk, k_s)

    def put(self, s, r, i, e):
        self.rk[s], self.rid[s], self.rety[s] = r, i, e

    def insert(self, cr, cid, ce):
        """One batch of candidates, one a lane (lane order = slot order)."""
        ins = [lane for lane in range(len(cr)) if cr[lane] > tcommon.NEG]
        if self.filled < self.k_eff and ins:
            fit = min(len(ins), self.k_eff - self.filled)
            ballot = sum(1 << lane for lane in ins)
            for s in range(self.filled, self.filled + fit):
                src = _nth_set_bit(ballot, s - self.filled)
                self.put(s, cr[src], cid[src], ce[src])
            ins = ins[fit:]
            self.filled += fit
            if self.filled == self.k_eff:
                self.mv, self.mi = _reg_first_min(self.rk, self.k_s)
        live = [lane for lane in ins if cr[lane] > self.mv]  # the ballot filter
        while live:
            lane = live.pop(0)
            if cr[lane] > self.mv:
                self.put(self.mi, cr[lane], cid[lane], ce[lane])
                self.mv, self.mi = _reg_first_min(self.rk, self.k_s)
                live = [x for x in live if cr[x] > self.mv]


def _grouped_k1_emulation(nbr, msk, ety, ts, tr, blk, k_s):
    """The CUDA grouped K1 for every grouped row, step for step: the
    register domain (k_s <= 256, the chain from the start) or the
    shared-memory domain (the fill, then the chain), both finding the first
    minimum the same way; slots >= k_eff parked at POS, the rank as its
    left-to-right head sum, the bypass copy, the exact ballot filter per
    D-tile with the first minimum found again only after an insert.
    Returns the domain's ranks, ids and edge types."""
    _, t_tile, w = nbr.shape
    n_blocks = blk.shape[1]
    rows = n_blocks * t_tile
    rd_rank = np.zeros((rows, k_s), np.float32)
    rd_id = np.full((rows, k_s), -1, np.int64)
    rd_ety = np.zeros((rows, k_s), np.int64)
    for b in range(n_blocks):
        first, n_dt, bypass, k_eff = (int(x) for x in blk[:, b])
        for y in range(t_tile):
            dom = _Domain(k_s, k_eff, fill=k_s > 256)
            for dt in range(n_dt):
                step = first + dt
                valid = msk[step, y]
                cid = np.where(valid, nbr[step, y], -1)
                ce = np.where(valid, ety[step, y], 0) if tr is not None else np.zeros(w, np.int64)
                cr = [_rank(ts, tr, cid[j], ce[j]) if valid[j] else np.float32(tcommon.NEG) for j in range(w)]
                if bypass:
                    for j in range(w):
                        dom.put(dt * w + j, cr[j], cid[j], ce[j])
                else:
                    dom.insert(cr, cid, ce)
            rd_rank[b * t_tile + y], rd_id[b * t_tile + y], rd_ety[b * t_tile + y] = dom.rk, dom.rid, dom.rety
    return rd_rank, rd_id, rd_ety


@pytest.mark.parametrize("k_s", sorted(KS_CASES))
def test_grouped_register_domain_emulation_matches_plain(k_s):
    """The grouped K1's domain and ballot filter
    (csrc/fused_prune_aggregate.cu), emulated in numpy, keep the ids of
    ``prune_plain`` slot for slot, α within 1e-6, on tie-heavy ranks (small
    integers, with a relation term) at k_s 1, 8, 32, 33 and 256 (the
    register domain) and 257, 300 and 528 (the shared-memory domain), on a
    mix of pruned and bypass buckets with slots parked at POS."""
    rng = np.random.default_rng(k_s)
    sg, k, n = _ks_graph(rng, k_s)
    h = 4
    ts = rng.integers(-1, 2, size=(n, h)).astype(np.float32)
    tr = rng.integers(-1, 2, size=(3, h)).astype(np.float32)
    td = _normal(rng, sg.num_targets, h)
    layout = sg.grouped(tops.T_TILE, tops.W_TILE)
    (nbr, msk, ety, rt, _), (blk, got_ks) = tops._layout_device(layout, k, torch.device("cpu"))
    assert got_ks == k_s
    bypass = blk[2].numpy()
    assert bypass.any() == (k_s > 2) and not bypass.all()
    args = (nbr, msk, ety, torch.from_numpy(ts), torch.from_numpy(tr), torch.from_numpy(td), rt, blk)
    a_p, i_p = tref.prune_plain(*args, k_s, 0.2)
    rd_rank, rd_id, rd_ety = _grouped_k1_emulation(
        nbr.numpy(), msk.numpy(), ety.numpy(), ts, tr, blk.numpy(), k_s
    )
    k_row = blk[3].long().repeat_interleave(tops.T_TILE)
    ok = torch.from_numpy(rd_rank > tcommon.NEG / 2) & (torch.arange(k_s)[None, :] < k_row[:, None])
    a_e, i_e = tref._flush(
        ok, torch.from_numpy(rd_id), torch.from_numpy(rd_ety), torch.from_numpy(ts),
        torch.from_numpy(tr), torch.from_numpy(td)[rt.long()], 0.2,
    )
    assert torch.equal(i_e, i_p)
    torch.testing.assert_close(a_e, a_p, atol=1e-6, rtol=0)


SEG = 256  # slots of a flat row the CUDA flat K1 compacts at once


def _warp_sum(part):
    """A float32 sum over the 32 lanes as the kernels take it: five
    __shfl_xor_sync butterfly steps (each lane adds its partner's)."""
    part = list(part)
    for off in (16, 8, 4, 2, 1):
        part = [np.float32(part[lane] + part[lane ^ off]) for lane in range(32)]
    return part[0]


def _flat_k1_emulation(nbr, msk, ety, ts, tr, td, k, slope=0.2):
    """The CUDA flat K1 for every row, step for step: segments of SEG slots,
    the valid slots compacted in slot order (ballot + prefix counts), the
    listed candidates 32 at a time with the rank as its left-to-right head
    sum; while the domain has empty slots the candidates ranked above NEG
    fill them in lane order, then the ballot filter and the chain (first
    minimum found again only after an insert); then the flush per head:
    LeakyReLU, maximum, each lane's sum of exp over its slots in order, the
    butterfly sum, alpha. Returns alpha (T, k, H) and ids (T, k)."""
    f32 = np.float32
    t, d = nbr.shape
    h = ts.shape[1]
    neg, slope = f32(tcommon.NEG), f32(slope)
    alpha = np.zeros((t, k, h), f32)
    ids = np.full((t, k), -1, np.int32)
    for row in range(t):
        dom = _Domain(k, k, fill=True)
        for seg in range(0, d, SEG):
            listed = []
            for c in range(SEG // 32):  # one ballot a chunk, prefix counts
                chunk = [seg + 32 * c + lane for lane in range(32)]
                listed += [j for j in chunk if j < d and msk[row, j]]
            for q in range(0, len(listed), 32):
                batch = listed[q:q + 32]
                cid = [int(nbr[row, j]) for j in batch]
                ce = [int(ety[row, j]) if tr is not None else 0 for j in batch]
                dom.insert([_rank(ts, tr, i, e) for i, e in zip(cid, ce)], cid, ce)
        rk, rid, rety = dom.rk, dom.rid, dom.rety
        ok = rk > neg * f32(0.5)
        for hh in range(h):
            logit = np.zeros(k, f32)
            for s in np.flatnonzero(ok):
                x = ts[rid[s], hh] if tr is None else f32(ts[rid[s], hh] + tr[rety[s], hh])
                x = f32(x + td[row, hh])
                logit[s] = x if x >= 0 else f32(slope * x)
            mx = max([neg] + [logit[s] for s in np.flatnonzero(ok)])
            ex = np.exp(np.where(ok, logit - mx, f32(0)), dtype=f32)
            part = [f32(0)] * 32
            for lane in range(32):
                for s in range(lane, k, 32):
                    if ok[s]:
                        part[lane] = f32(part[lane] + ex[s])
            alpha[row, :, hh] = np.where(ok, ex / f32(_warp_sum(part) + f32(1e-30)), f32(0))
        ids[row] = np.where(ok, rid, -1)
    return alpha, ids


def _special_theta(rng, n, h):
    """Tie-heavy integer θ_u* with rows ranking NaN, -inf, in the NEG band
    (-2.5e38: it takes a slot but is flushed as empty), -0.0, +0.0 and
    below NEG."""
    ts = rng.integers(-1, 2, size=(n, h)).astype(np.float32)
    ts[0] = np.nan
    ts[1] = -np.inf
    ts[2] = 0.0
    ts[2, 0] = -2.5e38
    ts[3] = -0.0
    ts[4] = 0.0
    ts[5] = 0.0
    ts[5, 0] = -3.4e38
    return ts


@pytest.mark.parametrize("k", (1, 8, 32, 33, 256, 257, 300, 528))
def test_flat_k1_emulation_matches_plain(k):
    """The flat K1 (csrc/fused_prune_aggregate.cu: compaction, fill, ballot
    filter and chain, flush), emulated in numpy, keeps the ids of
    ``flat_prune_plain`` slot for slot, α within 1e-6, on tie-heavy
    integer ranks with a relation term and rows whose candidates rank NaN,
    -inf, in the NEG band, ±0.0 and below NEG; with an empty row, a row of
    fewer valid slots than k and rows that run the chain, over more than
    one SEG segment, in registers (k <= 256) and in shared memory."""
    rng = np.random.default_rng(100 + k)
    t, d, n, h, r = 6, max(k + 60, SEG + 44), 40, 4, 3
    nbr = rng.integers(0, n, size=(t, d)).astype(np.int32)
    msk = rng.random((t, d)) < 0.85
    msk[1] = False
    msk[2, k // 2:] = False
    ety = rng.integers(0, r, size=(t, d)).astype(np.int32)
    ts, tr = _special_theta(rng, n, h), rng.integers(-1, 2, size=(r, h)).astype(np.float32)
    td = _normal(rng, t, h)
    a_e, i_e = _flat_k1_emulation(nbr, msk, ety, ts, tr, td, k)
    a_p, i_p = tref.flat_prune_plain(
        *(torch.from_numpy(x) for x in (nbr, msk, ety, ts, tr, td)), k, 0.2
    )
    np.testing.assert_array_equal(i_e, i_p.numpy())
    np.testing.assert_allclose(a_e, a_p.numpy(), atol=1e-6, rtol=0)
    assert (i_e[1] == -1).all() and (i_e[2] >= 0).sum() <= k // 2


FLAT_SWEEP = ((11, 70, 8, 8, 200, 5), (8, 128, 8, 8, 64, 50), (5, 33, 4, 16, 40, 33), (2, 7, 2, 4, 10, 3))


def _flat_inputs(rng, t, d, h, dh, n, r=0, p_valid=0.85):
    """The reference's flat-kernel test inputs: random ids, a random mask
    with holes (not left-packed), optional edge types."""
    hp, ts, td = _normal(rng, n, h, dh), _normal(rng, n, h), _normal(rng, t, h)
    idx = rng.integers(0, n, size=(t, d)).astype(np.int32)
    msk = rng.random((t, d)) < p_valid
    if not r:
        return hp, ts, td, idx, msk, None, None
    tr = _normal(rng, r, h)
    ety = rng.integers(0, r, size=(t, d)).astype(np.int32)
    return hp, ts, td, idx, msk, tr, ety


def _flat_both(hp, ts, td, idx, msk, tr, ety, k):
    import jax.numpy as jnp
    from repro.kernels.fused_prune_aggregate.ops import fused_prune_aggregate

    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    out_j = fused_prune_aggregate(
        jnp.asarray(hp), jnp.asarray(ts), jnp.asarray(td), jnp.asarray(idx),
        jnp.asarray(msk), theta_rel=opt(tr, jnp.asarray), edge_type=opt(ety, jnp.asarray),
        prune_k=k,
    )
    out_t = tops.fused_prune_aggregate(
        torch.from_numpy(hp), torch.from_numpy(ts), torch.from_numpy(td),
        torch.from_numpy(idx), torch.from_numpy(msk),
        theta_rel=opt(tr, torch.from_numpy), edge_type=opt(ety, torch.from_numpy),
        prune_k=k,
    )
    return np.asarray(out_j), out_t.numpy()


@pytest.mark.parametrize("t,d,h,dh,n,k", FLAT_SWEEP)
def test_flat_matches_reference_kernel(t, d, h, dh, n, k):
    """The flat op against the flat Pallas kernel on the reference's sweep
    shapes (random masks with holes; the Pallas kernel pads T to 8 and D
    to 128, the port does not)."""
    pytest.importorskip("jax")
    rng = np.random.default_rng(10 + t)
    out_j, out_t = _flat_both(*_flat_inputs(rng, t, d, h, dh, n), k)
    assert out_t.shape == (t, h, dh)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


@pytest.mark.parametrize("k", (257, 300))
def test_flat_wide_domain_matches_reference_kernel(k):
    """Domains past the CUDA K1's 256 register slots: the flat op against
    the flat Pallas kernel, whose scratch is sized by K."""
    pytest.importorskip("jax")
    rng = np.random.default_rng(k)
    out_j, out_t = _flat_both(*_flat_inputs(rng, 5, 340, 4, 8, 300, r=3), k)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


@pytest.mark.parametrize("k_s", (257, 300))
def test_grouped_wide_domain_matches_reference_kernel(k_s):
    """The grouped op against the grouped Pallas kernel at k_s 257 and 300
    (a pruned bucket of capacity 400 beside a bypass bucket), past the CUDA
    K1's 256 register slots."""
    pytest.importorskip("jax")
    caps, k, t, n, edges = KS_CASES[k_s]
    rng = np.random.default_rng(k_s)
    sg_j, sg_t = _both(rng, t, max(caps) + 8, n, caps, edges=edges)
    assert tops.grouped_meta(sg_t.grouped(tops.T_TILE, tops.W_TILE), k)[2] == k_s
    hp, ts, td = _normal(rng, n, 4, 8), _normal(rng, n, 4), _normal(rng, t, 4)
    out_j, out_t = _run_both(sg_j, sg_t, hp, ts, td, k)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_flat_rel_term_matches_reference_kernel():
    pytest.importorskip("jax")
    rng = np.random.default_rng(11)
    out_j, out_t = _flat_both(*_flat_inputs(rng, 6, 40, 4, 8, 50, r=5, p_valid=0.9), 8)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_flat_edges_and_launch_accounting():
    """k = D (no pruning), an empty row and a table with no rows, against
    the reference where it has one; CPU tensors count no launch."""
    pytest.importorskip("jax")
    rng = np.random.default_rng(12)
    hp, ts, td, idx, msk, _, _ = _flat_inputs(rng, 9, 20, 4, 8, 30)
    msk[3] = False  # a row with no valid slot: zeros
    before = dict(tops.LAUNCHES)
    for k in (None, 20, 6):
        out_j, out_t = _flat_both(hp, ts, td, idx, msk, None, None, k)
        np.testing.assert_allclose(out_t, out_j, atol=ATOL)
        np.testing.assert_array_equal(out_t[3], 0.0)
    empty = tops.fused_prune_aggregate(
        torch.from_numpy(hp), torch.from_numpy(ts), torch.zeros((0, 4)),
        torch.zeros((0, 5), dtype=torch.int32), torch.zeros((0, 5), dtype=torch.bool),
        prune_k=3,
    )
    assert tuple(empty.shape) == (0, 4, 8)
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError, match="no retention slot"):
        tops.fused_prune_aggregate(
            torch.from_numpy(hp), torch.from_numpy(ts), torch.from_numpy(td),
            torch.from_numpy(idx), torch.from_numpy(msk), prune_k=0,
        )


def test_flat_tie_follows_kernel_rule_not_top_k():
    """Scores [1, 1, 2] at k = 2 in one flat row: the flat kernel keeps
    {b, c} (ids [c, b] in slots 0, 1), the reference's Pallas kernel agrees,
    and the ``top_k`` oracle, which keeps {a, c}, differs."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.fused_prune_aggregate.ref import fused_prune_aggregate_ref

    rng = np.random.default_rng(13)
    n, h, dh = 4, 4, 8
    ts = _normal(rng, n, h)
    ts[1] = ts[0]
    ts[2] = ts[0] + 1.0
    hp, td = _normal(rng, n, h, dh), _normal(rng, 2, h)
    idx = np.array([[0, 1, 2], [3, 1, 0]], np.int32)
    msk = np.array([[True, True, True], [True, True, False]])
    out_j, out_t = _flat_both(hp, ts, td, idx, msk, None, None, 2)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)
    out_topk = np.asarray(fused_prune_aggregate_ref(
        jnp.asarray(ts[idx]), jnp.asarray(msk), jnp.asarray(td), jnp.asarray(idx),
        jnp.asarray(hp), 2,
    ))
    assert np.abs(out_topk[0] - out_j[0]).max() > 1e-2, "top_k oracle should differ"
    _, ids = tref.flat_prune_plain(
        torch.from_numpy(idx), torch.from_numpy(msk), None, torch.from_numpy(ts), None,
        torch.from_numpy(td), 2, 0.2,
    )
    assert ids[0].tolist() == [2, 1]


@pytest.mark.parametrize("tile", (1, 3, 8))
def test_fused_emulation_ties_follow_reference(tile):
    """On integer-valued scores full of ties, the port's ``fused`` flow
    equals the reference's scan emulation ``aggregate_fused`` for several
    tile widths, and so does ``staged_pruned`` (``top_k`` over [domain,
    tile] keeps the whole row's lower-index ``top_k`` set, since the domain
    holds earlier slots than the tile); the kernel rule keeps another set
    on these inputs."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import attention as jattention

    from repro_torch.core import flows as tflows

    rng = np.random.default_rng(14)
    t, d, h, dh, n, k = 16, 12, 4, 8, 20, 3
    hp = _normal(rng, n, h, dh)
    ts = rng.integers(0, 2, size=(n, h)).astype(np.float32)
    td = _normal(rng, t, h)
    idx = rng.integers(0, n, size=(t, d)).astype(np.int32)
    msk = rng.random((t, d)) < 0.8
    jargs = (
        jnp.asarray(hp), jattention.DecomposedScores(jnp.asarray(ts), jnp.asarray(td)),
        jnp.asarray(idx), jnp.asarray(msk),
    )
    want = np.asarray(jattention.aggregate_fused(*jargs, prune_k=k, tile=tile))
    want_staged = np.asarray(jattention.aggregate_staged(*jargs, prune_k=k))
    np.testing.assert_allclose(want_staged, want, atol=ATOL)
    sc = tattention.DecomposedScores(torch.from_numpy(ts), torch.from_numpy(td))
    args = (torch.from_numpy(hp), sc, torch.from_numpy(idx), torch.from_numpy(msk))
    got = tflows.run_aggregate(tflows.FlowConfig("fused", prune_k=k), *args).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    staged = tattention.aggregate_staged(*args, prune_k=k).numpy()
    np.testing.assert_allclose(staged, want, atol=ATOL)
    kernel_rule = tflows.run_aggregate(
        tflows.FlowConfig("fused_kernel", prune_k=k), *args
    ).numpy()
    assert np.abs(kernel_rule - got).max() > 1e-2, "the kernel rule should differ on ties"


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so that equal NaNs compare equal."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


def _flat_step_inputs(rng, k, rel, device="cpu"):
    """A flat table for the fused step at width k: tie-heavy integer ranks
    with NaN, -inf, NEG-band and ±0.0 rows, an empty row, a row of fewer
    valid slots than k, more than one SEG segment."""
    t, d, n, h, dh, r = 6, max(k + 60, SEG + 44), 40, 4, 8, 3
    nbr = rng.integers(0, n, size=(t, d)).astype(np.int32)
    msk = rng.random((t, d)) < 0.85
    msk[1] = False
    msk[2, k // 2:] = False
    ety = rng.integers(0, r, size=(t, d)).astype(np.int32)
    ts, tr = _special_theta(rng, n, h), rng.integers(-1, 2, size=(r, h)).astype(np.float32)
    arrays = (nbr, msk, ety if rel else None, ts, tr if rel else None, _normal(rng, t, h), _normal(rng, n, h, dh))
    return tuple(None if a is None else torch.from_numpy(a).to(device) for a in arrays)


@pytest.mark.parametrize("rel", (False, True))
@pytest.mark.parametrize("k", (1, 8, 33, 257, 528))
def test_flat_prune_aggregate_is_the_pair(k, rel):
    """On CPU tensors ``flat_prune_aggregate`` returns exactly
    ``flat_aggregate(*flat_prune(...))`` with ``flat_prune``'s alpha and ids
    (``keep=True``), and that output alone without it; no launch is
    counted under any key."""
    nbr, msk, ety, ts, tr, td, hp = _flat_step_inputs(np.random.default_rng(200 + k), k, rel)
    before = dict(tops.LAUNCHES)
    out, alpha, ids = tops.flat_prune_aggregate(nbr, msk, ety, ts, tr, td, hp, k, keep=True)
    a_pair, i_pair = tops.flat_prune(nbr, msk, ety, ts, tr, td, k)
    o_pair = tops.flat_aggregate(a_pair, i_pair, hp)
    assert _same_bits((out, alpha, ids), (o_pair, a_pair, i_pair))
    assert _same_bits((tops.flat_prune_aggregate(nbr, msk, ety, ts, tr, td, hp, k),), (o_pair,))
    assert tops.LAUNCHES == before and len(before) == 6
    assert (ids[1] == -1).all() and not out[1].any()


@pytest.mark.parametrize("k_s", sorted(KS_CASES))
def test_prune_aggregate_is_the_pair(k_s):
    """On CPU tensors ``prune_aggregate`` returns exactly
    ``aggregate(*prune(...))`` with ``prune``'s alpha and ids, at the
    grouped K1's widths (register and shared-memory domains), on pruned and
    bypass buckets with a relation term; no launch is counted."""
    rng = np.random.default_rng(300 + k_s)
    sg, k, n = _ks_graph(rng, k_s)
    h, dh = 4, 8
    layout = sg.grouped(tops.T_TILE, tops.W_TILE)
    (nbr, msk, ety, rt, _), (blk, got_ks) = tops._layout_device(layout, k, torch.device("cpu"))
    assert got_ks == k_s
    ts = torch.from_numpy(rng.integers(-1, 2, size=(n, h)).astype(np.float32))
    tr = torch.from_numpy(rng.integers(-1, 2, size=(3, h)).astype(np.float32))
    td = torch.from_numpy(_normal(rng, sg.num_targets, h))
    hp = torch.from_numpy(_normal(rng, n, h, dh))
    args = (nbr, msk, ety, ts, tr, td, rt, blk, k_s)
    before = dict(tops.LAUNCHES)
    got = tops.prune_aggregate(*args, hp, keep=True)
    a_pair, i_pair = tops.prune(*args)
    o_pair = tops.aggregate(a_pair, i_pair, hp, blk)
    assert _same_bits(got, (o_pair, a_pair, i_pair))
    assert _same_bits((tops.prune_aggregate(*args, hp),), (o_pair,))
    assert tops.LAUNCHES == before


def test_na_ops_run_one_fused_step(monkeypatch):
    """``fused_prune_aggregate_grouped`` and ``fused_prune_aggregate`` each
    run their fused step wrapper once and no K1 or K2 step wrapper."""
    calls = []
    for name in ("prune", "aggregate", "flat_prune", "flat_aggregate", "prune_aggregate",
                 "flat_prune_aggregate"):
        real = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    rng = np.random.default_rng(15)
    src, dst, ety = _edges(rng, 20, 30)
    sg = _bucketed(thg, src, dst, ety, 20, 24, (4, 8))
    hp, ts, td = (torch.from_numpy(a) for a in (_normal(rng, 30, 4, 8), _normal(rng, 30, 4), _normal(rng, 20, 4)))
    out = tops.fused_prune_aggregate_grouped(hp, ts, td, sg, prune_k=3)
    assert calls == ["prune_aggregate"] and out.shape == (20, 4, 8)
    calls.clear()
    idx = torch.from_numpy(rng.integers(0, 30, size=(20, 12)).astype(np.int32))
    out = tops.fused_prune_aggregate(hp, ts, td, idx, torch.ones((20, 12), dtype=torch.bool), prune_k=3)
    assert calls == ["flat_prune_aggregate"] and out.shape == (20, 4, 8)


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


@pytest.mark.cuda
@pytest.mark.parametrize("k_s", (1, 8, 32, 33, 256, 257, 300, 528))
def test_cuda_register_domain_matches_plain(cuda_device, k_s):
    """The grouped K1 at the widths of its register domain and, past 256,
    its shared-memory domain, on tie-heavy ranks with a relation term,
    pruned and bypass buckets."""
    rng = np.random.default_rng(k_s)
    sg, k, n = _ks_graph(rng, k_s)
    h = 4
    layout = sg.grouped(tops.T_TILE, tops.W_TILE)
    (nbr, msk, ety, rt, _), (blk, got_ks) = tops._layout_device(layout, k, cuda_device)
    assert got_ks == k_s
    ts = torch.from_numpy(rng.integers(-1, 2, size=(n, h)).astype(np.float32)).to(cuda_device)
    tr = torch.from_numpy(rng.integers(-1, 2, size=(3, h)).astype(np.float32)).to(cuda_device)
    td = torch.from_numpy(_normal(rng, sg.num_targets, h)).to(cuda_device)
    a_k, i_k = tops.prune(nbr, msk, ety, ts, tr, td, rt, blk, k_s)
    a_p, i_p = tref.prune_plain(nbr, msk, ety, ts, tr, td, rt, blk, k_s, 0.2)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(a_k, a_p, atol=1e-6, rtol=0)


# past 256 slots the domain is in shared memory; the last at the budget
FLAT_WIDE = ((9, 300, 8, 8, 50, 256), (5, 300, 4, 8, 60, 257), (5, 340, 8, 8, 60, 300),
             (4, 600, 4, 8, 80, 528), (2, tops.MAX_KS + 3000, 4, 8, 30000, tops.MAX_KS))


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,h,dh,n,k", FLAT_SWEEP + FLAT_WIDE)
def test_cuda_flat_kernels_match_plain(cuda_device, t, d, h, dh, n, k):
    rng = np.random.default_rng(t)
    hp, ts, td, idx, msk, tr, ety = (
        None if a is None else torch.from_numpy(a).to(cuda_device)
        for a in _flat_inputs(rng, t, d, h, dh, n, r=3)
    )
    a_k, i_k = tops.flat_prune(idx, msk, ety, ts, tr, td, k)
    a_p, i_p = tref.flat_prune_plain(idx, msk, ety, ts, tr, td, k, 0.2)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(a_k, a_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(
        tops.flat_aggregate(a_p, i_p, hp), tref.flat_aggregate_plain(a_p, i_p, hp),
        atol=1e-5, rtol=0,
    )
    with pytest.raises(ValueError, match="domain width"):
        tops.flat_prune(idx, msk, ety, ts, tr, td, tops.MAX_KS + 1)


def _launches_of(fn):
    """``fn()``'s result and the launches it counted, by key."""
    before = dict(tops.LAUNCHES)
    got = fn()
    torch.cuda.synchronize()
    return got, {key: n - before[key] for key, n in tops.LAUNCHES.items() if n != before[key]}


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,h,dh,n,k", FLAT_SWEEP + FLAT_WIDE)
def test_cuda_flat_prune_aggregate_is_the_pair(cuda_device, t, d, h, dh, n, k):
    """The fused flat launch against the kernel pair on the same inputs,
    bit for bit: out, alpha and ids with ``keep=True``, and out alone (the
    serving call) without; one launch under ``flat_prune_aggregate`` and
    none under the step keys. h'[0] holds an inf, which empty slots must
    carry into the output as K2 does."""
    rng = np.random.default_rng(t)
    hp, ts, td, idx, msk, tr, ety = (
        None if a is None else torch.from_numpy(a).to(cuda_device)
        for a in _flat_inputs(rng, t, d, h, dh, n, r=3)
    )
    hp[0, 0, 0] = float("inf")
    a_pair, i_pair = tops.flat_prune(idx, msk, ety, ts, tr, td, k)
    o_pair = tops.flat_aggregate(a_pair, i_pair, hp)
    got, n_kept = _launches_of(lambda: tops.flat_prune_aggregate(idx, msk, ety, ts, tr, td, hp, k, keep=True))
    out, n_served = _launches_of(lambda: tops.flat_prune_aggregate(idx, msk, ety, ts, tr, td, hp, k))
    assert n_kept == n_served == {"flat_prune_aggregate": 1}
    assert _same_bits(got, (o_pair, a_pair, i_pair)) and _same_bits((out,), (o_pair,))


@pytest.mark.cuda
@pytest.mark.parametrize("k_s", sorted(KS_CASES))
def test_cuda_prune_aggregate_is_the_pair(cuda_device, k_s):
    """The fused grouped launch against the kernel pair, bit for bit, at
    the grouped K1's widths, pruned and bypass buckets, a relation term;
    one launch under ``prune_aggregate`` and none under the step keys."""
    rng = np.random.default_rng(k_s)
    sg, k, n = _ks_graph(rng, k_s)
    h, dh = 4, 8
    layout = sg.grouped(tops.T_TILE, tops.W_TILE)
    (nbr, msk, ety, rt, _), (blk, got_ks) = tops._layout_device(layout, k, cuda_device)
    assert got_ks == k_s
    ts = torch.from_numpy(rng.integers(-1, 2, size=(n, h)).astype(np.float32)).to(cuda_device)
    tr = torch.from_numpy(rng.integers(-1, 2, size=(3, h)).astype(np.float32)).to(cuda_device)
    td = torch.from_numpy(_normal(rng, sg.num_targets, h)).to(cuda_device)
    hp = torch.from_numpy(_normal(rng, n, h, dh)).to(cuda_device)
    hp[0, 1, 2] = float("nan")
    args = (nbr, msk, ety, ts, tr, td, rt, blk, k_s)
    a_pair, i_pair = tops.prune(*args)
    o_pair = tops.aggregate(a_pair, i_pair, hp, blk)
    got, n_kept = _launches_of(lambda: tops.prune_aggregate(*args, hp, keep=True))
    out, n_served = _launches_of(lambda: tops.prune_aggregate(*args, hp))
    assert n_kept == n_served == {"prune_aggregate": 1}
    assert _same_bits(got, (o_pair, a_pair, i_pair)) and _same_bits((out,), (o_pair,))


@pytest.mark.cuda
def test_cuda_fused_steps_raise_before_launch(cuda_device):
    """H * dh = 1025 and a domain one past ``MAX_KS`` raise ``ValueError``
    before any launch, grouped and flat."""
    dev = cuda_device
    ts, td = torch.zeros((4, 1), device=dev), torch.zeros((8, 1), device=dev)
    wide_row = torch.zeros((4, 1, 1025), device=dev)
    narrow = torch.zeros((4, 1, 8), device=dev)
    idx = torch.zeros((8, 4), dtype=torch.int32, device=dev)
    tiles = torch.zeros((1, 8, 8), dtype=torch.int32, device=dev)
    rt, blk = torch.zeros(8, dtype=torch.int32, device=dev), torch.zeros((4, 1), dtype=torch.int32, device=dev)
    before = dict(tops.LAUNCHES)
    for hp, k in ((wide_row, 2), (narrow, tops.MAX_KS + 1)):
        with pytest.raises(ValueError):
            tops.flat_prune_aggregate(idx, idx.bool(), None, ts, None, td, hp, k)
        with pytest.raises(ValueError):
            tops.prune_aggregate(tiles, tiles.bool(), None, ts, None, td, rt, blk, k, hp)
    assert tops.LAUNCHES == before
