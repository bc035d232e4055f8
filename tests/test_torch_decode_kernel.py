"""Port parity: top-K decode attention (kernel #4) against the reference.

On the CPU the port's ``topk_decode_attention`` runs the plain version of
its CUDA kernel pair (``ref.py``). It is held against the reference's
Pallas kernel ``topk_decode_attention_pallas``, run as the reference's
own tests run it (``interpret=True``), on the reference's sweep shapes and
its k ≥ length case, at the reference's kernel-vs-oracle tolerance (2e-5,
``tests/test_kernels.py``).

The tie tests pin the retention rule. For logits [1, 1, 2, 1] at k = 2
the Pallas kernel evicts the FIRST minimum slot and inserts only on a
strictly greater logit, so it keeps positions {1, 2}; the port follows it.
The reference's oracle ``topk_decode_attention_ref`` keeps {0, 1} there,
losing the maximum (its exact-k cumsum counts every slot at or above the
threshold, not only the tied ones); a test records that.

The test marked ``cuda`` holds the CUDA kernels against the plain versions
on a card; it skips without one.
"""
import gc
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.topk_decode_attention import ops as tops  # noqa: E402
from repro_torch.kernels.topk_decode_attention import ref as tref  # noqa: E402

ATOL = 2e-5  # the reference's kernel-vs-oracle tolerance
SWEEP = ((2, 8, 2, 16, 200, 12), (3, 4, 4, 8, 128, 5), (1, 16, 4, 32, 300, 50))
# the head groupings the cross-attention archs give the kernel, at a small
# context: llama-3.2-vision's 8 q-heads a kv-head at hd 128, seamless-m4t's
# 1 at hd 64 (every context row valid)
CROSS = ((2, 16, 2, 128, 96, 24), (2, 4, 4, 64, 80, 20))


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


def _inputs(rng, b, h, hkv, dh, s):
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kc = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    vc = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    return q, kc, vc


def _pallas(q, kc, vc, lens, k, scale=None):
    import jax.numpy as jnp
    from repro.kernels.topk_decode_attention.kernel import topk_decode_attention_pallas

    return np.asarray(topk_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens), k, scale
    ))


def _port(q, kc, vc, lens, k, scale=None):
    before = dict(tops.LAUNCHES)
    out = tops.topk_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(np.asarray(lens, np.int32)), k, scale,
    )
    assert tops.LAUNCHES == before, "a CPU tensor launched a kernel"
    assert not tops.LAUNCHES_BY_WIDTH
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("b,h,hkv,dh,s,k", SWEEP)
def test_plain_matches_pallas_sweep(b, h, hkv, dh, s, k):
    rng = np.random.default_rng(0)
    q, kc, vc = _inputs(rng, b, h, hkv, dh, s)
    lens = rng.integers(k + 1, s, size=(b,)).astype(np.int32)
    np.testing.assert_allclose(_port(q, kc, vc, lens, k), _pallas(q, kc, vc, lens, k), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,h,hkv,dh,s,k", CROSS)
def test_plain_matches_pallas_cross_attention_groupings(b, h, hkv, dh, s, k):
    """Group 8 at hd 128 and group 1 at hd 64, every row valid (lengths =
    C, as a cross-attention's context), float32 and a bfloat16 cache."""
    rng = np.random.default_rng(dh + h)
    q, kc, vc = _inputs(rng, b, h, hkv, dh, s)
    lens = np.full((b,), s, np.int32)
    np.testing.assert_allclose(_port(q, kc, vc, lens, k), _pallas(q, kc, vc, lens, k), atol=ATOL, rtol=0)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, kc, vc))
    got = tops.topk_decode_attention(qb, kb, vb, torch.from_numpy(lens), k).numpy()
    want = _pallas(*(t.float().numpy() for t in (qb, kb, vb)), lens, k)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_k_geq_length_equals_full():
    rng = np.random.default_rng(1)
    b, h, hkv, dh, s = 2, 4, 2, 8, 64
    q, kc, vc = _inputs(rng, b, h, hkv, dh, s)
    lens = np.array([40, 64], np.int32)
    got = _port(q, kc, vc, lens, s)
    np.testing.assert_allclose(got, _pallas(q, kc, vc, lens, s), atol=ATOL, rtol=0)
    full = tops.topk_decode_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, lens)), prune_k=None
    ).numpy()
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=0)


def test_plain_per_row_lengths_below_and_above_k():
    """One row shorter than K (its empty slots keep α 0, id −1), one just
    past it, one at the full cache; GQA group 4."""
    rng = np.random.default_rng(2)
    b, h, hkv, dh, s, k = 3, 8, 2, 16, 160, 50
    q, kc, vc = _inputs(rng, b, h, hkv, dh, s)
    lens = np.array([17, 51, 160], np.int32)
    np.testing.assert_allclose(_port(q, kc, vc, lens, k), _pallas(q, kc, vc, lens, k), atol=ATOL, rtol=0)
    _, ids = tref.score_prune_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(lens), k, dh ** -0.5
    )
    assert bool((ids[0, :, 17:] == -1).all()) and bool((ids[0, :, :17] >= 0).all())
    assert bool((ids[1:] >= 0).all())


def test_plain_bfloat16_cache_matches_pallas():
    """q and the cache in bfloat16, read as stored: the same values as the
    Pallas kernel, which casts them to float32 first."""
    rng = np.random.default_rng(3)
    b, h, hkv, dh, s, k = 2, 8, 4, 32, 200, 24
    q, kc, vc = (torch.from_numpy(a).bfloat16() for a in _inputs(rng, b, h, hkv, dh, s))
    lens = np.array([150, 200], np.int32)
    got = tops.topk_decode_attention(q, kc, vc, torch.from_numpy(lens), k).numpy()
    want = _pallas(*(t.float().numpy() for t in (q, kc, vc)), lens, k)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_matches_pallas_on_tie_heavy_logits():
    """Small-integer q and keys: the logits are exact integers with many
    ties, so the retained set depends on the tie rule (and on the first K
    positions being placed in slots 0..K-1 as the streaming rule would)."""
    rng = np.random.default_rng(5)
    b, h, hkv, dh, s, k = 2, 8, 2, 16, 180, 40
    q = rng.integers(-1, 2, size=(b, h, dh)).astype(np.float32)
    kc = rng.integers(-1, 2, size=(b, s, hkv, dh)).astype(np.float32)
    vc = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    lens = np.array([180, 97], np.int32)
    logits = tref.score_logits_plain(torch.from_numpy(q), torch.from_numpy(kc), 1.0)
    assert len(torch.unique(logits[0, 0])) < 20  # ties everywhere
    np.testing.assert_allclose(
        _port(q, kc, vc, lens, k, 1.0), _pallas(q, kc, vc, lens, k, 1.0), atol=ATOL, rtol=0
    )


def _tie_inputs():
    """Logits [1, 1, 2, 1] (scale 1) and V rows 0..3 = arange."""
    q = np.array([[[1.0, 0.0, 0.0, 0.0]]], np.float32)  # (1, 1, 4)
    kc = np.zeros((1, 4, 1, 4), np.float32)
    kc[0, :, 0, 0] = [1.0, 1.0, 2.0, 1.0]
    vc = np.arange(16, dtype=np.float32).reshape(1, 4, 1, 4)
    return q, kc, vc, np.array([4], np.int32)


def test_tie_follows_kernel_rule():
    q, kc, vc, lens = _tie_inputs()
    _, ids = tref.score_prune_plain(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(lens), 2, 1.0)
    assert sorted(ids[0, 0].tolist()) == [1, 2]
    got = _port(q, kc, vc, lens, 2, 1.0)
    e1, e2 = np.exp(1.0), np.exp(2.0)
    np.testing.assert_allclose(got[0, 0], (e1 * vc[0, 1, 0] + e2 * vc[0, 2, 0]) / (e1 + e2), atol=1e-5)
    np.testing.assert_allclose(got, _pallas(q, kc, vc, lens, 2, 1.0), atol=ATOL, rtol=0)


def test_reference_oracle_tie_keeps_first_two():
    """Records the reference oracle's tie fault: it keeps {0, 1} and drops
    the maximum, unlike the Pallas kernel and the port."""
    import jax.numpy as jnp
    from repro.kernels.topk_decode_attention.ref import topk_decode_attention_ref

    q, kc, vc, lens = _tie_inputs()
    oracle = np.asarray(topk_decode_attention_ref(*(jnp.asarray(a) for a in (q, kc, vc, lens)), 2, 1.0))
    np.testing.assert_allclose(oracle[0, 0], [2.0, 3.0, 4.0, 5.0], atol=1e-6)
    assert np.abs(oracle - _port(q, kc, vc, lens, 2, 1.0)).max() > 1.0


def test_logits_follow_kernel_summation_order():
    """The plain logits are the kernel's: lane l sums the float32 products
    of dims l, l+32, … left to right from 0, the lanes combine by an xor
    butterfly (16, 8, 4, 2, 1), then one multiply by the scale — each step
    one float32 rounding. Checked bit for bit against that order written
    out in numpy, with dh not a multiple of 32."""
    rng = np.random.default_rng(4)
    b, h, hkv, dh, s, scale = 2, 4, 2, 72, 30, 0.125
    q, kc, _ = _inputs(rng, b, h, hkv, dh, s)
    got = tref.score_logits_plain(torch.from_numpy(q), torch.from_numpy(kc), scale).numpy()
    f32 = np.float32
    want = np.empty((b, h, s), f32)
    for bi in range(b):
        for hi in range(h):
            for si in range(s):
                kv = kc[bi, si, hi // (h // hkv)]
                lane = np.zeros(32, f32)
                for d in range(dh):
                    lane[d % 32] = f32(lane[d % 32] + f32(q[bi, hi, d] * kv[d]))
                for off in (16, 8, 4, 2, 1):
                    lane = (lane + lane[np.arange(32) ^ off]).astype(f32)
                want[bi, hi, si] = f32(lane[0] * f32(scale))
    assert np.array_equal(got, want)


def test_shared_memory_budget():
    """K1 keeps each q-head's domain in shared memory (8 B a slot beside
    the group's q): gemma3-4b's K = 2048 (group 2, dh 256) fits."""
    assert tops.max_k(2, 256) == (232448 - 4 * 2 * 256) // 16
    assert tops.max_k(2, 256) >= 2048


def test_plain_canonical_layout():
    """``score_prune_plain`` writes the retained positions in ascending
    order with their α alongside and the empty slots (id −1, α 0) last;
    α sums to 1 over the retained slots."""
    rng = np.random.default_rng(6)
    b, h, hkv, dh, s, k = 3, 4, 2, 8, 90, 20
    q, kc, _ = _inputs(rng, b, h, hkv, dh, s)
    lens = np.array([90, 13, 0], np.int32)
    alpha, ids = (t.numpy() for t in tref.score_prune_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(lens), k, dh ** -0.5))
    for bi in range(b):
        for hi in range(h):
            n = min(int(lens[bi]), k)
            kept = ids[bi, hi, :n]
            assert (np.diff(kept) > 0).all() and (kept >= 0).all() and (ids[bi, hi, n:] == -1).all()
            assert (alpha[bi, hi, n:] == 0).all()
            if n:
                assert abs(alpha[bi, hi].sum() - 1) < 1e-5
    q, kc, _, lens = _tie_inputs()
    _, ids = tref.score_prune_plain(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(lens), 2, 1.0)
    assert ids[0, 0].tolist() == [1, 2]


def test_plain_special_logits_match_pallas():
    """NaN, -inf and a NEG-band logit among the first K positions: the TPU
    kernel never inserts a logit at or below NEG or a NaN (they are not
    greater than an empty slot's NEG), and drops a NEG-band one at the
    flush; the plain version fills the domain the same way."""
    s, dh, k = 12, 4, 4
    q = np.array([[[1.0, 0, 0, 0], [1.0, 0, 0, 0]]], np.float32)  # (1, 2, 4), a kv-head each
    kc = np.zeros((1, s, 2, dh), np.float32)
    kc[0, :, 0, 0] = [1, np.nan, 3, -np.inf, -2.5e38, 2, 5, 0.5, 4, 1, 7, 6]
    kc[0, :, 1, 0] = [-2.5e38, 1, np.nan, 2, -np.inf, 0.5, -1, 3, 0, 0, 0, 0]
    vc = np.random.default_rng(0).normal(size=(1, s, 2, dh)).astype(np.float32)
    lens = np.array([s], np.int32)
    np.testing.assert_allclose(_port(q, kc, vc, lens, k, 1.0), _pallas(q, kc, vc, lens, k, 1.0), atol=ATOL, rtol=0)
    _, ids = tref.score_prune_plain(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(lens), k, 1.0)
    assert ids[0, 0].tolist() == [6, 8, 10, 11]
    assert ids[0, 1].tolist() == [1, 3, 5, 7]


# --- the CUDA K1's two paths, emulated in numpy -----------------------------

CLUSTER = 8  # blocks of a (batch, kv-head) in K1
NEG32 = np.float32(-3.0e38)


def _mono_key(v):
    """The kernel's radix key: the float's bits made monotone, -0.0 as +0.0."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32).copy()
    u[(u & np.uint32(0x7FFFFFFF)) == 0] = 0
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _block_bounds(n):
    return [(n * r // CLUSTER, n * (r + 1) // CLUSTER) for r in range(CLUSTER)]


def _radix_select(keys, bounds, kk):
    """t (the kk-th largest key), the rank still sought among keys equal
    to t, and their count: 4 passes of 8 bits, each digit found from the
    sum of the blocks' histograms, counted from the top."""
    prefix, rem, eq = 0, kk, 0
    for p in range(4):
        shift = 24 - 8 * p
        hist = np.zeros(256, np.int64)
        for lo, hi in bounds:
            kb = keys[lo:hi]
            if p:
                kb = kb[(kb >> np.uint32(shift + 8)) == prefix]
            hist += np.bincount((kb >> np.uint32(shift)) & 255, minlength=256)
        before = 0
        for d in range(255, -1, -1):
            if before < rem <= before + hist[d]:
                break
            before += hist[d]
        prefix, rem, eq = (prefix << 8) | d, rem - before, int(hist[d])
    return np.uint32(prefix), rem, eq


def _fast_path(v, keys, bounds, t, k):
    """Each block's kept positions (key >= t) in order after the lower
    ranks'; the softmax's maximum over the blocks' maxima, its sum over the
    blocks' sums in rank order."""
    kept = [lo + np.flatnonzero(keys[lo:hi] >= t) for lo, hi in bounds]
    gmax = max((v[kb].max() for kb in kept if len(kb)), default=NEG32)
    parts = [np.exp(v[kb] - gmax, dtype=np.float32).sum(dtype=np.float32) for kb in kept]
    denom = np.float32(0)
    for part in parts:
        denom = np.float32(denom + part)
    denom = np.float32(denom + np.float32(1e-30))
    pos = np.concatenate(kept)
    ids = np.full(k, -1, np.int64)
    alpha = np.zeros(k, np.float32)
    ids[: len(pos)] = pos
    alpha[: len(pos)] = np.exp(v[pos] - gmax, dtype=np.float32) / denom
    return alpha, ids


def _first_min(rv):
    """domain_first_min: the least value, the lowest slot among equals."""
    i = int(np.argmin(rv))
    return rv[i], i


def _tie_path(v, n, k):
    """One warp's tie path: a ballot fill of the empty slots by the logits
    above NEG in position order, the chain chunk by chunk (an exact ballot
    filter against the minimum, inserts in position order, the first
    minimum found again after each), the flush, and a bitonic sort of the
    domain by position into the canonical layout."""
    rv = np.full(k, NEG32, np.float32)
    ri = np.full(k, -1, np.int64)
    filled, chain_from = 0, None
    for c0 in range(0, n, 32):
        p = np.arange(c0, min(c0 + 32, n))
        cand = v[p]
        fill = p[cand > NEG32]
        room = k - filled
        rv[filled: filled + min(room, len(fill))] = v[fill[:room]]
        ri[filled: filled + min(room, len(fill))] = fill[:room]
        if len(fill) < room:
            filled += len(fill)
        else:
            chain_from = (c0, set(fill[room:].tolist()))
            break
    if chain_from is not None:
        c0, live0 = chain_from
        mv, mi = _first_min(rv)
        for c in range(c0, n, 32):
            p = np.arange(c, min(c + 32, n))
            live = [int(j) for j in p if v[j] > mv and (c != c0 or j in live0)]
            for j in live:
                if v[j] > mv:
                    rv[mi], ri[mi] = v[j], j
                    mv, mi = _first_min(rv)
    ok = rv > NEG32 / 2
    mx = rv[ok].max() if ok.any() else NEG32
    denom = np.float32(np.exp(rv[ok] - mx, dtype=np.float32).sum(dtype=np.float32) + np.float32(1e-30))
    key = np.where(ok, ri, 0x7FFFFFFF)
    size, m = 2, 1
    while m < k:
        m <<= 1
    while size <= m:
        stride = size >> 1
        while stride:
            i = np.arange(m >> 1)
            a = (i // stride) * 2 * stride + i % stride
            bb = a ^ (size - 1) if stride == size >> 1 else a + stride
            sel = bb < k
            a, bb = a[sel], bb[sel]
            swap = key[bb] < key[a]
            a, bb = a[swap], bb[swap]
            key[a], key[bb] = key[bb], key[a].copy()
            rv[a], rv[bb] = rv[bb], rv[a].copy()
            stride >>= 1
        size <<= 1
    keep = key != 0x7FFFFFFF
    alpha = np.where(keep, np.exp(rv - mx, dtype=np.float32) / denom, np.float32(0))
    return alpha.astype(np.float32), np.where(keep, key, -1)


def _emulated_k1(logits, lens, k):
    """The CUDA K1 after its logits, per (batch, q-head): the radix select
    over the cluster's blocks, the fast-path test, then the fast path or
    the tie path. Returns alpha, ids and which rows took the tie path."""
    b, h, s = logits.shape
    alpha = np.zeros((b, h, k), np.float32)
    ids = np.full((b, h, k), -1, np.int64)
    tie = np.zeros((b, h), np.int64)
    for bi in range(b):
        n = int(min(max(lens[bi], 0), s))
        kk = min(k, n)
        bounds = _block_bounds(n)
        for hi in range(h):
            v = logits[bi, hi, :n]
            fast = False
            if n:
                keys = _mono_key(v)
                t, rem, eq = _radix_select(keys, bounds, kk)
                bad = bool((~(v > NEG32 / 2)).any())
                fast = not bad and eq == rem
            if fast:
                alpha[bi, hi], ids[bi, hi] = _fast_path(v, keys, bounds, t, k)
            else:
                tie[bi, hi] = 1
                alpha[bi, hi], ids[bi, hi] = _tie_path(logits[bi, hi], n, k)
    return alpha, ids, tie


def _logit_case(case):
    """(logits (B, H, S) float32, lengths, k) for the emulation tests."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "gaussian":
        return rng.normal(size=(2, 3, 300)).astype(np.float32), [300, 170], 64
    if case == "integers":  # ties at the K-th everywhere
        return rng.integers(-3, 4, size=(2, 3, 300)).astype(np.float32), [300, 211], 64
    if case == "all_equal":
        return np.full((1, 2, 200), 1.5, np.float32), [200], 50
    if case == "signed_zeros":
        lg = -rng.random((1, 4, 64)).astype(np.float32) - 1
        lg[0, :, [3, 9, 20, 31, 40]] = [[10.0], [11.0], [12.0], [13.0], [14.0]]
        lg[0, 0, [5, 7, 50, 60]] = [-0.0, 0.0, -0.0, 0.0]  # zeros straddle slot 8: tie path
        lg[0, 1, [5, 7, 50]] = [-0.0, 0.0, 0.0]  # exactly 8 >= t = 0: fast path, -0.0 kept
        lg[0, 2, [5, 7, 50]] = [-0.0, -0.0, -0.0]
        # the chain keeps -0.0 at 0 and +0.0 at 1 over +0.0 at 50: -0.0 must
        # tie +0.0 in the key, or the fast path would keep 50 instead of 0
        lg[0, 3, [0, 1, 45, 50]] = [-0.0, 0.0, 15.0, 0.0]
        return lg, [64], 8
    if case == "special":  # NaN, -inf and the NEG band, early and late
        lg = rng.normal(size=(1, 4, 120)).astype(np.float32)
        lg[0, 0, [2, 90]] = np.nan
        lg[0, 1, [1, 100]] = -np.inf
        lg[0, 2, [4, 70]] = -2.5e38
        lg[0, 3, [0, 5]] = [NEG32, -3.4e38]
        return lg, [120], 16
    if case == "lengths":  # length 0, below K, equal to K, above K
        return rng.normal(size=(4, 2, 100)).astype(np.float32), [0, 30, 64, 100], 64
    if case == "group8_integers":  # llama-3.2-vision's grouping: 16 q-heads on 2 kv-heads, hd 128
        q = torch.from_numpy(rng.integers(-1, 2, size=(2, 16, 128)).astype(np.float32))
        kc = torch.from_numpy(rng.integers(-1, 2, size=(2, 300, 2, 128)).astype(np.float32))
        return tref.score_logits_plain(q, kc, 128 ** -0.5).numpy(), [300, 300], 64
    if case == "wide_gaussian":  # gemma3-4b's K on its cache width
        return rng.normal(size=(1, 2, 3104)).astype(np.float32) * 3, [3073], 2048
    lg = rng.integers(-4, 5, size=(1, 2, 3104)).astype(np.float32)  # wide_integers
    return lg, [3104], 2048


@pytest.mark.parametrize(
    "case",
    ("gaussian", "integers", "all_equal", "signed_zeros", "special", "lengths", "wide_gaussian",
     "wide_integers", "group8_integers"),
)
def test_kernel_two_paths_emulation_matches_plain(case):
    """The CUDA K1's selection (csrc/topk_decode_attention.cu), emulated in
    numpy step for step, equals ``score_prune_plain`` (the chain, itself
    held to ``topk_decode_attention_pallas`` above): ids slot for slot, α
    within 1e-6, on whichever path each row takes; the rows it sends down
    the tie path are ``tie_rows_plain``'s; and the tie path alone gives
    the same result on the fast rows too, so the fast path's set is the
    chain's set there."""
    lg, lens, k = _logit_case(case)
    lens = np.asarray(lens, np.int32)
    a_p, i_p = (t.numpy() for t in tref.prune_logits_plain(torch.from_numpy(lg), torch.from_numpy(lens), k))
    alpha, ids, tie = _emulated_k1(lg, lens, k)
    np.testing.assert_array_equal(ids, i_p)
    np.testing.assert_allclose(alpha, a_p, atol=1e-6, rtol=0)
    want_tie = tref.tie_rows_plain(torch.from_numpy(lg), torch.from_numpy(lens), k).numpy()
    np.testing.assert_array_equal(tie, want_tie)
    for bi in range(lg.shape[0]):
        for hi in range(lg.shape[1]):
            if not tie[bi, hi]:
                a_t, i_t = _tie_path(lg[bi, hi], int(lens[bi]), k)
                np.testing.assert_array_equal(i_t, i_p[bi, hi])
                np.testing.assert_allclose(a_t, a_p[bi, hi], atol=1e-6, rtol=0)
    expect = {"gaussian": 0, "wide_gaussian": 0, "all_equal": 2, "wide_integers": 2}
    if case in expect:
        assert int(tie.sum()) == expect[case]
    if case in ("integers", "group8_integers"):
        assert 0 < int(tie.sum()) < tie.size
    if case == "signed_zeros":
        assert tie[0].tolist() == [1, 0, 0, 1]
    if case == "special":
        assert tie[0].tolist() == [1, 1, 1, 1]
    if case == "lengths":  # only the empty row takes the tie path
        assert tie[:, 0].tolist() == [1, 0, 0, 0]


def test_wrapper_returns_tie_rows_on_request():
    """``score_prune(..., tie_rows=True)`` also returns the (B, H) tie
    rows; without it the result is the pair alone. CPU tensors count no
    launch."""
    q, kc, _, lens = _tie_inputs()
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(lens), 2, 1.0)
    before = dict(tops.LAUNCHES)
    alpha, ids = tops.score_prune(*args)
    a2, i2, tie = tops.score_prune(*args, tie_rows=True)
    assert torch.equal(alpha, a2) and torch.equal(ids, i2)
    assert tie.dtype == torch.int32 and tie.tolist() == [[1]]  # k 2: three logits tie at t = 1
    assert tops.score_prune(*args[:3], 1, 1.0, tie_rows=True)[2].tolist() == [[0]]  # k 1: t = 2 alone
    assert tops.LAUNCHES == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# K2's edges on the card: k = 1 (lengths from 0), k = 77 (not a multiple of
# 32 nor of the 64 parts a (batch, q-head) is split into), and widths whose
# rows are not a multiple of 16 bytes (dh 12 in bfloat16, dh 5), read one
# element a load
K2_EDGES = ((2, 4, 2, 8, 64, 1), (1, 8, 2, 16, 200, 77), (2, 4, 2, 12, 100, 33), (1, 4, 1, 5, 90, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,dh,s,k", SWEEP + K2_EDGES + CROSS + ((4, 8, 4, 256, 3104, 2048),))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_cuda_kernels_match_plain(cuda_device, b, h, hkv, dh, s, k, dtype):
    """K1 and K2 against their plain versions; K2 also with one (batch,
    q-head) whose ids are all -1 and with every third slot -1, and two
    calls on the same inputs give the same bits."""
    rng = np.random.default_rng(s)
    dt = getattr(torch, dtype)
    q, kc, vc = (torch.from_numpy(a).to(cuda_device, dt) for a in _inputs(rng, b, h, hkv, dh, s))
    lens = torch.from_numpy(rng.integers(k // 2, s + 1, size=(b,)).astype(np.int32)).to(cuda_device)
    a_k, i_k = tops.score_prune(q, kc, lens, k, dh ** -0.5)
    a_p, i_p = tref.score_prune_plain(q, kc, lens, k, dh ** -0.5)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(a_k, a_p, atol=1e-6, rtol=0)
    holes = i_p.clone()
    holes[0, 0] = -1
    holes[..., ::3] = -1
    for ids in (i_p, holes):
        out = tops.value_gather(a_p, ids, vc)
        torch.testing.assert_close(out, tref.value_gather_plain(a_p, ids, vc), atol=1e-5, rtol=0)
        assert torch.equal(out, tops.value_gather(a_p, ids, vc))
    assert not bool(out[0, 0].any())  # a (batch, q-head) with no retained row


@pytest.mark.cuda
def test_cuda_tie_heavy_logits_match_plain(cuda_device):
    rng = np.random.default_rng(5)
    b, h, hkv, dh, s, k = 2, 8, 2, 16, 180, 40
    q = torch.from_numpy(rng.integers(-1, 2, size=(b, h, dh)).astype(np.float32)).to(cuda_device)
    kc = torch.from_numpy(rng.integers(-1, 2, size=(b, s, hkv, dh)).astype(np.float32)).to(cuda_device)
    lens = torch.tensor([180, 97], dtype=torch.int32, device=cuda_device)
    a_k, i_k = tops.score_prune(q, kc, lens, k, 1.0)
    a_p, i_p = tref.score_prune_plain(q, kc, lens, k, 1.0)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(a_k, a_p, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_cuda_domain_too_wide_raises_before_launch(cuda_device):
    h, hkv, dh = 8, 1, 1024
    k = tops.max_k(h // hkv, dh) + 1
    q = torch.zeros((1, h, dh), device=cuda_device)
    kc = torch.zeros((1, k + 10, hkv, dh), device=cuda_device)
    lens = torch.full((1,), k + 10, dtype=torch.int32, device=cuda_device)
    before = dict(tops.LAUNCHES)
    with pytest.raises(ValueError, match="shared"):
        tops.score_prune(q, kc, lens, k, dh ** -0.5)
    assert tops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("gaussian", "integers", "all_equal", "special", "lengths", "wide_integers"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_cuda_k1_two_paths_match_plain(cuda_device, case, dtype):
    """K1 on the emulation's logits (a kv-head per q-head, q = e_0, keys
    (x, 0, 0, 0), scale 1, so the logits are x): ids slot for slot, α
    within 1e-6, and the tie rows ``tie_rows_plain``'s."""
    x, lens, k = _logit_case(case)
    b, h, s = x.shape
    dt = getattr(torch, dtype)
    q = torch.zeros((b, h, 4))
    q[..., 0] = 1.0
    kc = torch.zeros((b, s, h, 4))
    kc[..., 0] = torch.from_numpy(x).permute(0, 2, 1)
    q, kc = q.to(cuda_device, dt), kc.to(cuda_device, dt)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    a_k, i_k, tie = tops.score_prune(q, kc, lens, k, 1.0, tie_rows=True)
    a_p, i_p = tref.score_prune_plain(q, kc, lens, k, 1.0)
    assert torch.equal(i_k, i_p)
    torch.testing.assert_close(a_k, a_p, atol=1e-6, rtol=0)
    assert torch.equal(tie, tref.tie_rows_plain(tref.score_logits_plain(q, kc, 1.0), lens, k))
