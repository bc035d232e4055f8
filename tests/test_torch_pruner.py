"""Port parity: the standalone Pruner (kernel #3) and ``core/pruning``
against the reference.

On the CPU the port's ``topk_select`` runs the plain version of its CUDA
kernel (``topk_select_plain``: the kernel's streaming rule, first-minimum
eviction, strict ``>``). It is held against the reference's Pallas kernel
``topk_select_pallas``, run as the reference's own tests run it
(``interpret=True``), ARRAY FOR ARRAY: values bit for bit, ids exactly, in
domain-slot order. The reference's kernel tests compare only sets on
continuous random data; here the cases add tie-heavy integer scores,
k > D, and a row of special values (±0.0, ±NaN, ±inf, NEG, values in
(NEG, NEG/2]).

``use_kernel=False``, ``topk_keep_mask`` and ``streaming_topk`` follow
``lax.top_k``'s order (floats in total order, the lower index first among
equals) and are held to the reference exactly. The reference's kernel and
its own oracle keep different slots on ties ([1, 1, 2] at k = 2: ids
[2, 1] against [2, 0]); a test records that.

The test marked ``cuda`` holds the CUDA kernel against the plain version
on a card; it skips without one.
"""
import gc
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.kernels.common import NEG  # noqa: E402
from repro_torch.kernels.fused_prune_aggregate import ref as fref  # noqa: E402
from repro_torch.kernels.topk_select import ops as tops  # noqa: E402
from repro_torch.kernels.topk_select import ref as tref  # noqa: E402

NAN_NEG = np.array([0xFFC00000], np.uint32).view(np.float32)[0]  # -NaN
# one row of every value the rule treats specially, with repeats
SPECIAL = np.array(
    [-0.0, 0.0, 1.0, np.nan, 2.0, NAN_NEG, np.inf, -np.inf, NEG, -2e38,
     np.float32(NEG / 2), 0.0, -0.0, -3.4e38, 1.0, 2.0], np.float32,
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


def _pallas(s, m, k):
    import jax.numpy as jnp

    from repro.kernels.topk_select.kernel import topk_select_pallas

    v, i = topk_select_pallas(jnp.asarray(s), jnp.asarray(m), k, interpret=True)
    return np.asarray(v), np.asarray(i)


def _oracle(s, m, k):
    import jax.numpy as jnp

    from repro.kernels.topk_select.ref import topk_select_ref

    v, i = topk_select_ref(jnp.asarray(s), jnp.asarray(m), k)
    return np.asarray(v), np.asarray(i)


def _port(s, m, k, use_kernel=True):
    v, i = tops.topk_select(torch.from_numpy(s), torch.from_numpy(m), k, use_kernel=use_kernel)
    return v.numpy(), i.numpy()


def _assert_same(got, want):
    """Values bit for bit (so -0.0 is not +0.0 and NaN equals NaN), ids
    exactly, position for position."""
    (v1, i1), (v2, i2) = got, want
    assert v1.dtype == v2.dtype == np.float32 and i1.dtype == i2.dtype == np.int32
    np.testing.assert_array_equal(v1.view(np.int32), v2.view(np.int32))
    np.testing.assert_array_equal(i1, i2)


def _normal(rng, t, d, density):
    return rng.normal(size=(t, d)).astype(np.float32), rng.random((t, d)) < density


def _ints(rng, t, d, density):
    return rng.integers(-2, 3, size=(t, d)).astype(np.float32), rng.random((t, d)) < density


def _special():
    """The special row, and the row reversed with every third slot masked."""
    s = np.stack([SPECIAL, SPECIAL[::-1]])
    m = np.ones_like(s, bool)
    m[1, ::3] = False
    return s, m


# --- the kernel's rule (use_kernel=True) against the Pallas kernel --------

# the shapes of the reference's kernel tests (tests/test_kernels.py:15-83):
# its sweep, then its tile-unaligned and tile-aligned edge shapes
KERNEL_SHAPES = (
    (3, 17, 4), (8, 128, 50), (13, 300, 7), (1, 1, 1), (5, 260, 64),
    (7, 100, 4), (9, 129, 8), (8, 127, 8), (15, 255, 16), (1, 3, 2), (8, 128, 8), (16, 256, 4),
)


@pytest.mark.parametrize("t,d,k", KERNEL_SHAPES)
def test_kernel_rule_matches_pallas(t, d, k):
    s, m = _normal(np.random.default_rng(t * 1000 + d), t, d, 0.75)
    _assert_same(_port(s, m, k), _pallas(s, m, k))


@pytest.mark.parametrize("t,d", ((3, 40), (8, 128), (9, 130)))
def test_kernel_rule_k1_matches_pallas(t, d):
    s, m = _normal(np.random.default_rng(d), t, d, 0.8)
    m[0] = False
    got = _port(s, m, 1)
    _assert_same(got, _pallas(s, m, 1))
    assert got[1][0, 0] == -1


def test_kernel_rule_all_masked_rows_match_pallas():
    s, m = _normal(np.random.default_rng(5), 10, 137, 0.6)
    m[[1, 4, 9]] = False
    got = _port(s, m, 6)
    _assert_same(got, _pallas(s, m, 6))
    assert (got[1][[1, 4, 9]] == -1).all() and (got[0][[1, 4, 9]] == np.float32(NEG)).all()


@pytest.mark.parametrize("t,d,k", ((3, 17, 40), (1, 3, 8), (4, 100, 130)))
def test_kernel_rule_k_above_d_matches_pallas(t, d, k):
    """k > D: the valid scores in arrival order, then NEG / -1."""
    s, m = _normal(np.random.default_rng(k), t, d, 0.8)
    got = _port(s, m, k)
    _assert_same(got, _pallas(s, m, k))
    for row in range(t):
        n = int(m[row].sum())
        np.testing.assert_array_equal(got[1][row, :n], np.flatnonzero(m[row]))
        assert (got[1][row, n:] == -1).all()


@pytest.mark.parametrize("t,d,k", ((9, 300, 7), (5, 260, 64), (3, 17, 40), (4, 64, 8)))
def test_kernel_rule_tie_heavy_matches_pallas(t, d, k):
    s, m = _ints(np.random.default_rng(t + d + k), t, d, 0.85)
    _assert_same(_port(s, m, k), _pallas(s, m, k))


@pytest.mark.parametrize("k", (1, 2, 3, 5, 8, 13, 16, 20))
def test_kernel_rule_special_values_match_pallas(k):
    """±0.0 keep their bits and tie; NaN and -inf never enter; a value in
    (NEG, NEG/2] enters but comes out with id -1."""
    s, m = _special()
    got = _port(s, m, k)
    _assert_same(got, _pallas(s, m, k))
    assert not np.isnan(got[0]).any() and not np.isneginf(got[0]).any()


def test_kernel_rule_value_in_neg_band_enters_with_id_minus_one():
    s = np.array([[-2e38, 1.0, np.float32(NEG / 2)]], np.float32)
    m = np.ones_like(s, bool)
    got = _port(s, m, 3)
    _assert_same(got, _pallas(s, m, 3))
    np.testing.assert_array_equal(got[0], s)
    np.testing.assert_array_equal(got[1], [[-1, 1, -1]])


def test_reference_tie_fault_kernel_against_its_oracle():
    """The reference's ``ref.py`` says ties keep the earliest slot; its
    kernel does not. For [1, 1, 2] at k = 2 the kernel gives ids [2, 1]
    (first-minimum eviction) and the oracle [2, 0] (``top_k``). The port's
    kernel path follows the kernel, ``use_kernel=False`` the oracle."""
    s = np.array([[1.0, 1.0, 2.0]], np.float32)
    m = np.ones_like(s, bool)
    assert _pallas(s, m, 2)[1].tolist() == [[2, 1]]
    assert _oracle(s, m, 2)[1].tolist() == [[2, 0]]
    assert _port(s, m, 2)[1].tolist() == [[2, 1]]
    assert _port(s, m, 2, use_kernel=False)[1].tolist() == [[2, 0]]


def test_plain_pruner_matches_plain_flat_k1():
    """The Pruner on the flat K1's ranks (the left-to-right head sum of
    θ_src[nbr] + θ_rel[ety], NEG where masked) keeps the same domain as
    the flat K1 itself: ``nbr[row, ids]`` equals K1's retained ids, slot for
    slot. Integer θ make ties common."""
    rng = np.random.default_rng(11)
    for t, d, n, h, r, k, ints in ((9, 70, 40, 4, 3, 8, False), (6, 90, 30, 8, 5, 16, True), (4, 20, 10, 2, 2, 30, True)):
        nbr = torch.from_numpy(rng.integers(0, n, size=(t, d)).astype(np.int32))
        msk = torch.from_numpy(rng.random((t, d)) < 0.8)
        ety = torch.from_numpy(rng.integers(0, r, size=(t, d)).astype(np.int32))
        draw = (lambda *sh: rng.integers(-2, 3, size=sh)) if ints else (lambda *sh: rng.normal(size=sh))
        ts, tr, td = (torch.from_numpy(draw(*sh).astype(np.float32)) for sh in ((n, h), (r, h), (t, h)))
        th = ts[nbr.long()] + tr[ety.long()]  # (T, D, H)
        rank = th[..., 0]
        for hh in range(1, h):
            rank = rank + th[..., hh]
        _, ids3 = tops.topk_select(rank, msk, k)
        _, ids1 = fref.flat_prune_plain(nbr, msk, ety, ts, tr, td, k, 0.2)
        mapped = torch.where(ids3 >= 0, nbr.gather(1, ids3.clamp(min=0).long()), -1)
        assert torch.equal(mapped, ids1), (t, d, k)


# --- the CUDA kernel's algorithm, emulated step for step -------------------

NO_KEY = 0xFFFFFFFF


def _cmp_key(v):
    """The key the kernel compares, ``cmp_key(to_key(v))``: an unsigned key
    in the order of the float values, -0.0 on +0.0's so that the zeros
    tie."""
    b = np.asarray(v, np.float32).view(np.uint32).copy()
    b[(b & 0x7FFFFFFF) == 0] = 0
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _from_key(key):
    """The kernel's ``from_key``: the float of a key."""
    b = np.uint32(key)
    return np.array([b & 0x7FFFFFFF if b & 0x80000000 else ~b], np.uint32).view(np.float32)[0]


def _first_of(a, b):
    """The first of two (key, slot) pairs: the lower key, then the lower slot."""
    return b if (b[0], b[1]) < (a[0], a[1]) else a


def _warp_first_min(keys, slots):
    """The least key over the lanes, then the least slot among the lanes
    that hold it (the kernel's two ``__reduce_min_sync``)."""
    mkey = keys.min()
    return mkey, int(np.where(keys == mkey, slots, NO_KEY).min())


def _warp_tree_select(s, m, k):
    """The CUDA kernel's algorithm for each row, in numpy, step for step:
    the ballot fill of the empty domain, 32 slots a chunk, up to the chunk
    where it fills, then the two-level winner tree
    (32-slot groups; the first minimum of each as (key, slot), lane l
    holding groups l*GPL .. l*GPL+GPL-1) and the chain: the exact ballot
    filter, then each survivor in slot order inserted at the root's slot
    mi; the new root is the first of the candidate at mi, the rest of mi's
    group (least key, then the lowest lane holding it) and the other
    groups' winners (least key, then least slot over the lanes)."""
    t, d = s.shape
    ng = (k + 31) // 32
    gpl = 1
    while gpl < (ng + 31) // 32:
        gpl *= 2
    width = -(-d // 32) * 32
    lanes32 = np.arange(32)
    out_v, out_i = np.empty((t, k), np.float32), np.empty((t, k), np.int32)
    for row in range(t):
        cand = np.full(width + 32, NEG, np.float32)
        cand[:d] = np.where(m[row], s[row], np.float32(NEG))
        rv, ri = np.full(k, NEG, np.float32), np.full(k, -1, np.int32)

        filled, c, live = 0, None, []
        for cc in range(0, d, 32):
            lanes = np.flatnonzero(cand[cc:cc + 32] > NEG)
            room = k - filled
            rv[filled:filled + min(room, len(lanes))] = cand[cc + lanes[:room]]
            ri[filled:filled + min(room, len(lanes))] = cc + lanes[:room]
            if len(lanes) < room:
                filled += len(lanes)
            else:
                c, live = cc, list(lanes[room:])
                break
        if c is not None:  # full: the winner tree, then the chain
            wkey = np.full((32, gpl), NO_KEY, np.uint64)
            wslot = np.full((32, gpl), k, np.int64)
            for g in range(ng):
                slots = g * 32 + lanes32
                keys = np.where(slots < k, _cmp_key(rv[np.minimum(slots, k - 1)]), NO_KEY).astype(np.uint64)
                wkey[g // gpl, g % gpl], wslot[g // gpl, g % gpl] = _warp_first_min(keys, slots)
            best = wkey.argmin(axis=1)  # the lane's first group among equal keys
            mkey, mi = _warp_first_min(wkey[lanes32, best], wslot[lanes32, best])
            cur = cand[c:c + 32]
            live = [lane for lane in live if cur[lane] > _from_key(mkey)]
            while True:
                while live:
                    src = live.pop(0)
                    g = mi >> 5
                    owner, jj = g // gpl, g % gpl
                    slots = g * 32 + lanes32
                    # mi's group without slot mi: least key, lowest lane holding it
                    xk_l = np.where((slots < k) & (slots != mi), _cmp_key(rv[np.minimum(slots, k - 1)]), NO_KEY)
                    xk = xk_l.astype(np.uint64).min()
                    xs = g * 32 + int(np.flatnonzero(xk_l == xk)[0])
                    # the other groups: each lane's first winner, then over the lanes
                    others = wkey.copy()
                    others[owner, jj] = NO_KEY
                    first = others.argmin(axis=1)
                    rk, rs = _warp_first_min(others[lanes32, first], wslot[lanes32, first])
                    if rk == NO_KEY:
                        rs = k
                    # the candidate at mi, then the first of the three
                    rv[mi], ri[mi] = cur[src], c + src
                    gk, gs = _first_of((int(_cmp_key(cur[src:src + 1])[0]), mi), (int(xk), xs))
                    wkey[owner, jj], wslot[owner, jj] = gk, gs
                    mkey, mi = _first_of((gk, gs), (int(rk), rs))
                    live = [lane for lane in live if cur[lane] > _from_key(mkey)]
                c += 32
                if c >= d:
                    break
                cur = cand[c:c + 32]
                live = list(np.flatnonzero(cur > _from_key(mkey)))
        out_v[row], out_i[row] = rv, np.where(rv <= np.float32(NEG / 2), -1, ri)
    return out_v, out_i


def _special_long(rng, d):
    """Rows of length d drawn from the special values (±0.0 heavy), every
    fifth slot of the second row masked."""
    pool = np.concatenate([SPECIAL, np.array([0.0, -0.0, 1.0, -1.0] * 4, np.float32)])
    s = rng.choice(pool, size=(2, d)).astype(np.float32)
    m = np.ones_like(s, bool)
    m[1, ::5] = False
    return s, m


def _tree_case(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "ties_k2048":  # equal minima in many groups
        return (*_ints(rng, 3, 3104, 0.97), 2048)
    if case == "all_equal_k2048":
        return np.full((2, 4000), 1.5, np.float32), np.ones((2, 4000), bool), 2048
    if case.startswith("k"):  # k not a multiple of 32, or the small-domain branch
        k = int(case[1:])
        return (*_normal(rng, 2, max(3 * k // 2, k + 100), 0.95), k)
    k = int(case.split("_")[1])
    return (*_special_long(rng, 160), k)


@pytest.mark.parametrize(
    "case",
    ("ties_k2048", "all_equal_k2048", "k33", "k1000", "k2047", "k2049", "k64", "k50",
     "special_20", "special_40"),
)
def test_kernel_winner_tree_emulation_matches_plain(case):
    """The CUDA kernel's first-minimum structure (csrc/topk_select.cu),
    emulated in numpy step for step, keeps the domain of
    ``topk_select_plain`` (itself held to ``topk_select_pallas`` above)
    array for array: on tie-heavy integers at k 2048 (equal minima in many
    groups), an all-equal row, k not a multiple of 32, the one- and
    two-group domains (k 50, 64), and rows of special values at k 20 and
    40 (±0.0 equal, NaN and -inf never entering)."""
    s, m, k = _tree_case(case)
    want = tref.topk_select_plain(torch.from_numpy(s), torch.from_numpy(m), k)
    _assert_same(_warp_tree_select(s, m, k), (want[0].numpy(), want[1].numpy()))


# --- the oracle path (use_kernel=False) and the wrapper's contract --------


@pytest.mark.parametrize("t,d,k", KERNEL_SHAPES[:5] + ((9, 300, 7),))
def test_oracle_path_matches_reference_oracle(t, d, k):
    rng = np.random.default_rng(d)
    for s, m in (_normal(rng, t, d, 0.8), _ints(rng, t, d, 0.8)):
        _assert_same(_port(s, m, k, use_kernel=False), _oracle(s, m, k))


@pytest.mark.parametrize("k", (1, 4, 16))
def test_oracle_path_special_values_match_reference_oracle(k):
    s, m = _special()
    _assert_same(_port(s, m, k, use_kernel=False), _oracle(s, m, k))


def test_oracle_path_raises_for_k_above_d_as_the_reference():
    s, m = _normal(np.random.default_rng(0), 3, 17, 0.8)
    with pytest.raises(ValueError):
        _oracle(s, m, 18)
    with pytest.raises(ValueError):
        _port(s, m, 18, use_kernel=False)


def test_wrapper_casts_and_checks_before_any_launch():
    rng = np.random.default_rng(3)
    s, m = _normal(rng, 4, 30, 0.7)
    # float64 scores are cast to float32, an integer mask taken as nonzero
    got = tops.topk_select(torch.from_numpy(s.astype(np.float64)), torch.from_numpy(m.astype(np.int32) * 7), 5)
    _assert_same((got[0].numpy(), got[1].numpy()), _port(s, m, 5))
    assert tops.max_k() == 232448 // 8
    before = dict(tops.LAUNCHES)
    for bad_k in (0, tops.max_k() + 1):
        with pytest.raises(ValueError):
            _port(s, m, bad_k)
    for shape in ((0, 5), (3, 0)):
        with pytest.raises(ValueError):
            tops.topk_select(torch.zeros(shape), torch.ones(shape, dtype=torch.bool), 2)
    with pytest.raises(ValueError):
        tops.topk_select(torch.zeros((3, 5)), torch.ones((3, 4), dtype=torch.bool), 2)
    # the reference raises for an empty array too (its (8, 128) block slicing)
    with pytest.raises(TypeError):
        _pallas(np.zeros((0, 5), np.float32), np.zeros((0, 5), bool), 2)
    assert tops.LAUNCHES == before  # plain versions never count


# --- core/pruning against the reference's ----------------------------------


def _case(seed: int):
    """The reference's ``tests/test_pruning.py`` draw: T in [1, 6], D in
    [1, 40], k in [1, 48], mask density in [0.1, 1.0]."""
    rng = np.random.default_rng(seed)
    t = int(rng.integers(1, 7))
    d = int(rng.integers(1, 41))
    k = int(rng.integers(1, 49))
    density = float(rng.uniform(0.1, 1.0))
    return rng.normal(size=(t, d)).astype(np.float32), rng.random((t, d)) < density, k


def _jax_pruning():
    from repro.core import pruning

    return pruning


def _streaming_both(s, m, k, tile):
    import jax.numpy as jnp

    jp = _jax_pruning()
    want = [np.asarray(a) for a in jp.streaming_topk(jnp.asarray(s), jnp.asarray(m), k, tile)]
    got = [a.numpy() for a in tpruning.streaming_topk(torch.from_numpy(s), torch.from_numpy(m), k, tile)]
    mask_want = np.asarray(jp.streaming_keep_mask(jnp.asarray(s), jnp.asarray(m), k, tile))
    mask_got = tpruning.streaming_keep_mask(torch.from_numpy(s), torch.from_numpy(m), k, tile).numpy()
    return got, want, mask_got, mask_want


TILES = (1, 2, 3, 8, 128)


@pytest.mark.parametrize("seed", range(12))
def test_streaming_topk_matches_reference(seed):
    s, m, k = _case(seed)
    if seed % 2:  # integer scores: ties across tile boundaries
        s = np.round(s * 2).astype(np.float32)
    for tile in TILES:
        got, want, mask_got, mask_want = _streaming_both(s, m, k, tile)
        _assert_same(tuple(got), tuple(want))
        np.testing.assert_array_equal(mask_got, mask_want)


@pytest.mark.parametrize("tile", TILES)
def test_streaming_topk_special_values_match_reference(tile):
    s, m = _special()
    for k in (1, 3, 8, 15):
        got, want, mask_got, mask_want = _streaming_both(s, m, k, tile)
        _assert_same(tuple(got), tuple(want))
        np.testing.assert_array_equal(mask_got, mask_want)


def test_streaming_edge_cases_match_reference():
    """The reference's edge cases: k >= D (the mask back unchanged), ties
    across tiles, rows with fewer than k valid, all-masked rows."""
    import jax.numpy as jnp

    jp = _jax_pruning()
    rng = np.random.default_rng(1)
    s, m = _normal(rng, 5, 12, 0.7)
    for k in (12, 50):
        np.testing.assert_array_equal(
            tpruning.streaming_keep_mask(torch.from_numpy(s), torch.from_numpy(m), k).numpy(), m
        )
    ties = np.array([[2.0, 1.0, 2.0, 1.0, 2.0, 1.0, 2.0, 1.0]], np.float32)
    for tile in (1, 2, 3, 8):
        got, want, mask_got, mask_want = _streaming_both(ties, np.ones_like(ties, bool), 3, tile)
        _assert_same(tuple(got), tuple(want))
        assert np.flatnonzero(mask_got[0]).tolist() == [0, 2, 4]
    few = np.zeros((6, 20), bool)
    for t in range(6):
        few[t, rng.choice(20, size=t, replace=False)] = True
    s20 = rng.normal(size=(6, 20)).astype(np.float32)
    got, want, mask_got, mask_want = _streaming_both(s20, few, 8, 8)
    _assert_same(tuple(got), tuple(want))
    np.testing.assert_array_equal(mask_got, few)
    none = np.zeros((3, 9), bool)
    got, want, mask_got, _ = _streaming_both(s20[:3, :9].copy(), none, 4, 4)
    _assert_same(tuple(got), tuple(want))
    assert not mask_got.any() and (got[1] == -1).all()
    # k > D through the scan itself, as the reference's bypass test runs it
    got = tpruning.streaming_topk(torch.from_numpy(s[:4, :10].copy()), torch.from_numpy(m[:4, :10].copy()), 16, 4)
    want = jp.streaming_topk(jnp.asarray(s[:4, :10]), jnp.asarray(m[:4, :10]), 16, 4)
    _assert_same((got[0].numpy(), got[1].numpy()), tuple(np.asarray(a) for a in want))


@pytest.mark.parametrize("seed", range(4))
def test_keep_mask_from_ids_matches_reference(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    t, d, k = 5, 23, 7
    ids = rng.integers(-1, d, size=(t, k)).astype(np.int32)  # repeats and -1
    want = np.asarray(_jax_pruning().keep_mask_from_ids(jnp.asarray(ids), d))
    np.testing.assert_array_equal(tpruning.keep_mask_from_ids(torch.from_numpy(ids), d).numpy(), want)


@pytest.mark.parametrize("k", range(1, len(SPECIAL) + 1))
def test_topk_keep_mask_total_order_matches_reference(k):
    """``lax.top_k`` orders floats totally (-0.0 < +0.0, -NaN below -inf,
    NaN above +inf) and keeps the lower index among equals; the port's
    ``topk_keep_mask`` must keep the same slots for every k from 1 to D, on
    rows of special values, NEG and ties, with some slots masked."""
    import jax.numpy as jnp

    s, m = _special()
    s = np.concatenate([s, np.array([[1.0, -0.0] * 8], np.float32)])
    m = np.concatenate([m, np.ones((1, s.shape[1]), bool)])
    want = np.asarray(_jax_pruning().topk_keep_mask(jnp.asarray(s), jnp.asarray(m), k))
    got = tpruning.topk_keep_mask(torch.from_numpy(s), torch.from_numpy(m), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_keep_mask_signed_zero_and_nan():
    """Scores [-0.0, 0.0, 1.0, nan, 2.0] at k = 4: ``top_k`` keeps slots
    {1, 2, 3, 4} (+0.0 above -0.0); a float sort, which ties the zeros,
    kept {0, 2, 3, 4}."""
    s = torch.tensor([[-0.0, 0.0, 1.0, float("nan"), 2.0]])
    keep = tpruning.topk_keep_mask(s, torch.ones_like(s, dtype=torch.bool), 4)
    assert torch.nonzero(keep[0]).flatten().tolist() == [1, 2, 3, 4]


# --- on a card ---------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case",
    ("sweep", "ties", "k_above_d", "masked_rows", "special", "wide", "k33", "k1000", "k2047", "k2049",
     "k4096", "k8000", "k16000", "k29056", "wide_ties", "all_equal"),
)
def test_cuda_kernel_matches_plain(cuda_device, case):
    rng = np.random.default_rng(7)
    # k 8000, 16000 and 29056 (``max_k()``): 8, 16 and 32 groups of 32 slots a lane
    wide_k = {"k33": (33, 3104), "k1000": (1000, 4000), "k2047": (2047, 3104), "k2049": (2049, 5000),
              "k4096": (4096, 6000), "k8000": (8000, 9000), "k16000": (16000, 17000),
              "k29056": (29056, 30000)}
    if case == "sweep":
        (s, m), k = _normal(rng, 2048, 512, 0.8), 50
    elif case == "ties":
        (s, m), k = _ints(rng, 300, 260, 0.85), 64
    elif case == "k_above_d":
        (s, m), k = _normal(rng, 3, 17, 0.8), 40
    elif case == "masked_rows":
        (s, m), k = _normal(rng, 10, 137, 0.6), 6
        m[[1, 4, 9]] = False
    elif case == "special":
        (s, m), k = _special(), 8
    elif case == "wide":
        (s, m), k = _normal(rng, 32, 3104, 0.99), 2048
    elif case in wide_k:
        k, d = wide_k[case]
        s, m = _normal(rng, 16, d, 0.97)
    elif case == "wide_ties":  # equal minima in many 32-slot groups
        (s, m), k = _ints(rng, 32, 3104, 0.97), 2048
    else:
        s, m, k = np.full((4, 4000), 1.5, np.float32), np.ones((4, 4000), bool), 2048
    st, mt = torch.from_numpy(s).to(cuda_device), torch.from_numpy(m).to(cuda_device)
    before = tops.LAUNCHES["topk_select"]
    v_k, i_k = tops.topk_select(st, mt, k)
    v_p, i_p = tref.topk_select_plain(st, mt, k)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["topk_select"] == before + 1
    _assert_same((v_k.cpu().numpy(), i_k.cpu().numpy()), (v_p.cpu().numpy(), i_p.cpu().numpy()))
    with pytest.raises(ValueError):
        tops.topk_select(st, mt, tops.max_k() + 1)
    assert tops.LAUNCHES["topk_select"] == before + 1
