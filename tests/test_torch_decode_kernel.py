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
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("b,h,hkv,dh,s,k", SWEEP)
def test_plain_matches_pallas_sweep(b, h, hkv, dh, s, k):
    rng = np.random.default_rng(0)
    q, kc, vc = _inputs(rng, b, h, hkv, dh, s)
    lens = rng.integers(k + 1, s, size=(b,)).astype(np.int32)
    np.testing.assert_allclose(_port(q, kc, vc, lens, k), _pallas(q, kc, vc, lens, k), atol=ATOL, rtol=0)


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
@pytest.mark.parametrize("b,h,hkv,dh,s,k", SWEEP + K2_EDGES + ((4, 8, 4, 256, 3104, 2048),))
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
