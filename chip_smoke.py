#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

It imports ``repro_torch`` from ``src/`` (never JAX, never ``repro``) and
exits non-zero at the first phase that fails:

1. prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/*/csrc`` with ``nvcc`` (one compiler per
   source, all started together) and prints the build times and the
   compiler's register/shared-memory report;
2. holds each CUDA kernel against its plain PyTorch version on the card:
   the grouped pair on the kernel-test parametrisations (pruned/bypass mix,
   unaligned capacities, one bucket, all-bypass, no pruning, a relation
   term, an empty bucket, an empty graph), a score tie, the real DBLP and
   ACM layouts, and the widths of the grouped K1's register domain (k_s 1,
   2, 16, 32, 33 and 256) and of its shared-memory domain (k_s 257, 300,
   528 and ``MAX_KS``, the budget of one warp's domain) on tie-heavy
   integer ranks, pruned and bypass buckets; the flat pair on the
   reference's sweep shapes (random masks with holes), a relation term,
   k = D, an empty row, a score tie, the real ACM ``union:paper`` table and
   tie-heavy tables at k 257, 300, 528 and ``MAX_KS``; on every case of
   both pairs the fused launch (``prune_aggregate`` /
   ``flat_prune_aggregate``: K1, then K2's aggregation in the same warp)
   must return the pair's output, alpha and ids bit for bit, with and
   without ``keep``, in exactly one launch; a flat domain of 257 slots runs
   and equals its plain version, and a domain one past ``MAX_KS`` or an
   H * dh of 1025 (flat and grouped, pair and fused) raises before any
   launch; the top-K decode attention pair on the reference's
   sweep shapes, k >= length (equal to the dense attention), per-row
   lengths with one below K, the logits [1, 1, 2, 1] tie at k = 2 (keeps
   positions {1, 2}), gemma3-4b's decode shapes in float32 and bfloat16,
   and a K too wide for shared memory, which raises before any launch;
   decode K1's tie path and fast path on logits built for them, in float32
   and bfloat16 (ties at t straddling slot 2048 at K 2048, all-equal rows,
   -0.0 and +0.0 at t, NaN, -inf and NEG-band logits, lengths 0, below,
   at and above K): its tie rows must be ``tie_rows_plain``'s, above 0 on
   the tie cases and 0 on the Gaussian sweep;
   K2 also with one (batch, q-head) whose ids are all -1 and with every
   third slot -1, at k = 1, k = 77 and rows not a multiple of 16 bytes
   (dh 12 in bfloat16, dh 5), and a second call on the same inputs must
   give the same bits; the Pruner (kernel #3) on the shapes of the
   reference's kernel tests, k = 1, all-masked rows, k > D, tie-heavy
   integer scores, a row of special values (±0.0, ±NaN, ±inf, values in
   (NEG, NEG/2]), wide domains (32 x 3104 at k 2048; k 33, 1000, 2047,
   2049 and 4096 at D 3104-6000; tie-heavy integers and all-equal rows at
   k 2048; k 8000, 16000 and 29056, the widest, at D above k), and a k too
   wide for shared memory, which raises before any launch. Retained ids
   equal, alpha within 1e-6, outputs within 1e-5 (``expf`` and FMA
   contraction differ from the CPU's arithmetic); the Pruner's values equal
   bit for bit (it only compares and copies);
3. drives the main paths — ``prepare`` → ``task.compile(FlowConfig(
   "fused_kernel", prune_k=8))`` → ``session(params)`` — at ``scale=1.0``
   with seeded random weights: HAN on DBLP and ACM (bucketed), then RGAT
   and Simple-HGN on ACM and IMDB on three routes each (the bucketed single
   dispatch, the per-bucket loop and the flat SGB). Each path runs the
   eager ``model.apply`` once, the counters set to 0 just before and read
   just after: every count must equal the count derived from the semantic
   graphs (one fused launch per NA call, and no launch of a K1 or K2 step
   wrapper). Then ``task.compile`` must capture the forward as a CUDA graph
   (its warm-up and capture launch each kernel twice that count), and three
   replays must tick no launch or dispatch counter and equal the eager
   forward bit for bit. Logits must be finite,
   within 1e-4 of the same route's forward on the CPU (plain versions; the
   projection sums in another order) and of the other routes, and
   ``session.query`` blocks at capacities 1, 8, 64 bit-identical to the
   full forward's rows. Then the wide path: HAN on ACM at
   ``max_degree=None`` (metapath PSP 527 wide) on the three routes at
   ``prune_k=None`` and 300, with the same checks; every route must run a
   K1 domain wider than 256 (the shared-memory domain). Then gemma3-4b LM
   serving at full width and depth
   as published (bfloat16 activations, float32 seeded weights,
   ``attn_prune_k=2048``): ``prefill`` of (4, 3072) tokens (no kernel #4
   launch) and 32 greedy eager ``decode_step``s, the counters set to 0
   before each step and read after it: exactly one launch of each kernel of
   the decode pair per global layer whose cache is wider than K (5 a step);
   then the same 32 steps through ``LM.compile_decode`` (one CUDA graph,
   captured at the first step, which counts each launch twice; replays
   count none), whose tokens, float32 logits and final cache must be the
   eager loop's bit for bit.
   One decode step of a float32 copy of the config, on the same weights
   and cache, must give logits within 1e-4 with the kernels and with their
   plain versions; one cycle of depth (6 layers) at full width in float32
   must give the same prefill and decode logits (1e-4) on the card and in
   the port's CPU forward, with a prompt long enough that pruning drops
   rows. The 32 decode steps are then replayed on the same tokens with
   decode K1 asked for its tie rows, which are counted. Then the Pruner
   through its entry point ``topk_select`` on the scores of two served
   paths (the counters set to 0 just before and read
   just after; no serving flow calls it): the ranks of every table the
   flat K1 prunes in one forward of RGAT and Simple-HGN on ACM, where
   ``nbr[row, ids]`` must equal, slot for slot, the ids of a ``keep=True``
   fused launch on each served launch's inputs (its output equal to the
   served one bit for bit), and
   gemma3-4b's float32 logits of the last global layer in decode step 1,
   where the ids, sorted ascending with -1 last, must equal decode K1's
   (which writes them in that canonical layout); on each of these inputs the
   kernel's values must also equal its plain version's bit for bit, and
   its ids slot for slot;
4. times each kernel and (for the aggregates) one library call twice: its
   device time per call from the profiler (CUPTI), and the CUDA-event time
   of back-to-back calls, which also holds the host's launch cost when the
   kernel is shorter than that; the plain versions with CUDA events. The
   grouped pair and its fused launch at the DBLP APA shapes, the flat pair
   and its fused launch at the ACM ``union:paper`` shapes of Simple-HGN's
   first layer, both pairs and fused launches on the wide path (HAN ACM PSP
   at ``prune_k=None``: flat k 527, grouped k_s 528; and at
   ``prune_k=300``), the decode pair at
   the inputs of gemma3-4b's last global layer in the first decode step;
   then every forward, eager and captured side by side (back to back,
   the median latency of a synchronized call, and on ACM the device's busy
   time from the profiler; where the profiler sees no kernel inside a
   replay, the run says so and the captured busy time is not measured);
   then the LM's prefill, its decode step eager and captured (medians of
   the main path's steps after the first, and back to back at one
   position) and tokens/s, and the decode pair's share of a decode step's
   device time; then the Pruner at three shapes (the reference's
   microbenchmark 2048 x 512 k 50, the ACM ``union:paper`` ranks and the
   gemma3-4b logits of phase 3) beside ``torch.topk`` as a yardstick; its
   row of the ``kernels`` line takes the times of the gemma3-4b logits,
   the widest shape phase 3 gives it, and lists all three by shape;
5. trains HAN, RGAT and Simple-HGN on ACM at ``scale=1.0`` (``prepare``'s
   defaults) on the GPU tasks phase 3 served, so training follows a
   session that filled the SGB's device caches under inference mode: the
   captured step (``task._train_step``: forward, backward, clip and AdamW
   in one CUDA graph) must give the CPU's first 3 losses (1e-5), 20
   captured steps the eager steps' losses (1e-5) and params (1e-4), and
   bit for bit so under deterministic algorithms; 200 captured steps must
   keep the loss finite and falling; then ``train_hgnn`` (200 steps) and
   ``benchmarks/fig9_accuracy.py``'s sweep on its params: the ``staged``
   accuracy, and at K = 2, 5, 10, 20, 50 a captured ``fused_kernel``
   session (checked as phase 3 checks one: kernel #1's launches a forward
   derived from the SGB, replays bit for bit the eager forward) whose
   accuracy must equal the ``fused`` flow's and whose logits must agree
   with it within 1e-4 on every row no tie at the K-th rank reaches (tie
   rows are counted and printed); a ``fig9_<model>_acm_K<k>`` line each;
   then the step's times (captured and eager, the CUDA-event median; the
   first step, warm-up and capture included; the device's busy share);
6. the SGB options and on-disk data, as the reference's ``sgb_scale`` and
   ``na_dispatch`` benchmarks run them, at ``scale=1.0``: ACM, IMDB and
   DBLP exported as dumps (``save_hetgraph``, npz) and loaded back equal
   array for array; then for HAN on DBLP and ACM, RGAT and Simple-HGN on
   ACM and IMDB, and RGAT on IMDB at ``max_degree=64``, ``prepare`` with
   ``bucket_sizes="auto"`` from the registry (no cache), then twice from
   the dump through an empty cache directory under ``build/``: a miss
   that writes one entry, then a hit that writes nothing and whose tables
   and grouped layouts are the miss's (and the registry build's) bit for
   bit. Each hit task (its tables read-only views into the mapped entry;
   a warning about a non-writable array fails the run) is served as phase
   3 serves a task, on the bucketed single dispatch and the per-bucket
   loop: launches of the eager forward derived from the SGB, captured,
   replays bit for bit; its logits bit for bit the miss task's session's,
   within 1e-4 of the default buckets' task on the card and of the CPU
   forward. Simple-HGN on ACM is also served with every parameter in
   bfloat16: captured, logits within 1e-4 of the CPU's and the same
   accuracy. Then kernel #1 and kernel #2 on HAN ACM's auto layout against
   its default one (held to their plain versions; device and event times,
   bounds) and each path's prepare seconds and captured forward times,
   auto beside default, printed with the card line;
7. serves RGAT on IMDB at ``scale=1.0``, ``max_degree=64`` (the setting
   of the reference's ``benchmarks/serve_load.py`` and
   ``examples/hgnn_serve.py``) through the serving front-end
   (``repro_torch.serve``) over the captured ``fused_kernel`` K = 8
   session, policy ``(1, 4, 8, 16)`` with a 2 ms flush timeout: 64
   requests of 1-4 targets at once through an inline front-end and through
   ``run_serial`` (rows bit for bit the full forward and each other, one
   query call a block, fewer blocks than requests, no launch or NA
   dispatch counter moving in a served window, the microbatched rate at
   least twice the serial one with a mean batch of at least 8); the
   device's busy share over the inline window and the double buffer in a
   burst (from profiler traces: was block k + 1 dispatched before block
   k's replay ended, did block k resolve before block k + 1's replay
   ended, any pageable host-to-device copy); the threaded front-end on
   paced Poisson arrivals at 2000 requests/s (rows bit for bit, both loop
   threads ended after ``close``); two tenants, seeded and trained (30
   steps), through one ``donate_params`` session and a streaming
   ``WeightPlane`` (pinned snapshots; each tenant's rows bit for bit its
   own forward); the primary failing for good behind a captured ``fused``
   fallback (the breaker trips, every block is served by the fallback bit
   for bit its forward, within 1e-4 of the primary's on rows no K-th-rank
   tie reaches, none fails); a threaded front-end whose drain fails for
   good (``close(timeout=0.5)`` returns, every future holds
   ``ServeClosedError``, both threads end); ids -1 and num_targets raising
   at ``submit`` before any launch, then a block served bit for bit;
8. prints a ``train {...}`` line with the step times, a ``serve {...}``
   line with the serving numbers (serial and microbatched wall time, QPS,
   p50/p99, mean batch, pad fraction and blocks; the threaded p50/p99; the
   busy share; the overlap counts), the card line, then the
   ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` as
   the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, published
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
TOL_ALPHA, TOL_OUT, TOL_LOGITS = 1e-6, 1e-5, 1e-4
SCALE = 1.0  # dataset scale of the main paths: the published node counts
PRUNE_K = 8
ROUTES = ("bucketed", "loop", "flat")
FLAT_SWEEP = ((11, 70, 8, 8, 200, 5), (8, 128, 8, 8, 64, 50), (5, 33, 4, 16, 40, 33), (2, 7, 2, 4, 10, 3))
REPORT = ROOT / "build" / "chip_smoke.json"  # the full report, beside the built kernels
DECODE_SWEEP = ((2, 8, 2, 16, 200, 12), (3, 4, 4, 8, 128, 5), (1, 16, 4, 32, 300, 50))
# the grouped K1's register domain and, past 256, its shared-memory domain:
# (k_s, bucket capacities, prune_k, targets, sources, edges); the budget
# case (k_s = MAX_KS) is added in kernel_cases
KS_CASES = ((1, (4, 8, 16), 1, 30, 50, 600), (2, (4, 8, 16), 2, 30, 50, 600),
            (16, (4, 8, 16, 64), 16, 30, 50, 600), (32, (8, 32, 64), 32, 30, 50, 600),
            (33, (8, 16, 64), 33, 30, 50, 600), (256, (8, 64, 400), 256, 20, 600, 4000),
            (257, (8, 64, 400), 257, 40, 600, 6000), (300, (8, 64, 400), 300, 40, 600, 6000),
            (528, (8, 300, 600), 528, 20, 600, 6000))
WIDE_PRUNE_K = (None, 300)  # the wide path: HAN ACM at max_degree=None
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "gemma3-4b", 4, 3072, 32
# the Pruner (kernel #3) in phase 2: the shapes of the reference's kernel
# tests (tests/test_kernels.py:15-83), and a row of special values (-NaN at
# index 5, filled in from its bits)
PRUNER_SHAPES = ((3, 17, 4), (8, 128, 50), (13, 300, 7), (1, 1, 1), (5, 260, 64), (7, 100, 4),
                 (9, 129, 8), (8, 127, 8), (15, 255, 16), (1, 3, 2), (8, 128, 8), (16, 256, 4))
SPECIAL_ROW = (-0.0, 0.0, 1.0, float("nan"), 2.0, float("nan"), float("inf"), float("-inf"), -3.0e38,
               -2.0e38, -1.5e38, 0.0, -0.0, -3.4e38, 1.0, 2.0)
# decode logits of the float32 config (|logit| up to ~10): kernel vs plain
# keep the same retained rows (their logits are bit-identical), so only K2's
# sum order and expf differ, ~1e-7 relative, carried through 34 layers; card
# vs CPU (6 layers) differ by the matmuls' sum order, TF32 off.
TOL_LM = 1e-4
CPU_CHECK_PROMPT = 2100  # > K = 2048: the global layer's retention domain drops rows
# HGNN training (phase 5): train_hgnn's defaults and fig9's thresholds
# (benchmarks/fig9_accuracy.py); card vs CPU and captured vs eager
# tolerances: the index backward adds with atomics on the card
TRAIN_STEPS, TRAIN_LR, TRAIN_CHECK_STEPS, TRAIN_TIMED = 200, 5e-3, 20, 20
FIG9_KS = (2, 5, 10, 20, 50)
TOL_TRAIN_LOSS, TOL_TRAIN_PARAMS = 1e-5, 1e-4
# phase 7, the serving front-end: the reference's serve_load.py / hgnn_serve.py
# setting (RGAT IMDB, max_degree 64, policy (1, 4, 8, 16) with a 2 ms flush
# timeout, 64 requests of 1-4 targets, 2000 req/s paced, 30 training steps)
SERVE_MAX_DEGREE, SERVE_CAPACITIES, SERVE_FLUSH = 64, (1, 4, 8, 16), 2e-3
SERVE_REQUESTS, SERVE_RATE, SERVE_TRAIN_STEPS = 64, 2000.0, 30
SERVE_REPEATS = 20  # each timed window replays the 64-request workload this many times


def check(cond, msg: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_launches(ops) -> None:
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0


def k1_widths(sgs, route: str, prune_k, ops) -> list:
    """The retention-domain width of each K1 launch of one NA layer,
    derived from the semantic graphs: per graph, the grouped K1 once when
    its layout has grid steps (bucketed route), the flat K1 once per
    non-empty bucket wider than K (loop route), or once per table wider
    than K (flat route); every table is wider than no K
    (``prune_k=None``)."""
    widths = []
    for sg in sgs:
        if route == "bucketed":
            layout = sg.grouped(ops.T_TILE, ops.W_TILE)
            if layout.num_steps > 0:
                widths.append(ops.grouped_meta(layout, prune_k)[2])
        elif route == "loop":
            widths += [b.capacity if prune_k is None else prune_k for b in sg.buckets
                       if b.num_targets > 0 and (prune_k is None or b.capacity > prune_k)]
        elif sg.num_targets > 0 and (prune_k is None or sg.nbr_idx.shape[1] > prune_k):
            widths.append(sg.nbr_idx.shape[1] if prune_k is None else prune_k)
    return widths


def expected_launches(sgs, route: str, prune_k, layers: int, ops) -> dict:
    """Kernel launches of one forward: per layer, the route's fused launch
    once per NA call ``k1_widths`` derives from the semantic graphs, and no
    launch of a K1 or K2 step wrapper."""
    n = len(k1_widths(sgs, route, prune_k, ops))
    out = {key: 0 for key in ops.LAUNCHES}
    out["prune_aggregate" if route == "bucketed" else "flat_prune_aggregate"] = layers * n
    return out


def same_bits(got, want) -> bool:
    """Equal tensors bit for bit (equal NaNs too)."""
    import torch

    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x  # noqa: E731
    return all(g.shape == w.shape and torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def check_fused(name, run, pair, launch_key, ops):
    """The fused launch ``run(keep)`` against its kernel pair's (out,
    alpha, ids), bit for bit, with ``keep=True`` and (out alone, the serving
    call) without; exactly one launch under ``launch_key`` each. Returns the
    fused output."""
    before = dict(ops.LAUNCHES)
    kept = run(True)
    served = run(False)
    launched = {key: n - before[key] for key, n in ops.LAUNCHES.items() if n != before[key]}
    check(launched == {launch_key: 2}, f"{name}: two fused calls launched {launched}")
    check(same_bits(kept, pair), f"{name}: the fused launch (keep=True) differs from the K1 -> K2 pair")
    check(same_bits((served,), pair[:1]), f"{name}: the fused launch's output differs from the pair's")
    return served


def captured_session(task, flow, want: dict, key: str, ops, dev, params=None):
    """One HGNN path served as its user calls it, on ``params`` (default:
    the task's): the eager ``model.apply`` once, whose launches must be
    ``want`` (the launches per forward); then ``task.compile(flow,
    params=params)``, which must capture the forward (its warm-up and
    capture launch each kernel twice as often); then three replays, which
    must tick no launch or dispatch counter and each equal the eager
    forward bit for bit. Returns the session, its logits and the eager
    forward's launches."""
    import torch

    from repro_torch.core import flows

    params = task.params if params is None else params
    reset_launches(ops)
    with torch.inference_mode():
        eager = task.model.apply(params, task.batch, flow)
    sync(dev)
    launches = dict(ops.LAUNCHES)
    check(launches == want, f"{key}: eager forward launches {launches}, expected {want}")
    reset_launches(ops)
    sess = task.compile(flow, params=params)
    sync(dev)
    built = dict(ops.LAUNCHES)
    check(sess.captured, f"{key}: the session is not a captured graph")
    check(built == {k: 2 * n for k, n in want.items()}, f"{key}: warm-up and capture launched {built}")
    reset_launches(ops)
    dispatch = dict(flows.DISPATCH)
    outs = [sess(params) for _ in range(3)]
    sync(dev)
    check(all(n == 0 for n in ops.LAUNCHES.values()) and flows.DISPATCH == dispatch,
          f"{key}: replays ticked launches {ops.LAUNCHES} or dispatch {flows.DISPATCH} (was {dispatch})")
    check(same_bits(outs, [eager] * 3), f"{key}: a captured forward differs from the eager forward")
    return sess, outs[0], launches


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_bucketed(hetgraph, rng, t, d, n, caps, num_etypes=1, edges=600):
    """The kernel tests' random bucketed graph (heavy-tailed degrees)."""
    import numpy as np

    src = rng.integers(0, n, size=edges).astype(np.int64)
    dst = np.minimum((t * rng.random(edges) ** 3).astype(np.int64), t - 1)
    ety = rng.integers(0, num_etypes, size=edges).astype(np.int64)
    nbr, msk, et = hetgraph._pad_csc(src, dst, t, d, np.random.default_rng(7), ety)
    return hetgraph.bucketize("g", ("x",), "x", nbr, msk, et, caps, num_edge_types=num_etypes)


def kernel_cases(hetgraph, tasks):
    """(name, graph, prune_k, N, H, dh, num_rel_types) for phase 2."""
    import numpy as np

    from repro_torch.kernels.fused_prune_aggregate import ops

    rng = np.random.default_rng(0)
    cases = []
    for caps, k in (((4, 8, 16), 6), ((5, 13), 7), ((64,), 6), ((4, 8), 100), ((4, 8, 16), None)):
        cases.append((f"random caps={caps} k={k}", random_bucketed(hetgraph, rng, 30, 40, 50, caps), k, 50, 4, 8, 0))
    cases.append(("relation term", random_bucketed(hetgraph, rng, 24, 32, 40, (4, 12), num_etypes=5), 6, 40, 4, 8, 5))
    sg = random_bucketed(hetgraph, rng, 12, 16, 30, (4, 8), edges=120)
    empty = hetgraph.DegreeBucket(
        targets=np.zeros(0, np.int32), nbr_idx=np.zeros((0, 6), np.int32),
        nbr_mask=np.zeros((0, 6), bool), edge_type=np.zeros((0, 6), np.int32),
    )
    cases.append(("empty bucket", hetgraph.BucketedSemanticGraph("e", ("x",), "x", 12, (empty,) + sg.buckets), 5, 30, 4, 8, 0))
    z = [np.zeros((5, 1), np.int32), np.zeros((5, 1), bool), np.zeros((5, 1), np.int32)]
    cases.append(("zero-edge graph", hetgraph.bucketize("z", ("x",), "x", *z, (2,)), 3, 30, 4, 8, 0))
    cases.append(("no buckets", hetgraph.BucketedSemanticGraph("none", ("x",), "x", 5, ()), 3, 30, 4, 8, 0))
    # the grouped K1's domain at its widths: in registers one slot a lane up
    # to k_s 32, two past it, eight at 256; in shared memory past 256, up to
    # the budget; pruned and bypass buckets, tie-heavy integer ranks and a
    # relation term
    budget = (ops.MAX_KS, (8, 64, ops.MAX_KS + 15), ops.MAX_KS, 4, 30000, 40000)
    for k_s, caps, k, t, n, edges in KS_CASES + (budget,):
        sg = random_bucketed(hetgraph, rng, t, max(caps) + 8, n, caps, num_etypes=3, edges=edges)
        kind = "register" if k_s <= 256 else "shared-memory"
        cases.append((f"{kind} domain k_s={k_s} caps={caps} k={k}", sg, k, n, 4, 8, 3))
    for ds, task in tasks.items():
        n = task.batch.total_nodes
        for sg in task.sgs:
            for k in (8, None) if ds == "acm" else (8, 32):
                cases.append((f"{ds} {sg.name} k={k}", sg, k, n, 8, 8, 0))
    return cases


def check_kernels(cases, dev):
    """Phase 2. Returns the largest alpha and output errors."""
    import torch

    from repro_torch.kernels.fused_prune_aggregate import ops, ref

    err = {"prune": 0.0, "aggregate": 0.0, "prune_aggregate": 0.0}
    gen = torch.Generator().manual_seed(0)
    for name, sg, k, n, h, dh, n_rel in cases:
        hp = torch.randn((n, h, dh), generator=gen).to(dev)
        ts = torch.randn((n, h), generator=gen).to(dev)
        domain_case = name.startswith(("register domain", "shared-memory domain"))
        if domain_case:  # small integers: ranks tie everywhere
            ts = torch.randint(-1, 2, (n, h), generator=gen).float().to(dev)
        td = torch.randn((sg.num_targets, h), generator=gen).to(dev)
        tr = torch.randn((n_rel, h), generator=gen).to(dev) if n_rel else None
        layout = sg.grouped(ops.T_TILE, ops.W_TILE)
        before = dict(ops.LAUNCHES)
        out = ops.fused_prune_aggregate_grouped(hp, ts, td, sg, theta_rel=tr, prune_k=k)
        if layout.num_steps == 0:
            check(ops.LAUNCHES == before, f"{name}: launched on a layout with no steps")
            check(torch.count_nonzero(out) == 0, f"{name}: nonzero output")
            print(f"  kernels == plain  {name}: no grid steps, zeros, no launch")
            continue
        (nbr, msk, ety, rt, perm), (blk, k_s) = ops._layout_device(layout, k, dev)
        if domain_case:
            check(f"k_s={k_s} " in name, f"{name}: the layout gives k_s {k_s}")
        ety = ety if tr is not None else None
        a_k, i_k = ops.prune(nbr, msk, ety, ts, tr, td, rt, blk, k_s)
        a_p, i_p = ref.prune_plain(nbr, msk, ety, ts, tr, td, rt, blk, k_s, 0.2)
        o_k = ops.aggregate(a_p, i_p, hp, blk)
        o_p = ref.aggregate_plain(a_p, i_p, hp, blk)
        o_f = check_fused(name, lambda keep: ops.prune_aggregate(nbr, msk, ety, ts, tr, td, rt, blk, k_s, hp,
                                                                  keep=keep),
                          (ops.aggregate(a_k, i_k, hp, blk), a_k, i_k), "prune_aggregate", ops)
        check(same_bits((out,), (o_f[perm],)), f"{name}: the grouped op differs from its fused launch")
        sync(dev)
        if not torch.equal(i_k, i_p):
            bad = int((i_k != i_p).sum())
            raise AssertionError(f"{name}: K1 retained ids differ from the plain version in {bad} slots")
        e_a = float((a_k - a_p).abs().max())
        e_o = float((o_k - o_p).abs().max())
        e_op = float((out - o_p[perm]).abs().max())
        if e_a > TOL_ALPHA or e_o > TOL_OUT or e_op > TOL_OUT:
            raise AssertionError(f"{name}: alpha err {e_a:.3g}, K2 err {e_o:.3g}, op err {e_op:.3g}")
        err["prune"] = max(err["prune"], e_a)
        err["aggregate"] = max(err["aggregate"], e_o)
        err["prune_aggregate"] = max(err["prune_aggregate"], e_op)
        print(f"  kernels == plain  {name}: k_s={k_s} steps={layout.num_steps} "
              f"ids equal, alpha err {e_a:.3g}, out err {max(e_o, e_op):.3g}; fused == pair bitwise")
    return err


def check_tie(hetgraph, dev):
    """a, b, c arrive in slot order with rank(a) = rank(b) < rank(c) at K=2:
    the kernel rule keeps {c in slot 0, b in slot 1}."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused_prune_aggregate import ops, ref

    nbr = np.array([[0, 1, 2], [3, 1, 0]], np.int32)
    msk = np.array([[True, True, True], [True, True, False]])
    sg = hetgraph.bucketize("tie", ("x",), "x", nbr, msk, np.zeros_like(nbr), ())
    ts = torch.randn((4, 4), generator=torch.Generator().manual_seed(1))
    ts[1] = ts[0]
    ts[2] = ts[0] + 1.0
    ts, td = ts.to(dev), torch.zeros((2, 4), device=dev)
    layout = sg.grouped(ops.T_TILE, ops.W_TILE)
    (nbr_t, msk_t, _, rt, _), (blk, k_s) = ops._layout_device(layout, 2, dev)
    _, i_k = ops.prune(nbr_t, msk_t, None, ts, None, td, rt, blk, k_s)
    _, i_p = ref.prune_plain(nbr_t, msk_t, None, ts, None, td, rt, blk, k_s, 0.2)
    got = i_k[int(layout.perm[0])].tolist()
    if got != [2, 1] or not torch.equal(i_k, i_p):
        raise AssertionError(f"tie case: kernel kept ids {got}, expected [2, 1]")
    print("  kernels == plain  score tie: kernel keeps {b, c} (first-minimum eviction)")


def flat_cases(acm_paper_sg, n_acm):
    """(name, nbr, msk, ety, N, H, dh, num_rel_types, k) for the flat pair
    in phase 2: numpy tables. Cases named "tie-heavy" rank on small
    integers."""
    import numpy as np

    from repro_torch.kernels.fused_prune_aggregate import ops

    rng = np.random.default_rng(1)

    def table(t, d, n, p_valid, r=0):
        idx = rng.integers(0, n, size=(t, d)).astype(np.int32)
        msk = rng.random((t, d)) < p_valid
        ety = rng.integers(0, r, size=(t, d)).astype(np.int32) if r else None
        return idx, msk, ety

    cases = []
    for t, d, h, dh, n, k in FLAT_SWEEP:
        cases.append((f"sweep t={t} d={d} h={h} dh={dh} k={k}", *table(t, d, n, 0.85), n, h, dh, 0, k))
    cases.append(("relation term", *table(6, 40, 50, 0.9, r=5), 50, 4, 8, 5, 8))
    cases.append(("k = D", *table(11, 70, 200, 0.85), 200, 8, 8, 0, 70))
    idx, msk, _ = table(9, 20, 30, 0.85)
    msk[3] = False
    cases.append(("empty row", idx, msk, None, 30, 4, 8, 0, 6))
    # the shared-memory domain past 256 slots, up to the budget
    for t, d, n, k in ((5, 300, 60, 257), (5, 340, 60, 300), (4, 600, 80, 528), (2, ops.MAX_KS + 3000, 30000, ops.MAX_KS)):
        cases.append((f"tie-heavy wide t={t} d={d} k={k}", *table(t, d, n, 0.9, r=3), n, 4, 8, 3, k))
    sg = acm_paper_sg
    for k in (PRUNE_K, None):
        cases.append((
            f"acm {sg.name} {sg.nbr_idx.shape[0]}x{sg.nbr_idx.shape[1]} k={k}", sg.nbr_idx, sg.nbr_mask,
            sg.edge_type, n_acm, 8, 8, sg.num_edge_types, k if k is not None else sg.nbr_idx.shape[1],
        ))
    return cases


def check_flat_kernels(cases, dev):
    """Phase 2, flat pair. Returns the largest alpha and output errors."""
    import torch

    from repro_torch.kernels.fused_prune_aggregate import ops, ref

    err = {"flat_prune": 0.0, "flat_aggregate": 0.0, "flat_prune_aggregate": 0.0}
    gen = torch.Generator().manual_seed(1)
    for name, idx, msk, ety, n, h, dh, n_rel, k in cases:
        t = idx.shape[0]
        hp = torch.randn((n, h, dh), generator=gen).to(dev)
        ts = torch.randn((n, h), generator=gen).to(dev)
        td = torch.randn((t, h), generator=gen).to(dev)
        tr = torch.randn((n_rel, h), generator=gen).to(dev) if n_rel else None
        if name.startswith("tie-heavy"):  # small integers: ranks tie everywhere
            ts = torch.randint(-1, 2, (n, h), generator=gen).float().to(dev)
            tr = torch.randint(-1, 2, (n_rel, h), generator=gen).float().to(dev)
        nbr = torch.from_numpy(idx).to(dev)
        mk = torch.from_numpy(msk).to(dev)
        et = torch.from_numpy(ety).to(dev) if n_rel else None
        a_k, i_k = ops.flat_prune(nbr, mk, et, ts, tr, td, k)
        a_p, i_p = ref.flat_prune_plain(nbr, mk, et, ts, tr, td, k, 0.2)
        o_k = ops.flat_aggregate(a_p, i_p, hp)
        o_p = ref.flat_aggregate_plain(a_p, i_p, hp)
        out = ops.fused_prune_aggregate(hp, ts, td, nbr, mk, theta_rel=tr, edge_type=et, prune_k=k)
        o_f = check_fused(f"flat {name}", lambda keep: ops.flat_prune_aggregate(nbr, mk, et, ts, tr, td, hp, k,
                                                                                keep=keep),
                          (ops.flat_aggregate(a_k, i_k, hp), a_k, i_k), "flat_prune_aggregate", ops)
        check(same_bits((out,), (o_f,)), f"flat {name}: the flat op differs from its fused launch")
        sync(dev)
        if not torch.equal(i_k, i_p):
            bad = int((i_k != i_p).sum())
            raise AssertionError(f"flat {name}: K1 retained ids differ from the plain version in {bad} slots")
        e_a = float((a_k - a_p).abs().max())
        e_f = float((out - o_p).abs().max())
        e_o = max(float((o_k - o_p).abs().max()), e_f)
        if e_a > TOL_ALPHA or e_o > TOL_OUT:
            raise AssertionError(f"flat {name}: alpha err {e_a:.3g}, out err {e_o:.3g}")
        empty = ~mk.any(dim=1)
        check(bool((i_k[empty] == -1).all()) and not bool(out[empty].any()),
              f"flat {name}: a row with no valid slot kept something")
        err["flat_prune"] = max(err["flat_prune"], e_a)
        err["flat_aggregate"] = max(err["flat_aggregate"], float((o_k - o_p).abs().max()))
        err["flat_prune_aggregate"] = max(err["flat_prune_aggregate"], e_f)
        print(f"  kernels == plain  flat {name}: ids equal, alpha err {e_a:.3g}, out err {e_o:.3g}"
              + (f", {int(empty.sum())} empty rows zero" if bool(empty.any()) else "") + "; fused == pair bitwise")
    return err


def check_flat_tie_and_width(dev):
    """Scores [1, 1, 2] at k = 2 in one flat row: the kernel keeps {b, c}
    (ids [c, b]); a flat domain of 257 slots (past the registers) runs and
    equals its plain version; a domain one past ``MAX_KS`` raises before any
    launch, flat and grouped."""
    import torch

    from repro_torch.kernels.fused_prune_aggregate import ops, ref

    nbr = torch.tensor([[0, 1, 2], [3, 1, 0]], dtype=torch.int32, device=dev)
    msk = torch.tensor([[True, True, True], [True, True, False]], device=dev)
    ts = torch.randn((4, 4), generator=torch.Generator().manual_seed(1))
    ts[1] = ts[0]
    ts[2] = ts[0] + 1.0
    ts, td = ts.to(dev), torch.zeros((2, 4), device=dev)
    _, i_k = ops.flat_prune(nbr, msk, None, ts, None, td, 2)
    _, i_p = ref.flat_prune_plain(nbr, msk, None, ts, None, td, 2, 0.2)
    got = i_k[0].tolist()
    if got != [2, 1] or not torch.equal(i_k, i_p):
        raise AssertionError(f"flat tie case: kernel kept ids {got}, expected [2, 1]")
    print("  kernels == plain  flat score tie: kernel keeps {b, c} (first-minimum eviction)")
    gen = torch.Generator().manual_seed(3)
    nbr = torch.randint(0, 4, (2, 300), generator=gen, dtype=torch.int32).to(dev)
    msk = (torch.rand((2, 300), generator=gen) < 0.95).to(dev)
    before = dict(ops.LAUNCHES)
    a_k, i_k = ops.flat_prune(nbr, msk, None, ts, None, td, 257)
    a_p, i_p = ref.flat_prune_plain(nbr, msk, None, ts, None, td, 257, 0.2)
    e_a = float((a_k - a_p).abs().max())
    check(ops.LAUNCHES["flat_prune"] == before["flat_prune"] + 1, "the k = 257 case did not launch the flat K1")
    check(torch.equal(i_k, i_p) and e_a <= TOL_ALPHA, f"flat k = 257: ids differ or alpha err {e_a:.3g}")
    print(f"  kernels == plain  flat k = 257 (shared-memory domain): ids equal, alpha err {e_a:.3g}")
    before = dict(ops.LAUNCHES)
    wide = torch.zeros((2, ops.MAX_KS + 1), dtype=torch.int32, device=dev)
    try:
        ops.fused_prune_aggregate(
            torch.zeros((4, 4, 2), device=dev), ts, td, wide, wide.bool(), prune_k=None
        )
    except ValueError as e:
        check(ops.LAUNCHES == before, f"the k = {ops.MAX_KS + 1} case launched a kernel")
        print(f"  k = {ops.MAX_KS + 1} raises before launch: {e}")
    else:
        raise AssertionError(f"a flat domain wider than {ops.MAX_KS} did not raise")
    blk = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    tiles = torch.zeros((1, 8, 8), dtype=torch.int32, device=dev)
    try:
        ops.prune(tiles, tiles.bool(), None, ts, None, td, torch.zeros(8, dtype=torch.int32, device=dev), blk,
                  ops.MAX_KS + 1)
    except ValueError as e:
        check(ops.LAUNCHES == before, f"the k_s = {ops.MAX_KS + 1} case launched a kernel")
        print(f"  k_s = {ops.MAX_KS + 1} raises before launch: {e}")
    else:
        raise AssertionError(f"a grouped domain wider than {ops.MAX_KS} did not raise")
    # the fused launches: the same widths, and an output row of H * dh 1025
    hp_wide, hp = torch.zeros((4, 1, 1025), device=dev), torch.zeros((4, 4, 2), device=dev)
    flat_idx = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    one_head = (ts[:, :1].contiguous(), td[:, :1].contiguous())
    for what, h_p, k, (theta, t_dst) in (("k = MAX_KS + 1", hp, ops.MAX_KS + 1, (ts, td)),
                                         ("H * dh = 1025", hp_wide, 2, one_head)):
        for kind, call in (
            ("flat", lambda: ops.flat_prune_aggregate(flat_idx, flat_idx.bool(), None, theta, None, t_dst, h_p, k)),
            ("grouped", lambda: ops.prune_aggregate(tiles, tiles.bool(), None, theta, None, t_dst,
                                                    torch.zeros(8, dtype=torch.int32, device=dev), blk, k, h_p)),
        ):
            try:
                call()
            except ValueError as e:
                check(ops.LAUNCHES == before, f"the fused {kind} launch at {what} launched a kernel")
                print(f"  fused {kind} at {what} raises before launch: {e}")
            else:
                raise AssertionError(f"the fused {kind} launch at {what} did not raise")


def prepare_route(pipeline, hetgraph, model, ds, route, dev):
    bucket_sizes = None if route == "flat" else hetgraph.DEFAULT_BUCKET_SIZES
    return pipeline.prepare(model, ds, scale=SCALE, seed=0, bucket_sizes=bucket_sizes, device=dev)


def route_flow(FlowConfig, route):
    return FlowConfig("fused_kernel", prune_k=PRUNE_K, bucket_dispatch="loop" if route == "loop" else "single")


def model_paths(pipeline, hetgraph, FlowConfig, ops, dev):
    """Phase 3, RGAT and Simple-HGN on ACM and IMDB, three routes each.
    Returns per-path results and the GPU tasks."""
    import numpy as np
    import torch

    results, gpu_tasks = {}, {}
    for model in ("rgat", "simple_hgn"):
        for ds in ("acm", "imdb"):
            logits_by_route = {}
            for route in ROUTES:
                key = f"{model}/{ds}/{route}"
                task = prepare_route(pipeline, hetgraph, model, ds, route, dev)
                cpu_task = prepare_route(pipeline, hetgraph, model, ds, route, torch.device("cpu"))
                gpu_tasks[key] = task
                flow = route_flow(FlowConfig, route)
                want = expected_launches(task.sgs, route, PRUNE_K, task.model.num_layers, ops)
                sess, logits, launches = captured_session(task, flow, want, key, ops, dev)
                if tuple(logits.shape) != sess.out_shape or not bool(torch.isfinite(logits).all()):
                    raise AssertionError(f"{key}: logits shape {tuple(logits.shape)} or non-finite values")
                err = float((logits.cpu() - cpu_task.compile(flow)(cpu_task.params)).abs().max())
                if err > TOL_LOGITS:
                    raise AssertionError(f"{key}: GPU logits differ from the CPU forward by {err:.3g}")
                rng = np.random.default_rng(0)
                for cap in (1, 8, 64):
                    idx = rng.integers(0, logits.shape[0], size=cap)
                    rows = sess.query(task.params, idx)
                    if not torch.equal(rows, sess(task.params)[torch.from_numpy(idx).to(dev)]):
                        raise AssertionError(f"{key}: query block (capacity {cap}) differs from the full rows")
                logits_by_route[route] = logits
                results[key] = {
                    "launches": launches, "logits_shape": list(logits.shape),
                    "max_abs_err_vs_cpu": err, "query_blocks_bit_identical": 3, "captured_bitwise_eager": 3,
                }
                print(f"  main path {key}: launches "
                      f"{ {k: v for k, v in launches.items() if v} } a forward, captured (3 replays == eager "
                      f"bitwise, no counter ticked), logits {tuple(logits.shape)} finite, |gpu-cpu| {err:.3g}, "
                      "3 query blocks bit-identical")
            for route in ROUTES[1:]:
                d = float((logits_by_route[route] - logits_by_route[ROUTES[0]]).abs().max())
                if d > TOL_LOGITS:
                    raise AssertionError(f"{model}/{ds}: route {route} differs from {ROUTES[0]} by {d:.3g}")
                results[f"{model}/{ds}/{route}"]["max_abs_diff_vs_bucketed"] = d
            print(f"  routes agree {model}/{ds}: " + ", ".join(
                f"{r} {results[f'{model}/{ds}/{r}']['max_abs_diff_vs_bucketed']:.3g}" for r in ROUTES[1:]))
    return results, gpu_tasks


def wide_paths(pipeline, hetgraph, FlowConfig, ops, dev):
    """Phase 3, the wide path: HAN on ACM at ``max_degree=None`` (metapath
    PSP up to 527 neighbors) on the three routes at each of
    ``WIDE_PRUNE_K``, with the checks of ``model_paths``; each route must
    run a K1 domain wider than 256. Returns per-path results and the GPU
    tasks by route."""
    import numpy as np
    import torch

    tasks = {}
    for route in ROUTES:
        kw = dict(scale=SCALE, max_degree=None, seed=0, bucket_sizes=None if route == "flat" else hetgraph.DEFAULT_BUCKET_SIZES)
        tasks[route] = (pipeline.prepare("han", "acm", device=dev, **kw), pipeline.prepare("han", "acm", device="cpu", **kw))
    results = {}
    for pk in WIDE_PRUNE_K:
        logits_by_route = {}
        for route in ROUTES:
            key = f"han/acm/max_degree=None/prune_k={pk}/{route}"
            task, cpu_task = tasks[route]
            flow = FlowConfig("fused_kernel", prune_k=pk, bucket_dispatch="loop" if route == "loop" else "single")
            want = expected_launches(task.sgs, route, pk, 1, ops)
            widths = k1_widths(task.sgs, route, pk, ops)
            check(max(widths) > 256, f"{key}: no K1 domain wider than 256 ({widths})")
            sess, logits, launches = captured_session(task, flow, want, key, ops, dev)
            if tuple(logits.shape) != sess.out_shape or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{key}: logits shape {tuple(logits.shape)} or non-finite values")
            err = float((logits.cpu() - cpu_task.compile(flow)(cpu_task.params)).abs().max())
            if err > TOL_LOGITS:
                raise AssertionError(f"{key}: GPU logits differ from the CPU forward by {err:.3g}")
            rng = np.random.default_rng(0)
            for cap in (1, 8, 64):
                idx = rng.integers(0, logits.shape[0], size=cap)
                rows = sess.query(task.params, idx)
                if not torch.equal(rows, sess(task.params)[torch.from_numpy(idx).to(dev)]):
                    raise AssertionError(f"{key}: query block (capacity {cap}) differs from the full rows")
            logits_by_route[route] = logits
            results[key] = {
                "launches": launches, "k1_widths": widths, "wide_launches": sum(w > 256 for w in widths),
                "logits_shape": list(logits.shape), "max_abs_err_vs_cpu": err, "query_blocks_bit_identical": 3,
                "captured_bitwise_eager": 3,
            }
            print(f"  wide path {key}: launches {launches} a forward, K1 widths {widths}, captured (3 replays "
                  f"== eager bitwise, no counter ticked), logits {tuple(logits.shape)} finite, |gpu-cpu| {err:.3g}, "
                  "3 query blocks bit-identical")
        for route in ROUTES[1:]:
            d = float((logits_by_route[route] - logits_by_route[ROUTES[0]]).abs().max())
            if d > TOL_LOGITS:
                raise AssertionError(f"wide path prune_k={pk}: route {route} differs from {ROUTES[0]} by {d:.3g}")
            results[f"han/acm/max_degree=None/prune_k={pk}/{route}"]["max_abs_diff_vs_bucketed"] = d
        print(f"  routes agree wide path prune_k={pk}: " + ", ".join(
            f"{r} {results[f'han/acm/max_degree=None/prune_k={pk}/{r}']['max_abs_diff_vs_bucketed']:.3g}"
            for r in ROUTES[1:]))
    return results, {route: gpu for route, (gpu, _) in tasks.items()}


def k1_bound(msk, nbr, ety, theta_src, theta_rel, theta_dst, alpha, ids, table_bytes: int = 0):
    """A K1's bound from this run's inputs: the bytes of every slot's mask,
    the ids (and edge types) of the valid slots, the theta_src rows they
    reference, theta_rel, theta_dst, the row tables and the outputs; the
    operations of a head sum (two adds a head with theta_rel) and a compare
    a valid slot, and six an output alpha. Returns (bound, valid slots,
    distinct source rows)."""
    import torch

    valid = int(msk.sum())
    src_rows = int(torch.unique(nbr[msk]).numel())
    heads = theta_src.shape[1]
    rel = theta_rel is not None
    nbytes = msk.numel() * msk.element_size() + valid * (nbr.element_size() + (ety.element_size() if rel else 0)) \
        + (src_rows * heads + (theta_rel.numel() if rel else 0) + theta_dst.numel()) * 4 + table_bytes \
        + (alpha.numel() + ids.numel()) * 4
    nops = valid * ((2 if rel else 1) * heads + 1) + alpha.numel() * 6
    return bound(nbytes, nops), valid, src_rows


def k2_bound(alpha, ids, h_proj, out, table_bytes: int = 0):
    """A K2's bound from this run's inputs: alpha, ids, the row tables, each
    distinct retained h' row once and the output; an FMA a retained slot and
    output. Returns (bound, retained slots, distinct retained rows)."""
    import torch

    retained = ids[ids >= 0]
    distinct = int(torch.unique(retained).numel())
    hdim = h_proj.shape[1] * h_proj.shape[2]
    nbytes = (alpha.numel() + ids.numel()) * 4 + table_bytes + distinct * hdim * 4 + out.numel() * 4
    return bound(nbytes, 2 * int(retained.numel()) * hdim), int(retained.numel()), distinct


def fused_bound(k1, alpha, ids, h_proj, out):
    """A fused launch's bound: its K1's bytes and operations (``k1``, from
    ``k1_bound``) less the alpha and ids writes and the six operations an
    output alpha, which it need not make, plus six operations a retained
    slot and head (its softmax runs on retained slots only), each distinct
    retained h' row once, the output, and an FMA a retained slot and
    output."""
    import torch

    _, _, nbytes, nops = k1
    retained = ids[ids >= 0]
    heads, hdim = h_proj.shape[1], h_proj.shape[1] * h_proj.shape[2]
    nbytes += -(alpha.numel() + ids.numel()) * 4 + int(torch.unique(retained).numel()) * hdim * 4 + out.numel() * 4
    nops += (int(retained.numel()) * heads - alpha.numel()) * 6 + 2 * int(retained.numel()) * hdim
    return bound(nbytes, nops)


def wide_timings(tasks, dev):
    """Phase 4, the wide path at HAN ACM PSP (real projected features and
    weights) on the flat route's table (k 527 at ``prune_k=None``, 300 at
    300) and the bucketed route's layout (k_s 528 at ``prune_k=None``, every
    bucket a bypass; pruned buckets beside bypass ones at 300): K1, K2 and
    the fused launch, which must equal the pair bit for bit. Kernel and
    plain times, the largest differences from the plain versions, and the
    bounds; keys ``<step>_wide`` at ``prune_k=None``, ``<step>_wide300`` at
    300."""
    import torch

    from repro_torch.core import attention, flows
    from repro_torch.core.projection import project_features
    from repro_torch.kernels.fused_prune_aggregate import ops, ref

    t, bounds, shapes, err = {}, {}, {}, {}
    with torch.inference_mode():
        for route, base in (("flat", "flat_"), ("bucketed", "")):
            task = tasks[route]
            p, batch, model = task.params, task.batch, task.model
            sg = next(g for g in task.sgs if g.name == "PSP")
            h = project_features(p, batch.features, batch.node_types, model.heads, model.dh)
            dst = slice(batch.dst_offset, batch.dst_offset + batch.num_targets)
            sc = attention.decompose_scores(h, p[f"attn.{sg.name}.a_src"], p[f"attn.{sg.name}.a_dst"], dst)
            for pk, tag in ((None, "_wide"), (300, "_wide300")):
                if route == "flat":
                    nbr, msk, _ = flows._flat_tables(sg, False, dev)
                    k = nbr.shape[1] if pk is None else min(pk, nbr.shape[1])
                    k1_args = (nbr, msk, None, sc.theta_src, None, sc.theta_dst)
                    prune, plain_prune = (lambda: ops.flat_prune(*k1_args, k)), (lambda: ref.flat_prune_plain(*k1_args, k, 0.2))
                    agg = lambda a, i: ops.flat_aggregate(a, i, h)  # noqa: E731
                    fused = lambda keep: ops.flat_prune_aggregate(*k1_args, h, k, keep=keep)  # noqa: E731
                    plain_fused = lambda: ref.flat_prune_aggregate_plain(*k1_args, h, k, 0.2)  # noqa: E731
                    table_bytes = k2_table = 0
                    desc = f"han acm {sg.name} flat table {tuple(nbr.shape)}, k={k}, prune_k={pk}"
                else:
                    layout = sg.grouped(ops.T_TILE, ops.W_TILE)
                    (nbr, msk, _, rt, _), (blk, k) = ops._layout_device(layout, pk, dev)
                    k1_args = (nbr, msk, None, sc.theta_src, None, sc.theta_dst, rt, blk, k)
                    prune, plain_prune = (lambda: ops.prune(*k1_args)), (lambda: ref.prune_plain(*k1_args, 0.2))
                    agg = lambda a, i: ops.aggregate(a, i, h, blk)  # noqa: E731
                    fused = lambda keep: ops.prune_aggregate(*k1_args, h, keep=keep)  # noqa: E731
                    plain_fused = lambda: ref.prune_aggregate_plain(*k1_args, h, 0.2)  # noqa: E731
                    table_bytes, k2_table = (rt.numel() + blk.numel()) * 4, blk.numel() * 4
                    desc = (f"han acm {sg.name} grouped, {layout.num_rows} rows, {layout.num_steps} grid steps, "
                            f"k_s={k}, prune_k={pk}")
                k1_key, k2_key, f_key = (f"{base}{step}{tag}" for step in ("prune", "aggregate", "prune_aggregate"))
                alpha, ids = prune()
                out = agg(alpha, ids)
                o_p, a_p, i_p = plain_fused()
                sync(dev)
                check(torch.equal(ids, i_p), f"wide {k1_key}: ids differ from the plain version")
                o_f = check_fused(f"wide {f_key}", fused, (out, alpha, ids),
                                  "flat_prune_aggregate" if route == "flat" else "prune_aggregate", ops)
                err[k1_key] = float((alpha - a_p).abs().max())
                err[f_key] = float((o_f - o_p).abs().max())
                check(err[k1_key] <= TOL_ALPHA and err[f_key] <= TOL_OUT,
                      f"wide {f_key}: alpha err {err[k1_key]:.3g}, out err {err[f_key]:.3g}")
                t[f"{k1_key}_plain"] = cuda_ms(plain_prune, 1, warmup=1)
                t[f"{f_key}_plain"] = cuda_ms(plain_fused, 1, warmup=1)
                timed(t, k1_key, prune, 50)
                timed(t, k2_key, lambda: agg(alpha, ids), 50)
                timed(t, f_key, lambda: fused(False), 50)
                k1, valid, _ = k1_bound(msk, nbr, None, sc.theta_src, None, sc.theta_dst, alpha, ids, table_bytes)
                bounds[k1_key] = k1
                bounds[k2_key] = k2_bound(alpha, ids, h, out, k2_table)[0]
                bounds[f_key] = fused_bound(k1, alpha, ids, h, out)
                for key in (k1_key, k2_key, f_key):
                    shapes[key] = desc
                print(f"  wide {desc} ({valid} valid slots): K1 {t[k1_key]:.4f} ms (bound {k1[0]:.5f}), "
                      f"K2 {t[k2_key]:.4f} ms, fused {t[f_key]:.4f} ms (events {t[f'{f_key}_event']:.4f}, "
                      f"bound {bounds[f_key][0]:.5f}), plain K1 {t[f'{k1_key}_plain']:.1f} ms, "
                      f"plain fused {t[f'{f_key}_plain']:.1f} ms; fused == pair bitwise")
    return t, bounds, shapes, err


def flat_timings(task, dev):
    """Phase 4, flat pair, at the ACM union:paper shapes of Simple-HGN's
    first layer (real projected features and weights, the relation term
    on): kernel, plain and library times, and the bounds from the bytes and
    operations this run's inputs need."""
    import torch

    from repro_torch.core import attention, flows
    from repro_torch.core.projection import project_features
    from repro_torch.kernels.fused_prune_aggregate import ops, ref

    p, batch, model = task.params, task.batch, task.model
    sg = batch.sg_by_dst["paper"]
    heads, dh = model.heads, model.dh
    with torch.inference_mode():
        h = project_features(p, batch.features, batch.node_types, heads, dh, "layers.0.")
        off, nt = batch.offsets["paper"], batch.num_nodes["paper"]
        sc = attention.decompose_scores(
            h, p["layers.0.a_src"], p["layers.0.a_dst"], slice(off, off + nt),
            rel_emb=p["layers.0.rel_emb"].reshape(-1, heads, model.rel_dim), a_rel=p["layers.0.a_rel"],
        )
        nbr, msk, ety = flows._flat_tables(sg, True, dev)
        args = (nbr, msk, ety, sc.theta_src, sc.theta_rel, sc.theta_dst, PRUNE_K)
        alpha, ids = ops.flat_prune(*args)
        out = ops.flat_aggregate(alpha, ids, h)
        t = {
            "flat_prune_plain": cuda_ms(lambda: ref.flat_prune_plain(*args, 0.2), 5, warmup=1),
            "flat_aggregate_plain": cuda_ms(lambda: ref.flat_aggregate_plain(alpha, ids, h), 20),
        }
        fused = lambda keep: ops.flat_prune_aggregate(*args[:6], h, PRUNE_K, keep=keep)  # noqa: E731
        check_fused("flat timing shapes", fused, (out, alpha, ids), "flat_prune_aggregate", ops)
        t["flat_prune_aggregate_plain"] = cuda_ms(lambda: ref.flat_prune_aggregate_plain(*args[:6], h, PRUNE_K, 0.2),
                                                  5, warmup=1)
        timed(t, "flat_prune", lambda: ops.flat_prune(*args), 200)
        timed(t, "flat_aggregate", lambda: ops.flat_aggregate(alpha, ids, h), 200)
        timed(t, "flat_prune_aggregate", lambda: fused(False), 200)
        lib_fn, lib_err = library_aggregate(alpha, ids, h, out)
        check(lib_err <= TOL_OUT, f"library flat K2 differs from the kernel by {lib_err:.3g}")
        timed(t, "flat_aggregate_library", lib_fn, 200)
        torch.cuda.synchronize()
        rows, k, _ = alpha.shape
        # bytes this run's data needs: K1's (k1_bound), K2's (k2_bound), and
        # the fused launch's (fused_bound)
        k1, valid, src_rows = k1_bound(msk, nbr, ety, sc.theta_src, sc.theta_rel, sc.theta_dst, alpha, ids)
        k2, retained, distinct = k2_bound(alpha, ids, h, out)
    bounds = {"flat_prune": k1, "flat_aggregate": k2, "flat_prune_aggregate": fused_bound(k1, alpha, ids, h, out)}
    shapes = {
        "graph": f"acm {sg.name} (simple_hgn layer 0)", "rows": rows, "width": int(nbr.shape[1]), "k": k,
        "edge_types": int(sc.theta_rel.shape[0]), "valid_edge_slots": valid,
        "distinct_source_rows": src_rows, "retained_slots": retained, "distinct_retained_rows": distinct,
    }
    return t, bounds, shapes


def main_path(pipeline, FlowConfig, ops, cpu_tasks, dev):
    """Phase 3. Returns per-dataset results and the GPU tasks."""
    import numpy as np
    import torch

    flow = FlowConfig("fused_kernel", prune_k=PRUNE_K)
    results, gpu_tasks = {}, {}
    for ds, cpu_task in cpu_tasks.items():
        t0 = time.perf_counter()
        task = pipeline.prepare("han", ds, scale=SCALE, seed=0, device=dev)
        prep_s = time.perf_counter() - t0
        gpu_tasks[ds] = task
        for name, p in task.params.items():
            check(torch.equal(p.cpu(), cpu_task.params[name]), f"{ds}: weights differ on {name}")
        n_sg = len(task.sgs)
        want = expected_launches(task.sgs, "bucketed", PRUNE_K, 1, ops)
        check(want["prune_aggregate"] == n_sg, f"{ds}: a semantic graph has no grid steps")
        sess, logits, launches = captured_session(task, flow, want, f"han/{ds}", ops, dev)
        if tuple(logits.shape) != sess.out_shape or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{ds}: logits shape {tuple(logits.shape)} or non-finite values")
        cpu_logits = cpu_task.compile(flow)(cpu_task.params)
        err = float((logits.cpu() - cpu_logits).abs().max())
        if err > TOL_LOGITS:
            raise AssertionError(f"{ds}: GPU logits differ from the CPU forward by {err:.3g}")
        rng = np.random.default_rng(0)
        n_blocks = 0
        for cap in (1, 8, 64):
            for _ in range(3):
                idx = rng.integers(0, logits.shape[0], size=cap)
                rows = sess.query(task.params, idx)
                full = sess(task.params)
                if not torch.equal(rows, full[torch.from_numpy(idx).to(dev)]):
                    raise AssertionError(f"{ds}: query block (capacity {cap}) differs from the full rows")
                n_blocks += 1
        results[f"han/{ds}"] = {
            "semantic_graphs": [sg.name for sg in task.sgs], "launches": launches,
            "logits_shape": list(logits.shape), "max_abs_err_vs_cpu": err,
            "query_blocks_bit_identical": n_blocks, "prepare_s": prep_s, "captured_bitwise_eager": 3,
        }
        print(f"  main path han/{ds}: {n_sg} semantic graphs, launches {launches} a forward, captured "
              f"(3 replays == eager bitwise, no counter ticked), logits {tuple(logits.shape)} finite, "
              f"|gpu-cpu| {err:.3g}, {n_blocks} query blocks bit-identical")
    return results, gpu_tasks


def library_aggregate(alpha, ids, h, out):
    """K2 as one library call: a CSR sparse-dense product, row r*H + hh of
    the sparse matrix holding alpha[r, :, hh] at columns id*H + hh. Returns
    the call and its largest difference from ``out``."""
    import torch

    rows, _, heads = alpha.shape
    n, _, dh = h.shape
    r_i, s_i = torch.nonzero(ids >= 0, as_tuple=True)
    hh = torch.arange(heads, device=alpha.device)
    with torch.sparse.check_sparse_tensor_invariants(enable=True):
        coo = torch.sparse_coo_tensor(
            torch.stack([(r_i[:, None] * heads + hh).reshape(-1),
                         (ids[r_i, s_i].long()[:, None] * heads + hh).reshape(-1)]),
            alpha[r_i, s_i].reshape(-1), size=(rows * heads, n * heads),
        )
        csr = coo.coalesce().to_sparse_csr()
    hflat = h.reshape(n * heads, dh)
    lib_out = torch.sparse.mm(csr, hflat).reshape(rows, heads, dh)
    return (lambda: torch.sparse.mm(csr, hflat)), float((lib_out - out).abs().max())


def bound(nbytes: int, nops: int):
    """(least ms, what bounds it, bytes, operations) on the published H100
    peaks."""
    b_ms, o_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_FLOPS * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, nops


def grouped_timings(task, dev):
    """Phase 4, grouped pair, at the DBLP APA shapes: kernel, plain and library times, and
    the bounds from the bytes and operations this run's inputs need."""
    import torch

    from repro_torch.core import attention
    from repro_torch.core.projection import project_features
    from repro_torch.kernels.fused_prune_aggregate import ops, ref

    p, batch, sg = task.params, task.batch, task.sgs[0]
    with torch.inference_mode():
        h = project_features(p, batch.features, batch.node_types, 8, 8)
        dst = slice(batch.dst_offset, batch.dst_offset + batch.num_targets)
        sc = attention.decompose_scores(h, p[f"attn.{sg.name}.a_src"], p[f"attn.{sg.name}.a_dst"], dst)
        layout = sg.grouped(ops.T_TILE, ops.W_TILE)
        (nbr, msk, _, rt, _), (blk, k_s) = ops._layout_device(layout, 8, dev)
        args = (nbr, msk, None, sc.theta_src, None, sc.theta_dst, rt, blk, k_s)
        alpha, ids = ops.prune(*args)
        out = ops.aggregate(alpha, ids, h, blk)
        t = {
            "prune_plain": cuda_ms(lambda: ref.prune_plain(*args, 0.2), 5, warmup=1),
            "aggregate_plain": cuda_ms(lambda: ref.aggregate_plain(alpha, ids, h, blk), 20),
        }
        fused = lambda keep: ops.prune_aggregate(*args, h, keep=keep)  # noqa: E731
        check_fused("grouped timing shapes", fused, (out, alpha, ids), "prune_aggregate", ops)
        t["prune_aggregate_plain"] = cuda_ms(lambda: ref.prune_aggregate_plain(*args, h, 0.2), 5, warmup=1)
        timed(t, "prune", lambda: ops.prune(*args), 200)
        timed(t, "aggregate", lambda: ops.aggregate(alpha, ids, h, blk), 200)
        timed(t, "prune_aggregate", lambda: fused(False), 200)
        lib_fn, lib_err = library_aggregate(alpha, ids, h, out)
        check(lib_err <= TOL_OUT, f"library K2 differs from the kernel by {lib_err:.3g}")
        timed(t, "aggregate_library", lib_fn, 200)
        torch.cuda.synchronize()
        rows = alpha.shape[0]
        # bytes this run's data needs: K1's (k1_bound, with the row tables),
        # K2's (k2_bound, with the block table) and the fused launch's
        k1, valid, src_rows = k1_bound(msk, nbr, None, sc.theta_src, None, sc.theta_dst, alpha, ids,
                                       (rt.numel() + blk.numel()) * 4)
        k2, retained, distinct = k2_bound(alpha, ids, h, out, blk.numel() * 4)
    bounds = {"prune": k1, "aggregate": k2, "prune_aggregate": fused_bound(k1, alpha, ids, h, out)}
    shapes = {
        "graph": f"dblp {sg.name}", "grid_steps": layout.num_steps, "rows": rows, "k_s": k_s,
        "valid_edge_slots": valid, "distinct_source_rows": src_rows,
        "retained_slots": retained, "distinct_retained_rows": distinct,
    }
    return t, bounds, shapes


def device_times(fn, reps: int) -> dict:
    """Device time per call of ``fn`` by kernel name (torch.profiler,
    CUPTI), over ``reps`` calls after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed as device events
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            per_kernel[ev.key] = us / reps / 1e3
    return per_kernel


def host_ops(fn) -> int:
    """PyTorch operators the host dispatches in one call of ``fn``: the
    top-level ``aten::`` events of a CPU profile (operators called from
    inside another operator are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(
        1 for ev in prof.events()
        if ev.name.startswith("aten::") and (ev.cpu_parent is None or not ev.cpu_parent.name.startswith("aten::"))
    )


def timed(t: dict, key: str, fn, iters: int) -> None:
    """Two times per call of ``fn`` into ``t``: ``key`` is the device time
    (the sum of its kernels' times from the profiler), ``key_event`` the
    CUDA-event time of back-to-back calls, which also holds the host's
    launch cost when the kernels are shorter than it. Without profiler
    data ``key`` is the event time (``key_source`` says which)."""
    t[f"{key}_event"] = cuda_ms(fn, iters)
    dev = sum(device_times(fn, 50).values())
    t[key] = dev if dev > 0 else t[f"{key}_event"]
    t[f"{key}_source"] = "profiler" if dev > 0 else "events"


def forward_profile(fn, forward_ms: float, reps: int = 5):
    """Device time per forward ``fn()`` by kernel name and the device's busy
    share of the event-timed forward. ``None`` when the profiler sees no
    device time (it may not see the kernels inside a graph replay)."""
    per_kernel = device_times(fn, reps)
    busy = sum(per_kernel.values())
    if busy == 0:
        return None
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "device_busy_ms": busy, "forward_ms": forward_ms, "busy_share": busy / forward_ms,
        "top_kernels_ms": [[name[:80], ms] for name, ms in top],
    }


def decode_cases():
    """(name, B, H, Hkv, dh, S, k, lengths, dtype) for the decode pair in
    phase 2."""
    import numpy as np

    rng = np.random.default_rng(2)
    cases = []
    for b, h, hkv, dh, s, k in DECODE_SWEEP:
        cases.append((f"sweep b={b} h={h} hkv={hkv} dh={dh} s={s} k={k}", b, h, hkv, dh, s, k,
                      rng.integers(k + 1, s, size=(b,)), "float32"))
    cases.append(("k >= length", 2, 4, 2, 8, 64, 64, [40, 64], "float32"))
    cases.append(("per-row lengths, one below K", 3, 8, 2, 16, 160, 50, [17, 51, 160], "float32"))
    cases.append(("integer q and keys (tie-heavy logits)", 2, 8, 2, 16, 180, 40, [180, 97], "ints"))
    for dt in ("float32", "bfloat16"):
        cases.append((f"gemma3-4b decode shapes {dt}", 4, 8, 4, 256, 3104, 2048, [3104, 3090, 3073, 3100], dt))
    # K2's edges: k = 1 with an empty row, k not a multiple of 32 nor of the
    # 64 parts a (batch, q-head) is split into, rows not a multiple of 16 B
    cases.append(("k = 1, one row empty", 2, 4, 2, 8, 64, 1, [0, 64], "float32"))
    cases.append(("k = 77", 1, 8, 2, 16, 200, 77, [190], "float32"))
    cases.append(("dh 12 bfloat16 (24 B rows)", 2, 4, 2, 12, 100, 33, [100, 60], "bfloat16"))
    cases.append(("dh 5 (20 B rows)", 1, 4, 1, 5, 90, 40, [90], "float32"))
    return cases


def check_decode_kernels(dev):
    """Phase 2, decode pair. Returns the largest alpha and output errors."""
    import numpy as np
    import torch

    from repro_torch.kernels.topk_decode_attention import ops, ref

    err = {"score_prune": 0.0, "value_gather": 0.0}
    gen = torch.Generator().manual_seed(2)
    ties = {}
    for name, b, h, hkv, dh, s, k, lens, dt in decode_cases():
        dtype = torch.float32 if dt == "ints" else getattr(torch, dt)
        q, kc, vc = (torch.randn(shape, generator=gen).to(dev, dtype)
                     for shape in ((b, h, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
        if dt == "ints":  # small integers: exact logits, ties everywhere
            q, kc = q.round().clamp(-1, 1), kc.round().clamp(-1, 1)
        lens = torch.tensor(np.asarray(lens), dtype=torch.int32, device=dev)
        scale = dh ** -0.5
        a_k, i_k, tie = ops.score_prune(q, kc, lens, k, scale, tie_rows=True)
        a_p, i_p = ref.score_prune_plain(q, kc, lens, k, scale)
        tie_p = ref.tie_rows_plain(ref.score_logits_plain(q, kc, scale), lens, k)
        o_k = ops.value_gather(a_p, i_p, vc)
        o_p = ref.value_gather_plain(a_p, i_p, vc)
        out = ops.topk_decode_attention(q, kc, vc, lens, k)
        # K2 on empty slots: one (batch, q-head) all -1, every third slot -1
        holes = i_p.clone()
        holes[0, 0] = -1
        holes[..., ::3] = -1
        o_h = ops.value_gather(a_p, holes, vc)
        o_hp = ref.value_gather_plain(a_p, holes, vc)
        again = (ops.value_gather(a_p, i_p, vc), ops.value_gather(a_p, holes, vc))
        sync(dev)
        if not torch.equal(i_k, i_p):
            bad = int((i_k != i_p).sum())
            raise AssertionError(f"decode {name}: K1 retained ids differ from the plain version in {bad} slots")
        check(torch.equal(again[0], o_k) and torch.equal(again[1], o_h),
              f"decode {name}: two K2 calls on the same inputs differ")
        check(not bool(o_h[0, 0].any()), f"decode {name}: K2 of a (batch, q-head) with no retained row is not 0")
        check(torch.equal(tie, tie_p), f"decode {name}: K1's tie rows {tie.tolist()} are not {tie_p.tolist()}")
        n_tie = int(tie.sum())
        ties[name] = n_tie
        if name.startswith("sweep"):  # Gaussian logits: no ties at the K-th
            check(n_tie == 0, f"decode {name}: {n_tie} rows took the tie path")
        if dt == "ints":
            check(n_tie > 0, f"decode {name}: no row took the tie path")
        e_a = float((a_k - a_p).abs().max())
        e_o = max(float((o_k - o_p).abs().max()), float((out - o_p).abs().max()), float((o_h - o_hp).abs().max()))
        if e_a > TOL_ALPHA or e_o > TOL_OUT:
            raise AssertionError(f"decode {name}: alpha err {e_a:.3g}, out err {e_o:.3g}")
        extra = ""
        if k >= s:
            e_d = float((out - ref.full_decode_attention(q, kc, vc, lens)).abs().max())
            check(e_d <= TOL_OUT, f"decode {name}: differs from the dense attention by {e_d:.3g}")
            extra = f", dense err {e_d:.3g}"
        short = lens < k
        if bool(short.any()):
            pos = torch.arange(k, device=dev)
            want_empty = pos[None, None, :] >= lens[:, None, None]
            check(bool(((i_k == -1) == want_empty.expand_as(i_k))[short].all()),
                  f"decode {name}: a row shorter than K kept a wrong set of slots")
            extra += f", {int(short.sum())} row(s) below K keep only their valid positions"
        err["score_prune"] = max(err["score_prune"], e_a)
        err["value_gather"] = max(err["value_gather"], e_o)
        print(f"  kernels == plain  decode {name}: ids equal, alpha err {e_a:.3g}, out err {e_o:.3g}{extra}; "
              f"K2 with empty slots equal, bitwise the same on a second call; tie-path rows {n_tie} of {b * h}")
    return err, ties


def crafted_decode_inputs(x, scale, dtype, dev):
    """q and a key cache whose logits are exactly x * scale: a kv-head per
    q-head, q = e_0 and each key (x, 0, 0, 0), so lane 0's sum is x and the
    other lanes' are +0.0. x (B, H, S) float32."""
    import torch

    b, h, s = x.shape
    q = torch.zeros((b, h, 4))
    q[..., 0] = 1.0
    kc = torch.zeros((b, s, h, 4))
    kc[..., 0] = torch.from_numpy(x).permute(0, 2, 1)
    return q.to(dev, dtype), kc.to(dev, dtype)


def decode_tie_cases():
    """(name, x (B, H, S), lengths, k, scale, rows expected on the tie path
    in float32 or None) for decode K1's two paths in phase 2."""
    import numpy as np

    rng = np.random.default_rng(5)
    cases = []
    # 2040 distinct logits above 100 equal ones at 5.0: the ties at t straddle slot 2048
    x = rng.uniform(-5, 0, size=(1, 2, 3104)).astype(np.float32)
    for hh, (top, tied) in enumerate(((2040, 100), (2038, 30))):
        pos = rng.permutation(3104)
        x[0, hh, pos[:top]] = 20 + rng.permutation(top) / 8
        x[0, hh, pos[top: top + tied]] = 5.0
    cases.append(("ties at t straddle slot 2048, K 2048", x, [3104], 2048, 1.0, [[1, 1]]))
    cases.append(("all-equal rows, K 2048", np.full((2, 2, 3104), 1.5, np.float32), [3104, 3073], 2048, 1.0,
                  [[1, 1], [1, 1]]))
    # -0.0 from the final multiply: the least negative denormal times 0.5
    # rounds to -0.0; every other logit is x / 2
    neg0 = np.array([0x80000001], np.uint32).view(np.float32)[0]
    x = -2 * rng.random((1, 4, 64)).astype(np.float32) - 2
    x[0, :, [3, 9, 20, 31, 40]] = [[20.0], [22.0], [24.0], [26.0], [28.0]]
    x[0, 0, [5, 7, 50, 60]] = [neg0, 0.0, neg0, 0.0]  # zeros straddle slot 8
    x[0, 1, [5, 7, 50]] = [neg0, 0.0, 0.0]  # exactly 8 logits >= 0: the fast path keeps -0.0
    x[0, 2, [5, 7, 50]] = [neg0, neg0, neg0]
    x[0, 3, [0, 1, 45, 50]] = [neg0, 0.0, 30.0, 0.0]  # the chain keeps -0.0 at 0 over +0.0 at 50
    cases.append(("-0.0 and +0.0 at t, K 8", x, [64], 8, 0.5, [[1, 0, 0, 1]]))
    x = rng.normal(size=(1, 4, 120)).astype(np.float32)
    x[0, 0, [2, 90]] = np.nan
    x[0, 1, [1, 100]] = -np.inf
    x[0, 2, [4, 70]] = -2.5e38
    x[0, 3, [0, 5]] = [-3.0e38, -3.4e38]
    cases.append(("NaN, -inf and NEG-band logits, K 16", x, [120], 16, 1.0, [[1, 1, 1, 1]]))
    cases.append(("lengths 0, 30 < K, 64 = K, 100 > K; K 64", rng.normal(size=(4, 2, 100)).astype(np.float32),
                  [0, 30, 64, 100], 64, 1.0, [[1, 1], [0, 0], [0, 0], [0, 0]]))
    return cases


def check_decode_tie_path(dev):
    """Phase 2, decode K1 on logits built to take its tie path (and a few
    rows that take its fast path beside them), in float32 and bfloat16:
    ids equal the plain version's slot for slot, alpha within 1e-6, the tie
    rows are ``tie_rows_plain``'s (and, in float32, the rows expected).
    Returns the largest alpha error and the tie rows by case."""
    import numpy as np
    import torch

    from repro_torch.kernels.topk_decode_attention import ops, ref

    err, ties = 0.0, {}
    for name, x, lens, k, scale, want in decode_tie_cases():
        for dt in (torch.float32, torch.bfloat16):
            q, kc = crafted_decode_inputs(x, scale, dt, dev)
            lens_t = torch.tensor(np.asarray(lens), dtype=torch.int32, device=dev)
            a_k, i_k, tie = ops.score_prune(q, kc, lens_t, k, scale, tie_rows=True)
            a_p, i_p = ref.score_prune_plain(q, kc, lens_t, k, scale)
            tie_p = ref.tie_rows_plain(ref.score_logits_plain(q, kc, scale), lens_t, k)
            sync(dev)
            key = f"{name} {str(dt).split('.')[-1]}"
            if not torch.equal(i_k, i_p):
                raise AssertionError(f"decode {key}: K1 ids differ from the plain version in {int((i_k != i_p).sum())} slots")
            e_a = float((a_k - a_p).abs().max())
            check(e_a <= TOL_ALPHA, f"decode {key}: alpha err {e_a:.3g}")
            check(torch.equal(tie, tie_p), f"decode {key}: tie rows {tie.tolist()}, plain {tie_p.tolist()}")
            if dt == torch.float32:
                check(tie.tolist() == want, f"decode {key}: tie rows {tie.tolist()}, expected {want}")
            elif sum(map(sum, want)) == len(want) * len(want[0]):
                check(bool(tie.all()), f"decode {key}: tie rows {tie.tolist()}")
            err = max(err, e_a)
            ties[key] = int(tie.sum())
            print(f"  kernels == plain  decode K1 {key}: ids equal, alpha err {e_a:.3g}, "
                  f"tie-path rows {tie.tolist()}")
    return err, ties


def check_decode_tie_and_width(dev):
    """Logits [1, 1, 2, 1] at k = 2 keep positions {1, 2} (first-minimum
    eviction, strict >); a K wider than shared memory holds raises before
    any launch."""
    import torch

    from repro_torch.kernels.topk_decode_attention import ops, ref

    q = torch.tensor([[[1.0, 0.0, 0.0, 0.0]]], device=dev)
    kc = torch.zeros((1, 4, 1, 4), device=dev)
    kc[0, :, 0, 0] = torch.tensor([1.0, 1.0, 2.0, 1.0])
    vc = torch.arange(16.0, device=dev).reshape(1, 4, 1, 4)
    lens = torch.tensor([4], dtype=torch.int32, device=dev)
    _, i_k, tie = ops.score_prune(q, kc, lens, 2, 1.0, tie_rows=True)
    _, i_p = ref.score_prune_plain(q, kc, lens, 2, 1.0)
    out = ops.topk_decode_attention(q, kc, vc, lens, 2, 1.0)
    want = torch.tensor([6.9241, 7.9241, 8.9241, 9.9241], device=dev)
    if i_k[0, 0].tolist() != [1, 2] or not torch.equal(i_k, i_p) or float((out[0, 0] - want).abs().max()) > 1e-3:
        raise AssertionError(f"decode tie: kernel kept {i_k[0, 0].tolist()}, out {out[0, 0].tolist()}")
    check(tie.tolist() == [[1]], f"decode tie: the row did not take the tie path ({tie.tolist()})")
    print("  kernels == plain  decode tie [1, 1, 2, 1], k = 2: keeps positions {1, 2}, out "
          + str([round(x, 4) for x in out[0, 0].tolist()]))
    h, hkv, dh = 8, 1, 1024
    k = ops.max_k(h // hkv, dh) + 1
    before = dict(ops.LAUNCHES)
    try:
        ops.score_prune(torch.zeros((1, h, dh), device=dev), torch.zeros((1, k + 8, hkv, dh), device=dev),
                        torch.full((1,), k + 8, dtype=torch.int32, device=dev), k, dh ** -0.5)
    except ValueError as e:
        check(ops.LAUNCHES == before, "the too-wide decode domain launched a kernel")
        print(f"  decode k = {k} (group {h // hkv}, dh {dh}) raises before launch: {e}")
    else:
        raise AssertionError("a decode domain wider than shared memory did not raise")


@contextlib.contextmanager
def plain_decode_attention():
    """The LM's pruned decode branch on the plain version of the decode
    pair, on whatever device its tensors are (the kernels' own wrapper
    always launches the kernels for CUDA tensors)."""
    from repro_torch.kernels.topk_decode_attention import ref
    from repro_torch.layers import attention

    saved = attention.topk_decode_attention
    attention.topk_decode_attention = ref.topk_decode_attention_plain
    try:
        yield
    finally:
        attention.topk_decode_attention = saved


def all_launches(*modules) -> dict:
    return {f"{m.__name__.split('.')[-2]}.{k}": v for m in modules for k, v in m.LAUNCHES.items()}


def lm_main_path(dev, hgnn_ops, ts_ops):
    """Phase 3, gemma3-4b serving. Returns the results, the model, the
    prompts and the cache right after prefill (for phase 4). No kernel but
    the decode pair may launch (``ts_ops`` is the Pruner's, which must
    stay at 0)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.topk_decode_attention import ops
    from repro_torch.layers.attention import KVCache
    from repro_torch.models import build_model

    cfg = get_config(LM_ARCH)
    max_len = LM_PROMPT + LM_GEN
    per_step = sum(kind == "A" and cfg.attn_prune_k < max_len for kind in cfg.pattern())
    want_step = {"topk_decode_attention.score_prune": per_step, "topk_decode_attention.value_gather": per_step}
    zero = {key: 0 for key in all_launches(hgnn_ops, ts_ops, ops)}
    t0 = time.perf_counter()
    lm = build_model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    lm.compute_params()
    sync(dev)
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    for m in (hgnn_ops, ts_ops, ops):
        reset_launches(m)
    logits, cache = lm.prefill(prompts, max_len=max_len)
    sync(dev)
    check(all_launches(hgnn_ops, ts_ops, ops) == zero, f"prefill launched kernels: {all_launches(hgnn_ops, ts_ops, ops)}")
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} or non-finite values")
    cache0 = [KVCache(c.k.clone(), c.v.clone()) for c in cache]
    tok = logits.argmax(-1)[:, None]
    tok0 = tok.clone()

    # one float32 decode step, same weights and cache: kernel vs plain
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lm32 = build_model(cfg32, device=dev, params=dict(lm.named_parameters()))
    outs = {}
    for route in ("kernel", "plain"):
        c32 = [KVCache(c.k.float(), c.v.float()) for c in cache0]
        reset_launches(ops)
        with plain_decode_attention() if route == "plain" else contextlib.nullcontext():
            lg, _ = lm32.decode_step(tok0, LM_PROMPT, c32)
        sync(dev)
        got = dict(ops.LAUNCHES)
        expect = {"score_prune": per_step, "value_gather": per_step} if route == "kernel" else {"score_prune": 0, "value_gather": 0}
        check(got == expect, f"float32 decode step ({route}): launches {got}, expected {expect}")
        outs[route] = lg
        del c32
    e32 = float((outs["kernel"] - outs["plain"]).abs().max())
    check(bool(torch.isfinite(outs["kernel"]).all()) and e32 <= TOL_LM,
          f"float32 decode logits, kernel vs plain: {e32:.3g} > {TOL_LM}")
    top32 = float(outs["plain"].abs().max())
    del lm32, outs
    print(f"  main path {LM_ARCH} float32 decode step: kernel vs plain logits {e32:.3g} (max |logit| {top32:.3g})")

    # 32 greedy eager decode steps from a copy of the cache: the launches a
    # step, and the tokens, logits and cache the compiled step must give
    step_ms, launches, tokens, eager_logits = [], {k: 0 for k in zero}, [], []
    eager_cache = [KVCache(c.k.clone(), c.v.clone()) for c in cache0]
    for i in range(LM_GEN):
        pos = LM_PROMPT + i
        for m in (hgnn_ops, ts_ops, ops):
            reset_launches(m)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        tokens.append(tok)
        start.record()
        logits, eager_cache = lm.decode_step(tok, pos, eager_cache)
        end.record()
        end.synchronize()
        got = all_launches(hgnn_ops, ts_ops, ops)
        check(got == dict(zero, **want_step), f"decode step {i} (pos {pos}): launches {got}, expected {want_step}")
        check(bool(torch.isfinite(logits).all()), f"decode step {i}: non-finite logits")
        for key, n in got.items():
            launches[key] += n
        step_ms.append(start.elapsed_time(end))
        eager_logits.append(logits)
        tok = logits.argmax(-1)[:, None]
    # the main path, as the serving launcher runs it: the same 32 steps
    # through the compiled step on the prefill's cache. The first call warms
    # up and captures (each kernel twice a global layer); replays launch
    # nothing from Python. Tokens, float32 logits and cache: the eager loop's,
    # bit for bit
    step = lm.compile_decode(cache)
    captured_ms, tok = [], tok0
    twice = {key: 2 * n for key, n in want_step.items()}
    for i in range(LM_GEN):
        check(torch.equal(tok, tokens[i]), f"captured decode step {i}: input token differs from the eager loop's")
        for m in (hgnn_ops, ts_ops, ops):
            reset_launches(m)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits = step(tok, LM_PROMPT + i)
        end.record()
        end.synchronize()
        got = all_launches(hgnn_ops, ts_ops, ops)
        check(got == (dict(zero, **twice) if i == 0 else zero), f"captured decode step {i}: launches {got}")
        check(same_bits((logits,), (eager_logits[i],)), f"captured decode step {i}: logits differ from the eager step's")
        captured_ms.append(start.elapsed_time(end))
        tok = logits.argmax(-1)[:, None]
    check(all(torch.equal(a.k, b.k) and torch.equal(a.v, b.v) for a, b in zip(cache, eager_cache)),
          "the captured steps' cache differs from the eager loop's")
    del eager_cache, eager_logits
    print(f"  main path {LM_ARCH}: prefill {LM_BATCH}x{LM_PROMPT}, {LM_GEN} eager decode steps, "
          f"{per_step} + {per_step} decode-pair launches each step, logits finite; the same {LM_GEN} steps "
          "captured: tokens, float32 logits and cache bit for bit the eager loop's, no launch counted "
          f"on a replay; sample tokens {tok[:, 0].tolist()}")
    res = {
        "launches": launches, "launches_per_decode_step": per_step, "decode_steps": LM_GEN,
        "prefill_launches": 0, "float32_kernel_vs_plain_logits": e32, "float32_max_abs_logit": top32,
        "init_and_cast_s": init_s, "captured_steps_bitwise_eager": LM_GEN,
        "step_ms_events": step_ms, "captured_step_ms_events": captured_ms, "param_count": cfg.param_count(),
    }
    res["tie_rows"] = lm_tie_rows(lm, cache0, tokens)
    print(f"  main path {LM_ARCH}: decode K1's tie path took {res['tie_rows']['rows']} of "
          f"{res['tie_rows']['of']} (batch, q-head) rows over the {LM_GEN} steps (replayed with tie_rows=True)")
    return res, lm, prompts, cache0, tok0


def lm_tie_rows(lm, cache0, tokens) -> dict:
    """The main path's decode steps replayed from the cache after prefill on
    the same tokens, with decode K1 asked for its tie rows (its keyword of
    ``score_prune``; no serving entry point has one): the (batch, q-head)
    rows that took the tie path, over all steps and global layers."""
    import torch

    from repro_torch.kernels.topk_decode_attention import ops
    from repro_torch.layers import attention
    from repro_torch.layers.attention import KVCache

    ties = []

    def counting(q, kc, vc, lens, prune_k, scale):
        k = min(int(prune_k), kc.shape[1])
        alpha, ids, tie = ops.score_prune(q.contiguous(), kc.contiguous(), lens.to(torch.int32).contiguous(),
                                          k, scale, tie_rows=True)
        ties.append(tie)
        return ops.value_gather(alpha, ids, vc.contiguous())

    cache = [KVCache(c.k.clone(), c.v.clone()) for c in cache0]
    saved = attention.topk_decode_attention
    attention.topk_decode_attention = counting
    try:
        with torch.inference_mode():
            for i, tok in enumerate(tokens):
                lm.decode_step(tok, LM_PROMPT + i, cache)
    finally:
        attention.topk_decode_attention = saved
    t = torch.stack(ties)
    return {"rows": int(t.sum()), "of": t.numel(), "by_call": t.sum(dim=(1, 2)).tolist()}


def lm_cpu_check(dev):
    """Phase 3: one cycle of depth (6 layers: L x5, A) at full width in
    float32, the same weights on the card and on the CPU; prefill logits
    and two decode steps' logits must agree within TOL_LM."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.topk_decode_attention import ops
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=6, dtype="float32")
    max_len = CPU_CHECK_PROMPT + 2
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    gpu = build_model(cfg, device=dev, params={n: p.to(dev) for n, p in cpu.named_parameters()})
    toks = torch.randint(0, cfg.vocab_size, (1, CPU_CHECK_PROMPT), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        l_c, c_c = cpu.prefill(toks, max_len=max_len)
        l_g, c_g = gpu.prefill(toks.to(dev), max_len=max_len)
        errs = [float((l_g.cpu() - l_c).abs().max())]
        for pos in range(CPU_CHECK_PROMPT, max_len):
            tok = l_c.argmax(-1)[:, None]
            reset_launches(ops)
            l_c, c_c = cpu.decode_step(tok, pos, c_c)
            l_g, c_g = gpu.decode_step(tok.to(dev), pos, c_g)
            sync(dev)
            check(ops.LAUNCHES == {"score_prune": 1, "value_gather": 1},
                  f"6-layer decode at pos {pos}: launches {ops.LAUNCHES}")
            errs.append(float((l_g.cpu() - l_c).abs().max()))
    check(max(errs) <= TOL_LM, f"6-layer float32 logits, card vs CPU: {errs} > {TOL_LM}")
    print(f"  main path {LM_ARCH} 6 layers float32, prompt {CPU_CHECK_PROMPT} (> K {cfg.attn_prune_k}): "
          f"card vs CPU logits, prefill {errs[0]:.3g}, decode {max(errs[1:]):.3g}")
    return {"prefill_err": errs[0], "decode_errs": errs[1:], "prompt": CPU_CHECK_PROMPT}


def capture_decode_inputs(lm, cache0, tok0):
    """The inputs of the decode pair at the last global layer in the first
    decode step: (q, k_cache, v_cache, lengths, prune_k, scale)."""
    from repro_torch.layers import attention
    from repro_torch.layers.attention import KVCache

    cache = [KVCache(c.k.clone(), c.v.clone()) for c in cache0]
    seen = []
    real = attention.topk_decode_attention

    def record(q, kc, vc, lens, k, scale):
        seen.append((q.clone(), kc.clone(), vc.clone(), lens.clone(), k, scale))
        return real(q, kc, vc, lens, k, scale)

    attention.topk_decode_attention = record
    try:
        lm.decode_step(tok0, LM_PROMPT, cache)
    finally:
        attention.topk_decode_attention = real
    return seen[-1]


def decode_timings(lm, prompts, cache0, tok0, decode_in, dev):
    """Phase 4, the decode pair at ``decode_in`` (the inputs of the last
    global layer in the first decode step, bfloat16 cache), its bounds from
    this run's inputs, the LM's prefill and decode-step times, and the
    decode pair's share of a decode step's device time."""
    import torch

    from repro_torch.kernels.topk_decode_attention import ops, ref
    from repro_torch.layers.attention import KVCache

    q, kc, vc, lens, prune_k, scale = decode_in
    k = min(prune_k, kc.shape[1])
    t = {}
    with torch.inference_mode():
        alpha, ids = ops.score_prune(q, kc, lens, k, scale)
        out = ops.value_gather(alpha, ids, vc)
        t["score_prune_plain"] = cuda_ms(lambda: ref.score_prune_plain(q, kc, lens, k, scale), 2, warmup=1)
        t["value_gather_plain"] = cuda_ms(lambda: ref.value_gather_plain(alpha, ids, vc), 10)
        timed(t, "score_prune", lambda: ops.score_prune(q, kc, lens, k, scale), 30)
        timed(t, "value_gather", lambda: ops.value_gather(alpha, ids, vc), 100)
        # the library call for K2: a CSR sparse-dense product, row b*H + h
        # holding alpha at column (b*S + id)*Hkv + h // group of the cache
        # as a float32 (S*B*Hkv, dh) matrix (bfloat16 -> float32 is exact)
        b, h, _ = alpha.shape
        s, hkv, dh = kc.shape[1], kc.shape[2], kc.shape[3]
        r_b, r_h, r_s = torch.nonzero(ids >= 0, as_tuple=True)
        col = ((r_b * s + ids[r_b, r_h, r_s].long()) * hkv + r_h // (h // hkv))
        with torch.sparse.check_sparse_tensor_invariants(enable=True):
            csr = torch.sparse_coo_tensor(
                torch.stack([r_b * h + r_h, col]), alpha[r_b, r_h, r_s], size=(b * h, b * s * hkv),
            ).coalesce().to_sparse_csr()
        vflat = vc.float().reshape(b * s * hkv, dh)
        lib_err = float((torch.sparse.mm(csr, vflat).reshape(b, h, dh) - out).abs().max())
        check(lib_err <= TOL_OUT, f"library decode K2 differs from the kernel by {lib_err:.3g}")
        timed(t, "value_gather_library", lambda: torch.sparse.mm(csr, vflat), 100)
        # bytes this run's data needs: K1 reads each valid key row once, q
        # and the lengths, and writes alpha and ids; K2 reads alpha, ids and
        # each distinct retained V row once, and writes the output
        el = kc.element_size()
        valid_rows = int(lens.long().clamp(max=s).sum()) * hkv
        k1_bytes = valid_rows * dh * el + q.numel() * el + lens.numel() * 4 + (alpha.numel() + ids.numel()) * 4
        k1_ops = 2 * valid_rows * (h // hkv) * dh + alpha.numel() * 6
        kvh = (torch.arange(h, device=dev) // (h // hkv))[None, :, None].expand_as(ids)
        bidx = torch.arange(b, device=dev)[:, None, None].expand_as(ids)
        keep = ids >= 0
        distinct = int(torch.unique((bidx[keep] * hkv + kvh[keep]) * s + ids[keep].long()).numel())
        retained = int(keep.sum())
        k2_bytes = distinct * dh * el + (alpha.numel() + ids.numel()) * 4 + out.numel() * 4
        k2_ops = 2 * retained * dh
        # the LM: prefill, and a decode step at one position (it writes the
        # same cache slot each time), eager and captured: its time, the
        # device's busy time and the decode pair's share of it
        t["lm_prefill_ms"] = cuda_ms(lambda: lm.prefill(prompts, max_len=LM_PROMPT + LM_GEN), 2, warmup=1)
        fresh = [KVCache(c.k.clone(), c.v.clone()) for c in cache0]
        step = lm.compile_decode([KVCache(c.k.clone(), c.v.clone()) for c in cache0])
        prof = {}
        for mode, fn in (("eager", lambda: lm.decode_step(tok0, LM_PROMPT, fresh)),
                         ("captured", lambda: step(tok0, LM_PROMPT))):
            step_ms = cuda_ms(fn, 5, warmup=1)
            t["lm_step_ms" if mode == "eager" else "lm_captured_step_ms"] = step_ms
            per_kernel = device_times(fn, 3)
            busy = sum(per_kernel.values())
            pair = sum(ms for name, ms in per_kernel.items()
                       if "score_prune_kernel" in name or "value_gather_kernel" in name)
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
            prof[mode] = None if busy == 0 else {
                "device_busy_ms": busy, "step_ms_events": step_ms, "busy_share": busy / step_ms,
                "decode_pair_ms": pair, "decode_pair_share_of_device": pair / busy,
                "host_ops_per_step": host_ops(fn), "top_kernels_ms": [[name[:80], ms] for name, ms in top],
            }
    bounds = {"score_prune": bound(k1_bytes, k1_ops), "value_gather": bound(k2_bytes, k2_ops)}
    shapes = {
        "inputs": f"{LM_ARCH} decode step 1, last global layer", "q": list(q.shape), "cache": list(kc.shape),
        "dtype": str(kc.dtype), "k": k, "lengths": lens.tolist(), "retained_slots": retained,
        "distinct_retained_rows": distinct,
    }
    return t, bounds, shapes, prof


def pruner_cases():
    """(name, scores, mask, k) numpy arrays for the Pruner in phase 2."""
    import numpy as np

    rng = np.random.default_rng(3)

    def normal(t, d, p):
        return rng.normal(size=(t, d)).astype(np.float32), rng.random((t, d)) < p

    cases = [(f"reference test shape t={t} d={d} k={k}", *normal(t, d, 0.75), k) for t, d, k in PRUNER_SHAPES]
    for t, d in ((3, 40), (8, 128), (9, 130)):
        cases.append((f"k = 1 t={t} d={d}", *normal(t, d, 0.8), 1))
    s, m = normal(10, 137, 0.6)
    m[[1, 4, 9]] = False
    cases.append(("all-masked rows 1, 4, 9 of 10x137 k=6", s, m, 6))
    for t, d, k in ((3, 17, 40), (1, 3, 8)):
        cases.append((f"k > D t={t} d={d} k={k}", *normal(t, d, 0.8), k))
    for t, d, k in ((9, 300, 7), (5, 260, 64), (300, 260, 64)):
        cases.append((f"tie-heavy integers t={t} d={d} k={k}",
                      rng.integers(-2, 3, size=(t, d)).astype(np.float32), rng.random((t, d)) < 0.85, k))
    row = np.array(SPECIAL_ROW, np.float32)
    row[5] = np.array([0xFFC00000], np.uint32).view(np.float32)[0]  # -NaN
    s = np.stack([row, row[::-1]])
    m = np.ones_like(s, bool)
    m[1, ::3] = False
    for k in (3, 8, 16, 20):
        cases.append((f"special values (+-0, +-NaN, +-inf, NEG band) k={k}", s, m, k))
    cases.append(("wide domain 32x3104 k=2048", *normal(32, 3104, 0.99), 2048))
    # the winner tree: k not a multiple of 32, one lane holding four groups
    for k, d in ((33, 3104), (1000, 4000), (2047, 3104), (2049, 5000), (4096, 6000)):
        cases.append((f"wide domain 16x{d} k={k}", *normal(16, d, 0.97), k))
    cases.append(("tie-heavy integers 32x3104 k=2048 (equal minima in many groups)",
                  rng.integers(-2, 3, size=(32, 3104)).astype(np.float32), rng.random((32, 3104)) < 0.97, 2048))
    cases.append(("all-equal rows 4x4000 k=2048", np.full((4, 4000), 1.5, np.float32), np.ones((4, 4000), bool), 2048))
    # the widest domains: 8, 16 and 32 groups of 32 slots a lane
    for k, d in ((8000, 9000), (16000, 17000), (29056, 30000)):
        cases.append((f"wide domain 4x{d} k={k}", *normal(4, d, 0.97), k))
    return cases


def check_pruner_kernel(dev):
    """Phase 2, the Pruner: kernel against plain, values bit for bit and ids
    slot for slot; a domain wider than shared memory raises before any
    launch. Returns the largest value difference (0 when all are equal)."""
    import torch

    from repro_torch.kernels.topk_select import ops, ref

    err = 0.0
    for name, s, m, k in pruner_cases():
        st, mt = torch.from_numpy(s).to(dev), torch.from_numpy(m).to(dev)
        v_k, i_k = ops.topk_select(st, mt, k)
        v_p, i_p = ref.topk_select_plain(st, mt, k)
        sync(dev)
        if not torch.equal(v_k.view(torch.int32), v_p.view(torch.int32)) or not torch.equal(i_k, i_p):
            bad = int((v_k.view(torch.int32) != v_p.view(torch.int32)).sum() + (i_k != i_p).sum())
            raise AssertionError(f"pruner {name}: kernel differs from the plain version in {bad} values/ids")
        err = max(err, float(torch.where(v_k == v_p, 0.0, (v_k - v_p).abs()).max()))
        print(f"  kernels == plain  pruner {name}: values bitwise equal, ids equal")
    before = dict(ops.LAUNCHES)
    k = ops.max_k() + 1
    try:
        ops.topk_select(torch.zeros((2, 4), device=dev), torch.ones((2, 4), dtype=torch.bool, device=dev), k)
    except ValueError as e:
        check(ops.LAUNCHES == before, "the too-wide Pruner domain launched a kernel")
        print(f"  pruner k = {k} raises before launch: {e}")
    else:
        raise AssertionError("a Pruner domain wider than shared memory did not raise")
    return err


def flat_ranks(nbr, ety, theta_src, theta_rel):
    """The flat K1's rank of every slot: the left-to-right head sum of
    theta_src[nbr] (+ theta_rel[ety])."""
    th = theta_src[nbr.long()]
    if theta_rel is not None:
        th = th + theta_rel[ety.long()]
    rank = th[..., 0]
    for hh in range(1, th.shape[-1]):
        rank = rank + th[..., hh]
    return rank


def pruner_main_path(model_tasks, FlowConfig, fpa_ops, ts_ops, tda_ops, decode_in, dev):
    """Phase 3, the Pruner through its entry point ``topk_select`` on the
    scores of two served paths, each a cross-check between two kernels
    that keep the same rule: (a) the ranks of every table the flat K1
    prunes in one forward of RGAT and of Simple-HGN on ACM (flat route),
    where ``nbr[row, ids]`` must equal the ids of a ``keep=True`` fused
    launch on each served launch's inputs, whose output must equal the
    served one bit for bit; (b) the float32
    logits of gemma3-4b's last global layer in decode step 1
    (``score_logits_plain``, bit-identical to decode K1's), where the ids
    must equal decode K1's. The counters are set to 0 just before the
    Pruner's calls and read just after. Returns the results and the inputs
    of the timed shapes (ii) and (iii). Each output is then held to the
    plain version on the same input, values bit for bit and ids slot for
    slot."""
    import torch

    from repro_torch.kernels.topk_decode_attention import ref as tda_ref

    served, real = [], fpa_ops.flat_prune_aggregate

    def record(nbr, msk, ety, ts, tr, td, hp, k, slope=0.2, keep=False):
        res = real(nbr, msk, ety, ts, tr, td, hp, k, slope, keep=keep)
        served.append((f"{key} table {len(served)} {tuple(nbr.shape)}", (nbr, msk, ety, ts, tr, td, hp, k, slope),
                       res[0] if keep else res))
        return res

    fpa_ops.flat_prune_aggregate = record
    try:
        for key in ("rgat/acm/flat", "simple_hgn/acm/flat"):
            # the eager forward: a replay of the session runs no wrapper, and
            # its launches equal the eager ones bit for bit (phase 3)
            task = model_tasks[key]
            with torch.inference_mode():
                task.model.apply(task.params, task.batch, route_flow(FlowConfig, "flat"))
    finally:
        fpa_ops.flat_prune_aggregate = real
    # the served launches write no ids: a keep=True launch on each served
    # input gives them, its output held to the served one bit for bit
    tables = []
    for name, args, out in served:
        kept, _, ids = real(*args, keep=True)
        check(same_bits((kept,), (out,)), f"pruner main path {name}: the keep=True launch differs from the served one")
        nbr, msk, ety, ts, tr, _, _, k, _ = args
        tables.append((name, nbr, msk, ety, ts, tr, k, ids))
    ranks = [(name, flat_ranks(nbr, ety, ts, tr), msk, k) for name, nbr, msk, ety, ts, tr, k, _ in tables]
    q, kc, _, lens, prune_k, scale = decode_in
    b, h, _ = q.shape
    s = kc.shape[1]
    k_dec = min(prune_k, s)
    logits = tda_ref.score_logits_plain(q, kc, scale).reshape(b * h, s)
    dmask = (torch.arange(s, device=dev)[None, :] < lens.long()[:, None]).repeat_interleave(h, dim=0)
    _, dec_ids = tda_ops.score_prune(q, kc, lens, k_dec, scale)
    sync(dev)

    for m in (fpa_ops, ts_ops, tda_ops):
        reset_launches(m)
    outs = [ts_ops.topk_select(r, msk, k) for _, r, msk, k in ranks]
    out_dec = ts_ops.topk_select(logits, dmask, k_dec)
    sync(dev)
    launches = all_launches(fpa_ops, ts_ops, tda_ops)
    want = dict({key: 0 for key in launches}, **{"topk_select.topk_select": len(ranks) + 1})
    check(launches == want, f"pruner main path: launches {launches}, expected {want}")

    from repro_torch.kernels.topk_select import ref as ts_ref

    inputs = ranks + [(f"{LM_ARCH} decode logits", logits, dmask, k_dec)]
    for (name, r, msk, k), (v_k, i_k) in zip(inputs, outs + [out_dec]):
        v_p, i_p = ts_ref.topk_select_plain(r, msk, k)
        if not torch.equal(v_k.view(torch.int32), v_p.view(torch.int32)) or not torch.equal(i_k, i_p):
            bad = int((v_k.view(torch.int32) != v_p.view(torch.int32)).sum() + (i_k != i_p).sum())
            raise AssertionError(f"pruner main path {name}: kernel differs from the plain version in {bad} values/ids")
    for (name, nbr, msk, *_, k1_ids), (_, ids3) in zip(tables, outs):
        mapped = torch.where(ids3 >= 0, nbr.gather(1, ids3.clamp(min=0).long()), -1)
        if not torch.equal(mapped, k1_ids):
            raise AssertionError(f"pruner vs the served flat launch {name}: {int((mapped != k1_ids).sum())} slots differ")
    # the same retained set: decode K1 writes it in the canonical layout
    # (positions ascending, -1 last), the Pruner in its domain's slot order
    dec_ids3 = out_dec[1].reshape(b, h, k_dec)
    srt = torch.sort(torch.where(dec_ids3 >= 0, dec_ids3, s), dim=-1).values
    srt = torch.where(srt < s, srt, -1)
    if not torch.equal(srt, dec_ids):
        raise AssertionError(f"pruner vs decode K1: {int((srt != dec_ids).sum())} slots of the sorted sets differ")
    print(f"  main path pruner: {len(ranks)} flat K1 tables of RGAT/Simple-HGN ACM (nbr[row, ids] == the ids of a "
          "keep=True launch on the served inputs, its output == the served one bitwise, "
          f"slot for slot) and {LM_ARCH} decode logits {b * h}x{s} k={k_dec} (ids sorted == decode K1's); "
          f"all {len(inputs)} equal the plain version (values bitwise, ids); "
          f"launches {launches['topk_select.topk_select']}")
    union = next(i for i, t in enumerate(tables) if t[0].startswith("simple_hgn"))  # union:paper, layer 0
    _, r, msk, k = ranks[union]
    res = {
        "launches": launches["topk_select.topk_select"],
        "flat_tables_checked": [t[0] for t in tables],
        "decode_logits": [b * h, s], "decode_k": k_dec,
    }
    res["plain_checked"] = len(inputs)
    shapes = {
        "ii": (f"acm union:paper ranks (simple_hgn layer 0) {tuple(r.shape)} k={k}", r, msk, k),
        "iii": (f"{LM_ARCH} decode step 1 logits, last global layer {tuple(logits.shape)} k={k_dec}",
                logits, dmask, k_dec),
    }
    return res, shapes


def pruner_timings(shapes, dev):
    """Phase 4, the Pruner at three shapes: (i) the reference's own
    microbenchmark (``benchmarks/kernels_micro.py``: 2048 x 512, k 50, 80 %
    valid normal scores) and (ii)-(iii) the served scores of phase 3.
    Kernel (profiler and events), plain, and the library yardstick
    ``torch.topk(torch.where(mask, s, NEG), k)`` (not used by the port);
    the bound: T*D*5 bytes read (score and mask) and T*k*8 written, one
    comparison a slot."""
    import torch

    from repro_torch.kernels.common import NEG
    from repro_torch.kernels.topk_select import ops, ref

    gen = torch.Generator(dev).manual_seed(4)
    s_i = torch.randn((2048, 512), generator=gen, device=dev)
    m_i = torch.rand((2048, 512), generator=gen, device=dev) < 0.8
    shapes = dict({"i": ("reference microbenchmark 2048x512 k=50, 80 % valid", s_i, m_i, 50)}, **shapes)
    out = {}
    with torch.inference_mode():
        for key, (desc, s, m, k) in shapes.items():
            t = {}
            timed(t, "kernel", lambda: ops.topk_select(s, m, k), 30)
            t["plain_ms"] = cuda_ms(lambda: ref.topk_select_plain(s, m, k), 2, warmup=1)
            timed(t, "library", lambda: torch.topk(torch.where(m, s, NEG), k), 30)
            rows, width = s.shape
            bound_ms, bound_by, nbytes, nops = bound(rows * width * 5 + rows * k * 8, rows * width)
            out[key] = dict(t, shape=desc, bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes, bound_ops=nops)
            print(f"  pruner ({key}) {desc}: device {t['kernel']:.4f} ms, events {t['kernel_event']:.4f}, "
                  f"plain {t['plain_ms']:.3f}, torch.topk {t['library']:.4f}, bound {bound_ms:.5f} ({nbytes} B)")
    return out


KERNELS = (
    # (LAUNCHES key, TPU kernel bodies it replaces, library-call timing key)
    ("prune", "kernel.py:219 _grouped_prune_kernel", None),
    ("aggregate", "kernel.py:137 _grouped_aggregate_kernel", "aggregate_library"),
    ("prune_aggregate", "kernel.py:219 _grouped_prune_kernel + kernel.py:137 _grouped_aggregate_kernel "
     "(fused_prune_aggregate_grouped_pallas, kernel.py:304)", None),
    ("flat_prune", "kernel.py:69 _prune_kernel (fused_prune_aggregate_pallas, kernel.py:153)", None),
    ("flat_aggregate", "kernel.py:124 _aggregate_kernel (fused_prune_aggregate_pallas, kernel.py:153)",
     "flat_aggregate_library"),
    ("flat_prune_aggregate", "kernel.py:69 _prune_kernel + kernel.py:124 _aggregate_kernel "
     "(fused_prune_aggregate_pallas, kernel.py:153)", None),
)
CHECKS = {
    "prune": "pass: ids equal, alpha <= 1e-6",
    "aggregate": "pass: out <= 1e-5",
    "prune_aggregate": "pass: out, alpha and ids bitwise equal to the K1 -> K2 pair's; out <= 1e-5 vs plain",
}
DECODE_KERNELS = (
    ("score_prune", "kernel.py:31 _score_prune_kernel (topk_decode_attention_pallas, kernel.py:97)", None),
    ("value_gather", "kernel.py:83 _value_gather_kernel (topk_decode_attention_pallas, kernel.py:97)",
     "value_gather_library"),
)


def event_median_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device time of one call of ``fn``: CUDA events around each
    of ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(end) for start, end in pairs)
    return ms[len(ms) // 2]


def record_na(task, params, flow) -> list:
    """One eager forward of ``flow``, recording each NA call's scores and
    semantic graph, by layer: ``[[(scores, sg), ...], ...]``."""
    import torch

    from repro_torch.core import flows
    from repro_torch.core.models import han, rgat, simple_hgn

    calls, mods = [], (han, rgat, simple_hgn)

    def record(cfg, h, scores, sg):
        calls.append((scores, sg))
        return flows.run_aggregate_graph(cfg, h, scores, sg)

    for m in mods:
        m.run_aggregate_graph = record
    layers = []
    try:
        with torch.inference_mode():
            carry = dict(task.batch.features)
            for step in task.model.layer_steps(params, task.batch, flow):
                h = step.project(carry)
                first = len(calls)
                zs = {name: fn(h) for name, fn in step.na}
                layers.append(calls[first:])
                carry = step.fuse(carry, h, zs)
    finally:
        for m in mods:
            m.run_aggregate_graph = flows.run_aggregate_graph
    return layers


def tie_rows(task, params, k: int, FlowConfig):
    """Where ``fused`` (``top_k``'s rule) and ``fused_kernel`` (first-minimum
    eviction, strict ``>``) may keep different neighbors at ``prune_k=k``:
    an NA row whose K-th and (K+1)-th ranked slots (the kernels' head sum
    of theta_src[nbr] + theta_rel[ety]) lie within 1e-6 of each other,
    relatively, and hold different (source, edge type) pairs (two slots of
    one source give the same message whichever is kept). Such a row moves
    its target's output, and through it every row of a later layer that
    has the target as a neighbor or as itself. Returns the tie rows over
    all NA calls and a bool vector over the logits' rows that they reach.
    (HAN's semantic attention averages over all targets, so a tie there
    also moves every row a little; none is counted for it.)"""
    import numpy as np
    import torch

    from repro_torch.core import hetgraph

    batch, dev = task.batch, task.batch.device
    reached = torch.zeros(batch.total_nodes, dtype=torch.bool, device=dev)
    n_ties = 0
    for layer in record_na(task, params, FlowConfig("fused", prune_k=k)):
        now = reached.clone()
        for scores, sg in layer:
            off = batch.offsets[sg.dst_type]
            if isinstance(sg, hetgraph.BucketedSemanticGraph):
                tables = [(b.targets, b.nbr_idx, b.nbr_mask, b.edge_type) for b in sg.buckets if b.num_targets]
            else:
                tables = [(np.arange(sg.num_targets), sg.nbr_idx, sg.nbr_mask, sg.edge_type)]
            for targets, nbr, msk, ety in tables:
                nbr, msk, ety = (torch.from_numpy(a).to(dev) for a in (nbr.astype(np.int64), msk, ety.astype(np.int64)))
                tg = torch.from_numpy(targets.astype(np.int64)).to(dev) + off
                hit = reached[tg] | (reached[nbr] & msk).any(dim=1)
                if nbr.shape[1] > k:
                    rank = flat_ranks(nbr, ety, scores.theta_src, scores.theta_rel)
                    rank = torch.where(msk, rank, torch.full_like(rank, -float("inf")))
                    val, slot = rank.sort(dim=1, descending=True, stable=True)
                    a, b = val[:, k - 1], val[:, k]
                    src = nbr.gather(1, slot[:, k - 1:k + 1])
                    et = ety.gather(1, slot[:, k - 1:k + 1])
                    same = (src[:, 0] == src[:, 1]) & (et[:, 0] == et[:, 1])
                    tie = torch.isfinite(b) & (a - b <= 1e-6 * a.abs()) & ~same
                    n_ties += int(tie.sum())
                    hit |= tie
                now[tg[hit]] = True
        reached = now
    return n_ties, reached[batch.dst_offset: batch.dst_offset + batch.num_targets]


def captured_vs_eager(step, params):
    """``TRAIN_CHECK_STEPS`` captured steps, then as many eager ones, each
    run from ``params``: the largest loss and parameter differences."""
    import torch

    runs = []
    for call in (step, step.eager):
        step.reset(params)
        runs.append((torch.stack([call().clone() for _ in range(TRAIN_CHECK_STEPS)]), step.params()))
    (l_c, p_c), (l_e, p_e) = runs
    return float((l_c - l_e).abs().max()), max(float((p_c[n] - p).abs().max()) for n, p in p_e.items())


def train_phase(pipeline, FlowConfig, ops, gpu_tasks, dev):
    """Phase 5, HGNN training, as ``benchmarks/fig9_accuracy.py`` runs it,
    at ``scale=1.0`` with ``prepare``'s defaults (``max_degree=256``,
    bucketed SGB), on the GPU tasks phase 3 served (their device caches
    were filled under ``torch.inference_mode()``). Per model: the captured
    step's first 3 losses against the same steps eagerly on the CPU
    (1e-5); 20 captured steps against 20 eager ones from the same params
    (losses 1e-5, params 1e-4: the index backward adds with atomics), and
    bit for bit for a step captured under
    ``torch.use_deterministic_algorithms``; 200 captured steps (loss finite and
    falling), then ``train_hgnn``'s 200 and the fig9 sweep on its params:
    the full ``staged`` accuracy, then at each K a captured
    ``fused_kernel`` session (kernel #1's launches a forward as phase 3
    derives them; replays bit for bit the eager forward) whose accuracy
    must equal a captured ``fused`` session's, and whose logits must agree
    with it within 1e-4 on every row no tie at the K-th rank reaches; then
    the step's times. Returns per-model results."""
    import numpy as np
    import torch

    from repro_torch.optim import adamw

    results = {}
    for model, task in gpu_tasks.items():
        cpu_task = pipeline.prepare(model, "acm", scale=SCALE, seed=0, device="cpu")
        for name, p in task.params.items():
            check(torch.equal(p.cpu(), cpu_task.params[name]), f"train {model}: weights differ on {name}")
        flow = FlowConfig()
        sync(dev)
        t0 = time.perf_counter()
        step = task._train_step(flow, TRAIN_LR)
        float(step())
        first_ms = (time.perf_counter() - t0) * 1e3
        check(step.captured, f"train {model}: the step is not a captured graph")

        # the card against the CPU: the first 3 steps from the same params
        step.reset(task.params)
        card = [float(step()) for _ in range(3)]
        cpu = [float(loss) for loss in (cpu_task._train_step(flow, TRAIN_LR)() for _ in range(3))]
        err_cpu = max(abs(a - b) for a, b in zip(card, cpu))
        check(err_cpu <= TOL_TRAIN_LOSS, f"train {model}: card losses {card} differ from the CPU's {cpu} by {err_cpu:.3g}")

        # captured against eager: 20 steps each from the same params; the
        # index backward adds with atomics, so within a tolerance, and bit
        # for bit under deterministic algorithms (a step captured under them)
        err_loss, err_par = captured_vs_eager(step, task.params)
        check(err_loss <= TOL_TRAIN_LOSS and err_par <= TOL_TRAIN_PARAMS,
              f"train {model}: captured vs eager losses {err_loss:.3g}, params {err_par:.3g}")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = pipeline.TrainStep(task, flow, adamw(lr=TRAIN_LR, weight_decay=1e-4))
            det_err = captured_vs_eager(det, task.params)
        finally:
            torch.use_deterministic_algorithms(False)
        check(det_err == (0.0, 0.0), f"train {model}: under deterministic algorithms captured vs eager {det_err}")

        # the full run: 200 captured steps, then train_hgnn's
        step.reset(task.params)
        losses = torch.stack([step().clone() for _ in range(TRAIN_STEPS)]).tolist()
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"train {model}: losses not finite and falling ({losses[0]} -> {losses[-1]})")
        sync(dev)
        t0 = time.perf_counter()
        trained = pipeline.train_hgnn(task, steps=TRAIN_STEPS, lr=TRAIN_LR)
        sync(dev)
        train_s = time.perf_counter() - t0
        print(f"  train {model}/acm: first step (warm-up, capture, replay) {first_ms:.1f} ms; losses card vs CPU "
              f"{err_cpu:.3g} over 3 steps; captured vs eager {err_loss:.3g} (params {err_par:.3g}) over "
              f"{TRAIN_CHECK_STEPS} steps, bit for bit under deterministic algorithms; {TRAIN_STEPS} steps "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"train_hgnn {TRAIN_STEPS} steps {train_s:.3f} s")

        # the fig9 sweep on the trained params
        acc_full = pipeline.accuracy(task, trained, FlowConfig("staged"))
        degs = np.concatenate([sg.degrees() for sg in task.sgs])
        layers = getattr(task.model, "num_layers", 1)
        sweep = {}
        for k in FIG9_KS:
            fk = FlowConfig("fused_kernel", prune_k=k)
            want = expected_launches(task.sgs, "bucketed", k, layers, ops)
            sess, lg_k, launches = captured_session(task, fk, want, f"train {model}/acm K={k}", ops, dev, trained)
            acc_k = pipeline.accuracy(task, trained, fk)
            fused = FlowConfig("fused", prune_k=k)
            lg_f = task.compile(fused, params=trained)(trained)
            acc_f = pipeline.accuracy(task, trained, fused)
            check(acc_k == acc_f, f"train {model} K={k}: fused_kernel accuracy {acc_k} != fused {acc_f}")
            n_ties, reached = tie_rows(task, trained, k, FlowConfig)
            diff = (lg_k - lg_f).abs().amax(dim=1)
            err = float(diff[~reached].max()) if bool((~reached).any()) else 0.0
            check(err <= TOL_LOGITS, f"train {model} K={k}: fused_kernel vs fused logits differ by {err:.3g} "
                                     f"on rows no tie reaches")
            red = 1 - np.minimum(degs, k).sum() / max(degs.sum(), 1)
            sweep[k] = {
                "compute_reduction": float(red), "acc_full": acc_full, "acc_pruned": acc_k,
                "acc_loss": acc_full - acc_k, "acc_fused": acc_f, "launches": launches,
                "tie_rows": n_ties, "rows_reached_by_ties": int(reached.sum()),
                "max_abs_diff_vs_fused": err, "max_abs_diff_vs_fused_all_rows": float(diff.max()),
            }
            print(f"  fig9_{model}_acm_K{k}: compute_reduction={red:.2%};acc_full={acc_full:.4f};"
                  f"acc_pruned={acc_k:.4f};acc_loss={(acc_full - acc_k):.4f} | kernel #1 launches "
                  f"{launches['prune_aggregate']} a forward, captured (3 replays == eager bitwise), accuracy == "
                  f"fused, |fused_kernel-fused| {err:.3g}, tie rows {n_ties} reaching {int(reached.sum())} rows")

        # times: one step, captured (a replay) and eager, and the device's share
        cap_ms = event_median_ms(step, TRAIN_TIMED)
        eager_ms = event_median_ms(step.eager, TRAIN_TIMED)
        prof = forward_profile(step, cuda_ms(step, TRAIN_TIMED))
        results[model] = {
            "first_step_ms": first_ms, "step_ms_captured": cap_ms, "step_ms_eager": eager_ms,
            "device_busy_share": prof["busy_share"] if prof else None, "profile": prof,
            "loss_err_vs_cpu": err_cpu, "loss_err_captured_vs_eager": err_loss,
            "param_err_captured_vs_eager": err_par, "captured_vs_eager_deterministic": list(det_err),
            "loss_first": losses[0], "loss_last": losses[-1], "train_hgnn_s": train_s, "num_edges": task.num_edges, "sweep": sweep,
        }
        print(f"  train {model}/acm step: captured {cap_ms:.4f} ms, eager {eager_ms:.4f} ms (median of "
              f"{TRAIN_TIMED}, CUDA events); device busy "
              + ("not measured (the profiler saw no device time)" if prof is None else
                 f"{prof['device_busy_ms']:.4f} ms of {prof['forward_ms']:.4f} ({prof['busy_share']:.1%})"))
    return results


# phase 6: the SGB options and on-disk data, as the reference's sgb_scale and
# na_dispatch benchmarks run them (bucket_sizes="auto" through the artifact
# cache): (model, dataset, max_degree)
SGB_PATHS = (("han", "dblp", 256), ("han", "acm", 256), ("rgat", "acm", 256), ("rgat", "imdb", 256),
             ("simple_hgn", "acm", 256), ("simple_hgn", "imdb", 256), ("rgat", "imdb", 64))
SGB_ROUTES = ("bucketed", "loop")
SGB_BF16_PATH = ("simple_hgn", "acm", 256)  # the relation term: theta_rel in bfloat16
SGB_DIR = ROOT / "build" / "sgb_phase"  # the dumps and the cache, emptied at the start


def same_graph(a, b, what: str) -> None:
    """Two ``HetGraph``s equal array for array."""
    import numpy as np

    check((a.node_types, a.num_nodes, a.relations, a.label_type, a.num_classes)
          == (b.node_types, b.num_nodes, b.relations, b.label_type, b.num_classes), f"{what}: schema differs")
    pairs = [(a.labels, b.labels)] + [(a.features[t], b.features[t]) for t in a.node_types]
    pairs += [(x, y) for rel in a.edges for x, y in zip(a.edges[rel], b.edges[rel])]
    check(list(a.edges) == list(b.edges)
          and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in pairs), f"{what}: arrays differ")


def same_sgb(a, b, what: str, ops) -> None:
    """Two SGB stacks equal bit for bit: bucket tables, target order and the
    grouped layout the kernels walk."""
    import numpy as np

    from repro_torch.data.sgb_cache import _GROUPED_ARRAYS

    check([sg.name for sg in a] == [sg.name for sg in b], f"{what}: semantic graphs differ")
    for x, y in zip(a, b):
        check(x.bucket_capacities == y.bucket_capacities, f"{what} {x.name}: capacities differ")
        arrays = [(getattr(bx, f), getattr(by, f)) for bx, by in zip(x.buckets, y.buckets)
                  for f in ("targets", "nbr_idx", "nbr_mask", "edge_type")]
        lx, ly = x.grouped(ops.T_TILE, ops.W_TILE), y.grouped(ops.T_TILE, ops.W_TILE)
        arrays += [(getattr(lx, f), getattr(ly, f)) for f in _GROUPED_ARRAYS] + [(x.target_perm(), y.target_perm())]
        check(lx.num_rows == ly.num_rows and all(
            u.dtype == v.dtype and u.shape == v.shape and np.array_equal(u, v) for u, v in arrays
        ), f"{what} {x.name}: tables differ")


def sgb_kernel_times(auto, default, dev):
    """Kernel #1 (the fused grouped launch, one a metapath graph) and kernel
    #2 (the fused flat launch, one a pruned bucket of the per-bucket loop)
    on HAN ACM's auto layout against its default one, on the same
    projected features and weights: device and event times, the plain
    versions' times and largest differences, and the bounds from the bytes
    and operations this run's inputs need (summed over the launches of one
    forward)."""
    import torch

    from repro_torch.core import attention, flows
    from repro_torch.core.projection import project_features
    from repro_torch.kernels.fused_prune_aggregate import ops, ref

    t, bounds, err, shapes = {}, {}, {"prune_aggregate": 0.0, "flat_prune_aggregate": 0.0}, {}
    with torch.inference_mode():
        for name, task in (("auto", auto), ("default", default)):
            p, batch, model = task.params, task.batch, task.model
            h = project_features(p, batch.features, batch.node_types, model.heads, model.dh)
            dst = slice(batch.dst_offset, batch.dst_offset + batch.num_targets)
            k1_calls, k2_calls = [], []
            nb1 = no1 = nb2 = no2 = 0
            for sg in task.sgs:
                sc = attention.decompose_scores(h, p[f"attn.{sg.name}.a_src"], p[f"attn.{sg.name}.a_dst"], dst)
                layout = sg.grouped(ops.T_TILE, ops.W_TILE)
                (nbr, msk, _, rt, _), (blk, k_s) = ops._layout_device(layout, PRUNE_K, dev)
                args = (nbr, msk, None, sc.theta_src, None, sc.theta_dst, rt, blk, k_s, h)
                out, alpha, ids = ops.prune_aggregate(*args, keep=True)
                plain = ref.prune_aggregate_plain(*args, 0.2)
                check(torch.equal(ids, plain[2]) and float((alpha - plain[1]).abs().max()) <= TOL_ALPHA,
                      f"phase 6 {name} {sg.name}: kernel #1's ids or alpha differ from its plain version's")
                err["prune_aggregate"] = max(err["prune_aggregate"], float((out - plain[0]).abs().max()))
                k1, _, _ = k1_bound(msk, nbr, None, sc.theta_src, None, sc.theta_dst, alpha, ids,
                                    (rt.numel() + blk.numel()) * 4)
                _, _, b, o = fused_bound(k1, alpha, ids, h, out)
                nb1, no1 = nb1 + b, no1 + o
                k1_calls.append(args)
                shapes[f"{name} {sg.name}"] = {
                    "capacities": list(sg.bucket_capacities), "grid_steps": layout.num_steps, "k_s": k_s,
                    "valid_slots": int(msk.sum()),
                    "k1_device_ms": sum(device_times(lambda a=args: ops.prune_aggregate(*a), 20).values()),
                    "k2_launches": [],
                }
                for targets, nbr2, msk2, _ in flows._bucket_loop_tables(sg, False, dev):
                    if nbr2.shape[1] <= PRUNE_K:
                        continue  # the §4.3 bypass: no kernel launch
                    args2 = (nbr2, msk2, None, sc.theta_src, None, sc.theta_dst[targets].contiguous(), h, PRUNE_K)
                    out2, alpha2, ids2 = ops.flat_prune_aggregate(*args2, keep=True)
                    plain = ref.flat_prune_aggregate_plain(*args2, 0.2)
                    check(torch.equal(ids2, plain[2]) and float((alpha2 - plain[1]).abs().max()) <= TOL_ALPHA,
                          f"phase 6 {name} {sg.name}: kernel #2's ids or alpha differ from its plain version's")
                    err["flat_prune_aggregate"] = max(err["flat_prune_aggregate"], float((out2 - plain[0]).abs().max()))
                    k1, _, _ = k1_bound(msk2, nbr2, None, sc.theta_src, None, args2[5], alpha2, ids2)
                    _, _, b, o = fused_bound(k1, alpha2, ids2, h, out2)
                    nb2, no2 = nb2 + b, no2 + o
                    k2_calls.append(args2)
                    shapes[f"{name} {sg.name}"]["k2_launches"].append({
                        "rows": int(nbr2.shape[0]), "width": int(nbr2.shape[1]), "valid_slots": int(msk2.sum()),
                        "device_ms": sum(device_times(lambda a=args2: ops.flat_prune_aggregate(*a), 20).values()),
                    })
            bounds[f"prune_aggregate_{name}"] = bound(nb1, no1) + (len(k1_calls),)
            bounds[f"flat_prune_aggregate_{name}"] = bound(nb2, no2) + (len(k2_calls),)
            timed(t, f"prune_aggregate_{name}", lambda c=k1_calls: [ops.prune_aggregate(*a) for a in c], 100)
            timed(t, f"flat_prune_aggregate_{name}", lambda c=k2_calls: [ops.flat_prune_aggregate(*a) for a in c], 100)
            t[f"prune_aggregate_{name}_plain"] = cuda_ms(
                lambda c=k1_calls: [ref.prune_aggregate_plain(*a, 0.2) for a in c], 3, warmup=1)
            t[f"flat_prune_aggregate_{name}_plain"] = cuda_ms(
                lambda c=k2_calls: [ref.flat_prune_aggregate_plain(*a, 0.2) for a in c], 3, warmup=1)
        torch.cuda.synchronize()
    check(max(err.values()) <= TOL_OUT, f"phase 6: a kernel differs from its plain version by {err}")
    return t, bounds, err, shapes


def sgb_phase(pipeline, FlowConfig, ops, default_tasks, card, dev):
    """Phase 6, the SGB options and on-disk data at ``scale=1.0``: ACM,
    IMDB and DBLP exported as dumps and loaded back; for each of
    ``SGB_PATHS``, ``prepare`` with ``bucket_sizes="auto"`` from the
    registry (no cache), then twice from the dump through an empty cache
    directory (a miss, then a hit whose tables are the miss's bit for bit);
    each hit task served as phase 3 serves a task on the bucketed and loop
    routes (launches derived from the SGB, captured, replays bit for bit),
    its logits bit for bit the miss task's and within 1e-4 of the default
    buckets' task and of the CPU forward; one hit task with every parameter
    in bfloat16; then the times. Returns the results."""
    import shutil
    import warnings

    import torch

    from repro_torch.data import datasets, sgb_cache, synthetic

    shutil.rmtree(SGB_DIR, ignore_errors=True)
    cache = SGB_DIR / "cache"
    check(sgb_cache.default_cache_dir() is None, "phase 6: $REPRO_SGB_CACHE is set")
    result = {"card": card, "dumps": {}, "paths": {}}
    dumps = {}
    for ds in ("acm", "imdb", "dblp"):
        g = datasets.resolve(ds, scale=SCALE, seed=0)[0]
        t0 = time.perf_counter()
        dumps[ds] = datasets.save_hetgraph(g, SGB_DIR / "dumps" / ds, name=ds, metapaths=synthetic.METAPATHS[ds])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, name, mps = datasets.resolve(dumps[ds])
        load_s = time.perf_counter() - t0
        same_graph(back, g, f"dump {ds}")
        check(name == ds and mps == {k: list(v) for k, v in synthetic.METAPATHS[ds].items()}, f"dump {ds}: meta")
        result["dumps"][ds] = {"export_s": export_s, "load_s": load_s, "nodes": g.total_nodes,
                               "edges": int(sum(len(s) for s, _ in g.edges.values()))}
    print("  dumps exported and loaded back equal: " + json.dumps(result["dumps"]))

    statuses = []
    real_build_or_load = sgb_cache.build_or_load

    def recording(*args, **kw):
        out, status = real_build_or_load(*args, **kw)
        statuses.append(status)
        return out, status

    def timed_prepare(model, ds, status, device, **kw):
        statuses.clear()
        sync(dev)
        t0 = time.perf_counter()
        task = pipeline.prepare(model, ds, device=device, **kw)
        sync(dev)
        secs = time.perf_counter() - t0
        check(statuses == [status], f"phase 6 {model} {ds}: the SGB cache said {statuses}, expected {status}")
        return task, secs

    launches = {key: 0 for key in ops.LAUNCHES}
    sgb_cache.build_or_load = recording
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*not writable.*")
            for model, ds, md in SGB_PATHS:
                path = f"{model}/{ds}/max_degree={md}"
                kw = dict(scale=SCALE, seed=0, max_degree=md, bucket_sizes="auto")
                reg, reg_s = timed_prepare(model, ds, "off", dev, **kw)
                entries = sorted(cache.glob("*.npz")) if cache.is_dir() else []
                cold, miss_s = timed_prepare(model, str(dumps[ds]), "miss", dev, sgb_cache_dir=cache, **kw)
                new = sorted(set(cache.glob("*.npz")) - set(entries))
                check(len(new) == 1, f"{path}: the miss wrote {len(new)} entries")
                stamp = new[0].stat().st_mtime_ns
                hit, hit_s = timed_prepare(model, str(dumps[ds]), "hit", dev, sgb_cache_dir=cache, **kw)
                check(len(list(cache.glob("*.npz"))) == len(entries) + 1 and new[0].stat().st_mtime_ns == stamp,
                      f"{path}: the hit wrote to the cache")
                check(not hit.sgs[0].buckets[0].nbr_idx.flags.writeable, f"{path}: the hit's tables are not mapped")
                same_sgb(cold.sgs, hit.sgs, f"{path} hit vs miss", ops)
                same_sgb(reg.sgs, hit.sgs, f"{path} hit vs registry", ops)
                for name, p in hit.params.items():
                    check(torch.equal(p, cold.params[name]), f"{path}: weights differ on {name}")
                cpu, _ = timed_prepare(model, str(dumps[ds]), "hit", "cpu", sgb_cache_dir=cache, **kw)
                dflt = default_tasks.get((model, ds, md))
                if dflt is None:
                    dflt = pipeline.prepare(model, ds, scale=SCALE, seed=0, max_degree=md, device=dev)
                r = {"prepare_s": {"registry": reg_s, "dump_miss": miss_s, "dump_hit": hit_s},
                     "capacities": [list(sg.bucket_capacities) for sg in hit.sgs],
                     "default_capacities": [list(sg.bucket_capacities) for sg in dflt.sgs],
                     "padded_slots": {"auto": sum(sg.padded_slots() for sg in hit.sgs),
                                      "default": sum(sg.padded_slots() for sg in dflt.sgs)},
                     "grid_steps": {name: sum(sg.grouped(ops.T_TILE, ops.W_TILE).num_steps for sg in t.sgs)
                                    for name, t in (("auto", hit), ("default", dflt))},
                     "routes": {}}
                for route in SGB_ROUTES:
                    key = f"{path}/{route}"
                    flow = route_flow(FlowConfig, route)
                    want = expected_launches(hit.sgs, route, PRUNE_K, getattr(hit.model, "num_layers", 1), ops)
                    sess, logits, got = captured_session(hit, flow, want, f"phase 6 {key}", ops, dev)
                    for k, n in got.items():
                        launches[k] += n
                    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == sess.out_shape,
                          f"{key}: logits shape or non-finite values")
                    check(same_bits((cold.compile(flow)(cold.params),), (logits,)),
                          f"{key}: the hit's logits differ from the miss task's")
                    d_sess = dflt.compile(flow)
                    e_default = float((logits - d_sess(dflt.params)).abs().max())
                    e_cpu = float((logits.cpu() - cpu.compile(flow)(cpu.params)).abs().max())
                    check(e_default <= TOL_LOGITS and e_cpu <= TOL_LOGITS,
                          f"{key}: logits differ from the default buckets' by {e_default:.3g}, "
                          f"from the CPU by {e_cpu:.3g}")
                    ms = {"auto": [], "default": []}
                    for _ in range(2):  # alternate the two, 20 back-to-back forwards each
                        ms["auto"].append(cuda_ms(lambda: sess(hit.params), 20))
                        ms["default"].append(cuda_ms(lambda: d_sess(dflt.params), 20))
                    widths = k1_widths(hit.sgs, route, PRUNE_K, ops)
                    r["routes"][route] = {
                        "launches": {k: n for k, n in got.items() if n}, "k1_widths": widths,
                        "max_abs_diff_vs_default": e_default, "max_abs_err_vs_cpu": e_cpu,
                        "captured_forward_ms": ms,
                    }
                    print(f"  {key}: auto capacities {r['capacities']}, launches "
                          f"{ {k: n for k, n in got.items() if n} } a forward, K1 widths {widths}, captured "
                          f"(3 replays == eager bitwise), == miss bitwise, |auto-default| {e_default:.3g}, "
                          f"|gpu-cpu| {e_cpu:.3g}, captured forward auto {min(ms['auto']):.4f} / default "
                          f"{min(ms['default']):.4f} ms")
                result["paths"][path] = r
                print(f"  {path}: prepare registry {reg_s:.3f} s, dump miss {miss_s:.3f} s, dump hit {hit_s:.3f} s; "
                      f"padded slots auto {r['padded_slots']['auto']} / default {r['padded_slots']['default']}; "
                      f"grid steps {r['grid_steps']['auto']} / {r['grid_steps']['default']} ({card})")
                if (model, ds, md) == SGB_BF16_PATH:
                    key = f"{path}/bucketed/bfloat16"
                    flow = route_flow(FlowConfig, "bucketed")
                    p16 = {n: p.to(torch.bfloat16) for n, p in hit.params.items()}
                    c16 = {n: p.to(torch.bfloat16) for n, p in cpu.params.items()}
                    want = expected_launches(hit.sgs, "bucketed", PRUNE_K, getattr(hit.model, "num_layers", 1), ops)
                    _, logits, _ = captured_session(hit, flow, want, f"phase 6 {key}", ops, dev, params=p16)
                    e_cpu = float((logits.cpu() - cpu.compile(flow, params=c16)(c16)).abs().max())
                    accs = {}
                    for split in ("val", "test"):
                        n = len(hit.splits[split])
                        a_gpu, a_cpu = pipeline.accuracy(hit, p16, flow, split), pipeline.accuracy(cpu, c16, flow, split)
                        check(round(a_gpu * n) == round(a_cpu * n), f"{key}: {split} accuracy {a_gpu} on the card, "
                                                                    f"{a_cpu} on the CPU")
                        accs[split] = {"gpu": a_gpu, "cpu": a_cpu, "rows": n}
                    check(e_cpu <= TOL_LOGITS and logits.dtype == torch.float32,
                          f"{key}: logits {logits.dtype} differ from the CPU by {e_cpu:.3g}")
                    result["bfloat16"] = {"path": key, "max_abs_err_vs_cpu": e_cpu, "accuracy": accs}
                    print(f"  {key}: every parameter bfloat16, captured, logits float32, |gpu-cpu| {e_cpu:.3g}, "
                          f"accuracy " + ", ".join(f"{s} {a['gpu']:.4f} (CPU {a['cpu']:.4f})" for s, a in accs.items()))
                if (model, ds, md) == ("han", "acm", 256):
                    kernel_pair = (hit, dflt)
    finally:
        sgb_cache.build_or_load = real_build_or_load
    t, bounds, err, shapes = sgb_kernel_times(*kernel_pair, dev)
    result.update(launches={k: n for k, n in launches.items() if n}, kernel_times_ms=t, kernel_err=err,
                  kernel_shapes=shapes, kernel_bounds={k: dict(zip(("bound_ms", "bound_by", "bytes", "ops", "launches"), b))
                                                       for k, b in bounds.items()})
    for key in ("prune_aggregate", "flat_prune_aggregate"):
        line = []
        for name in ("auto", "default"):
            b = result["kernel_bounds"][f"{key}_{name}"]
            line.append(f"{name} {t[f'{key}_{name}']:.4f} ms device ({t[f'{key}_{name}_source']}), "
                        f"{t[f'{key}_{name}_event']:.4f} ms events, plain {t[f'{key}_{name}_plain']:.2f} ms, "
                        f"{b['launches']} launches, bound {b['bound_ms']:.5f} ms ({b['bound_by']}, {b['bytes']} B)")
        print(f"  kernel {key} on han/acm a forward: " + "; ".join(line) + f" ({card})")
    print("  shapes, han/acm layouts: " + json.dumps(shapes))
    return result


def serve_trace(path: Path, window_ms: float) -> dict:
    """Phase 7's reading of a Chrome trace of served blocks: the device's
    busy time (the union of its kernel and copy intervals) over the host's
    window, and, for each pair of consecutive blocks k, k + 1 (one
    ``cudaGraphLaunch`` and one ``cudaEventSynchronize`` a block, in order;
    a replay's kernels carry its launch's correlation id): whether block
    k + 1's replay was launched before block k's replay ended on the card
    (its host-to-device copy and dispatch did not wait for block k), and
    whether block k's resolve returned before block k + 1's replay ended
    (the resolve did not wait for block k + 1). Pageable host-to-device
    copies in the window are counted: they can synchronize the stream."""
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, -float("inf")
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e.get("dur", 0)
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    runtime = sorted((e for e in events if e.get("cat") == "cuda_runtime"), key=lambda e: e["ts"])
    launches = [e for e in runtime if e["name"].startswith("cudaGraphLaunch")]
    syncs = [e for e in runtime if e["name"].startswith("cudaEventSynchronize")]
    ends = {}
    for e in device:
        corr = (e.get("args") or {}).get("correlation")
        ends[corr] = max(ends.get(corr, -float("inf")), e["ts"] + e.get("dur", 0))
    replay_end = [ends.get((e.get("args") or {}).get("correlation")) for e in launches]
    pairs = [k for k in range(len(launches) - 1) if replay_end[k] is not None and replay_end[k + 1] is not None]
    out = {
        "device_busy_ms": busy / 1e3 if device else None, "window_ms": window_ms,
        "busy_share": busy / 1e3 / window_ms if device else None,
        "graph_launches": len(launches), "event_syncs": len(syncs), "replays_traced": sum(r is not None for r in replay_end),
        "pageable_h2d_copies": sum("Pageable" in e["name"] and "HtoD" in e["name"] for e in device),
        "pinned_h2d_copies": sum("Pinned" in e["name"] and "HtoD" in e["name"] for e in device),
    }
    if not pairs or len(syncs) != len(launches):
        out["overlap"] = "not measured (the trace holds no replay kernels by launch, or not one sync a block)"
        return out
    out["pairs"] = len(pairs)
    out["next_dispatched_before_replay_end"] = sum(launches[k + 1]["ts"] < replay_end[k] for k in pairs)
    out["resolved_before_next_replay_end"] = sum(
        syncs[k]["ts"] + syncs[k].get("dur", 0) < replay_end[k + 1] for k in pairs)
    return out


def serve_phase(pipeline, FlowConfig, kernel_ops, dev):
    """Phase 7: the serving front-end (``repro_torch.serve``) over the
    captured ``fused_kernel`` session of RGAT on IMDB at ``scale=1.0``,
    ``max_degree=64`` (the reference's ``benchmarks/serve_load.py`` and
    ``examples/hgnn_serve.py`` setting), policy ``(1, 4, 8, 16)`` with a 2
    ms flush timeout. Each timed window replays the reference's 64-request
    workload ``SERVE_REPEATS`` times and reports over all its requests.
    Replays are counted per session, so kernel #1's replayed launches
    count only the ``fused_kernel`` sessions' forwards, not the ``fused``
    fallback's. Every check raises; returns the results."""
    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.core import flows

    ops = kernel_ops[0]
    res = {}
    task = pipeline.prepare("rgat", "imdb", scale=SCALE, max_degree=SERVE_MAX_DEGREE, seed=0, device=dev)
    flow = FlowConfig("fused_kernel", prune_k=PRUNE_K)
    want = expected_launches(task.sgs, "bucketed", PRUNE_K, task.model.num_layers, ops)
    sess, logits, launches = captured_session(task, flow, want, "serve/rgat/imdb", ops, dev)
    cpu_task = pipeline.prepare("rgat", "imdb", scale=SCALE, max_degree=SERVE_MAX_DEGREE, seed=0,
                                device=torch.device("cpu"))
    err = float((logits.cpu() - cpu_task.compile(flow)(cpu_task.params)).abs().max())
    check(bool(torch.isfinite(logits).all()) and err <= TOL_LOGITS, f"serve: GPU logits differ from the CPU by {err:.3g}")
    full = logits.cpu().numpy()
    n = sess.out_shape[0]
    per_forward = launches["prune_aggregate"]
    policy = serve.BatchPolicy(SERVE_CAPACITIES, flush_timeout=SERVE_FLUSH)
    res["path"] = {"launches": launches, "logits_shape": list(logits.shape), "max_abs_err_vs_cpu": err,
                   "captured_bitwise_eager": 3}

    def counters():
        return [dict(m.LAUNCHES) for m in kernel_ops], dict(flows.DISPATCH)

    # the sessions a served window may replay, by flow, and their replays
    # over every served window
    sessions = {"fused_kernel": [sess], "fused": []}
    replays = {flow: 0 for flow in sessions}

    def served_window(run):
        """``run()`` with the launch counters at 0 and the dispatch
        counters read around it: no launch and no NA dispatch (replays
        only), and one replay of a tracked session a query call; adds the
        replays to ``replays`` by flow and returns run's result and the
        query calls it made."""
        for m in kernel_ops:
            reset_launches(m)
        before = dict(flows.DISPATCH)
        start = {flow: sum(x.forwards for x in xs) for flow, xs in sessions.items()}
        out = run()
        sync(dev)
        launched, after = counters()
        check(all(v == 0 for m in launched for v in m.values()), f"serve: a served window launched {launched}")
        moved = {k: after[k] - before[k] for k in after if k != "query_calls" and after[k] != before[k]}
        check(not moved, f"serve: a served window entered NA dispatch {moved}")
        q = after["query_calls"] - before["query_calls"]
        by_flow = {flow: sum(x.forwards for x in xs) - start[flow] for flow, xs in sessions.items()}
        check(sum(by_flow.values()) == q, f"serve: {q} query calls in a window, but replays {by_flow}")
        for flow, r in by_flow.items():
            replays[flow] += r
        return out, q

    def bit_exact(futs, wl, table, what):
        for w, f in zip(wl, futs):
            rows = f.result(60)
            check(isinstance(rows, np.ndarray) and np.array_equal(rows, table[w.targets]),
                  f"serve: {what}: a future's rows differ from the full forward's")

    def summary(stats, wall_s):
        s = stats.summary()
        return {"wall_s": wall_s, "qps": s["qps"], "qps_wall": s["requests"] / wall_s, "p50_ms": s["p50_ms"],
                "p99_ms": s["p99_ms"], "mean_batch": s["mean_batch"], "pad_fraction": s["pad_fraction"],
                "blocks": s["blocks"], "requests": s["requests"], "repeats": SERVE_REPEATS}

    def repeated(fe, wl):
        """The workload through ``fe`` ``SERVE_REPEATS`` times, each run
        drained before the next; the futures of all runs, in order."""
        return [f for _ in range(SERVE_REPEATS) for f in serve.run_workload(fe, wl)]

    # inline, saturation: serial (one padded block a request) vs microbatched
    wl = serve.make_workload(SERVE_REQUESTS, n, rate=None, size_range=(1, 4), seed=0)
    wl_r = list(wl) * SERVE_REPEATS
    for rep in range(2):  # the first pass warms the pinned pools; the second is reported
        t0 = time.perf_counter()
        (serial_rows, serial_stats), q = served_window(
            lambda: serve.run_serial(sess, task.params, wl_r, policy, serve.SystemClock()))
        serial_s = time.perf_counter() - t0
        check(q == len(wl_r), f"serve: the serial loop made {q} query calls for {len(wl_r)} requests")
        for w, rows in zip(wl_r, serial_rows):
            check(np.array_equal(rows, full[w.targets]), "serve: a serial row differs from the full forward's")
        fe = serve.ServeFrontend(sess, task.params, policy=policy, clock=serve.SystemClock(),
                                 executor=serve.InlineExecutor())
        t0 = time.perf_counter()
        futs, q = served_window(lambda: repeated(fe, wl))
        micro_s = time.perf_counter() - t0
        bit_exact(futs, wl_r, full, "inline")
        for f, rows in zip(futs, serial_rows):
            check(np.array_equal(f.result(0), rows), "serve: a microbatched row differs from the serial loop's")
        check(q == fe.stats.blocks < len(wl_r), f"serve: {q} query calls for {fe.stats.blocks} blocks")
    res["serial"] = summary(serial_stats, serial_s)
    res["microbatched"] = summary(fe.stats, micro_s)
    res["speedup_qps"] = res["microbatched"]["qps"] / res["serial"]["qps"]
    check(res["speedup_qps"] >= 2.0 and res["microbatched"]["mean_batch"] >= 8.0,
          f"serve: microbatched {res['microbatched']['qps']:.0f} QPS against serial {res['serial']['qps']:.0f} "
          f"(need 2x), mean batch {res['microbatched']['mean_batch']:.2f} (need 8)")
    print(f"  serve rgat/imdb (max_degree {SERVE_MAX_DEGREE}), {len(wl)} requests at once, {SERVE_REPEATS} times: serial "
          f"{res['serial']['qps']:.0f} QPS ({res['serial']['blocks']} blocks), microbatched "
          f"{res['microbatched']['qps']:.0f} QPS ({res['microbatched']['blocks']} blocks, mean batch "
          f"{res['microbatched']['mean_batch']:.2f}), {res['speedup_qps']:.2f}x; rows bitwise the full forward, "
          "no launch or NA dispatch in the window")

    # the device's busy share over the inline microbatched window (the
    # profiled window itself), and the double buffer in bursts each drained
    # by one pump (blocks back to back)
    from torch.profiler import ProfilerActivity, profile

    trace_dir = ROOT / "build"
    trace_dir.mkdir(exist_ok=True)
    for name, burst in (("window", False), ("burst", True)):
        fe = serve.ServeFrontend(sess, task.params, policy=policy, clock=serve.SystemClock(),
                                 executor=serve.InlineExecutor())

        def run(fe=fe, burst=burst):
            if not burst:
                return repeated(fe, wl)
            futs = []
            for _ in range(SERVE_REPEATS):
                futs += [fe.submit(w.targets) for w in wl]
                fe.flush()
            return futs

        sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            futs, _ = served_window(run)
            window_ms = (time.perf_counter() - t0) * 1e3
        bit_exact(futs, wl_r, full, f"profiled {name}")
        path = trace_dir / f"serve_trace_{name}.json"
        prof.export_chrome_trace(str(path))
        res[f"trace_{name}"] = dict(serve_trace(path, window_ms), blocks=fe.stats.blocks, repeats=SERVE_REPEATS)
        print(f"  serve trace, {name}: " + json.dumps(res[f"trace_{name}"]))
    # an estimate, not a measurement of one window: the profiled run's
    # device time over the wall time of the unprofiled run of the same
    # traffic (the profiler slows the host, not the card)
    busy = res["trace_window"]["device_busy_ms"]
    res["busy_share_estimate"] = None if busy is None else busy / (res["microbatched"]["wall_s"] * 1e3)

    # threaded: paced Poisson arrivals
    wl_t = serve.make_workload(SERVE_REQUESTS, n, rate=SERVE_RATE, size_range=(1, 4), seed=0)
    fe = serve.ServeFrontend(sess, task.params, policy=policy, clock=serve.SystemClock(),
                             executor=serve.ThreadExecutor())

    def threaded():
        with fe:
            futs = repeated(fe, wl_t)
            bit_exact(futs, wl_t * SERVE_REPEATS, full, "threaded")
        return futs

    t0 = time.perf_counter()
    served_window(threaded)
    res["threaded"] = summary(fe.stats, time.perf_counter() - t0)
    for t in fe.executor.threads:
        t.join(5.0)
    check(not any(t.is_alive() for t in fe.executor.threads), "serve: a loop thread outlived close")
    print(f"  serve threaded, {len(wl_t)} requests at {SERVE_RATE:.0f}/s, {SERVE_REPEATS} times: p50 {res['threaded']['p50_ms']:.3f} ms, "
          f"p99 {res['threaded']['p99_ms']:.3f} ms, {res['threaded']['blocks']} blocks; both threads ended")

    # two tenants through one donate_params session, weights streamed
    trained = pipeline.train_hgnn(task, steps=SERVE_TRAIN_STEPS, lr=TRAIN_LR)
    sess_d = task.compile(flow, donate_params=True)
    check(sess_d.captured and sess_d.donate_params and sess_d is not sess, "serve: no captured donate_params session")
    sessions["fused_kernel"].append(sess_d)
    tables = {"init": sess_d(task.params).cpu().numpy(), "trained": sess_d(trained).cpu().numpy()}
    check(np.array_equal(tables["init"], full) and np.array_equal(tables["trained"], sess(trained).cpu().numpy()),
          "serve: the donate_params session's forward differs from the primary's")
    check(not np.array_equal(tables["init"], tables["trained"]), "serve: training did not change the logits")
    plane = serve.WeightPlane(task.params, stream=True)
    plane.publish("init", task.params)
    plane.publish("trained", trained)
    check(all(t.is_pinned() for t in plane._versions["trained"].values()), "serve: a streamed snapshot is not pinned")
    wl_2 = serve.make_workload(SERVE_REQUESTS, n, tenants=("init", "trained"), seed=9)
    fe = serve.ServeFrontend(sess_d, plane, policy=policy, clock=serve.SystemClock(), executor=serve.InlineExecutor())
    futs, _ = served_window(lambda: serve.run_workload(fe, wl_2))
    for w, f in zip(wl_2, futs):
        check(np.array_equal(f.result(0), tables[w.tenant][w.targets]), f"serve: tenant {w.tenant}'s rows differ")
    res["tenants"] = {"requests": len(wl_2), "blocks": fe.stats.blocks,
                      "by_tenant": {t: sum(w.tenant == t for w in wl_2) for t in ("init", "trained")}}
    print(f"  serve two tenants (init, trained {SERVE_TRAIN_STEPS} steps), streamed from pinned memory through one "
          f"donate_params session: {fe.stats.blocks} blocks, each tenant's rows bitwise its own forward")

    # degradation: the primary fails for good, the breaker routes to a
    # captured fused fallback, prewarmed by the front-end
    fallback = task.compile(FlowConfig("fused", prune_k=PRUNE_K))
    check(fallback.captured, "serve: the fallback session is not captured")
    sessions["fused"].append(fallback)
    fb_full = fallback(task.params).cpu().numpy()
    n_ties, reached = tie_rows(task, task.params, PRUNE_K, FlowConfig)
    reached = reached.cpu().numpy()
    plan = serve.FaultPlan()
    plan.fail("dispatch", RuntimeError("injected primary failure"), engine="primary", times=None)
    fe = serve.ServeFrontend(sess, task.params, policy=policy, clock=serve.SystemClock(),
                             executor=serve.InlineExecutor(), fallback=fallback, faults=plan,
                             supervisor=serve.SupervisorPolicy(max_retries=0, breaker_threshold=2))
    check(sorted(fallback.query_capacities) == list(SERVE_CAPACITIES), "serve: the fallback ladder is not prewarmed")
    kernel_replays = replays["fused_kernel"]
    futs, _ = served_window(lambda: serve.run_workload(fe, wl))
    check(replays["fused_kernel"] == kernel_replays and replays["fused"] == fe.stats.fallback_blocks,
          f"serve: the degraded window replayed {replays}, {fe.stats.fallback_blocks} fallback blocks")
    d_primary = 0.0
    for w, f in zip(wl, futs):
        check(f.exception(0) is None and f.via == "fallback", f"serve: a degraded future: {f.exception(0)!r}, {f.via}")
        check(np.array_equal(f.result(0), fb_full[w.targets]), "serve: a degraded row differs from the fallback's")
        keep = ~reached[w.targets]
        if keep.any():
            d_primary = max(d_primary, float(np.abs(f.result(0)[keep] - full[w.targets][keep]).max()))
    check(d_primary <= TOL_LOGITS, f"serve: fallback rows differ from the primary's by {d_primary:.3g}")
    check(fe.breaker.trips >= 1 and fe.stats.failed == 0, f"serve: trips {fe.breaker.trips}, failed {fe.stats.failed}")
    res["degraded"] = {"blocks": fe.stats.blocks, "fallback_blocks": fe.stats.fallback_blocks,
                       "trips": fe.breaker.trips, "max_abs_diff_vs_primary": d_primary, "na_tie_rows": n_ties,
                       "tie_reached_logit_rows": int(reached.sum())}
    print(f"  serve degraded: breaker tripped {fe.breaker.trips}x, {fe.stats.fallback_blocks} blocks via the "
          f"fallback, rows bitwise its forward, {d_primary:.3g} from the primary's ({n_ties} NA tie rows)")

    # a wedged threaded front-end over the card session: close ends both threads
    plan = serve.FaultPlan()
    plan.fail("drain", RuntimeError("wedged drain"), times=None)
    fe = serve.ServeFrontend(sess, task.params, policy=policy, clock=serve.SystemClock(),
                             executor=serve.ThreadExecutor(), faults=plan).start()
    futs = [fe.submit(w.targets) for w in wl[:8]]
    t0 = time.perf_counter()
    fe.close(timeout=0.5)
    close_s = time.perf_counter() - t0
    check(all(isinstance(f.exception(0), serve.ServeClosedError) for f in futs),
          "serve: a wedged front-end's future does not hold ServeClosedError")
    for t in fe.executor.threads:
        t.join(1.0)
    check(not any(t.is_alive() for t in fe.executor.threads), "serve: a wedged front-end's thread outlived close")
    res["wedged_close"] = {"close_s": close_s, "collector_errors": fe.health().collector_errors}
    print(f"  serve wedged: close(timeout=0.5) returned in {close_s:.2f} s, 8 futures ServeClosedError, both threads "
          f"ended, {fe.health().collector_errors} failed drains (backed off)")

    # bad ids raise at submit, before any launch; the context serves on
    fe = serve.ServeFrontend(sess, task.params, policy=policy, clock=serve.SystemClock(),
                             executor=serve.InlineExecutor())

    def bad_then_good():
        for bad in ([-1], [n]):
            try:
                fe.submit(bad)
            except IndexError:
                continue
            raise AssertionError(f"serve: submit({bad}) did not raise IndexError")
        check(len(fe.queue) == 0, "serve: a bad request was queued")
        f = fe.submit([n - 1, 0, 1])
        fe.flush()
        return f

    f, _ = served_window(bad_then_good)
    check(np.array_equal(f.result(0), full[[n - 1, 0, 1]]), "serve: the block after the bad ids differs")
    res["replayed_forwards"] = dict(replays)
    res["replayed_launches"] = replays["fused_kernel"] * per_forward
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import hetgraph, pipeline
    from repro_torch.core.flows import FlowConfig
    from repro_torch.kernels.fused_prune_aggregate import ops
    from repro_torch.kernels.topk_decode_attention import ops as tda_ops
    from repro_torch.kernels.topk_select import ops as ts_ops

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # phase 1: build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = list(pool.map(lambda m: m.library()[1], (ops, tda_ops, ts_ops)))
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {len(builds)} kernel libraries in {build_s:.2f} s")
    for record in builds:
        print(f"  {record['path']}: nvcc {record['seconds']:.2f} s")
        for line in record["log"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # host-side SGB for the main path, on the CPU (also the CPU reference)
    cpu_tasks = {ds: pipeline.prepare("han", ds, scale=SCALE, seed=0, device="cpu") for ds in ("dblp", "acm")}
    acm_union = pipeline.prepare("simple_hgn", "acm", scale=SCALE, seed=0, bucket_sizes=None, device="cpu")

    # phase 2: kernels against their plain versions on the card
    phase_s = {"1": build_s}
    t_phase = time.perf_counter()
    print("phase 2: CUDA kernels against their plain PyTorch versions")
    err = check_kernels(kernel_cases(hetgraph, cpu_tasks), dev)
    check_tie(hetgraph, dev)
    err.update(check_flat_kernels(
        flat_cases(acm_union.batch.sg_by_dst["paper"], acm_union.batch.total_nodes), dev
    ))
    check_flat_tie_and_width(dev)
    dec_err, dec_ties = check_decode_kernels(dev)
    err.update(dec_err)
    check_decode_tie_and_width(dev)
    e_tie, tie_cases = check_decode_tie_path(dev)
    err["score_prune"] = max(err["score_prune"], e_tie)
    err["topk_select"] = check_pruner_kernel(dev)

    # phase 3: the main paths
    phase_s["2"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    print(f"phase 3: fused_kernel serving at scale={SCALE}, prune_k={PRUNE_K}")
    reset_launches(ts_ops)
    results, gpu_tasks = main_path(pipeline, FlowConfig, ops, cpu_tasks, dev)
    model_results, model_tasks = model_paths(pipeline, hetgraph, FlowConfig, ops, dev)
    results.update(model_results)
    wide_results, wide_tasks = wide_paths(pipeline, hetgraph, FlowConfig, ops, dev)
    check(ts_ops.LAUNCHES["topk_select"] == 0, "the HGNN forwards launched the Pruner")
    print(f"phase 3: {LM_ARCH} serving, prefill {LM_BATCH}x{LM_PROMPT} + {LM_GEN} decode steps")
    lm_result, lm, prompts, cache0, tok0 = lm_main_path(dev, ops, ts_ops)
    lm_result["cpu_check"] = lm_cpu_check(dev)
    print("phase 3: the Pruner (kernel #3) on the scores of the served paths")
    decode_in = capture_decode_inputs(lm, cache0, tok0)
    pruner_result, pruner_shapes = pruner_main_path(model_tasks, FlowConfig, ops, ts_ops, tda_ops, decode_in, dev)

    # phase 4: times
    phase_s["3"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    print("phase 4: times (CUDA events)")
    t, bounds, shapes = grouped_timings(gpu_tasks["dblp"], dev)
    t_flat, b_flat, s_flat = flat_timings(model_tasks["simple_hgn/acm/flat"], dev)
    t.update(t_flat)
    bounds.update(b_flat)
    t_wide, b_wide, s_wide, e_wide = wide_timings(wide_tasks, dev)
    t.update(t_wide)
    bounds.update(b_wide)
    modes = ("eager", "captured")
    fwd, latency, prof = ({mode: {} for mode in modes} for _ in range(3))
    sessions = {f"han/{ds}/bucketed": (task, FlowConfig("fused_kernel", prune_k=PRUNE_K))
                for ds, task in gpu_tasks.items()}
    for key, task in model_tasks.items():
        sessions[key] = (task, route_flow(FlowConfig, key.rsplit("/", 1)[1]))
    for key, (task, flow) in sessions.items():
        sess = task.compile(flow)

        def eager(task=task, flow=flow):
            with torch.inference_mode():
                return task.model.apply(task.params, task.batch, flow)

        for mode, fn in (("eager", eager), ("captured", lambda: sess(task.params))):
            fwd[mode][key] = cuda_ms(fn, 20)
            lat = []
            for _ in range(20):  # one forward at a time: host clock around a synchronized call
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            latency[mode][key] = sorted(lat)[len(lat) // 2]
            if "/acm/" in key:
                prof[mode][key] = forward_profile(fn, fwd[mode][key])
    print("  shapes, grouped pair: " + json.dumps(shapes))
    print("  shapes, flat pair: " + json.dumps(s_flat))
    print("  times_ms: " + json.dumps(t))
    print("  forward_ms (back to back, CUDA events): " + json.dumps(fwd))
    print("  forward_latency_ms (median, host clock, synchronized): " + json.dumps(latency))
    for key in sessions:
        busy = {mode: (prof[mode].get(key) or {}).get("device_busy_ms") for mode in modes}
        line = (f"  forward {key}, eager / captured: back to back {fwd['eager'][key]:.4f} / "
                f"{fwd['captured'][key]:.4f} ms, latency {latency['eager'][key]:.4f} / {latency['captured'][key]:.4f} ms")
        if key in prof["eager"]:
            line += ", device busy " + " / ".join("not measured" if busy[m] is None else f"{busy[m]:.4f} ms"
                                                  for m in modes)
            if busy["captured"] is None:
                line += " (the profiler saw no kernel inside a replay: the captured forward's busy time is not measured)"
        print(line)
    for mode in modes:
        for key, p in prof[mode].items():
            if p:
                p = dict(p, top_kernels_ms=p["top_kernels_ms"][:6])
            print(f"  profile {key} {mode}: " + (json.dumps(p) if p else "profiler saw no device time: not measured"))
    t_dec, b_dec, s_dec, lm_prof = decode_timings(lm, prompts, cache0, tok0, decode_in, dev)
    t.update(t_dec)
    bounds.update(b_dec)
    steps = sorted(lm_result["step_ms_events"][1:])
    lm_result["decode_step_ms_median"] = steps[len(steps) // 2]
    lm_result["tokens_per_s"] = LM_BATCH / (lm_result["decode_step_ms_median"] / 1e3)
    lm_result["prefill_ms"] = t_dec["lm_prefill_ms"]
    lm_result["profile"] = lm_prof
    print("  shapes, decode pair: " + json.dumps(s_dec))
    print("  times_ms, decode pair: " + json.dumps({k: v for k, v in t_dec.items() if not k.startswith("lm_")}))
    steps = sorted(lm_result["captured_step_ms_events"][1:])
    lm_result["captured_decode_step_ms_median"] = steps[len(steps) // 2]
    lm_result["captured_tokens_per_s"] = LM_BATCH / (lm_result["captured_decode_step_ms_median"] / 1e3)
    print(f"  {LM_ARCH}: prefill {LM_BATCH}x{LM_PROMPT} {lm_result['prefill_ms']:.1f} ms (CUDA events), "
          f"decode step eager / captured {lm_result['decode_step_ms_median']:.2f} / "
          f"{lm_result['captured_decode_step_ms_median']:.2f} ms median of steps 2-{LM_GEN} "
          f"({lm_result['tokens_per_s']:.1f} / {lm_result['captured_tokens_per_s']:.1f} tokens/s at batch {LM_BATCH}); "
          f"back to back at one position {t_dec['lm_step_ms']:.2f} / {t_dec['lm_captured_step_ms']:.2f} ms")
    for mode, p in lm_prof.items():
        print(f"  profile {LM_ARCH} decode step {mode}: "
              + (json.dumps(dict(p, top_kernels_ms=p["top_kernels_ms"][:6])) if p
                 else "profiler saw no device time: not measured"))
    t_ts = pruner_timings(pruner_shapes, dev)

    # phase 5: HGNN training and the fig9 sweep
    phase_s["4"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    print(f"phase 5: HGNN training on ACM at scale={SCALE} ({TRAIN_STEPS} steps, lr {TRAIN_LR}) and the fig9 "
          f"sweep K={list(FIG9_KS)}")
    train = train_phase(pipeline, FlowConfig, ops, {
        "han": gpu_tasks["acm"], "rgat": model_tasks["rgat/acm/bucketed"],
        "simple_hgn": model_tasks["simple_hgn/acm/bucketed"],
    }, dev)

    # phase 6: the SGB options and on-disk data
    phase_s["5"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    print(f"phase 6: SGB options and on-disk data at scale={SCALE}: dumps, bucket_sizes='auto' through the "
          "artifact cache, served")
    default_tasks = {("han", ds, 256): task for ds, task in gpu_tasks.items()}
    default_tasks.update({(m, ds, 256): model_tasks[f"{m}/{ds}/bucketed"]
                          for m in ("rgat", "simple_hgn") for ds in ("acm", "imdb")})
    sgb = sgb_phase(pipeline, FlowConfig, ops, default_tasks, card, dev)
    phase_s["6"] = time.perf_counter() - t_phase
    print(f"phase 6: wall time {phase_s['6']:.1f} s")

    # phase 7: the serving front-end
    t_phase = time.perf_counter()
    print(f"phase 7: the serving front-end (repro_torch.serve) on RGAT IMDB at scale={SCALE}, "
          f"max_degree={SERVE_MAX_DEGREE}, policy {SERVE_CAPACITIES}")
    served = serve_phase(pipeline, FlowConfig, (ops, tda_ops, ts_ops), dev)
    results["serve/rgat/imdb"] = served["path"]
    phase_s["7"] = time.perf_counter() - t_phase
    print(f"phase 7: wall time {phase_s['7']:.1f} s")

    kernels = []
    for key, line, lib in KERNELS:
        bound_ms, bound_by, nbytes, nops = bounds[key]
        per_fwd = {path: r["launches"][key] for path, r in results.items() if r["launches"][key]}
        kernels.append({
            "name": f"fused_prune_aggregate.{key}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/fused_prune_aggregate/csrc/fused_prune_aggregate.cu",
            "replaces": f"src/repro/kernels/fused_prune_aggregate/{line}",
            "launches": sum(per_fwd.values()),
            "launches_per_forward": per_fwd,
            "max_abs_err": err[key],
            "ms": t[key],
            "ms_source": t[f"{key}_source"],
            "event_ms": t[f"{key}_event"],
            "plain_ms": t[f"{key}_plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_bytes": nbytes,
            "bound_ops": nops,
            "library_ms": t[lib] if lib else None,
            "library_event_ms": t[f"{lib}_event"] if lib else None,
            "shapes": (s_flat if key.startswith("flat_") else shapes)["graph"],
            "check": CHECKS[key.removeprefix("flat_")],
        })
        if key == "prune_aggregate":
            kernels[-1]["replayed_launches_phase7"] = served["replayed_launches"]
    wide_rows = (("prune_wide", "prune", KERNELS[0][1]), ("prune_aggregate_wide", "prune_aggregate", KERNELS[2][1]),
                 ("flat_prune_wide", "flat_prune", KERNELS[3][1]),
                 ("flat_prune_aggregate_wide", "flat_prune_aggregate", KERNELS[5][1]))
    for key, base, line in wide_rows:
        bound_ms, bound_by, nbytes, nops = bounds[key]
        per_fwd = {path: r["launches"][base] for path, r in wide_results.items() if r["launches"][base]}
        wide = {path: r["wide_launches"] for path, r in wide_results.items() if r["launches"][base]}
        kernels.append({
            "name": f"fused_prune_aggregate.{key}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/fused_prune_aggregate/csrc/fused_prune_aggregate.cu",
            "replaces": f"src/repro/kernels/fused_prune_aggregate/{line}",
            "launches": sum(per_fwd.values()),
            "launches_on": "the wide path (HAN ACM, max_degree=None), all widths; wider than 256 by path in "
                           "wide_launches_per_forward",
            "launches_per_forward": per_fwd,
            "wide_launches_per_forward": wide,
            "max_abs_err": e_wide[key],
            "ms": t[key],
            "ms_source": t[f"{key}_source"],
            "event_ms": t[f"{key}_event"],
            "plain_ms": t[f"{key}_plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_bytes": nbytes,
            "bound_ops": nops,
            "library_ms": None,
            "library_event_ms": None,
            "shapes": s_wide[key],
            "check": CHECKS[base.removeprefix("flat_")],
        })
    for key, line, lib in DECODE_KERNELS:
        bound_ms, bound_by, nbytes, nops = bounds[key]
        kernels.append({
            "name": f"topk_decode_attention.{key}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/topk_decode_attention/csrc/topk_decode_attention.cu",
            "replaces": f"src/repro/kernels/topk_decode_attention/{line}",
            "launches": lm_result["launches"][f"topk_decode_attention.{key}"],
            "launches_per_decode_step": lm_result["launches_per_decode_step"],
            "max_abs_err": err[key],
            "ms": t[key],
            "ms_source": t[f"{key}_source"],
            "event_ms": t[f"{key}_event"],
            "plain_ms": t[f"{key}_plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_bytes": nbytes,
            "bound_ops": nops,
            "library_ms": t[lib] if lib else None,
            "library_event_ms": t[f"{lib}_event"] if lib else None,
            "shapes": s_dec["inputs"],
            "check": "pass: ids equal, alpha <= 1e-6" if key == "score_prune" else "pass: out <= 1e-5",
        })
    ts_row = t_ts["iii"]  # the widest and slowest of the shapes phase 3 feeds it
    kernels.append({
        "name": "topk_select.topk_select",
        "route": "cuda",
        "source": "src/repro_torch/kernels/topk_select/csrc/topk_select.cu",
        "replaces": "src/repro/kernels/topk_select/kernel.py:28 _pruner_kernel (topk_select_pallas, kernel.py:57)",
        "launches": pruner_result["launches"],
        "launches_on": "its entry point topk_select on the scores of phase 3 (no serving flow calls it)",
        "max_abs_err": err["topk_select"],
        "ms": ts_row["kernel"],
        "ms_source": ts_row["kernel_source"],
        "event_ms": ts_row["kernel_event"],
        "plain_ms": ts_row["plain_ms"],
        "bound_ms": ts_row["bound_ms"],
        "bound_by": ts_row["bound_by"],
        "bound_bytes": ts_row["bound_bytes"],
        "bound_ops": ts_row["bound_ops"],
        "library_ms": ts_row["library"],
        "library_event_ms": ts_row["library_event"],
        "shapes": ts_row["shape"],
        "by_shape": {key: {name: v for name, v in r.items() if not name.endswith("_source")} for key, r in t_ts.items()},
        "check": "pass: values bitwise equal, ids equal",
    })
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps({
        "card": card, "results": results, "wide_path": wide_results, "lm": lm_result, "pruner": pruner_result, "times_ms": t,
        "decode_k1_tie_rows": {"phase2_cases": dec_ties, "phase2_tie_cases": tie_cases,
                               "main_path": lm_result["tie_rows"]},
        "pruner_times_ms": t_ts, "forward_ms": fwd, "forward_latency_ms": latency, "profiles": prof,
        "train": train, "sgb": sgb, "serve": served, "kernels": kernels, "phase_wall_s": phase_s,
    }, indent=1))
    print(f"  full report: {REPORT.relative_to(ROOT)}; wall time {time.perf_counter() - t_start:.1f} s, by phase (s) "
          + json.dumps({k: round(v, 1) for k, v in phase_s.items()}))
    print("train " + json.dumps({model: {
        key: r[key] for key in ("step_ms_captured", "step_ms_eager", "first_step_ms", "device_busy_share")
    } for model, r in train.items()}))
    print("serve " + json.dumps({
        "path": f"rgat/imdb scale={SCALE} max_degree={SERVE_MAX_DEGREE} fused_kernel K={PRUNE_K}, policy "
                f"{list(SERVE_CAPACITIES)}",
        "serial": served["serial"], "microbatched": served["microbatched"], "speedup_qps": served["speedup_qps"],
        "threaded": {k: served["threaded"][k] for k in ("p50_ms", "p99_ms", "blocks", "mean_batch")},
        "busy_share_inline_window": {"profiled": served["trace_window"]["busy_share"],
                                     "estimate_traced_busy_over_unprofiled_window": served["busy_share_estimate"]},
        "replayed_forwards": served["replayed_forwards"],
        "overlap_burst": {k: served["trace_burst"].get(k) for k in (
            "pairs", "next_dispatched_before_replay_end", "resolved_before_next_replay_end", "overlap",
            "pageable_h2d_copies")},
        "card": card,
    }))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
