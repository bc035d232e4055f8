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
   the shapes the cross-attention archs' pruned cross-attention gives it in
   phase 11 (llama-3.2-vision-90b's C layers: 8 q-heads a kv-head, hd 128,
   4096 context rows, K 1024; seamless-m4t-medium's D cross: 1 a kv-head,
   hd 64, 1024 rows, K 256; bfloat16, every row valid) and integer q and
   keys at llama's grouping (tie-heavy), and a K too wide for shared
   memory, which raises before any launch;
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
8. serves ego subgraphs (``session.query_ego``) in the setting of the
   reference's ``benchmarks/serve_ego.py``, grown to IMDB at ``scale=1.0``,
   ``max_degree=64``, K = 8, ``enable_ego(seed=0, sample_sizes=(1, 4))``,
   32 seeded queries of 1 and 4 targets, HAN (depth 1), RGAT (3) and
   Simple-HGN (2) on captured ``fused_kernel`` sessions. A first pass
   captures one CUDA graph per ego signature: kernel #2's launches must be
   2 (warm-up and capture) per layer and ego table wider than K of each
   captured signature, and HAN's ego globals (its β over the full graph)
   add kernel #1's launches of one forward once. A second pass replays:
   no program built, no launch or NA dispatch counter moving, every query
   an ego call or a counted fallback, every row within 1e-5 of the
   captured full forward, bit for bit the eager ego forward on the card on
   the same ego batch, which is within 1e-4 of the port's CPU ego forward
   (the plain versions). Then the overflow (capacities (1,): a counted
   fallback, bit for bit ``session.query``), ids -1 and ``num_targets``
   raising ``IndexError`` before any launch, then a good query; the front-
   end with ``BatchPolicy((1, 4, 8, 16), 2 ms, ego=True)`` on RGAT serving
   phase 7's 64-request workload inline (on a fake clock, so the served
   window meets the warm-up's blocks): rows within 1e-5, query calls equal
   to the fallbacks, no launch in the served window; per query, medians of
   20 repeats, ``query_ego`` against ``query`` (host extraction, the
   replay's device time, wall time, rows and bytes read), the ego graphs
   captured and the memory their private pools hold; and HAN at
   ``scale=1.0`` and 4.0 (rows a query must grow at most half as fast as
   the graph);
9. streams graph deltas (``repro_torch.stream``) in the setting of the
   reference's ``benchmarks/graph_deltas.py`` full run: RGAT on DBLP at
   ``scale=1.0``, ``max_degree=None``, seed 0, ``enable_ego(seed=0,
   sample_sizes=(1, 4))``, 8 batches of 48 random edges alternating AP and
   PV, one ego-continuity delta first; the one change is the session, the
   captured ``fused_kernel`` flow at K = 8 (the reference runs ``fused``),
   so kernel #1 is on the path. Every successor is a new CUDA graph
   captured by ``StreamIngestor.ingest``; after each ingest its warm-up
   and capture must have launched kernel #1 twice a forward's count and a
   replay none; clean slices' device tables and every feature tensor must
   be the predecessor's (``data_ptr``), dirty slices' their own; the
   predecessor's dirty tables are zeroed and the successor's replay must
   not change; the merged host tables must equal a cold ``prepare`` of
   the version's graph array for array, its captured logits that cold
   capture's bit for bit, each dirty slice's fused NA on seeded inputs the
   cold slice's bit for bit, and every version's logits the CPU forward
   (plain versions) within 1e-5. (RGAT's DBLP logits read no NA, since the
   labeled type receives no relation: the table checks are the ones that
   see a delta.) The ego proof: an absorb-tier delta outside a warm
   closure recaptures nothing, carries the closure, adopts the ego graphs,
   hits the closure and serves the query bit for bit as before. An inline
   front-end (fake clock) serves 2 requests an ingest, each row bit for bit
   its version's. The merge's mean time over the 8 batches must be at
   most 0.2 of a cold rebuild (the builders plus the grouped layouts,
   median of 5), as the reference asserts. Then HAN on DBLP: an AP delta
   (the full-rebuild tier: APA's compose draws under the fanout cap, so no
   closure is carried) whose adopted ego graph must recapture nothing and
   serve the successor's β (rows bit for bit the eager ego forward with
   it, 1e-5 of the successor's full forward), where zeroing the
   successor's own APA mask moves the logits and restoring it restores
   them. Then a session dropped while its replay waits behind a spin on
   another stream, whose feature memory must not be handed out first; and
   a threaded front-end at 2000 requests/s, paced, serving through the 8
   ingests on a fresh task: nothing failed, shed, expired or stranded,
   every row bit for bit the rows of the version that served it (the
   checkout recorded per block), every version serving, and the memory
   reserved after the 8 ingests within one session's pool plus one set of
   tables of where it started;
10. shards grouped NA: every shard of the 2-, 4- and 8-way splits of
   phase 3's bucketed paths and of the wide path (K None and 300) through
   ``ops.shard_out`` on the card, each stitched output bit for bit the
   single-device fused launch with one launch per shard that has grid
   steps; a one-rank NCCL device mesh (a ``tcp://127.0.0.1`` rendezvous,
   destroyed at the end of the phase) under which ``prepare`` splits
   every graph and HAN ACM, RGAT IMDB and Simple-HGN IMDB are captured
   (logits bit for bit the unsharded sessions', no launch on a replay,
   both timed back to back); two RGAT DBLP deltas on a ``shards=2`` task
   (phase 9's first batch, then one into rows with room: splits equal to
   a cold build's, the successor on the same mesh, a new shard reading no
   device mirror of its predecessor); and a HAN ACM training step
   captured while a threaded front-end serves RGAT IMDB at 2000
   requests/s, with no failed request;
11. serves the dense, MoE, recurrent and cross-attention LM archs through
   ``build_model``, ``prefill`` and ``compile_decode``, with seeded
   weights: qwen2-1.5b, chatglm3-6b, olmoe-1b-7b, recurrentgemma-2b
   (RG-LRU "R" blocks and local attention, 2:1; the prompt passes its
   2048-token window), rwkv6-3b (RWKV-6 "W" blocks) and
   seamless-m4t-medium (12 "E" encoder layers over 1024 stub audio frames,
   12 "D" decoder layers) whole at their published configs, qwen2-72b (8 of
   80 layers), arctic-480b (1 of 35) and llama-3.2-vision-90b (10 of 100:
   two A A A A C cycles, over 4096 stub image embeddings) at full width
   with their depth cut to fit one card. The two cross-attention archs'
   gates are drawn from N(0, 1) (the seeded init's are zero, which
   silences the cross path) and their context on the card; the logits'
   change with every gate at zero is printed. Each runs a prefill of
   (4, 3072) and 32 greedy decode steps (8 for the cut three) eagerly,
   then the same steps through the compiled step: tokens, float32 logits
   and every cache and recurrent state tensor bit for bit the eager
   loop's, and no kernel of the port launched (none of these published
   configs prunes). Then the cross-attention archs again with ADE on
   (``attn_prune_k`` 1024 for llama, 256 for seamless, as the launcher's
   ``--prune-k`` sets it): a second LM on the same parameters (shared, not
   copied), the same steps from a clone of the prefill cache,
   teacher-forced on the dense run's tokens, eager (kernel #4's pair
   launched once each per pruned attention a step: llama's 8 A and 2 C
   layers, seamless's 12 self and 12 cross) and captured (bit for bit, no
   launch on a replay), step times beside the dense ones and the top-1
   agreement with the dense logits, and the decode pair timed at the first
   cross-attention's inputs. It times the prefill and both decode loops, profiles a
   captured step (and, for chatglm3-6b and qwen2-72b, a prefill: device
   time by kernel, busy share),
   reads the peak reserved memory, counts each decode step's bytes (the weights it reads
   in the compute dtype, all of olmoe's experts included, the KV rows it
   needs, at most a window's on a local layer, a context's K rows and the
   V rows kept, and the recurrent states it
   reads and writes), and prints how many (token, expert) picks each olmoe
   prefill group dropped. For the five whole archs and the two
   cross-attention ones, 2 layers (3 for recurrentgemma-2b: R R L; an A and
   a C for llama; 2 D over 2 E for seamless) at full width in float32 on
   the card and on the CPU (one seeded set of weights, gates drawn): the
   prefill of (2, 300) and two decode steps' logits within 1e-4 of the
   CPU's logit scale, and for the cross-attention archs the two steps again
   pruned (kernel #4 on the card, its plain version on the CPU). For olmoe each layer's routing is compared first:
   a token whose top-8 experts differ on the two devices is a flip, printed
   with its top-8 margin on the CPU; the check fails above 1 % of the
   routed tokens or at a flip whose margin exceeds 1e-5, and holds the
   logits only on sequences whose every token was routed and slotted
   alike;
12. LM training (no kernel of the port is on its path; every launch
   counter is zeroed first and must read zero after it): the flash
   backward (``layers/flash.py``'s ``Flash``) against autograd through a
   dense materialised-softmax attention in float32 at qwen2-1.5b's global
   layer (12 q-heads over 2, hd 128, causal, S 4096), recurrentgemma-2b's
   local one (10 over 1, hd 256, window 2048) and seamless-m4t-medium's
   cross-attention (16 over 16, hd 64, 4096 queries over 1024 frames),
   dq / dk / dv within 1e-4 of their largest magnitude, backward ms and
   peak memory of both printed; then 6 eager ``make_train_step`` steps of
   the token pipeline at (8, 4096), train_4k's sequence with its global
   batch cut from 256 to 8, the config's optimizer, remat and grad_accum
   and seeded weights (the step's first call on the card grows the
   allocator's segments, ``steps.grow_allocator_segments``): qwen2-1.5b and seamless-m4t-medium (1024 stub
   frames a row) whole, recurrentgemma-2b at 12 of 26 layers (whole it
   needs ~104 GB); each prints step ms (steps 2-6, CUDA events), tokens/s,
   peak reserved memory, every step's loss (finite), the leaves changed
   and the model-FLOPs share of 989 TFLOP/s (dense bf16); arctic-480b is
   not run (1 of 35 layers with its float32 gradient accumulator is ~84
   GB). qwen2-1.5b at 2 layers, full width, float32, on the card and the
   CPU: the loss of (2, 256) tokens within 1e-5 relative, every gradient
   within 1e-4 of its leaf's largest magnitude, and AdamW's and
   Adafactor's new parameters from the same gradients within 1e-6; a
   ``Trainer`` run on the card stopped after an asynchronous save at step
   3 and resumed in a new ``Trainer``, its losses equal to an uninterrupted
   run's bit for bit, the bytes written and the save seconds printed;
13. the LM on a device mesh (``distributed/sharding.py``, ``launch/mesh.py``,
   ``launch/steps.py``): the caching allocator's settings in effect are
   printed first (phase 12's train step turned expandable segments on),
   then a one-rank NCCL ``DeviceMesh`` (1, 1) over ``("data", "model")``
   (as phase 10's, destroyed at the end), serving before training.
   (a) gemma3-4b, published config, phase 3's seeded weights and prompts
   (its unsharded tokens equal phase 3's): prefill (4, 3072), one eager
   step and the 32 captured steps unsharded and on the mesh (caches placed
   by ``cache_shardings``, DTensors), tokens, logits and caches bit for
   bit, kernel #4 counted on the mesh run (5 + 5 the eager step, 10 + 10
   the capture), step ms beside the unsharded; (b) the split pruned decode
   (``layers/attention.split_pruned_decode``, each rank a thread of this
   process, its two collectives a ``ThreadLoopback``) at gemma3-4b's global-layer shape in float32
   at 2 and 4 shards of positions, with and without ``hier_topk``, at K
   2048 (where a shard holds fewer than K positions, so the merge falls
   back to the gathered logits) and K 512 (the merge runs): the kept
   positions equal unsplit kernel #4 K1's (the K-th / (K+1)-th logit gap
   printed where not), the output within 1e-5 of the unsplit pair, kernel
   #3's launches (n, or 2n with the merge) and K2's (n) counted on one run,
   device ms; (b') ``attention_decode`` itself on 2 and 4 ranks, each a
   thread of this process (``ThreadLoopback``), at gemma3-4b's global
   (pruned at K 512 with and without ``hier_topk``, and dense) and local
   layer shapes in float32: every rank's output within 1e-5 of the unsplit
   decode, the owner-gated write bit for bit; (c) qwen2-1.5b whole at (8,
   4096), fsdp placements, 3 sharded steps against 3 unsharded ones in the
   same process: losses and parameters bit for bit; (d) the unsharded step-3 checkpoint restored
   onto the mesh (``Trainer.restore_for_mesh``), every leaf bit for bit,
   and one more step equal to the unsharded step 4 bit for bit; a ``mesh
   {...}`` line;
14. prints a ``train {...}`` line with the step times, a ``serve {...}``
   line with the serving numbers (serial and microbatched wall time, QPS,
   p50/p99, mean batch, pad fraction and blocks; the threaded p50/p99; the
   busy share; the overlap counts), an ``ego {...}`` line with phase 8's
   numbers, a ``stream {...}`` line with phase 9's (merge and cold
   rebuild times and their ratio, per-ingest session times, bytes
   uploaded and tiers, the threaded QPS during the ingests, memory), a
   ``shard {...}`` line with phase 10's, an ``archs {...}`` line with phase
   11's, an ``lm_train {...}`` line with phase 12's, the ``mesh {...}``
   line, the card line, then the
   ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` as
   the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# phase 8, ego subgraphs: the reference's serve_ego.py setting (IMDB,
# max_degree 64, sample_sizes (1, 4), queries of 1 and 4 targets from seed
# 1) at scale 1.0, 32 queries, K 8, the registered depths; the scaling run
# grows HAN's graph from scale 1 to 4
EGO_MODELS = (("han", 1), ("rgat", 3), ("simple_hgn", 2))
EGO_QUERIES, EGO_SIZES, EGO_REPEATS, EGO_SCALES = 32, (1, 4), 20, (1.0, 4.0)
# phase 9, streamed graph deltas: the reference's benchmarks/graph_deltas.py
# full run (RGAT DBLP, scale 1.0, max_degree None, 8 batches of 48 random
# edges alternating AP / PV, merge <= 0.2x the cold rebuild), served by the
# captured fused_kernel K = 8 session instead of the reference's fused flow
STREAM_BATCHES, STREAM_EDGES, STREAM_RELS, STREAM_RATIO_CEILING = 8, 48, ("AP", "PV"), 0.2
STREAM_SPIN_CYCLES = 200_000_000  # ~0.1 s of one SM spinning ahead of a replay
STREAM_WORKLOAD = 40_000  # paced requests offered at most (20 s at 2000/s); cut at the last ingest
# phase 10, sharded grouped NA: every shard of 2-, 4- and 8-way splits on
# the card (shard_out), the served paths under a one-rank NCCL device mesh,
# two of phase 9's deltas on a shards=2 task, and a training step captured
# while a threaded front-end serves another tenant
SHARD_WAYS = (2, 4, 8)
SHARD_PATHS = (("han", "dblp"), ("han", "acm"), ("rgat", "acm"), ("rgat", "imdb"), ("simple_hgn", "acm"),
               ("simple_hgn", "imdb"))
SHARD_MESH_PATHS = (("han", "acm"), ("rgat", "imdb"), ("simple_hgn", "imdb"))
SHARD_DELTAS, SHARD_TIMED = 2, 50
SHARD_TRAIN_LR = 1e-3  # a step of its own: phase 5 cached the ones at TRAIN_LR
SHARD_SERVE_REQUESTS = 20_000  # paced requests offered at most (10 s at 2000/s); cut once the steps ran
# phase 11, the dense, MoE, recurrent and cross-attention LM archs: (arch, layers kept or None
# for the published depth, decode steps); the two cut to fit one card's 80 GB
ARCH_RUNS = (("qwen2-1.5b", None, 32), ("chatglm3-6b", None, 32), ("olmoe-1b-7b", None, 32),
             ("qwen2-72b", 8, 8), ("arctic-480b", 1, 8), ("recurrentgemma-2b", None, 32), ("rwkv6-3b", None, 32),
             ("llama-3.2-vision-90b", 10, 8), ("seamless-m4t-medium", None, 32))
ARCH_CPU_CHECK = ("qwen2-1.5b", "chatglm3-6b", "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-3b",
                  "llama-3.2-vision-90b", "seamless-m4t-medium")
# the cross-attention archs also run with ADE on (attn_prune_k, the knob the
# launcher's --prune-k sets): the pruned cross-attention and self-attention
# decode through kernel #4. K is a quarter of each context, a choice: neither
# published config, nor anything else here, gives a K for these archs
ARCH_PRUNE_K = {"llama-3.2-vision-90b": 1024, "seamless-m4t-medium": 256}
# kernel #4 at the shapes their pruned cross-attention gives it in phase 11:
# (name, B, H, Hkv, dh, context rows, K); phase 2 holds it to its plain
# version there, and on integer q and keys at llama's grouping (tie-heavy)
CROSS_DECODE_SHAPES = (("llama-3.2-vision-90b C layer", 4, 64, 8, 128, 4096, 1024),
                       ("seamless-m4t-medium D cross", 4, 16, 16, 64, 1024, 256))
CROSS_TIE_CASE = "integer q and keys at llama's C layer shape"
# a prefill's profile costs 10-20 s of host time (tens of thousands of
# events); two archs show its two regimes: chatglm3-6b's 28 global layers
# (the plain-torch attention's elementwise passes) and qwen2-72b's wide GEMMs
ARCH_PREFILL_PROFILE = ("chatglm3-6b", "qwen2-72b")
ARCH_EAGER_OPS = 8  # an eager step's largest operators by device time, with their input shapes
# card vs CPU: 2 layers, float32, batch 2 of 300 tokens (600 routed rows: a
# group of 512 and a padded one for olmoe), 2 decode steps; errors relative
# to the CPU's largest |logit|; routing flips allowed on at most 1 % of the
# routed tokens, each with a top-k margin of at most 1e-5; recurrentgemma-2b
# on 3 layers, so that its first local-attention layer is in (R R L)
ARCH_CPU_LAYERS, ARCH_CPU_BATCH, ARCH_CPU_PROMPT, ARCH_CPU_STEPS = 2, 2, 300, 2
ARCH_CPU_LAYERS_OF = {"recurrentgemma-2b": 3}
# the cross-attention archs' cut keeps a layer of each kind at full width:
# llama's 2 layers are one A and one C (its first two of A A A A C are both
# A), seamless's 2 decoder layers run over 2 encoder layers
ARCH_CPU_CUT = {"llama-3.2-vision-90b": {"cycle": ("A", "C")}, "seamless-m4t-medium": {"enc_layers": 2}}
TOL_ARCH_REL, ARCH_FLIP_SHARE, ARCH_FLIP_MARGIN = 1e-4, 0.01, 1e-5
# the MoE archs' routing spread, seeded against unit-scale weights: per layer
# of a 2-layer float32 prefill of batch 2 of 512 tokens (two whole groups of
# 512, no pad rows); the second half of each sequence is the "late" tokens
ARCH_SPREAD_BATCH, ARCH_SPREAD_PROMPT = 2, 512
ARCH_ROUTER_SPREAD = 2.4  # the std of a unit-scale router's logits on a normed input
# phase 12, LM training (no kernel of the port is on its path): the flash
# backward against autograd through a dense attention in float32 at three
# archs' full-width shapes (name, B, S, Skv, H, Hkv, hd, causal, window),
# each gradient within 1e-4 of its largest magnitude
FLASH_BWD_CASES = (("qwen2-1.5b global", 1, 4096, 4096, 12, 2, 128, True, None),
                   ("recurrentgemma-2b local", 1, 4096, 4096, 10, 1, 256, True, 2048),
                   ("seamless-m4t-medium cross", 1, 4096, 1024, 16, 16, 64, False, None))
TOL_FLASH_BWD = 1e-4
# eager training steps at full width: train_4k's sequence (4096), its global
# batch cut from 256 to 8; (arch, layers kept or None for the published
# depth); recurrentgemma-2b whole needs ~104 GB (AdamW's update holds 9
# float32 copies of its 2.89 B parameters; PERF.md §6), so 12 of 26
# layers (R R L four times); arctic-480b does not fit at any depth (1 of 35
# layers is 14.1 B bf16 parameters, the float32 gradient accumulator alone
# 56 GB more) and is not run
TRAIN_LM_SEQ, TRAIN_LM_BATCH, TRAIN_LM_STEPS = 4096, 8, 6
TRAIN_LM_RUNS = (("qwen2-1.5b", None), ("seamless-m4t-medium", None), ("recurrentgemma-2b", 12))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate, published
# card vs CPU: qwen2-1.5b at 2 layers, full width, float32, (2, 256) tokens:
# the loss (relative), each gradient (of its leaf's largest magnitude) and,
# from the same gradients, each optimizer's new parameters (relative to the
# leaf's largest magnitude)
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 2, 256
TOL_TRAIN_CPU_LOSS, TOL_TRAIN_CPU_GRAD, TOL_TRAIN_CPU_UPDATE = 1e-5, 1e-4, 1e-6
# resume on the card: qwen2-1.5b at 2 layers, (4, 1024) a step, 6 steps
# uninterrupted against 3, an asynchronous save, and 3 resumed
RESUME_STEPS, RESUME_SPLIT, RESUME_SEQ, RESUME_BATCH = 6, 3, 1024, 4
# phase 13, the LM on a device mesh: a one-rank NCCL mesh (1, 1) over
# ("data", "model"). (b) the split pruned decode at gemma3-4b's global layer
# (q (4, 8, 256), cache (4, 3104, 4, 256) in float32 as in phase 2, 3073
# valid positions a row) cut into 2 and 4 blocks of positions, with and
# without hier_topk: at the config's K 2048 a block holds fewer than K
# positions, so hier_topk falls back to the gathered logits as the
# reference's _hier_topk falls back; at K 512 the hierarchical merge runs.
# (b') attention_decode itself (the owner-gated write, the dense
# flash-decode merge, the pruned split) at gemma3-4b's global and local
# layer shapes in float32, each of 2 and 4 ranks a thread of this process
# (layers/attention.ThreadLoopback), against the unsplit decode.
# (c) qwen2-1.5b whole at phase 12's (8, 4096), fsdp placements, 3 steps;
# (d) its unsharded step-3 checkpoint restored onto the mesh, then step 4
MESH_SPLITS, MESH_SPLIT_KS, MESH_SPLIT_LENGTH = (2, 4), (2048, 512), 3073
TOL_MESH_SPLIT = 1e-5
# (kind, attn_prune_k, hier_topk) of (b'): pruned at K 512 (the merge runs
# at 2 and 4 ranks), dense global, the local ring (1024 positions)
MESH_SPLIT_LAYERS = (("A", 512, False), ("A", 512, True), ("A", None, False), ("L", None, False))
MESH_TRAIN_ARCH, MESH_TRAIN_STEPS = "qwen2-1.5b", 3


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
    getattr(ops, "LAUNCHES_BY_WIDTH", {}).clear()


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


def op_device_times(fn, top: int) -> list:
    """Device time of one call of ``fn`` (after a warm-up call) by the
    PyTorch operator that launched each kernel and the operator's input
    shapes (torch.profiler with ``record_shapes``), which name the call
    site: the ``top`` largest as ``[operator, input shapes, ms]``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages(group_by_input_shape=True):
        if ev.device_type != DeviceType.CPU:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append([ev.key, str(ev.input_shapes), us / 1e3])
    return sorted(rows, key=lambda row: -row[2])[:top]


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
    # the cross-attention archs' pruned cross-attention: every context row valid
    for name, b, h, hkv, dh, c, k in CROSS_DECODE_SHAPES:
        cases.append((f"{name} bfloat16", b, h, hkv, dh, c, k, [c] * b, "bfloat16"))
    b, h, hkv, dh, c, k = CROSS_DECODE_SHAPES[0][1:]
    cases.append((f"{CROSS_TIE_CASE} (tie-heavy logits)", b, h, hkv, dh, c, k, [c] * b, "ints"))
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
    ties, per_case = {}, {}
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
        per_case[name] = {"alpha_err": e_a, "out_err": e_o, "tie_rows": n_tie, "rows": b * h}
        if name.startswith(CROSS_TIE_CASE):  # timed too: the tie path at llama's grouping
            t_tie, b_tie, _ = decode_pair_times((q, kc, vc, lens, k, scale), dev)
            per_case[name].update(times_ms=t_tie, bounds={key: {"bound_ms": v[0], "bound_by": v[1], "bytes": v[2]}
                                                          for key, v in b_tie.items()})
        print(f"  kernels == plain  decode {name}: ids equal, alpha err {e_a:.3g}, out err {e_o:.3g}{extra}; "
              f"K2 with empty slots equal, bitwise the same on a second call; tie-path rows {n_tie} of {b * h}")
    return err, ties, per_case


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
        "tokens": [t[:, 0].tolist() for t in tokens],
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


def decode_pair_times(decode_in, dev):
    """The decode pair at ``decode_in`` (q, k_cache, v_cache, lengths,
    prune_k, scale): K1's ids held to its plain version's, K1 and K2 timed
    (device and event ms), their plain versions and K2's library call (a
    CSR sparse-dense product), and the bounds from the bytes and operations
    these inputs need. Returns (times, bounds, shapes)."""
    import torch

    from repro_torch.kernels.topk_decode_attention import ops, ref

    q, kc, vc, lens, prune_k, scale = decode_in
    k = min(prune_k, kc.shape[1])
    t = {}
    with torch.inference_mode():
        alpha, ids = ops.score_prune(q, kc, lens, k, scale)
        out = ops.value_gather(alpha, ids, vc)
        a_p, i_p = ref.score_prune_plain(q, kc, lens, k, scale)
        check(torch.equal(ids, i_p), f"decode K1 at {list(q.shape)} / {list(kc.shape)}: ids differ from the plain "
                                     f"version's in {int((ids != i_p).sum())} slots")
        t["alpha_err"] = float((alpha - a_p).abs().max())
        t["out_err"] = float((out - ref.value_gather_plain(a_p, i_p, vc)).abs().max())
        check(t["alpha_err"] <= TOL_ALPHA and t["out_err"] <= TOL_OUT,
              f"decode pair at {list(kc.shape)}: alpha err {t['alpha_err']:.3g}, out err {t['out_err']:.3g}")
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
    bounds = {"score_prune": bound(k1_bytes, k1_ops), "value_gather": bound(k2_bytes, k2_ops)}
    shapes = {"q": list(q.shape), "cache": list(kc.shape), "dtype": str(kc.dtype), "k": k,
              "lengths": lens.tolist(), "retained_slots": retained, "distinct_retained_rows": distinct}
    return t, bounds, shapes


def decode_timings(lm, prompts, cache0, tok0, decode_in, dev):
    """Phase 4, the decode pair at ``decode_in`` (the inputs of the last
    global layer in the first decode step, bfloat16 cache), its bounds from
    this run's inputs, the LM's prefill and decode-step times, and the
    decode pair's share of a decode step's device time."""
    import torch

    from repro_torch.layers.attention import KVCache

    t, bounds, pair_shapes = decode_pair_times(decode_in, dev)
    with torch.inference_mode():
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
    shapes = {"inputs": f"{LM_ARCH} decode step 1, last global layer", **pair_shapes}
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


def ego_queries(n: int, seed: int = 1) -> list:
    """The reference's ``serve_ego.py`` queries: sizes cycling 1, 4."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, size=min(EGO_SIZES[i % len(EGO_SIZES)], n)).astype(np.int32)
            for i in range(EGO_QUERIES)]


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def pool_bytes(graphs):
    """Bytes the caching allocator holds in the private memory pools of
    the captured ``graphs`` (its segment snapshot, by pool id); ``None``
    where the snapshot names no pool."""
    import torch

    pools = {tuple(g.pool()) for g in graphs}
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) in pools)


def ego_times(sess, params, queries, dev) -> dict:
    """Per query, medians over ``EGO_REPEATS`` passes: the wall time of a
    synchronized ``query_ego`` and ``query``, the host's extraction alone,
    the device time of the query's ego graph replay and of the full
    forward's (CUDA events around ``replay()``), and rows and bytes read a
    query (the planner's stats over one pass)."""
    import torch

    planner, gl = sess.ego_planner, sess._ego_globals_for(params)
    wall = {"ego": [], "query": [], "extract": []}
    for _ in range(EGO_REPEATS):
        for idx in queries:
            for name, fn in (("ego", lambda: sess.query_ego(params, idx)), ("query", lambda: sess.query(params, idx)),
                             ("extract", lambda: planner.extract(idx, ego_globals=gl))):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                wall[name].append((time.perf_counter() - t0) * 1e3)

    def replay_ms(graph):
        return event_median_ms(graph.replay, EGO_REPEATS)

    by_sig = {sig: replay_ms(exe._graph) for sig, exe in sess._ego_exes.items()}
    planner.stats.reset()
    ego_replay = []
    for idx in queries:
        eb = planner.extract(idx, ego_globals=gl)
        if eb is not None:
            ego_replay.append(by_sig[eb.sig])
    st = planner.stats
    served = max(st.queries - st.fallbacks, 1)
    return {"query_ego_ms": median(wall["ego"]), "query_ms": median(wall["query"]),
            "extract_ms": median(wall["extract"]), "ego_replay_device_ms": median(ego_replay),
            "ego_replay_device_ms_max": max(ego_replay), "full_replay_device_ms": replay_ms(sess._graph),
            "rows_per_query": st.rows_per_query, "bytes_per_query": st.bytes_read / served,
            "fallbacks": st.fallbacks, "repeats": EGO_REPEATS, "queries": len(queries)}


def ego_phase(pipeline, FlowConfig, kernel_ops, dev):
    """Phase 8: ego-subgraph serving on the captured ``fused_kernel``
    sessions of HAN, RGAT and Simple-HGN on IMDB (module docstring). Every
    check raises; returns the results, with each model's first-pass
    launches under ``launches``."""
    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.core import flows
    from repro_torch.core.ego import EgoPlanner
    from repro_torch.core.session import InferenceSession

    ops = kernel_ops[0]
    flow = FlowConfig("fused_kernel", prune_k=PRUNE_K)
    res = {}

    def counters():
        return [dict(m.LAUNCHES) for m in kernel_ops], dict(flows.DISPATCH)

    def zero_launches():
        for m in kernel_ops:
            reset_launches(m)

    for model, depth in EGO_MODELS:
        key = f"{model}/imdb"
        task = pipeline.prepare(model, "imdb", scale=SCALE, max_degree=SERVE_MAX_DEGREE, seed=0, device=dev)
        check(task.model.num_layers == depth, f"ego {key}: depth {task.model.num_layers}, expected {depth}")
        want_full = expected_launches(task.sgs, "bucketed", PRUNE_K, depth, ops)
        sess, logits, _ = captured_session(task, flow, want_full, f"ego {key}", ops, dev)
        full = logits.cpu().numpy()
        n = task.batch.num_targets
        queries = ego_queries(n)

        # first pass: one capture per new signature
        zero_launches()
        before = dict(flows.DISPATCH)
        sess.enable_ego(seed=0, sample_sizes=EGO_SIZES)
        first = [sess.query_ego(task.params, idx) for idx in queries]
        sync(dev)
        launched, after = counters()
        sigs = list(sess._ego_exes)
        wide = sum(s.d_cap > PRUNE_K for sig in sigs for s in sig.sgs)
        want = {k: 0 for k in ops.LAUNCHES}
        want["flat_prune_aggregate"] = 2 * depth * wide
        want["prune_aggregate"] = want_full["prune_aggregate"] if model == "han" else 0
        check(launched[0] == want and not any(v for m in launched[1:] for v in m.values()),
              f"ego {key}: the first pass launched {launched}, expected {want}")
        moved = {k: after[k] - before[k] for k in after}
        check(moved["ego_traces"] == len(sigs) > 0, f"ego {key}: {moved['ego_traces']} programs for {len(sigs)} signatures")
        check(all(isinstance(exe._graph, torch.cuda.CUDAGraph) for exe in sess._ego_exes.values()),
              f"ego {key}: an ego program is not a captured graph")

        # second pass: replays only
        zero_launches()
        before = dict(flows.DISPATCH)
        second = [sess.query_ego(task.params, idx) for idx in queries]
        sync(dev)
        launched, after = counters()
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        check(all(v == 0 for m in launched for v in m.values()), f"ego {key}: the replays launched {launched}")
        check(set(moved) <= {"ego_calls", "ego_bypass", "ego_fallback", "query_calls"},
              f"ego {key}: the replays entered NA dispatch or built a program: {moved}")
        calls, fallback = moved.get("ego_calls", 0), moved.get("ego_fallback", 0)
        check(calls + fallback == len(queries) and moved.get("query_calls", 0) == fallback,
              f"ego {key}: {calls} ego calls and {fallback} fallbacks for {len(queries)} queries")
        err_full, err_cpu = 0.0, 0.0
        gl = sess._ego_globals_for(task.params)
        cpu_params = {k: v.cpu() for k, v in task.params.items()}
        for idx, a, b in zip(queries, first, second):
            rows = b.cpu()
            check(torch.equal(a.cpu(), rows), f"ego {key}: a replay differs from the first pass")
            err_full = max(err_full, float(np.abs(rows.numpy() - full[idx]).max()))
            eb = sess.ego_planner.extract(idx, ego_globals=gl)
            if eb is None:
                continue
            with torch.inference_mode():
                on_card = eb.to(dev)
                eager = task.model.apply(task.params, on_card, flow).index_select(0, on_card.out_rows).cpu()
                on_cpu = eb.to("cpu")
                cpu = task.model.apply(cpu_params, on_cpu, flow).index_select(0, on_cpu.out_rows)
            check(same_bits([rows], [eager]), f"ego {key}: a replay differs from the eager ego forward on the card")
            err_cpu = max(err_cpu, float((eager - cpu).abs().max()))
        check(err_full <= TOL_OUT, f"ego {key}: ego rows differ from the full forward by {err_full:.3g}")
        check(err_cpu <= TOL_LOGITS, f"ego {key}: the card's ego forward differs from the CPU's by {err_cpu:.3g}")
        r = {"signatures": len(sigs), "captured_graphs": len(sess._ego_exes),
             "max_d_cap": sorted({sig.max_d_cap for sig in sigs}), "wide_tables": wide,
             "ego_calls": calls, "ego_bypass": moved.get("ego_bypass", 0), "ego_fallback": fallback,
             "max_abs_err_vs_full": err_full, "max_abs_err_card_vs_cpu": err_cpu,
             "pool_reserved_bytes": pool_bytes([exe._graph for exe in sess._ego_exes.values()]),
             "full_forward_pool_bytes": pool_bytes([sess._graph]), "launches": dict(want)}

        # overflow: capacities (1,) send a block of 3 to the full forward
        planner = sess.ego_planner
        sess.enable_ego(planner=EgoPlanner(task.batch, depth=depth, capacities={t: (1,) for t in task.batch.node_types}))
        before = dict(flows.DISPATCH)
        idx = np.array([2, 7, 11], dtype=np.int32)
        got = sess.query_ego(task.params, idx)
        check(flows.DISPATCH["ego_fallback"] - before["ego_fallback"] == 1
              and flows.DISPATCH["ego_calls"] == before["ego_calls"], f"ego {key}: the overflow was not a fallback")
        check(same_bits([got], [sess.query(task.params, idx)]), f"ego {key}: the fallback differs from query")
        sess.enable_ego(planner=planner)

        # bad ids raise before any launch or extraction; then a good query
        zero_launches()
        before, queried = dict(flows.DISPATCH), planner.stats.queries
        for bad in ([-1], [n]):
            try:
                sess.query_ego(task.params, bad)
            except IndexError:
                continue
            raise AssertionError(f"ego {key}: query_ego({bad}) did not raise IndexError")
        sync(dev)
        launched, after = counters()
        check(after == before and planner.stats.queries == queried and not any(v for m in launched for v in m.values()),
              f"ego {key}: a bad id reached the extraction or the card")
        good = sess.query_ego(task.params, [n - 1, 0]).cpu().numpy()
        check(float(np.abs(good - full[[n - 1, 0]]).max()) <= TOL_OUT, f"ego {key}: the query after bad ids differs")

        r["times"] = ego_times(sess, task.params, queries, dev)
        res[key] = r
        print(f"  ego {key}: {len(sigs)} signatures captured (max_d_cap {r['max_d_cap']}, {wide} tables wider than "
              f"K), launches {dict((k, v) for k, v in want.items() if v)}; replays bitwise the eager ego forward, "
              f"{err_full:.3g} from the full forward, card vs CPU {err_cpu:.3g}; {calls} ego calls "
              f"({r['ego_bypass']} bypass), {fallback} fallbacks; " + json.dumps(r["times"]))

        if model == "rgat":
            # the front-end with ego routing on a session of its own (its
            # planner tuned on the policy's ladder), phase 7's workload
            fsess = InferenceSession(task.model, task.batch, flow, params=task.params)
            policy = serve.BatchPolicy(SERVE_CAPACITIES, flush_timeout=SERVE_FLUSH, ego=True)
            wl = serve.make_workload(SERVE_REQUESTS, n, rate=None, size_range=(1, 4), seed=0)
            fe = serve.ServeFrontend(fsess, task.params, policy=policy, clock=serve.FakeClock(),
                                     executor=serve.InlineExecutor())
            check(fsess.ego_planner is not None, "ego front-end: ego not enabled on the primary")
            serve.run_workload(fe, wl)  # warm-up: the captures
            sync(dev)
            zero_launches()
            before = dict(flows.DISPATCH)
            blocks0 = fe.stats.blocks
            t0 = time.perf_counter()
            futs = serve.run_workload(fe, wl)
            wall_s = time.perf_counter() - t0
            launched, after = counters()
            moved = {k: after[k] - before[k] for k in after}
            blocks = fe.stats.blocks - blocks0
            err = max(float(np.abs(f.result(0) - full[w.targets]).max()) for w, f in zip(wl, futs))
            check(err <= TOL_OUT, f"ego front-end: rows differ from the full forward by {err:.3g}")
            check(moved["query_calls"] == moved["ego_fallback"] and moved["ego_calls"] + moved["ego_fallback"] == blocks,
                  f"ego front-end: {moved} for {blocks} blocks")
            check(moved["ego_traces"] == 0 and not any(v for m in launched for v in m.values()),
                  f"ego front-end: the served window launched {launched} or built {moved['ego_traces']} programs")
            res["frontend"] = {"requests": len(wl), "blocks": blocks, "ego_calls": moved["ego_calls"],
                               "ego_fallback": moved["ego_fallback"], "max_abs_err_vs_full": err,
                               "wall_ms": wall_s * 1e3, "captured_graphs": len(fsess._ego_exes),
                               "capacities": {t: list(c) for t, c in fsess.ego_planner.capacities.items()}}
            print("  ego front-end rgat/imdb: " + json.dumps(res["frontend"]))

    # scaling: HAN's rows a query against the graph's size
    scaling = {}
    for scale in EGO_SCALES:
        task = pipeline.prepare("han", "imdb", scale=scale, max_degree=SERVE_MAX_DEGREE, seed=0, device=dev)
        sess = task.compile(flow).enable_ego(seed=0, sample_sizes=EGO_SIZES)
        queries = ego_queries(task.batch.num_targets)
        for idx in queries:  # warm: the captures
            sess.query_ego(task.params, idx)
        scaling[scale] = dict(ego_times(sess, task.params, queries, dev), graph_nodes=task.batch.total_nodes,
                              signatures=len(sess._ego_exes))
    lo, hi = (scaling[s] for s in EGO_SCALES)
    growth = {"graph": hi["graph_nodes"] / lo["graph_nodes"], "rows": hi["rows_per_query"] / lo["rows_per_query"],
              "query_ego_ms": hi["query_ego_ms"] / lo["query_ego_ms"], "query_ms": hi["query_ms"] / lo["query_ms"],
              "ego_replay_device_ms": hi["ego_replay_device_ms"] / lo["ego_replay_device_ms"],
              "full_replay_device_ms": hi["full_replay_device_ms"] / lo["full_replay_device_ms"]}
    check(growth["graph"] >= 2.0 and growth["rows"] <= 0.5 * growth["graph"],
          f"ego scaling: rows a query grew {growth['rows']:.2f}x against the graph's {growth['graph']:.2f}x")
    res["scaling"] = {"han/imdb": {str(s): v for s, v in scaling.items()}, "growth": growth}
    print("  ego scaling han/imdb: " + json.dumps(res["scaling"]))
    return res


def stream_host_arrays(sgs, ops) -> dict:
    """Every host array of a bucketed stack, by name: the bucket tables,
    ``perm``, the row lookup and the grouped layout the kernel walks."""
    out = {}
    for sg in sgs:
        for i, b in enumerate(sg.buckets):
            for f in ("targets", "nbr_idx", "nbr_mask", "edge_type"):
                out[sg.name, i, f] = getattr(b, f)
        out[sg.name, "perm"] = sg.target_perm()
        out[sg.name, "bucket_of"], out[sg.name, "row_of"] = sg.row_lookup()
        lay = sg.grouped(ops.T_TILE, ops.W_TILE)
        for f in ("nbr", "msk", "ety", "step_row", "step_dt", "step_ndt", "step_bucket", "caps", "caps_pad",
                  "row_targets", "perm"):
            out[sg.name, "grouped", f] = getattr(lay, f)
    return out


def same_arrays(a: dict, b: dict) -> bool:
    import numpy as np

    return list(a) == list(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def zero_tables(sgs) -> int:
    """Zero every device table cached on ``sgs``; returns the bytes."""
    from repro_torch.core.session import sg_tensors

    n = 0
    for sg in sgs:
        for t in sg_tensors(sg):
            t.zero_()
            n += t.nbytes
    return n


def cold_rebuild_s(hetgraph, graph, sgs, sgb_args) -> float:
    """The reference's ``_cold_rebuild_time``: the relation builders on
    ``graph`` plus the grouped layouts ``sgs`` carry, host wall time."""
    t0 = time.perf_counter()
    built = hetgraph.build_relation_graphs(graph, max_degree=sgb_args["max_degree"], seed=sgb_args["seed"],
                                           bucket_sizes=sgb_args["bucket_sizes"])
    for old, new in zip(sgs, built):
        for key in old._grouped:
            new.grouped(*key)
    return time.perf_counter() - t0


def retire_in_flight(task, flow, dev) -> bool:
    """A session dropped while its replay still waits on another stream
    behind a spin: the memory that replay reads outside its pool (here the
    batch's feature tensors, allocated on this stream) must not be handed
    to new tensors first. Drops the session, fills same-sized new tensors
    with NaN, then waits: True when the replay's rows are still the
    session's."""
    import torch

    from repro_torch.core.batch import GraphBatch
    from repro_torch.core.session import InferenceSession

    batch = GraphBatch.from_graph(task.graph, task.sgs, dev)
    sess = InferenceSession(task.model, batch, flow, params=task.params)
    want = sess(task.params)
    shapes = [(f.shape, f.dtype) for f in batch.features.values()]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        torch.cuda._sleep(STREAM_SPIN_CYCLES)
        got = sess(task.params)
    del sess, batch
    junk = [torch.full(shape, float("nan"), dtype=dtype, device=dev) for shape, dtype in shapes]
    side.synchronize()
    del junk
    return same_bits([got], [want])


def stream_phase(pipeline, FlowConfig, kernel_ops, card, dev):
    """Phase 9: streamed graph deltas (``repro_torch.stream``) in the
    setting of the reference's ``benchmarks/graph_deltas.py`` full run
    (module docstring). Every check raises; returns the results."""
    import gc
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.core import flows, hetgraph
    from repro_torch.core.session import InferenceSession, sg_tensors
    from repro_torch.stream import StreamIngestor
    from repro_torch.stream.merge import _degrees_of

    ops = kernel_ops[0]
    flow = FlowConfig("fused_kernel", prune_k=PRUNE_K)
    res = {}

    def zero_launches():
        for m in kernel_ops:
            reset_launches(m)

    def launched():
        return [dict(m.LAUNCHES) for m in kernel_ops]

    def delta_of(rng, g, i):
        """The reference's batch ``i``: random edges into one of AP, PV."""
        rels = [r for r in g.relations if r[1] in STREAM_RELS]
        s_t, name, d_t = rels[i % len(rels)]
        return {name: (rng.integers(0, g.num_nodes[s_t], STREAM_EDGES), rng.integers(0, g.num_nodes[d_t], STREAM_EDGES))}

    def ptrs(sg):
        return {t.data_ptr() for t in sg_tensors(sg)}

    def ingest_checked(ing, task, edges, model):
        """One ingest and the per-version gates that need the predecessor:
        launches 2 x a forward's (warm-up and capture), none in a replay;
        clean slices' device tables and the features the predecessor's,
        dirty slices' their own; the predecessor's dirty tables zeroed,
        the successor's replay unchanged. Returns the report, the
        successor's logits, the dirty slices and a row for the print."""
        old, old_sgs = ing.session, {sg.name: sg for sg in ing.sgs}
        old_feats = old.graph_batch.features
        zero_launches()
        rep = ing.ingest(edges)
        sync(dev)
        got = launched()
        sess = ing.session
        want = expected_launches(ing.sgs, "bucketed", PRUNE_K, task.model.num_layers, ops)
        check(got[0] == {k: 2 * v for k, v in want.items()} and not any(v for m in got[1:] for v in m.values()),
              f"stream {model} v{rep.version}: the ingest launched {got}, expected twice {want}")
        check(sess.captured and sess is ing.plane.current() and rep.version == ing.version,
              f"stream {model} v{rep.version}: the successor is not a published captured session")
        zero_launches()
        before = dict(flows.DISPATCH)
        logits = sess(task.params)
        sync(dev)
        check(not any(v for m in launched() for v in m.values()) and flows.DISPATCH == before,
              f"stream {model} v{rep.version}: a replay launched or dispatched")
        dirty = [sg for sg in ing.sgs if sg is not old_sgs[sg.name]]
        for sg in ing.sgs:
            mine, theirs = ptrs(sg), ptrs(old_sgs[sg.name])
            check(mine and (mine == theirs if sg is old_sgs[sg.name] else not mine & theirs),
                  f"stream {model} v{rep.version} {sg.name}: device tables shared wrongly")
        feats = sess.graph_batch.features
        check(all(feats[t] is old_feats[t] for t in feats), f"stream {model} v{rep.version}: a feature tensor moved")
        uploaded = sum(t.nbytes for sg in dirty for t in sg_tensors(sg))
        zeroed = zero_tables([old_sgs[sg.name] for sg in dirty])
        check(same_bits([sess(task.params)], [logits]),
              f"stream {model} v{rep.version}: zeroing the predecessor's tables changed the successor's replay")
        row = {"version": rep.version, "tiers": rep.stats.summary(), "dirty_slices": [sg.name for sg in dirty],
               "t_merge_ms": rep.t_merge * 1e3, "t_batch_ms": rep.t_batch * 1e3,
               "t_session_ms": rep.t_session * 1e3, "t_publish_ms": rep.t_publish * 1e3,
               "bytes_uploaded": uploaded, "predecessor_bytes_zeroed": zeroed,
               "launches": got[0]["prune_aggregate"], "closures_carried": rep.closures_carried,
               "exes_adopted": rep.exes_adopted}
        return rep, logits, dirty, row

    def cold_checks(ing, task, logits, dirty, model, key):
        """The version against a cold ``prepare`` of its graph on the card:
        host tables array for array, the captured logits bit for bit, and
        each dirty slice's fused NA (kernel #1 on seeded inputs) bit for
        bit the cold slice's."""
        cold = pipeline.prepare(model, ing.graph, max_degree=None, seed=0, metapaths=task.metapaths, device=dev)
        check(same_arrays(stream_host_arrays(ing.sgs, ops), stream_host_arrays(cold.sgs, ops)),
              f"stream {key}: merged host tables differ from the cold build's")
        check(same_bits([logits], [cold.compile(flow)(task.params)]),
              f"stream {key}: the successor's logits differ from the cold capture's")
        cold_by = {sg.name: sg for sg in cold.sgs}
        gen = torch.Generator(device=dev).manual_seed(len(dirty))
        n = task.batch.total_nodes
        h = torch.randn((n, 2, 16), device=dev, generator=gen)
        ts = torch.randn((n, 2), device=dev, generator=gen)
        for sg in dirty:
            td = torch.randn((sg.num_targets, 2), device=dev, generator=gen)
            a = ops.fused_prune_aggregate_grouped(h, ts, td, sg, prune_k=PRUNE_K)
            b = ops.fused_prune_aggregate_grouped(h, ts, td, cold_by[sg.name], prune_k=PRUNE_K)
            check(same_bits([a], [b]), f"stream {key} {sg.name}: the slice's NA differs from the cold slice's")
        zero_launches()

    # -- pass A: the reference's run, inline front-end, every gate --------
    rng = np.random.default_rng(0)
    task = pipeline.prepare("rgat", "dblp", scale=SCALE, max_degree=None, seed=0, device=dev)
    want0 = expected_launches(task.sgs, "bucketed", PRUNE_K, task.model.num_layers, ops)
    base, base_logits, _ = captured_session(task, flow, want0, "stream rgat/dblp", ops, dev)
    base.enable_ego(seed=0, sample_sizes=EGO_SIZES)
    ing = StreamIngestor(task, base)
    fe = serve.ServeFrontend(ing.plane, task.params, policy=serve.BatchPolicy(capacities=(1, 4)),
                             clock=serve.FakeClock(), executor=serve.InlineExecutor())
    n_tgt = task.batch.num_targets
    versions = {0: base_logits.cpu().numpy()}
    graphs = {0: ing.graph}
    inline = [(fe.submit(q), q, 0) for q in (rng.integers(0, n_tgt, 2) for _ in range(2))]
    fe.pump(force=True)

    # ego continuity: one absorb-tier delta outside a warm closure
    qa = np.arange(min(4, n_tgt), dtype=np.int32)
    ego_before = base.query_ego(task.params, qa)
    full_a, _ = base.ego_planner._closure(qa.astype(np.int64))
    g = ing.graph
    s_t, rel, d_t = g.relations[0]
    sg0 = next(s for s in ing.sgs if s.name == rel)
    bucket_of, row_of = sg0.row_lookup()
    cand = np.setdiff1d(np.arange(g.num_nodes[d_t], dtype=np.int64), full_a.get(d_t, []))
    ok = cand[_degrees_of(sg0, cand, bucket_of, row_of) + 1 <= np.asarray(sg0.bucket_capacities)[bucket_of[cand]]]
    check(ok.size > 0, "stream: no absorbable target outside the warm closure")
    traces0 = flows.DISPATCH["ego_traces"]
    rep, logits, dirty, row = ingest_checked(
        ing, task, {rel: (rng.integers(0, g.num_nodes[s_t], 1), np.array([int(ok[0])], dtype=np.int64))}, "rgat")
    rows = [dict(row, delta="ego proof")]
    ego_after = ing.session.query_ego(task.params, qa)
    hits = ing.session.ego_planner.stats.closure_hits
    ego = {"absorbed": rep.stats.absorbed_slices, "full_rebuild": rep.stats.full_rebuild,
           "ego_traces_moved": flows.DISPATCH["ego_traces"] - traces0, "closures_carried": rep.closures_carried,
           "exes_adopted": rep.exes_adopted, "closure_hits": hits, "rows_bitwise": same_bits([ego_after], [ego_before])}
    check(ego["absorbed"] >= 1 and not ego["full_rebuild"] and ego["ego_traces_moved"] == 0
          and ego["closures_carried"] >= 1 and ego["exes_adopted"] >= 1 and hits >= 1 and ego["rows_bitwise"],
          f"stream: the ego continuity proof failed: {ego}")
    res["ego_rgat"] = ego
    cold_checks(ing, task, logits, dirty, "rgat", f"rgat/dblp v{rep.version}")
    versions[rep.version], graphs[rep.version] = logits.cpu().numpy(), ing.graph

    # the 8 batches, 2 requests an ingest through the inline front-end
    batches = []
    for i in range(STREAM_BATCHES):
        edges = delta_of(rng, ing.graph, i)
        batches.append(edges)
        rep, logits, dirty, row = ingest_checked(ing, task, edges, "rgat")
        rows.append(dict(row, delta=f"{list(edges)[0]} x {STREAM_EDGES}"))
        cold_checks(ing, task, logits, dirty, "rgat", f"rgat/dblp v{rep.version}")
        versions[rep.version], graphs[rep.version] = logits.cpu().numpy(), ing.graph
        zero_launches()
        inline += [(fe.submit(q), q, rep.version) for q in (rng.integers(0, n_tgt, 2) for _ in range(2))]
        fe.pump(force=True)
        check(not any(v for m in launched() for v in m.values()), "stream: the inline front-end launched")
    fe.close()
    st = fe.stats
    check(st.failed == 0 and st.shed == 0 and st.expired == 0 and st.completed == st.submitted == len(inline)
          and all(f.done() for f, _, _ in inline), f"stream: the inline front-end stranded or failed: {st.summary()}")
    check(all(np.array_equal(f.result(0), versions[v][q]) for f, q, v in inline),
          "stream: an inline row differs from its version's logits")
    for r in rows:
        print("  stream ingest " + json.dumps(r))

    # every version within 1e-5 of the CPU forward (plain versions), the
    # eight forwards side by side, one intra-op thread each
    cpu_params = {k: v.detach().cpu() for k, v in task.params.items()}

    def cpu_forward(v):
        cpu = pipeline.prepare("rgat", graphs[v], max_degree=None, seed=0, device="cpu")
        with torch.inference_mode():
            return v, float(np.abs(cpu.model.apply(cpu_params, cpu.batch, flow).numpy() - versions[v]).max())

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(8) as pool:
            cpu_err = dict(pool.map(cpu_forward, sorted(versions)))
    finally:
        torch.set_num_threads(threads)
    check(max(cpu_err.values()) <= TOL_OUT, f"stream: a version differs from its CPU forward: {cpu_err}")

    # merge cost against the cold rebuild (host)
    t_merge = [r["t_merge_ms"] for r in rows[1:]]
    cold_ms = sorted(cold_rebuild_s(hetgraph, ing.graph, ing.sgs, task.sgb_args) * 1e3 for _ in range(5))
    ratio = (sum(t_merge) / len(t_merge)) / cold_ms[2]
    res["pass_a"] = {"ingests": rows, "mean_merge_ms": sum(t_merge) / len(t_merge), "cold_rebuild_ms": cold_ms,
                     "merge_over_cold": ratio, "cpu_max_abs_err": max(cpu_err.values()),
                     "inline": {"requests": len(inline), "completed": st.completed, "failed": st.failed,
                                "shed": st.shed, "expired": st.expired},
                     "ingest_launches_prune_aggregate": sum(r["launches"] for r in rows),
                     "launches_per_forward": want0}
    print(f"  stream merge: mean {res['pass_a']['mean_merge_ms']:.3f} ms over {len(t_merge)} batches, cold rebuild "
          f"{cold_ms[2]:.3f} ms (median of 5: {[round(x, 3) for x in cold_ms]}), ratio {ratio:.4f} "
          f"(<= {STREAM_RATIO_CEILING}); every version 1e-5 of the CPU ({max(cpu_err.values()):.3g})")
    check(ratio <= STREAM_RATIO_CEILING, f"stream: the merge costs {ratio:.3f} of a cold rebuild")
    del ing, fe, base, inline
    gc.collect()

    # -- HAN DBLP: the adopted ego graph serves the successor's β ---------
    htask = pipeline.prepare("han", "dblp", scale=SCALE, max_degree=None, seed=0, device=dev)
    hwant = expected_launches(htask.sgs, "bucketed", PRUNE_K, htask.model.num_layers, ops)
    hs, _, _ = captured_session(htask, flow, hwant, "stream han/dblp", ops, dev)
    hs.enable_ego(seed=0, sample_sizes=EGO_SIZES)
    hing = StreamIngestor(htask, hs)
    before = hs.query_ego(htask.params, qa)
    beta0 = {k: v.clone() for k, v in hs._ego_globals_for(htask.params).items()}
    full_h, _ = hs.ego_planner._closure(qa.astype(np.int64))
    outside = np.setdiff1d(np.arange(htask.graph.num_nodes["author"]), full_h["author"])
    traces0 = flows.DISPATCH["ego_traces"]
    hrep, hlogits, hdirty, hrow = ingest_checked(
        hing, htask, {"AP": (outside[:1], rng.integers(0, htask.graph.num_nodes["paper"], 1))}, "han")
    check("APA" in [sg.name for sg in hdirty], f"stream han: the AP delta left APA clean ({hrep.stats.summary()})")
    got = hing.session.query_ego(htask.params, qa)
    beta1 = hing.session._ego_globals_for(htask.params)
    eb = hing.session.ego_planner.extract(qa, ego_globals=beta1)
    check(eb is not None, "stream han: the ego query fell back to the full forward")
    with torch.inference_mode():
        on_card = eb.to(dev)
        eager = htask.model.apply(htask.params, on_card, flow).index_select(0, on_card.out_rows)
        eb0 = hing.session.ego_planner.extract(qa, ego_globals=beta0)
        on_card0 = eb0.to(dev)
        eager0 = htask.model.apply(htask.params, on_card0, flow).index_select(0, on_card0.out_rows)
    full_err = float((got - hing.session(htask.params)[torch.as_tensor(qa, device=dev).long()]).abs().max())
    han = {"tiers": hrep.stats.summary(), "ego_traces_moved": flows.DISPATCH["ego_traces"] - traces0,
           "closures_carried": hrep.closures_carried, "exes_adopted": hrep.exes_adopted,
           "closure_hits": hing.session.ego_planner.stats.closure_hits, "max_abs_err_vs_full": full_err,
           "rows_bitwise_eager_with_successor_beta": same_bits([got], [eager]),
           "beta_changed": any(not torch.equal(beta0[k], beta1[k]) for k in beta0),
           "rows_bitwise_eager_with_predecessor_beta": same_bits([got], [eager0]),
           "rows_bitwise_before": same_bits([got], [before]), **{k: hrow[k] for k in ("t_session_ms", "bytes_uploaded")}}
    check(han["ego_traces_moved"] == 0 and han["exes_adopted"] >= 1 and full_err <= TOL_OUT
          and han["rows_bitwise_eager_with_successor_beta"], f"stream han: the ego proof failed: {han}")
    # the zeroing above can see a table: the successor's own APA mask, zeroed, moves its logits
    hwant_bits = hing.session(htask.params)
    apa = next(sg for sg in hing.sgs if sg.name == "APA")
    msk = next(v for k, v in next(iter(apa._grouped.values()))._dev.items() if k[0] == "base")[1]
    saved = msk.clone()
    msk.zero_()
    moved = not same_bits([hing.session(htask.params)], [hwant_bits])
    msk.copy_(saved)
    check(moved and same_bits([hing.session(htask.params)], [hwant_bits]),
          "stream han: zeroing the successor's own APA table did not move its logits, or restoring it did not")
    cold_checks(hing, htask, hlogits, hdirty, "han", f"han/dblp v{hrep.version}")
    han["own_table_zeroed_moves_logits"] = moved
    res["ego_han"] = han
    print("  stream ego proof rgat/dblp: " + json.dumps(res["ego_rgat"]))
    print("  stream ego proof han/dblp: " + json.dumps(han))
    del hing, hs, htask
    gc.collect()

    # -- pass B: a threaded front-end serving through 8 ingests -----------
    task = pipeline.prepare("rgat", "dblp", scale=SCALE, max_degree=None, seed=0, device=dev)
    check(retire_in_flight(task, flow, dev),
          "stream: a dropped session's replay read memory handed out again before it ran")

    class RecordingPlane(serve.GraphPlane):
        """The graph plane, keeping per thread the version of its last
        checkout (the front-end resolves one per block)."""

        def __init__(self, session):
            super().__init__(session)
            self.seen = threading.local()

        def current(self):
            self.seen.version, session = self.checkout()
            return session

    sess = InferenceSession(task.model, task.batch, flow, params=task.params)
    plane = RecordingPlane(sess)
    ing = StreamIngestor(task, sess, plane=plane)
    versions = {0: sess(task.params).cpu().numpy()}
    pool0 = pool_bytes([sess._graph])
    del sess
    sync(dev)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = {"reserved": torch.cuda.memory_reserved(dev), "allocated": torch.cuda.memory_allocated(dev)}
    fe = serve.ServeFrontend(plane, task.params, policy=serve.BatchPolicy(SERVE_CAPACITIES, flush_timeout=SERVE_FLUSH),
                             clock=serve.SystemClock(), executor=serve.ThreadExecutor())
    served_by = {}
    dispatch = fe._supervised_dispatch

    def recorded_dispatch(blk):
        out = dispatch(blk)
        for req, _ in blk.requests:
            served_by[req.future] = plane.seen.version
        return out

    fe._supervised_dispatch = recorded_dispatch
    wl = serve.make_workload(STREAM_WORKLOAD, n_tgt, rate=SERVE_RATE, size_range=(1, 4), seed=1)
    stop, offered, errors = threading.Event(), [], []

    def offer():
        try:
            t0 = time.perf_counter()
            for w in wl:
                if stop.is_set():
                    return
                dt = t0 + w.t_offset - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
                offered.append((fe.submit(w.targets), w.targets))
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    submitter = threading.Thread(target=offer, name="stream-offer")
    fe.start()
    t0 = time.perf_counter()
    submitter.start()
    time.sleep(0.05)
    trows = []
    for edges in batches:
        old_sgs = {sg.name: sg for sg in ing.sgs}
        rep = ing.ingest(edges)
        versions[rep.version] = ing.session(task.params).cpu().numpy()
        trows.append({"version": rep.version, "tiers": rep.stats.summary(), "t_merge_ms": rep.t_merge * 1e3,
                      "t_session_ms": rep.t_session * 1e3, "t_publish_ms": rep.t_publish * 1e3,
                      "bytes_uploaded": sum(t.nbytes for sg in ing.sgs if sg is not old_sgs[sg.name]
                                            for t in sg_tensors(sg))})
    time.sleep(0.05)
    stop.set()
    submitter.join(60)
    check(not submitter.is_alive() and not errors, f"stream: the offering thread failed: {errors}")
    fe.close()
    wall_s = time.perf_counter() - t0
    for th in fe.executor.threads:
        th.join(5.0)
    check(not any(th.is_alive() for th in fe.executor.threads), "stream: a loop thread outlived close")
    st = fe.stats
    check(st.failed == 0 and st.shed == 0 and st.expired == 0 and st.completed == st.submitted == len(offered)
          and all(f.done() for f, _ in offered), f"stream: the threaded front-end stranded or failed: {st.summary()}")
    check(all(np.array_equal(f.result(0), versions[served_by[f]][q]) for f, q in offered),
          "stream: a threaded row differs from the rows of the version that served it")
    by_version = {v: sum(1 for f, _ in offered if served_by[f] == v) for v in sorted(versions)}
    check(all(by_version.values()), f"stream: a version served no request: {by_version}")
    summ = st.summary()
    del fe, dispatch, recorded_dispatch, offered, served_by  # the front-end holds the base version
    sync(dev)
    gc.collect()
    reserved_cached = torch.cuda.memory_reserved(dev)
    torch.cuda.empty_cache()
    tables = sum(t.nbytes for t in ing.session._serial._held)
    mem = {"start": mem0, "after": {"reserved": torch.cuda.memory_reserved(dev),
                                    "allocated": torch.cuda.memory_allocated(dev)},
           "reserved_before_empty_cache": reserved_cached, "session_pool": pool_bytes([ing.session._graph]),
           "base_pool": pool0, "tables": tables}
    check(mem["session_pool"] is not None, "stream: the allocator's snapshot names no pool")
    bound = mem0["reserved"] + mem["session_pool"] + tables
    check(mem["after"]["reserved"] <= bound,
          f"stream: reserved memory after {len(batches)} ingests {mem['after']['reserved']} > {bound} (start + one "
          f"session's pool + one set of tables): a retired version kept its memory; {mem}")
    res["pass_b"] = {"ingests": trows, "requests": sum(by_version.values()),
                     "by_version": by_version, "wall_s": wall_s, "qps": summ["qps"], "p50_ms": summ["p50_ms"],
                     "p99_ms": summ["p99_ms"], "blocks": summ["blocks"], "mean_batch": summ["mean_batch"],
                     "memory": mem, "retire_in_flight": True}
    print("  stream threaded: " + json.dumps({k: v for k, v in res["pass_b"].items() if k != "ingests"}))
    for r in trows:
        print("  stream threaded ingest " + json.dumps(r))
    res["launches"] = {"prune_aggregate": res["pass_a"]["ingest_launches_prune_aggregate"] + hrow["launches"]}
    return res


def free_port() -> int:
    """A free TCP port on the loopback interface, for the process group's
    rendezvous (no network: 127.0.0.1 only)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def record_grouped(task, flow, ops) -> list:
    """One eager forward of ``flow``, recording the arguments of each
    grouped NA call (``ops.fused_prune_aggregate_grouped``) in call order:
    ``[(h_proj, theta_src, theta_dst, sg, theta_rel, prune_k, slope), ...]``."""
    import torch

    calls, orig = [], ops.fused_prune_aggregate_grouped

    def record(h, ts, td, sg, theta_rel=None, prune_k=None, slope=0.2):
        calls.append((h, ts, td, sg, theta_rel, prune_k, slope))
        return orig(h, ts, td, sg, theta_rel=theta_rel, prune_k=prune_k, slope=slope)

    ops.fused_prune_aggregate_grouped = record
    try:
        with torch.inference_mode():
            task.model.apply(task.params, task.batch, flow)
    finally:
        ops.fused_prune_aggregate_grouped = orig
    return calls


def stitched(ops, sl, h, ts, td, rel, prune_k, slope):
    """Every shard of ``sl`` through ``shard_out`` on this device, then the
    global ``perm`` gather: what the ranks of an n-way mesh compute."""
    import torch

    outs = [ops.shard_out(sl, s, h, ts, td, theta_rel=rel, prune_k=prune_k, slope=slope) for s in range(sl.n_shards)]
    return torch.cat(outs).index_select(0, torch.from_numpy(sl.perm.astype("int64")).to(h.device))


def check_shard_out(ops, calls, key, dev) -> dict:
    """For each recorded grouped NA call: the single-device fused launch,
    then every shard of its 2-, 4- and 8-way splits through ``shard_out``;
    the stitched result must equal the single-device launch bit for bit,
    with exactly one fused launch per shard that has grid steps (counted
    by the wrapper and per shard) and none of any other kernel. Returns a
    summary by split count."""
    out = {n: {"graphs": 0, "launches": 0, "empty_shards": 0, "balance_max": 1.0, "k_s": []} for n in SHARD_WAYS}
    for h, ts, td, sg, rel, pk, slope in calls:
        ref = ops.fused_prune_aggregate_grouped(h, ts, td, sg, theta_rel=rel, prune_k=pk, slope=slope)
        k_s = ops.grouped_meta(sg.grouped(ops.T_TILE, ops.W_TILE), pk)[2]
        for n in SHARD_WAYS:
            sl = sg.sharded(n, ops.T_TILE, ops.W_TILE)
            check(ops.sharded_k_s(sl, pk) == k_s, f"shard {key} {sg.name} {n}-way: k_s differs from the unsharded {k_s}")
            reset_launches(ops)
            ops.SHARD_LAUNCHES.clear()
            got = stitched(ops, sl, h, ts, td, rel, pk, slope)
            sync(dev)
            full = [s for s in range(n) if sl.shards[s].num_steps]
            launched = {k: v for k, v in ops.LAUNCHES.items() if v}
            check(launched == {"prune_aggregate": len(full)} and ops.SHARD_LAUNCHES == {s: 1 for s in full},
                  f"shard {key} {sg.name} {n}-way: launches {launched}, per shard {ops.SHARD_LAUNCHES}, "
                  f"expected one per shard with steps {full}")
            check(same_bits([got], [ref]), f"shard {key} {sg.name} {n}-way: stitched shards differ from the "
                                           "single-device launch")
            r = out[n]
            r["graphs"] += 1
            r["launches"] += len(full)
            r["empty_shards"] += n - len(full)
            r["balance_max"] = max(r["balance_max"], sl.balance())
            r["k_s"].append(k_s)
    for r in out.values():
        r["k_s"] = sorted(set(r["k_s"]))
    return out


def shard_phase(pipeline, FlowConfig, kernel_ops, tasks, lm_result, dev):
    """Phase 10: sharded grouped NA. ``tasks`` maps a path key to (GPU task
    of phase 3, prune_k values). Every check raises; returns the results."""
    import gc
    import threading

    import numpy as np
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import serve
    from repro_torch.core import flows
    from repro_torch.core.session import _device_tensors
    from repro_torch.distributed import sharding as dist
    from repro_torch.stream import StreamIngestor
    from repro_torch.stream.merge import _degrees_of

    ops = kernel_ops[0]
    flow = FlowConfig("fused_kernel", prune_k=PRUNE_K)
    res = {"shard_out": {}, "mesh": {}, "deltas": [], "train_under_serving": {}}

    # (a) every shard of 2-, 4- and 8-way splits, on one card
    for key, (task, prune_ks) in tasks.items():
        for pk in prune_ks:
            path = f"{key}/prune_k={pk}"
            calls = record_grouped(task, FlowConfig("fused_kernel", prune_k=pk), ops)
            check(calls, f"shard {path}: the forward made no grouped NA call")
            res["shard_out"][path] = check_shard_out(ops, calls, path, dev)
            print(f"  shard_out {path}: {len(calls)} grouped NA calls, stitched 2/4/8-way splits bit for bit the "
                  "single-device launch, one launch per shard with steps: " + json.dumps(
                      {n: {k: r[k] for k in ("launches", "empty_shards", "balance_max", "k_s")}
                       for n, r in res["shard_out"][path].items()}))
    res["shard_out_launches"] = sum(r[n]["launches"] for r in res["shard_out"].values() for n in SHARD_WAYS)

    # (b) a one-rank NCCL device mesh: prepare, capture, replay, time
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                             device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        key_1 = (1, ops.T_TILE, ops.W_TILE)
        for model, ds in SHARD_MESH_PATHS:
            key = f"{model}/{ds}"
            with dist.set_mesh(mesh):
                task = pipeline.prepare(model, ds, scale=SCALE, seed=0, device=dev)
                check(all(key_1 in sg._sharded for sg in task.sgs), f"shard mesh {key}: prepare did not split")
                want = expected_launches(task.sgs, "bucketed", PRUNE_K, task.model.num_layers, ops)
                reset_launches(ops)
                for k in flows.DISPATCH:
                    flows.DISPATCH[k] = 0
                with torch.inference_mode():
                    eager = task.model.apply(task.params, task.batch, flow)
                sync(dev)
                launches = {k: v for k, v in ops.LAUNCHES.items() if v}
                sharded_calls, lookups = flows.DISPATCH["sharded_calls"], flows.DISPATCH["mesh_lookups"]
                check(dict(ops.LAUNCHES) == want and sharded_calls == flows.DISPATCH["graph_calls"] > 0
                      and lookups == 1, f"shard mesh {key}: eager launches {launches} (want {want}), "
                                        f"{sharded_calls} sharded calls, {lookups} lookups")
                sess = task.compile(flow)
            check(sess.captured and sess.mesh_info == (mesh, "data", 1),
                  f"shard mesh {key}: the session is not captured on the mesh")
            plain = task.compile(flow)
            check(plain is not sess and plain.mesh_info is None, f"shard mesh {key}: the unsharded session is cached wrongly")
            with torch.inference_mode():
                eager_plain = task.model.apply(task.params, task.batch, flow)
            reset_launches(ops)
            dispatch = dict(flows.DISPATCH)
            outs = [sess(task.params) for _ in range(3)]
            plain_out = plain(task.params)
            sync(dev)
            check(not any(ops.LAUNCHES.values()) and flows.DISPATCH == dispatch,
                  f"shard mesh {key}: a replay launched {ops.LAUNCHES} or dispatched")
            check(same_bits(outs + [plain_out, eager_plain], [eager] * 5),
                  f"shard mesh {key}: the sharded logits differ from the single-device ones")
            ms = {"unsharded": [], "sharded": []}
            for which in ("unsharded", "sharded", "sharded", "unsharded"):
                s_ = plain if which == "unsharded" else sess
                ms[which].append(cuda_ms(lambda s_=s_: s_(task.params), SHARD_TIMED))
            res["mesh"][key] = {
                "launches_per_forward": launches, "sharded_calls": sharded_calls, "mesh_lookups": lookups,
                "replays_bitwise_single_device": 3,
                "captured_forward_ms": {k: sum(v) / len(v) for k, v in ms.items()}, "captured_forward_ms_runs": ms,
            }
            print(f"  mesh {key}: one-rank NCCL mesh, launches {launches} a forward ({sharded_calls} sharded NA "
                  f"calls, {lookups} lookup), captured, 3 replays bit for bit the single-device forward; captured "
                  f"forward unsharded / sharded {res['mesh'][key]['captured_forward_ms']['unsharded']:.4f} / "
                  f"{res['mesh'][key]['captured_forward_ms']['sharded']:.4f} ms (CUDA events, back to back)")

        # (c) two of phase 9's deltas on a shards=2 task served on the mesh
        with dist.set_mesh(mesh):
            task = pipeline.prepare("rgat", "dblp", scale=SCALE, max_degree=None, seed=0, shards=2, device=dev)
            sess = task.compile(flow)
        ing = StreamIngestor(task, sess)
        rng = np.random.default_rng(0)
        s_t, name, d_t = next(r for r in task.graph.relations if r[1] == STREAM_RELS[0])
        for i in range(SHARD_DELTAS):
            g = ing.graph
            src = rng.integers(0, g.num_nodes[s_t], STREAM_EDGES)
            if i == 0:  # phase 9's first batch: 48 random edges into AP
                dst = rng.integers(0, g.num_nodes[d_t], STREAM_EDGES)
            else:  # 48 AP edges into rows with room: the absorb tier, split patches
                sg = next(x for x in ing.sgs if x.name == name)
                bucket_of, row_of = sg.row_lookup()
                cand = np.arange(sg.num_targets)
                room = np.asarray(sg.bucket_capacities)[bucket_of] - _degrees_of(sg, cand, bucket_of, row_of)
                dst = rng.choice(cand[room > 0], STREAM_EDGES, replace=False)
            edges = {name: (src, dst)}
            old = {sg.name: sg for sg in ing.sgs}
            rep = ing.ingest(edges)
            check(ing.session.captured and ing.session.mesh_info == sess.mesh_info,
                  f"shard delta {i}: the successor is not captured on the predecessor's mesh")
            check((rep.stats.absorbed_slices == 1 or i == 0) and not rep.stats.full_rebuild,
                  f"shard delta {i}: tiers {rep.stats.summary()}")
            kept = fresh = 0
            for sg in ing.sgs:
                for skey, sl in sg._sharded.items():
                    for a, b in zip(old[sg.name]._sharded[skey].shards, sl.shards):
                        if a is b:
                            kept += 1
                        else:
                            shared = ({t.data_ptr() for t in _device_tensors(a._dev, [])}
                                      & {t.data_ptr() for t in _device_tensors(b._dev, [])})
                            check(not shared, f"shard delta {i} {sg.name}: a new shard reads its predecessor's "
                                              "device mirrors")
                            fresh += 1
            check(kept > 0 or i == 0, f"shard delta {i}: no shard kept its object through an absorb")
            cold = pipeline.prepare("rgat", ing.graph, max_degree=None, seed=0, shards=2, device=dev)
            splits = 0
            for sg, csg in zip(ing.sgs, cold.sgs):
                for skey in sg._sharded:
                    a, b = sg._sharded[skey], csg.sharded(*skey)
                    check(a.num_rows_alloc == b.num_rows_alloc and np.array_equal(a.perm, b.perm) and all(
                        np.array_equal(getattr(x, f), getattr(y, f)) for x, y in zip(a.shards, b.shards)
                        for f in ("nbr", "msk", "ety", "step_row", "step_dt", "step_ndt", "step_bucket",
                                  "row_targets", "perm")),
                        f"shard delta {i} {sg.name} {skey}: the patched split differs from the cold one")
                    splits += 1
            check(same_bits([ing.session(task.params)], [cold.compile(flow)(task.params)]),
                  f"shard delta {i}: the successor's logits differ from the cold capture's")
            dirty = [sg for sg in ing.sgs if sg is not old[sg.name]]
            gen = torch.Generator(device=dev).manual_seed(i)
            n = task.batch.total_nodes
            for sg in dirty:
                csg = next(c for c in cold.sgs if c.name == sg.name)
                h = torch.randn((n, 2, 16), device=dev, generator=gen)
                ts = torch.randn((n, 2), device=dev, generator=gen)
                td = torch.randn((sg.num_targets, 2), device=dev, generator=gen)
                ref = ops.fused_prune_aggregate_grouped(h, ts, td, csg, prune_k=PRUNE_K)
                got = stitched(ops, sg.sharded(2, ops.T_TILE, ops.W_TILE), h, ts, td, None, PRUNE_K, 0.2)
                check(same_bits([got], [ref]), f"shard delta {i} {sg.name}: the patched split's NA differs")
            res["deltas"].append({"delta": f"{name} x {STREAM_EDGES}", "tiers": rep.stats.summary(),
                                  "splits_equal_cold": splits, "shards_kept": kept, "shards_new": fresh,
                                  "dirty_slices": [sg.name for sg in dirty],
                                  "t_merge_ms": rep.t_merge * 1e3, "t_session_ms": rep.t_session * 1e3})
            print(f"  delta {i} ({name} x {STREAM_EDGES}) on a shards=2 task on the mesh: {rep.stats.summary()}; "
                  f"{splits} splits equal a cold prepare's ({kept} shards kept their objects, {fresh} new), the "
                  "successor keeps the mesh, logits bit for bit the cold capture's, dirty slices' 2-way NA bit for "
                  "bit")
    finally:
        # drop every graph that captured a collective before the group goes
        ing = sess = plain = task = None
        gc.collect()
        torch.cuda.synchronize(dev)
        tdist.destroy_process_group()

    # (d) a training step captured while a threaded front-end serves
    stask, ttask = tasks["rgat/imdb"][0], tasks["han/acm"][0]
    ssess = stask.compile(flow)
    full = ssess(stask.params).cpu().numpy()
    fe = serve.ServeFrontend(ssess, stask.params, policy=serve.BatchPolicy(SERVE_CAPACITIES, flush_timeout=SERVE_FLUSH),
                             clock=serve.SystemClock(), executor=serve.ThreadExecutor())
    wl = serve.make_workload(SHARD_SERVE_REQUESTS, stask.batch.num_targets, rate=SERVE_RATE, size_range=(1, 4), seed=2)
    stop, offered, errors = threading.Event(), [], []

    def offer():
        try:
            t0 = time.perf_counter()
            for w in wl:
                if stop.is_set():
                    return
                dt = t0 + w.t_offset - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
                offered.append((fe.submit(w.targets), w.targets))
        except BaseException as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    submitter = threading.Thread(target=offer, name="shard-offer")
    fe.start()
    submitter.start()
    time.sleep(0.1)
    n0 = len(offered)
    t0 = time.perf_counter()
    step = ttask._train_step(FlowConfig("staged"), SHARD_TRAIN_LR)
    capture_ms = (time.perf_counter() - t0) * 1e3
    check(step.captured, "shard: the training step is not captured")
    d_loss, d_param = captured_vs_eager(step, ttask.params)
    n1 = len(offered)
    time.sleep(0.1)
    stop.set()
    submitter.join(60)
    check(not submitter.is_alive() and not errors, f"shard: the offering thread failed: {errors}")
    fe.close()
    for th in fe.executor.threads:
        th.join(5.0)
    check(not any(th.is_alive() for th in fe.executor.threads), "shard: a loop thread outlived close")
    st = fe.stats
    check(st.failed == 0 and st.shed == 0 and st.expired == 0 and st.completed == st.submitted == len(offered)
          and all(f.done() for f, _ in offered), f"shard: the front-end failed or stranded requests: {st.summary()}")
    check(all(np.array_equal(f.result(0), full[q]) for f, q in offered), "shard: a served row differs from the full rows")
    check(n1 > n0, "shard: no request arrived while the step was captured and run")
    check(d_loss <= TOL_OUT and d_param <= 1e-4,
          f"shard: captured training differs from eager by {d_loss:.3g} (loss) / {d_param:.3g} (params)")
    res["train_under_serving"] = {
        "requests": len(offered), "during_capture_and_steps": n1 - n0, "failed": st.failed,
        "capture_ms": capture_ms, "captured_vs_eager_loss": d_loss, "captured_vs_eager_params": d_param,
        "decode_captured_steps_bitwise_eager": lm_result["captured_steps_bitwise_eager"],
    }
    print(f"  a HAN ACM training step captured in {capture_ms:.1f} ms while a threaded front-end served RGAT IMDB: "
          f"{len(offered)} requests ({n1 - n0} during the capture and {2 * TRAIN_CHECK_STEPS} steps), none failed, "
          f"rows bit for bit; captured vs eager steps {d_loss:.3g} (loss) / {d_param:.3g} (params); the captured "
          f"decode step bit for bit its eager step on {lm_result['captured_steps_bitwise_eager']} steps (phase 3)")
    return res


@contextlib.contextmanager
def recorded_dispatch(keep: list, reduce=lambda probs, dispatch: (probs.cpu(), dispatch.cpu())):
    """Every MoE routing (``layers.moe._topk_dispatch``, one a layer) in
    order, as ``reduce(probs (G, S, E) float32, dispatch (G, S, E, C))``:
    by default both on the host."""
    from repro_torch.layers import moe

    real = moe._topk_dispatch

    def record(probs, top_k, capacity):
        dispatch, combine = real(probs, top_k, capacity)
        keep.append(reduce(probs, dispatch))
        return dispatch, combine

    moe._topk_dispatch = record
    try:
        yield keep
    finally:
        moe._topk_dispatch = real


def decode_step_bytes(lm, batch: int, positions) -> dict:
    """Bytes a decode step must move: every weight it uses in the dtype it
    computes in (the dense GShard einsum reads all experts; a tied head reads
    the table, else the table gives only ``batch`` rows; a cross-attention's
    wk, wv, bk and bv are not read, since the context's K and V were
    projected at prefill, nor are an encoder's weights); the KV rows of
    positions 0..pos of every global layer ("A", "M", a "D" block's self)
    and at most the window's of a local one ("L"), and every context row's K
    of a cross-attention ("C", a "D" block's cross), each with its V rows:
    all of them dense, the K it keeps where the layer prunes
    (``attn_prune_k`` below its cache width: the fewest rows its retained
    set can span), as the mean over ``positions`` (the global cache is
    ``max(positions) + 1`` wide); and the recurrent states, read and written
    once a step: h (float32) and the conv window of an "R" layer, the
    (B, H, hs, hs) float32 state and both token shifts of a "W" layer."""
    import torch

    params = lm.compute_params()
    cfg = lm.cfg
    kinds = lm.kinds

    def size(tree) -> int:
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(size(v) for v in tree)
        return tree.numel() * tree.element_size()

    def read_at_decode(layer: dict) -> dict:
        cross = {k: v for k, v in layer.get("cross", {}).items() if k not in ("wk", "wv", "bk", "bv")}
        return {**layer, "cross": cross}

    table = params["embed"]["table"]
    weights = sum(size(read_at_decode(p)) for p in params["layers"])
    weights += size(params["final_norm"]) + size(params.get("lm_head", {}))
    weights += size(table) if cfg.tie_embeddings else batch * table.shape[1] * table.element_size()
    el = torch.finfo(cfg.adtype).bits // 8
    half = batch * cfg.num_kv_heads * cfg.hd * el  # one position's K (or V) in one layer
    row = 2 * half
    window = cfg.sliding_window or float("inf")
    max_len, ctx, prune = max(positions) + 1, lm.ctx_len, cfg.attn_prune_k

    def attend(valid: int, width: int) -> int:  # K rows, then the V rows read
        pruned = prune is not None and prune < width
        return half * valid + half * (min(prune, valid) if pruned else valid)

    def layer_kv(kind: str, pos: int) -> int:
        if kind == "L":
            return row * min(pos + 1, window)
        return ((attend(pos + 1, max_len) if kind in "AMD" else 0)
                + (attend(ctx, ctx) if kind in "CD" else 0))

    kv = sum(layer_kv(k, pos) for pos in positions for k in kinds if k in "AMLCD") / len(positions)
    context_kv = sum(attend(ctx, ctx) for k in kinds if k in "CD")
    w, hs = cfg.lru_width or cfg.d_model, cfg.rwkv_head_size
    state = {"R": batch * (w * 4 + (cfg.conv_width - 1) * w * el),
             "W": batch * (cfg.d_model // hs * hs * hs * 4 + 2 * cfg.d_model * el)}
    states = 2 * sum(state.get(k, 0) for k in kinds)
    return {"weights": weights, "kv_mean": kv, "context_kv": context_kv,
            "kv_per_position": row * sum(k in "AMD" for k in kinds),
            "states_read_and_written": states, "bound_ms": (weights + kv + states) / PEAK_BYTES_PER_S * 1e3}


def sequential_topk(probs, k: int):
    """The reference's routing order: k argmax picks, each masking its
    expert (first maximum on ties) -> (..., k) expert ids."""
    import torch

    remaining, picks = probs.clone(), []
    for _ in range(k):
        idx = remaining.argmax(-1)
        picks.append(idx)
        remaining.scatter_(-1, idx[..., None], 0.0)
    return torch.stack(picks, dim=-1)


def routing_diff(cfg, rec_gpu, rec_cpu, batch: int, seq: int, first_call: int) -> dict:
    """Phase 11's olmoe check of one call (a prefill of ``seq`` tokens a
    sequence, or a decode step, ``seq`` 1): per layer, the tokens whose
    top-k experts differ between the devices (flips, each with its top-k
    margin on the CPU: the least gap among its k + 1 largest
    probabilities), those routed alike but slotted or dropped differently
    (a flip ahead of them in the group), and the sequences any of these
    touch."""
    import torch

    k = cfg.moe.top_k
    flips, slotted, tainted = [], 0, set()
    for layer, ((pg, dg), (pc, dc)) in enumerate(zip(rec_gpu, rec_cpu)):
        real = batch * seq  # rows past it are the zero pad of the last group
        pg, pc = pg.reshape(-1, pg.shape[-1])[:real], pc.reshape(-1, pc.shape[-1])[:real]
        dg, dc = dg.reshape(-1, *dg.shape[-2:])[:real], dc.reshape(-1, *dc.shape[-2:])[:real]
        sel_g, sel_c = sequential_topk(pg, k), sequential_topk(pc, k)
        flip = (sel_g != sel_c).any(-1)
        moved = (dg != dc).flatten(1).any(-1) & ~flip
        top = torch.sort(pc, dim=-1, descending=True).values[:, :k + 1]
        margin = (top[:, :-1] - top[:, 1:]).min(-1).values
        for row in torch.nonzero(flip).flatten().tolist():
            flips.append({"call": first_call, "layer": layer, "sequence": row // seq, "token": row % seq,
                          "margin": float(margin[row]), "gpu": sel_g[row].tolist(), "cpu": sel_c[row].tolist()})
        slotted += int(moved.sum())
        tainted |= {row // seq for row in torch.nonzero(flip | moved).flatten().tolist()}
    return {"flips": flips, "slotted_differently": slotted, "tainted": tainted, "routed": batch * seq * len(rec_gpu)}


def unit_scale_moe(lm, generator) -> None:
    """Redraw an MoE LM's expert weights at unit scale (normal over the
    square root of each product's fan-in) and its routers so that their
    logits spread by ``ARCH_ROUTER_SPREAD`` on a normed input, as the CPU
    tests do: routing then spreads over the experts and near-ties occur.
    The seeded init's glorot takes E as the experts' fan-in, which leaves
    their output tiny."""
    import torch

    params = {n: p.detach() for n, p in lm.named_parameters()}
    for name, p in params.items():
        scale = {"router": ARCH_ROUTER_SPREAD, "experts": 1.0}.get(name.split(".")[-2])
        if scale is not None:
            draw = torch.randn(p.shape, generator=generator, device=p.device)
            params[name] = draw.mul_(scale * p.shape[-2] ** -0.5)
    lm.load_params(params)


def routing_spread(lm, toks) -> list:
    """Per layer of an MoE LM's prefill of ``toks`` (B, S), walked with the
    block's own functions: the RMS of the residual stream entering the
    layer, of its attention output and of its MoE output; how alike the
    late tokens (each sequence's second half) are at the attention output
    and at the router's input (the mean cosine of each row to its
    sequence's mean direction); and the share of (token, expert) picks
    dropped past capacity."""
    import torch

    from repro_torch.layers import attention, blocks, moe
    from repro_torch.layers.norms import apply_norm

    cfg, params = lm.cfg, lm.compute_params()
    x = lm._embed(params, toks)
    positions = torch.arange(toks.shape[1], device=toks.device)
    half = toks.shape[1] // 2
    rms = lambda t: float(t.float().square().mean().sqrt())  # noqa: E731

    def alike(t) -> float:
        rows = torch.nn.functional.normalize(t[:, half:].float(), dim=-1)
        mean = torch.nn.functional.normalize(rows.mean(1, keepdim=True), dim=-1)
        return float((rows * mean).sum(-1).mean())

    out = []
    with torch.inference_mode():
        for p, kind in zip(params["layers"], cfg.pattern()):
            h, _ = attention.attention_train(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), positions, kind="A")
            hn = apply_norm(cfg, p["ln2"], x + h)
            kept = []
            with recorded_dispatch(kept, lambda probs, dispatch: float(dispatch.sum())):
                mo, _ = moe.apply_moe(cfg, p["moe"], hn)
            picks = cfg.moe.top_k * toks.numel()
            out.append({"rms_residual": rms(x), "rms_attention": rms(h), "rms_moe": rms(mo),
                        "late_alike_attention": alike(h), "late_alike_router_input": alike(hn),
                        "dropped_share": (picks - kept[0]) / picks})
            x, _, _ = blocks.apply_block_train(cfg, kind, p, x, positions)
    return out


def draw_gates(lm, generator) -> list:
    """Every cross-attention ``gate`` of ``lm`` drawn from N(0, 1) on the
    generator's device: the seeded init's, like the reference's, are zero,
    and ``tanh(0)`` silences the cross path. Returns the values drawn."""
    import torch

    drawn = []
    for name, p in lm.named_parameters():
        if name.endswith("cross.gate"):
            p.data.copy_(torch.randn((), generator=generator, device=generator.device))
            drawn.append(float(p))
    lm._compute = None
    return drawn


def stub_context(lm, batch: int, generator):
    """The stub frontend's output on the generator's device, as the
    reference launcher draws it: (batch, ctx_len, d_model) standard normal
    image embeddings or audio frames; None for an LM without a context."""
    import torch

    if not lm.ctx_len:
        return None
    return torch.randn((batch, lm.ctx_len, lm.cfg.d_model), generator=generator, device=generator.device)


def pruned_layers(lm, max_len: int) -> int:
    """Attentions of a decode step that prune through kernel #4: a global
    self-attention ("A", "M", a "D" block's self) whose cache is wider than
    ``attn_prune_k``, a cross-attention ("C", a "D" block's cross) whose
    context is."""
    k = lm.cfg.attn_prune_k
    if k is None:
        return 0
    return sum((kind in "AMD" and k < max_len) + (kind in "CD" and k < lm.ctx_len) for kind in lm.kinds)


def arch_cpu_check(arch: str, dev) -> dict:
    """Phase 11: ``arch`` at full width, 2 layers (``ARCH_CPU_LAYERS_OF``
    where it says otherwise, cut as ``ARCH_CPU_CUT`` says), float32, the
    same weights on the card and on the CPU; prefill and two decode steps.
    Errors are relative to the CPU's largest |logit|. The weights are
    seeded; an MoE arch's experts and routers are then redrawn at unit
    scale (``unit_scale_moe``), after its routing spread was read under
    both, since the seeded ones route alike most late tokens. For an MoE
    arch the routing is compared first and the logits held only on the
    sequences no routing difference touched. A cross-attention arch gets
    its gates drawn away from zero (``draw_gates``) and a seeded context,
    and its two decode steps run again from the same prefill caches with
    ``ARCH_PRUNE_K`` (kernel #4 on the card, its plain version on the CPU)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.topk_decode_attention import ops as tda
    from repro_torch.models import build_model
    from repro_torch.models.lm import clone_cache

    layers = ARCH_CPU_LAYERS_OF.get(arch, ARCH_CPU_LAYERS)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype="float32", **ARCH_CPU_CUT.get(arch, {}))
    b, t = ARCH_CPU_BATCH, ARCH_CPU_PROMPT
    max_len = t + ARCH_CPU_STEPS
    gpu = build_model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(2))
    spread = {}
    if cfg.moe is not None:
        toks = torch.randint(0, cfg.vocab_size, (ARCH_SPREAD_BATCH, ARCH_SPREAD_PROMPT), device=dev,
                             generator=torch.Generator(dev).manual_seed(4))
        spread["seeded"] = routing_spread(gpu, toks)
        unit_scale_moe(gpu, torch.Generator(dev).manual_seed(5))
        spread["unit_scale"] = routing_spread(gpu, toks)
        for weights, by_layer in spread.items():
            print(f"  {arch} routing spread, {weights} weights, batch {ARCH_SPREAD_BATCH} of {ARCH_SPREAD_PROMPT} "
                  f"tokens, by layer: {json.dumps(by_layer)}")
    gates = draw_gates(gpu, torch.Generator(dev).manual_seed(6)) if gpu.ctx_len else []
    cpu = build_model(cfg, device="cpu", params={n: p.cpu() for n, p in gpu.named_parameters()})
    ctx = stub_context(cpu, b, torch.Generator().manual_seed(7))
    toks = torch.randint(0, cfg.vocab_size, (b, t), generator=torch.Generator().manual_seed(3))
    moe = cfg.moe is not None
    calls, rows = [], []  # per call: (gpu logits, cpu logits); rows: routing diffs
    pruned_calls, step_toks = [], []
    if arch in ARCH_PRUNE_K:  # the same weights, pruned (shared, not copied)
        pcfg = dataclasses.replace(cfg, attn_prune_k=ARCH_PRUNE_K[arch])
        p_g = build_model(pcfg, device=dev, params=dict(gpu.named_parameters()))
        p_c = build_model(pcfg, device="cpu", params=dict(cpu.named_parameters()))
    with torch.inference_mode():
        rec_g, rec_c = [], []
        with recorded_dispatch(rec_g):
            l_g, c_g = gpu.prefill(toks.to(dev), max_len=max_len, context=None if ctx is None else ctx.to(dev))
        with recorded_dispatch(rec_c):
            l_c, c_c = cpu.prefill(toks, max_len=max_len, context=ctx)
        calls.append((l_g.cpu(), l_c))
        prefill_caches = (clone_cache(c_g), clone_cache(c_c)) if arch in ARCH_PRUNE_K else None
        if moe:
            rows.append(routing_diff(cfg, rec_g, rec_c, b, t, 0))
        for i in range(ARCH_CPU_STEPS):
            tok = l_c.argmax(-1)[:, None]
            step_toks.append(tok)
            rec_g, rec_c = [], []
            with recorded_dispatch(rec_g):
                l_g, c_g = gpu.decode_step(tok.to(dev), t + i, c_g)
            with recorded_dispatch(rec_c):
                l_c, c_c = cpu.decode_step(tok, t + i, c_c)
            calls.append((l_g.cpu(), l_c))
            if moe:
                rows.append(routing_diff(cfg, rec_g, rec_c, b, 1, i + 1))
        if prefill_caches is not None:
            # the same decode steps, pruned, from the same prefill caches
            # (prefill does not prune)
            want = pruned_layers(p_g, max_len)
            c_g, c_c = prefill_caches
            for i, tok in enumerate(step_toks):
                reset_launches(tda)
                l_g, c_g = p_g.decode_step(tok.to(dev), t + i, c_g)
                sync(dev)
                check(tda.LAUNCHES == {"score_prune": want, "value_gather": want},
                      f"{arch} pruned decode step {i}: kernel #4 launches {tda.LAUNCHES}, expected {want} each")
                l_c, c_c = p_c.decode_step(tok, t + i, c_c)
                pruned_calls.append((l_g.cpu(), l_c))
            del p_g, prefill_caches
    del gpu, c_g
    scale = max(float(c.abs().max()) for _, c in calls)
    res = {"layers": layers, "kinds": "".join(cpu.kinds), "batch": b, "prompt": t, "decode_steps": ARCH_CPU_STEPS,
           "logit_scale": scale, "weights": "seeded, experts and routers at unit scale" if spread else "seeded"}
    if spread:
        res["routing_spread"] = spread
    if gates:
        res.update(gates=gates, context=list(ctx.shape), encoder_layers=cfg.enc_layers)
    held = set(range(b))
    if moe:
        flips = [f for r in rows for f in r["flips"]]
        routed = sum(r["routed"] for r in rows)
        for r in rows:  # a sequence touched at any call is held at none
            held -= r["tainted"]
        res.update(routed_tokens=routed, flips=flips, flip_share=len(flips) / routed,
                   slotted_differently=sum(r["slotted_differently"] for r in rows), sequences_held=sorted(held))
        check(len(flips) <= ARCH_FLIP_SHARE * routed, f"{arch}: {len(flips)} of {routed} routed tokens flipped "
                                                      f"between the card and the CPU")
        check(all(f["margin"] <= ARCH_FLIP_MARGIN for f in flips),
              f"{arch}: a routing flip with a top-k margin above {ARCH_FLIP_MARGIN}: {flips}")
        check(held, f"{arch}: routing differences touched every sequence: {flips}")
    rows_held = sorted(held)
    errs = [float((g[rows_held] - c[rows_held]).abs().max()) / scale for g, c in calls]
    res.update(rel_errs=errs)
    check(all(bool(torch.isfinite(g).all()) for g, _ in calls + pruned_calls), f"{arch}: non-finite logits on the card")
    check(max(errs) <= TOL_ARCH_REL, f"{arch} {layers} layers float32, card vs CPU: logits {errs} of the "
                                     f"logit scale {scale:.3g} > {TOL_ARCH_REL}")
    line = (f"  {arch} {layers} layers ({res['kinds']}) float32, {res['weights']} weights, batch {b} prompt {t} + "
            f"{ARCH_CPU_STEPS} steps: card vs CPU "
            f"logits {max(errs):.3g} of the logit scale {scale:.3g} (prefill {errs[0]:.3g}, decode "
            f"{max(errs[1:]):.3g})")
    if pruned_calls:
        p_errs = [float((g - c).abs().max()) / scale for g, c in pruned_calls]
        res.update(pruned_rel_errs=p_errs, prune_k=ARCH_PRUNE_K[arch], pruned_layers_per_step=want)
        check(max(p_errs) <= TOL_ARCH_REL, f"{arch} pruned (K {ARCH_PRUNE_K[arch]}) float32 decode, card vs CPU: "
                                           f"logits {p_errs} of the logit scale {scale:.3g} > {TOL_ARCH_REL}")
        line += (f"; pruned at K {ARCH_PRUNE_K[arch]} ({want} attentions a step through kernel #4 on the card, its "
                 f"plain version on the CPU) decode {max(p_errs):.3g}; gates {[round(g, 3) for g in gates]}, "
                 f"context {list(ctx.shape)}")
    if moe:
        line += (f"; routing: {len(res['flips'])} flips of {res['routed_tokens']} routed tokens, "
                 f"{res['slotted_differently']} slotted differently, sequences held {res['sequences_held']}")
        for f in res["flips"]:
            print(f"  {arch} routing flip: {json.dumps(f)}")
    print(line)
    return res


def decode_runs(tag: str, lm, cache, gen: int, want: dict, modules, first=None, forced=None, hook=None) -> dict:
    """Phase 11's decode of one LM on the card: ``gen`` eager steps from a
    clone of ``cache``, then the same steps through ``compile_decode`` on
    ``cache`` itself. Greedy from the token ``first``, or teacher-forced on
    ``forced`` (a token a step). Launches are counted a step: ``want`` on
    an eager step, twice that on the captured loop's first (warm-up and
    capture), nothing on a replay. The captured steps' input tokens and
    logits, and at the end every tensor of the cache (KV caches and
    recurrent states alike), are bit for bit the eager loop's. ``hook(i)``,
    where given, is a context manager around eager step ``i``. Returns the
    step, the input tokens, the eager logits, both loops' event times and
    the token after the last captured step, and the launches counted over
    the eager steps."""
    import torch

    from repro_torch.models.lm import cache_tensors, clone_cache

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits = fn()
        end.record()
        end.synchronize()
        return logits, start.elapsed_time(end)

    def launched(label: str, expected: dict) -> dict:
        got = all_launches(*modules)
        check(got == expected, f"{tag} {label}: launches {got}, expected {expected}")
        return got

    def after(i, logits):
        return logits.argmax(-1)[:, None] if forced is None else forced[min(i + 1, gen - 1)]

    twice = {key: 2 * n for key, n in want.items()}
    zero = {key: 0 for key in want}
    eager_cache, tokens, eager_logits, eager_ms = clone_cache(cache), [], [], []
    eager_launches = dict(zero)
    tok = first if forced is None else forced[0]
    for i in range(gen):
        for m in modules:
            reset_launches(m)
        tokens.append(tok)
        with hook(i) if hook else contextlib.nullcontext():
            (logits, eager_cache), ms = timed(lambda: lm.decode_step(tok, LM_PROMPT + i, eager_cache))
        for key, n in launched(f"eager decode step {i}", want).items():
            eager_launches[key] += n
        check(bool(torch.isfinite(logits).all()), f"{tag} eager decode step {i}: non-finite logits")
        eager_ms.append(ms)
        eager_logits.append(logits)
        tok = after(i, logits)
    step = lm.compile_decode(cache)
    captured_ms, tok = [], tokens[0]
    for i in range(gen):
        check(torch.equal(tok, tokens[i]), f"{tag} captured decode step {i}: input token differs from the eager loop's")
        for m in modules:
            reset_launches(m)
        logits, ms = timed(lambda: step(tok, LM_PROMPT + i))
        launched(f"captured decode step {i}", twice if i == 0 else zero)
        check(same_bits((logits,), (eager_logits[i],)), f"{tag} captured decode step {i}: logits differ from the "
                                                        "eager step's")
        captured_ms.append(ms)
        tok = after(i, logits)
    check(all(torch.equal(x, y) for x, y in zip(cache_tensors(cache), cache_tensors(eager_cache))),
          f"{tag}: the captured steps' cache or states differ from the eager loop's")
    return {"step": step, "tokens": tokens, "eager_logits": eager_logits, "eager_ms": eager_ms,
            "captured_ms": captured_ms, "last": tok, "eager_launches": eager_launches}


def arch_run(arch: str, layers, gen: int, zero: dict, modules, dev) -> dict:
    """Phase 11, one arch on the card: seeded weights, prefill of
    (LM_BATCH, LM_PROMPT), ``gen`` greedy decode steps eager and then
    captured (``decode_runs``); times, peak reserved memory and the decode
    step's byte bound. No kernel of the port may launch (``zero``). A
    cross-attention arch gets its gates drawn away from zero (``draw_gates``)
    and a stub context drawn on the card; the logits' change with the gates
    at zero is printed (``gates_off``), and then its pruned run
    (``pruned_run``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import clone_cache

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    max_len = LM_PROMPT + gen
    steady = lambda xs: median(xs[1:])  # noqa: E731  steps 2..gen
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    lm = build_model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    gates = draw_gates(lm, torch.Generator(dev).manual_seed(2)) if lm.ctx_len else []
    lm.compute_params()
    sync(dev)
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    ctx = stub_context(lm, LM_BATCH, torch.Generator(dev).manual_seed(3))
    for m in modules:
        reset_launches(m)
    routed = []
    with torch.inference_mode():
        # the MoE archs: picks kept per layer and group
        kept = lambda probs, dispatch: dispatch.sum(dim=(1, 2, 3))  # noqa: E731
        with recorded_dispatch(routed, kept) if cfg.moe else contextlib.nullcontext():
            logits, cache = lm.prefill(prompts, max_len=max_len, context=ctx)
        sync(dev)
        check(all_launches(*modules) == zero, f"{arch} prefill launched kernels: {all_launches(*modules)}")
        check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
              f"{arch} prefill logits {tuple(logits.shape)} or non-finite values")
        dropped = None
        if cfg.moe:
            # (token, expert) picks past an expert's capacity, per layer and group
            sg = min(cfg.moe.group_size, LM_BATCH * LM_PROMPT)
            dropped = [(cfg.moe.top_k * sg - k).round().long().tolist() for k in routed]
        tok0, prefill_logits = logits.argmax(-1)[:, None], logits
        cache0 = clone_cache(cache) if arch in ARCH_PRUNE_K else None  # for the pruned run
        run = decode_runs(arch, lm, cache, gen, zero, modules, first=tok0)
        step, tokens, eager_logits, eager_ms, captured_ms, tok = (
            run[key] for key in ("step", "tokens", "eager_logits", "eager_ms", "captured_ms", "last"))
        moved = gates_off(lm, prompts, ctx, max_len, cache0, tok0, prefill_logits, eager_logits[0]) if gates else None
        dense_top1 = [lg.argmax(-1) for lg in eager_logits]
        del run, eager_logits, prefill_logits
        prefill_ms = cuda_ms(lambda: lm.prefill(prompts, max_len=max_len, context=ctx), 2, warmup=0)
        # where the time goes: device time by kernel of a captured step (it
        # rewrites the slot of position LM_PROMPT each call, and advances a
        # recurrent state) and of a prefill
        profiles, t_prof = {}, time.perf_counter()
        runs = [("captured_step", lambda: step(tok0, LM_PROMPT), steady(captured_ms))]
        if arch in ARCH_PREFILL_PROFILE:
            runs.append(("prefill", lambda: lm.prefill(prompts, max_len=max_len, context=ctx), prefill_ms))
        for name, fn, ms in runs:
            per_kernel = device_times(fn, 1 if name == "prefill" else 5)
            busy = sum(per_kernel.values())
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
            profiles[name] = None if busy == 0 else {
                "device_busy_ms": busy, "busy_share": busy / ms, "kernels": len(per_kernel),
                "top_kernels_ms": [[k[:80], v] for k, v in top]}
        # the same step run eagerly, its device time by launching operator
        eager_ops = op_device_times(lambda: lm.decode_step(tok0, LM_PROMPT, cache), ARCH_EAGER_OPS)
        profile_s = time.perf_counter() - t_prof
    sync(dev)
    peak = torch.cuda.max_memory_reserved(dev)
    nbytes = decode_step_bytes(lm, LM_BATCH, range(LM_PROMPT, max_len))
    res = {
        "arch": arch, "layers": cfg.num_layers, "published_layers": full.num_layers,
        "cut": None if layers is None else f"{cfg.num_layers} of {full.num_layers} layers",
        "param_count": cfg.param_count(), "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
        "batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": gen, "init_and_cast_s": init_s,
        "prefill_ms": prefill_ms, "eager_step_ms_events": eager_ms, "captured_step_ms_events": captured_ms,
        "eager_step_ms_median": steady(eager_ms), "captured_step_ms_median": steady(captured_ms),
        "captured_tokens_per_s": LM_BATCH / (steady(captured_ms) / 1e3),
        "eager_tokens_per_s": LM_BATCH / (steady(eager_ms) / 1e3),
        "captured_steps_bitwise_eager": gen, "cache_kinds": sorted({type(c).__name__ for c in cache}),
        "reserved_before_gb": base / 1e9, "peak_reserved_gb": peak / 1e9,
        "decode_step_bytes": nbytes, "sample_tokens": tok[:, 0].tolist(), "profiles": profiles,
        "step_tokens": [t[:, 0].tolist() for t in tokens],
        "eager_step_ops_ms": eager_ops, "profile_s": profile_s,
    }
    if gates:
        res.update(gates=gates, context=list(ctx.shape), gates_off_logit_change=moved)
    if dropped is not None:
        res["dropped_picks_by_layer_group"] = dropped
        res["dropped_picks_by_group"] = [sum(col) for col in zip(*dropped)]
        res["groups"] = len(dropped[0])
    cut = f" ({res['cut']})" if res["cut"] else ""
    print(f"  {arch}{cut}: init {init_s:.1f} s, prefill {LM_BATCH}x{LM_PROMPT} {prefill_ms:.1f} ms, decode step "
          f"eager / captured {res['eager_step_ms_median']:.3f} / {res['captured_step_ms_median']:.3f} ms median of "
          f"steps 2-{gen} ({res['eager_tokens_per_s']:.1f} / {res['captured_tokens_per_s']:.1f} tokens/s), bound "
          f"{nbytes['bound_ms']:.3f} ms ({nbytes['weights'] / 1e9:.2f} GB weights + {nbytes['kv_mean'] / 1e9:.3f} GB "
          f"KV, {nbytes['context_kv'] / 1e9:.3f} GB of it context, + {nbytes['states_read_and_written'] / 1e9:.4f} GB "
          f"recurrent states a step), peak reserved {res['peak_reserved_gb']:.1f} GB ({res['reserved_before_gb']:.1f} GB before); "
          f"{gen} captured steps bit for bit the eager loop ({', '.join(res['cache_kinds'])}); sample tokens {res['sample_tokens']}")
    print(f"  {arch} profiles took {profile_s:.1f} s")
    for name, prof in profiles.items():
        print(f"  {arch} profile {name}: " + (json.dumps(prof) if prof else "profiler saw no device time: not measured"))
    print(f"  {arch} profile eager_step by operator [op, input shapes, ms]: "
          + (json.dumps(eager_ops) if eager_ops else "profiler saw no device time: not measured"))
    if dropped is not None:
        print(f"  {arch} prefill: (token, expert) picks dropped past capacity, by group of {cfg.moe.group_size} summed "
              f"over {cfg.num_layers} layers: {res['dropped_picks_by_group']}")
    if gates:
        print(f"  {arch} cross path: gates drawn from N(0, 1) {[round(g, 3) for g in gates]}, context "
              f"{list(ctx.shape)} on the card; with every gate at zero the logits move by {moved['prefill']:.4g} "
              f"(prefill) and {moved['decode_step_1']:.4g} (decode step 1, same prefill cache)")
        check(moved["prefill"] > 0 and moved["decode_step_1"] > 0, f"{arch}: the cross path does not move the logits")
    del step, cache
    if arch in ARCH_PRUNE_K:
        res["pruned"] = pruned_run(arch, lm, cache0, tokens, dense_top1, res, zero, modules, dev)
    del lm, cache0, prompts
    return res


def gates_off(lm, prompts, ctx, max_len: int, cache0, tok0, prefill_logits, step_logits) -> dict:
    """How far the cross path moves the output: the largest change of the
    prefill logits and of the first decode step's (from a clone of the same
    prefill cache) when every gate is zero. The gates are put back."""
    import torch

    from repro_torch.models.lm import clone_cache

    gates = [p for name, p in lm.named_parameters() if name.endswith("cross.gate")]
    saved = [p.detach().clone() for p in gates]
    for p in gates:  # compute_params holds these float32 leaves themselves
        p.data.zero_()
    try:
        with torch.inference_mode():
            lp, _ = lm.prefill(prompts, max_len=max_len, context=ctx)
            ls, _ = lm.decode_step(tok0, LM_PROMPT, clone_cache(cache0))
    finally:
        for p, v in zip(gates, saved):
            p.data.copy_(v)
    return {"prefill": float((lp - prefill_logits).abs().max()), "decode_step_1": float((ls - step_logits).abs().max())}


def pruned_run(arch: str, lm, cache0, tokens, dense_top1, dense: dict, zero: dict, modules, dev) -> dict:
    """Phase 11, a cross-attention arch with ADE on: a second LM with
    ``attn_prune_k = ARCH_PRUNE_K[arch]`` on the dense LM's parameters
    (shared on the card, not copied), the dense run's decode steps from a
    clone of its prefill cache (prefill does not prune), teacher-forced on
    its tokens, eager then captured (``decode_runs``). An eager step
    launches each kernel of #4 once a pruned attention
    (``pruned_layers``) and no other kernel; of these, the launches over a
    cache of ``ctx_len`` rows (kernel #4's ``LAUNCHES_BY_WIDTH``) are the
    cross-attentions', one each. Step times beside the dense ones, the
    top-1 agreement of the pruned logits with the dense ones (a report, not
    a threshold), the step's byte bound, and the decode pair timed and held
    to its plain version at the first cross-attention's inputs of the first
    eager step (``decode_pair_times``)."""
    import torch

    from repro_torch.kernels.topk_decode_attention import ops as tda
    from repro_torch.layers import attention
    from repro_torch.models import build_model
    from repro_torch.models.lm import clone_cache

    k = ARCH_PRUNE_K[arch]
    plm = build_model(dataclasses.replace(lm.cfg, attn_prune_k=k), device=dev, params=dict(lm.named_parameters()))
    check(all(p.data_ptr() == q.data_ptr() for p, q in zip(plm.parameters(), lm.parameters())),
          f"{arch}: the pruned LM copied the dense one's parameters")
    gen, ctx_len = len(tokens), plm.ctx_len
    max_len = LM_PROMPT + gen
    check(ctx_len != max_len, f"{arch}: the context and the self cache are both {max_len} rows wide")
    per_step = pruned_layers(plm, max_len)
    cross_per_step = sum(kind in "CD" and k < ctx_len for kind in plm.kinds)
    want = dict(zero, **{"topk_decode_attention.score_prune": per_step, "topk_decode_attention.value_gather": per_step})
    steady = lambda xs: median(xs[1:])  # noqa: E731  steps 2..gen
    seen, real = [], attention.topk_decode_attention
    at_ctx = {"score_prune": 0, "value_gather": 0}  # launches over the context, summed over the eager steps

    def record(q, kc, vc, lens, kk, scale):  # the first cross-attention's inputs
        if not seen and kc.shape[1] == ctx_len:
            seen.append((q.clone(), kc.clone(), vc.clone(), lens.clone(), kk, scale))
        return real(q, kc, vc, lens, kk, scale)

    @contextlib.contextmanager
    def hook(i):
        attention.topk_decode_attention = record if i == 0 else real
        try:
            yield
        finally:
            attention.topk_decode_attention = real
        got = {name: tda.LAUNCHES_BY_WIDTH.get((name, ctx_len), 0) for name in at_ctx}
        check(got == dict.fromkeys(at_ctx, cross_per_step),
              f"{arch} pruned eager decode step {i}: launches over the {ctx_len}-row context {got}, expected "
              f"{cross_per_step} of each")
        for name, n in got.items():
            at_ctx[name] += n

    with torch.inference_mode():
        run = decode_runs(f"{arch} pruned", plm, clone_cache(cache0), gen, want, modules, forced=tokens, hook=hook)
        eager_ms, captured_ms, launches = run["eager_ms"], run["captured_ms"], run["eager_launches"]
        agree = sum(int((lg.argmax(-1) == d).sum()) for lg, d in zip(run["eager_logits"], dense_top1)) / (gen * LM_BATCH)
        argmax_tokens = [lg.argmax(-1).tolist() for lg in run["eager_logits"]]
        del run
    check(len(seen) == 1, f"{arch}: no pruned cross-attention reached kernel #4")
    pair_t, pair_b, pair_s = decode_pair_times(seen[0], dev)
    nbytes = decode_step_bytes(plm, LM_BATCH, range(LM_PROMPT, max_len))
    res = {
        "prune_k": k, "pruned_attentions_per_step": per_step, "cross_attentions_per_step": cross_per_step,
        "launches_eager": {key: n for key, n in launches.items() if n}, "decode_steps": gen,
        "eager_step_ms_events": eager_ms, "captured_step_ms_events": captured_ms,
        "eager_step_ms_median": steady(eager_ms), "captured_step_ms_median": steady(captured_ms),
        "captured_tokens_per_s": LM_BATCH / (steady(captured_ms) / 1e3), "top1_agreement_with_dense": agree,
        "captured_steps_bitwise_eager": gen, "decode_step_bytes": nbytes, "argmax_tokens": argmax_tokens,
        "cross_decode_pair": {"shapes": pair_s, "times_ms": pair_t,
                              "bounds": {key: {"bound_ms": b[0], "bound_by": b[1], "bytes": b[2], "ops": b[3]}
                                         for key, b in pair_b.items()},
                              "launches_eager": at_ctx},
    }
    print(f"  {arch} pruned at K {k}: {per_step} + {per_step} kernel #4 launches each eager step (checked), "
          f"{cross_per_step} + {cross_per_step} of them over the {ctx_len}-row context, none on a replay; decode step "
          f"eager / captured "
          f"{res['eager_step_ms_median']:.3f} / {res['captured_step_ms_median']:.3f} ms against dense "
          f"{dense['eager_step_ms_median']:.3f} / {dense['captured_step_ms_median']:.3f} ms (median of steps 2-{gen}), "
          f"bound {nbytes['bound_ms']:.3f} ms; top-1 agreement with the dense logits {agree:.4f} over {gen} steps x "
          f"{LM_BATCH}; {gen} captured steps bit for bit the eager loop")
    print(f"  {arch} kernel #4 at the first cross-attention of eager step 1 ({json.dumps(pair_s)}): K1 "
          f"{pair_t['score_prune']:.4f} ms device ({pair_t['score_prune_source']}) / {pair_t['score_prune_event']:.4f} "
          f"events, plain {pair_t['score_prune_plain']:.4f}, bound {pair_b['score_prune'][0]:.5f} ms "
          f"({pair_b['score_prune'][1]}); K2 {pair_t['value_gather']:.4f} / {pair_t['value_gather_event']:.4f}, plain "
          f"{pair_t['value_gather_plain']:.4f}, library {pair_t['value_gather_library']:.4f}, bound "
          f"{pair_b['value_gather'][0]:.5f} ms; ids equal the plain version's, alpha err {pair_t['alpha_err']:.3g}, "
          f"out err {pair_t['out_err']:.3g}; launches over the context in the eager steps, counted: {at_ctx}")
    del plm
    return res


def arch_phase(modules, card, dev) -> dict:
    """Phase 11: every arch of ``ARCH_RUNS`` on the card, each freed before
    the next, then the card-vs-CPU checks. Every check raises."""
    import gc

    import torch

    torch.cuda.init()  # the memory statistics need an initialised device
    gc.collect()  # hand back what phase 3's freed LM left cached
    torch.cuda.empty_cache()
    zero = {key: 0 for key in all_launches(*modules)}
    out = {"card": card, "runs": {}, "cpu_check": {}}

    def freed(part: str, arch: str, run) -> None:
        t0 = time.perf_counter()
        out[part][arch] = run()
        gc.collect()
        torch.cuda.empty_cache()
        out[part][arch]["wall_s"] = time.perf_counter() - t0
        print(f"  {arch} {part}: wall time {out[part][arch]['wall_s']:.1f} s")

    for arch, layers, gen in ARCH_RUNS:
        freed("runs", arch, lambda: arch_run(arch, layers, gen, zero, modules, dev))
    for arch in ARCH_CPU_CHECK:
        freed("cpu_check", arch, lambda: arch_cpu_check(arch, dev))
    return out


def graph_nodes(fn) -> set:
    """The names of the autograd nodes reachable from ``fn``."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or type(f).__name__ in seen:
            continue
        seen.add(type(f).__name__)
        todo.extend(nxt for nxt, _ in f.next_functions)
    return seen


def dense_attention(q, k, v, causal: bool, window):
    """Plain attention over a materialised (S, Skv) softmax, float32: the
    flash backward's yardstick."""
    import torch

    b, s, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * hd ** -0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    p = torch.softmax(torch.where(mask, logits, -2.3e38), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, s, h, hd)


def flash_backward_check(dev) -> dict:
    """The flash backward (``layers/flash.py``'s ``Flash``) against autograd
    through ``dense_attention`` at ``FLASH_BWD_CASES``, float32, the
    configs' chunks (1024): dq, dk, dv each within ``TOL_FLASH_BWD`` of its
    largest magnitude; backward ms (CUDA events, retained graph, median of
    3) and the peak memory above the inputs of each (forward + backward)."""
    import types

    import torch

    from repro_torch.layers import flash

    cfg = types.SimpleNamespace(attn_chunk_q=1024, attn_chunk_kv=1024)
    out = {}
    for i, (name, b, s, skv, h, hkv, hd, causal, window) in enumerate(FLASH_BWD_CASES):
        g = torch.Generator(dev).manual_seed(i)
        q, k, v = (torch.randn(shape, generator=g, device=dev) for shape in
                   ((b, s, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
        dout = torch.randn((b, s, h, hd), generator=g, device=dev)
        res = {}
        for how, fn in (("flash", lambda *a: flash.flash_attention(cfg, *a, causal=causal, window=window)),
                        ("dense", lambda *a: dense_attention(*a, causal, window))):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            sync(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            o = fn(*leaves)
            grads = torch.autograd.grad(o, leaves, dout, retain_graph=True)
            sync(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base
            if how == "flash":
                check("FlashBackward" in graph_nodes(o.grad_fn), f"{name}: flash did not run through Flash")
            ms = event_median_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True), 3, warmup=1)
            res[how] = {"grads": grads, "peak_gb": peak / 1e9, "bwd_ms": ms}
            del o, leaves
        errs = {}
        for part, gf, gd in zip(("dq", "dk", "dv"), res["flash"]["grads"], res["dense"]["grads"]):
            errs[part] = float((gf - gd).abs().max() / gd.abs().max())
            check(errs[part] <= TOL_FLASH_BWD, f"{name}: flash {part} off the dense one by {errs[part]:.2e} of its max")
        out[name] = {"shape": {"B": b, "S": s, "Skv": skv, "H": h, "Hkv": hkv, "hd": hd, "causal": causal,
                               "window": window},
                     "rel_err": errs, **{f"{how}_{k}": res[how][k] for how in res for k in ("bwd_ms", "peak_gb")}}
        print(f"  flash backward {name}: dq/dk/dv {errs['dq']:.1e}/{errs['dk']:.1e}/{errs['dv']:.1e} of their max; "
              f"backward {res['flash']['bwd_ms']:.2f} ms (dense {res['dense']['bwd_ms']:.2f}), peak "
              f"{res['flash']['peak_gb']:.2f} GB (dense {res['dense']['peak_gb']:.2f}) above the inputs")
        del res
    # the training microbatch's shape in its dtype: qwen2-1.5b, (2, 4096), bfloat16
    b, s, h, hkv, hd = 2, 4096, 12, 2, 128
    g = torch.Generator(dev).manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16).requires_grad_()
               for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    dout = torch.randn((b, s, h, hd), generator=g, device=dev, dtype=torch.bfloat16)
    fwd = event_median_ms(lambda: flash.flash_attention(cfg, q, k, v), 5)
    o = flash.flash_attention(cfg, q, k, v)
    bwd = event_median_ms(lambda: torch.autograd.grad(o, (q, k, v), dout, retain_graph=True), 5)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True)

    lib_fwd = event_median_ms(sdpa, 5)
    lo = sdpa()
    lib_bwd = event_median_ms(lambda: torch.autograd.grad(lo, (q, k, v), dout.transpose(1, 2), retain_graph=True), 5)
    out["qwen2-1.5b global, bf16 (2, 4096)"] = {"flash_fwd_ms": fwd, "flash_bwd_ms": bwd, "sdpa_fwd_ms": lib_fwd,
                                                 "sdpa_bwd_ms": lib_bwd}
    print(f"  flash at qwen2-1.5b's training microbatch (2, 4096), bf16: forward {fwd:.2f} ms, backward {bwd:.2f} "
          f"ms a layer; scaled_dot_product_attention (a library call, not used by the port) {lib_fwd:.2f} / "
          f"{lib_bwd:.2f} ms")
    return out


def train_flops(cfg, params, batch: int, seq: int) -> dict:
    """A training step's model FLOPs: 6 · N · rows (N without an untied
    embedding table, whose gather multiplies nothing; the encoder's against
    the frames, the rest against the tokens), and the attention's
    3 · 4 · hd · H · (query, key) pairs attended (causal, windowed, over a
    context; forward and backward, no recompute counted)."""
    from repro_torch.models.lm import decoder_kinds

    ctx = cfg.num_img_tokens or cfg.num_audio_frames
    enc = sum(p.numel() for n, p in params.items() if n.startswith("encoder."))
    dec = sum(p.numel() for n, p in params.items()
              if not n.startswith("encoder.") and not (n == "embed.table" and not cfg.tie_embeddings))
    dense = 6 * (dec * batch * seq + enc * batch * ctx)
    causal = seq * (seq + 1) // 2
    window = cfg.sliding_window or seq
    local = sum(min(i + 1, window) for i in range(seq))
    pairs = {"A": causal, "M": causal, "L": local, "C": seq * ctx, "D": causal + seq * ctx, "R": 0, "W": 0}
    per_pair = 3 * 4 * cfg.hd * cfg.num_heads * batch
    attn = per_pair * (sum(pairs[k] for k in decoder_kinds(cfg)) + cfg.enc_layers * ctx * ctx)
    return {"dense": dense, "attention": attn, "total": dense + attn}


def lm_train_run(arch: str, layers, dev) -> dict:
    """``TRAIN_LM_STEPS`` eager ``make_train_step`` steps of ``arch`` at full
    width (depth ``layers`` when cut) on the token pipeline at
    (``TRAIN_LM_BATCH``, ``TRAIN_LM_SEQ``), the config's optimizer, remat
    and grad_accum, seeded weights, a stub context drawn per step for a
    context arch; steps 2-6 timed with CUDA events."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    lm = LM(cfg, dev)
    lm.reset_parameters(torch.Generator(dev).manual_seed(0))
    params = {n: p.detach() for n, p in lm.named_parameters()}
    del lm
    sample = {n: p.reshape(-1)[:4096].clone() for n, p in params.items()}
    opt = steps.make_optimizer(cfg)
    state = opt.init(params)
    step = steps.make_train_step(cfg)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_LM_SEQ, TRAIN_LM_BATCH, seed=0)
    ctx_len = cfg.num_img_tokens or cfg.num_audio_frames
    flops = train_flops(cfg, params, TRAIN_LM_BATCH, TRAIN_LM_SEQ)
    n_params = sum(p.numel() for p in params.values())
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    for i in range(TRAIN_LM_STEPS):
        batch = pipe.batch(i, dev)
        if ctx_len:
            g = torch.Generator(dev).manual_seed(i)
            batch["context"] = torch.randn((TRAIN_LM_BATCH, ctx_len, cfg.d_model), generator=g, device=dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, loss = step(params, state, batch)
        e1.record()
        sync(dev)
        losses.append(float(loss))
        ms.append(e0.elapsed_time(e1))
    peak_reserved = torch.cuda.max_memory_reserved(dev) / 1e9
    peak_alloc = torch.cuda.max_memory_allocated(dev) / 1e9
    check(all(math.isfinite(x) for x in losses), f"{arch}: a loss is not finite: {losses}")
    unchanged = [n for n, p in params.items() if torch.equal(p.reshape(-1)[:4096], sample[n])]
    check(len(unchanged) <= len(params) // 100, f"{arch}: {len(unchanged)} parameters unchanged: {unchanged[:8]}")
    step_ms = sorted(ms[1:])[len(ms[1:]) // 2]
    out = {
        "cut": f"{cfg.num_layers} layers" if layers is not None else "whole",
        "params": n_params, "optimizer": cfg.optimizer, "remat": cfg.remat, "grad_accum": cfg.grad_accum,
        "microbatch": TRAIN_LM_BATCH // cfg.grad_accum, "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ,
        "context_rows": ctx_len, "losses": losses, "step_ms_events": ms, "step_ms_median": step_ms,
        "first_step_ms": ms[0], "tokens_per_s": TRAIN_LM_BATCH * TRAIN_LM_SEQ / (step_ms / 1e3),
        "peak_reserved_gb": peak_reserved, "peak_allocated_gb": peak_alloc,
        "leaves_changed": len(params) - len(unchanged), "leaves": len(params), "flops": flops,
        "model_flops_share": flops["total"] / (step_ms / 1e3) / PEAK_BF16_FLOPS,
    }
    print(f"  train {arch} ({out['cut']}, {n_params / 1e9:.3f} B params, {cfg.optimizer}, remat {cfg.remat}, "
          f"grad_accum {cfg.grad_accum}): step {step_ms:.1f} ms median of steps 2-{TRAIN_LM_STEPS} (first "
          f"{ms[0]:.1f}), {out['tokens_per_s']:.0f} tokens/s, peak reserved {peak_reserved:.2f} GB (allocated "
          f"{peak_alloc:.2f}), losses {[round(x, 4) for x in losses]}, {out['leaves_changed']}/{len(params)} leaves "
          f"changed, model FLOPs {flops['total']:.3e} a step ({flops['attention']:.3e} attention), "
          f"{100 * out['model_flops_share']:.2f} % of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16")
    return out


def lm_train_cpu_check(dev) -> dict:
    """qwen2-1.5b at ``TRAIN_CPU_LAYERS`` layers, full width, float32, on the
    card and on the CPU from one seeded set of weights: the loss and every
    gradient of (``TRAIN_CPU_BATCH``, ``TRAIN_CPU_SEQ``) pipeline tokens,
    then AdamW's and Adafactor's new parameters from the CPU's gradients."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=TRAIN_CPU_LAYERS, dtype="float32")
    lm = LM(cfg, "cpu")
    lm.reset_parameters(torch.Generator().manual_seed(0))
    cpu = {n: p.detach() for n, p in lm.named_parameters()}
    gpu = {n: p.to(dev) for n, p in cpu.items()}
    batch = TokenPipeline(cfg.vocab_size, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH, seed=0).batch_np(0)
    model = LM(cfg, "meta")

    def value_and_grad(params, device):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss = model.loss_fn(leaves, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        return float(loss.detach()), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    t0 = time.perf_counter()
    lc, gc = value_and_grad(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    lg, gg = value_and_grad(gpu, dev)
    loss_err = abs(lg - lc) / abs(lc)
    check(loss_err <= TOL_TRAIN_CPU_LOSS, f"card vs CPU loss {lg} / {lc}: {loss_err:.2e} relative")
    grad_err = {n: float((gg[n].cpu() - g).abs().max() / g.abs().max()) for n, g in gc.items()}
    worst = max(grad_err, key=grad_err.get)
    check(grad_err[worst] <= TOL_TRAIN_CPU_GRAD, f"card vs CPU gradient {worst}: {grad_err[worst]:.2e} of its max")
    upd_err = {}
    for optimizer in ("adamw", "adafactor"):
        opt = steps.make_optimizer(dataclasses.replace(cfg, optimizer=optimizer))
        new_c, _ = opt.update(gc, opt.init(cpu), cpu)
        new_g, _ = opt.update({n: g.to(dev) for n, g in gc.items()}, opt.init(gpu), gpu)
        errs = {n: float((new_g[n].cpu() - p).abs().max() / p.abs().max().clamp_min(1e-30)) for n, p in new_c.items()}
        w = max(errs, key=errs.get)
        check(errs[w] <= TOL_TRAIN_CPU_UPDATE, f"card vs CPU {optimizer} update {w}: {errs[w]:.2e} relative")
        check(any(not torch.equal(new_c[n], cpu[n]) for n in cpu), f"{optimizer} moved no parameter")
        upd_err[optimizer] = errs[w]
    out = {"loss_cpu": lc, "loss_card": lg, "loss_rel_err": loss_err, "grad_rel_err_max": grad_err[worst],
           "grad_worst_leaf": worst, "update_rel_err_max": upd_err, "cpu_s": cpu_s}
    print(f"  card vs CPU (qwen2-1.5b, {TRAIN_CPU_LAYERS} layers, float32, ({TRAIN_CPU_BATCH}, {TRAIN_CPU_SEQ})): "
          f"loss {lg:.6f} / {lc:.6f} ({loss_err:.1e} relative), gradients <= {grad_err[worst]:.1e} of their max "
          f"({worst}), new parameters AdamW {upd_err['adamw']:.1e}, Adafactor {upd_err['adafactor']:.1e} relative")
    return out


def lm_resume_check(dev) -> dict:
    """``Trainer`` on the card, qwen2-1.5b at 2 layers: ``RESUME_STEPS``
    steps uninterrupted; then ``RESUME_SPLIT`` steps that end with an
    asynchronous save, and a second ``Trainer`` resumed from that
    checkpoint: its losses equal the uninterrupted run's bit for bit."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    root = ROOT / "build" / "lm_resume"
    shutil.rmtree(root, ignore_errors=True)
    tc = TrainConfig(steps=RESUME_STEPS, seq_len=RESUME_SEQ, global_batch=RESUME_BATCH, ckpt_dir=str(root / "whole"),
                     ckpt_every=10**9, keep=1, log_every=0)
    try:
        _, _, whole = Trainer(cfg, tc, device=dev).run()
        shutil.rmtree(root / "whole")
        split = dataclasses.replace(tc, ckpt_dir=str(root / "split"))
        first = Trainer(cfg, dataclasses.replace(split, steps=RESUME_SPLIT), device=dev)
        _, _, head = first.run()
        saved = dict(first.ckpt.last_write)
        second = Trainer(cfg, split, device=dev)
        _, _, tail = second.run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(head == whole[:RESUME_SPLIT], f"the first {RESUME_SPLIT} steps differ: {head} / {whole}")
    check(tail == whole[RESUME_SPLIT:], f"resumed losses {tail} differ from the uninterrupted {whole[RESUME_SPLIT:]}")
    out = {"losses": whole, "resumed": tail, "save": saved}
    print(f"  resume (qwen2-1.5b, 2 layers, ({RESUME_BATCH}, {RESUME_SEQ})): steps {RESUME_SPLIT + 1}-{RESUME_STEPS} "
          f"resumed from the step-{RESUME_SPLIT} checkpoint equal the uninterrupted run's bit for bit; the save wrote "
          f"{saved['bytes']} bytes, snapshot {saved['snapshot_s']:.2f} s (before save returned), write "
          f"{saved['write_s']:.2f} s (behind)")
    return out


def lm_train_phase(modules, card, dev) -> dict:
    """Phase 12: LM training. Every launch counter is zeroed first and must
    read zero after the training runs (no kernel of the port is on the
    path). Every check raises."""
    import gc

    import torch

    torch.cuda.init()
    gc.collect()
    torch.cuda.empty_cache()
    for m in modules:
        reset_launches(m)
    zero = {key: 0 for key in all_launches(*modules)}
    out = {"card": card, "flash_backward": flash_backward_check(dev), "runs": {}}
    gc.collect()
    torch.cuda.empty_cache()
    for arch, layers in TRAIN_LM_RUNS:
        t0 = time.perf_counter()
        out["runs"][arch] = lm_train_run(arch, layers, dev)
        gc.collect()
        torch.cuda.empty_cache()
        out["runs"][arch]["wall_s"] = time.perf_counter() - t0
        print(f"  {arch} training: wall time {out['runs'][arch]['wall_s']:.1f} s")
    out["cpu_check"] = lm_train_cpu_check(dev)
    out["resume"] = lm_resume_check(dev)
    got = all_launches(*modules)
    check(got == zero, f"a kernel launched during LM training: {got}")
    out["launches"] = got
    return out


def allocator_setting() -> str:
    """The caching allocator's settings in effect: the user's
    ``PYTORCH_CUDA_ALLOC_CONF``, or what the train step's first call on the
    card set (``steps.grow_allocator_segments``), or the defaults."""
    import os

    from repro_torch.launch import steps

    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    if env is not None:
        return f"PYTORCH_CUDA_ALLOC_CONF={env}"
    return steps.ALLOCATOR_SETTING["set"] or "defaults"


def mesh_serve(mesh, lm_result: dict, modules, dev) -> dict:
    """Phase 13 (a): gemma3-4b (published config, phase 3's seeded weights
    and prompts) served unsharded and on the one-rank mesh: prefill (4,
    3072), one eager step on a copy of the cache, then the 32 captured
    steps; tokens, logits and caches bit for bit, the caches placed by
    ``cache_shardings``, kernel #4's launches counted on the mesh run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.lm import cache_tensors, clone_cache

    cfg = get_config(LM_ARCH)
    max_len = LM_PROMPT + LM_GEN
    per_step = sum(kind == "A" and cfg.attn_prune_k < max_len for kind in cfg.pattern())
    lm = build_model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))  # phase 3's weights
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    zero = {key: 0 for key in all_launches(*modules)}
    runs = {}
    for mode in ("unsharded", "mesh"):
        for m in modules:
            reset_launches(m)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with sharding.set_mesh(mesh if mode == "mesh" else None):
            lm.prefill(prompts, max_len=max_len)  # warm-up: a mode's first call pays one-time costs
            e0.record()
            logits, cache = lm.prefill(prompts, max_len=max_len)
            e1.record()
        sync(dev)
        local = lambda t: t.to_local() if type(t).__name__ == "DTensor" else t  # noqa: E731
        run = {"prefill_ms": e0.elapsed_time(e1), "prefill_logits": local(logits).clone()}
        tok = local(logits).argmax(-1)[:, None]
        eager_logits, _ = lm.decode_step(tok, LM_PROMPT, clone_cache(cache))
        sync(dev)
        run["eager_launches"] = all_launches(*modules)
        run["eager_logits"] = local(eager_logits).clone()
        step = lm.compile_decode(cache)
        tokens, step_logits, ms = [], [], []
        for i in range(LM_GEN):
            tokens.append(tok[:, 0].tolist())
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(tok, LM_PROMPT + i)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
            step_logits.append(local(out).clone())
            tok = local(out).argmax(-1)[:, None]
        run.update(tokens=tokens, step_logits=step_logits, step_ms=ms, cache=cache,
                   launches=all_launches(*modules))
        runs[mode] = run
        del step
    u, m = runs["unsharded"], runs["mesh"]
    want_eager = dict(zero, **{"topk_decode_attention.score_prune": per_step,
                               "topk_decode_attention.value_gather": per_step})
    want = {k: 2 * v for k, v in want_eager.items()}  # the captured run's warm-up and capture, on top
    for mode, r in runs.items():
        got = {k: r["launches"][k] - r["eager_launches"][k] for k in zero}
        check(r["eager_launches"] == want_eager and got == want,
              f"phase 13 (a) {mode}: launches eager {r['eager_launches']}, captured {got}")
    check(u["tokens"] == lm_result["tokens"], "phase 13 (a): the unsharded tokens differ from phase 3's")
    check(same_bits((m["prefill_logits"], m["eager_logits"]), (u["prefill_logits"], u["eager_logits"])),
          "phase 13 (a): the mesh prefill or eager step differs from the unsharded one")
    check(m["tokens"] == u["tokens"] and all(same_bits((a,), (b,)) for a, b in zip(m["step_logits"], u["step_logits"])),
          "phase 13 (a): the captured mesh steps differ from the unsharded ones")
    specs = steps.cache_shardings(cfg, steps.ShapeSpec("serve", "decode", max_len, LM_BATCH), mesh, m["cache"])
    placed = all(type(t).__name__ == "DTensor" and sharding.spec_of(t) == sh.spec
                 for c, sp in zip(m["cache"], specs) for t, sh in zip(c, sp))
    check(placed, "phase 13 (a): a mesh cache tensor is not placed by cache_shardings")
    check(all(torch.equal(a.to_local(), b) for a, b in zip(cache_tensors(m["cache"]), cache_tensors(u["cache"]))),
          "phase 13 (a): the mesh cache differs from the unsharded one after the steps")
    median = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]  # noqa: E731
    out = {"prefill_ms": {k: r["prefill_ms"] for k, r in runs.items()},
           "captured_step_ms_median": {k: median(r["step_ms"]) for k, r in runs.items()},
           "launches_mesh": {k: v for k, v in m["launches"].items() if v},
           "cache_specs": sorted({str(sh.spec) for sp in specs for sh in sp}),
           "bitwise": "prefill, eager step, 32 captured steps' tokens and logits, caches"}
    print(f"  (a) {LM_ARCH} on the mesh: prefill {LM_BATCH}x{LM_PROMPT} {m['prefill_ms']:.1f} ms (unsharded "
          f"{u['prefill_ms']:.1f}), captured step {out['captured_step_ms_median']['mesh']:.3f} ms median of steps "
          f"2-{LM_GEN} (unsharded {out['captured_step_ms_median']['unsharded']:.3f}); tokens, logits and caches bit "
          f"for bit; caches placed {out['cache_specs']}; kernel #4 launches {out['launches_mesh']}")
    del runs, u, m, lm
    return out


def mesh_split_decode(modules, dev) -> dict:
    """Phase 13 (b): the split pruned decode (``split_pruned_decode``, each
    rank a thread, its collectives a ``ThreadLoopback``) at gemma3-4b's global-layer
    shape against unsplit kernel #4: kept positions, the K-th / (K+1)-th
    logit gap where they differ, the output's max error (1e-5), kernel #3
    and K2 launches (counted on one run), device ms (CUDA events)."""
    import torch

    from repro_torch.kernels.topk_decode_attention import ops as tda
    from repro_torch.kernels.topk_decode_attention import ref as tda_ref
    from repro_torch.kernels.topk_select import ops as ts
    from repro_torch.layers import attention

    b, h, hkv, hd, c = LM_BATCH, 8, 4, 256, LM_PROMPT + LM_GEN
    g = torch.Generator(dev).manual_seed(13)
    q = torch.randn((b, h, hd), generator=g, device=dev)
    kc = torch.randn((b, c, hkv, hd), generator=g, device=dev)
    vc = torch.randn((b, c, hkv, hd), generator=g, device=dev)
    lengths = torch.full((b,), MESH_SPLIT_LENGTH, dtype=torch.int32, device=dev)
    scale = hd ** -0.5
    desc = torch.sort(tda_ref.score_logits_plain(q, kc, scale)[..., :MESH_SPLIT_LENGTH], dim=-1, descending=True).values
    out = {"shape": {"q": [b, h, hd], "cache": [b, c, hkv, hd], "dtype": "float32", "lengths": MESH_SPLIT_LENGTH},
           "cases": {}}
    for k in MESH_SPLIT_KS:
        want = tda.topk_decode_attention(q, kc, vc, lengths, k, scale)
        _, ids = tda.score_prune(q, kc, lengths, k, scale)
        unsplit_ms = cuda_ms(lambda: tda.topk_decode_attention(q, kc, vc, lengths, k, scale), 10)
        for n in MESH_SPLITS:
            for hier in (False, True):
                for m in modules:
                    reset_launches(m)
                got_out, got_ids = attention.split_pruned_decode_loopback(q, kc, vc, lengths, n, k, scale, hier,
                                                                          return_ids=True)
                sync(dev)
                launches = {"topk_select": ts.LAUNCHES["topk_select"], "value_gather": tda.LAUNCHES["value_gather"],
                            "score_prune": tda.LAUNCHES["score_prune"]}
                merged = hier and c // n >= k
                expect = {"topk_select": n * (2 if merged else 1), "value_gather": n, "score_prune": 0}
                err = float((got_out - want).abs().max())
                differ = (got_ids != ids).any(dim=-1)
                gaps = (desc[..., k - 1] - desc[..., k])[differ].tolist()
                ms = cuda_ms(lambda: attention.split_pruned_decode_loopback(q, kc, vc, lengths, n, k, scale, hier), 5)
                key = f"K{k}/{n}way/{'hier' if hier else 'gathered'}"
                out["cases"][key] = {"hier_merge_ran": merged, "launches": launches, "max_abs_err": err,
                                     "rows_ids_differ": int(differ.sum()), "rows": b * h, "gaps_where_differ": gaps,
                                     "ms": ms, "unsplit_ms": unsplit_ms}
                check(launches == expect, f"phase 13 (b) {key}: launches {launches}, expected {expect}")
                check(err <= TOL_MESH_SPLIT, f"phase 13 (b) {key}: output {err:.3g} off unsplit kernel #4")
                check(not differ.any(), f"phase 13 (b) {key}: {int(differ.sum())} rows keep other positions than "
                      f"kernel #4 K1 on tie-free logits (K-th minus (K+1)-th logit there: {gaps[:8]})")
                print(f"  (b) {key}: {'merge of shard-local top-K' if merged else 'gathered logits'}, kept ids "
                      f"{'equal K1' if not differ.any() else f'differ in {int(differ.sum())} rows, gaps {gaps[:4]}'}, "
                      f"out {err:.2e} off unsplit, launches {launches}, {ms:.4f} ms (unsplit pair {unsplit_ms:.4f})")
    out["launches"] = {key: sum(r["launches"][key] for r in out["cases"].values()) for key in ("topk_select",
                                                                                              "value_gather")}
    return out


def mesh_split_layers(dev) -> dict:
    """Phase 13 (b'): ``attention_decode`` on a cache whose positions are
    split over 2 and 4 ranks, each rank a thread of this process
    (``ThreadLoopback``), at gemma3-4b's shapes in float32 (d_model 2560,
    8 q-heads, 4 kv-heads of 256; the global cache 3104 positions at
    position 3072, the local ring 1024 wrapped): every rank's output
    against the unsplit decode (1e-5), and the blocks joined against the
    unsplit cache after its write (bit for bit)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.layers import attention

    base = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    b, pos = LM_BATCH, LM_PROMPT
    g = torch.Generator(dev).manual_seed(31)
    params = {k: torch.randn(s, generator=g, device=dev) * s[0] ** -0.5
              for k, s in attention.attention_shapes(base).items()}
    x = torch.randn((b, 1, base.d_model), generator=g, device=dev)
    out = {}
    for kind, prune_k, hier in MESH_SPLIT_LAYERS:
        cfg = dataclasses.replace(base, attn_prune_k=prune_k, hier_topk=hier)
        c = LM_PROMPT + LM_GEN if kind == "A" else cfg.sliding_window
        kc = torch.randn((b, c, cfg.num_kv_heads, cfg.hd), generator=g, device=dev)
        vc = torch.randn((b, c, cfg.num_kv_heads, cfg.hd), generator=g, device=dev)
        whole = attention.KVCache(kc.clone(), vc.clone())
        want, _ = attention.attention_decode(cfg, params, x, pos, whole, kind)
        for n in MESH_SPLITS:
            cl = c // n
            blocks = [attention.KVCache(kc[:, r * cl:(r + 1) * cl].clone(), vc[:, r * cl:(r + 1) * cl].clone())
                      for r in range(n)]
            loop = attention.ThreadLoopback(n)
            outs = loop.run([lambda r=r: attention.attention_decode(
                cfg, params, x, pos, blocks[r], kind, split=attention.PositionSplit(n, r, loop.comm(r)))[0]
                for r in range(n)])
            sync(dev)
            err = max(float((o - want).abs().max()) for o in outs)
            written = all(torch.equal(torch.cat([blk[i] for blk in blocks], dim=1), whole[i]) for i in (0, 1))
            what = f"{kind}/{'dense' if prune_k is None else f'K{prune_k}'}{'/hier' if hier else ''}"
            key = f"{what}/{n}way"
            out[key] = {"positions": c, "max_abs_err": err, "out_max": float(want.abs().max()), "cache_bitwise": written}
            check(err <= TOL_MESH_SPLIT, f"phase 13 (b') {key}: a rank's output {err:.3g} off the unsplit decode")
            check(written, f"phase 13 (b') {key}: the split write differs from the unsplit cache's")
            print(f"  (b') attention_decode {key} ({c} positions, {c // n} a rank, ranks as threads): "
                  f"out {err:.2e} off unsplit (|out| max {out[key]['out_max']:.3g}), cache write bit for bit")
    return out


def mesh_train(mesh, dev) -> dict:
    """Phase 13 (c) and (d): qwen2-1.5b whole at (``TRAIN_LM_BATCH``,
    ``TRAIN_LM_SEQ``), fsdp placements. Unsharded: 3 steps, the step-3
    state to host and a checkpoint written behind, step 4. On the mesh from
    the same seeded weights, once the checkpoint is written: 3 steps,
    losses and parameters bit for bit.
    Then ``Trainer.restore_for_mesh`` places the unsharded step-3
    checkpoint on the mesh (every leaf bit for bit) and one more step
    there equals the unsharded step 4 bit for bit."""
    import gc
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager, flatten_train_state
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config(MESH_TRAIN_ARCH), fsdp=True)
    root = ROOT / "build" / "lm_mesh"
    shutil.rmtree(root, ignore_errors=True)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_LM_SEQ, TRAIN_LM_BATCH, seed=0)
    opt = steps.make_optimizer(cfg)

    def seeded():
        lm = LM(cfg, dev)
        lm.reset_parameters(torch.Generator(dev).manual_seed(0))
        return {n: p.detach() for n, p in lm.named_parameters()}

    def timed(step, params, state, i):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, loss = step(params, state, pipe.batch(i, dev))
        e1.record()
        e1.synchronize()
        return params, state, float(loss), e0.elapsed_time(e1)

    def pinned(t):  # a host copy in page-locked memory: one fast copy each way
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    out = {"arch": MESH_TRAIN_ARCH, "fsdp": True, "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ, "cut": "whole"}
    t0 = time.perf_counter()
    params = seeded()
    state = opt.init(params)
    step = steps.make_train_step(cfg)
    losses_u, ms_u = [], []
    for i in range(MESH_TRAIN_STEPS):
        params, state, loss, ms = timed(step, params, state, i)
        losses_u.append(loss)
        ms_u.append(ms)
    ckpt = CheckpointManager(root, keep=1)
    t1 = time.perf_counter()
    host = {k: pinned(t) for k, t in flatten_train_state(params, state).items()}
    ckpt.save(MESH_TRAIN_STEPS, host, blocking=False)  # written behind the next steps
    snapshot_s = time.perf_counter() - t1
    p3 = params
    p4, _, loss4, ms4 = timed(step, params, state, MESH_TRAIN_STEPS)
    p4 = {n: pinned(t) for n, t in p4.items()}
    del state, params, step
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    ckpt.wait()  # the write's thread would slow the mesh steps' host-bound dispatch
    wait_s = time.perf_counter() - t2
    out["unsharded"] = {"losses": losses_u + [loss4], "step_ms": ms_u + [ms4]}

    fresh = seeded()
    psh, osh = steps.params_shardings(cfg, mesh, fresh, steps.state_specs(cfg, with_opt=True)[1])
    placed = steps.place_tree(fresh, psh)
    pstate = steps.place_tree(opt.init(fresh), osh)
    del fresh
    step = steps.make_train_step(cfg, grad_shardings=psh)
    losses_m, ms_m = [], []
    for i in range(MESH_TRAIN_STEPS):
        placed, pstate, loss, ms = timed(step, placed, pstate, i)
        losses_m.append(loss)
        ms_m.append(ms)
    check(losses_m == losses_u, f"phase 13 (c): mesh losses {losses_m} differ from the unsharded {losses_u}")
    check(all(torch.equal(placed[n].to_local(), p3[n]) for n in p3),
          "phase 13 (c): the mesh step's parameters differ from the unsharded ones")
    out["mesh"] = {"losses": losses_m, "step_ms": ms_m,
                   "param_specs": sorted({str(sh.spec) for sh in psh.values()})}
    del placed, pstate, p3
    gc.collect()
    torch.cuda.empty_cache()

    tr = Trainer(cfg, TrainConfig(steps=MESH_TRAIN_STEPS + 1, seq_len=TRAIN_LM_SEQ, global_batch=TRAIN_LM_BATCH,
                                  ckpt_dir=str(root), keep=1, log_every=0), device=dev)
    t3 = time.perf_counter()
    (rp, rs), at = tr.restore_for_mesh(mesh, (psh, osh))
    sync(dev)
    restore_s = time.perf_counter() - t3
    flat = flatten_train_state(rp, rs)
    check(at == MESH_TRAIN_STEPS and all(type(v).__name__ == "DTensor" for v in flat.values()),
          f"phase 13 (d): restored step {at}, or a leaf not placed")
    check(all(torch.equal(v.to_local(), host[k].to(dev, non_blocking=True)) for k, v in flat.items()),
          "phase 13 (d): the restored state differs from the unsharded step-3 state")
    del flat, host
    rp, rs, loss, ms = timed(step, rp, rs, MESH_TRAIN_STEPS)
    check(loss == loss4, f"phase 13 (d): the step after the restore gives loss {loss}, unsharded {loss4}")
    check(all(torch.equal(rp[n].to_local(), p4[n].to(dev, non_blocking=True)) for n in p4),
          "phase 13 (d): the step after the restore differs from the unsharded step 4")
    out["restore"] = {"step": at, "restore_s": restore_s, "write_wait_s": wait_s, "snapshot_s": snapshot_s,
                      "bytes": ckpt.last_write.get("bytes"), "write_s": ckpt.last_write.get("write_s"),
                      "next_loss": loss, "next_step_ms": ms, "read": "warm (the file was written in this run)"}
    del rp, rs, tr
    shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    print(f"  (c) {MESH_TRAIN_ARCH} whole, ({TRAIN_LM_BATCH}, {TRAIN_LM_SEQ}), fsdp placements, {MESH_TRAIN_STEPS} "
          f"steps on the mesh: losses {[round(x, 4) for x in losses_m]} and parameters bit for bit the unsharded "
          f"steps'; step ms mesh {[round(x, 1) for x in ms_m]}, unsharded {[round(x, 1) for x in ms_u]}")
    print(f"  (d) restore_for_mesh: the unsharded step-{at} checkpoint ({out['restore']['bytes']} bytes) placed on "
          f"the mesh in {restore_s:.1f} s (a warm read), every leaf bit for bit; step {at + 1} there: loss {loss:.6f} "
          f"and parameters bit for bit the unsharded step's")
    return out


def lm_mesh_phase(modules, card, lm_result: dict, dev, late=None) -> dict:
    """Phase 13: the LM on a one-rank NCCL device mesh (1, 1) over
    ``("data", "model")`` (serving before training), then ``late(mesh,
    out)`` where given (13 (e) and 14 (a)); the process group is destroyed
    at the end. Every check raises."""
    import gc

    import torch
    import torch.distributed as tdist
    import torch.distributed.tensor  # noqa: F401 (its first import takes seconds: not inside a timed call)

    from repro_torch.launch.mesh import make_mesh

    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card, "allocator": allocator_setting()}
    print(f"  allocator settings in effect: {out['allocator']}")
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                             device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        t0 = time.perf_counter()
        out["serve"] = mesh_serve(mesh, lm_result, modules, dev)
        out["serve"]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["split_decode"] = mesh_split_decode(modules, dev)
        out["split_decode"]["wall_s"] = time.perf_counter() - t0
        out["split_layers"] = mesh_split_layers(dev)
        gc.collect()
        torch.cuda.empty_cache()
        out["train"] = mesh_train(mesh, dev)
        if late is not None:
            gc.collect()
            torch.cuda.empty_cache()
            late(mesh, out)
    finally:
        tdist.destroy_process_group()
    return out


# phase 13 (e), on the one-rank mesh: serving with the weights placed by
# params_shardings (fsdp on) and, for the recurrent and cross-attention
# archs, the decode state placed by cache_shardings. gemma3-4b as in (a);
# rwkv6-3b and seamless-m4t-medium whole, as phase 11 runs them (seamless
# pruned at ARCH_PRUNE_K, teacher-forced on phase 11's dense tokens); then
# the split cross decode at llama-3.2-vision-90b's C layer shape
# (CROSS_DECODE_SHAPES) on 2 and 4 ranks as threads, dense and pruned
# (gathered logits and hier_topk's merge), against unsplit kernel #4
MESH_E_ARCHS = ("rwkv6-3b", "seamless-m4t-medium")
MESH_CROSS_SPLIT = ((None, False), (1024, False), (1024, True))  # (attn_prune_k, hier_topk)
# phase 14, the dry-run (repro_torch.launch.dryrun). (a) on the one-rank
# mesh: qwen2-1.5b whole at phase 12's (TRAIN_LM_BATCH, TRAIN_LM_SEQ), fsdp
# on, counted on fake CUDA tensors, then one real step under the same
# FlopCounterMode: FLOPs equal, the predicted peak within TOL_DRYRUN_PEAK of
# the step's own max_memory_allocated; a gemma3-4b decode cell at phase 3's
# shape (batch 4, cache 3104; the dry-run decodes at the last position, so
# every row is valid) whose fake kernel #4 reports its bound's bytes. (b)
# the production meshes, each a subprocess of the dry-run's CLI on the
# card's path, started before (e) and read after (a): (arch, shape, mesh)
DRYRUN_TRAIN_ARCH = "qwen2-1.5b"
TOL_DRYRUN_PEAK = 0.10
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", "single"), ("gemma3-4b", "decode_32k", "multi"))
DRYRUN_TIMEOUT = 600


def placed_weights(cfg, mesh, lm):
    """``lm``'s parameters placed by ``params_shardings`` (fsdp on)."""
    from repro_torch.launch import steps

    params = {n: p.detach() for n, p in lm.named_parameters()}
    psh, _ = steps.params_shardings(dataclasses.replace(cfg, fsdp=True), mesh, params)
    return steps.place_tree(params, psh)


def placed_run(tag: str, cfg, mesh, lm, prompts, ctx, gen: int, want: dict, modules, forced=None) -> dict:
    """``lm`` served on ``mesh`` with its weights placed (fsdp): the prefill
    through ``make_prefill_step`` under the mesh, then ``gen`` captured
    steps (``compile_decode(cache, params=)``), greedy or teacher-forced on
    ``forced``; each cache tensor placed by ``cache_shardings``; launches
    ``want`` an eager step, twice that on the first captured call, none on
    a replay. Returns each step's input tokens and its logits' argmax."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.models.lm import cache_tensors

    max_len = LM_PROMPT + gen
    placed = placed_weights(cfg, mesh, lm)
    batch = {"tokens": prompts} if ctx is None else {"tokens": prompts, "context": ctx}
    for m in modules:
        reset_launches(m)
    with torch.inference_mode():
        with sharding.set_mesh(mesh):
            logits, cache = steps.make_prefill_step(cfg, steps.ShapeSpec("serve", "prefill", max_len, LM_BATCH))(
                placed, batch)
        specs = steps.cache_shardings(cfg, steps.ShapeSpec("serve", "decode", max_len, LM_BATCH), mesh, cache)

        def leaves(tree):
            return [tree] if isinstance(tree, sharding.Sharding) else [x for part in tree for x in leaves(part)]

        spec_ok = all(type(t).__name__ == "DTensor" and sharding.spec_of(t) == sh.spec
                      for t, sh in zip(cache_tensors(cache), leaves(specs)))
        check(spec_ok, f"phase 13 (e) {tag}: a cache tensor is not placed by cache_shardings")
        step = lm.compile_decode(cache, params=placed)
        tok = logits.to_local().argmax(-1)[:, None] if forced is None else forced[0]
        tokens, argmax, ms = [], [], []
        for i in range(gen):
            tokens.append(tok[:, 0].tolist())
            before = all_launches(*modules)
            if e_on := prompts.is_cuda:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            out = step(tok, LM_PROMPT + i).to_local()
            if e_on:
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            got = {k: v - before[k] for k, v in all_launches(*modules).items()}
            expect = {k: (2 * want.get(k, 0) if i == 0 else 0) for k in got}
            check(got == expect, f"phase 13 (e) {tag} captured step {i}: launches {got}, expected {expect}")
            argmax.append(out.argmax(-1).tolist())
            tok = out.argmax(-1)[:, None] if forced is None else forced[min(i + 1, gen - 1)]
    sync(prompts.device)
    kinds = sorted({type(c).__name__ for c in cache})
    del step, cache, placed
    return {"tokens": tokens, "argmax": argmax, "cache_kinds": kinds,
            "cache_specs": sorted({str(sh.spec) for sh in leaves(specs)}),
            "captured_step_ms_median": median(ms[1:]) if len(ms) > 1 else None}


def mesh_cross_split(modules, dev) -> dict:
    """Phase 13 (e), the split cross decode (``cross_attention_decode`` on
    a context whose rows are split over ranks, each rank a thread of this
    process) at llama-3.2-vision-90b's C layer shape in float32 against the
    unsplit decode: every rank's output within 1e-5; pruned, the kept rows
    (``split_pruned_decode_loopback``) equal unsplit kernel #4 K1's, and
    kernel #3 / K2 launched as often as the ranks launch them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.topk_decode_attention import ops as tda
    from repro_torch.kernels.topk_select import ops as ts
    from repro_torch.layers import attention

    name, b, h, hkv, hd, c, _ = CROSS_DECODE_SHAPES[0]
    base = dataclasses.replace(get_config("llama-3.2-vision-90b"), dtype="float32")
    check((base.num_heads, base.num_kv_heads, base.hd) == (h, hkv, hd), f"{name}: the config's heads differ")
    g = torch.Generator(dev).manual_seed(41)
    params = {k: torch.randn(s, generator=g, device=dev) * (s[0] ** -0.5 if s else 1.0)
              for k, s in attention.attention_shapes(base, cross=True).items()}
    x = torch.randn((b, 1, base.d_model), generator=g, device=dev)
    kc = torch.randn((b, c, hkv, hd), generator=g, device=dev)
    vc = torch.randn((b, c, hkv, hd), generator=g, device=dev)
    q = (x @ params["wq"]).reshape(b, h, hd)
    lengths = torch.full((b,), c, dtype=torch.int32, device=dev)
    scale = hd ** -0.5
    out = {"shape": {"q": [b, h, hd], "context": [b, c, hkv, hd], "dtype": "float32"}, "cases": {}}
    for prune_k, hier in MESH_CROSS_SPLIT:
        cfg = dataclasses.replace(base, attn_prune_k=prune_k, hier_topk=hier)
        want = attention.cross_attention_decode(cfg, params, x, attention.KVCache(kc, vc))
        ids = tda.score_prune(q, kc, lengths, prune_k, scale)[1] if prune_k else None
        for n in MESH_SPLITS:
            cl = c // n
            blocks = [attention.KVCache(kc[:, r * cl:(r + 1) * cl].contiguous(), vc[:, r * cl:(r + 1) * cl].contiguous())
                      for r in range(n)]
            for m in modules:
                reset_launches(m)
            loop = attention.ThreadLoopback(n)
            outs = loop.run([lambda r=r: attention.cross_attention_decode(
                cfg, params, x, blocks[r], split=attention.PositionSplit(n, r, loop.comm(r))) for r in range(n)])
            sync(dev)
            launches = {"topk_select": ts.LAUNCHES["topk_select"], "value_gather": tda.LAUNCHES["value_gather"],
                        "score_prune": tda.LAUNCHES["score_prune"]}
            err = max(float((o - want).abs().max()) for o in outs)
            key = f"{'dense' if prune_k is None else f'K{prune_k}'}{'/hier' if hier else ''}/{n}way"
            r = {"max_abs_err": err, "out_max": float(want.abs().max()), "launches": launches}
            check(err <= TOL_MESH_SPLIT, f"phase 13 (e) cross {key}: a rank's output {err:.3g} off the unsplit decode")
            if prune_k is None:
                expect = dict.fromkeys(launches, 0)
            else:
                merged = hier and cl >= prune_k
                expect = {"topk_select": n * (2 if merged else 1), "value_gather": n, "score_prune": 0}
                _, got_ids = attention.split_pruned_decode_loopback(q, kc, vc, lengths, n, prune_k, scale, hier,
                                                                    return_ids=True)
                r["rows_ids_differ"] = int((got_ids != ids).any(dim=-1).sum())
                check(r["rows_ids_differ"] == 0, f"phase 13 (e) cross {key}: {r['rows_ids_differ']} rows keep other "
                      "context rows than unsplit kernel #4 K1")
            check(launches == expect, f"phase 13 (e) cross {key}: launches {launches}, expected {expect}")
            out["cases"][key] = r
            print(f"  (e) cross {key} at {name} ({c} context rows, {cl} a rank, ranks as threads): out {err:.2e} off "
                  f"unsplit (|out| max {r['out_max']:.3g}), launches {launches}"
                  + ("" if prune_k is None else f", kept rows equal K1's in every row"))
    return out


def mesh_placed(mesh, lm_result: dict, archs: dict, modules, dev) -> dict:
    """Phase 13 (e): serving on the one-rank mesh with placed weights and
    placed decode state (see ``MESH_E_ARCHS``); tokens bit for bit those of
    phase 3 (gemma3-4b) and phase 11 (the others)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    out, t0 = {}, time.perf_counter()
    zero = {key: 0 for key in all_launches(*modules)}
    max_len = LM_PROMPT + LM_GEN
    cfg = get_config(LM_ARCH)
    lm = build_model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))  # phase 3's weights
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    per_step = pruned_layers(lm, max_len)
    want = dict(zero, **{"topk_decode_attention.score_prune": per_step,
                         "topk_decode_attention.value_gather": per_step})
    r = placed_run(LM_ARCH, cfg, mesh, lm, prompts, None, LM_GEN, want, modules)
    check(r["tokens"] == lm_result["tokens"], f"phase 13 (e) {LM_ARCH}: the placed-weight tokens differ from phase 3's")
    out[LM_ARCH] = {k: r[k] for k in ("cache_kinds", "cache_specs", "captured_step_ms_median")} | {
        "steps": LM_GEN, "tokens_equal": "phase 3"}
    print(f"  (e) {LM_ARCH}: weights placed by params_shardings (fsdp), prefill {LM_BATCH}x{LM_PROMPT} and {LM_GEN} "
          f"captured steps on the mesh: tokens bit for bit phase 3's; caches {r['cache_specs']}; captured step "
          f"{r['captured_step_ms_median']} ms median of steps 2-{LM_GEN} (each layer's weights gathered and cast "
          "inside the graph)")
    del lm, r
    gc.collect()
    torch.cuda.empty_cache()
    for arch in MESH_E_ARCHS:
        ref = archs["runs"][arch]
        k = ARCH_PRUNE_K.get(arch)
        cfg = get_config(arch) if k is None else dataclasses.replace(get_config(arch), attn_prune_k=k)
        gen = ref["decode_steps"]
        lm = build_model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))  # phase 11's weights
        if lm.ctx_len:
            draw_gates(lm, torch.Generator(dev).manual_seed(2))
        prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=dev,
                                generator=torch.Generator(dev).manual_seed(1))
        ctx = stub_context(lm, LM_BATCH, torch.Generator(dev).manual_seed(3))
        per_step = pruned_layers(lm, LM_PROMPT + gen) if k is not None else 0
        want = dict(zero, **{"topk_decode_attention.score_prune": per_step,
                             "topk_decode_attention.value_gather": per_step})
        if k is None:  # greedy, as phase 11's dense run
            r = placed_run(arch, cfg, mesh, lm, prompts, ctx, gen, want, modules)
            check(r["tokens"] == ref["step_tokens"], f"phase 13 (e) {arch}: the tokens differ from phase 11's")
            what = f"{gen} greedy steps' tokens bit for bit phase 11's"
        else:  # teacher-forced on phase 11's dense tokens, as its pruned run
            forced = [torch.tensor(t, device=dev)[:, None] for t in ref["step_tokens"]]
            r = placed_run(arch, cfg, mesh, lm, prompts, ctx, gen, want, modules, forced=forced)
            check(r["argmax"] == ref["pruned"]["argmax_tokens"],
                  f"phase 13 (e) {arch} pruned at K {k}: the tokens differ from phase 11's pruned run")
            what = f"pruned at K {k}, {gen} steps teacher-forced on phase 11's tokens: argmax bit for bit phase 11's"
        out[arch] = {"cache_kinds": r["cache_kinds"], "cache_specs": r["cache_specs"], "steps": gen, "prune_k": k,
                     "kernel4_launches_a_step": per_step, "captured_step_ms_median": r["captured_step_ms_median"]}
        print(f"  (e) {arch} whole, weights placed (fsdp), decode state placed {r['cache_specs']} "
              f"({', '.join(r['cache_kinds'])}): {what}; captured step {r['captured_step_ms_median']} ms median")
        del lm, r
        gc.collect()
        torch.cuda.empty_cache()
    out["cross_split"] = mesh_cross_split(modules, dev)
    out["wall_s"] = time.perf_counter() - t0
    return out


def dryrun_train_cell(path: str) -> None:
    """Phase 14 (a)'s count: ``DRYRUN_TRAIN_ARCH`` whole at
    (``TRAIN_LM_BATCH``, ``TRAIN_LM_SEQ``), fsdp on, on fake CUDA tensors
    on a (1, 1) mesh over a fake one-rank world (the dry-run's
    ``count_cell``), written as JSON to ``path``. Run in a process of its
    own (:func:`start_dryrun_cells`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps

    cfg = dataclasses.replace(get_config(DRYRUN_TRAIN_ARCH), fsdp=True)
    mesh = dryrun.cell_mesh("single", ((1, 1), ("data", "model")), "cuda")
    t0 = time.perf_counter()
    r = dryrun.count_cell(cfg, steps.ShapeSpec("chip", "train", TRAIN_LM_SEQ, TRAIN_LM_BATCH), mesh, device="cuda")
    r["count_s"] = time.perf_counter() - t0
    dryrun.stop_world()
    Path(path).write_text(json.dumps(r))


def start_dryrun_cells() -> dict:
    """Phase 14's processes, started together before phase 13 so that they
    run beside it: each of ``DRYRUN_CELLS`` (b) a subprocess of ``python -m
    repro_torch.launch.dryrun`` on the card's path, its record under
    ``build/dryrun``, and (a)'s count (:func:`dryrun_train_cell`); read by
    :func:`finish_dryrun_cells` and :func:`dryrun_counts`."""
    import os
    import shutil

    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        d = out / f"{arch}_{shape}_{mesh}"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", str(d)]
        procs[arch, shape, mesh] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True), d, time.perf_counter())
    path = out / "train_cell.json"
    code = ("import sys; sys.path[:0] = ['src', '.']; import chip_smoke; "
            f"chip_smoke.dryrun_train_cell({str(path)!r})")
    procs["train_cell"] = (subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True), path, time.perf_counter())
    return procs


def wait_dryrun(procs: dict, key):
    """A phase 14 process ended 0: (its output directory or file, its
    seconds)."""
    proc, d, t0 = procs[key]
    stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
    check(proc.returncode == 0, f"phase 14 {key}: exit {proc.returncode}\n" + stdout[-3000:] + stderr[-3000:])
    return d, time.perf_counter() - t0


def finish_dryrun_cells(procs: dict) -> dict:
    """Phase 14 (b): each cell's process ended 0 with one record ``ok``; the
    decode cell's kernels #3 and #4 stood in for on fake tensors (reported,
    none launched)."""
    out = {}
    try:
        for arch, shape, mesh in DRYRUN_CELLS:
            d, wall = wait_dryrun(procs, (arch, shape, mesh))
            recs = list(d.glob("*.json"))
            check(len(recs) == 1, f"phase 14 (b) {arch} {shape} {mesh}: records {recs}")
            rec = json.loads(recs[0].read_text())
            check(rec["status"] == "ok", f"phase 14 (b) {arch} {shape} {mesh}: {rec.get('error')}")
            called = sorted({c[0] for c in rec["kernel_calls"]})
            check(not any(rec["kernel_launches"].values()), f"phase 14 (b) {arch}: kernels launched on fake tensors: "
                  f"{rec['kernel_launches']}")
            if rec["kind"] == "decode":
                check(called == ["topk_select", "value_gather"], f"phase 14 (b) {arch}: fake kernels {called}")
            mem = rec["memory"]
            out[f"{arch} {shape} {mesh}"] = r = {
                "chips": rec["chips"], "flops_per_device": rec["flops_per_device"],
                "bytes_per_device": rec["bytes_per_device"],
                "collective_bytes_per_device": rec["collective_bytes_per_device"],
                "collectives": rec["collectives"], "collective_counts": rec["collective_counts"],
                "peak_bytes": mem["peak_bytes"], "argument_bytes": mem["argument_bytes"], "temp_bytes": mem["temp_bytes"],
                "dominant": rec["dominant"], "roofline_fraction": rec["roofline_fraction"],
                "t_compute": rec["t_compute"], "t_memory": rec["t_memory"], "t_collective": rec["t_collective"],
                "scanned_cost": rec["scanned_cost"], "probe": rec["probe"], "fake_kernels": called,
                "fake_kernel_calls": len(rec["kernel_calls"]), "cell_s": rec["cell_s"], "read_after_s": wall}
            print(f"  (b) {arch} {shape} on {mesh} ({rec['chips']} fake ranks): per device {r['flops_per_device']:.4e} "
                  f"FLOPs, {r['bytes_per_device']:.4e} bytes, {r['collective_bytes_per_device']:.4e} collective bytes, "
                  f"peak {r['peak_bytes'] / 1e9:.3f} GB (arguments {r['argument_bytes'] / 1e9:.3f}); dominant "
                  f"{r['dominant']}, roofline fraction {r['roofline_fraction']}; fake kernels {called} "
                  f"({r['fake_kernel_calls']} calls, none launched); cell {r['cell_s']} s (its record read {wall:.1f} s "
                  "after the process started)")
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def dryrun_counts(mesh, procs: dict, dev) -> dict:
    """Phase 14 (a) on the one-rank mesh (see ``DRYRUN_TRAIN_ARCH``): the
    dry-run's count on fake CUDA tensors (its process,
    :func:`dryrun_train_cell`) against one real step, and the fake kernel
    #4's bytes against its bound's."""
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.lm import LM

    out = {}
    cfg = dataclasses.replace(get_config(DRYRUN_TRAIN_ARCH), fsdp=True)
    gc.collect()
    torch.cuda.empty_cache()
    other = torch.cuda.memory_allocated(dev)  # what the rest of this process holds
    lm = LM(cfg, dev)
    lm.reset_parameters(torch.Generator(dev).manual_seed(0))
    params = {n: p.detach() for n, p in lm.named_parameters()}
    del lm
    opt = steps.make_optimizer(cfg)
    state = opt.init(params)
    psh, osh = steps.params_shardings(cfg, mesh, params, state)
    placed, pstate = steps.place_tree(params, psh), steps.place_tree(state, osh)
    del params, state
    batch = TokenPipeline(cfg.vocab_size, TRAIN_LM_SEQ, TRAIN_LM_BATCH, seed=0).batch(0, dev)
    step = steps.make_train_step(cfg, grad_shardings=psh)
    sync(dev)
    args_real = torch.cuda.memory_allocated(dev) - other
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        new = step(placed, pstate, batch)
    sync(dev)
    real_s = time.perf_counter() - t1
    peak_real = torch.cuda.max_memory_allocated(dev) - other
    loss = float(new[2])
    del new, placed, pstate, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    path, _ = wait_dryrun(procs, "train_cell")
    fake = json.loads(path.read_text())
    fake_s = fake["count_s"]
    mem = fake["memory"]
    rel = (mem["peak_bytes"] - peak_real) / peak_real
    out["train"] = {"arch": DRYRUN_TRAIN_ARCH, "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ, "fsdp": True,
                    "grad_accum": cfg.grad_accum, "flops_fake": fake["flops"], "flops_real": fc.get_total_flops(),
                    "peak_predicted": mem["peak_bytes"], "peak_real": peak_real, "peak_rel_diff": rel,
                    "arguments_predicted": mem["argument_bytes"], "arguments_real": args_real,
                    "bytes_accessed": fake["bytes accessed"], "fake_s": fake_s, "real_step_s": real_s, "loss": loss,
                    "other_allocated": other}
    check(fake["flops"] == fc.get_total_flops(), f"phase 14 (a): fake FLOPs {fake['flops']} differ from the real "
          f"step's {fc.get_total_flops()}")
    check(abs(rel) <= TOL_DRYRUN_PEAK, f"phase 14 (a): predicted peak {mem['peak_bytes']} B is {100 * rel:.1f} % off "
          f"the step's max_memory_allocated {peak_real} B")
    print(f"  (a) {DRYRUN_TRAIN_ARCH} whole, ({TRAIN_LM_BATCH}, {TRAIN_LM_SEQ}), fsdp, grad_accum {cfg.grad_accum}: "
          f"FLOPs fake {fake['flops']:.6e} == real {fc.get_total_flops():.6e}; peak predicted {mem['peak_bytes']} B, "
          f"real max_memory_allocated over the step {peak_real} B ({100 * rel:+.2f} %; arguments {mem['argument_bytes']} "
          f"predicted, {args_real} real); fake count {fake_s:.1f} s, real step {real_s:.2f} s")
    # kernel #4 on fake tensors: a gemma3-4b decode cell at phase 3's shape
    from repro_torch.kernels.topk_decode_attention import ops as tda

    gcfg = get_config(LM_ARCH)
    c = LM_PROMPT + LM_GEN
    dshape = steps.ShapeSpec("chip", "decode", c, LM_BATCH)
    before = dict(tda.LAUNCHES)
    fake_d = dryrun.count_cell(gcfg, dshape, mesh, device="cuda")
    check(tda.LAUNCHES == before, f"phase 14 (a): the fake decode cell launched kernel #4: {tda.LAUNCHES}")
    g = torch.Generator(dev).manual_seed(17)
    h, hkv, hd, k = gcfg.num_heads, gcfg.num_kv_heads, gcfg.hd, gcfg.attn_prune_k
    q = torch.randn((LM_BATCH, h, hd), generator=g, device=dev).to(gcfg.adtype)
    kc = torch.randn((LM_BATCH, c, hkv, hd), generator=g, device=dev).to(gcfg.adtype)
    vc = torch.randn((LM_BATCH, c, hkv, hd), generator=g, device=dev).to(gcfg.adtype)
    lengths = torch.full((LM_BATCH,), c, dtype=torch.int32, device=dev)  # pos c - 1: every row valid
    _, bounds, shapes = decode_pair_times((q, kc, vc, lengths, k, hd ** -0.5), dev)
    calls = fake_d["kernel_calls"]
    k1 = [b for name, _, b in calls if name == "score_prune"]
    k2 = [b for name, _, b in calls if name == "value_gather"]
    el = kc.element_size()
    k2_most = LM_BATCH * hkv * min(c, (h // hkv) * k) * hd * el + (2 * LM_BATCH * h * k + LM_BATCH * h * hd) * 4
    check(len(k1) == len(k2) == sum(kd == "A" for kd in gcfg.pattern()) and set(k1) == {bounds["score_prune"][2]},
          f"phase 14 (a): fake K1 bytes {sorted(set(k1))} ({len(k1)} calls), bound {bounds['score_prune'][2]}")
    check(set(k2) == {k2_most} and k2_most >= bounds["value_gather"][2],
          f"phase 14 (a): fake K2 bytes {sorted(set(k2))}, the most K2 reads {k2_most}, this data's "
          f"{bounds['value_gather'][2]}")
    out["decode"] = {"arch": LM_ARCH, "batch": LM_BATCH, "cache": c, "k1_calls": len(k1), "k1_bytes_fake": k1[0],
                     "k1_bytes_bound": bounds["score_prune"][2], "k2_bytes_fake": k2[0],
                     "k2_bytes_bound_this_data": bounds["value_gather"][2],
                     "k2_distinct_rows_this_data": shapes["distinct_retained_rows"],
                     "k2_rows_most": LM_BATCH * hkv * min(c, (h // hkv) * k), "flops": fake_d["flops"],
                     "bytes_accessed": fake_d["bytes accessed"], "memory": fake_d["memory"]}
    print(f"  (a) {LM_ARCH} decode cell ({LM_BATCH}, cache {c}) on fake tensors: {len(k1)} K1 + {len(k2)} K2 calls, none "
          f"launched; K1 reports {k1[0]} B == its bound's {bounds['score_prune'][2]} B (every row valid); K2 reports "
          f"{k2[0]} B, the most it can read ({out['decode']['k2_rows_most']} rows), where this data's retained rows "
          f"need {bounds['value_gather'][2]} B ({shapes['distinct_retained_rows']} distinct rows)")
    return out


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
    dec_err, dec_ties, dec_cases = check_decode_kernels(dev)
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

    # phase 8: ego subgraphs
    t_phase = time.perf_counter()
    print(f"phase 8: ego-subgraph serving (session.query_ego) on IMDB at scale={SCALE}, max_degree={SERVE_MAX_DEGREE}, "
          f"K={PRUNE_K}, {EGO_QUERIES} queries of {list(EGO_SIZES)} targets")
    ego = ego_phase(pipeline, FlowConfig, (ops, tda_ops, ts_ops), dev)
    for model, _ in EGO_MODELS:
        results[f"ego/{model}/imdb"] = {"launches": ego[f"{model}/imdb"]["launches"]}
    phase_s["8"] = time.perf_counter() - t_phase
    print(f"phase 8: wall time {phase_s['8']:.1f} s")

    # phase 9: streamed graph deltas
    t_phase = time.perf_counter()
    print(f"phase 9: streamed graph deltas (repro_torch.stream) on RGAT DBLP at scale={SCALE}, max_degree=None, "
          f"{STREAM_BATCHES} batches of {STREAM_EDGES} edges into {list(STREAM_RELS)}, fused_kernel K={PRUNE_K}")
    stream = stream_phase(pipeline, FlowConfig, (ops, tda_ops, ts_ops), card, dev)
    phase_s["9"] = time.perf_counter() - t_phase
    print(f"phase 9: wall time {phase_s['9']:.1f} s")

    # phase 10: sharded grouped NA
    t_phase = time.perf_counter()
    print(f"phase 10: sharded grouped NA at scale={SCALE}: shard_out at {list(SHARD_WAYS)} shards, a one-rank NCCL "
          f"device mesh, {SHARD_DELTAS} deltas on a shards=2 task, a training step captured under threaded serving")
    shard_tasks = {"han/dblp": (gpu_tasks["dblp"], (PRUNE_K,)), "han/acm": (gpu_tasks["acm"], (PRUNE_K,))}
    shard_tasks.update({f"{m}/{ds}": (model_tasks[f"{m}/{ds}/bucketed"], (PRUNE_K,))
                        for m, ds in SHARD_PATHS if m != "han"})
    shard_tasks["han/acm/max_degree=None"] = (wide_tasks["bucketed"], WIDE_PRUNE_K)
    sharded = shard_phase(pipeline, FlowConfig, (ops, tda_ops, ts_ops), shard_tasks, lm_result, dev)
    phase_s["10"] = time.perf_counter() - t_phase
    print(f"phase 10: wall time {phase_s['10']:.1f} s")

    # phase 11: the dense, MoE, recurrent and cross-attention LM archs; phase 3's LM is freed first
    del lm, prompts, cache0, tok0, decode_in
    t_phase = time.perf_counter()
    print(f"phase 11: the dense, MoE, recurrent and cross-attention LM archs, prefill {LM_BATCH}x{LM_PROMPT} + decode: "
          + ", ".join(f"{a} ({'whole' if n is None else f'{n} layers'}, {g} steps)" for a, n, g in ARCH_RUNS))
    archs = arch_phase((ops, tda_ops, ts_ops), card, dev)
    phase_s["11"] = time.perf_counter() - t_phase
    print(f"phase 11: wall time {phase_s['11']:.1f} s")

    # phase 12: LM training
    t_phase = time.perf_counter()
    print(f"phase 12: LM training: the flash backward at {len(FLASH_BWD_CASES)} full-width shapes, then "
          f"{TRAIN_LM_STEPS} eager steps of ({TRAIN_LM_BATCH}, {TRAIN_LM_SEQ}) tokens (train_4k's global batch 256 "
          "cut to 8): " + ", ".join(f"{a} ({'whole' if n is None else f'{n} layers'})" for a, n in TRAIN_LM_RUNS)
          + "; card vs CPU; a resumed run")
    lm_train = lm_train_phase((ops, tda_ops, ts_ops), card, dev)
    phase_s["12"] = time.perf_counter() - t_phase
    print(f"phase 12: wall time {phase_s['12']:.1f} s")

    # phase 13: the LM on a device mesh (serving first, then training)
    t_phase = time.perf_counter()
    print(f"phase 13: the LM on a one-rank NCCL mesh (1, 1) over (data, model): {LM_ARCH} served (prefill "
          f"{LM_BATCH}x{LM_PROMPT}, {LM_GEN} captured steps); the split pruned decode at {list(MESH_SPLITS)} shards, "
          f"K {list(MESH_SPLIT_KS)}, with and without hier_topk; {MESH_TRAIN_ARCH} whole, {MESH_TRAIN_STEPS} steps at "
          f"({TRAIN_LM_BATCH}, {TRAIN_LM_SEQ}) with fsdp placements; restore_for_mesh")
    dry, procs = {}, start_dryrun_cells()  # phase 14's processes run beside phase 13

    def late(mesh, out):
        t0 = time.perf_counter()
        out["placed"] = mesh_placed(mesh, lm_result, archs, (ops, tda_ops, ts_ops), dev)
        phase_s["13e"] = time.perf_counter() - t0
        print(f"phase 13 (e): wall time {phase_s['13e']:.1f} s")
        print(f"phase 14: the dry-run: (a) {DRYRUN_TRAIN_ARCH} whole at ({TRAIN_LM_BATCH}, {TRAIN_LM_SEQ}) on fake "
              f"CUDA tensors against a real step, and kernel #4 on fake tensors at {LM_ARCH}'s decode; (b) "
              f"{[' '.join(c) for c in DRYRUN_CELLS]} on the production meshes, fake worlds of 256 and 512 ranks")
        t0 = time.perf_counter()
        dry.update(dryrun_counts(mesh, procs, dev))
        phase_s["14a"] = time.perf_counter() - t0

    try:
        lm_mesh = lm_mesh_phase((ops, tda_ops, ts_ops), card, lm_result, dev, late=late)
        t0 = time.perf_counter()
        dry["cells"] = finish_dryrun_cells(procs)
        phase_s["14b_wait"] = time.perf_counter() - t0
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    phase_s["13"] = time.perf_counter() - t_phase
    print(f"phase 13 and 14: wall time {phase_s['13']:.1f} s (13 (e) {phase_s['13e']:.1f} s, 14 (a) "
          f"{phase_s['14a']:.1f} s, then 14 (b)'s processes waited for {phase_s['14b_wait']:.1f} s; 14's processes "
          "ran beside phase 13)")

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
            kernels[-1]["launches_phase9_ingests"] = stream["launches"]["prune_aggregate"]
            kernels[-1]["launches_phase10_shard_out"] = sharded["shard_out_launches"]
            kernels[-1]["launches_per_forward_phase10_mesh"] = {
                path: r["launches_per_forward"].get("prune_aggregate", 0) for path, r in sharded["mesh"].items()}
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
            "launches_phase13_mesh": lm_mesh["serve"]["launches_mesh"].get(f"topk_decode_attention.{key}", 0),
            "launches_phase13_split_decode": lm_mesh["split_decode"]["launches"].get(key, 0),
            "launches_phase11_pruned": {arch: r["pruned"]["launches_eager"][f"topk_decode_attention.{key}"]
                                        for arch, r in archs["runs"].items() if "pruned" in r},
            "by_shape": {f"{arch} first cross-attention, eager step 1": {
                "shapes": r["pruned"]["cross_decode_pair"]["shapes"],
                "ms": r["pruned"]["cross_decode_pair"]["times_ms"][key],
                "ms_source": r["pruned"]["cross_decode_pair"]["times_ms"][f"{key}_source"],
                "event_ms": r["pruned"]["cross_decode_pair"]["times_ms"][f"{key}_event"],
                "plain_ms": r["pruned"]["cross_decode_pair"]["times_ms"][f"{key}_plain"],
                "library_ms": r["pruned"]["cross_decode_pair"]["times_ms"][lib] if lib else None,
                **r["pruned"]["cross_decode_pair"]["bounds"][key],
                "launches": r["pruned"]["cross_decode_pair"]["launches_eager"][key],
            } for arch, r in archs["runs"].items() if "pruned" in r},
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
        "launches_phase13_split_decode": lm_mesh["split_decode"]["launches"]["topk_select"],
        "launches_phase13_on": "the split pruned decode's selections (gemma3-4b global-layer shape, 2 and 4 shards)",
    })
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps({
        "card": card, "results": results, "wide_path": wide_results, "lm": lm_result, "pruner": pruner_result, "times_ms": t,
        "decode_k1_tie_rows": {"phase2_cases": dec_ties, "phase2_tie_cases": tie_cases,
                               "main_path": lm_result["tie_rows"]},
        "decode_phase2_errors": dec_cases,
        "pruner_times_ms": t_ts, "forward_ms": fwd, "forward_latency_ms": latency, "profiles": prof,
        "train": train, "sgb": sgb, "serve": served, "ego": ego, "stream": stream, "shard": sharded, "archs": archs,
        "lm_train": lm_train, "lm_mesh": lm_mesh, "dryrun": dry,
        "kernels": kernels,
        "phase_wall_s": phase_s,
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
    print("ego " + json.dumps({
        "path": f"imdb scale={SCALE} max_degree={SERVE_MAX_DEGREE} fused_kernel K={PRUNE_K}, {EGO_QUERIES} queries of "
                f"{list(EGO_SIZES)} targets, medians of {EGO_REPEATS}",
        **{key: {k: r[k] for k in ("signatures", "max_d_cap", "ego_calls", "ego_bypass", "ego_fallback",
                                   "max_abs_err_vs_full", "pool_reserved_bytes", "full_forward_pool_bytes",
                                   "times")}
           for key, r in ego.items() if key.endswith("/imdb")},
        "frontend": ego["frontend"], "scaling_growth": ego["scaling"]["growth"], "card": card,
    }))
    pa, pb = stream["pass_a"], stream["pass_b"]
    print("stream " + json.dumps({
        "path": f"rgat/dblp scale={SCALE} max_degree=None fused_kernel K={PRUNE_K}, {STREAM_BATCHES} batches of "
                f"{STREAM_EDGES} edges into {list(STREAM_RELS)}",
        "mean_merge_ms": pa["mean_merge_ms"], "cold_rebuild_ms": pa["cold_rebuild_ms"][2],
        "merge_over_cold": pa["merge_over_cold"],
        "t_session_ms": [r["t_session_ms"] for r in pa["ingests"][1:]],
        "bytes_uploaded": [r["bytes_uploaded"] for r in pa["ingests"][1:]],
        "tiers": [r["tiers"] for r in pa["ingests"][1:]],
        "threaded": {k: pb[k] for k in ("requests", "qps", "p50_ms", "p99_ms", "blocks", "wall_s")},
        "memory": pb["memory"], "ego_rgat": stream["ego_rgat"],
        "ego_han": {k: stream["ego_han"][k] for k in ("tiers", "closures_carried", "exes_adopted", "beta_changed",
                                                      "max_abs_err_vs_full")},
        "card": card,
    }))
    print("shard " + json.dumps({
        "shard_out": {path: {n: {k: r[k] for k in ("graphs", "launches", "empty_shards", "balance_max")}
                             for n, r in by_n.items()} for path, by_n in sharded["shard_out"].items()},
        "mesh": {key: {k: r[k] for k in ("launches_per_forward", "captured_forward_ms")}
                 for key, r in sharded["mesh"].items()},
        "deltas": [{k: r[k] for k in ("delta", "tiers", "splits_equal_cold", "t_session_ms")} for r in sharded["deltas"]],
        "train_under_serving": sharded["train_under_serving"], "card": card,
    }))
    print("archs " + json.dumps({
        "runs": {arch: {k: r[k] for k in ("cut", "prefill_ms", "eager_step_ms_median", "captured_step_ms_median",
                                          "captured_tokens_per_s", "peak_reserved_gb")}
                 | {"bound_ms": r["decode_step_bytes"]["bound_ms"]}
                 | ({"pruned": {k: r["pruned"][k] for k in ("prune_k", "eager_step_ms_median", "captured_step_ms_median",
                                                            "top1_agreement_with_dense", "launches_eager")}
                               | {"bound_ms": r["pruned"]["decode_step_bytes"]["bound_ms"]}} if "pruned" in r else {})
                 for arch, r in archs["runs"].items()},
        "cpu_check": {arch: {k: r.get(k) for k in ("rel_errs", "pruned_rel_errs", "logit_scale", "flip_share",
                                                    "sequences_held")}
                      for arch, r in archs["cpu_check"].items()},
        "card": card,
    }))
    print("lm_train " + json.dumps({
        "flash_backward": {name: {k: v for k, v in r.items() if k != "shape"}
                           for name, r in lm_train["flash_backward"].items()},
        "runs": {arch: {k: r[k] for k in ("cut", "params", "optimizer", "grad_accum", "microbatch", "step_ms_median",
                                          "tokens_per_s", "peak_reserved_gb", "losses", "leaves_changed",
                                          "model_flops_share")}
                 for arch, r in lm_train["runs"].items()},
        "cpu_check": lm_train["cpu_check"], "resume": lm_train["resume"], "launches": lm_train["launches"],
        "card": card,
    }))
    print("mesh " + json.dumps({
        "mesh": "(1, 1) data, model, one NCCL rank", "allocator": lm_mesh["allocator"],
        "serve": {k: lm_mesh["serve"][k] for k in ("prefill_ms", "captured_step_ms_median", "launches_mesh", "bitwise",
                                                   "wall_s")},
        "split_decode": {key: {k: r[k] for k in ("hier_merge_ran", "rows_ids_differ", "max_abs_err", "launches", "ms",
                                                 "unsplit_ms")}
                         for key, r in lm_mesh["split_decode"]["cases"].items()},
        "split_layers": lm_mesh["split_layers"],
        "train": {"unsharded": lm_mesh["train"]["unsharded"], "mesh": lm_mesh["train"]["mesh"],
                  "restore": lm_mesh["train"]["restore"], "wall_s": lm_mesh["train"]["wall_s"]},
        "card": card,
    }))
    print("dryrun " + json.dumps({
        "train_vs_real_step": dry["train"], "kernel4_fake_bytes": dry["decode"], "cells": dry["cells"],
        "placed_serving": {k: v for k, v in lm_mesh["placed"].items() if k != "cross_split"},
        "cross_split": {key: {k: r[k] for k in ("max_abs_err", "launches")}
                        for key, r in lm_mesh["placed"]["cross_split"]["cases"].items()},
        "wall_s": {k: phase_s[k] for k in ("13e", "14a", "14b_wait")}, "card": card,
    }))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
