#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

It imports ``repro_torch`` from ``src/`` (never JAX, never ``repro``) and
exits non-zero at the first phase that fails:

1. prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/*/csrc`` with ``nvcc`` and prints the build
   time and the compiler's register/shared-memory report;
2. holds each CUDA kernel against its plain PyTorch version on the card, on
   the kernel-test parametrisations (pruned/bypass mix, unaligned
   capacities, one bucket, all-bypass, no pruning, a relation term, an
   empty bucket, an empty graph), a score tie, and the real DBLP and ACM
   layouts: retained ids equal, alpha within 1e-6, outputs within 1e-5
   (``expf`` and FMA contraction differ from the CPU's arithmetic);
3. drives the main path — ``prepare`` → ``task.compile(FlowConfig(
   "fused_kernel", prune_k=8))`` → ``session(params)`` — for HAN on DBLP and
   ACM at ``scale=1.0`` with seeded random weights: exactly one launch of
   each kernel per semantic graph, finite logits within 1e-4 of the same
   forward on the CPU (plain versions; the projection sums in another
   order), and ``session.query`` blocks at capacities 1, 8, 64
   bit-identical to the full forward's rows;
4. times each kernel, its plain version and (for K2) one library call at
   the DBLP APA shapes with CUDA events, and the whole forward;
5. prints the card line, then the ``{"kernels": [...]}`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, published
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
TOL_ALPHA, TOL_OUT, TOL_LOGITS = 1e-6, 1e-5, 1e-4


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

    err = {"prune": 0.0, "aggregate": 0.0}
    gen = torch.Generator().manual_seed(0)
    for name, sg, k, n, h, dh, n_rel in cases:
        hp = torch.randn((n, h, dh), generator=gen).to(dev)
        ts = torch.randn((n, h), generator=gen).to(dev)
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
        ety = ety if tr is not None else None
        a_k, i_k = ops.prune(nbr, msk, ety, ts, tr, td, rt, blk, k_s)
        a_p, i_p = ref.prune_plain(nbr, msk, ety, ts, tr, td, rt, blk, k_s, 0.2)
        o_k = ops.aggregate(a_p, i_p, hp, blk)
        o_p = ref.aggregate_plain(a_p, i_p, hp, blk)
        torch.cuda.synchronize()
        if not torch.equal(i_k, i_p):
            bad = int((i_k != i_p).sum())
            raise AssertionError(f"{name}: K1 retained ids differ from the plain version in {bad} slots")
        e_a = float((a_k - a_p).abs().max())
        e_o = float((o_k - o_p).abs().max())
        e_op = float((out - o_p[perm]).abs().max())
        if e_a > TOL_ALPHA or e_o > TOL_OUT or e_op > TOL_OUT:
            raise AssertionError(f"{name}: alpha err {e_a:.3g}, K2 err {e_o:.3g}, op err {e_op:.3g}")
        err["prune"] = max(err["prune"], e_a)
        err["aggregate"] = max(err["aggregate"], e_o, e_op)
        print(f"  kernels == plain  {name}: k_s={k_s} steps={layout.num_steps} "
              f"ids equal, alpha err {e_a:.3g}, out err {max(e_o, e_op):.3g}")
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


def main_path(pipeline, FlowConfig, ops, cpu_tasks, dev):
    """Phase 3. Returns per-dataset results and the GPU tasks."""
    import numpy as np
    import torch

    flow = FlowConfig("fused_kernel", prune_k=8)
    results, gpu_tasks = {}, {}
    for ds, cpu_task in cpu_tasks.items():
        t0 = time.perf_counter()
        task = pipeline.prepare("han", ds, scale=1.0, seed=0, device=dev)
        prep_s = time.perf_counter() - t0
        gpu_tasks[ds] = task
        for name, p in task.params.items():
            check(torch.equal(p.cpu(), cpu_task.params[name]), f"{ds}: weights differ on {name}")
        sess = task.compile(flow)
        n_sg = len(task.sgs)
        check(all(sg.grouped(ops.T_TILE, ops.W_TILE).num_steps > 0 for sg in task.sgs),
              f"{ds}: a semantic graph has no grid steps")
        ops.LAUNCHES.update(prune=0, aggregate=0)
        logits = sess(task.params)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        if launches != {"prune": n_sg, "aggregate": n_sg}:
            raise AssertionError(f"{ds}: launches {launches}, expected {n_sg} of each kernel")
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
        results[ds] = {
            "semantic_graphs": [sg.name for sg in task.sgs], "launches": launches,
            "logits_shape": list(logits.shape), "max_abs_err_vs_cpu": err,
            "query_blocks_bit_identical": n_blocks, "prepare_s": prep_s,
        }
        print(f"  main path {ds}: {n_sg} semantic graphs, launches {launches}, "
              f"logits {tuple(logits.shape)} finite, |gpu-cpu| {err:.3g}, "
              f"{n_blocks} query blocks bit-identical")
    return results, gpu_tasks


def timings(task, dev):
    """Phase 4 at the DBLP APA shapes: kernel, plain and library times, and
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
            "prune": cuda_ms(lambda: ops.prune(*args), 200),
            "prune_plain": cuda_ms(lambda: ref.prune_plain(*args, 0.2), 5, warmup=1),
            "aggregate": cuda_ms(lambda: ops.aggregate(alpha, ids, h, blk), 200),
            "aggregate_plain": cuda_ms(lambda: ref.aggregate_plain(alpha, ids, h, blk), 20),
        }
        # K2 as one library call: a CSR sparse-dense product, row r*H + hh
        # of the sparse matrix holding alpha[r, :, hh] at columns id*H + hh
        rows, _, heads = alpha.shape
        n, _, dh = h.shape
        r_i, s_i = torch.nonzero(ids >= 0, as_tuple=True)
        hh = torch.arange(heads, device=dev)
        with torch.sparse.check_sparse_tensor_invariants(enable=True):
            coo = torch.sparse_coo_tensor(
                torch.stack([(r_i[:, None] * heads + hh).reshape(-1),
                             (ids[r_i, s_i].long()[:, None] * heads + hh).reshape(-1)]),
                alpha[r_i, s_i].reshape(-1), size=(rows * heads, n * heads),
            )
            csr = coo.coalesce().to_sparse_csr()
        hflat = h.reshape(n * heads, dh)
        lib_out = torch.sparse.mm(csr, hflat).reshape(rows, heads, dh)
        lib_err = float((lib_out - out).abs().max())
        check(lib_err <= TOL_OUT, f"library K2 differs from the kernel by {lib_err:.3g}")
        t["aggregate_library"] = cuda_ms(lambda: torch.sparse.mm(csr, hflat), 200)
        torch.cuda.synchronize()
        # bytes this run's data needs: every slot's mask (1 B), the ids of
        # valid slots, the theta_src rows they reference (as K2 counts the
        # h' rows its retained ids reference), theta_dst, the row tables
        valid = int(msk.sum())
        src_rows = int(torch.unique(nbr[msk]).numel())
        retained = ids[ids >= 0]
        distinct = int(torch.unique(retained).numel())
        n_blocks = blk.shape[1]
        k1_bytes = msk.numel() * msk.element_size() + valid * nbr.element_size() \
            + (src_rows * heads + sc.theta_dst.numel()) * 4 + (rt.numel() + blk.numel()) * 4 \
            + alpha.numel() * 4 + ids.numel() * 4
        k1_ops = valid * (heads + 1) + rows * k_s * heads * 6
        k2_bytes = (alpha.numel() + ids.numel() + 4 * n_blocks) * 4 + distinct * heads * dh * 4 + out.numel() * 4
        k2_ops = 2 * int((ids >= 0).sum()) * heads * dh
    bounds = {}
    for key, nbytes, nops in (("prune", k1_bytes, k1_ops), ("aggregate", k2_bytes, k2_ops)):
        b_ms, o_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_FLOPS * 1e3
        bounds[key] = (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, nops)
    shapes = {
        "graph": f"dblp {sg.name}", "grid_steps": layout.num_steps, "rows": rows, "k_s": k_s,
        "valid_edge_slots": valid, "distinct_source_rows": src_rows,
        "retained_slots": int(retained.numel()), "distinct_retained_rows": distinct,
    }
    return t, bounds, shapes


def forward_profile(sess, params, forward_ms: float, reps: int = 5):
    """Device time per forward by kernel name (torch.profiler, CUPTI) and
    the device's busy share of the event-timed forward. ``None`` when the
    profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            sess(params)
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
    busy = sum(per_kernel.values())
    if busy == 0:
        return None
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "device_busy_ms": busy, "forward_ms": forward_ms, "busy_share": busy / forward_ms,
        "top_kernels_ms": [[name[:80], ms] for name, ms in top],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import hetgraph, pipeline
    from repro_torch.core.flows import FlowConfig
    from repro_torch.kernels.fused_prune_aggregate import ops

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # phase 1: build
    t0 = time.perf_counter()
    _, record = ops.library()
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {record['path']} in {build_s:.2f} s (nvcc {record['seconds']:.2f} s)")
    for line in record["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # host-side SGB for the main path, on the CPU (also the CPU reference)
    cpu_tasks = {ds: pipeline.prepare("han", ds, scale=1.0, seed=0, device="cpu") for ds in ("dblp", "acm")}

    # phase 2: kernels against their plain versions on the card
    print("phase 2: CUDA kernels against their plain PyTorch versions")
    err = check_kernels(kernel_cases(hetgraph, cpu_tasks), dev)
    check_tie(hetgraph, dev)

    # phase 3: the main path
    print("phase 3: HAN fused_kernel serving at scale=1.0")
    results, gpu_tasks = main_path(pipeline, FlowConfig, ops, cpu_tasks, dev)

    # phase 4: times
    print("phase 4: times (CUDA events)")
    t, bounds, shapes = timings(gpu_tasks["dblp"], dev)
    flow = FlowConfig("fused_kernel", prune_k=8)
    fwd, latency, prof = {}, {}, {}
    for ds, task in gpu_tasks.items():
        sess = task.compile(flow)
        fwd[ds] = cuda_ms(lambda: sess(task.params), 20)
        lat = []
        for _ in range(20):  # one forward at a time: host clock around a synchronized call
            t0 = time.perf_counter()
            sess(task.params)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        latency[ds] = sorted(lat)[len(lat) // 2]
        prof[ds] = forward_profile(sess, task.params, fwd[ds])
    print("  shapes: " + json.dumps(shapes))
    print("  times_ms: " + json.dumps(t))
    print("  forward_ms (back to back, CUDA events): " + json.dumps(fwd))
    print("  forward_latency_ms (median, host clock, synchronized): " + json.dumps(latency))
    for ds, p in prof.items():
        print(f"  profile {ds}: " + (json.dumps(p) if p else "profiler saw no device time: not measured"))
    print("  results: " + json.dumps(results))

    kernels = []
    launches = {k: sum(r["launches"][k] for r in results.values()) for k in ("prune", "aggregate")}
    for key, line, lib in (("prune", "kernel.py:219", None), ("aggregate", "kernel.py:137", "aggregate_library")):
        bound_ms, bound_by, nbytes, nops = bounds[key]
        kernels.append({
            "name": f"fused_prune_aggregate.{key}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/fused_prune_aggregate/csrc/fused_prune_aggregate.cu",
            "replaces": f"src/repro/kernels/fused_prune_aggregate/{line}",
            "launches": launches[key],
            "launches_per_forward": {ds: r["launches"][key] for ds, r in results.items()},
            "max_abs_err": err[key],
            "ms": t[key],
            "plain_ms": t[f"{key}_plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_bytes": nbytes,
            "bound_ops": nops,
            "library_ms": t[lib] if lib else None,
            "shapes": shapes["graph"],
            "check": "pass: ids equal, alpha <= 1e-6" if key == "prune" else "pass: out <= 1e-5",
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
