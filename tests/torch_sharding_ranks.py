"""The rank program of ``tests/test_torch_sharding.py``'s multi-rank checks.

:func:`spawn` starts ``world`` processes (``spawn`` start method), each a
``gloo`` rank on the CPU over a ``file://`` rendezvous, with the ranks
joined in a one-axis ``torch.distributed`` device mesh named ``"data"``.
Every rank runs :func:`rank_checks`, the same calls in the same order, as
the collectives need, and sends back what it saw: logits, served rows and
counters, as numpy arrays and ints. The test process compares them with
its own single-device results. A rank that raises sends its traceback; a
rank that hangs is ended when the join timeout runs out, and the spawn
raises either way.

This module imports neither JAX nor the reference: the ranks run only the
port.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback

import numpy as np

MODELS = ("han", "rgat", "simple_hgn")
TASK = dict(scale=0.04, max_degree=32, seed=0, bucket_sizes=(4, 8, 16))


def _reset(flows, ops):
    for k in flows.DISPATCH:
        flows.DISPATCH[k] = 0
    ops.SHARD_LAUNCHES.clear()


class _CountCalls:
    """Counts the grouped fused wrapper's calls (one per launch on a card;
    the CPU runs its plain version) while installed."""

    def __init__(self, ops):
        self.ops, self.n, self._orig = ops, 0, ops.prune_aggregate

    def __enter__(self):
        def counted(*a, **kw):
            self.n += 1
            return self._orig(*a, **kw)

        self.ops.prune_aggregate = counted
        return self

    def __exit__(self, *exc):
        self.ops.prune_aggregate = self._orig


def rank_checks(mesh, world: int) -> dict:
    import torch

    from repro_torch.core import flows, pipeline
    from repro_torch.core.flows import FlowConfig
    from repro_torch.distributed import sharding as dist
    from repro_torch.kernels.fused_prune_aggregate import ops
    from repro_torch.serve import BatchPolicy, FakeClock, InlineExecutor, ServeFrontend, make_workload, run_workload
    from repro_torch.stream import StreamIngestor

    kernel = FlowConfig("fused_kernel", prune_k=8)
    off = FlowConfig("fused_kernel", prune_k=8, shard="off")
    out: dict = {"rank": dist.shard_rank(mesh, "data")}
    tasks = {m: pipeline.prepare(m, "imdb", device="cpu", **TASK) for m in MODELS}
    with torch.inference_mode():
        for m, task in tasks.items():
            apply = task.model.apply
            _reset(flows, ops)
            out[m, "single"] = apply(task.params, task.batch, kernel).numpy()
            out[m, "single_counts"] = (flows.DISPATCH["sharded_calls"], flows.DISPATCH["mesh_lookups"])
            with dist.set_mesh(mesh):
                _reset(flows, ops)
                with _CountCalls(ops) as calls:
                    out[m, "sharded"] = apply(task.params, task.batch, kernel).numpy()
                out[m, "sharded_counts"] = (
                    flows.DISPATCH["sharded_calls"], flows.DISPATCH["mesh_lookups"],
                    calls.n, flows.DISPATCH["graph_calls"],
                )
                _reset(flows, ops)
                out[m, "off"] = apply(task.params, task.batch, off).numpy()
                out[m, "off_counts"] = (flows.DISPATCH["sharded_calls"], flows.DISPATCH["mesh_lookups"])
                _reset(flows, ops)
                apply(task.params, task.batch, FlowConfig("staged"))
                out[m, "staged_lookups"] = flows.DISPATCH["mesh_lookups"]

    # a session built under the mesh keeps it pinned, inside the block or not
    task = tasks["rgat"]
    with dist.set_mesh(mesh):
        sess = task.compile(kernel)
        out["compile_cached"] = task.compile(kernel) is sess
    out["compile_unsharded_differs"] = task.compile(kernel) is not sess
    out["session_mesh_n"] = sess.mesh_info[2]
    _reset(flows, ops)
    out["session"] = sess(task.params).numpy()
    out["session_counts"] = (flows.DISPATCH["sharded_calls"], flows.DISPATCH["mesh_lookups"])

    # the serving front-end over the sharded session: a fake clock and the
    # inline executor, so every rank forms the same blocks
    fe = ServeFrontend(
        sess, task.params, BatchPolicy(capacities=(1, 4, 8), flush_timeout=1e-3),
        clock=FakeClock(), executor=InlineExecutor(),
    )
    wl = make_workload(11, task.batch.num_targets, size_range=(1, 3), seed=3)
    _reset(flows, ops)
    futs = run_workload(fe, wl)
    out["serve_targets"] = [np.asarray(w.targets) for w in wl]
    out["serve_rows"] = [f.result(0) for f in futs]
    out["serve_counts"] = (flows.DISPATCH["query_calls"], fe.stats.blocks, flows.DISPATCH["mesh_lookups"],
                           flows.DISPATCH["sharded_calls"])

    # ego queries on the sharded session run on one device, pinned to no mesh
    sess.enable_ego(seed=0, sample=8, sample_sizes=(1, 4))
    rng = np.random.default_rng(5)
    queries = [rng.integers(0, task.batch.num_targets, size=s) for s in (1, 2, 4, 4)]
    _reset(flows, ops)
    out["ego_queries"] = queries
    out["ego_rows"] = [sess.query_ego(task.params, q).numpy() for q in queries]
    out["ego_counts"] = (flows.DISPATCH["mesh_lookups"], flows.DISPATCH["sharded_calls"],
                         flows.DISPATCH["ego_calls"] + flows.DISPATCH["ego_fallback"])

    # deltas: prepare under the mesh splits every graph; an ingest's
    # successor keeps the mesh, and its splits equal a cold prepare's
    with dist.set_mesh(mesh):
        dtask = pipeline.prepare("rgat", "imdb", device="cpu", **{**TASK, "max_degree": None})
        out["presplit"] = all((world, 8, 8) in sg._sharded for sg in dtask.sgs)
        dsess = dtask.compile(kernel)
    ing = StreamIngestor(dtask, dsess)
    g = ing.graph
    s_t, rel, d_t = g.relations[0]
    old = {sg.name: sg._sharded[(world, 8, 8)] for sg in ing.sgs}
    rep = ing.ingest({rel: (np.random.default_rng(7).integers(0, g.num_nodes[s_t], 3),
                            np.array([0, 1, 2], dtype=np.int64))})
    out["delta_tier"] = (rep.stats.absorbed_slices, bool(rep.stats.full_rebuild))
    out["successor_mesh"] = ing.session.mesh_info == dsess.mesh_info
    out["clean_split_kept"] = {
        sg.name: sg._sharded[(world, 8, 8)] is old[sg.name] for sg in ing.sgs
    }
    out["delta_logits"] = ing.session(dtask.params).numpy()
    with dist.set_mesh(mesh):
        cold = pipeline.prepare("rgat", ing.graph, device="cpu", **{**TASK, "max_degree": None})
        out["cold_logits"] = cold.compile(kernel)(dtask.params).numpy()
    out["split_vs_cold"] = all(
        _same_split(a._sharded[(world, 8, 8)], b._sharded[(world, 8, 8)])
        for a, b in zip(ing.sgs, cold.sgs)
    )
    return out


def _same_split(a, b) -> bool:
    fields = ("nbr", "msk", "ety", "step_row", "step_dt", "step_ndt", "step_bucket", "caps",
              "caps_pad", "row_targets", "perm")
    return (
        a.num_rows_alloc == b.num_rows_alloc and np.array_equal(a.perm, b.perm)
        and all(np.array_equal(getattr(x, f), getattr(y, f)) for x, y in zip(a.shards, b.shards)
                for f in fields)
    )


def _rank_main(rank: int, world: int, init_file: str, q) -> None:
    try:
        import torch
        import torch.distributed as tdist
        from torch.distributed.device_mesh import init_device_mesh

        torch.set_num_threads(1)
        tdist.init_process_group(
            "gloo", init_method=f"file://{init_file}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120),
        )
        try:
            mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
            q.put((rank, "ok", rank_checks(mesh, world)))
        finally:
            tdist.destroy_process_group()
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))


def spawn(world: int, workdir: str, timeout: float = 240.0, main=None) -> list:
    """Run :func:`rank_checks` (or ``main(rank, world, init_file, q)``,
    a rank program that puts ``(rank, "ok", result)`` or ``(rank, "error",
    traceback)`` on ``q``) on ``world`` gloo ranks; their results in rank
    order. Raises ``RuntimeError`` with the first traceback if a rank
    failed or died, or if the ranks did not finish within ``timeout``
    seconds; every rank is ended before it returns."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    init_file = os.path.join(workdir, f"rendezvous_{world}")
    procs = [ctx.Process(target=main or _rank_main, args=(r, world, init_file, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, error = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and error is None and time.monotonic() < deadline:
            try:
                rank, status, payload = q.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (0, None) for p in procs):
                    error = f"a rank died: exit codes {[p.exitcode for p in procs]}"
                continue
            if status == "ok":
                results[rank] = payload
            else:
                error = payload
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()) if error is None else 0.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
    if error is not None:
        raise RuntimeError(f"{world}-rank run failed:\n{error}")
    if len(results) < world:
        raise RuntimeError(f"{world}-rank run did not finish within {timeout} s")
    return [results[r] for r in range(world)]
