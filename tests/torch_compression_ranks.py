"""The rank program of ``tests/test_torch_lm_train_runtime.py``'s
``compressed_psum`` check: :func:`spawn` starts ``world`` processes
(``spawn`` start method), each a ``gloo`` rank on the CPU over a
``file://`` rendezvous, and each returns ``compressed_psum`` of its own
seeded vector. A rank that raises sends its traceback; the ranks are ended
when the join timeout runs out. Imports neither JAX nor the reference."""
from __future__ import annotations

import multiprocessing
import os
import queue
import time
import traceback

import numpy as np


def rank_input(rank: int, n: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).normal(size=(n,)).astype(np.float32) * (rank + 1)


def _rank_main(rank: int, world: int, init_file: str, n: int, q) -> None:
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.distributed.compression import compressed_psum

        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
        try:
            out = compressed_psum(torch.from_numpy(rank_input(rank, n)))
        finally:
            dist.destroy_process_group()
        q.put((rank, "ok", out.numpy()))
    except Exception:  # the parent raises with this traceback
        q.put((rank, "error", traceback.format_exc()))


def spawn(world: int, workdir: str, n: int, timeout: float = 120.0) -> list:
    """``compressed_psum`` on ``world`` gloo ranks; each rank's result in
    rank order. Raises ``RuntimeError`` if a rank failed, died or did not
    finish within ``timeout`` seconds; every rank is ended before it
    returns."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    init_file = os.path.join(workdir, f"rendezvous_{world}")
    procs = [ctx.Process(target=_rank_main, args=(r, world, init_file, n, q), daemon=True) for r in range(world)]
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
