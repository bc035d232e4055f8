"""Deterministic load generation — shared by the load-test harness
(``tests/test_torch_serve.py``) and ``chip_smoke.py``'s serving phase, so
both exercise and report the SAME traffic; the draws are the reference's
(``repro.serve.load``, which its ``benchmarks/serve_load.py`` and
``examples/hgnn_serve.py`` replay), so a seed gives the same workload in
both packages.

``make_workload`` draws an open-loop request stream from a seeded RNG:
per-request target ids, request sizes, tenant assignment, and Poisson
arrival offsets (``rate=None`` → everything arrives at t0, the
saturation/backlog regime). ``run_workload`` replays it through a
front-end, pacing arrivals on the front-end's clock — with a
``FakeClock`` the paced replay runs instantly but stamps honest arrival
times, so latency percentiles are exact functions of the seed.

``run_serial`` is the comparison baseline: the synchronous
one-request-at-a-time loop (one padded query dispatch per request — the
pre-front-end ``examples/hgnn_serve.py`` behavior), measured with the
same per-request latency accounting. Each request's rows are read back to
the host before the next is dispatched.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.frontend import ServeFrontend, ServeStats
from repro_torch.serve.queueing import BatchPolicy, ServeFuture


@dataclasses.dataclass(frozen=True)
class Workload:
    """One request: arrival offset (seconds from stream start), tenant,
    and the target-id vector queried."""

    t_offset: float
    tenant: str
    targets: np.ndarray


def make_workload(
    n_requests: int,
    num_targets: int,
    rate: Optional[float] = None,
    size_range: Tuple[int, int] = (1, 4),
    tenants: Sequence[str] = ("default",),
    seed: int = 0,
) -> List[Workload]:
    """Seeded open-loop stream: sizes uniform in ``size_range``
    (inclusive), ids uniform over ``range(num_targets)``, tenants
    round-robin-shuffled, arrivals Poisson at ``rate`` req/s (``None`` →
    all at t=0)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(size_range[0], size_range[1] + 1, size=n_requests)
    if rate is None:
        offsets = np.zeros(n_requests)
    else:
        offsets = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    tenant_ids = rng.integers(0, len(tenants), size=n_requests)
    return [
        Workload(
            t_offset=float(offsets[i]),
            tenant=tenants[int(tenant_ids[i])],
            targets=rng.integers(0, num_targets, size=int(sizes[i])).astype(
                np.int32
            ),
        )
        for i in range(n_requests)
    ]


def run_workload(
    frontend: ServeFrontend, workload: Sequence[Workload]
) -> List[ServeFuture]:
    """Replay ``workload`` through the front-end, pacing arrivals on its
    clock, then flush. Inline front-ends are pumped between arrivals (the
    collector's role, driven deterministically); threaded front-ends just
    receive the paced submits. Returns the futures in workload order —
    all completed after the final flush."""
    clock = frontend.clock
    inline = not frontend.executor.threaded
    t0 = clock.now()
    futures: List[ServeFuture] = []
    for w in workload:
        dt = (t0 + w.t_offset) - clock.now()
        if dt > 0:
            if inline:
                # serve what the elapsed time matured before sleeping past
                # it (the collector would have woken on this deadline)
                frontend.pump()
            clock.sleep(dt)
        futures.append(frontend.submit(w.targets, tenant=w.tenant))
        if inline:
            frontend.pump()
    frontend.flush()
    return futures


def run_serial(
    session, plane, workload: Sequence[Workload],
    policy: BatchPolicy, clock,
) -> Tuple[List[np.ndarray], ServeStats]:
    """The one-request-at-a-time baseline: every request pays its own
    padded query dispatch (capacity = the ladder's tightest fit for that
    single request) under its tenant's weights. Same session, same
    padding discipline — the measured delta vs the front-end is purely
    the microbatching."""
    from repro_torch.serve.frontend import _host_rows, _stage
    from repro_torch.serve.plane import WeightPlane
    from repro_torch.serve.queueing import RequestQueue

    if not isinstance(plane, WeightPlane):
        wrapped = WeightPlane(plane, stream=session.donate_params)
        wrapped.publish("default", plane)
        plane = wrapped
    stats = ServeStats()
    q = RequestQueue()  # reuse the same pack/pad code path, one req each
    outs: List[np.ndarray] = []
    t0 = clock.now()
    for w in workload:
        dt = (t0 + w.t_offset) - clock.now()
        if dt > 0:
            clock.sleep(dt)
        stats.on_submit(clock.now())
        q.put(w.targets, w.tenant, clock.now(), policy.max_batch)
        (blk,) = q.drain(policy, clock.now(), force=True)
        params = plane.checkout(blk.tenant)
        # serial baseline measures E2E: wait for this request's rows
        rows = _host_rows(_stage(session.query(params, blk.idx)))
        outs.append(rows[: blk.n_valid])
        stats.on_block(blk, clock.now())
    return outs, stats
