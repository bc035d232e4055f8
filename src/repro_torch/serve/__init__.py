"""Async microbatching serving front-end over ``InferenceSession``.

The request-scale layer, the reference's ``repro.serve`` name for name:
concurrent target-vertex queries are collected into padded
capacity-bucketed query blocks (a fixed capacity ladder, so the session
never meets a new block shape), stepped through a double-buffered
collector/stepper loop, and routed across tenant weight versions sharing
ONE session (on a card, one captured CUDA graph). Fault-tolerant by
contract: bounded admission, per-request deadlines, query ids checked on
the host at submit, a supervised stepper with retry + circuit-breaker
degradation to a prewarmed fallback flow, loops that end at ``close``
even when their drain keeps failing, and a deterministic fault-injection
seam (``FaultPlan``). The design notes are the reference's
``src/repro/serve/README.md``; ``frontend.py`` says what the card changes.
"""
from repro_torch.serve.clock import (
    Clock,
    FakeClock,
    InlineExecutor,
    SystemClock,
    ThreadExecutor,
)
from repro_torch.serve.faults import FaultContext, FaultPlan, FaultRule
from repro_torch.serve.frontend import ServeFrontend, ServeStats
from repro_torch.serve.health import (
    CircuitBreaker,
    DeadlineExceededError,
    FlushTimeout,
    HealthReport,
    QueueFullError,
    ServeClosedError,
    ServeError,
    StepperDiedError,
    SupervisorPolicy,
    TenantUnpublishedError,
    TransientDispatchError,
)
from repro_torch.serve.load import Workload, make_workload, run_serial, run_workload
from repro_torch.serve.plane import GraphPlane, WeightPlane, param_avals
from repro_torch.serve.queueing import (
    BatchPolicy,
    QueryBlock,
    Request,
    RequestQueue,
    ServeFuture,
    tune_capacities,
)

__all__ = [
    "BatchPolicy",
    "CircuitBreaker",
    "Clock",
    "DeadlineExceededError",
    "FakeClock",
    "FaultContext",
    "FaultPlan",
    "FaultRule",
    "FlushTimeout",
    "GraphPlane",
    "HealthReport",
    "InlineExecutor",
    "QueryBlock",
    "QueueFullError",
    "Request",
    "RequestQueue",
    "ServeClosedError",
    "ServeError",
    "ServeFrontend",
    "ServeFuture",
    "ServeStats",
    "StepperDiedError",
    "SupervisorPolicy",
    "SystemClock",
    "TenantUnpublishedError",
    "ThreadExecutor",
    "TransientDispatchError",
    "WeightPlane",
    "Workload",
    "make_workload",
    "param_avals",
    "run_serial",
    "run_workload",
    "tune_capacities",
]
