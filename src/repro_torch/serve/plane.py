"""``WeightPlane`` — several parameter versions behind ONE session.

A session's program is specialized to the parameters' names, shapes and
dtypes (``core.session.param_spec``), not to their values — so every
param version with a matching spec (A/B arms, per-tenant fine-tunes, a
freshly trained checkpoint) can share the same captured program. The
plane is the registry enforcing that: ``publish`` validates a version
against the reference spec ONCE, loudly, so a mismatched tenant fails at
publish time instead of mid-traffic.

``stream=True`` is the weight-streaming mode paired with a
``donate_params=True`` session: ``publish`` snapshots one host copy per
tensor (pinned when the plane's device is a card), and ``checkout``
materializes fresh device tensors per block through ``non_blocking``
copies, enqueued on the caller's current stream — at any moment roughly
one tenant's weights occupy device memory instead of all of them. With
``stream=False`` (default) versions are stored as given and ``checkout``
is a dict lookup.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from repro_torch.core.session import param_spec
from repro_torch.serve.health import TenantUnpublishedError


def param_avals(params) -> Tuple:
    """Hashable (name, shape, dtype) identity of a flat params mapping —
    the compatibility contract two versions must share to be served by
    one session (the port's ``session.param_spec``)."""
    return param_spec(params)


def _device_of(params: Mapping) -> torch.device:
    for t in params.values():
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


class WeightPlane:
    """Named parameter versions, all spec-compatible with a reference.
    ``device`` is where ``checkout`` puts streamed versions (default: the
    reference params' device)."""

    def __init__(self, reference_params, stream: bool = False, device=None):
        self.stream = bool(stream)
        self.device = torch.device(device) if device is not None else _device_of(reference_params)
        self._ref_avals = param_avals(reference_params)
        self._versions: Dict[str, object] = {}

    def publish(self, tenant: str, params) -> None:
        """Install/replace ``tenant``'s weights (validated against the
        reference spec). In stream mode the plane snapshots HOST copies,
        so a later change to the caller's tensors never reaches a block."""
        avals = param_avals(params)
        if avals != self._ref_avals:
            raise ValueError(
                f"tenant {tenant!r} params are not aval-compatible with "
                f"this plane's session: {_aval_diff(self._ref_avals, avals)}"
            )
        if self.stream:
            pin = self.device.type == "cuda"
            params = {n: _host_copy(t, pin) for n, t in params.items()}
        self._versions[tenant] = params

    def unpublish(self, tenant: str) -> None:
        """Delete ``tenant``'s weights. A block already queued for this
        tenant fails at checkout with
        :class:`~repro_torch.serve.health.TenantUnpublishedError` — the
        supervised stepper fails that block's futures and keeps serving
        (the submit→checkout race is a first-class, tested failure
        mode, not a crash)."""
        if tenant not in self._versions:
            raise KeyError(
                f"unknown tenant {tenant!r}; published: {sorted(self._versions)}"
            )
        del self._versions[tenant]

    def checkout(self, tenant: str):
        """The params to run ``tenant``'s next block with. Stream mode
        returns FRESH device tensors (``non_blocking`` copies from the host
        snapshot); resident mode returns the stored mapping. Raises
        ``TenantUnpublishedError`` (a ``KeyError`` subclass) when the
        tenant was never published or was unpublished after submit."""
        try:
            params = self._versions[tenant]
        except KeyError:
            raise TenantUnpublishedError(
                f"unknown tenant {tenant!r} (unpublished?); published: "
                f"{sorted(self._versions)}"
            ) from None
        if self.stream:
            return {n: t.to(self.device, non_blocking=True, copy=True) for n, t in params.items()}
        return params

    def version_token(self, tenant: str) -> int:
        """Opaque token identifying ``tenant``'s currently-published
        version — changes on every ``publish``, stable across ``checkout``
        calls (which, in stream mode, return fresh tensors each time).
        Raises :class:`~repro_torch.serve.health.TenantUnpublishedError`
        like ``checkout``."""
        try:
            return id(self._versions[tenant])
        except KeyError:
            raise TenantUnpublishedError(
                f"unknown tenant {tenant!r} (unpublished?); published: "
                f"{sorted(self._versions)}"
            ) from None

    def tenants(self) -> List[str]:
        return sorted(self._versions)

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._versions

    def __len__(self) -> int:
        return len(self._versions)


def _host_copy(t, pin: bool) -> torch.Tensor:
    """One host copy of ``t`` (a tensor or an array), pinned if ``pin``."""
    t = torch.as_tensor(t).detach()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    host.copy_(t)
    return host


class GraphPlane:
    """Monotonically versioned GRAPH sessions behind one serving handle.

    The structural sibling of :class:`WeightPlane`: where the weight
    plane routes blocks across parameter versions of one graph, the
    graph plane swaps the graph itself. A streamed-delta ingestor
    (``repro_torch.stream.StreamIngestor``) merges version ``v``'s layouts
    into ``v + 1``, builds a successor ``InferenceSession`` over them, and
    ``publish``-es it; serving code resolves the session once per query
    block via :meth:`checkout`.

    Checkout semantics — the serving-parity contract: a block that
    checked out version ``v`` runs to completion on ``v`` even if
    ``v + 1`` publishes mid-flight (the old session, layouts, and device
    tables stay alive for exactly as long as some block still references
    them — plain refcounting, no epoch bookkeeping; on a card the session
    hands their memory back only after its last replay has ended). New
    arrivals pick up ``v + 1`` at their own checkout. No request is ever failed or
    stranded by a version swap.

    ``publish`` validates the successor's ``out_shape`` against the
    plane's reference (deltas are additive-only, so a shape change means
    the caller swapped in a different task's session) and prewarms the
    registered query-capacity ladder BEFORE taking the swap lock, and the
    swap itself is a pointer assignment.
    """

    def __init__(self, session):
        self._lock = threading.Lock()
        self._session = session
        self._version = 0
        self._out_shape = tuple(session.out_shape)
        self._capacities: Tuple[int, ...] = ()

    def register_capacities(self, capacities: Sequence[int]) -> None:
        """Declare the query-block capacity ladder every published session
        must have prewarmed (the serving ``BatchPolicy``'s capacities).
        The current session is prewarmed immediately; future ``publish``
        calls prewarm the successor before the swap."""
        caps = tuple(sorted({int(c) for c in capacities}))
        session = self.current()
        self._capacities = caps
        if caps:
            session.prewarm(caps)

    def publish(self, session) -> int:
        """Install ``session`` as the next graph version and return its
        version number. Validates ``out_shape`` against the reference and
        prewarms the registered capacity ladder outside the swap lock."""
        shape = tuple(session.out_shape)
        if shape != self._out_shape:
            raise ValueError(
                f"successor session out_shape {shape} does not match this "
                f"plane's reference {self._out_shape} — graph deltas are "
                "additive-only, so a published successor must serve the "
                "same target set and class count"
            )
        if self._capacities:
            session.prewarm(self._capacities)
        with self._lock:
            self._version += 1
            self._session = session
            return self._version

    def checkout(self):
        """The ``(version, session)`` pair to run one query block with —
        one atomic read; the block holds the session reference (NOT the
        plane) for its whole lifetime, so a mid-flight publish never
        retargets it."""
        with self._lock:
            return self._version, self._session

    def current(self):
        """The currently published session (convenience over
        :meth:`checkout` when the version number is not needed)."""
        with self._lock:
            return self._session

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return self._out_shape


def _aval_diff(ref: Tuple, got: Tuple) -> str:
    want = {n: (s, d) for n, s, d in ref}
    have = {n: (s, d) for n, s, d in got}
    if set(want) != set(have):
        return (
            f"parameter names differ: missing {sorted(set(want) - set(have))}, "
            f"unexpected {sorted(set(have) - set(want))}"
        )
    bad = [f"{n}: {want[n]} vs {have[n]}" for n in sorted(want) if want[n] != have[n]]
    return "leaf avals differ: " + "; ".join(bad[:3])
