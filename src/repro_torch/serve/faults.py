"""``FaultPlan`` — the deterministic fault-injection seam.

Chaos testing that sleeps and hopes is flaky; this plan is a COUNTED
script. The front-end calls ``plan.fire(site, ctx)`` at three fixed
points of the drain → dispatch → resolve core:

  * ``"checkout"`` — before ``plane.checkout`` (inject tenant-unpublish
    races: a rule callback deletes the tenant the block is about to
    check out);
  * ``"dispatch"`` — before ``session.query`` (inject transient/fatal
    dispatch exceptions and slow blocks; ``ctx.engine`` distinguishes
    the primary flow from the fallback, so a plan can fail the primary
    while leaving the degradation path healthy);
  * ``"drain"`` — before the collector drains the queue (poison the
    collector and assert it survives).

Rules fire deterministically: each rule counts the events matching its
``site``/``tenant``/``engine`` filters, skips the first ``after``, fires
on the next ``times`` (``None`` = forever), and then goes inert. Delay
actions sleep on the INJECTED clock — with ``FakeClock`` a "slow block"
advances virtual time instantly, so deadline storms and breaker cooldowns
are exact, sleep-free functions of the plan. Every firing is recorded in
``plan.injected`` for assertions.

Queue saturation and deadline storms need no seam at all: they are just a
bounded queue plus a submit burst, and ``submit(timeout=...)`` plus a
slow block — see the reference's ``benchmarks/serve_chaos.py`` for the
full taxonomy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.serve.health import TransientDispatchError

SITES = ("checkout", "dispatch", "drain")


@dataclasses.dataclass
class FaultContext:
    """What a site exposes to a firing rule."""

    site: str
    clock: object
    frontend: object = None
    tenant: Optional[str] = None
    block: object = None
    engine: Optional[str] = None  # "primary" | "fallback" at dispatch sites


@dataclasses.dataclass
class FaultRule:
    site: str
    action: Callable[[FaultContext], None]
    tenant: Optional[str] = None      # None matches any tenant
    engine: Optional[str] = None      # None matches primary AND fallback
    after: int = 0                    # skip this many matching events
    times: Optional[int] = 1          # fire on the next N (None = forever)
    label: str = ""
    hits: int = 0                     # matching events seen (fired or not)
    fired: int = 0

    def __post_init__(self):
        assert self.site in SITES, f"unknown fault site {self.site!r}"
        assert self.after >= 0
        assert self.times is None or self.times >= 1

    def matches(self, ctx: FaultContext) -> bool:
        return (
            ctx.site == self.site
            and (self.tenant is None or ctx.tenant == self.tenant)
            and (self.engine is None or ctx.engine == self.engine)
        )

    def should_fire(self) -> bool:
        """Call once per matching event; True when this event fires."""
        self.hits += 1
        n = self.hits - self.after
        if n < 1 or (self.times is not None and n > self.times):
            return False
        self.fired += 1
        return True


class FaultPlan:
    """An ordered script of :class:`FaultRule`\\ s. Rules are evaluated in
    registration order; a raising action aborts the event (later rules
    don't see it), exactly like the real exception would."""

    def __init__(self):
        self.rules: List[FaultRule] = []
        self.injected: List[Tuple[str, str]] = []  # (site, label) log

    def add(self, rule: FaultRule) -> FaultRule:
        self.rules.append(rule)
        return rule

    # -- rule builders ------------------------------------------------------
    def fail(
        self,
        site: str,
        exc: BaseException = None,
        *,
        tenant: Optional[str] = None,
        engine: Optional[str] = None,
        after: int = 0,
        times: Optional[int] = 1,
        label: str = "",
    ) -> FaultRule:
        """Raise ``exc`` (an exception INSTANCE, re-raised each firing; a
        fresh ``TransientDispatchError`` by default) at ``site``."""
        if exc is None:
            exc = TransientDispatchError("injected transient fault")

        def action(ctx: FaultContext) -> None:
            raise exc

        return self.add(FaultRule(
            site, action, tenant=tenant, engine=engine, after=after,
            times=times, label=label or f"fail:{type(exc).__name__}",
        ))

    def delay(
        self,
        site: str,
        dt: float,
        *,
        tenant: Optional[str] = None,
        engine: Optional[str] = None,
        after: int = 0,
        times: Optional[int] = 1,
        label: str = "",
    ) -> FaultRule:
        """Sleep ``dt`` on the injected clock at ``site`` — a slow block
        under ``FakeClock`` advances virtual time with zero real sleep."""

        def action(ctx: FaultContext) -> None:
            ctx.clock.sleep(dt)

        return self.add(FaultRule(
            site, action, tenant=tenant, engine=engine, after=after,
            times=times, label=label or f"delay:{dt}",
        ))

    def call(
        self,
        site: str,
        fn: Callable[[FaultContext], None],
        *,
        tenant: Optional[str] = None,
        engine: Optional[str] = None,
        after: int = 0,
        times: Optional[int] = 1,
        label: str = "",
    ) -> FaultRule:
        """Run an arbitrary callback at ``site`` (e.g. unpublish the
        tenant the block is about to check out)."""
        return self.add(FaultRule(
            site, fn, tenant=tenant, engine=engine, after=after,
            times=times, label=label or getattr(fn, "__name__", "call"),
        ))

    # -- the seam the front-end calls ---------------------------------------
    def fire(self, site: str, ctx: FaultContext) -> None:
        assert site in SITES, f"unknown fault site {site!r}"
        for rule in self.rules:
            if rule.matches(ctx) and rule.should_fire():
                self.injected.append((site, rule.label))
                rule.action(ctx)

    def count(self, site: Optional[str] = None) -> int:
        """Injected-fault count, optionally filtered by site."""
        return sum(1 for s, _ in self.injected if site is None or s == site)
