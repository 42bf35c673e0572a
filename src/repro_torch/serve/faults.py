"""Fault model for the serving subsystem: structured errors + a seeded,
scriptable fault injector.

The paged engine runs every tick as ONE fused program over the whole slot
batch (the Kitsune dataflow shape), so a single poison request -- a NaN in
the logits, a pool-exhaustion race, a failing step -- would halt or corrupt
every co-tenant unless the engine can isolate, fail, and keep ticking.
This module provides the two halves of a *tested* failure model:

  * `EngineError` and friends: every request that terminates abnormally
    carries a structured error naming the fault SITE, the engine TICK it
    fired on, and the culpable request id -- never a bare RuntimeError.

  * `FaultInjector`: a deterministic (seeded) injector with NAMED SITES
    threaded through the stack.  `ServeConfig.fault_plan` installs one in
    the engine; tests and the chaos bench script exact failure schedules
    (fire at tick 7, fire on the 3rd alloc, fire with probability p) and
    then assert the engine's behaviour differentially: survivors must stay
    bitwise identical to a fault-free run.

Sites (see docs/SERVING.md "Failure model" for semantics):

    pool.alloc        BlockPool.alloc raises OutOfBlocks
    tick.step         the compiled tick raises before executing
    tick.logits       decode logits corrupted to NaN/Inf for one slot
    prefill.chunk     one slot's prefill chunk fails transiently
    executor.profile  the capacity profiling pass OOMs
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

SITES = ("pool.alloc", "tick.step", "tick.logits", "prefill.chunk",
         "executor.profile")


class EngineError(RuntimeError):
    """A request (or the engine) failed at a named fault site.

    Attributes: `site` (one of SITES or an engine-internal site like
    "engine.degraded"), `tick` (engine tick number when it fired, -1 when
    outside the tick loop), `rid` (culpable request id, None for
    engine-scoped errors)."""

    def __init__(self, message: str, *, site: str | None = None,
                 tick: int = -1, rid: int | None = None):
        super().__init__(message)
        self.site = site
        self.tick = tick
        self.rid = rid

    def __repr__(self) -> str:  # str() stays the bare message
        return (f"{type(self).__name__}({str(self)!r}, site={self.site!r}, "
                f"tick={self.tick}, rid={self.rid})")


class DeadlineExceeded(EngineError):
    """The request's deadline passed while queued or in flight."""


class QueueFull(EngineError):
    """Admission backpressure: the bounded waiting queue is at capacity."""


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: WHERE (`site`), WHEN (`ticks` are engine tick
    numbers; `hits` are 0-based per-site probe indices; `p` a seeded
    per-probe probability -- any match fires), and optionally WHO (`rid`
    pins blame/corruption to a specific request where the site supports
    targeting).  With no schedule at all the spec fires on EVERY probe
    (useful for unit tests of a single site).  `mode` selects the payload
    at `tick.logits` ("nan" | "inf")."""

    site: str
    ticks: tuple[int, ...] = ()
    hits: tuple[int, ...] = ()
    p: float = 0.0
    rid: int | None = None
    mode: str = "nan"

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {', '.join(SITES)}")
        if self.mode not in ("nan", "inf"):
            raise ValueError(f"mode must be 'nan' or 'inf', got {self.mode!r}")

    @property
    def unconditional(self) -> bool:
        return not self.ticks and not self.hits and self.p == 0.0


@dataclass
class FaultInjector:
    """Deterministic fault scheduler.  The engine calls `advance(tick)` at
    the top of every tick and `check(site)` at each instrumented point;
    `check` returns the matching FaultSpec (recording it in `history`) or
    None.  Probabilistic specs draw from ONE seeded stream, so a given
    (plan, seed) always produces the same schedule."""

    plan: tuple[FaultSpec, ...] = ()
    seed: int = 0
    now: int = -1                                   # current engine tick
    history: list[dict] = field(default_factory=list)

    def __post_init__(self):
        self.plan = tuple(self.plan)
        self._rng = random.Random(self.seed)
        self._hits: dict[str, int] = {}             # site -> probe count

    def advance(self, tick: int) -> None:
        self.now = tick

    def check(self, site: str) -> FaultSpec | None:
        """Probe `site`; return the firing spec (and log it) or None."""
        k = self._hits.get(site, 0)
        self._hits[site] = k + 1
        for spec in self.plan:
            if spec.site != site:
                continue
            if (spec.unconditional or self.now in spec.ticks
                    or k in spec.hits
                    or (spec.p > 0.0 and self._rng.random() < spec.p)):
                self.history.append({"site": site, "tick": self.now,
                                     "hit": k, "rid": spec.rid})
                return spec
        return None

    def fired(self, site: str | None = None) -> int:
        if site is None:
            return len(self.history)
        return sum(1 for h in self.history if h["site"] == site)


def parse_fault_plan(text: str) -> tuple[FaultSpec, ...]:
    """Parse a CLI fault plan: comma-separated `site@tick[&tick...][:rid=N]
    [:mode=inf]` entries, e.g.

        tick.step@4,tick.logits@6:rid=3:mode=nan,pool.alloc@7&8

    `site@*` fires on every probe."""
    specs = []
    for entry in filter(None, (e.strip() for e in text.split(","))):
        head, *opts = entry.split(":")
        if "@" not in head:
            raise ValueError(f"fault entry {entry!r} needs site@ticks")
        site, when = head.split("@", 1)
        ticks = () if when == "*" else tuple(int(t) for t in when.split("&"))
        kw: dict = {"site": site, "ticks": ticks}
        for opt in opts:
            key, _, val = opt.partition("=")
            if key == "rid":
                kw["rid"] = int(val)
            elif key == "mode":
                kw["mode"] = val
            elif key == "p":
                kw["p"] = float(val)
            else:
                raise ValueError(f"unknown fault option {opt!r}")
        specs.append(FaultSpec(**kw))
    return tuple(specs)
