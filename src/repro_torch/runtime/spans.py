"""Host phases of the port's hot paths, on the host clock and, while a
`torch.profiler` records, on the profiler's timeline too.

`Phases(layer, names)` keeps, per phase name, the seconds spent inside
`span(name)` (`time.perf_counter`, two reads a span); its owner reports
them through its own `stats()`, beside the one count of its layer that it
already keeps (ticks, runs, replays).  The timing is always on.  Only
while a profiler records does a span also open a range named
`repro_torch.<layer>.<name>`, so that a trace shows the phase on the
profiler's clock, around the device work it launched; otherwise the span
pays one read of the profiler's own is-enabled flag.  The range is a host
range (`_RecordFunctionFast`): a `record_function` range would also show
on the device's timeline, as an annotation over the kernels launched
inside it, which a reader of the device's ops would count as device work.
"""
from __future__ import annotations

import time
from typing import Iterable

import torch
from torch.autograd import profiler as _profiler

_HostRange = torch._C._profiler._RecordFunctionFast


class _Span:
    __slots__ = ("phases", "name", "t0", "range")

    def __init__(self, phases: "Phases", name: str):
        self.phases, self.name, self.range = phases, name, None

    def __enter__(self) -> None:
        if _profiler._is_profiler_enabled:
            self.range = _HostRange(f"repro_torch.{self.phases.layer}.{self.name}")
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        self.phases.seconds[self.name] += time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class Phases:
    """Seconds inside the named phases of one layer (a span of another
    name raises KeyError as it closes)."""

    def __init__(self, layer: str, names: tuple[str, ...]):
        self.layer = layer
        self.seconds = dict.fromkeys(names, 0.0)

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def stats(self) -> dict[str, float]:
        """`<name>_s`: the seconds inside each phase."""
        return {name + "_s": s for name, s in self.seconds.items()}


def summed(phases: Iterable[Phases], names: tuple[str, ...]) -> dict[str, float]:
    """The `stats()` of several `Phases` over `names`, added up."""
    out = dict.fromkeys((name + "_s" for name in names), 0.0)
    for ph in phases:
        for name, s in ph.seconds.items():
            out[name + "_s"] += s
    return out
