"""idle_pct.serve: the share of a decode step in which no operation runs on
the card: one less the device's busy time a step in the profiled ticks
(the union of its ops on the profiler's timeline) over `step_ms.serve`,
the window's host time a step with the profiler off.  The profiled slice's
own length is not used: under the profiler a replayed tick of ~1300
kernels stretches by a third, and that stretch is the profiler's."""


def read(obs: dict) -> float | None:
    tr, step_ms = obs.get("trace"), obs.get("step_ms")
    if tr is None or not step_ms or not tr.units.get("steps"):
        return None
    busy_ms = 1e3 * tr.busy_s() / tr.units["steps"]
    return 100.0 * (1.0 - busy_ms / step_ms)
