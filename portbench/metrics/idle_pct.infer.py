"""idle_pct.infer: the share of the profiled forwards (run back to back) in
which no operation runs on the card, from the profiler's timeline.  The
profiler stretches a forward by ~1 % here, so this reads a little
high; against the unprofiled forward it would read within noise of 0."""


def read(obs: dict) -> float | None:
    tr = obs.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
