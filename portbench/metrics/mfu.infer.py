"""mfu.infer: the whole forward's share of the card's bf16 peak: the
operations one forward needs (2 x M x fan_in x fan_out over the
configuration's linears, reference/nerf.py `flops`) over the time of a
forward in the traced run's window (the profiler off), over the peak.  The
run is only read where the profiler traced the card."""
from portbench.reference import nerf


def read(obs: dict) -> float | None:
    if obs.get("trace") is None or not obs.get("infer_ms"):
        return None
    return 100.0 * nerf.flops(obs["config"], obs["points"]) / (obs["infer_ms"] * 1e-3) / \
        obs["peaks"]["bf16_flops"]
