"""mfu.serve: a decode step's share of the card's bf16 peak: the operations
of the active slots' tokens (the linears, the LM head, and attention over
each one's context), averaged over the profiled ticks' steps, over
`step_ms.serve` (the window's time a step, the profiler off), over the
peak."""


def step_flops(cfg: dict, active: int, valid: list) -> float:
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    per_layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * f
    linears = 2.0 * active * (cfg["num_hidden_layers"] * per_layer + d * v)
    attention = 4.0 * cfg["num_hidden_layers"] * hq * hd * sum(sorted(valid)[-active:]) \
        if active else 0.0
    return linears + attention


def read(obs: dict) -> float | None:
    ticks, step_ms = obs.get("slice_ticks"), obs.get("step_ms")
    steps = sum(t["steps"] for t in ticks or [])
    if obs.get("trace") is None or not steps or not step_ms:
        return None
    flops = sum(t["steps"] * step_flops(obs["config"], t["active"], t["valid"])
                for t in ticks) / steps
    return 100.0 * flops / (step_ms * 1e-3) / obs["peaks"]["bf16_flops"]
