"""b8_roofline.serve: B8's (paged flash decode's, with the combine of its
split partials) share of its roofline in the profiled decode steps.

Per layer and step, each slot's query (Hq heads of D) attends its valid
rows: it reads the K and V rows its valid length covers (Hkv x D each,
bfloat16) and its query, and writes its output, once; it needs 4 x valid
x Hq x D operations.  A slot's valid length is its position after the
tick (1 for an idle slot), which the harness reads from the engine."""

B8_NAMES = ("paged_decode_kernel", "decode_combine_kernel")
ELEM = 2


def ops_bytes(valid: list, hq: int, hkv: int, d: int) -> tuple[float, float]:
    rows = sum(valid)
    ops = 4.0 * rows * hq * d
    nbytes = ELEM * (2 * rows * hkv * d + 2 * len(valid) * hq * d)
    return ops, nbytes


def read(obs: dict) -> float | None:
    tr = obs.get("trace")
    ticks = obs.get("slice_ticks")
    if tr is None or not ticks:
        return None
    t = tr.op_seconds(lambda n: any(k in n for k in B8_NAMES))
    if t <= 0:
        return None
    cfg, pk = obs["config"], obs["peaks"]
    bound = 0.0
    for tick in ticks:
        ops, nbytes = ops_bytes(tick["valid"], cfg["num_attention_heads"],
                                cfg["num_key_value_heads"], cfg["head_dim"])
        one = max(ops / pk["bf16_flops"], nbytes / pk["hbm_bytes_s"])
        bound += one * cfg["num_hidden_layers"] * tick["steps"]
    return 100.0 * bound / t
