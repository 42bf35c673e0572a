"""b1_roofline.infer: B1's (the fused MLP's) share of its roofline in a
forward: the least time the card could take for the B1 sites the plan
runs, over the device time of B1's kernels in the profiled forwards.

Each site is a chain of linears on `rows` rows with a ReLU between; it
needs 2 x rows x fan_in x fan_out operations per linear, and reads its
input and weights and writes its output once (bfloat16, 2 bytes an
element); the hidden activations stay on chip.  The bound is the larger
of operations over the bf16 peak and bytes over the HBM bandwidth."""

B1_NAMES = ("mlp_fwd_wgmma", "fused_mlp_kernel", "small_m_kernel")
ELEM = 2


def ops_bytes(rows: int, dims: list) -> tuple[float, float]:
    ops = sum(2.0 * rows * k * n for k, n in dims)
    nbytes = ELEM * (rows * dims[0][0] + sum(k * n for k, n in dims) + rows * dims[-1][1])
    return ops, nbytes


def bound_s(sites: list, peaks: dict) -> float:
    total = 0.0
    for s in sites:
        ops, nbytes = ops_bytes(s["rows"], s["dims"])
        total += max(ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_s"])
    return total


def read(obs: dict) -> float | None:
    tr, sites = obs.get("trace"), obs.get("b1_sites")
    if tr is None or not sites:
        return None
    t = tr.op_seconds(lambda n: any(k in n for k in B1_NAMES)) / tr.units["forwards"]
    if t <= 0:
        return None
    return 100.0 * bound_s(sites, obs["peaks"]) / t
