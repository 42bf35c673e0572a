"""b2_roofline.serve: B2's (the fused SwiGLU MLP's small-M form, with the
queue_reduce fold of its partials) share of its roofline in the profiled
decode steps.

Every decode step runs one B2 launch per layer on all `batch` slots'
rows.  A launch needs 2 x rows x (2 x d x f + f x d) operations and
reads x and the three weight matrices and writes y once (bfloat16, 2
bytes an element); the bound is the larger of operations over the bf16
peak and bytes over the HBM bandwidth."""

B2_NAMES = ("small_m_kernel", "queue_reduce_kernel", "mlp_fwd_wgmma", "fused_mlp_kernel")
ELEM = 2


def ops_bytes(rows: int, d: int, f: int) -> tuple[float, float]:
    ops = 2.0 * rows * 3 * d * f
    nbytes = ELEM * (3 * d * f + 2 * rows * d)
    return ops, nbytes


def bound_s(rows: int, d: int, f: int, peaks: dict) -> float:
    ops, nbytes = ops_bytes(rows, d, f)
    return max(ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_s"])


def read(obs: dict) -> float | None:
    tr = obs.get("trace")
    if tr is None or not tr.units.get("steps"):
        return None
    t = tr.op_seconds(lambda n: any(k in n for k in B2_NAMES))
    if t <= 0:
        return None
    cfg = obs["config"]
    one = bound_s(obs["serve"]["batch"], cfg["hidden_size"], cfg["intermediate_size"],
                  obs["peaks"])
    return 100.0 * one * cfg["num_hidden_layers"] * tr.units["steps"] / t
