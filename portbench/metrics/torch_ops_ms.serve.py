"""torch_ops_ms.serve: device milliseconds per decode step in operations
that are not the program's own kernels (PyTorch's and cuBLAS's: the
projections, norms, rope, the LM head, copies), in the profiled ticks."""
from portbench import bench


def read(obs: dict) -> float | None:
    tr = obs.get("trace")
    if tr is None or not tr.units.get("steps"):
        return None
    return 1e3 * tr.op_seconds(lambda n: not bench.is_port_kernel(n)) / tr.units["steps"]
