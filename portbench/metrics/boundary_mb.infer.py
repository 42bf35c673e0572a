"""boundary_mb.infer: megabytes crossing the compiled plan's program
boundaries in one forward (`ExecutionReport.bytes_accessed`, the
program's count from tensor shapes, not a device counter)."""


def read(obs: dict) -> float | None:
    b = obs.get("boundary_bytes")
    return None if b is None else b / 1e6
