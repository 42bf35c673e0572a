"""step_ms.serve: host milliseconds of the engine's ticks in the window
(the harness's span around each `tick()`, admission, planning, the
replay and the read-back inside it) over the decode steps they ran."""


def read(obs: dict) -> float | None:
    return obs.get("step_ms")
