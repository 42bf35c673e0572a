"""host_ms.infer: mean host milliseconds of one `CompiledApp.run` call
with the device's queue empty (a synchronise before each, none inside the
span): what the executor and the replay cost the host to enqueue a
forward.  In the window the host runs ahead and blocks on a full launch
queue, so a span there would read the device's pace."""


def read(obs: dict) -> float | None:
    return obs.get("host_ms")
