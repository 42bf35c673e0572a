"""occupancy.multiturn: the mean share of the engine's slots that hold a
request in a tick of the window (those left after it, plus those it
finished)."""


def read(obs: dict) -> float | None:
    return obs.get("occupancy")
