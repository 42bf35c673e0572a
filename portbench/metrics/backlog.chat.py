"""backlog.chat: requests submitted and not yet admitted to a slot when
the window closes (the scheduler's waiting queue): above the knee it
grows with the window."""


def read(obs: dict) -> float | None:
    b = obs.get("backlog")
    return None if b is None else float(b)
