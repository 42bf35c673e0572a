"""prefix_hit.serve: the share of the prompt tokens admitted in the window
that the prefix cache served: its block hits in the window
(`stats()["prefix_cache"]["hits"]`, one per reused block) times the block
size, over the prompt tokens of the requests admitted meanwhile."""


def read(obs: dict) -> float | None:
    return obs.get("prefix_hit")
