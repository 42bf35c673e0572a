"""Model entry point: family dispatch for init / KV cache / decode.

The dense family's decode path is ported (`lm.py`); the full-sequence
forward, the other families and the encoder-decoder are not yet (ROADMAP
A5 zoo forward, A7 serving's recurrent families).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from ..configs.base import ArchConfig
from . import layers, lm


class Model(NamedTuple):
    init: Callable             # (seed, device) -> params
    init_cache: Callable       # (batch, max_len, **kw) -> cache
    decode_step: Callable      # (params, token, pos, cache, **kw) -> (logits, cache)


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP A5 zoo forward, A7 serving)")

    def init(seed: int = 0, device="cuda"):
        return lm.init_params(cfg, seed, device)

    def icache(batch, max_len, **kw):
        return lm.init_cache(cfg, batch, max_len, **kw)

    def dstep(params, token, pos, cache, **kw):
        return lm.decode_step(params, token, pos, cache, cfg, **kw)

    return Model(init, icache, dstep)


__all__ = ["Model", "get_model", "layers", "lm"]
