"""Model entry point: family dispatch for init / forward / KV cache /
decode.

The dense family is ported for the full-sequence forward and for decode
(`lm.py`); the encoder-decoder (`encdec.py`, whisper) for init and the
forward, its decode waiting for the serving of that family (ROADMAP A7).
The other families are not ported yet (ROADMAP A5 zoo forward, A7
serving's recurrent families).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from ..configs.base import ArchConfig
from . import encdec, layers, lm


class Model(NamedTuple):
    init: Callable             # (seed, device) -> params
    forward: Callable          # (params, batch, **kw) -> logits
    init_cache: Callable       # (batch, max_len, **kw) -> cache
    decode_step: Callable      # (params, token, pos, cache, **kw) -> (logits, cache)


def check_decode(cfg: ArchConfig) -> None:
    """Raise NotImplementedError unless `cfg`'s family can decode here."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: decoding the {cfg.family} family is not ported yet "
            f"(ROADMAP A7 serving)")


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family == "encdec":
        def fwd(params, batch, **kw):
            return encdec.forward(params, batch["frame_embeds"], batch["tokens"], cfg, **kw)

        def no_decode(*_, **__):
            check_decode(cfg)

        return Model(lambda seed=0, device="cuda": encdec.init_params(cfg, seed, device),
                     fwd, no_decode, no_decode)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP A5 zoo forward, A7 serving)")

    def init(seed: int = 0, device="cuda"):
        return lm.init_params(cfg, seed, device)

    def fwd(params, batch, **kw):
        return lm.forward(params, batch["tokens"], cfg, **kw)

    def icache(batch, max_len, **kw):
        return lm.init_cache(cfg, batch, max_len, **kw)

    def dstep(params, token, pos, cache, **kw):
        return lm.decode_step(params, token, pos, cache, cfg, **kw)

    return Model(init, fwd, icache, dstep)


__all__ = ["Model", "check_decode", "encdec", "get_model", "layers", "lm"]
