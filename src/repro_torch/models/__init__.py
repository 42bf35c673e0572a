"""Model entry point: family dispatch for init / forward / cache / decode,
the counterpart of `repro/models/__init__.py`.

`lm.py` covers the decoder-only families (dense, moe, hybrid, ssm, vlm)
and `encdec.py` the encoder-decoder (whisper).  `models/zoo.py` waits for
the capture front-end (ROADMAP A4).
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
    """Raise NotImplementedError unless `cfg` can decode here: every family
    decodes, but a float8_e4m3fn KV cache is not ported (ROADMAP A5)."""
    if cfg.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(
            f"{cfg.name}: a {cfg.kv_cache_dtype} KV cache is not ported (ROADMAP A5)")


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family == "encdec":
        def fwd(params, batch, **kw):
            kw.pop("moe_groups", None)
            return encdec.forward(params, batch["frame_embeds"], batch["tokens"], cfg, **kw)

        def icache(batch, max_len, **kw):
            return encdec.init_cache(cfg, batch, max_len, **kw)

        def dstep(params, token, pos, cache, **kw):
            return encdec.decode_step(params, token, pos, cache, cfg, **kw)

        return Model(lambda seed=0, device="cuda": encdec.init_params(cfg, seed, device),
                     fwd, icache, dstep)

    def init(seed: int = 0, device="cuda"):
        return lm.init_params(cfg, seed, device)

    def fwd(params, batch, **kw):
        return lm.forward(params, batch["tokens"], cfg,
                          patch_embeds=batch.get("patch_embeds"), **kw)

    def icache(batch, max_len, **kw):
        kw.pop("enc_len", None)
        return lm.init_cache(cfg, batch, max_len, **kw)

    def dstep(params, token, pos, cache, **kw):
        return lm.decode_step(params, token, pos, cache, cfg, **kw)

    return Model(init, fwd, icache, dstep)


__all__ = ["Model", "check_decode", "encdec", "get_model", "layers", "lm"]
