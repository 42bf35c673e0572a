"""Model entry point: family dispatch for init / forward / cache / decode,
the counterpart of `repro/models/__init__.py`.

`lm.py` covers the decoder-only families (dense, moe, hybrid, ssm, vlm)
and `encdec.py` the encoder-decoder (whisper).  `zoo.py` builds each config
as a traceable function for `repro_torch.compile(fn, example_inputs)`, and
`atoms.py` holds the training atomics a traced step keeps whole.
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
    """Raise ValueError unless `cfg` can decode here: every family decodes,
    with a KV cache of a dtype the reference knows (`lm.KV_CACHE_DTYPES`:
    the activation dtype's, or float8_e4m3fn; whisper keeps its activation
    dtype whatever the config says, as the reference's does)."""
    if cfg.kv_cache_dtype not in lm.KV_CACHE_DTYPES:
        raise ValueError(f"{cfg.name}: kv_cache_dtype {cfg.kv_cache_dtype!r} is none of "
                         f"{lm.KV_CACHE_DTYPES}")


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
