"""input_specs(): stand-ins for every (arch x shape) cell, the counterparts
of `repro/launch/inputs.py`'s ShapeDtypeStructs.

Each stand-in is a tensor on the meta device: it has a shape, a dtype and
strides, and no storage, so a dry run (launch/dryrun.py) traces a
full-size step against these and allocates nothing, on the card or the
host.  Every op on them runs its meta (fake) rule -- the kernel ops their
`register_fake` rules -- and every tensor the model makes itself
(positions, masks, zeros) lands on the meta device too, since the models
make theirs on their inputs' device.  Modality frontends are stubs, as in
the reference: pixtral gets precomputed patch embeddings, whisper gets
precomputed frame embeddings.
"""
from __future__ import annotations

import torch

from ..configs.base import SHAPES, ArchConfig, InputShape
from ..models import encdec as encdec_mod
from ..models import lm as lm_mod

DEVICE = "meta"


def _act_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=DEVICE)


def train_inputs(cfg: ArchConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((b, s), torch.int32)}
    if cfg.family == "vlm":
        batch["tokens"] = _sds((b, s - cfg.vision_tokens), torch.int32)
        batch["patch_embeds"] = _sds((b, cfg.vision_tokens, cfg.d_model), _act_dtype(cfg))
    if cfg.family == "encdec":
        # encoder consumes frame embeddings of the same length (stub)
        batch["frame_embeds"] = _sds((b, s, cfg.d_model), _act_dtype(cfg))
    return batch


def decode_inputs(cfg: ArchConfig, shape: InputShape) -> dict:
    """serve_step state: one new token against a seq_len-deep cache."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        cache = encdec_mod.init_cache(cfg, b, s, enc_len=1500, device=DEVICE)
    else:
        cache = lm_mod.init_cache(cfg, b, s, device=DEVICE)
    return {"tokens": _sds((b,), torch.int32),
            "pos": _sds((), torch.int32),
            "cache": cache}


def params_specs(cfg: ArchConfig, model) -> dict:
    """The parameter tree on the meta device: `model.init` drawing nothing,
    the counterpart of `jax.eval_shape(model.init)`."""
    return model.init(0, DEVICE)


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return train_inputs(cfg, shape)
    return decode_inputs(cfg, shape)
