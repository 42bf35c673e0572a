"""The kernel wrappers as `torch.library` custom ops, and the public
functions over them, the counterparts of `repro.kernels.ops`: x may carry
leading batch dims, which are flattened for the kernel and restored after.

Each wrapper of kernels/ is one op in the `repro_torch` namespace
(`torch.ops.repro_torch.fused_mlp_fwd`, ...).  An op's real implementation
is the wrapper itself, so an eager call runs exactly what it ran before:
the CUDA kernel for CUDA tensors, the plain version for CPU tensors.  Its
`register_fake` rule gives the output's shape, dtype and layout from the
inputs' alone, so a capture under fake tensors (core/trace.py) records the
op as ONE graph node and never reaches a kernel.  The two MLP forward ops
carry an autograd formula whose backward is the matching backward op --
the counterpart of the reference's custom VJP (ops.py `_fused_mlp`) and of
`atoms.swiglu_atom` -- so a captured training step holds both directions
as single nodes, and under remat the recomputed forward is a node too.
Only x and the weights are saved for the backward, never the (M, H)
hidden tensor.

`OP_SPECS` names, for each op, what the capture front-end records of it:
the graph node's kind, its flop count, the kernel-lowering hint that
core/lower.py binds back to the kernel, and the plain version that the
node runs when it is not lowered.  So in a captured graph a kernel is
reached only through the lowering pass, and the bsp and vertical modes
stay op-by-op baselines.

`KernelConfig` holds the launches' run-time knobs, which the public
functions take as `cfg` and the ops as trailing int arguments with the
same defaults: a traced node records the tile its call asked for, and the
lowering pass's autotuner (kernels/autotune.py) searches them.  The
default config launches exactly what the wrappers launch on their own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch.library import custom_op

from .flash_attention import (DECODE_MAX_BLOCK_S, flash_attention,
                              flash_attention_plain, flash_decode,
                              flash_decode_plain)
from .fused_mlp import (F32_BLOCK_H, F32_BWD_BLOCK_H, F32_BWD_BLOCK_M,
                        fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_fwd,
                        fused_mlp_fwd_plain, fused_mlp_swiglu_bwd,
                        fused_mlp_swiglu_bwd_plain, fused_mlp_swiglu_fwd,
                        fused_mlp_swiglu_fwd_plain)
from .paged_attention import paged_flash_decode, paged_flash_decode_plain
from .queue_reduce import queue_reduce, queue_reduce_plain

Tensor = torch.Tensor


@dataclass(frozen=True)
class KernelConfig:
    """The Hopper launches' run-time knobs (each kernel module's
    `tile_candidates` lists the values its launch takes) and whether the
    lowering pass searches them.  Every default is the wrappers' own, so
    `KernelConfig()` launches bitwise what an untuned call launches.  A
    knob a kernel's source fixes (the bf16 forms' geometry, B3's and B5's
    tiles) is not here."""
    block_s: int = DECODE_MAX_BLOCK_S   # B4 / B8 split-K chunk (keys; B8: whole pages)
    f32_block_h: int = F32_BLOCK_H      # B1 / B2 float32 tiled form: hidden chunk
    f32_bwd_block_h: int = F32_BWD_BLOCK_H  # B6 / B7 float32: dX hidden chunk
    f32_bwd_block_m: int = F32_BWD_BLOCK_M  # B6 / B7 float32: dW row slice
    autotune: bool = False              # search tile_candidates grids at lower time


_DEFAULT = KernelConfig()

# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


@custom_op("repro_torch::fused_mlp_fwd", mutates_args=())
def fused_mlp_fwd_op(x: Tensor, w1: Tensor, w2: Tensor, act: str,
                     f32_block_h: int = F32_BLOCK_H) -> Tensor:
    """B1: act(x @ w1) @ w2 for 2-D x."""
    return fused_mlp_fwd(x, w1, w2, act=act, f32_block_h=f32_block_h)


@fused_mlp_fwd_op.register_fake
def _(x, w1, w2, act, f32_block_h=F32_BLOCK_H):
    return x.new_empty((x.shape[0], w2.shape[1]))


@custom_op("repro_torch::fused_mlp_swiglu_fwd", mutates_args=())
def fused_mlp_swiglu_fwd_op(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
                            act: str, f32_block_h: int = F32_BLOCK_H) -> Tensor:
    """B2: (act(x @ wg) * (x @ wu)) @ wd for 2-D x."""
    return fused_mlp_swiglu_fwd(x, wg, wu, wd, act=act, f32_block_h=f32_block_h)


@fused_mlp_swiglu_fwd_op.register_fake
def _(x, wg, wu, wd, act, f32_block_h=F32_BLOCK_H):
    return x.new_empty((x.shape[0], wd.shape[1]))


@custom_op("repro_torch::fused_mlp_bwd", mutates_args=())
def fused_mlp_bwd_op(x: Tensor, w1: Tensor, w2: Tensor, dy: Tensor, act: str,
                     f32_block_h: int = F32_BWD_BLOCK_H,
                     f32_block_m: int = F32_BWD_BLOCK_M) -> tuple[Tensor, Tensor, Tensor]:
    """B6: (dx, dw1, dw2) of act(x @ w1) @ w2 for 2-D x and dy."""
    return fused_mlp_bwd(x, w1, w2, dy, act=act, f32_block_h=f32_block_h,
                         f32_block_m=f32_block_m)


@fused_mlp_bwd_op.register_fake
def _(x, w1, w2, dy, act, f32_block_h=F32_BWD_BLOCK_H, f32_block_m=F32_BWD_BLOCK_M):
    return torch.empty_like(x), torch.empty_like(w1), torch.empty_like(w2)


@custom_op("repro_torch::fused_mlp_swiglu_bwd", mutates_args=())
def fused_mlp_swiglu_bwd_op(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
                            dy: Tensor, act: str, f32_block_h: int = F32_BWD_BLOCK_H,
                            f32_block_m: int = F32_BWD_BLOCK_M
                            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """B7: (dx, dwg, dwu, dwd) of the gated MLP for 2-D x and dy."""
    return fused_mlp_swiglu_bwd(x, wg, wu, wd, dy, act=act, f32_block_h=f32_block_h,
                                f32_block_m=f32_block_m)


@fused_mlp_swiglu_bwd_op.register_fake
def _(x, wg, wu, wd, dy, act, f32_block_h=F32_BWD_BLOCK_H, f32_block_m=F32_BWD_BLOCK_M):
    return (torch.empty_like(x), torch.empty_like(wg), torch.empty_like(wu),
            torch.empty_like(wd))


def _save_operands(ctx, inputs, output):
    """The MLP forwards' autograd context: the tensors (never the hidden
    tensor) and the activation, and how many non-tensor arguments (the
    activation, the tile knobs) get no gradient.  The forward's tile is not
    the backward's, which runs its own defaults."""
    tensors = [t for t in inputs if isinstance(t, Tensor)]
    ctx.act = inputs[len(tensors)]
    ctx.n_static = len(inputs) - len(tensors)
    ctx.save_for_backward(*tensors)


def _mlp_backward(ctx, dy):
    return (*fused_mlp_bwd_op(*ctx.saved_tensors, dy.contiguous(), ctx.act),
            *[None] * ctx.n_static)


def _swiglu_backward(ctx, dy):
    return (*fused_mlp_swiglu_bwd_op(*ctx.saved_tensors, dy.contiguous(), ctx.act),
            *[None] * ctx.n_static)


fused_mlp_fwd_op.register_autograd(_mlp_backward, setup_context=_save_operands)
fused_mlp_swiglu_fwd_op.register_autograd(_swiglu_backward,
                                          setup_context=_save_operands)


@custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: Optional[int]) -> Tensor:
    """B3: online-softmax attention, q (B, Hq, S, D), k/v (B, Hkv, S, D)."""
    return flash_attention(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


def _valid_arg(valid_len) -> tuple[Optional[Tensor], Optional[int]]:
    """A decode op's valid length as (tensor, int): the kernels take a
    python int without a device copy, so it crosses as an int."""
    if torch.is_tensor(valid_len):
        return valid_len, None
    return None, valid_len


def _valid_len(valid: Optional[Tensor], valid_int: Optional[int]):
    return valid if valid is not None else valid_int


@custom_op("repro_torch::flash_decode", mutates_args=())
def flash_decode_op(q: Tensor, k: Tensor, v: Tensor, valid: Optional[Tensor],
                    valid_int: Optional[int],
                    block_s: int = DECODE_MAX_BLOCK_S) -> Tensor:
    """B4: split-K decode attention, q (B, Hq, 1, D), k/v (B, Hkv, S, D)."""
    return flash_decode(q, k, v, valid_len=_valid_len(valid, valid_int), block_s=block_s)


@flash_decode_op.register_fake
def _(q, k, v, valid, valid_int, block_s=DECODE_MAX_BLOCK_S):
    return torch.empty_like(q)


@custom_op("repro_torch::paged_flash_decode", mutates_args=())
def paged_flash_decode_op(q: Tensor, kp: Tensor, vp: Tensor, tables: Tensor,
                          valid: Optional[Tensor], valid_int: Optional[int],
                          block_size: int, layer: Optional[list[int]],
                          block_s: int = DECODE_MAX_BLOCK_S) -> Tensor:
    """B8: decode attention through per-slot block tables."""
    return paged_flash_decode(q, kp, vp, tables,
                              valid_len=_valid_len(valid, valid_int),
                              block_size=block_size,
                              layer=None if layer is None else tuple(layer),
                              block_s=block_s)


@paged_flash_decode_op.register_fake
def _(q, kp, vp, tables, valid, valid_int, block_size, layer, block_s=DECODE_MAX_BLOCK_S):
    return torch.empty_like(q)


@custom_op("repro_torch::queue_reduce", mutates_args=())
def queue_reduce_op(x: Tensor, op: str) -> Tensor:
    """B5: (N, R, C) -> (R, C) over axis 0 through an f32 accumulator."""
    return queue_reduce(x, op=op)


@queue_reduce_op.register_fake
def _(x, op):
    return x.new_empty(x.shape[1:])


# ---------------------------------------------------------------------------
# DTensor sharding strategies: under a Sharder (distributed/sharding.py) each
# op runs on every rank's local shards, inside DTensor dispatch.  Each rule
# lists, for ONE mesh dim, acceptable (output placements, input placements);
# DTensor expands them over the mesh's dims and picks the cheapest
# redistribution of the inputs it was given.  A non-tensor argument's entry is
# None.  No rule gathers a tensor that its kernel could take as a shard.
# ---------------------------------------------------------------------------

def _mlp_strategies(n_w: int, bwd: bool):
    """B1 / B2 (n_w = 2 / 3 weights) and their backward ops.  Replicated;
    rows sharded (x, dy and dx on dim 0; the weight gradients Partial sums
    over the row shards); Megatron tensor parallel (the first n_w - 1
    weights on their output dim, the last on its input dim, x replicated:
    the forward's output and the backward's dx are Partial sums over the
    hidden shards)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    r, s0, s1, p = Replicate(), Shard(0), Shard(1), Partial()

    def rule(*args):
        n_static = len(args) - n_w - 1 - bwd
        pad = [None] * n_static
        if not bwd:
            return [([r], [r] * (n_w + 1) + pad),
                    ([s0], [s0] + [r] * n_w + pad),
                    ([p], [r] + [s1] * (n_w - 1) + [s0] + pad)]
        return [([r] * (n_w + 1), [r] * (n_w + 2) + pad),
                ([s0] + [p] * n_w, [s0] + [r] * n_w + [s0] + pad),
                ([p] + [s1] * (n_w - 1) + [s0],
                 [r] + [s1] * (n_w - 1) + [s0] + [r] + pad)]
    return rule


def _attention_rule(q, k, v, causal, window):
    """B3: batch or heads sharded (heads: q's and k/v's on the same shards,
    so each q head meets its GQA group), or replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [([pl], [pl] * 3 + [None, None])
            for pl in (Replicate(), Shard(0), Shard(1))]


def _decode_rule(q, k, v, valid, valid_int, block_s=DECODE_MAX_BLOCK_S):
    """B4: batch (q, the caches and a per-slot valid length on dim 0) or
    heads (q's and the caches' dim 1), or replicated."""
    from torch.distributed.tensor import Replicate, Shard
    r, vt = Replicate(), valid is not None
    out = [([r], [r] * 3 + ([r] if vt else [None]) + [None, None])]
    out.append(([Shard(0)], [Shard(0)] * 3 + ([Shard(0)] if vt else [None]) + [None, None]))
    out.append(([Shard(1)], [Shard(1)] * 3 + ([r] if vt else [None]) + [None, None]))
    return out


def _paged_rule(q, kp, vp, tables, valid, valid_int, block_size, layer,
                block_s=DECODE_MAX_BLOCK_S):
    """B8: batch (q, the tables and valid lengths on dim 0; the pools, which
    every slot's pages share, replicated) or heads (q's dim 1, the pools'
    head dim), or replicated."""
    from torch.distributed.tensor import Replicate, Shard
    r, vt = Replicate(), valid is not None
    static = [None] * 4
    heads = Shard(kp.ndim - 2)
    return [([r], [r] * 4 + ([r] if vt else [None]) + static),
            ([Shard(0)], [Shard(0), r, r, Shard(0)] + ([Shard(0)] if vt else [None]) + static),
            ([Shard(1)], [Shard(1), heads, heads, r] + ([r] if vt else [None]) + static)]


def _reduce_rule(x, op):
    """B5: any placement that leaves the reduced axis 0 whole."""
    from torch.distributed.tensor import Replicate, Shard
    return ([([Replicate()], [Replicate(), None])]
            + [([Shard(d - 1)], [Shard(d), None]) for d in range(1, x.ndim)])


def _register_sharding() -> None:
    import torch.distributed as dist
    if not dist.is_available():
        return
    from torch.distributed.tensor.experimental import register_sharding
    rules = {fused_mlp_fwd_op: _mlp_strategies(2, False),
             fused_mlp_swiglu_fwd_op: _mlp_strategies(3, False),
             fused_mlp_bwd_op: _mlp_strategies(2, True),
             fused_mlp_swiglu_bwd_op: _mlp_strategies(3, True),
             flash_attention_op: _attention_rule,
             flash_decode_op: _decode_rule,
             paged_flash_decode_op: _paged_rule,
             queue_reduce_op: _reduce_rule}
    for op, rule in rules.items():
        register_sharding(op._opoverload)(rule)


_register_sharding()


# ---------------------------------------------------------------------------
# what the capture front-end records of each op
# ---------------------------------------------------------------------------

class OpSpec(NamedTuple):
    """kind: the graph node's op kind.  flops(*args): the node's flop
    count from the op's arguments (fake tensors at capture).  lower(*args):
    the kernel-lowering hint for the op's arguments (None: never lowered).
    plain(*args): the op's function in torch ops, which an unlowered node
    runs."""
    kind: str
    flops: Callable
    lower: Callable | None
    plain: Callable


def attention_flops(in_vals: list, out_vals: list) -> float:
    """q (B, Hq, S, D) against k (B, Hkv, T, D): two products of
    2 * B * Hq * S * T * D each."""
    shaped = [a for a in in_vals if a.ndim == 4]
    if len(shaped) < 2:
        return sum(2.0 * a.numel() for a in in_vals)
    b, hq, s, d = shaped[0].shape
    return 2 * 2.0 * b * hq * s * shaped[1].shape[2] * d


def mlp_flops(n_in: int, n_out: int, bwd: bool = False) -> Callable:
    """Flops of an MLP op whose x is (..., D), first weight (D, H) and last
    weight (H, O) (before dy in a backward): `n_in` products of x's width
    (2 M D H each, M rows) and `n_out` of the output's (2 M H O each)."""
    def flops(*args) -> float:
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        d, h = ts[0].shape[-1], ts[1].shape[1]
        o = ts[-2 if bwd else -1].shape[1]
        return 2.0 * (ts[0].numel() // d) * h * (n_in * d + n_out * o)
    return flops


def _paged_flops(q, kp, vp, tables, valid, valid_int, block_size, layer, *_) -> float:
    b, hq, _, d = q.shape
    return 4.0 * b * hq * tables.shape[1] * block_size * d


def _plain_decode(q, k, v, valid, valid_int, block_s=DECODE_MAX_BLOCK_S):
    return flash_decode_plain(q, k, v, valid_len=_valid_len(valid, valid_int),
                              block_s=block_s)


def _plain_paged(q, kp, vp, tables, valid, valid_int, block_size, layer,
                 block_s=DECODE_MAX_BLOCK_S):
    return paged_flash_decode_plain(
        q, kp, vp, tables, valid_len=_valid_len(valid, valid_int),
        block_size=block_size, layer=None if layer is None else tuple(layer),
        block_s=block_s)


def _valid_hint(valid, valid_int) -> tuple:
    """A python-int valid length is no graph operand: the hint carries it."""
    return () if valid is not None else (("valid_int", valid_int),)


def _knob_hint(**knobs) -> tuple:
    """The KernelConfig knobs a call asked for other than the defaults: the
    traced node's tile, which the lowered call replays unless it is tuned
    (an untuned node's hint is the same as before the knobs existed)."""
    return tuple((name, int(v)) for name, v in knobs.items()
                 if v != getattr(_DEFAULT, name))


def _paged_hint(q, kp, vp, tables, valid, valid_int, block_size, layer,
                block_s=DECODE_MAX_BLOCK_S):
    hint = ("paged_decode", ("block_size", int(block_size)))
    if layer is not None:
        hint += (("layer", tuple(int(i) for i in layer)),)
    return hint + _valid_hint(valid, valid_int) + _knob_hint(block_s=block_s)


def _fwd_hint(family: str, n_w: int):
    def hint(x, *rest):
        act, *knobs = rest[n_w:]
        return (family, ("act", act)) + _knob_hint(
            **dict(zip(("f32_block_h",), knobs)))
    return hint


def _bwd_hint(family: str, n_w: int):
    def hint(x, *rest):
        act, *knobs = rest[n_w + 1:]
        return (family, ("act", act)) + _knob_hint(
            **dict(zip(("f32_bwd_block_h", "f32_bwd_block_m"), knobs)))
    return hint


def _mlp_plain(plain: Callable, n_tensors: int) -> Callable:
    """An MLP op's plain version over the op's arguments (its tile knobs,
    which change no value, dropped)."""
    return lambda *args: plain(*args[:n_tensors + 1])


OP_SPECS: dict[str, OpSpec] = {
    "repro_torch::fused_mlp_fwd": OpSpec(
        "matmul", mlp_flops(1, 1), _fwd_hint("mlp_fwd", 2),
        _mlp_plain(fused_mlp_fwd_plain, 3)),
    "repro_torch::fused_mlp_swiglu_fwd": OpSpec(
        "matmul", mlp_flops(2, 1), _fwd_hint("swiglu_fwd", 3),
        _mlp_plain(fused_mlp_swiglu_fwd_plain, 4)),
    "repro_torch::fused_mlp_bwd": OpSpec(
        "matmul", mlp_flops(3, 2, bwd=True), _bwd_hint("mlp_bwd", 2),
        _mlp_plain(fused_mlp_bwd_plain, 4)),
    "repro_torch::fused_mlp_swiglu_bwd": OpSpec(
        "matmul", mlp_flops(6, 2, bwd=True), _bwd_hint("swiglu_bwd", 3),
        _mlp_plain(fused_mlp_swiglu_bwd_plain, 5)),
    # B3 stays opaque, as the reference's attention atomics do: no traced
    # path reaches it (the models' training attention is chunked torch ops)
    "repro_torch::flash_attention": OpSpec(
        "attention", lambda q, k, v, *_: attention_flops([q, k], []), None,
        lambda q, k, v, causal, window: flash_attention_plain(
            q, k, v, causal=causal, window=window)),
    "repro_torch::flash_decode": OpSpec(
        "attention", lambda q, k, v, *_: attention_flops([q, k], []),
        lambda q, k, v, valid, valid_int, block_s=DECODE_MAX_BLOCK_S:
            ("decode",) + _valid_hint(valid, valid_int) + _knob_hint(block_s=block_s),
        _plain_decode),
    "repro_torch::paged_flash_decode": OpSpec(
        "attention", _paged_flops, _paged_hint, _plain_paged),
    "repro_torch::queue_reduce": OpSpec(
        "reduce", lambda x, op: float(x.numel()), None,
        lambda x, op: queue_reduce_plain(x, op)),
}


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------

def _rows(x: Tensor) -> Tensor:
    """x (..., D) as (M, D) rows.  A DTensor sharded on a leading dim other
    than the first is gathered on that dim first: DTensor cannot flatten
    it in place (the sequence-parallel residual stream, batch on "data"
    and sequence on "model", meets the MLP this way)."""
    if hasattr(x, "placements"):
        from torch.distributed.tensor import Replicate, Shard
        pl = [Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1 else p
              for p in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(-1, x.shape[-1])


def mlp(x: Tensor, w1: Tensor, w2: Tensor, *, act: str = "gelu",
        cfg: KernelConfig = _DEFAULT) -> Tensor:
    """act(x @ w1) @ w2; x may have leading batch dims.  Differentiable:
    the backward is B6."""
    lead = x.shape[:-1]
    y = fused_mlp_fwd_op(_rows(x), w1, w2, act, cfg.f32_block_h)
    return y.reshape(*lead, w2.shape[1])


def mlp_swiglu(x: Tensor, wg, wu, wd, *, act: str = "silu",
               cfg: KernelConfig = _DEFAULT) -> Tensor:
    """(act(x @ wg) * (x @ wu)) @ wd; x may have leading batch dims.
    Differentiable: the backward is B7."""
    lead = x.shape[:-1]
    y = fused_mlp_swiglu_fwd_op(_rows(x), wg, wu, wd, act, cfg.f32_block_h)
    return y.reshape(*lead, wd.shape[1])


def mlp_bwd(x: Tensor, w1: Tensor, w2: Tensor, dy: Tensor, *, act: str = "gelu",
            cfg: KernelConfig = _DEFAULT):
    """(dx, dw1, dw2) of act(x @ w1) @ w2; x/dy may have leading batch dims."""
    dx, dw1, dw2 = fused_mlp_bwd_op(_rows(x), w1, w2, _rows(dy), act,
                                    cfg.f32_bwd_block_h, cfg.f32_bwd_block_m)
    return dx.reshape(x.shape), dw1, dw2


def mlp_swiglu_bwd(x: Tensor, wg, wu, wd, dy: Tensor, *, act: str = "silu",
                   cfg: KernelConfig = _DEFAULT):
    """(dx, dwg, dwu, dwd) of (act(x @ wg) * (x @ wu)) @ wd; x/dy may have
    leading batch dims."""
    dx, dwg, dwu, dwd = fused_mlp_swiglu_bwd_op(
        _rows(x), wg, wu, wd, _rows(dy), act,
        cfg.f32_bwd_block_h, cfg.f32_bwd_block_m)
    return dx.reshape(x.shape), dwg, dwu, dwd


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              cfg: KernelConfig = _DEFAULT) -> Tensor:
    """B3's tiles are fixed in its source: `cfg` changes nothing here."""
    return flash_attention_op(q, k, v, causal, window)


def decode_attention(q, k, v, *, valid_len=None, cfg: KernelConfig = _DEFAULT) -> Tensor:
    """Single-token attention, q (B, Hq, 1, D) against k/v (B, Hkv, S, D),
    in chunks of cfg.block_s keys."""
    return flash_decode_op(q, k, v, *_valid_arg(valid_len), cfg.block_s)


def paged_decode_attention(q, kp, vp, tables, *, valid_len, block_size: int,
                           layer=None, cfg: KernelConfig = _DEFAULT) -> Tensor:
    """Decode attention straight out of the flat page pools (no dense-view
    gather): kp/vp (P, Hkv, D) or (P, G, A, Hkv, D) + layer=(g, a), tables
    (B, V), valid_len (B,); chunks of cfg.block_s rows, aligned to whole
    pages (`page_block_s`)."""
    return paged_flash_decode_op(q, kp, vp, tables, *_valid_arg(valid_len),
                                 int(block_size),
                                 None if layer is None else [int(i) for i in layer],
                                 cfg.block_s)


def reduce(x: Tensor, *, op: str = "sum", cfg: KernelConfig = _DEFAULT) -> Tensor:
    """Reduce axis 0 of (N, R, C).  B5's geometry is fixed in its source:
    `cfg` changes nothing here."""
    return queue_reduce_op(x, op)
