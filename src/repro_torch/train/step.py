"""Train step: remat forward, chunked cross entropy, gradients, global-norm
clipping, optimizer update and optional microbatch accumulation -- the
counterpart of `repro/train/step.py`'s `make_train_step`.

Gradients come from `torch.autograd.grad` over the parameter tree's leaves
(the functional form of `jax.value_and_grad`); the step returns new
parameter and optimizer trees and leaves its inputs untouched.  The MLP
blocks run the fused kernels in both directions (kernels/ops.py); the
cross entropy's matmul stays `torch.matmul`, as the reference computes it
outside any Pallas kernel.  `compile_train_step` traces the same step
through the capture front-end (core/trace.py) and compiles it through the
dataflow pass pipeline.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.compiler import compile as _compile
from ..distributed.sharding import (NULL, dispatch_context, full_tensor, is_dtensor,
                                    is_sharded, pad as pad_dims, place, rows_matmul,
                                    whole_rows)
from ..kernels import KernelConfig
from ..models import atoms, get_model
from ..optim import Optimizer, clip_by_global_norm
from ..tree import flatten, tree_map, unflatten_like


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # gradient-accumulation steps
    max_grad_norm: float = 1.0
    remat: bool = True
    z_loss: float = 1e-4           # logit regularizer (stabilizes bf16 LMs)
    # sequence-chunk width of the chunked cross entropy (peak logits memory
    # is O(chunk * vocab))
    xent_chunk: int = 512


def _lse(logits: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the last axis of f32 logits, the max held constant."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    return torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]


def loss_fn(logits: torch.Tensor, tokens: torch.Tensor, z_loss: float = 0.0) -> torch.Tensor:
    """Next-token cross entropy over the last len(tokens) - 1 positions (a
    non-token prefix, e.g. vlm patches, occupies the first ones)."""
    targets = tokens[:, 1:]
    n = targets.shape[1]
    pf = logits[:, -n - 1:-1].float()          # position t-1 predicts target t
    lse = _lse(pf)
    ll = pf.gather(-1, targets[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def _xent_chunk(xi, table, ti, constrain=None):
    """(sum of -log p, sum of lse^2, count) over one chunk's valid targets
    (ti >= 0); `constrain` pins the chunk's logits ("logits")."""
    logits = rows_matmul(xi, table.T)
    if constrain is not None:
        logits = constrain(logits, "logits")
    logits = logits.float()
    lse = _lse(logits)
    valid = (ti >= 0).float()
    if constrain is None:
        ll = logits.gather(-1, ti.clamp(min=0)[..., None].long())[..., 0]
    else:
        # the target's logit as a masked sum over the vocab-sharded dim (one
        # term is not zero, so the sum is exact): DTensor's gather on a
        # sharded dim cannot reduce its masked partial sums
        vocab = torch.arange(logits.shape[-1], device=ti.device)
        hit = vocab == ti.clamp(min=0)[..., None].long()
        ll = torch.where(hit, logits, 0.0).sum(-1)
    return ((lse - ll) * valid).sum(), (lse.square() * valid).sum(), valid.sum()


def chunked_softmax_xent(x: torch.Tensor, table: torch.Tensor, tokens: torch.Tensor,
                         z_loss: float = 0.0, chunk: int = 512,
                         sharder=NULL) -> torch.Tensor:
    """Cross entropy without materializing (B, S, V) logits.

    x: (B, S, D) final hidden states; table: (V, D).  Each sequence chunk's
    logits (B, chunk, V) exist only inside a `torch.utils.checkpoint`ed
    call, so peak memory is O(chunk * V) rather than O(S * V); a ragged last
    chunk is padded with targets -1, which count nothing."""
    targets = tokens[:, 1:]
    n = targets.shape[1]
    # a sequence-split x is gathered before its chunks are sliced out
    xs = whole_rows(x)[:, -n - 1:-1]
    pad = (-n) % chunk
    if pad:
        xs = pad_dims(xs, (0, 0, 0, pad))
        targets = pad_dims(targets, (0, pad), value=-1)
    tot = totz = cnt = 0.0
    fn = functools.partial(_xent_chunk, constrain=sharder.constrain) if is_sharded(sharder) \
        else _xent_chunk
    for c in range(0, n + pad, chunk):
        t, tz, k = checkpoint(fn, xs[:, c:c + chunk], table,
                              targets[:, c:c + chunk], use_reentrant=False)
        tot, totz, cnt = tot + t, totz + tz, cnt + k
    loss = tot / cnt
    if z_loss:
        loss = loss + z_loss * totz / cnt
    return loss


def make_train_state(cfg: ArchConfig, opt: Optimizer, seed: int = 0,
                     device="cuda") -> dict:
    params = get_model(cfg).init(seed, device)
    return {"params": params, "opt": opt.init(params)}


def value_and_grad(fn: Callable, params, *args):
    """(fn(params, *args) detached, d fn / d params as a tree like params)."""
    flat = flatten(params)
    live = {path: t.detach().requires_grad_() for path, t in flat}
    value = fn(unflatten_like(params, live), *args)
    grads = torch.autograd.grad(value, list(live.values()))
    return value.detach(), unflatten_like(params, dict(zip(live, grads)))


def _microbatch(t: torch.Tensor, k: int, i: int) -> torch.Tensor:
    """The i-th of k microbatches of t (B, ...): rows [i B/k, (i+1) B/k),
    as the reference splits.  A DTensor whose batch is split over n ranks
    that k does not divide takes each rank's i-th local slice instead:
    DTensor cannot unflatten such a batch, and a split along the ranks
    would gather the batch onto every rank.  The microbatches are as large,
    so their mean loss and gradient are the batch's."""
    b, rest = t.shape[0], t.shape[1:]
    if is_dtensor(t):
        from torch.distributed.tensor import Shard
        n = 1
        for i_dim, pl in enumerate(t.placements):
            if isinstance(pl, Shard) and pl.dim == 0:
                n *= t.device_mesh.size(i_dim)
        if n > 1 and k % n:
            return t.reshape(n, k, b // (n * k), *rest)[:, i].reshape(b // k, *rest)
    return t.reshape(k, b // k, *rest)[i]


def make_train_step(cfg: ArchConfig, opt: Optimizer,
                    tc: TrainConfig = TrainConfig(), *,
                    kernels: KernelConfig = KernelConfig(), sharder=NULL) -> Callable:
    """Returns step(state, batch) -> (state, metrics).  `kernels` reaches
    the model's kernel calls (the MLP blocks, forward and backward).

    Under a `sharder` on a DeviceMesh the state's leaves are DTensors
    (`Sharder.distribute`); a batch leaf that is a plain tensor is placed
    by `data_sharding`.  The model's activations are pinned at the
    reference's sites, and the gradients' reduction over the batch axes,
    which GSPMD inserts for the reference, comes from DTensor's Partial
    gradients.  The metrics come back as plain (full) tensors."""
    model = get_model(cfg)
    sharded = is_sharded(sharder)

    def fwd_loss(params, batch):
        hidden = model.forward(params, batch, remat=tc.remat, return_hidden=True,
                               kernels=kernels, sharder=sharder)
        table = params.get("unembed", params["embed"])
        return chunked_softmax_xent(hidden, table, batch["tokens"], tc.z_loss,
                                    chunk=tc.xent_chunk, sharder=sharder)

    def step(state, batch):
        if not sharded:
            return _step(state, batch)
        batch = {n: t if is_dtensor(t) else place(t, sharder.data_sharding(t.ndim))
                 for n, t in batch.items()}
        with dispatch_context(sharder):
            state, metrics = _step(state, batch)
        return state, {k: full_tensor(v) for k, v in metrics.items()}

    def _step(state, batch):
        params = state["params"]
        if tc.microbatches > 1:
            # one microbatch of activations live at a time
            k = tc.microbatches
            loss = torch.zeros((), device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(k):
                mb = {n: _microbatch(t, k, i) for n, t in batch.items()}
                lv, g = value_and_grad(fwd_loss, params, mb)
                loss = loss + lv
                grads = tree_map(torch.add, grads, g)
            loss = loss / k
            grads = tree_map(lambda g: g / k, grads)
        else:
            loss, grads = value_and_grad(fwd_loss, params, batch)
        if sharded:
            # each gradient onto its parameter's placements: the Partial
            # sums over the batch shards are reduced here
            grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements),
                             grads, params)
        grads, gnorm = clip_by_global_norm(grads, tc.max_grad_norm)
        new_params, new_opt = opt.update(grads, state["opt"], params)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, "grad_norm": gnorm}

    return step


def compile_train_step(cfg: ArchConfig, opt: Optimizer,
                       tc: TrainConfig = TrainConfig(), *,
                       state, batch, compile_mode: str = "kitsune",
                       donate_state: bool = True, **compile_kwargs):
    """The full training step -- forward, backward, loss, optimizer update --
    compiled through the dataflow pipeline.

    Traces `make_train_step(cfg, opt, tc)` on the example (state, batch)
    under `models.atoms.dataflow_training()`, so the MLP / SwiGLU blocks
    survive capture as atomic pairs in BOTH directions and the
    `lower_kernels` pass binds them to the kernels (`fused_mlp_fwd` /
    `fused_mlp_swiglu_fwd` forward, `fused_mlp_bwd` /
    `fused_mlp_swiglu_bwd` backward -- the Fig 2(c) multicast, executable,
    not plan-only); under remat the recomputed forward is a node of its
    own.  Attention stays single-node with its flash-style recompute
    backward on the plain path.

    Returns a TracedApp: `app(state, batch) -> (state, metrics)`, the raw
    step's contract.  With `donate_state` (default) the state argument's
    storage is DONATED: each new parameter and optimizer moment is written
    into its old tensor as soon as nothing reads the old one, so feed each
    call the previous call's output state, not a retained copy.

    With `tc.microbatches > 1` the accumulation loop unrolls into
    structurally identical per-microbatch subgraphs, which the `dedupe`
    pass keys to shared executables.  The serving analogue is
    `ServeConfig(compile_mode=...)`."""
    step_fn = make_train_step(cfg, opt, tc)
    donate = (0,) if donate_state else ()
    with atoms.dataflow_training():
        return _compile(step_fn, (state, batch), mode=compile_mode,
                        donate_argnums=donate, **compile_kwargs)
