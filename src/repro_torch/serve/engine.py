"""Serving engines over the port's decode path, the counterparts of
`repro/serve/engine.py`.

  * `ServingEngine` -- the legacy CONTIGUOUS engine: one (B, max_len) cache,
    one shared position clock, teacher-forcing one prompt token per tick.
    Kept as the solo oracle.

  * `PagedServingEngine` -- the production engine: the KV cache is a pool of
    fixed-size pages (block_pool.py) indexed through per-slot block tables,
    positions are a per-slot (B,) clock threaded down to the decode-attention
    kernels (each slot attends exactly its own [0, valid) range), prompts
    prefill in chunks mixed into decode ticks (scheduler.py), and finished
    prompts publish their blocks to a prefix cache (prefix_cache.py).
    Capacity comes from a profiling pass (`PagedKVExecutor`).

  * `AsyncServingEngine` wraps the paged engine in a background tick loop:
    `submit()` returns a streaming `RequestHandle` immediately; `drain()`
    stops the loop after in-flight work completes.

The paged tick runs over the full slot batch on the parameters' device.
On a CUDA device every tick replays a captured CUDA graph, one per
(chunk width, view) bucket (`PagedServingEngine._get_step`, the
counterpart of the reference's one compiled program per bucket): the host
copies the tick's tokens, positions and block tables into the graph's
input buffers, replays it, and reads the sampled tokens back.  There is no
eager tick on the card.  On the CPU the same tick runs eagerly, as the
tests drive it.  The legacy engine's tick goes through `cached_jit`, as
the reference's does: a replayed CUDA graph on the card, eager on the CPU.
With `ServeConfig.compile_mode`, either engine's tick is instead traced
(core/trace.py) and run on that compiler mode's executor, the kernels
reached through the lowering pass, each plan a replayed CUDA graph on the
card (core/executor.py).  The batch shape
never changes, so every op of a step sees the same shapes each tick, and
each slot's outputs depend only on its own tokens: a refilled slot is
bitwise equal to serving its request alone, and the two KV data paths
("native" and "gather") are bitwise equal to each other.  (MoE families
are the exception the reference shares: capacity routing couples the
slots of a step, ROADMAP C.)

Every engine takes `kernels` (a `KernelConfig`, the reference's `kernels=`):
the tile its ticks' kernel calls launch (the decode kernels' `block_s`),
threaded through `serve_step` / `paged_tick` into the model.  A config's
`kv_cache_dtype="float8_e4m3fn"` stores the cache and the page pools in
e4m3 (half the bytes a page, so about twice the pages for one budget),
written through the reference's cast and read as e4m3 by the decode
kernels.

Recurrent families carry per-slot state beside the pages -- hymba's SSM
state, xlstm's mLSTM and sLSTM state, keyed as `models.lm.init_cache` keys
them -- which each decode step advances only in its active slots, and which
the engine resets in place when it refills a slot.  xlstm attends nowhere:
its engine has no pages, pools or tables.  The paged engine serves every
decoder-only family; the encoder-decoder (whisper) decodes through the
legacy engine and `models.encdec`.
"""
from __future__ import annotations

import functools
import threading
import time
import warnings
import weakref
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.compiler import cached_jit, compile as compile_fn
from ..core.costmodel import paged_decode_traffic
from ..core.cudagraph import CapturedGraph, GraphCaptureError, graph_stats
from ..core.executor import executable_cache
from ..distributed.sharding import (NULL, cache_placement, full_tensor, is_dtensor,
                                    is_sharded, join_local, place, pool_placement,
                                    replicated_view, split_local)
from ..kernels import KernelConfig
from ..kernels.ref import paged_rows
from ..models import check_decode, get_model
from ..models import lm
from ..models.layers import _write
from .block_pool import BlockPool, OutOfBlocks
from .faults import DeadlineExceeded, EngineError, FaultInjector, QueueFull
from .prefix_cache import PrefixCache
from .scheduler import Request, Scheduler, blocks_for


@dataclass(frozen=True)
class ServeConfig:
    max_len: int
    batch: int
    # None: the eager tick (a captured CUDA graph per bucket for the paged
    # engine on the card).  "bsp" / "vertical" / "kitsune": the tick traced
    # through the capture front-end and run on that executor
    # (`repro_torch.compile`), one trace per tick shape.
    compile_mode: str | None = None
    # The compiled tick's lowering policy (`CompilerOptions.lowering_policy`,
    # used only with `compile_mode`): "auto" weighs each kernel site and
    # tunes its tile on the card, "always" lowers every site at the default
    # tiles, as the eager tick launches them.
    lowering_policy: str = "auto"
    # Optional LRU bound for the PROCESS-WIDE executable cache
    # (`executable_cache()`), which engines of every shape and config share:
    # evicted builds (cached_jit graphs, with their graph pools) are built
    # again on next use.  None leaves whatever bound is in force; the knob
    # is global and last-setter-wins, so set it from one place.
    cache_capacity: int | None = None
    # -- paged engine knobs -------------------------------------------------
    block_size: int = 8            # token positions per KV page
    prefill_chunk: int = 8         # max prompt tokens one slot feeds per tick
    token_budget: int | None = None  # tokens per tick across the batch
    num_blocks: int | None = None    # pool size; None -> profiling pass
    mem_budget_bytes: int | None = None  # profiling budget override
    prefix_caching: bool = True
    # False (default) pins the per-tick KV view at max_blocks: every tick
    # reduces over the same attention length, which keeps outputs BITWISE
    # independent of what the other slots are doing.  True sizes the view at
    # the active-slot max: less attention work per tick, and value-level
    # (not bitwise) batch invariance.
    view_buckets: bool = False
    # Tick KV data path.  "native" (default): attention reads/writes the flat
    # page pools through the block tables (paged_flash_decode) -- no
    # pool->view gather, no trailing scatter.  "gather": gather the dense
    # view, flash_decode it, scatter written columns back; the differential
    # oracle, bitwise equal to "native".
    paged_attention: str = "native"
    max_new_tokens: int | None = None    # default per-request cap
    # -- fault tolerance ----------------------------------------------------
    fault_plan: tuple = ()               # faults.FaultSpec schedule
    fault_seed: int = 0
    nan_guard: bool = False              # fail slots with non-finite logits
    max_tick_retries: int = 3            # consecutive failed ticks -> degraded
    max_chunk_retries: int = 3           # transient prefill-chunk failures
    max_queue: int | None = None         # waiting-queue bound (QueueFull)
    default_deadline_s: float | None = None


def _device_of(params: dict) -> torch.device:
    return params["embed"].device


def _apply_cache_capacity(sc: ServeConfig) -> None:
    """Apply ServeConfig.cache_capacity to the process-wide executable cache,
    warning when it would SHRINK a larger capacity some other engine set:
    the knob is global, and evicting a co-tenant's builds silently is what
    should be loud."""
    if sc.cache_capacity is None:
        return
    cache = executable_cache()
    cur = cache.stats()["capacity"]
    if cur is not None and sc.cache_capacity < cur:
        warnings.warn(
            f"ServeConfig.cache_capacity={sc.cache_capacity} shrinks the "
            f"process-wide executable cache from capacity {cur}; other "
            "engines in this process share that cache and may rebuild "
            "evicted shapes", stacklevel=3)
    cache.set_capacity(sc.cache_capacity)


def _compiled(fn, example: tuple, sc: ServeConfig, device: torch.device):
    """`fn(params, state, feed)` traced on `example` and compiled in
    `sc.compile_mode`, as a callable of the same arguments that moves the
    host tensors of `feed` to `device` (the engines build their tick inputs
    on the host).  The params are read in place and the state (caches,
    pools, recurrent state) is donated, so the captured plan keeps both
    where they are; the per-tick feed is copied into its buffers.  The tick
    writes its state in place: the trace functionalizes those writes and
    the compiled graph's trailing copies put them into the engine's
    buffers."""
    app = compile_fn(fn, example, mode=sc.compile_mode, inplace_argnums=(0,),
                     donate_argnums=(1,), lowering_policy=sc.lowering_policy)

    def step(params, state, feed):
        return app(params, state, {k: v.to(device) for k, v in feed.items()})
    step.app = app
    return step


def serve_step(params, state, cfg: ArchConfig, kernels: KernelConfig = KernelConfig(),
               sharder=NULL):
    """One decode tick for the whole batch (legacy contiguous engine).

    state = {"tokens": (B,), "pos": (B,) or int, "cache": {...}}; the cache
    is updated in place.  Returns the sampled next tokens and the logits.
    Under a `sharder` (params and cache DTensors on its mesh) the decode
    step's activations are pinned at the reference's sites, and the tokens
    and logits come back whole (plain tensors)."""
    logits, cache = get_model(cfg).decode_step(params, state["tokens"],
                                               state["pos"], state["cache"],
                                               kernels=kernels, sharder=sharder)
    if is_sharded(sharder):
        # the logits come back whole: the argmax runs on them (DTensor's
        # argmax over a vocab-sharded dim fails on a batch of one)
        logits = full_tensor(logits)
    tokens = logits.argmax(dim=-1)
    return {"tokens": tokens, "pos": state["pos"] + 1, "cache": cache, "logits": logits}


def _legacy_tick(params, cache, feed, cfg: ArchConfig, kernels: KernelConfig,
                 sharder=NULL):
    """`serve_step` with the cache apart from the per-tick tokens and
    position, so that a compiled tick keeps the cache in place."""
    return serve_step(params, {**feed, "cache": cache}, cfg, kernels, sharder)


def _local_tick(params, cache, feed, *, layouts: dict, **kw):
    """`_legacy_tick` over the local shards of DTensor params and cache
    (`split_local`): the captured graph reads plain tensors at their
    addresses, and the DTensors are wrapped around them inside."""
    out = _legacy_tick(join_local(params, layouts["params"]),
                       join_local(cache, layouts["cache"]), feed, **kw)
    return {**out, "cache": cache}


class ServingEngine:
    """Legacy host-side request manager: continuous batching over fixed
    slots with ONE contiguous (B, max_len) cache and a shared position clock
    (so a slot refilled mid-stream attends its predecessor's stale entries;
    the paged engine's per-slot clock fixes that).  With batch=1 it is the
    per-request ground truth.

    Its tick goes through `cached_jit` keyed ("serve_step", config, batch,
    max_len, repr(kernels)) as the reference's is, and by the KV cache
    dtype besides, so that a bfloat16 and a float8 engine of one config
    never share a build: on the card one CUDA graph per
    engine (the weights and the cache are read in place, at their
    addresses), replayed every tick and dropped from the executable cache,
    with its graph pool, when the engine is collected; on the CPU eager, one
    build for every engine of the key.  The tokens and the
    position, a (B,) int64 tensor, are the per-tick feed.  With
    `ServeConfig.compile_mode` the tick is traced once and runs on the
    compiler's executor instead; under a sharder it is traced over the
    local shards (`_local_tick`), its collectives nodes of the graph."""

    def __init__(self, cfg: ArchConfig, params, sc: ServeConfig, *,
                 eos_id: int = 1, kernels: KernelConfig = KernelConfig(), sharder=NULL):
        check_decode(cfg)
        self.sharded = is_sharded(sharder)
        self.cfg = cfg
        self.params = sharder.distribute(params) if self.sharded and not \
            is_dtensor(params["embed"]) else params
        self.sc = sc
        self.sharder = sharder
        self.device = _device_of(params)
        self.eos = eos_id
        self.queue: deque[tuple[int, list[int]]] = deque()
        self.slots: list[dict | None] = [None] * sc.batch
        self.done: dict[int, list[int]] = {}
        self.cache = get_model(cfg).init_cache(sc.batch, sc.max_len, device=self.device)
        self.tokens = np.zeros(sc.batch, np.int64)
        self.pos = 0
        _apply_cache_capacity(sc)
        tick = functools.partial(_legacy_tick, cfg=cfg, kernels=kernels)
        args = (params, self.cache)
        if self.sharded:
            # the graph reads the local shards in place; the tick wraps them
            # (a compiled tick is traced over them: its graph is this rank's
            # local ops and the collectives between them)
            self.cache = {k: place(v, cache_placement(sharder, v))
                          if k in ("k", "v", "xk", "xv") else sharder.replicate(v)
                          for k, v in self.cache.items()}
            self._params_local, p_lay = split_local(self.params)
            self._cache_local, c_lay = split_local(self.cache)
            tick = functools.partial(_local_tick, layouts={"params": p_lay, "cache": c_lay},
                                     cfg=cfg, kernels=kernels, sharder=sharder)
            args = (self._params_local, self._cache_local)
        if sc.compile_mode is not None:
            zeros = torch.zeros(sc.batch, dtype=torch.int64, device=self.device)
            self._step = _compiled(tick, (*args, {"tokens": zeros, "pos": zeros}),
                                   sc, self.device)
        else:
            self._step = cached_jit(tick, key=("serve_step", cfg.name, sc.batch, sc.max_len,
                                               repr(kernels), cfg.kv_cache_dtype,
                                               str(getattr(sharder, "mesh", "null"))),
                                    inplace_argnums=(0, 1))
            # on the card the graph reads this engine's cache at its address
            # and serves no other engine: it goes, with its pool, when the
            # engine does
            weakref.finalize(self, self._step.release)

    def graph_stats(self) -> dict:
        """The tick's captured graphs (core/cudagraph.py `graph_stats`):
        the cached_jit graph of this engine's weights and cache, or with
        `compile_mode` the compiled tick's captured plans."""
        if self.sc.compile_mode is not None:
            return self._step.app.capture_stats()
        return self._step.graph_stats()

    def submit(self, request_id: int, prompt: list[int]):
        self.queue.append((request_id, prompt))

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                rid, prompt = self.queue.popleft()
                self.slots[i] = {"id": rid, "prompt": prompt, "out": [], "fed": 0}

    def tick(self) -> int:
        """One engine tick: feed prompt tokens or decode; returns #active."""
        self._admit()
        feed = self.tokens.copy()
        for i, slot in enumerate(self.slots):
            if slot is not None and slot["fed"] < len(slot["prompt"]):
                feed[i] = slot["prompt"][slot["fed"]]   # teacher-force prompt
                slot["fed"] += 1
        feed_t = {"tokens": torch.from_numpy(feed).to(self.device),
                  "pos": torch.full((self.sc.batch,), self.pos, dtype=torch.int64,
                                    device=self.device)}
        if self.sharded:
            # the cache's local shards are written in place under the DTensors
            out = self._step(self._params_local, self._cache_local, feed_t)
        else:
            out = self._step(self.params, self.cache, feed_t)
            self.cache = out["cache"]
        self.pos += 1
        nxt = out["tokens"].cpu().numpy()
        active = 0
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot["fed"] >= len(slot["prompt"]):
                slot["out"].append(int(nxt[i]))
            limit = self.sc.max_len - len(slot["prompt"]) - 1
            if (slot["out"] and slot["out"][-1] == self.eos) or len(slot["out"]) >= limit:
                self.done[slot["id"]] = slot["out"]
                self.slots[i] = None
            else:
                active += 1
        self.tokens = nxt
        return active + len(self.queue)

    def run_until_done(self, max_ticks: int = 10_000) -> dict[int, list[int]]:
        for _ in range(max_ticks):
            if self.tick() == 0:
                break
        return self.done


# ---------------------------------------------------------------------------
# paged engine
# ---------------------------------------------------------------------------

class RequestHandle:
    """Future/stream for one submitted request.

    `tokens()` snapshots what has been generated so far (streaming);
    `result()` blocks until completion and returns the full output, raising
    if the request was rejected or failed."""

    def __init__(self, rid: int, prompt: list[int]):
        self.rid = rid
        self.prompt = prompt
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._tokens: list[int] = []
        self._error: BaseException | None = None

    def _append(self, tok: int) -> None:
        with self._lock:
            self._tokens.append(tok)

    def _finish(self) -> None:
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def error(self) -> BaseException | None:
        return self._error

    def tokens(self) -> list[int]:
        with self._lock:
            return list(self._tokens)

    def result(self, timeout: float | None = None) -> list[int]:
        if not self._event.wait(timeout):
            # a handle failed while we were waiting still reports ITS error
            if self._error is not None:
                raise self._error
            raise TimeoutError(
                f"request {self.rid} still running after {timeout}s "
                f"({len(self.tokens())} tokens so far)")
        if self._error is not None:
            raise self._error
        return self.tokens()


# batch axis of each recurrent (non-KV) cache entry, per models/lm.init_cache
_AUX_BATCH_AXIS = {"ssm": 1, "mC": 2, "mn": 2, "mm": 2, "sc": 2, "sn": 2, "sm": 2}


def aux_state(cfg: ArchConfig, batch: int, device) -> dict:
    """The recurrent (non-KV) entries of `lm.init_cache` for `batch` slots
    in their initial state: {} for a family that only attends."""
    full = lm.init_cache(cfg, batch, 1, device=device)
    return {k: v for k, v in full.items() if k in _AUX_BATCH_AXIS}


def paged_tick(params, state, cfg: ArchConfig, *, block_size: int,
               n_steps: int, mode: str = "gather", kernels: KernelConfig = KernelConfig(),
               sharder=NULL):
    """One serving tick over paged KV: `n_steps` decode steps with per-slot
    activity masks (chunked prefill and decode mixed in one tick).

    mode="gather" (the oracle): gather a dense per-slot view from the page
    pools, decode against the view (flash_decode), scatter the newly written
    positions back to their pages.
    mode="native": attention indexes the pools through the block tables
    (paged_flash_decode); new K/V land on their page rows as they are
    produced, so neither the view nor the scatter exists.  Bitwise equal to
    "gather": both kernels run one chunk function over the same rows.

    state (tensors on one device):
      tokens (B, n_steps)        input token per slot per step (padded)
      n_tok  (B,)                active steps per slot; 0 = idle slot
      pos    (B,)                per-slot write position at tick start
      tables (B, V) int32        physical page id per logical block
      kp/vp  (P, G, A, Hkv, D)   flat page pools (P = (num_blocks+1) * bs;
                                 page 0 is the reserved null page), updated
                                 in place; the activation dtype or e4m3
      + recurrent entries (ssm/mC/...) keyed as in lm.init_cache, updated
        in place in the active slots only
    A family with no KV (xlstm) has no tables and pools.

    A slot's outputs depend only on its own fed tokens: masked-out steps
    write at a stationary position that a later active step overwrites, or
    that is redirected to the null page (native) / skipped by the scatter
    (gather); positions past a slot's valid length get probability 0; an
    inactive slot's recurrent state is written back unchanged.

    Under a `sharder` (params and pools DTensors on its mesh) the decode
    steps pin their activations at the reference's sites, and the sampled
    tokens and logits come back whole (plain tensors); the gather path's
    view and scatter run on each rank's local pool shards (`_pool_view`,
    `layers._write`).
    """
    model = get_model(cfg)
    tokens, n_tok, pos = state["tokens"], state["n_tok"], state["pos"]
    b, bs = tokens.shape[0], block_size
    has_kv = "kp" in state
    native = has_kv and mode == "native"
    cache = {name: state[name] for name in _AUX_BATCH_AXIS if name in state}
    if has_kv:
        kp, vp, tables = state["kp"], state["vp"], state["tables"]
        v_blocks, tables_l = tables.shape[1], tables.long()
    if native:
        cache.update(kp=kp, vp=vp)
    elif has_kv:
        view_len = v_blocks * bs
        rows = paged_rows(tables, bs)
        cache.update(k=_pool_view(kp, rows), v=_pool_view(vp, rows))
    pos0 = pos
    logits = None
    for j in range(n_steps):
        active = n_tok > j
        if native:
            # flat pool row of each slot's new K/V; inactive slots write the
            # null page's row 0
            blk = (pos // bs).clamp(max=v_blocks - 1)
            phys = tables_l.gather(1, blk[:, None])[:, 0]
            write_rows = torch.where(active, phys * bs + pos % bs, torch.zeros_like(pos))
            lg, _ = model.decode_step(params, tokens[:, j], pos, cache,
                                      block_tables=tables, block_size=bs,
                                      kv_write_rows=write_rows, state_mask=active,
                                      kernels=kernels, sharder=sharder)
        else:
            lg, _ = model.decode_step(params, tokens[:, j], pos, cache, state_mask=active,
                                      kernels=kernels, sharder=sharder)
        if is_sharded(sharder):
            lg = full_tensor(lg)
        logits = lg if logits is None else torch.where(active[:, None], lg, logits)
        pos = torch.where(active, pos + 1, pos)

    out = {"tokens_next": logits.argmax(dim=-1), "logits": logits, "pos": pos}
    if not has_kv:
        return out
    if not native:
        # scatter the freshly written view columns back to their pages;
        # columns of masked steps go to the null page's row 0
        steps = torch.arange(n_steps, device=pos0.device)
        wpos = pos0[:, None] + steps[None, :]                        # (B, C)
        phys = tables_l.gather(1, (wpos // bs).clamp(max=v_blocks - 1))
        flat = torch.where(steps[None, :] < n_tok[:, None], phys * bs + wpos % bs,
                           torch.zeros_like(wpos)).reshape(-1)
        cols = wpos.clamp(max=view_len - 1)
        for pool, view in ((kp, cache["k"]), (vp, cache["v"])):
            # under a sharder on every rank's local shards, the view laid
            # out as its pool; the indices line up with the view's slots
            _write(_pool_scatter, pool, view, _VIEW_DIM, cols, flat, index_dim=2)
    return {**out, "kp": kp, "vp": vp}


# pool dim -> the dim of the dense view (`_pool_view`) that it becomes
_VIEW_DIM = {1: 0, 2: 1, 3: 3, 4: 5}


def _pool_view(pool, rows):
    """The dense cache layout (G, A, B, H, L, D) of a page pool's rows
    (B, L): (B, L, G, A, H, D) permuted.  A DTensor pool's view is taken on
    every rank's local shards (`local_map`: DTensor has no index into a
    tensor sharded on another dim) and laid out as its pool (`_VIEW_DIM`);
    the pools are never split on their indexed row dim (`pool_placement`)."""
    if not is_dtensor(pool):
        return pool[rows].permute(2, 3, 0, 4, 1, 5).contiguous()
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if any(isinstance(p, Shard) and p.dim == 0 for p in pool.placements):
        raise NotImplementedError("a page pool split on its row dim")
    mesh = pool.device_mesh
    view_pl = tuple(Shard(_VIEW_DIM[p.dim]) if isinstance(p, Shard) else p
                    for p in pool.placements)
    rows = DTensor.from_local(rows, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    return local_map(_pool_view, out_placements=(view_pl,),
                     in_placements=(pool.placements, rows.placements), device_mesh=mesh,
                     redistribute_inputs=True)(pool, rows)


def _pool_scatter(pool, view, cols, flat):
    """Write each slot's view columns `cols` (B, C) back to their flat pool
    rows `flat` (B * C), in place."""
    slots = torch.arange(cols.shape[0], device=cols.device)[:, None]
    written = view[:, :, slots, :, cols]                             # (B, C, G, A, H, D)
    pool[flat] = written.reshape(flat.shape[0], *pool.shape[1:])


# the tick state the engine keeps on the card between ticks: the page pools
# and the recurrent state, updated in place; the rest is the per-tick feed
_TICK_STATE = frozenset(("kp", "vp", *_AUX_BATCH_AXIS))


def _split_tick(params, held: dict, feed: dict, **kw):
    """`paged_tick` with the state the engine keeps (`_TICK_STATE`) apart
    from the per-tick tokens, n_tok, positions and tables."""
    return paged_tick(params, {**feed, **held}, **kw)


def _local_split_tick(params, held: dict, feed: dict, *, tick, layouts: dict, sharder):
    """`tick` (a `_split_tick`) over the local shards of DTensor params and
    held state (`split_local`), as `_local_tick` is for the legacy engine:
    the pools it returns are the local shards it wrote in place."""
    out = tick(join_local(params, layouts["params"]), join_local(held, layouts["held"]),
               feed, sharder=sharder)
    return {**out, **{k: held[k] for k in out if k in held}}


class TickGraphError(EngineError):
    """Capturing or replaying a tick's CUDA graph failed.  The device's
    fault, not a request's: `PagedServingEngine.tick` blames no request,
    degrades the engine and raises it, and nothing retries eagerly."""


class CapturedTick:
    """One (n_steps, v_blocks) bucket of `paged_tick` as a CUDA graph
    (core/cudagraph.py `CapturedGraph`, in the engine's one graph pool).

    Owns static input buffers -- tokens (B, n_steps), n_tok (B,), pos (B,)
    int64 and tables (B, v_blocks) int32 (none without KV) -- and uses the
    engine's page pools and recurrent-state buffers (`aux`) in place: the
    graph updates them as the eager tick does, and the engine's refill
    reset writes into the same buffers before a replay, on the same stream.
    The warm-up run and the capture both see n_tok = 0 in every slot, so
    every KV row they write is the null page's row 0 and every slot's
    recurrent state is written back as it was: capturing between two live
    ticks leaves every slot's pages and state bitwise as they were, and
    neither the warm-up nor the capture counts as a tick's launches.

    Calling it copies the host tensors of a tick state into the buffers,
    replays the graph on the current stream and returns its outputs
    ("tokens_next", "pos" and "logits"; the logits are a copy, since the
    next replay overwrites the graph's own buffer).  Each replay adds what
    the capture launched to the launch counters."""

    def __init__(self, params, cfg: ArchConfig, kp: torch.Tensor | None,
                 vp: torch.Tensor | None, aux: dict, *, batch: int, block_size: int,
                 n_steps: int, v_blocks: int, mode: str, pool,
                 kernels: KernelConfig = KernelConfig(), sharder=NULL):
        dev = params["embed"].device
        i64 = dict(dtype=torch.int64, device=dev)
        self.state = {"tokens": torch.zeros((batch, n_steps), **i64),
                      "n_tok": torch.zeros(batch, **i64), "pos": torch.zeros(batch, **i64),
                      **aux}
        self.inputs = ("tokens", "n_tok", "pos")
        if kp is not None:
            self.state.update(tables=torch.zeros((batch, v_blocks), dtype=torch.int32,
                                                 device=dev), kp=kp, vp=vp)
            self.inputs += ("tables",)
        tick = functools.partial(paged_tick, params, self.state, cfg, block_size=block_size,
                                 n_steps=n_steps, mode=mode, kernels=kernels, sharder=sharder)
        try:
            self.graph = CapturedGraph(tick, dev, what=f"the tick ({n_steps} steps, "
                                       f"{v_blocks} blocks)", pool=pool, count_warm_up=False)
        except GraphCaptureError as exc:
            raise TickGraphError(str(exc), site="tick.graph") from exc
        self.graph.first = None
        self.out = {k: self.graph.out[k] for k in ("tokens_next", "pos", "logits")}
        self.launches = self.graph.launches

    @property
    def replays(self) -> int:
        return self.graph.replays

    def __call__(self, state: dict) -> dict:
        try:
            for k in self.inputs:
                self.state[k].copy_(state[k])
            self.graph.replay()
        except Exception as exc:
            raise TickGraphError(f"replaying the tick failed: {type(exc).__name__}: {exc}",
                                 site="tick.graph") from exc
        return {**self.out, "logits": self.out["logits"].clone()}


class PagedKVExecutor:
    """Capacity owner for the paged engine, in the vLLM ExecutorBase shape:
    `get_max_allowed_kv_blocks()` runs a profiling pass (parameter bytes +
    one tick's working set against MEMORY_FRACTION of the memory the
    allocator can reach on the card), the engine decides
    the final count, `initialize_cache(n)` allocates the page pools."""

    DEFAULT_BUDGET = 256 * 1024 * 1024   # no device memory to read (CPU)
    # share of the card's reachable memory the capacity model plans for; the
    # rest is headroom for allocator fragmentation, library workspaces and
    # ticks longer than the profiled one
    MEMORY_FRACTION = 0.9

    def __init__(self, cfg: ArchConfig, params, sc: ServeConfig, *,
                 fault: FaultInjector | None = None, kernels: KernelConfig = KernelConfig(),
                 sharder=NULL):
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.fault = fault
        self.kernels = kernels
        self.sharder = sharder
        self.device = _device_of(params)
        self.profile_error: str | None = None
        template = lm.init_cache(cfg, 1, sc.block_size, device="meta")["k"]
        g, a, _, h, _, d = template.shape
        self.page_shape = (g, a, h, d)
        self.kv_dtype = template.dtype
        self.max_blocks = blocks_for(sc.max_len, sc.block_size)
        # bytes of ONE logical block: its K page + its V page (1 byte an
        # element in a float8 cache)
        self.block_bytes = 2 * sc.block_size * g * a * h * d * template.element_size()

    def _device_budget(self) -> int:
        if self.sc.mem_budget_bytes is not None:
            return self.sc.mem_budget_bytes
        if self.device.type == "cuda":
            # what the allocator can still get from the driver plus what it
            # already holds (the parameters among it); the CUDA context and
            # other processes' memory lie outside both
            free, _ = torch.cuda.mem_get_info(self.device)
            reachable = free + torch.cuda.memory_reserved(self.device)
            return int(self.MEMORY_FRACTION * reachable)
        return self.DEFAULT_BUDGET

    def profile_run(self) -> int:
        """Peak bytes one 1-step tick allocates beyond what is already held
        (1-block view, 1-block pool): the activation term of the capacity
        model, read from `torch.cuda.max_memory_allocated`; 0 off the card.
        Raises MemoryError at the `executor.profile` fault site."""
        if self.fault is not None and self.fault.check("executor.profile"):
            raise MemoryError("injected OOM at executor.profile")
        if self.device.type != "cuda":
            return 0
        b, dev = self.sc.batch, self.device
        kp, vp = place_pools(self.sharder, *self.initialize_cache(1))
        zeros = dict(dtype=torch.int64, device=dev)
        state = {"tokens": torch.zeros((b, 1), **zeros), "n_tok": torch.zeros(b, **zeros),
                 "pos": torch.zeros(b, **zeros),
                 "tables": torch.zeros((b, 1), dtype=torch.int32, device=dev),
                 "kp": kp, "vp": vp, **aux_state(self.cfg, b, dev)}
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        paged_tick(self.params, state, self.cfg, block_size=self.sc.block_size,
                   n_steps=1, mode=self.sc.paged_attention, kernels=self.kernels,
                   sharder=self.sharder)
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) - held

    def get_max_allowed_kv_blocks(self) -> tuple[int, int]:
        """(device_blocks, swap_blocks).  device_blocks = what fits in the
        budget after parameters and the tick working set; floored at
        max_blocks + batch so a full-length request plus one block per slot
        always fits.  No host swap tier, so swap_blocks is 0."""
        budget = self._device_budget()
        param_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(split_local(self.params)[0]))
        floor = self.max_blocks + self.sc.batch
        try:
            act_bytes = self.profile_run()
        except MemoryError as exc:
            # profiling OOMed: fall back to the guaranteed-viable floor
            self.profile_error = str(exc)
            return floor, 0
        n = (budget - param_bytes - act_bytes) // self.block_bytes
        return max(int(n), floor), 0

    def initialize_cache(self, num_blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Allocate the K and V page pools: page 0 is the reserved null
        page, usable pages are rows [bs, (num_blocks+1)*bs)."""
        rows = (num_blocks + 1) * self.sc.block_size
        kp = torch.zeros((rows, *self.page_shape), dtype=self.kv_dtype, device=self.device)
        return kp, torch.zeros_like(kp)


def place_pools(sharder, kp: torch.Tensor, vp: torch.Tensor):
    """The page pools as a tick reads them under `sharder`: DTensors laid
    out by `pool_placement` (under NULL, the pools themselves)."""
    if not is_sharded(sharder):
        return kp, vp
    return tuple(place(t, pool_placement(sharder, t)) for t in (kp, vp))


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class PagedServingEngine:
    """Block-paged continuous batching with per-slot position tracking.

    Each slot carries its own (pos, block-table row); the decode kernels see
    a per-slot (B,) valid-length vector, so a slot refilled mid-stream is
    bitwise identical to serving its request alone.  Prompts prefill in
    budget-bounded chunks mixed into decode ticks; finished prompts publish
    their KV pages to the prefix cache for later requests to reuse."""

    def __init__(self, cfg: ArchConfig, params, sc: ServeConfig, *,
                 eos_id: int = 1, clock=time.monotonic,
                 kernels: KernelConfig = KernelConfig(), sharder=NULL):
        if cfg.family == "encdec":
            raise ValueError("paged serving covers decoder-only families")
        if sc.paged_attention not in ("gather", "native"):
            raise ValueError("paged_attention must be 'gather' or 'native', "
                             f"got {sc.paged_attention!r}")
        check_decode(cfg)                # refuses what the port cannot decode
        self.sharder, self.sharded = sharder, is_sharded(sharder)
        _apply_cache_capacity(sc)
        self.cfg = cfg
        if self.sharded and not is_dtensor(params["embed"]):
            params = sharder.distribute(params)
        self.params = params
        self.sc = sc
        self.kernels = kernels
        self.device = _device_of(params)
        self.eos = eos_id
        self.clock = clock               # injectable for deadline tests
        self.injector = (FaultInjector(tuple(sc.fault_plan), sc.fault_seed)
                         if sc.fault_plan else None)

        b = sc.batch
        self.max_blocks = blocks_for(sc.max_len, sc.block_size)
        # per-slot recurrent state: the initial values, and the buffers the
        # ticks advance in place (a captured tick's graph holds these)
        full = lm.init_cache(cfg, b, 1, device=self.device)
        self.aux_init = {k: v for k, v in full.items() if k in _AUX_BATCH_AXIS}
        self.aux = {k: v.clone() for k, v in self.aux_init.items()}
        # what a tick reads: under a sharder, replicated DTensors over the
        # very buffers (the refill reset writes the buffers themselves)
        self._tick_aux = {k: replicated_view(sharder, v) for k, v in self.aux.items()}
        self.has_kv = "k" in full
        self.executor = self.pool = self.prefix = self.tables = None
        self.kp = self.vp = None
        self._pools = (None, None)
        if self.has_kv:
            self.executor = PagedKVExecutor(cfg, params, sc, fault=self.injector,
                                            kernels=kernels, sharder=sharder)
            if sc.num_blocks is not None:
                num = sc.num_blocks
            else:
                num, _ = self.executor.get_max_allowed_kv_blocks()
            # under a sharder the ticks read DTensor pools over the local
            # shards this engine keeps as kp / vp
            self._pools = place_pools(sharder, *self.executor.initialize_cache(num))
            self.kp, self.vp = (t.to_local() if self.sharded else t for t in self._pools)
            self.pool = BlockPool(num, sc.block_size,
                                  on_evict=lambda key, bid: self.prefix.on_evict(key, bid),
                                  fault=self.injector)
            self.prefix = PrefixCache(self.pool)
            self.tables = np.zeros((b, self.max_blocks), np.int32)
        # prefix reuse is only sound when KV pages are the whole model state:
        # a recurrent family would need the matching recurrent state too
        self.prefix_enabled = sc.prefix_caching and self.has_kv and not self.aux_init

        self.scheduler = Scheduler(block_size=sc.block_size,
                                   prefill_chunk=sc.prefill_chunk,
                                   token_budget=sc.token_budget,
                                   n_slots=b, max_queue=sc.max_queue)
        self.slots: list[dict | None] = [None] * b
        self.pos = np.zeros(b, np.int64)
        self.done: dict[int, list[int]] = {}
        self.failed: dict[int, EngineError] = {}
        self.handles: dict[int, RequestHandle] = {}
        self._rid = 0
        self._view_buckets = ([0] if not self.has_kv
                              else list(range(1, self.max_blocks + 1)) if sc.view_buckets
                              else [self.max_blocks])
        # the tick per (n_steps, v_blocks) bucket (_get_step); on the card
        # every CapturedTick of the engine shares one graph memory pool
        self._steps: dict[tuple[int, int], object] = {}
        self._graph_pool = None
        self.ticks = 0
        self.decode_steps = 0            # decode steps run, over all ticks
        self.tokens_out = 0
        self.peak_active = 0
        # the last tick's (B, vocab) logits; on the card a copy of the
        # graph's buffer, which the next replay overwrites
        self.last_logits: torch.Tensor | None = None
        # analytic per-tick KV bytes for BOTH tick data paths, accumulated
        # from each tick's actual geometry (costmodel.paged_decode_traffic)
        self.kv_traffic = {"ticks": 0, "gather_bytes": 0, "native_bytes": 0}
        # -- health/degraded-mode state (health()) -------------------------
        self.state = "healthy"           # healthy | degraded | stopped
        self.last_error: EngineError | None = None
        self.consecutive_failures = 0
        self.ticks_since_progress = 0
        self._culprit_rid: int | None = None   # tick-scoped blame context
        self._tick_admitted: list[int] = []
        self._tick_no = 0
        self._progressed = False

    def _view_for(self, need_blocks: int) -> int:
        for v in self._view_buckets:
            if v >= need_blocks:
                return v
        return self._view_buckets[-1]

    # -- the tick per (chunk width, view) bucket ---------------------------
    def _get_step(self, n_steps: int, v_blocks: int):
        """The callable `_tick_inner` runs on a tick state for this bucket,
        made once per engine.  With `compile_mode`: `paged_tick` traced on
        this bucket's shapes and compiled in that mode.  Else on the CPU:
        `paged_tick`, eager; on a CUDA device: a `CapturedTick`, captured
        here on first use (on the calling thread); a failed capture raises
        TickGraphError."""
        key = (n_steps, v_blocks)
        fn = self._steps.get(key)
        if fn is not None:
            return fn
        sc = self.sc
        if sc.compile_mode is not None:
            tick = functools.partial(_split_tick, cfg=self.cfg, block_size=sc.block_size,
                                     n_steps=n_steps, mode=sc.paged_attention,
                                     kernels=self.kernels)
            example = self._example_state(n_steps, v_blocks)
            held = [k for k in example if k in _TICK_STATE]
            params = self.params
            if self.sharded:
                # traced over the local shards of the params, the pools and
                # the recurrent state, which the graph reads and writes in
                # place; the DTensors are wrapped around them inside
                params, p_lay = split_local(self.params)
                locals_, h_lay = split_local({k: self._tick_aux.get(k, example[k])
                                              for k in held})
                tick = functools.partial(_local_split_tick, tick=tick, sharder=self.sharder,
                                         layouts={"params": p_lay, "held": h_lay})
                example.update(locals_)
            compiled = _compiled(tick, (params, {k: example[k] for k in held},
                                        {k: v for k, v in example.items() if k not in held}),
                                 sc, self.device)
            own = {k: example[k] for k in held}

            def fn(state):
                # the engine's own buffers (under a sharder their local
                # shards), where the compiled plan reads and writes them
                return compiled(params, own,
                                {k: v for k, v in state.items() if k not in held})
            fn.app = compiled.app
        elif self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            fn = CapturedTick(self.params, self.cfg, *self._pools, self._tick_aux,
                              batch=sc.batch, block_size=sc.block_size, n_steps=n_steps,
                              v_blocks=v_blocks, mode=sc.paged_attention,
                              pool=self._graph_pool, kernels=self.kernels,
                              sharder=self.sharder)
        else:
            fn = functools.partial(paged_tick, self.params, cfg=self.cfg,
                                   block_size=sc.block_size, n_steps=n_steps,
                                   mode=sc.paged_attention, kernels=self.kernels,
                                   sharder=self.sharder)
        self._steps[key] = fn
        return fn

    def _example_state(self, n_steps: int, v_blocks: int) -> dict:
        """A tick state of one bucket's shapes on the engine's device (the
        trace's example), over the engine's own pools and state buffers."""
        b, dev = self.sc.batch, self.device
        i64 = dict(dtype=torch.int64, device=dev)
        st = {"tokens": torch.zeros((b, n_steps), **i64), "n_tok": torch.zeros(b, **i64),
              "pos": torch.zeros(b, **i64), **self.aux}
        if self.has_kv:
            st.update(tables=torch.zeros((b, v_blocks), dtype=torch.int32, device=dev),
                      kp=self._pools[0], vp=self._pools[1])
        return st

    def graph_stats(self) -> dict:
        """The captured ticks, summed by core/cudagraph.py `graph_stats`:
        graphs, replays, the seconds of the warm-ups and of the captures
        apart, and the bytes their graph pools hold on the card -- the
        CapturedTicks' shared pool, and with `compile_mode` the captured
        plans of each bucket's compiled tick."""
        stats = graph_stats(g.graph for g in self._steps.values()
                            if isinstance(g, CapturedTick))
        for fn in self._steps.values():
            if hasattr(fn, "app"):
                for k, v in fn.app.capture_stats().items():
                    stats[k] += v
        return stats

    # -- request lifecycle -------------------------------------------------
    def submit(self, prompt: list[int], rid: int | None = None,
               max_new_tokens: int | None = None,
               deadline_s: float | None = None) -> RequestHandle:
        """Enqueue a request.  Raises QueueFull when the bounded admission
        queue (`ServeConfig.max_queue`) is at capacity.  `deadline_s` (or
        the config default) fails the request with DeadlineExceeded once
        that many seconds pass -- queued requests before any prefill budget
        is spent, in-flight requests by slot eviction at the next tick."""
        if rid is None:
            self._rid += 1
            rid = self._rid
        handle = RequestHandle(rid, list(prompt))
        if self.state != "healthy":
            self.handles[rid] = handle
            handle._fail(EngineError(
                f"engine is {self.state}: request {rid} rejected",
                site="engine." + self.state, tick=self.ticks, rid=rid))
            return handle
        if deadline_s is None:
            deadline_s = self.sc.default_deadline_s
        req = Request(rid=rid, prompt=list(prompt), handle=handle,
                      max_new=max_new_tokens or self.sc.max_new_tokens,
                      deadline=None if deadline_s is None else self.clock() + deadline_s)
        if len(prompt) >= self.sc.max_len:
            self.handles[rid] = handle
            self.scheduler.rejected += 1
            handle._fail(ValueError(
                f"prompt of {len(prompt)} tokens >= max_len {self.sc.max_len}"))
            return handle
        if self.pool is not None and self.scheduler.admission_cost(req) > self.pool.num_blocks:
            self.handles[rid] = handle
            self.scheduler.rejected += 1
            handle._fail(ValueError(
                f"request needs {self.scheduler.admission_cost(req)} blocks; "
                f"pool holds {self.pool.num_blocks}"))
            return handle
        if not self.scheduler.submit(req):
            # a full bounded queue is an EXCEPTION, not a failed handle: the
            # caller must retry or shed, and no handle leaks into self.handles
            raise QueueFull(
                f"admission queue full ({self.sc.max_queue} waiting); "
                f"request {rid} not enqueued",
                site="engine.queue", tick=self.ticks, rid=rid)
        self.handles[rid] = handle
        return handle

    def _admit(self) -> None:
        for i in [i for i, s in enumerate(self.slots) if s is None]:
            req = self.scheduler.next_admission(self.pool)
            if req is None:
                break
            reused_bids: list[int] = []
            reused = 0
            if self.prefix_enabled and not req.resume_out:
                reused_bids, reused = self.prefix.match(req.prompt)
            if self.tables is not None:
                self.tables[i, :] = 0
                self.tables[i, :len(reused_bids)] = reused_bids
            self.slots[i] = {
                "rid": req.rid, "req": req, "prompt": req.prompt,
                "seq": req.feed, "out": list(req.resume_out),
                "fed": reused, "nblocks": len(reused_bids), "last": None,
                "handle": req.handle, "max_new": req.max_new,
                "admit_seq": self.scheduler.admit_seq, "chunk_fails": 0,
            }
            self.pos[i] = reused
            self._tick_admitted.append(req.rid)
            self._reset_state(i)

    def _reset_state(self, i: int) -> None:
        """Put slot i's recurrent state back to its initial value, in place
        in the tick's buffers (on the current stream, before the next
        tick): every admission -- a refill, or a preempted request's
        recompute -- starts from the state a fresh engine has."""
        for name, init in self.aux_init.items():
            ax = _AUX_BATCH_AXIS[name]
            self.aux[name].select(ax, i).copy_(init.select(ax, i))

    def _release(self, i: int, *, cache_prefix: bool) -> None:
        slot = self.slots[i]
        if self.pool is not None:
            bids = [int(b) for b in self.tables[i, :slot["nblocks"]]]
            if cache_prefix and self.prefix_enabled:
                self.prefix.insert(slot["prompt"], bids)
            for bid in bids:
                self.pool.decref(bid)
            self.tables[i, :] = 0
        self.pos[i] = 0
        self.slots[i] = None

    def _preempt(self, i: int) -> None:
        """Preemption-by-recompute: tear the slot down, requeue its request
        (prompt + generated-so-far) at the queue head.  Greedy decoding
        makes the recompute exact, so the handle keeps streaming."""
        req = self.slots[i]["req"]
        req.resume_out = list(self.slots[i]["out"])
        self._release(i, cache_prefix=False)
        if self.pool is not None and self.scheduler.admission_cost(req) > self.pool.num_blocks:
            self.scheduler.rejected += 1
            req.handle._fail(OutOfBlocks(f"request {req.rid} grew past pool capacity"))
            return
        self.scheduler.requeue(req)

    def _ensure_blocks(self, n_tok: list[int]) -> None:
        """Allocate pages so every slot's table covers pos + n_tok this
        tick; on exhaustion, preempt the newest slot and retry (the slot
        being grown preempts ITSELF when it is the newest)."""
        if self.pool is None:
            return
        order = sorted((s["admit_seq"], i) for i, s in enumerate(self.slots) if s is not None)
        for _, i in order:
            slot = self.slots[i]
            if slot is None or n_tok[i] == 0:
                continue
            # blame context: if allocation fails terminally, the request
            # whose growth triggered it is the culprit
            self._culprit_rid = slot["rid"]
            need = blocks_for(int(self.pos[i]) + n_tok[i], self.sc.block_size)
            while slot["nblocks"] < need:
                try:
                    bid = self.pool.alloc()
                except OutOfBlocks:
                    victim = self.scheduler.pick_victim(self.slots)
                    if victim is None:
                        raise
                    self._preempt(victim)
                    n_tok[victim] = 0
                    if victim == i:
                        break
                    continue
                self.tables[i, slot["nblocks"]] = bid
                slot["nblocks"] += 1
        self._culprit_rid = None

    # -- fault isolation ---------------------------------------------------
    def _slot_of(self, rid: int) -> int | None:
        for i, s in enumerate(self.slots):
            if s is not None and s["rid"] == rid:
                return i
        return None

    def _fail_request(self, rid: int, err: EngineError) -> None:
        """Terminal failure of ONE request: release its slot/blocks (or pull
        it from the waiting queue) and fail its handle -- co-tenants keep
        their state untouched, so survivors stay bitwise identical."""
        self.failed[rid] = err
        i = self._slot_of(rid)
        if i is not None:
            self.slots[i]["handle"]._fail(err)
            self._release(i, cache_prefix=False)
            return
        for req in list(self.scheduler.waiting):
            if req.rid == rid:
                self.scheduler.waiting.remove(req)
                req.handle._fail(err)
                return
        h = self.handles.get(rid)
        if h is not None and not h.done():
            h._fail(err)

    def _pick_culprit(self) -> int | None:
        """Blame for a whole-tick failure: the explicit culprit context if
        set, else the request admitted THIS tick, else the newest admission
        among live slots."""
        if self._culprit_rid is not None:
            return self._culprit_rid
        for rid in reversed(self._tick_admitted):
            if self._slot_of(rid) is not None:
                return rid
        live = [s for s in self.slots if s is not None]
        return max(live, key=lambda s: s["admit_seq"])["rid"] if live else None

    def _fail_all(self, message: str, site: str, tick: int) -> None:
        """Fail every live slot and queued request with an EngineError."""
        for i, s in enumerate(self.slots):
            if s is not None:
                tomb = EngineError(message, site=site, tick=tick, rid=s["rid"])
                self.failed[s["rid"]] = tomb
                s["handle"]._fail(tomb)
                self._release(i, cache_prefix=False)
        while self.scheduler.waiting:
            req = self.scheduler.waiting.popleft()
            tomb = EngineError(message, site=site, tick=tick, rid=req.rid)
            self.failed[req.rid] = tomb
            if req.handle is not None:
                req.handle._fail(tomb)

    def _enter_degraded(self, err: EngineError) -> None:
        """Terminal engine state: stop isolating, fail everything in flight
        and queued so every handle reaches a terminal state, report via
        health()."""
        self.state = "degraded"
        self.last_error = err
        self._fail_all(f"engine degraded at tick {self._tick_no}: {err}",
                       "engine.degraded", self._tick_no)

    def _fail_stragglers(self) -> None:
        """Late racers: a submit() that passed the health check on the caller
        thread may land in the queue after _enter_degraded() drained it.
        Every non-healthy tick() fails such leftovers so pending() reaches 0
        and drain()/result() raise instead of hanging."""
        suffix = "" if self.last_error is None else f": {self.last_error}"
        self._fail_all(f"engine is {self.state}{suffix}", "engine." + self.state,
                       self.ticks)

    def _expire_deadlines(self) -> None:
        now = self.clock()
        for req in self.scheduler.expire(now):
            err = DeadlineExceeded(
                f"request {req.rid} expired in queue "
                f"(deadline passed before admission)",
                site="engine.deadline", tick=self._tick_no, rid=req.rid)
            self.failed[req.rid] = err
            if req.handle is not None:
                req.handle._fail(err)
        for s in self.slots:
            if s is None:
                continue
            dl = s["req"].deadline
            if dl is not None and now > dl:
                self.scheduler.expired += 1
                self._fail_request(s["rid"], DeadlineExceeded(
                    f"request {s['rid']} expired in flight after "
                    f"{len(s['out'])} tokens", site="engine.deadline",
                    tick=self._tick_no, rid=s["rid"]))

    def health(self) -> dict:
        """Liveness snapshot: `state` is "healthy" until max_tick_retries
        CONSECUTIVE tick failures force the terminal "degraded" state
        ("stopped" once the owner closes the engine)."""
        return {"state": self.state,
                "last_error": self.last_error,
                "consecutive_failures": self.consecutive_failures,
                "ticks_since_progress": self.ticks_since_progress,
                "ticks": self.ticks,
                "failed": len(self.failed)}

    # -- the tick ----------------------------------------------------------
    def tick(self) -> int:
        """One engine tick; returns #requests still in flight afterwards.

        Any exception inside the tick is caught, blamed on the culpable
        request, and ONLY that handle fails with a structured EngineError;
        after `max_tick_retries` consecutive failing ticks the engine enters
        the terminal degraded state with every remaining handle failed.
        The one exception is TickGraphError, the device's failure to capture
        or replay the tick: no request is blamed, the engine degrades at once
        and the error propagates to the caller."""
        if self.state != "healthy":
            self._fail_stragglers()
            return 0
        t = self.ticks
        self.ticks = t + 1               # failed ticks advance the clock too
        self._tick_no = t
        self._tick_admitted = []
        self._culprit_rid = None
        self._progressed = False
        if self.injector is not None:
            self.injector.advance(t)
        self._expire_deadlines()
        try:
            left = self._tick_inner()
        except TickGraphError as exc:
            exc.tick = t
            self._enter_degraded(exc)
            raise
        except Exception as exc:  # noqa: BLE001 -- isolate, blame, keep serving
            self.consecutive_failures += 1
            self.ticks_since_progress += 1
            rid = self._pick_culprit()
            if isinstance(exc, EngineError):
                err = exc
            else:
                err = EngineError(f"tick {t} failed at {type(exc).__name__}: {exc}",
                                  site="tick.step", tick=t, rid=rid)
                err.__cause__ = exc
            err.tick, err.rid = t, rid
            self.last_error = err
            if rid is not None:
                self._fail_request(rid, err)
            if self.consecutive_failures >= self.sc.max_tick_retries or rid is None:
                self._enter_degraded(err)
            return self.pending()
        if self._progressed:
            self.consecutive_failures = 0
            self.ticks_since_progress = 0
        else:
            self.ticks_since_progress += 1
        return left

    def _prefill_faults(self, n_tok: list[int]) -> None:
        """`prefill.chunk` fault site: a firing spec makes one prefilling
        slot's chunk fail TRANSIENTLY (skipped this tick, retried next);
        after `max_chunk_retries` consecutive failures the request fails."""
        if self.injector is None:
            return
        prefilling = [i for i, s in enumerate(self.slots)
                      if s is not None and n_tok[i] > 0 and s["fed"] < len(s["seq"])]
        if not prefilling:
            return
        spec = self.injector.check("prefill.chunk")
        if spec is None:
            for i in prefilling:
                self.slots[i]["chunk_fails"] = 0
            return
        victims = [i for i in prefilling if spec.rid is None or self.slots[i]["rid"] == spec.rid]
        if not victims:
            return
        slot = self.slots[victims[-1]]          # newest-admitted qualifying slot
        n_tok[victims[-1]] = 0
        slot["chunk_fails"] += 1
        if slot["chunk_fails"] > self.sc.max_chunk_retries:
            self._fail_request(slot["rid"], EngineError(
                f"request {slot['rid']}: prefill chunk failed "
                f"{slot['chunk_fails']} consecutive times",
                site="prefill.chunk", tick=self._tick_no, rid=slot["rid"]))

    def _tick_inner(self) -> int:
        self._admit()
        n_tok = self.scheduler.plan(self.slots)
        self._prefill_faults(n_tok)
        self._ensure_blocks(n_tok)
        active = [i for i, t in enumerate(n_tok) if t > 0]
        if not active:
            return self.pending()
        self.peak_active = max(self.peak_active, sum(s is not None for s in self.slots))
        if self.injector is not None:
            spec = self.injector.check("tick.step")
            if spec is not None:
                # fires BEFORE the tick runs, so no pool row has been touched
                if spec.rid is not None:
                    self._culprit_rid = spec.rid
                raise EngineError(f"injected fault at tick.step (tick {self._tick_no})",
                                  site="tick.step", tick=self._tick_no, rid=spec.rid)

        c = 1 if max(n_tok) <= 1 else self.scheduler.chunk
        tokens = np.zeros((self.sc.batch, c), np.int64)
        for i in active:
            slot, t = self.slots[i], n_tok[i]
            if slot["fed"] < len(slot["seq"]):
                tokens[i, :t] = slot["seq"][slot["fed"]:slot["fed"] + t]
            else:
                tokens[i, 0] = slot["last"]
        # host tensors: the CPU tick runs on them, a captured one copies them
        # into its input buffers
        state = {"tokens": torch.from_numpy(tokens),
                 "n_tok": torch.tensor(n_tok, dtype=torch.int64),
                 "pos": torch.from_numpy(self.pos), **self._tick_aux}
        v_blocks = 0
        if self.has_kv:
            need = max(blocks_for(int(self.pos[i]) + n_tok[i], self.sc.block_size)
                       for i in active)
            v_blocks = self._view_for(need)
            kp, vp = self._pools
            state.update(tables=torch.from_numpy(self.tables[:, :v_blocks].copy()),
                         kp=kp, vp=vp)
        out = self._get_step(c, v_blocks)(state)
        nxt = out["tokens_next"].cpu().numpy()
        self.pos = out["pos"].cpu().numpy()
        self.last_logits = out["logits"]
        self.decode_steps += c
        self._progressed = True

        if self.has_kv:
            # analytic KV bytes for this tick's geometry, BOTH data paths
            g_, a_, h_, d_ = self.executor.page_shape
            tr = paged_decode_traffic(
                batch=self.sc.batch, v_blocks=v_blocks, block_size=self.sc.block_size,
                n_steps=c, row_bytes=h_ * d_ * self.kp.element_size(), n_sites=g_ * a_,
                alloc_blocks=int(np.count_nonzero(self.tables[:, :v_blocks])))
            self.kv_traffic["ticks"] += 1
            self.kv_traffic["gather_bytes"] += tr["gather_bytes"]
            self.kv_traffic["native_bytes"] += tr["native_bytes"]

        # slots that finish prefill this tick sample their first/next token
        sampling = [i for i in active
                    if self.slots[i]["fed"] + n_tok[i] >= len(self.slots[i]["seq"])]
        logits_np = None
        if self.injector is not None and sampling:
            spec = self.injector.check("tick.logits")
            if spec is not None:
                # `tick.logits` fault site: corrupt ONE sampling slot's logits
                # at the host boundary and derail its sampled token the way a
                # real NaN argmax would; co-tenant state stays untouched
                victims = [i for i in sampling
                           if spec.rid is None or self.slots[i]["rid"] == spec.rid]
                if victims:
                    logits_np = out["logits"].float().cpu().numpy()
                    logits_np[victims[-1], :] = np.nan if spec.mode == "nan" else np.inf
                    nxt[victims[-1]] = 0
        if self.sc.nan_guard and sampling and logits_np is None:
            logits_np = out["logits"].float().cpu().numpy()
        poisoned: set[int] = set()
        if self.sc.nan_guard and logits_np is not None:
            poisoned = {i for i in sampling if not np.isfinite(logits_np[i]).all()}

        for i in active:
            slot = self.slots[i]
            slot["fed"] += n_tok[i]
            if slot["fed"] < len(slot["seq"]):
                continue                        # still prefilling
            if i in poisoned:
                self._fail_request(slot["rid"], EngineError(
                    f"request {slot['rid']}: non-finite decode logits "
                    f"at tick {self._tick_no}", site="tick.logits",
                    tick=self._tick_no, rid=slot["rid"]))
                continue
            tok = int(nxt[i])
            slot["out"].append(tok)
            slot["last"] = tok
            slot["handle"]._append(tok)
            self.tokens_out += 1
            limit = self.sc.max_len - len(slot["prompt"]) - 1
            if slot["max_new"] is not None:
                limit = min(limit, slot["max_new"])
            if tok == self.eos or len(slot["out"]) >= limit:
                self.done[slot["rid"]] = slot["out"]
                slot["handle"]._finish()
                self._release(i, cache_prefix=True)
        return self.pending()

    def pending(self) -> int:
        return sum(s is not None for s in self.slots) + len(self.scheduler.waiting)

    def run_until_done(self, max_ticks: int = 10_000) -> dict[int, list[int]]:
        for _ in range(max_ticks):
            if self.tick() == 0:
                break
        return self.done

    def stats(self) -> dict:
        s = {"ticks": self.ticks, "decode_steps": self.decode_steps,
             "tokens_out": self.tokens_out, "peak_active": self.peak_active,
             "scheduler": self.scheduler.stats(), "health": self.health()}
        if self.pool is not None:
            s["pool"] = self.pool.check()
        n = self.kv_traffic["ticks"]
        if n:
            s["kv_traffic"] = {
                "mode": self.sc.paged_attention, "ticks": n,
                "gather_bytes_per_tick": self.kv_traffic["gather_bytes"] / n,
                "native_bytes_per_tick": self.kv_traffic["native_bytes"] / n,
                "reduction": (self.kv_traffic["gather_bytes"]
                              / max(self.kv_traffic["native_bytes"], 1)),
            }
        if self.prefix_enabled:
            s["prefix_cache"] = self.prefix.stats()
        if self.injector is not None:
            s["faults_fired"] = self.injector.fired()
        if self.executor is not None and self.executor.profile_error:
            s["profile_error"] = self.executor.profile_error
        if self.device.type == "cuda":
            s["graphs"] = self.graph_stats()
        return s


class AsyncServingEngine:
    """Background tick loop around a PagedServingEngine.

    `submit()` enqueues from any thread and returns the streaming handle
    immediately; a daemon thread ticks whenever work is pending and parks on
    a condition variable when idle.  On the card that thread also captures
    the ticks' CUDA graphs, in the "thread_local" capture mode, so the
    submitting threads' own CUDA calls cannot break a capture.  `drain()`
    waits for in-flight requests to finish and stops the loop; the engine
    is also a context manager.  If
    a tick raises past the engine's own isolation, the loop records it as
    the TERMINAL error, degrades the engine (failing every handle) and
    exits; `drain()` then raises that error.  Keyword arguments (`eos_id`,
    `kernels`, ...) go to the PagedServingEngine it builds."""

    def __init__(self, cfg: ArchConfig | None = None, params=None,
                 sc: ServeConfig | None = None, *,
                 engine: PagedServingEngine | None = None, **kw):
        if engine is None:
            engine = PagedServingEngine(cfg, params, sc, **kw)
        self.engine = engine
        self._cond = threading.Condition()
        self._running = False
        self._error: BaseException | None = None   # terminal loop error
        self._thread: threading.Thread | None = None

    def start(self) -> "AsyncServingEngine":
        with self._cond:
            if self._running:
                return self
            self._running = True
            self._thread = threading.Thread(target=self._loop, name="serve-tick",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)   # per-thread current device
        while True:
            with self._cond:
                while self._running and self.engine.pending() == 0:
                    self._cond.notify_all()          # wake drain() waiters
                    self._cond.wait(timeout=0.05)
                if not self._running:
                    self._cond.notify_all()
                    return
            # tick OUTSIDE the lock: submissions only append to the
            # scheduler's deque, which tick consumes on its next admission
            try:
                self.engine.tick()
            except BaseException as exc:  # noqa: BLE001 -- loop must not die silently
                with self._cond:
                    self._error = exc
                    try:
                        self.engine._enter_degraded(
                            exc if isinstance(exc, EngineError)
                            else EngineError(f"tick loop died: {exc}", site="engine.loop"))
                    finally:
                        self._running = False
                        self._cond.notify_all()
                return
            with self._cond:
                self._cond.notify_all()

    def health(self) -> dict:
        h = self.engine.health()
        if self._error is not None:
            h["loop_error"] = self._error
        if self._thread is not None and not self._thread.is_alive():
            h["loop_alive"] = False
        return h

    def submit(self, prompt: list[int], rid: int | None = None,
               max_new_tokens: int | None = None, deadline_s: float | None = None,
               queue_timeout: float | None = None) -> RequestHandle:
        """Thread-safe submit.  On a full bounded queue (QueueFull):
        `queue_timeout=None` re-raises immediately; a number blocks up to
        that many seconds for the queue to shrink, then raises."""
        if self._thread is None:
            self.start()
        deadline = None if queue_timeout is None else time.monotonic() + queue_timeout
        with self._cond:
            while True:
                if self._error is not None:
                    raise self._error
                try:
                    handle = self.engine.submit(prompt, rid=rid,
                                                max_new_tokens=max_new_tokens,
                                                deadline_s=deadline_s)
                except QueueFull:
                    if deadline is None:
                        raise
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        raise
                    continue
                self._cond.notify_all()
                return handle

    def drain(self, timeout: float | None = None) -> dict[int, list[int]]:
        """Graceful stop: wait for all in-flight work, then halt the loop.
        Raises the loop's TERMINAL error when the tick thread died with work
        still pending."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.engine.pending() > 0:
                if self._error is not None:
                    raise self._error
                if self._running and (self._thread is None or not self._thread.is_alive()):
                    raise RuntimeError("serve-tick thread died with work pending")
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    h = self.engine.health()
                    raise TimeoutError(
                        f"drain timed out with {self.engine.pending()} "
                        f"requests pending (engine {h['state']}, "
                        f"{h['ticks_since_progress']} ticks since progress)")
                self._cond.wait(remaining if remaining is not None else 0.1)
        self.close()
        return self.engine.done

    def close(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.engine.state == "healthy":
            self.engine.state = "stopped"

    def __enter__(self) -> "AsyncServingEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.drain()
        else:
            self.close()
