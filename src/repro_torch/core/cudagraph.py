"""CUDA graphs: the port's compiled executable on the card.

XLA has no addresses: the reference compiles a program once per shape
and runs it on whatever buffers a call brings.  A CUDA graph records
device addresses, so the port's counterpart of a compiled executable is a
graph over buffers that stay where they are.  This module holds the one
capture sequence every caller uses -- the paged engine's `CapturedTick`,
`cached_jit` (core/compiler.py) and the executor's captured
`ExecutionPlan` (core/executor.py):

  * a warm-up runs first, on the device's one capture stream, so that
    every lazy first-use step (a kernel library's load, a shared-memory
    attribute, cuBLAS's workspace for that stream, a Dynamo compile)
    happens outside the capture;
  * the capture runs on the same stream in the "thread_local" mode (a
    thread serving requests may capture while other threads make CUDA
    calls), with the garbage collector off (a graph it destroyed
    mid-capture would invalidate the capture); captures in one process
    take turns under one lock;
  * the kernels' launch counters are Python increments that a replay does
    not move: what the capture recorded is rolled back and added again by
    every replay.

A failure to capture or to replay raises `GraphCaptureError`; nothing
falls back to an uncaptured run.
"""
from __future__ import annotations

import functools
import gc
import threading
import time
from typing import Any, Callable, Iterable, Sequence

import torch
from torch.utils import _pytree as pytree

from ..kernels import add_launches, launch_delta, launch_state, restore_launches


class GraphCaptureError(RuntimeError):
    """Capturing or replaying a CUDA graph failed."""


_capture_lock = threading.RLock()


def capture_lock() -> threading.RLock:
    """The lock every capture in the process takes (re-entrant).  A caller
    that must keep other captures out for longer -- the lowering pass
    timing its candidates' replays -- holds it, and takes it before any
    lock of its own."""
    return _capture_lock


@functools.cache
def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every capture on `device` warms up and is captured on,
    one for the process: cuBLAS keeps a workspace for each stream it has
    run on, which a stream per graph would leave behind per graph."""
    return torch.cuda.Stream(device)


def pool_bytes(*pools) -> int:
    """Bytes the allocator's segments of the graph memory pools hold."""
    ids = {tuple(p) for p in pools}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in ids)


def graph_stats(graphs: Iterable["CapturedGraph"]) -> dict[str, float]:
    """`CapturedGraph.stats()` summed over `graphs`, with the bytes their
    distinct graph pools hold (`pool_bytes`)."""
    graphs = list(graphs)
    out = {"graphs": 0, "replays": 0, "warm_up_s": 0.0, "capture_s": 0.0}
    for g in graphs:
        for k, v in g.stats().items():
            out[k] += v
    out["pool_bytes"] = pool_bytes(*(g.pool for g in graphs)) if graphs else 0
    return out


def _message(what: str, exc: BaseException) -> str:
    notes = "; ".join(getattr(exc, "__notes__", ()))
    return f"{what}: {type(exc).__name__}: {exc}" + (f" ({notes})" if notes else "")


def _reset_generators(device: torch.device, stream: torch.cuda.Stream) -> None:
    """After a failed capture: PyTorch takes the device's random generator
    out of its capture mode only when a capture ends well, so every later
    random op on the device would fail.  One small capture that ends well
    takes it out."""
    scratch = torch.zeros(1, device=device)
    with torch.cuda.stream(stream), torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
        scratch.uniform_()


class CapturedGraph:
    """`fn()` captured as one CUDA graph on `device`.

    `warm_up()` (default: `fn`) runs first on the device's capture stream;
    its result is `first`, and its launches count unless `count_warm_up` is
    False.  Then `fn` is captured on that stream into `graph`, allocating
    from `pool` (a private pool of its own by default), and its outputs,
    which live in the pool, are `out`.  `launches` is what the capture
    recorded; every `replay()` adds it.  `warm_up_s` and `capture_s` are
    the seconds the two took.  Dropping the last reference to the
    object frees the graph, and the pool's memory goes back to the card at
    the next `torch.cuda.empty_cache()` once no graph uses it."""

    def __init__(self, fn: Callable[[], Any], device, *, what: str, pool=None,
                 warm_up: Callable[[], Any] | None = None, count_warm_up: bool = True):
        self.what = what
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        device = torch.device(device)
        stream = capture_stream(device)
        raised: list[BaseException] = []

        def body():
            try:
                return fn()
            except BaseException as exc:
                raised.append(exc)
                raise

        t0 = time.perf_counter()
        counts = launch_state()
        with _capture_lock:
            try:
                current = torch.cuda.current_stream(device)
                stream.wait_stream(current)
                with torch.cuda.stream(stream):
                    self.first = (warm_up or body)()
                current.wait_stream(stream)
                self.warm_up_s = time.perf_counter() - t0
                if count_warm_up:
                    counts = launch_state()
                self.graph = torch.cuda.CUDAGraph()
                at_capture = launch_state()
                gc.collect()
                collecting = gc.isenabled()
                gc.disable()
                try:
                    # the outer context puts the caller's stream back even
                    # when the capture's own exit raises
                    with torch.cuda.stream(stream), torch.cuda.graph(
                            self.graph, pool=self.pool, stream=stream,
                            capture_error_mode="thread_local"):
                        self.out = body()
                except Exception:
                    _reset_generators(device, stream)
                    raise
                finally:
                    if collecting:
                        gc.enable()
                self.launches = launch_delta(at_capture, launch_state())
            except Exception as exc:
                # a capture's own exit raises over the error inside it:
                # report the first one, with the node notes it carries
                raise GraphCaptureError(_message(f"capturing {what} failed",
                                                 raised[0] if raised else exc)) from exc
            finally:
                restore_launches(counts)
        self.capture_s = time.perf_counter() - t0 - self.warm_up_s
        self.replays = 0

    def stats(self) -> dict[str, float]:
        """graphs (1), replays, and the seconds of the warm-up and of the
        capture, apart: the warm-up may be a caller's real first run."""
        return {"graphs": 1, "replays": self.replays, "warm_up_s": self.warm_up_s,
                "capture_s": self.capture_s}

    def replay(self) -> None:
        try:
            self.graph.replay()
        except Exception as exc:
            raise GraphCaptureError(_message(f"replaying {self.what} failed", exc)) from exc
        self.replays += 1
        add_launches(self.launches)


# how GraphFunction hands back one output leaf
_OWN, _LEAF, _VIEW, _VALUE = range(4)


class GraphFunction:
    """`fn(*leaves)` as one CUDA graph over buffers that stay put.

    Tensor leaves flagged in `inplace` are read, and written, at their own
    addresses: the caller keeps them alive there, and keys its cache by
    those addresses, since a call whose in-place leaves sit elsewhere needs
    another graph.  The graph never writes into any other tensor of the
    caller's: the other tensor leaves are copied into static buffers the
    graph owns before every replay (no copy when the call passes that very
    buffer, `static`).  Other leaves are part of the graph as captured.

    The first call's result is `take_first()`: the warm-up runs `fn` on the
    caller's own leaves.  Calling the object with a later call's leaves
    replays the graph and returns `fn`'s outputs in `fn`'s structure: an
    output on an in-place leaf's storage as that leaf of the call (or a
    view of it), any other tensor output cloned out of the graph's pool,
    so that a later replay cannot overwrite it."""

    def __init__(self, fn: Callable, leaves: Sequence, inplace: Sequence[bool], device, *,
                 what: str, warm_up: Callable[[], Any] | None = None):
        static = list(leaves)
        self.static = {i: t.clone() for i, (t, ip) in enumerate(zip(leaves, inplace))
                       if torch.is_tensor(t) and not ip}
        for i, buf in self.static.items():
            static[i] = buf
        self.captured = CapturedGraph(lambda: fn(*static), device, what=what,
                                      warm_up=warm_up or (lambda: fn(*leaves)))
        self.first, self.captured.first = self.captured.first, None
        owner: dict[int, int] = {}
        for i, (t, ip) in enumerate(zip(leaves, inplace)):
            if ip and torch.is_tensor(t):
                owner.setdefault(t.untyped_storage().data_ptr(), i)
        flat, self.out_tree = pytree.tree_flatten(self.captured.out)
        self.outs: list[tuple] = []
        for t in flat:
            i = owner.get(t.untyped_storage().data_ptr()) if torch.is_tensor(t) else None
            if not torch.is_tensor(t):
                self.outs.append((_VALUE, t))
            elif i is None or t.dtype != leaves[i].dtype:
                self.outs.append((_OWN, t))
            elif (t.shape, t.stride(), t.storage_offset()) == \
                    (leaves[i].shape, leaves[i].stride(), leaves[i].storage_offset()):
                self.outs.append((_LEAF, i))
            else:
                self.outs.append((_VIEW, i, t.shape, t.stride(), t.storage_offset()))
        self.captured.out = None         # the graph's own outputs live on in self.outs

    def take_first(self):
        """The first call's result, handed over once: the object keeps no
        reference to it (it may hold the caller's in-place tensors)."""
        first, self.first = self.first, None
        return first

    @property
    def replays(self) -> int:
        return self.captured.replays

    @property
    def pool(self):
        return self.captured.pool

    def __call__(self, leaves: Sequence):
        for i, buf in self.static.items():
            src = leaves[i]
            if src.data_ptr() != buf.data_ptr():
                buf.copy_(src)
        self.captured.replay()
        out = []
        for how, *arg in self.outs:
            if how == _OWN:
                out.append(arg[0].clone())
            elif how == _LEAF:
                out.append(leaves[arg[0]])
            elif how == _VIEW:
                out.append(leaves[arg[0]].as_strided(*arg[1:]))
            else:
                out.append(arg[0])
        return pytree.tree_unflatten(out, self.out_tree)
