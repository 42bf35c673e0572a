"""Executor backends: run an operator Graph in bsp / vertical / kitsune mode.

Three backends behind one ABC:

  * BSPBackend      -- runs every node as its own eager PyTorch call (one
    kernel per op, every intermediate round-trips through HBM; the
    PyTorch-eager baseline).
  * VerticalBackend -- runs the WHOLE graph as one program (the vertical-
    fusion baseline).  On a CUDA device that program is wrapped in
    `torch.compile`, which fuses it temporally; on the CPU it runs eagerly.
    It is a baseline, not a kernel of this package.
  * KitsuneBackend  -- runs every sf-node as ONE Python callable
    (spatial-dataflow mode); ops outside sf-nodes fall back to per-op BSP.
    With a `lower_kernels` plan (core/lower.py) the sf-node callables launch
    the hand-written Hopper kernels for matched stage chains (fused MLP /
    SwiGLU, flash attention, queue_reduce) instead of replaying the member
    ops one by one.

Numerical equivalence between the three modes is a test invariant; the
difference is *where the intermediates live*.  Each program's traffic is
counted as the bytes of the tensors crossing its boundary (inputs, weights
and outputs, from their shapes): for a per-op program that is the op's HBM
traffic, for a fused program the intermediates inside it are free.

Built programs are cached process-wide in `executable_cache()`, keyed by
(graph fingerprint / backend key, program name, feed shapes+dtypes), so a
second run with same-shaped feeds performs ZERO new builds (observable via
`lowering_count()`).  Execution is driven by per-shape ExecutionPlans: the
first run per feed/param shape signature resolves every value name to an
integer slot and binds the cached programs; steady-state `Engine.run` is a
tight loop over prebound programs.

PyTorch frees a dead intermediate as soon as its last reference goes,
which the plan's release lists arrange (and an sf-node program's own drop
lists, inside it).  Buffer donation -- the reference's in-place reuse of
dead XLA buffers -- is a graph rewrite for traced callables
(core/trace.py `donate_outputs`): copy nodes write each output into a
donated input once nothing reads that input any more.
"""
from __future__ import annotations

import abc
import functools
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from ..runtime.spans import Phases
from .cudagraph import GRAPH_PHASES, GraphCaptureError, GraphFunction, graph_stats
from .graph import Graph, Node, graph_fingerprint, subgraph_interface
from .patterns import Selection, select_subgraphs

_EW_FNS: dict[str, Callable] = {
    "add": lambda *xs: functools.reduce(torch.add, xs),
    "mul": lambda *xs: functools.reduce(torch.mul, xs),
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "identity": lambda x: x,
}

def init_params(graph: Graph, seed: int = 0, dtype=torch.float32,
                device="cuda", scale: float = 0.02) -> dict[str, Any]:
    """Materialize weights for linear/norm/gather nodes from one seeded
    `torch.Generator` on `device` (random draws in topological order)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device) * scale

    params: dict[str, Any] = {}
    for n in graph.topo():
        if n.kind == "linear":
            d_in, d_out = n.attrs["d_in"], n.attrs["d_out"]
            params[n.name] = {"w": normal((d_in, d_out))}
            if n.attrs.get("bias"):
                params[n.name]["b"] = torch.zeros((d_out,), dtype=dtype,
                                                  device=device)
        elif n.kind == "norm":
            params[n.name] = {"g": torch.ones((n.out.shape[-1],), dtype=dtype,
                                              device=device)}
        elif n.kind == "gather":
            params[n.name] = {"table": normal(tuple(n.attrs["table"]))}
    return params


def tensor_from_numpy(a, device="cuda", dtype=None) -> torch.Tensor:
    """One array (numpy, or anything `np.asarray` takes, e.g. a jax array)
    as a tensor on `device`.  bfloat16 crosses as its uint16 bits, because
    `torch.from_numpy` rejects numpy's bfloat16; the array is copied, since
    arrays exported by jax are read-only."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype)


def params_from_numpy(params, device="cuda", dtype=None) -> dict[str, Any]:
    """A params pytree (nested dicts of arrays, e.g. the reference package's
    `init_params` output) as this package's dict of tensors."""
    if isinstance(params, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in params.items()}
    return tensor_from_numpy(params, device, dtype)


def _eval_node(n: Node, inputs: list[torch.Tensor], p: dict | None) -> torch.Tensor:
    if n.kind in ("input", "const"):
        raise AssertionError("inputs are fed externally")
    ev = n.attrs.get("_eval")
    if ev is not None:
        # a traced node (core/trace.py): the exact recorded op.  A traced
        # graph holds its own backward, so TracedApp runs it under no_grad.
        return ev(*inputs)
    if n.kind == "linear":
        y = inputs[0] @ p["w"]
        if n.attrs.get("bias"):
            y = y + p["b"]
        return y
    if n.kind == "matmul":
        b = inputs[1]
        if n.attrs.get("transpose_b"):
            b = b.transpose(-1, -2)
        return inputs[0] @ b
    if n.kind == "elementwise":
        return _EW_FNS[n.attrs.get("fn", "add")](*inputs)
    if n.kind == "norm":
        x = inputs[0]
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * p["g"]
    if n.kind == "softmax":
        return torch.softmax(inputs[0], dim=-1)
    if n.kind == "attention":
        # logits in the input dtype, softmax in f32 -- as the reference
        # executor; the kernel path agrees only because lowering requires
        # sq == skv (the flash kernel's causal mask is start-aligned)
        q, k, v = inputs
        scale = 1.0 / torch.sqrt(torch.full((), float(q.shape[-1]),
                                            dtype=q.dtype, device=q.device))
        logits = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
        if n.attrs.get("causal", True):
            s, t = logits.shape[-2], logits.shape[-1]
            mask = torch.ones((s, t), dtype=torch.bool,
                              device=q.device).tril(t - s)
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, -1e30))
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhst,bhtd->bhsd", probs, v)
    if n.kind == "reduce":
        return torch.sum(inputs[0], dim=n.attrs["axis"],
                         keepdim=n.attrs.get("keepdims", False))
    if n.kind == "reduce_partial":
        # fan-in stage: partial sums over `fanin` chunks of the reduce axis
        x = inputs[0]
        axis = n.attrs["axis"] % x.ndim
        fanin = n.attrs["fanin"]
        pad = (-x.shape[axis]) % fanin
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:axis] + (pad,)
                                          + x.shape[axis + 1:])], dim=axis)
        x = torch.movedim(x, axis, 0)
        x = x.reshape((fanin, -1) + tuple(x.shape[1:]))
        return torch.sum(x, dim=1)  # (fanin, *rest)
    if n.kind == "reduce_final":
        return torch.sum(inputs[0], dim=0)
    if n.kind == "gather":
        return p["table"][inputs[0].long()]
    if n.kind == "concat":
        return torch.cat(inputs, dim=n.attrs.get("axis", -1))
    if n.kind == "reshape":
        return inputs[0].reshape(n.out.shape)
    if n.kind == "output":
        return inputs[0]
    raise NotImplementedError(n.kind)


# ---------------------------------------------------------------------------
# Process-wide program cache + build counter
# ---------------------------------------------------------------------------

_LOWERINGS = 0


def lowering_count() -> int:
    """Monotonic count of programs this process has built (a vertical
    program's build is its `torch.compile` wrapping).

    Tests assert that a second `CompiledApp.run()` with same-shaped feeds
    leaves this unchanged."""
    return _LOWERINGS


def _note_lowering() -> None:
    global _LOWERINGS
    _LOWERINGS += 1


class ExecutableCache:
    """Shape-keyed store of built programs.  One process-wide instance backs
    every CompiledApp/GraphExecutor and `cached_jit`; `get_or_build` counts
    a build on every miss, and at most one build per key ever happens.

    Unlike the reference's, the lock is not held while a program builds: a
    build on the card warms up and captures a CUDA graph, which takes
    seconds and the capture lock (core/cudagraph.py).  A miss marks its key
    in flight, builds outside the lock and inserts; another thread asking
    for that key waits for the build, while hits and builds of other keys
    go on.  A build that raises leaves nothing behind, and the next caller
    builds again.

    `capacity` optionally bounds the store with LRU eviction (a hit moves
    its key to the recent end; `evictions` in `stats()`); the default None
    leaves it unbounded.  An evicted or discarded `cached_jit` graph
    (core/cudagraph.py) is freed with its graph memory pool once no caller
    holds it, and a later call builds it anew.  Live ExecutionPlans keep
    the programs they bound until the Engine drops them."""

    def __init__(self, capacity: int | None = None):
        self._store: OrderedDict[Any, Any] = OrderedDict()
        self._lock = threading.RLock()
        self._building: dict[Any, tuple[int, threading.Event]] = {}
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self):
        with self._lock:
            return len(self._store)

    def __contains__(self, key):
        with self._lock:
            return key in self._store

    def get(self, key):
        """Passive lookup (introspection, tests): no LRU touch, no counters."""
        with self._lock:
            return self._store.get(key)

    def keys(self):
        with self._lock:
            return list(self._store)

    def get_or_build(self, key, build: Callable[[], Any]):
        me = threading.get_ident()
        while True:
            with self._lock:
                hit = self._store.get(key)
                if hit is not None:
                    self.hits += 1
                    self._store.move_to_end(key)
                    return hit
                flight = self._building.get(key)
                if flight is None:
                    self.misses += 1
                    done = threading.Event()
                    self._building[key] = (me, done)
                    break
            owner, waiting = flight
            if owner == me:
                raise RuntimeError(f"building {key!r} asks for its own build")
            waiting.wait()
        try:
            val = build()
            with self._lock:
                _note_lowering()
                self._store[key] = val
                self._evict()
            return val
        finally:
            with self._lock:
                del self._building[key]
            done.set()

    def discard(self, key) -> None:
        """Drop `key`'s build, if any (no eviction counted)."""
        with self._lock:
            val = self._store.pop(key, None)
        del val          # freed here, outside the lock

    def set_capacity(self, capacity: int | None) -> None:
        with self._lock:
            self.capacity = capacity
            self._evict()

    def _evict(self) -> None:
        if self.capacity is None:
            return
        while len(self._store) > max(self.capacity, 1):
            self._store.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"size": len(self._store), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "capacity": self.capacity}

    def clear(self):
        with self._lock:
            self._store.clear()


_CACHE = ExecutableCache()


def executable_cache() -> ExecutableCache:
    return _CACHE


def clear_executable_cache() -> None:
    _CACHE.clear()


class VerdictCache:
    """Process-wide store of kernel-lowering profitability verdicts
    (core/lower.py), living beside the executable cache so that repeat
    compiles of the same (kernel pattern, shape, dtype, hw, device) site
    pay neither the roofline estimate nor the microbenchmark again.

    Deliberately NOT an ExecutableCache: a miss there counts a build in
    `lowering_count()`, and verdicts are compile-time decisions, not built
    programs.  Its lock is never held while a verdict is decided."""

    def __init__(self):
        self._store: dict[Any, Any] = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        with self._lock:
            return len(self._store)

    def __contains__(self, key):
        with self._lock:
            return key in self._store

    def get(self, key):
        with self._lock:
            v = self._store.get(key)
            if v is None:
                self.misses += 1
            else:
                self.hits += 1
            return v

    def put(self, key, verdict) -> None:
        with self._lock:
            self._store[key] = verdict

    def keys(self):
        with self._lock:
            return list(self._store)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"size": len(self._store), "hits": self.hits,
                    "misses": self.misses}

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


_VERDICTS = VerdictCache()


def verdict_cache() -> VerdictCache:
    return _VERDICTS


def clear_verdict_cache() -> None:
    _VERDICTS.clear()


# ---------------------------------------------------------------------------
# Programs and backends
# ---------------------------------------------------------------------------

@dataclass
class Program:
    """One buildable unit: a callable over (feed, params) dicts.

    fn=None marks a zero-cost op (reshape/output outside any sf-node) that is
    evaluated inline without a kernel launch.  `outs` is the static order of
    the result dict's keys -- the ExecutionPlan binds them to integer slots
    once instead of walking dict results per call."""
    name: str
    needs: tuple[str, ...]                # graph values consumed
    params: tuple[str, ...] = ()          # param keys consumed
    fn: Callable | None = None            # (feed, params) -> {name: value}
    node: Node | None = None              # the node of a one-node program
    outs: tuple[str, ...] = ()            # value names produced, in order


class _Executable:
    """A built program: `call(psub, *ins)` or `call(*ins)` returning its
    outputs as a tuple, plus its boundary bytes (set at its first run)."""
    __slots__ = ("call", "compiled", "bytes_accessed")

    def __init__(self, call: Callable, compiled: bool):
        self.call = call
        self.compiled = compiled          # wrapped in torch.compile
        self.bytes_accessed: float | None = None


def _nbytes(obj) -> float:
    if isinstance(obj, torch.Tensor):
        return float(obj.numel() * obj.element_size())
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0.0


def _op_program(g: Graph, node: Node) -> Program:
    def fn(feed: dict[str, torch.Tensor], params: dict, _n=node) -> dict:
        ins = [feed[i] for i in _n.inputs]
        try:
            return {_n.name: _eval_node(_n, ins, params.get(_n.name))}
        except Exception as exc:
            exc.add_note(f"at node {_n.name} ({_n.attrs.get('prim', _n.kind)}) on "
                         + ", ".join(f"{tuple(t.shape)} {t.dtype} {t.device}"
                                     if isinstance(t, torch.Tensor) else repr(t)
                                     for t in ins))
            raise

    return Program(node.name, tuple(node.inputs), (node.name,), fn, node,
                   outs=(node.name,))


def _free_program(node: Node) -> Program:
    return Program(node.name, tuple(node.inputs), (), None, node,
                   outs=(node.name,))


def _sf_program(g: Graph, name: str, members: list[str],
                matches: Iterable | None = None) -> Program:
    """One Python callable for one sf-node.

    `matches` (KernelMatch objects from core/lower.py, duck-typed: `.ops`,
    `.out`, `.call(vals, params)`) replace runs of member ops with kernel
    launches; the members they cover are skipped by the op-by-op loop and
    their internal intermediates never materialize.  Without matches the
    program replays every member op."""
    pkeys = tuple(members)
    match_of: dict[str, Any] = {}
    for km in (matches or ()):
        for o in km.ops:
            match_of[o] = km
    # static schedule: member ops in topo order, each match emitted once at
    # its first member's position (all kernel inputs are available there)
    schedule: list[tuple[bool, Any]] = []
    emitted: set[int] = set()
    for m in members:
        km = match_of.get(m)
        if km is not None:
            if id(km) not in emitted:
                schedule.append((True, km))
                emitted.add(id(km))
            continue
        schedule.append((False, g.nodes[m]))
    # needs/exports come from the SHARED interface helper (core/graph.py):
    # exports are values consumed outside the sf-node; match internals are
    # single-consumer-internal by matcher contract, so never exports
    internal = {o for km in (matches or ()) for o in km.ops if o != km.out}
    need, exports = subgraph_interface(g, members, internal)
    # values no later item reads and the program does not export are dropped
    # after their last reader: a traced sf-node can span a whole backward
    # pass, whose intermediates must not all live to the program's end
    last: dict[str, int] = {}
    for k, (is_kernel, item) in enumerate(schedule):
        if is_kernel:
            reads = {i for o in item.ops for i in g.nodes[o].inputs
                     if i not in item.ops}
        else:
            reads = item.inputs
        for i in reads:
            last[i] = k
    keep = set(exports)
    drop: list[tuple[str, ...]] = [() for _ in schedule]
    for nm, k in last.items():
        if nm not in keep:
            drop[k] += (nm,)
    steps = [(is_kernel, item, drop[k])
             for k, (is_kernel, item) in enumerate(schedule)]

    def fn(feed: dict[str, torch.Tensor], params: dict) -> dict:
        vals = dict(feed)
        try:
            for is_kernel, item, dead in steps:
                if is_kernel:
                    vals[item.out] = item.call(vals, params)
                else:
                    ins = [vals[i] for i in item.inputs]
                    vals[item.name] = _eval_node(item, ins, params.get(item.name))
                for nm in dead:
                    del vals[nm]
        except Exception as exc:
            exc.add_note(f"at node {item.out if is_kernel else item.name}")
            raise
        return {m: vals[m] for m in exports}

    return Program(name, need, pkeys, fn, outs=exports)


class ExecutorBackend(abc.ABC):
    """Plans a Graph into an ordered list of buildable Programs."""

    mode: str = "?"
    compiles: bool = False   # wrap each program in torch.compile on CUDA

    def __init__(self, graph: Graph):
        self.graph = graph

    @abc.abstractmethod
    def plan(self) -> list[Program]:
        ...

    def key(self) -> tuple:
        """Cache-key component distinguishing this backend's programs."""
        return (self.mode,)


class BSPBackend(ExecutorBackend):
    """One eager call per op; free ops (reshape/output) evaluated inline."""

    mode = "bsp"

    def plan(self) -> list[Program]:
        progs = []
        for n in self.graph.topo():
            if n.kind in ("input", "const"):
                continue
            progs.append(_free_program(n) if n.is_free else
                         _op_program(self.graph, n))
        return progs


class VerticalBackend(ExecutorBackend):
    """Whole-graph single-program fusion: the vertical-fusion baseline
    (`torch.compile` on CUDA, eager on the CPU).  A graph with collectives
    is cut at each: the runs between them are one program each, and every
    collective a program of its own, so `torch.compile` never sees one."""

    mode = "vertical"
    compiles = True

    def plan(self) -> list[Program]:
        g = self.graph
        if any(n.kind == "collective" for n in g.topo()):
            return self._cut_plan()
        inputs = tuple(n.name for n in g.topo() if n.kind in ("input", "const"))
        pkeys = tuple(n.name for n in g.topo()
                      if n.kind in ("linear", "norm", "gather"))
        outs = [n for n in g.topo() if n.kind == "output"]
        if outs:
            exports = {n.name: n.inputs[0] for n in outs}
        else:  # fall back: leaves
            succ = g.successors_map()
            exports = {k: k for k in g.nodes
                       if not succ.get(k) and g.nodes[k].kind not in ("input", "const")}

        def fn(feed: dict[str, torch.Tensor], params: dict) -> dict:
            vals = dict(feed)
            for n in g.topo():
                if n.name in vals:
                    continue
                ins = [vals[i] for i in n.inputs]
                vals[n.name] = _eval_node(n, ins, params.get(n.name))
            return {name: vals[src] for name, src in exports.items()}

        return [Program(f"{g.name}.vertical", inputs, pkeys, fn,
                        outs=tuple(exports))]

    def _cut_plan(self) -> list[Program]:
        g = self.graph
        progs: list[Program] = []
        run: list[str] = []

        def flush():
            if run:
                progs.append(_sf_program(g, f"{g.name}.vertical{len(progs)}", list(run)))
                run.clear()
        for n in g.topo():
            if n.kind in ("input", "const"):
                continue
            if n.kind == "collective":
                flush()
                progs.append(_op_program(g, n))
            else:
                run.append(n.name)
        flush()
        return progs


class KitsuneBackend(ExecutorBackend):
    """sf-nodes as single callables; everything else per-op BSP.

    `lowering` (a core/lower.py LoweringPlan, or None) maps sf-node member
    chains onto the kernels inside those callables."""

    mode = "kitsune"

    def __init__(self, graph: Graph, sf_members: Iterable[tuple[str, list[str]]],
                 lowering=None):
        super().__init__(graph)
        self.sf_members = [(name, list(members)) for name, members in sf_members]
        self.lowering = lowering

    def key(self) -> tuple:
        low_sig = self.lowering.signature() if self.lowering is not None else ()
        return (self.mode,
                tuple((n, tuple(m)) for n, m in self.sf_members),
                low_sig)

    def plan(self) -> list[Program]:
        g = self.graph
        sf_of: dict[str, str] = {}
        members_of = dict(self.sf_members)
        for name, members in self.sf_members:
            for m in members:
                sf_of[m] = name
        progs: list[Program] = []
        emitted: set[str] = set()
        for n in g.topo():
            if n.kind in ("input", "const"):
                continue
            sf = sf_of.get(n.name)
            if sf is not None:
                if sf not in emitted:
                    matches = (self.lowering.matches_for(sf)
                               if self.lowering is not None else None)
                    progs.append(_sf_program(g, sf, members_of[sf], matches))
                    emitted.add(sf)
                continue
            progs.append(_free_program(n) if n.is_free else
                         _op_program(g, n))
        return progs


def make_backend(mode: str, graph: Graph,
                 sf_members: Iterable[tuple[str, list[str]]] | None = None,
                 lowering=None) -> ExecutorBackend:
    if mode == "bsp":
        return BSPBackend(graph)
    if mode == "vertical":
        return VerticalBackend(graph)
    if mode == "kitsune":
        return KitsuneBackend(graph, sf_members or [], lowering)
    raise ValueError(f"unknown executor mode {mode!r}")


# ---------------------------------------------------------------------------
# Shared execution engine
# ---------------------------------------------------------------------------

@dataclass
class ExecutionReport:
    outputs: dict[str, torch.Tensor]
    bytes_accessed: float      # sum of program-boundary bytes (HBM traffic)
    n_programs: int            # programs launched (BSP: one per op)
    # programs bound without a fresh build this call.  On the plan fast
    # path programs are PREBOUND, so hits == n_programs by definition.
    cache_hits: int = 0
    cache_misses: int = 0      # programs built fresh this call
    replayed: bool = False     # the call replayed the plan's CUDA graph
    capture_s: float = 0.0     # seconds this call spent capturing it
    n_collectives: int = 0     # collective programs among n_programs


def _plan_key(obj, addresses: bool = False) -> tuple:
    """Cheap shape/dtype/device key over (nested dicts of) tensors -- ONE
    of these per run() call selects the ExecutionPlan.  Dict items are
    sorted so key ORDER never splits plans.  With `addresses`, a CUDA
    tensor's key adds its address and strides: a captured graph reads and
    writes its in-place leaves there (core/cudagraph.py)."""
    if isinstance(obj, dict):
        return tuple((k, _plan_key(v, addresses)) for k, v in sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return (len(obj),) + tuple(_plan_key(v, addresses) for v in obj)
    if isinstance(obj, torch.Tensor):
        if addresses and obj.is_cuda:
            return (tuple(obj.shape), obj.dtype, obj.device, obj.data_ptr(), obj.stride())
        return (tuple(obj.shape), obj.dtype, obj.device)
    return (type(obj).__name__, repr(obj))


def cuda_device(*trees) -> torch.device | None:
    """The device of the first CUDA tensor in `trees`, or None."""
    for tree in trees:
        for t in pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                return t.device
    return None


@dataclass
class _StepSpec:
    """Shape-independent schedule entry (built once per Engine)."""
    prog: Program
    in_slots: tuple[int, ...]
    out_slots: tuple[int, ...]
    release: tuple[int, ...]    # buffer slots dead after this step


@dataclass
class _FreeSpec:
    node: Node
    in_slots: tuple[int, ...]
    out_slot: int
    release: tuple[int, ...]


def _compile_step(st) -> Callable:
    """Specialize one plan step into a closure `step(buf, params)` -- the
    steady-state loop is then one Python call per step with every slot,
    program and release list already bound."""
    rel = st.release
    if type(st) is _FreeSpec:
        node, in_slots, out = st.node, st.in_slots, st.out_slot

        def step(buf, params):
            buf[out] = _eval_node(node, [buf[i] for i in in_slots], None)
            for r in rel:
                buf[r] = None
        return step
    call, in_slots, out_slots, pkeys = (st.exe.call, st.in_slots,
                                        st.out_slots, st.pkeys)

    if not pkeys:
        def step(buf, params):
            outs = call(*[buf[i] for i in in_slots])
            for o, v in zip(out_slots, outs):
                buf[o] = v
            for r in rel:
                buf[r] = None
        return step

    def step(buf, params):
        outs = call({k: params[k] for k in pkeys}, *[buf[i] for i in in_slots])
        for o, v in zip(out_slots, outs):
            buf[o] = v
        for r in rel:
            buf[r] = None
    return step


class _BoundStep:
    """A _StepSpec bound to its built program for one shape signature.
    Programs with no params are called WITHOUT the params dict."""
    __slots__ = ("name", "exe", "in_slots", "out_slots", "pkeys", "release")

    def __init__(self, spec: _StepSpec, exe: _Executable, pkeys: tuple[str, ...]):
        self.name = spec.prog.name
        self.exe = exe
        self.in_slots = spec.in_slots
        self.out_slots = spec.out_slots
        self.pkeys = pkeys
        self.release = spec.release


class ExecutionPlan:
    """Everything `run()` needs for one (feed, param) shape signature:
    prebound programs, slot wiring, and precomputed traffic totals.
    `steps` keeps the bound step objects for introspection; `fns` are the
    specialized closures the hot loop actually runs.  On the card `graph`
    is the plan captured as one CUDA graph (a GraphFunction over the
    feeds), which every later run replays instead of walking `fns`."""
    __slots__ = ("steps", "fns", "bytes_accessed", "n_programs", "n_collectives",
                 "graph")

    def __init__(self, steps, bytes_accessed, n_programs, n_collectives=0):
        self.steps = steps
        self.fns = tuple(_compile_step(st) for st in steps)
        self.bytes_accessed = bytes_accessed
        self.n_programs = n_programs
        self.n_collectives = n_collectives
        self.graph = None


class _Refused:
    """A plan whose capture failed: every later run raises, none walks."""

    def __init__(self, exc: GraphCaptureError):
        self.exc = exc

    def __call__(self, leaves):
        raise GraphCaptureError(str(self.exc)) from self.exc


class Engine:
    """Runs a backend's program list against the process-wide program
    cache.  `engine_key` namespaces cache entries (graph fingerprint +
    backend/options signature), so identical graphs share programs across
    Engine instances.

    The first `run()` per (feed, param) shape signature builds an
    ExecutionPlan -- feed/param names resolved to integer slots, cache keys
    built once, programs bound directly, intermediates in a flat buffer
    list released after their last reader.  Steady-state `run()` is a loop
    over prebound programs.

    On the card, with `capture` (the default), that first run is also the
    warm-up of the plan's capture: right after it the whole plan is
    captured as ONE CUDA graph (core/cudagraph.py), and every later run
    with that key is one replay -- the counterpart of the reference's
    jitted programs.  The params and the `inplace_feeds` are read in place,
    so their addresses are part of the plan key; every other feed is copied
    into the graph's own buffer, and outputs that alias no in-place feed
    are cloned out of the graph's pool.  Each captured plan keeps a graph
    pool of its working set, so a caller that moves an in-place feed on
    every call captures on every call (up to MAX_PLANS pools): keep them
    where they are, as a donated state is.  A failed capture raises
    GraphCaptureError, on that run and every later run with its key; no run
    falls back to the walk.  With `capture=False` every run walks the plan,
    as on the CPU.

    `phases` (runtime/spans.py, layer "kitsune") times each `run()` and,
    inside it, the plan key and its lookup ("key"), and a replay's copies
    into the static buffers ("stage"), the replay ("launch") and the
    outputs ("outputs"); `runs` counts the `run()` calls;
    `capture_stats()` reports both."""

    # plans an engine keeps live; beyond this the least-recent shape's plan
    # is dropped and rebuilt from the cache on next use
    MAX_PLANS = 64

    def __init__(self, backend: ExecutorBackend, engine_key: tuple,
                 cache: ExecutableCache | None = None,
                 struct_keys: dict[str, str] | None = None, *,
                 capture: bool = True, inplace_feeds: Iterable[str] = ()):
        self.backend = backend
        self.graph = backend.graph
        self.programs = backend.plan()
        # program name -> canonical structural key (core/graph.py
        # program_struct_key), provided by the dedupe pass.  Param-less
        # programs carrying a struct key are cached under it INSTEAD of the
        # engine-namespaced name key, so N structurally equal stages (and
        # identical stages of other engines) bind to ONE program.
        self.struct_keys = dict(struct_keys or {})
        self.engine_key = (engine_key,) + backend.key()
        self.cache = cache if cache is not None else _CACHE
        self.capture = capture
        self.inplace_feeds = frozenset(inplace_feeds)
        self._plans: OrderedDict[tuple, ExecutionPlan] = OrderedDict()
        self.phases = Phases("kitsune", ("run", "key", *GRAPH_PHASES))
        self.runs = 0
        self._build_skeleton()

    # -- shape-independent schedule (once per Engine) ----------------------
    def _build_skeleton(self) -> None:
        g = self.graph
        slots: dict[str, int] = {}

        def slot(name: str) -> int:
            return slots.setdefault(name, len(slots))

        self._feed_slots = tuple(
            (slot(n.name), n.name) for n in g.topo()
            if n.kind in ("input", "const"))
        # run outputs: output nodes, else leaves (unconsumed feeds count as
        # leaves, matching the reference executor)
        out_nodes = [n.name for n in g.topo() if n.kind == "output"]
        if out_nodes:
            run_outs = list(out_nodes)
        else:
            succ = g.successors_map()
            run_outs = [n.name for n in g.topo() if not succ.get(n.name)]
        END = len(self.programs)
        last_use: dict[str, int] = {}
        for idx, prog in enumerate(self.programs):
            for nm in prog.needs:
                last_use[nm] = idx
        for name in run_outs:
            last_use[name] = END
        steps: list[Any] = []
        for idx, prog in enumerate(self.programs):
            in_slots = tuple(slot(nm) for nm in prog.needs)
            release = tuple(slots[nm] for nm in dict.fromkeys(prog.needs)
                            if last_use.get(nm) == idx)
            if prog.fn is None:
                steps.append(_FreeSpec(prog.node, in_slots,
                                       slot(prog.node.name), release))
                continue
            out_slots = tuple(slot(nm) for nm in prog.outs)
            steps.append(_StepSpec(prog, in_slots, out_slots, release))
        self._steps = steps
        self._run_out_slots = tuple((name, slots[name]) for name in run_outs)
        self._n_slots = len(slots)

    def _feed_buffer(self, feeds: dict) -> list:
        buf: list[Any] = [None] * self._n_slots
        for s, name in self._feed_slots:
            if name not in feeds:
                raise KeyError(f"missing feed for {name}")
            buf[s] = feeds[name]
        return buf

    def _key(self, feeds: dict, params: dict, inplace: frozenset) -> tuple:
        if not self.capture:
            return (_plan_key(feeds), _plan_key(params))
        return (tuple((k, _plan_key(v, k in inplace)) for k, v in sorted(feeds.items())),
                _plan_key(params, True))

    # -- execution ---------------------------------------------------------
    def run(self, feeds: dict[str, torch.Tensor], params: dict,
            measure: bool = True, inplace: frozenset[str] | None = None,
            ) -> ExecutionReport:
        """Execute via the per-shape ExecutionPlan.  The first call per
        shape signature builds the plan (building each program at most once
        per shape, via the process-wide cache) and, on the card, captures
        it; later calls replay the graph or walk the prebound programs.
        `inplace` overrides the engine's in-place feeds for this call.
        measure=False only zeroes the traffic/program accounting."""
        ph = self.phases
        self.runs += 1
        with ph.span("run"):
            with ph.span("key"):
                inplace = self.inplace_feeds if inplace is None else inplace
                key = self._key(feeds, params, inplace)
                plan = self._plans.get(key)
            if plan is None:
                return self._build_and_run(key, feeds, params, measure, inplace)
            self._plans.move_to_end(key)
            if plan.graph is not None:
                vals = plan.graph([feeds[name] for _, name in self._feed_slots])
                outs = {name: v for (name, _), v in zip(self._run_out_slots, vals)}
            else:
                buf = self._feed_buffer(feeds)
                for step in plan.fns:
                    step(buf, params)
                outs = {name: buf[s] for name, s in self._run_out_slots}
            replayed = plan.graph is not None
            if not measure:
                return ExecutionReport(outs, 0.0, 0, plan.n_programs, 0, replayed)
            return ExecutionReport(outs, plan.bytes_accessed, plan.n_programs,
                                   plan.n_programs, 0, replayed,
                                   n_collectives=plan.n_collectives)

    def _build_and_run(self, key: tuple, feeds: dict, params: dict, measure: bool,
                       inplace: frozenset) -> ExecutionReport:
        """First call per plan key: bind the plan while running it, and on
        the card capture it right after, that run being the warm-up."""
        device = cuda_device(feeds, params) if self.capture else None
        if device is None:
            return self._bind_and_run(key, feeds, params, measure)
        buf = self._feed_buffer(feeds)
        what = f"{self.graph.name} ({self.backend.mode}, {len(self.programs)} programs)"
        try:
            gf = GraphFunction(functools.partial(self._walk, key, params),
                               [buf[s] for s, _ in self._feed_slots],
                               [name in inplace for _, name in self._feed_slots], device,
                               what=what, warm_up=lambda: self._bind_and_run(
                                   key, feeds, params, measure), phases=self.phases)
        except GraphCaptureError as exc:
            if key in self._plans:
                self._plans[key].graph = _Refused(exc)
            raise
        self._plans[key].graph = gf
        report = gf.take_first()
        report.capture_s = gf.captured.capture_s
        return report

    def _walk(self, key: tuple, params: dict, *vals) -> list:
        """The plan of `key` on feeds `vals` (in feed-slot order): the body a
        capture records.  An error names the program it came from."""
        plan = self._plans[key]
        buf: list[Any] = [None] * self._n_slots
        for (s, _), v in zip(self._feed_slots, vals):
            buf[s] = v
        for st, step in zip(plan.steps, plan.fns):
            try:
                step(buf, params)
            except Exception as exc:
                name = st.name if type(st) is _BoundStep else st.node.name
                exc.add_note(f"in program {name}")
                raise
        return [buf[s] for _, s in self._run_out_slots]

    def capture_stats(self) -> dict[str, float]:
        """The engine's captured plans, summed by core/cudagraph.py
        `graph_stats`: graphs, replays, the seconds of the warm-ups (each
        plan's first, building run) and of the captures apart, and the
        bytes their pools hold; with the `run()` calls (`runs`) and the
        seconds of each of the run's phases (`phases`: run_s, key_s,
        stage_s, launch_s, outputs_s)."""
        return {**graph_stats(p.graph.captured for p in self._plans.values()
                              if isinstance(p.graph, GraphFunction)),
                "runs": self.runs, **self.phases.stats()}

    def _bind_and_run(self, key: tuple, feeds: dict, params: dict,
                      measure: bool) -> ExecutionReport:
        """Execute while binding the plan."""
        buf = self._feed_buffer(feeds)
        bound: list[Any] = []
        total_bytes = 0.0
        n_programs = n_collectives = hits = misses = 0
        for spec in self._steps:
            if type(spec) is _FreeSpec:
                buf[spec.out_slot] = _eval_node(
                    spec.node, [buf[i] for i in spec.in_slots], None)
                bound.append(spec)
            else:
                prog = spec.prog
                pkeys = tuple(k for k in prog.params if k in params)
                psub = {k: params[k] for k in pkeys}
                ins = tuple(buf[i] for i in spec.in_slots)
                skey = self.struct_keys.get(prog.name) if not pkeys else None
                if skey is not None:
                    # canonical struct-keyed entry: NO engine namespace, so
                    # structurally equal programs share ONE build across
                    # stages, apps, and engines (param-less programs only)
                    ckey = ("sfprog", skey, self.backend.compiles,
                            _plan_key(ins))
                else:
                    ckey = self.engine_key + (
                        "plan", prog.name, _plan_key(ins), _plan_key(psub))
                before = self.cache.misses
                exe = self.cache.get_or_build(
                    ckey, lambda: self._build(prog, ins, bool(pkeys)))
                if self.cache.misses > before:
                    misses += 1
                else:
                    hits += 1
                outs = exe.call(psub, *ins) if pkeys else exe.call(*ins)
                if exe.bytes_accessed is None:
                    exe.bytes_accessed = _nbytes(ins) + _nbytes(psub) + _nbytes(outs)
                for o, v in zip(spec.out_slots, outs):
                    buf[o] = v
                total_bytes += exe.bytes_accessed
                n_programs += 1
                n_collectives += prog.node is not None and prog.node.kind == "collective"
                bound.append(_BoundStep(spec, exe, pkeys))
            for i in spec.release:
                buf[i] = None
        self._plans[key] = ExecutionPlan(bound, total_bytes, n_programs, n_collectives)
        while len(self._plans) > self.MAX_PLANS:
            self._plans.popitem(last=False)
        outs = {name: buf[s] for name, s in self._run_out_slots}
        if not measure:
            return ExecutionReport(outs, 0.0, 0, hits, misses)
        return ExecutionReport(outs, total_bytes, n_programs,
                               hits, misses, n_collectives=n_collectives)

    def _build(self, prog: Program, ins: tuple, with_params: bool) -> _Executable:
        """A positional callable for `prog`; for a compiling backend (the
        vertical baseline) on a CUDA device, wrapped in torch.compile."""
        if with_params:
            def wrapped(psub_, *arrs):
                out = prog.fn(dict(zip(prog.needs, arrs)), psub_)
                return tuple(out[k] for k in prog.outs)
        else:
            def wrapped(*arrs):
                out = prog.fn(dict(zip(prog.needs, arrs)), {})
                return tuple(out[k] for k in prog.outs)
        on_cuda = any(isinstance(t, torch.Tensor) and t.is_cuda for t in ins)
        if self.backend.compiles and on_cuda:
            return _Executable(torch.compile(wrapped, dynamic=False), True)
        return _Executable(wrapped, False)


# ---------------------------------------------------------------------------
# Public executor API
# ---------------------------------------------------------------------------

class GraphExecutor:
    """Executes a Graph in 'bsp', 'vertical' or 'kitsune' mode on concrete
    tensors.  Thin wrapper over the backend/Engine split; prefer the
    `repro_torch.compile()` front-door (core/compiler.py)."""

    def __init__(self, graph: Graph, mode: str = "bsp",
                 selection: Selection | None = None):
        if mode not in ("bsp", "vertical", "kitsune"):
            raise ValueError(f"unknown executor mode {mode!r}")
        self.graph = graph
        self.mode = mode
        self.selection = selection or select_subgraphs(graph)
        self.covered = self.selection.covered if mode == "kitsune" else set()
        sf_members = [(sf.name, list(sf.members))
                      for sf in self.selection.sf_nodes]
        backend = make_backend(mode, graph, sf_members)
        self._engine = Engine(backend, (graph_fingerprint(graph),))

    def run(self, feeds: dict[str, torch.Tensor], params: dict,
            measure: bool = True) -> ExecutionReport:
        return self._engine.run(feeds, params, measure)


def compare_traffic(graph: Graph, feeds: dict[str, torch.Tensor],
                    params: dict) -> dict[str, float]:
    """Boundary bytes, BSP vs Kitsune (Table 2's "Traffic Red."): the
    graph run in both modes, their outputs held within rtol = atol = 2e-2,
    and each mode's sum of program-boundary bytes (the tensors crossing
    each program's boundary, from their shapes -- a count, not a device
    counter) with its program count."""
    bsp = GraphExecutor(graph, "bsp").run(feeds, params)
    kit = GraphExecutor(graph, "kitsune").run(feeds, params)
    for k, v in bsp.outputs.items():
        # on the outputs' device: a full-width app's logits are GBs
        torch.testing.assert_close(kit.outputs[k].float(), v.float(), rtol=2e-2, atol=2e-2)
    red = 1.0 - kit.bytes_accessed / max(bsp.bytes_accessed, 1.0)
    return {"bsp_bytes": bsp.bytes_accessed, "kitsune_bytes": kit.bytes_accessed,
            "traffic_reduction": red, "bsp_programs": bsp.n_programs,
            "kitsune_programs": kit.n_programs}
