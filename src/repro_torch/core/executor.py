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
        scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]),
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
    every CompiledApp/GraphExecutor; `get_or_build` counts a build on every
    miss, and holds a lock for the whole check-build-insert so at most one
    build per key ever happens."""

    def __init__(self):
        self._store: OrderedDict[Any, Any] = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        with self._lock:
            return len(self._store)

    def keys(self):
        with self._lock:
            return list(self._store)

    def get_or_build(self, key, build: Callable[[], Any]):
        with self._lock:
            hit = self._store.get(key)
            if hit is not None:
                self.hits += 1
                return hit
            self.misses += 1
            val = build()
            _note_lowering()
            self._store[key] = val
            return val

    def clear(self):
        with self._lock:
            self._store.clear()


_CACHE = ExecutableCache()


def executable_cache() -> ExecutableCache:
    return _CACHE


def clear_executable_cache() -> None:
    _CACHE.clear()


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
    node: Node | None = None              # set for inline (free) programs
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
        return {_n.name: _eval_node(_n, ins, params.get(_n.name))}

    return Program(node.name, tuple(node.inputs), (node.name,), fn,
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
        for is_kernel, item, dead in steps:
            if is_kernel:
                vals[item.out] = item.call(vals, params)
            else:
                ins = [vals[i] for i in item.inputs]
                vals[item.name] = _eval_node(item, ins, params.get(item.name))
            for nm in dead:
                del vals[nm]
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
    (`torch.compile` on CUDA, eager on the CPU)."""

    mode = "vertical"
    compiles = True

    def plan(self) -> list[Program]:
        g = self.graph
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
    temp_bytes: float = 0.0    # not measured: no allocator counterpart of XLA's temp bytes
    # programs bound without a fresh build this call.  On the plan fast
    # path programs are PREBOUND, so hits == n_programs by definition.
    cache_hits: int = 0
    cache_misses: int = 0      # programs built fresh this call


def _plan_key(obj) -> tuple:
    """Cheap shape/dtype/device key over (nested dicts of) tensors -- ONE
    of these per run() call selects the ExecutionPlan.  Dict items are
    sorted so key ORDER never splits plans."""
    if isinstance(obj, dict):
        return tuple((k, _plan_key(v)) for k, v in sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return (len(obj),) + tuple(_plan_key(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.dtype, obj.device)
    return (type(obj).__name__, repr(obj))


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
    __slots__ = ("exe", "in_slots", "out_slots", "pkeys", "release")

    def __init__(self, spec: _StepSpec, exe: _Executable, pkeys: tuple[str, ...]):
        self.exe = exe
        self.in_slots = spec.in_slots
        self.out_slots = spec.out_slots
        self.pkeys = pkeys
        self.release = spec.release


class ExecutionPlan:
    """Everything `run()` needs for one (feed, param) shape signature:
    prebound programs, slot wiring, and precomputed traffic totals.
    `steps` keeps the bound step objects for introspection; `fns` are the
    specialized closures the hot loop actually runs."""
    __slots__ = ("steps", "fns", "bytes_accessed", "n_programs")

    def __init__(self, steps, bytes_accessed, n_programs):
        self.steps = steps
        self.fns = tuple(_compile_step(st) for st in steps)
        self.bytes_accessed = bytes_accessed
        self.n_programs = n_programs


class Engine:
    """Runs a backend's program list against the process-wide program
    cache.  `engine_key` namespaces cache entries (graph fingerprint +
    backend/options signature), so identical graphs share programs across
    Engine instances.

    The first `run()` per (feed, param) shape signature builds an
    ExecutionPlan -- feed/param names resolved to integer slots, cache keys
    built once, programs bound directly, intermediates in a flat buffer
    list released after their last reader.  Steady-state `run()` is a loop
    over prebound programs."""

    # plans an engine keeps live; beyond this the least-recent shape's plan
    # is dropped and rebuilt from the cache on next use
    MAX_PLANS = 64

    def __init__(self, backend: ExecutorBackend, engine_key: tuple,
                 cache: ExecutableCache | None = None,
                 struct_keys: dict[str, str] | None = None):
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
        self._plans: OrderedDict[tuple, ExecutionPlan] = OrderedDict()
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

    # -- execution ---------------------------------------------------------
    def run(self, feeds: dict[str, torch.Tensor], params: dict,
            measure: bool = True) -> ExecutionReport:
        """Execute via the per-shape ExecutionPlan.  The first call per
        shape signature builds the plan (building each program at most once
        per shape, via the process-wide cache); later calls replay the
        prebound programs.  measure=False only zeroes the traffic/program
        accounting."""
        key = (_plan_key(feeds), _plan_key(params))
        plan = self._plans.get(key)
        if plan is None:
            return self._build_and_run(key, feeds, params, measure)
        self._plans.move_to_end(key)
        buf = self._feed_buffer(feeds)
        for step in plan.fns:
            step(buf, params)
        outs = {name: buf[s] for name, s in self._run_out_slots}
        if not measure:
            return ExecutionReport(outs, 0.0, 0, 0.0, plan.n_programs, 0)
        return ExecutionReport(outs, plan.bytes_accessed, plan.n_programs,
                               0.0, plan.n_programs, 0)

    def _build_and_run(self, key: tuple, feeds: dict, params: dict,
                       measure: bool) -> ExecutionReport:
        """First call per shape signature: execute while binding the plan."""
        buf = self._feed_buffer(feeds)
        bound: list[Any] = []
        total_bytes = 0.0
        n_programs = hits = misses = 0
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
                bound.append(_BoundStep(spec, exe, pkeys))
            for i in spec.release:
                buf[i] = None
        self._plans[key] = ExecutionPlan(bound, total_bytes, n_programs)
        while len(self._plans) > self.MAX_PLANS:
            self._plans.popitem(last=False)
        outs = {name: buf[s] for name, s in self._run_out_slots}
        if not measure:
            return ExecutionReport(outs, 0.0, 0, 0.0, hits, misses)
        return ExecutionReport(outs, total_bytes, n_programs, 0.0,
                               hits, misses)

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
