"""The Kitsune compiler front-door: `repro_torch.compile(graph, options)`.

One staged, introspectable compiler (the paper's SS5 end-to-end flow behind
a single entrypoint):

    options = CompilerOptions(mode="kitsune")
    app = repro_torch.compile(graph, options)  # runs the pass pipeline once
    report = app.run(feeds, params)            # cached programs; no rebuild

Pieces:

  * CompilerOptions -- every compiler knob in one frozen dataclass (mode,
    tile bytes, split-reduction threshold, pattern subset, balancing,
    lowering policy).
  * PassManager -- runs the stages as NAMED passes
    (`select -> split_reduction -> create_queues -> epilogue_fuse ->
    lower_kernels -> dedupe -> balance`) with per-pass wall-clock timing, an
    IR dump hook, support for reordering, and per-pass disabling (each
    disabled pass degrades to its identity/fallback form instead of crashing
    downstream passes).  `lower_kernels` (core/lower.py) pattern-matches the
    pipelined sf-node stages onto the hand-written Hopper kernels (fused MLP
    / SwiGLU, flash attention, queue_reduce), with per-op fallback reasons
    surfaced by `CompiledApp.describe()`; under the default "auto" policy
    each match carries a profitability verdict (a roofline estimate, then
    a microbenchmark on the compile's device) and, on the card, a tuned
    tile.
  * CompiledApp -- the compiled artifact: selection + pipelined IR + balance
    results + an executor Engine whose programs live in the process-wide
    cache keyed by (graph fingerprint, feed shapes, options), so repeated
    `run()` calls (and fresh `compile()`s of an identical graph) perform
    zero new builds.

Callables: `repro_torch.compile(fn, example_inputs)` traces `fn` first
(core/trace.py; tracing is pass 0 of the pipeline) and returns a TracedApp
that is itself callable like `fn`.  `cached_jit(fn, key=...)` binds any
callable to the same executable cache without tracing it.

On the card a compiled artifact's executable is a CUDA graph
(core/cudagraph.py): each plan of a CompiledApp, and each build of a
`cached_jit` function, is captured after its first run and replayed by
every later call.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from .balance import BalanceResult, balance as _balance_pipeline
from .costmodel import H100, GraphCost, HwSpec, evaluate
from .cudagraph import GraphFunction, graph_stats
from .executor import (Engine, ExecutionReport, _plan_key, cuda_device,
                       executable_cache, init_params, make_backend)
from .graph import Graph, graph_fingerprint
from .lower import POLICIES, LoweringPlan, lower_pipelines, target_for
from .trace import TracedFunction, donate_outputs, trace as trace_fn
from .patterns import PATTERN_LIBRARY, Selection, select_subgraphs
from .pipeline import (DEFAULT_TILE_BYTES, SPLIT_REDUCTION_MIN, DedupeInfo,
                       OpQueue, Pipeline, PipelinedGraph, Stage,
                       dedupe_programs, fuse_epilogues, materialize_queues,
                       plan_queues, split_reductions)

MODES = ("bsp", "vertical", "kitsune")
PASS_NAMES = ("select", "split_reduction", "create_queues", "epilogue_fuse",
              "lower_kernels", "dedupe", "balance")


@dataclass(frozen=True)
class CompilerOptions:
    """Every knob of the compiler in one (hashable) place.

    mode                 executor mode the artifact runs in:
                         bsp      -- one eager call per op (baseline)
                         vertical -- whole graph as ONE program, wrapped in
                                     torch.compile on CUDA (vertical-fusion
                                     baseline)
                         kitsune  -- sf-nodes as dataflow programs that
                                     launch the Hopper kernels
    tile_bytes           on-chip queue payload size (Algorithm 1)
    split_reduction_min  reductions at least this wide get fan-in/final split
    patterns             subset of PATTERN_LIBRARY names to match (None=all)
    min_sf_size          smallest op count an sf-node may have
    balance              run the ILP load-balancing pass (Algorithm 2)
    hw                   HwSpec the balance pass, the lowering verdicts'
                         estimates and estimate() default to (None: H100)
    disable              pass names to skip (each falls back to its identity
                         form; e.g. disabling `epilogue_fuse` yields one
                         stage per op)
    lowering_policy      profitability gate on kernel matches (core/lower.py):
                         "auto" (default) -- roofline estimate, then a
                         compile-time microbenchmark on the compile's device
                         inside the uncertainty band (verdicts cached
                         process-wide), tiles tuned on the card; "cost" --
                         the estimate alone; "always" -- every match lowers
                         at the default tiles
    dump_ir              hook called as dump_ir(pass_name, state) after every
                         pass -- the introspection point for IR dumps
    capture              on the card, capture each plan as one CUDA graph
                         after its first run and replay it (default); False
                         walks the plan program by program on every run,
                         as on the CPU (the bitwise oracle of a capture,
                         and bsp as the paper's eager baseline)
    """
    mode: str = "kitsune"
    tile_bytes: int = DEFAULT_TILE_BYTES
    split_reduction_min: int = SPLIT_REDUCTION_MIN
    patterns: tuple[str, ...] | None = None
    min_sf_size: int = 2
    balance: bool = True
    hw: HwSpec | None = None
    disable: tuple[str, ...] = ()
    lowering_policy: str = "auto"
    dump_ir: Callable[[str, "CompileState"], None] | None = None
    capture: bool = True

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.lowering_policy not in POLICIES:
            raise ValueError(f"lowering_policy must be one of {POLICIES}, "
                             f"got {self.lowering_policy!r}")
        for p in self.disable:
            if p not in PASS_NAMES:
                raise ValueError(f"unknown pass {p!r} in disable "
                                 f"(known: {PASS_NAMES})")
        if self.patterns is not None:
            object.__setattr__(self, "patterns", tuple(self.patterns))
            for name in self.patterns:
                if name not in PATTERN_LIBRARY:
                    raise ValueError(f"unknown pattern {name!r} "
                                     f"(known: {tuple(PATTERN_LIBRARY)})")

    @property
    def disabled(self) -> frozenset[str]:
        dis = set(self.disable)
        if not self.balance:
            dis.add("balance")
        return frozenset(dis)

    def resolved_hw(self) -> HwSpec:
        return self.hw if self.hw is not None else H100

    def cache_key(self) -> tuple:
        """Hashable identity for the program cache (hooks and `capture`
        excluded: neither changes the produced programs; the lowering
        plan's own signature -- verdicts and tiles -- is part of the
        kitsune backend's key)."""
        return (self.mode, self.tile_bytes, self.split_reduction_min,
                self.patterns, self.min_sf_size, tuple(sorted(self.disabled)),
                self.lowering_policy)


@dataclass
class CompileState:
    """Mutable state threaded through the pass pipeline.  `device` is the
    device the compile will run on, where the lowering measures."""
    graph: Graph
    device: torch.device | None = None
    selection: Selection | None = None
    work_graph: Graph | None = None                 # post split-reduction
    members_of: dict[str, list[str]] | None = None  # sf name -> members
    op_queues: dict[str, list[OpQueue]] = field(default_factory=dict)
    stages_of: dict[str, tuple[list[Stage], dict[str, Stage]]] = \
        field(default_factory=dict)
    pipelined: PipelinedGraph | None = None
    lowering: LoweringPlan | None = None            # lower_kernels artifact
    dedupe: DedupeInfo | None = None                # dedupe pass artifact
    balance_results: dict[str, BalanceResult] = field(default_factory=dict)


@dataclass
class PassRecord:
    name: str
    seconds: float
    disabled: bool = False
    summary: str = ""


# -- pass bodies (and the identity fallbacks used when a pass is disabled) --

def _ensure_selection(state: CompileState, opts: CompilerOptions) -> Selection:
    if state.selection is None:
        state.selection = Selection(state.graph, [])
    return state.selection


def _ensure_work(state: CompileState, opts: CompilerOptions) -> Graph:
    if state.work_graph is None:
        sel = _ensure_selection(state, opts)
        state.work_graph = state.graph.clone()
        state.members_of = {sf.name: list(sf.members) for sf in sel.sf_nodes}
    return state.work_graph


def _invalidate_derived(state: CompileState) -> None:
    """Drop everything computed from a previous selection/work graph (pass
    reordering support: a structural pass re-running invalidates downstream
    state so lazy _ensure_* rebuilds it consistently)."""
    state.work_graph = None
    state.members_of = None
    state.op_queues = {}
    state.stages_of = {}
    state.pipelined = None
    state.lowering = None
    state.dedupe = None


def _pass_select(state: CompileState, opts: CompilerOptions) -> str:
    state.selection = select_subgraphs(state.graph, min_size=opts.min_sf_size,
                                       patterns=opts.patterns)
    _invalidate_derived(state)
    grouped, total = state.selection.coverage()
    return f"{len(state.selection.sf_nodes)} sf-nodes, coverage {grouped}/{total}"


def _skip_select(state: CompileState, opts: CompilerOptions) -> str:
    state.selection = Selection(state.graph, [])
    _invalidate_derived(state)
    return "selection disabled: 0 sf-nodes"


def _pass_split_reduction(state: CompileState, opts: CompilerOptions) -> str:
    sel = _ensure_selection(state, opts)
    work, members = split_reductions(sel, opts.split_reduction_min)
    # the rewrite renames member ops: stage/queue state built against the
    # old graph (reordered pipelines) is stale and must be rebuilt
    _invalidate_derived(state)
    state.work_graph, state.members_of = work, members
    n = sum(1 for node in state.work_graph.topo()
            if node.kind == "reduce_partial")
    return f"{n} reductions split"


def _skip_split_reduction(state: CompileState, opts: CompilerOptions) -> str:
    _ensure_work(state, opts)
    return "reductions left whole"


def _pass_create_queues(state: CompileState, opts: CompilerOptions) -> str:
    g = _ensure_work(state, opts)
    state.op_queues = {name: plan_queues(g, members)
                       for name, members in state.members_of.items()}
    n = sum(len(v) for v in state.op_queues.values())
    return f"{n} queue intents"


def _skip_create_queues(state: CompileState, opts: CompilerOptions) -> str:
    _ensure_work(state, opts)
    state.op_queues = {name: [] for name in state.members_of}
    return "no queues"


def _pass_epilogue_fuse(state: CompileState, opts: CompilerOptions,
                        enable: bool = True) -> str:
    g = _ensure_work(state, opts)
    state.stages_of = {
        name: fuse_epilogues(g, name, members, enable=enable)
        for name, members in state.members_of.items()}
    n_ops = sum(len(m) for m in state.members_of.values())
    n_stages = sum(len(s) for s, _ in state.stages_of.values())
    return f"{n_ops} ops -> {n_stages} stages"


def _skip_epilogue_fuse(state: CompileState, opts: CompilerOptions) -> str:
    return _pass_epilogue_fuse(state, opts, enable=False) + " (unfused)"


def _pipelined_members(pg: PipelinedGraph) -> dict[str, list[str]]:
    """Executable member list per pipeline: stage ops re-sorted to topo order
    (epilogue fusion can hoist an op into its producer's stage past
    siblings).  This is the exact member order the kitsune backend runs."""
    order = {name: i for i, name in enumerate(pg.graph.nodes)}
    return {p.name: sorted((o.name for s in p.stages for o in s.ops),
                           key=order.__getitem__)
            for p in pg.pipelines}


def _pass_lower_kernels(state: CompileState, opts: CompilerOptions) -> str:
    pg = _ensure_pipelined(state, opts)
    if opts.mode != "kitsune":
        # bsp/vertical never execute sf-node programs, so matching would be
        # wasted work and describe() would claim kernels that never run
        state.lowering = None
        return f"skipped: kernels only execute in kitsune mode ({opts.mode})"
    state.lowering = lower_pipelines(pg.graph, _pipelined_members(pg),
                                     hw=opts.resolved_hw(),
                                     policy=opts.lowering_policy,
                                     target=target_for(state.device, opts.capture))
    return state.lowering.summary()


def _skip_lower_kernels(state: CompileState, opts: CompilerOptions) -> str:
    _ensure_pipelined(state, opts)
    state.lowering = None
    return "kernel lowering disabled: every stage runs op by op"


def _pass_dedupe(state: CompileState, opts: CompilerOptions) -> str:
    """Bucket the artifact's programs by structural identity (core/pipeline.py
    `dedupe_programs`); the Engine caches param-less programs by these keys
    so structurally equal stages share ONE built program."""
    pg = _ensure_pipelined(state, opts)
    if opts.mode == "vertical":
        state.dedupe = None
        return "skipped: vertical mode runs one whole-graph program"
    if opts.mode == "kitsune":
        members_of = _pipelined_members(pg)
        matches_of = {
            name: (state.lowering.matches_for(name)
                   if state.lowering is not None else [])
            for name in members_of}
        state.dedupe = dedupe_programs(pg.graph, members_of, matches_of)
    else:  # bsp: one program per non-free op of the source graph
        state.dedupe = dedupe_programs(state.graph, {})
    return state.dedupe.summary()


def _skip_dedupe(state: CompileState, opts: CompilerOptions) -> str:
    _ensure_pipelined(state, opts)
    state.dedupe = None
    return "dedupe disabled: every program keyed by name"


def _pass_balance(state: CompileState, opts: CompilerOptions) -> str:
    pg = _ensure_pipelined(state, opts)
    hw = opts.resolved_hw()
    state.balance_results = {}
    for pipe in pg.pipelines:
        # DRAM / on-chip volumes for the bandwidth caps come from the model
        dram = sum(s.weight_bytes for s in pipe.stages)
        onchip = sum(q.total_bytes * (1 + len(q.consumers))
                     for q in pipe.queues)
        state.balance_results[pipe.name] = _balance_pipeline(
            pipe, hw, dram, onchip)
    return f"{len(state.balance_results)} pipelines balanced on {hw.name}"


def _skip_balance(state: CompileState, opts: CompilerOptions) -> str:
    _ensure_pipelined(state, opts)
    state.balance_results = {}
    return "unbalanced (1 unit per stage at execution)"


def _ensure_pipelined(state: CompileState, opts: CompilerOptions,
                      ) -> PipelinedGraph:
    """Materialize the PipelinedGraph from whatever the passes produced.

    Called lazily by the first consumer (balance pass or compile() itself),
    so `create_queues` and `epilogue_fuse` may run in either order."""
    if state.pipelined is not None:
        return state.pipelined
    g = _ensure_work(state, opts)
    sel = _ensure_selection(state, opts)
    pipelines: list[Pipeline] = []
    for sf in sel.sf_nodes:
        members = state.members_of[sf.name]
        if sf.name in state.stages_of:
            stages, op_to_stage = state.stages_of[sf.name]
        else:
            stages, op_to_stage = fuse_epilogues(g, sf.name, members)
        queues, edges = materialize_queues(
            sf.name, stages, state.op_queues.get(sf.name, []), op_to_stage,
            opts.tile_bytes)
        pipelines.append(Pipeline(sf.name, stages, queues, sf, edges))
    state.pipelined = PipelinedGraph(g, pipelines)
    return state.pipelined


_PASSES: dict[str, tuple[Callable, Callable]] = {
    "select": (_pass_select, _skip_select),
    "split_reduction": (_pass_split_reduction, _skip_split_reduction),
    "create_queues": (_pass_create_queues, _skip_create_queues),
    "epilogue_fuse": (_pass_epilogue_fuse, _skip_epilogue_fuse),
    "lower_kernels": (_pass_lower_kernels, _skip_lower_kernels),
    "dedupe": (_pass_dedupe, _skip_dedupe),
    "balance": (_pass_balance, _skip_balance),
}


class PassManager:
    """Runs the compiler stages as named, introspectable passes.

    `passes` selects and ORDERS the passes (default: the canonical
    Algorithm-1 order).  Disabled passes (options.disable / balance=False)
    still appear in the records, marked disabled, and run their identity
    fallback so later passes see consistent state."""

    def __init__(self, passes: tuple[str, ...] | list[str] | None = None):
        names = tuple(passes) if passes is not None else PASS_NAMES
        for n in names:
            if n not in _PASSES:
                raise ValueError(f"unknown pass {n!r} (known: {PASS_NAMES})")
        self.pass_names = names

    def run(self, state: CompileState, options: CompilerOptions,
            ) -> list[PassRecord]:
        records: list[PassRecord] = []
        disabled = options.disabled
        for name in self.pass_names:
            run_fn, skip_fn = _PASSES[name]
            fn = skip_fn if name in disabled else run_fn
            t0 = time.perf_counter()
            summary = fn(state, options)
            dt = time.perf_counter() - t0
            records.append(PassRecord(name, dt, name in disabled, summary))
            if options.dump_ir is not None:
                options.dump_ir(name, state)
        return records


class CompiledApp:
    """The artifact `repro_torch.compile()` returns: pipelined IR + balance
    plan + a mode-specific executor whose programs are cached process-wide.

    run() with same-shaped feeds never rebuilds: the first call per shape
    populates the cache; later calls (and later CompiledApps of an identical
    graph+options) reuse the same built programs."""

    def __init__(self, graph: Graph, options: CompilerOptions,
                 state: CompileState, pass_records: list[PassRecord],
                 inplace_feeds: frozenset[str] = frozenset()):
        self.graph = graph
        self.options = options
        self.state = state
        self.pass_records = pass_records
        self.selection = state.selection
        self.pipelined = state.pipelined
        self.lowering = state.lowering
        self.dedupe = state.dedupe
        self.balance_results = state.balance_results
        self.fingerprint = graph_fingerprint(graph)
        if options.mode == "kitsune":
            # execute the POST-pass graph: reductions split, stage structure
            # fixed; sf programs follow the pipelined member lists (see
            # _pipelined_members), with lower_kernels matches replacing
            # member chains by kernel launches.
            exec_graph = state.pipelined.graph
            members = _pipelined_members(state.pipelined)
            sf_members = [(p.name, members[p.name])
                          for p in state.pipelined.pipelines]
            lowering = state.lowering
        else:
            exec_graph = graph
            sf_members = []
            lowering = None
        self._backend = make_backend(options.mode, exec_graph, sf_members,
                                     lowering)
        self._struct_keys = (state.dedupe.struct_keys
                             if state.dedupe is not None else None)
        self.inplace_feeds = frozenset(inplace_feeds)
        self._engine = self._make_engine(options.capture)

    def _make_engine(self, capture: bool) -> Engine:
        return Engine(self._backend, (self.fingerprint, self.options.cache_key()),
                      struct_keys=self._struct_keys, capture=capture,
                      inplace_feeds=self.inplace_feeds)

    # -- execution --------------------------------------------------------
    def run(self, feeds: dict[str, torch.Tensor], params: dict | None = None,
            ) -> ExecutionReport:
        return self._engine.run(feeds, params or {})

    def uncaptured(self) -> "CompiledApp":
        """This artifact as `CompilerOptions(capture=False)` compiles it:
        the same passes and programs (shared through the cache), every run
        a walk of the plan, without compiling or tracing again."""
        other = copy.copy(self)
        other.options = replace(self.options, capture=False)
        other._engine = other._make_engine(False)
        return other

    def with_mode(self, mode: str) -> "CompiledApp":
        """This artifact's graph compiled in `mode`, its other options
        kept: the passes run again, a traced callable is not traced again
        (the trace does not depend on the mode)."""
        options = replace(self.options, mode=mode)
        state, records = _run_passes(self.graph, options, PassManager(),
                                     self.state.device)
        return self._recompiled(options, state, records)

    def _recompiled(self, options, state, records) -> "CompiledApp":
        return CompiledApp(self.graph, options, state, records, self.inplace_feeds)

    def capture_stats(self) -> dict[str, float]:
        """The captured plans: graphs, replays, the seconds of their warm-ups
        (each plan's first run) and of their captures apart, and the bytes
        their graph pools hold (core/cudagraph.py `graph_stats`)."""
        return self._engine.capture_stats()

    def init_params(self, seed: int = 0, dtype=torch.float32,
                    device="cuda", scale: float = 0.02) -> dict[str, Any]:
        return init_params(self.graph, seed, dtype, device, scale)

    # -- analytics --------------------------------------------------------
    def estimate(self, hw: HwSpec | None = None, mode: str | None = None,
                 ) -> GraphCost:
        """Analytic end-to-end cost (paper Figs 10-14) of this artifact's
        pipelined IR under `mode` (default: the compiled mode)."""
        return evaluate(self.pipelined, hw or self.options.resolved_hw(),
                        mode or self.options.mode)

    def describe(self) -> str:
        """Human-readable pass pipeline + artifact summary."""
        mode = self.options.mode
        how = {"bsp": "one eager PyTorch call per op",
               "vertical": "one whole-graph program (one per run between "
                           "collectives), torch.compile'd on CUDA and eager on the CPU",
               "kitsune": "one callable per sf-node launching the Hopper "
                          "kernels (plain versions on the CPU)"}[mode]
        cap = ("the card: each plan captured after its first run as one CUDA "
               "graph and replayed" if self.options.capture else
               "the card as on the CPU: every run walks the plan (capture=False)")
        lines = [f"CompiledApp({self.graph.name}, mode={mode}, "
                 f"fingerprint={self.fingerprint})",
                 f"  executes as {how}",
                 f"  on {cap}",
                 f"  lowering policy {self.options.lowering_policy}"]
        for r in self.pass_records:
            flag = " [disabled]" if r.disabled else ""
            lines.append(f"  pass {r.name:<16} {r.seconds * 1e3:8.2f} ms"
                         f"{flag}  {r.summary}")
        for p in self.pipelined.pipelines:
            lines.append(f"  pipeline {p.name}: "
                         f"{len(p.stages)} stages, {len(p.queues)} queues")
            low = (self.lowering.pipelines.get(p.name)
                   if self.lowering is not None else None)
            lowered_of = {}
            if low is not None:
                lowered_of = {op: m for m in low.matches for op in m.ops}
            for s in p.stages:
                alloc = self.balance_results.get(p.name)
                units = (alloc.allocation.get(s.name) if alloc else None)
                ustr = f" units={units}" if units is not None else ""
                kstr = ""
                kernels = sorted({lowered_of[o.name].label() for o in s.ops
                                  if o.name in lowered_of})
                if kernels:
                    kstr = f" kernel={'|'.join(kernels)}"
                lines.append(f"    stage {s.name} [{s.resource}]"
                             f" ops={[o.name for o in s.ops]}{ustr}{kstr}")
            for q in p.queues:
                lines.append(f"    queue {q.name}: {q.producer} -> "
                             f"{q.consumers} ({q.payload_bytes // 1024}KB"
                             f" x{q.depth})")
            if low is not None:
                for m in low.matches:
                    tag = "" if m.executable else " (plan-only)"
                    if m.verdict is not None:
                        word = "accepted" if m.verdict.lowered else "declined"
                        tag += f" [{word}: {m.verdict.reason()}]"
                    lines.append(f"    lowered {m.label()}{tag}: "
                                 f"{'+'.join(m.ops)} -> {m.out}")
                for op, why in low.fallbacks.items():
                    lines.append(f"    fallback {op}: {why}")
        lines.extend(self._describe_donation())
        st = self._engine.capture_stats() if self._engine._plans else None
        if st and st["graphs"]:
            lines.append(f"  captured {st['graphs']} plans: {st['replays']} replays, "
                         f"{st['capture_s']:.3f} s capturing, graph pools "
                         f"{st['pool_bytes'] / 1e6:.1f} MB")
        return "\n".join(lines)

    def _describe_donation(self) -> list[str]:
        return []

    def lowering_verdicts(self) -> list[dict]:
        """Per-site kernel-lowering verdict rows."""
        if self.lowering is None:
            return []
        return self.lowering.verdict_table()

    def __repr__(self):
        return (f"CompiledApp({self.graph.name!r}, mode={self.options.mode!r}, "
                f"{len(self.pipelined.pipelines)} pipelines)")


class TracedApp(CompiledApp):
    """A CompiledApp built by tracing a PyTorch callable (core/trace.py).

    Behaves like the original function: `app(*args)` feeds the positional
    tensors (plus the captured consts) through the compiled executor and
    returns outputs in the function's own pytree structure.  Weights live in
    the traced consts, so `init_params()` is empty and `run()` needs no
    params dict.  The graph holds its own backward, so it runs under
    `torch.no_grad()`.

    `donate_feeds` are the input names whose storage the outputs reuse
    (`donation`: the (input, output value) pairs, core/trace.py
    `donate_outputs`): as with `jax.jit`'s donation, those inputs are
    CONSUMED by a call -- they hold the new values afterwards -- so feed
    each call the previous call's outputs.  A donated input that shares its
    storage with another input is copied first and so left alone.

    On the card the consts, the donated feeds and the `inplace` feeds
    (arguments the caller keeps alive at fixed addresses: weights, an
    engine's cache) are read in place by the captured plan; the other
    feeds are copied into the graph's own buffers (core/executor.py
    `Engine`)."""

    def __init__(self, traced: TracedFunction, options: CompilerOptions,
                 state: CompileState, pass_records: list[PassRecord],
                 donate_feeds: frozenset[str] = frozenset(),
                 donation: list[tuple[str, str]] | None = None,
                 inplace: frozenset[str] = frozenset()):
        self.traced = traced
        self.donate_feeds = donate_feeds
        self.donation = list(donation or [])
        self._donated = tuple(d for d, _ in self.donation)
        self._inplace = inplace
        super().__init__(traced.graph, options, state, pass_records,
                         frozenset(traced.consts) | donate_feeds | inplace)

    def _recompiled(self, options, state, records) -> "TracedApp":
        # the trace's record stays first: the new artifact runs that trace
        return TracedApp(self.traced, options, state, self.pass_records[:1] + records,
                         self.donate_feeds, self.donation, self._inplace)

    def __call__(self, *args):
        report = self.run(self.traced.feeds(*args))
        return self.traced.unflatten_outputs(report.outputs)

    def run(self, feeds: dict[str, torch.Tensor], params: dict | None = None,
            ) -> ExecutionReport:
        full = dict(self.traced.consts)
        full.update(feeds)
        inplace = self._unalias(full) if self._donated else None
        with torch.no_grad():
            return self._engine.run(full, params or {}, inplace=inplace)

    def _unalias(self, feeds: dict) -> frozenset[str] | None:
        """Copy each donated feed that shares its storage with another feed:
        writing it in place would change the other.  Returns the in-place
        feeds of this call (the copies are not), None if nothing was
        copied."""
        owners: dict[int, int] = {}
        for t in feeds.values():
            ptr = t.untyped_storage().data_ptr()
            owners[ptr] = owners.get(ptr, 0) + 1
        copied = set()
        for d in self._donated:
            t = feeds[d]
            if owners[t.untyped_storage().data_ptr()] > 1:
                feeds[d] = t.clone()
                copied.add(d)
        return self.inplace_feeds - copied if copied else None

    def init_params(self, seed: int = 0, dtype=torch.float32, device="cuda",
                    scale: float = 0.02) -> dict:
        return {}  # weights are captured consts, fed automatically

    def _describe_donation(self) -> list[str]:
        if not self.donate_feeds:
            return []
        nbytes = sum(self.graph.nodes[d].out.nbytes for d, _ in self.donation)
        return [f"  donation declared={len(self.donate_feeds)} feeds, "
                f"{len(self.donation)} reused by outputs "
                f"({nbytes / 1e6:.2f} MB written in place)"]

    def __repr__(self):
        return (f"TracedApp({self.graph.name!r}, mode={self.options.mode!r}, "
                f"{len(self.graph.nodes)} nodes, "
                f"{len(self.traced.consts)} consts)")


def _run_passes(graph: Graph, options: CompilerOptions, pm: PassManager,
                device=None) -> tuple[CompileState, list[PassRecord]]:
    state = CompileState(graph, device=device)
    records = pm.run(state, options)
    _ensure_pipelined(state, options)
    return state, records


def compile(graph: Graph | Callable, *args,
            options: CompilerOptions | None = None,
            example_inputs: tuple | None = None,
            pass_manager: PassManager | None = None,
            donate_argnums: tuple[int, ...] = (),
            donate_feeds: tuple[str, ...] = (),
            inplace_argnums: tuple[int, ...] = (),
            **option_overrides) -> CompiledApp:
    """Compile an operator graph OR any PyTorch callable.

    Graphs: `repro_torch.compile(g)` / `repro_torch.compile(g,
    mode="vertical")` / `repro_torch.compile(g, CompilerOptions(...))`.
    Callables: `repro_torch.compile(fn, example_inputs)` (optionally with a
    CompilerOptions third positional / keyword) traces `fn` under fake
    tensors -- tracing is pass 0 of the pipeline -- and returns a TracedApp
    that is itself callable like `fn`.  `example_inputs` is the tuple of
    positional example arguments (a single tensor may be passed bare).

    Donation (callables only): `donate_argnums` marks positional arguments
    whose storage the app may reuse for its outputs -- the training step
    donates its (state,) argument, so parameters and optimizer moments are
    written in place instead of doubling resident memory; `donate_feeds`
    names input feeds (`arg<i>`) directly.  Only those inputs are donated.
    `inplace_argnums` marks arguments the caller keeps alive at fixed
    addresses (weights, an engine's cache): on the card the captured plan
    reads them in place instead of copying them into its own buffers, and
    a call that moves them captures anew (the reference has no counterpart:
    XLA has no addresses).

    The lowering's verdicts and tiles are measured on the device the
    compile will run on: a callable's example inputs' device; for a graph,
    the card when one is present, as the port's entry points default."""
    for a in args:
        if isinstance(a, CompilerOptions):
            if options is not None:
                raise TypeError("options given twice")
            options = a
        elif example_inputs is None:
            example_inputs = a
        else:
            raise TypeError(f"unexpected positional argument {a!r}")
    if options is None:
        options = CompilerOptions(**option_overrides)
    elif option_overrides:
        options = replace(options, **option_overrides)
    pm = pass_manager or PassManager()
    if isinstance(graph, Graph):
        if example_inputs is not None:
            raise TypeError("example_inputs is only valid when compiling a "
                            "callable")
        if donate_argnums or donate_feeds or inplace_argnums:
            raise TypeError("donation and inplace_argnums are only valid when "
                            "compiling a callable")
        state, records = _run_passes(graph, options, pm)
        return CompiledApp(graph, options, state, records)
    if not callable(graph):
        raise TypeError(f"compile takes a Graph or a callable, got {graph!r}")
    if example_inputs is None:
        raise TypeError("repro_torch.compile(fn, ...) needs example_inputs")
    if not isinstance(example_inputs, (tuple, list)):
        example_inputs = (example_inputs,)
    example_inputs = tuple(example_inputs)
    t0 = time.perf_counter()
    traced = trace_fn(graph, *example_inputs)
    donate = set(donate_feeds) | _arg_names(traced, example_inputs, donate_argnums,
                                            "donate_argnums")
    inplace = _arg_names(traced, example_inputs, inplace_argnums, "inplace_argnums")
    unknown = donate - set(traced.in_names)
    if unknown:
        raise ValueError(f"donate_feeds {sorted(unknown)} are not inputs")
    donation = donate_outputs(traced, donate) if donate else []
    rec = PassRecord("trace", time.perf_counter() - t0, False,
                     f"{len(traced.graph.nodes)} nodes, "
                     f"{len(traced.consts)} consts, "
                     f"{len(donation)} donated outputs")
    state, records = _run_passes(traced.graph, options, pm,
                                 _example_device(example_inputs))
    return TracedApp(traced, options, state, [rec] + records,
                     frozenset(donate), donation, frozenset(inplace))


def _example_device(example_inputs: tuple) -> torch.device:
    """The device of a callable's example inputs (their first tensor's)."""
    for leaf in pytree.tree_leaves(example_inputs):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _arg_names(traced: TracedFunction, example_inputs: tuple,
               argnums: tuple[int, ...], what: str) -> set[str]:
    """Argument positions -> the traced input names their flattened leaves
    occupy (in_names is leaf-ordered)."""
    spans, start = [], 0
    for a in example_inputs:
        n = len(pytree.tree_leaves(a))
        spans.append((start, start + n))
        start += n
    names: set[str] = set()
    for i in argnums:
        if not 0 <= i < len(spans):
            raise ValueError(f"{what} {i} out of range for {len(spans)} example inputs")
        lo, hi = spans[i]
        names.update(traced.in_names[lo:hi])
    return names


# ---------------------------------------------------------------------------
# cached_jit: the executable cache for any callable
# ---------------------------------------------------------------------------

class CachedFunction:
    """A callable bound to the executable cache (the reference's
    `cached_jit`).

    The first call per argument signature builds, counted by
    `lowering_count()`; every later call -- including one from another
    instance constructed with the same `key` -- reuses the build.  On the
    CPU the build is `fn` itself, run eagerly.  On the card it is a CUDA
    graph (core/cudagraph.py `GraphFunction`), captured right after the
    first call, which runs eagerly on the capture stream as its warm-up.
    Tensor leaves of `donate_argnums` and `inplace_argnums` arguments are
    read in place, and their addresses are part of the signature: moving
    them builds anew.  Every other tensor leaf is copied into a buffer the
    graph owns (not when the call passes that buffer itself), so the graph
    never writes into a caller's tensor the caller did not hand over; an
    output that is not an in-place leaf is cloned before it is returned.
    Non-tensor arguments are part of the signature by value.

    A graph keyed by addresses serves only the caller whose tensors sit
    there: `graphs()` are the ones this instance called, and `release()`
    drops them from the cache (a later call builds again), so that an owner
    of those tensors -- a serving engine -- frees its graphs and their
    pools when it goes."""

    def __init__(self, fn: Callable, key: tuple, donate_argnums: tuple[int, ...] = (),
                 inplace_argnums: tuple[int, ...] = ()):
        self._fn = fn
        self._key = ("cached_jit",) + tuple(key)
        self._inplace = frozenset(donate_argnums) | frozenset(inplace_argnums)
        self._graph_keys: dict[tuple, None] = {}

    def graphs(self) -> list[GraphFunction]:
        """The cached graphs this instance's calls on the card used."""
        cache = executable_cache()
        return [g for g in map(cache.get, self._graph_keys) if g is not None]

    def graph_stats(self) -> dict[str, float]:
        """`graphs()` summed by core/cudagraph.py `graph_stats`."""
        return graph_stats(g.captured for g in self.graphs())

    def release(self) -> None:
        """Drop the graphs this instance's calls on the card used."""
        cache = executable_cache()
        for key in self._graph_keys:
            cache.discard(key)
        self._graph_keys.clear()

    def __call__(self, *args):
        device = cuda_device(args)
        key = self._key + tuple(_plan_key(a, device is not None and i in self._inplace)
                                for i, a in enumerate(args))
        cache = executable_cache()
        if device is None:
            return cache.get_or_build(key, lambda: self._fn)(*args)
        self._graph_keys[key] = None
        flat, tree = pytree.tree_flatten(args)
        first = []

        def build() -> GraphFunction:
            mask = [i in self._inplace for i, a in enumerate(args)
                    for _ in pytree.tree_leaves(a)]
            fn = self._fn
            gf = GraphFunction(lambda *leaves: fn(*pytree.tree_unflatten(list(leaves), tree)),
                               flat, mask, device, what=f"cached_jit {self._key[1:]}")
            first.append(gf.take_first())
            return gf

        exe = cache.get_or_build(key, build)
        return first[0] if first else exe(flat)


def cached_jit(fn: Callable, *, key: tuple, donate_argnums: tuple[int, ...] = (),
               inplace_argnums: tuple[int, ...] = ()) -> CachedFunction:
    return CachedFunction(fn, key, donate_argnums, inplace_argnums)
