"""Public API of the Kitsune port to PyTorch: one compiler front-door.

    import repro_torch
    from repro_torch import CompilerOptions

    app = repro_torch.compile(graph, CompilerOptions(mode="kitsune"))
    params = app.init_params(seed=0, dtype=torch.bfloat16)   # on CUDA
    report = app.run(feeds, params)

    app = repro_torch.compile(fn, example_inputs, mode="kitsune")
    outputs = app(*example_inputs)       # a TracedApp, callable like fn

`compile()` runs the staged pass pipeline (select -> split_reduction ->
create_queues -> epilogue_fuse -> lower_kernels -> dedupe -> balance) and
returns a CompiledApp (a TracedApp for a callable, traced first by
core/trace.py) whose programs are cached process-wide -- repeated
runs with same-shaped feeds perform zero new builds; on the card each plan
is captured as one CUDA graph and replayed.  `cached_jit`, the entry point
the serving stack uses for callables it does not trace, binds any callable
to the same cache.  Entry points default
to `device="cuda"`; pass `device="cpu"` to run the plain versions of the
kernels on the CPU.
"""
from .core.compiler import (CachedFunction, CompiledApp, CompilerOptions,
                            CompileState, PassManager, PassRecord, TracedApp,
                            cached_jit, compile)
from .core.executor import (ExecutionReport, GraphExecutor,
                            clear_executable_cache, executable_cache,
                            init_params, lowering_count, params_from_numpy)
from .core.graph import (Graph, Node, TensorSpec, graph_fingerprint,
                         structural_fingerprint)
from .core.trace import TracedFunction, atomic, atomic_vjp, trace

__all__ = [
    "compile", "CompilerOptions", "CompiledApp", "CompileState",
    "PassManager", "PassRecord", "TracedApp", "TracedFunction", "trace",
    "cached_jit", "CachedFunction",
    "atomic", "atomic_vjp",
    "ExecutionReport", "GraphExecutor", "init_params", "params_from_numpy",
    "executable_cache", "clear_executable_cache", "lowering_count",
    "Graph", "Node", "TensorSpec", "graph_fingerprint",
    "structural_fingerprint",
]
