"""Kitsune core on PyTorch: operator-graph IR, staged compiler, executor.

The paper's SS5 flow is exposed as ONE front door (compiler.py):

    app = repro_torch.compile(graph, CompilerOptions(mode=...))  # passes
    app.run(feeds, params)                                       # cached
    app = repro_torch.compile(fn, example_inputs)   # traced (trace.py)
    step = cached_jit(fn, key=...)                  # any callable, cached

with the stages runnable as named passes through PassManager:

    select -> split_reduction -> create_queues -> epilogue_fuse ->
    lower_kernels -> dedupe -> balance

The free functions (select_subgraphs, design_pipeline, balance,
GraphExecutor) stay exported for direct pass-level use and tests.
"""
from .graph import (Graph, Node, TensorSpec, MXU, VPU, graph_fingerprint,
                    node_struct_payload, program_struct_key,
                    structural_fingerprint, structural_hashes,
                    subgraph_interface)
from .patterns import select_subgraphs, Selection, SfNode, PATTERN_LIBRARY
from .pipeline import (design_pipeline, split_reductions, plan_queues,
                       fuse_epilogues, materialize_queues, OpQueue,
                       DedupeInfo, dedupe_programs,
                       PipelinedGraph, Pipeline, Stage, QueueSpec)
from .balance import solve_allocation, balance, BalanceResult
from .costmodel import (A100, H100, HwSpec, evaluate, cost_bsp, cost_vertical,
                        cost_kitsune, cost_kernel_site, calibrate, roofline,
                        RooflineTerms, utilization_quadrants,
                        PEAK_FLOPS_PER_CHIP, HBM_BW_PER_CHIP, NVLINK_BW_PER_LINK)
from .queue import (queue_bandwidth, QueueLevel, L2_QUEUE_A100, L2_QUEUE_H100,
                    NVLINK_QUEUE, spatial_pipeline, make_spatial_pipeline,
                    ring_push)
from .executor import (GraphExecutor, ExecutorBackend, BSPBackend,
                       VerticalBackend, KitsuneBackend, make_backend,
                       ExecutionReport, ExecutionPlan, ExecutableCache,
                       compare_traffic, init_params, params_from_numpy,
                       executable_cache,
                       clear_executable_cache, lowering_count,
                       verdict_cache, clear_verdict_cache)
from .lower import (KernelMatch, LoweringPlan, PipelineLowering, Verdict,
                    lower_pipeline, lower_pipelines)
from .trace import (AtomicSpec, TracedFunction, atomic, atomic_vjp,
                    attention_flops, trace)
from .compiler import (CompilerOptions, CompiledApp, CompileState,
                       PassManager, PassRecord, TracedApp, cached_jit,
                       CachedFunction, compile)
from .cudagraph import (CapturedGraph, GraphCaptureError, GraphFunction,
                        capture_stream)

__all__ = [
    "Graph", "Node", "TensorSpec", "MXU", "VPU", "graph_fingerprint",
    "node_struct_payload", "program_struct_key", "structural_fingerprint",
    "structural_hashes", "subgraph_interface",
    "select_subgraphs", "Selection", "SfNode", "PATTERN_LIBRARY",
    "design_pipeline", "split_reductions", "plan_queues", "fuse_epilogues",
    "materialize_queues", "OpQueue", "DedupeInfo", "dedupe_programs",
    "PipelinedGraph", "Pipeline", "Stage", "QueueSpec",
    "solve_allocation", "balance", "BalanceResult",
    "A100", "H100", "HwSpec", "evaluate", "cost_bsp", "cost_vertical",
    "cost_kitsune", "cost_kernel_site", "calibrate", "roofline",
    "RooflineTerms", "utilization_quadrants", "PEAK_FLOPS_PER_CHIP",
    "HBM_BW_PER_CHIP", "NVLINK_BW_PER_LINK",
    "queue_bandwidth", "QueueLevel", "L2_QUEUE_A100", "L2_QUEUE_H100",
    "NVLINK_QUEUE", "spatial_pipeline", "make_spatial_pipeline", "ring_push",
    "GraphExecutor", "ExecutorBackend", "BSPBackend", "VerticalBackend",
    "KitsuneBackend", "make_backend", "ExecutionReport", "ExecutionPlan",
    "ExecutableCache", "compare_traffic", "init_params", "params_from_numpy",
    "executable_cache",
    "clear_executable_cache", "lowering_count",
    "verdict_cache", "clear_verdict_cache",
    "KernelMatch", "LoweringPlan", "PipelineLowering", "Verdict",
    "lower_pipeline", "lower_pipelines",
    "CompilerOptions", "CompiledApp", "CompileState", "PassManager",
    "PassRecord", "TracedApp", "cached_jit", "CachedFunction", "compile",
    "CapturedGraph", "GraphCaptureError", "GraphFunction", "capture_stream",
    "AtomicSpec", "TracedFunction", "atomic", "atomic_vjp",
    "attention_flops", "trace",
]
