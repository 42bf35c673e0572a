"""Kitsune on PyTorch and CUDA: dataflow execution for operator graphs on
an NVIDIA H100, with hand-written Hopper kernels.  The JAX package `repro`
beside it is the reference this port is held against; nothing here imports
it.

Front door:

    import repro_torch
    app = repro_torch.compile(graph, repro_torch.CompilerOptions(mode="kitsune"))
    report = app.run(feeds, params)

    app = repro_torch.compile(fn, example_inputs)   # any PyTorch callable
    outputs = app(*example_inputs)
"""
from .api import (CachedFunction, CompiledApp, CompilerOptions, Graph,
                  KernelConfig, Node, PassManager, TensorSpec, TracedApp,
                  TracedFunction, atomic, atomic_vjp, cached_jit, calibrate,
                  clear_verdict_cache, compile, graph_fingerprint,
                  init_params, lowering_count, params_from_numpy,
                  structural_fingerprint, trace, tune_cache, verdict_cache)

__all__ = [
    "compile", "CompilerOptions", "CompiledApp", "TracedApp", "TracedFunction",
    "PassManager",
    "trace", "atomic", "atomic_vjp",
    "cached_jit", "CachedFunction", "init_params", "params_from_numpy", "lowering_count",
    "verdict_cache", "clear_verdict_cache", "tune_cache", "KernelConfig", "calibrate",
    "Graph", "Node", "TensorSpec", "graph_fingerprint",
    "structural_fingerprint",
]
