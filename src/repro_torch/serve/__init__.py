"""Paged serving on the port's decode kernels (counterpart of `repro.serve`)."""
from .block_pool import NULL_BLOCK, BlockPool, OutOfBlocks
from .engine import (AsyncServingEngine, PagedKVExecutor, PagedServingEngine,
                     RequestHandle, ServeConfig, ServingEngine, paged_tick,
                     serve_step)
from .faults import (SITES, DeadlineExceeded, EngineError, FaultInjector,
                     FaultSpec, QueueFull, parse_fault_plan)
from .prefix_cache import PrefixCache, block_key
from .scheduler import Request, Scheduler, blocks_for

__all__ = [
    "ServeConfig", "ServingEngine", "serve_step",
    "PagedServingEngine", "PagedKVExecutor", "AsyncServingEngine",
    "RequestHandle", "paged_tick",
    "BlockPool", "OutOfBlocks", "NULL_BLOCK",
    "PrefixCache", "block_key",
    "Scheduler", "Request", "blocks_for",
    "EngineError", "DeadlineExceeded", "QueueFull",
    "FaultInjector", "FaultSpec", "SITES", "parse_fault_plan",
]
