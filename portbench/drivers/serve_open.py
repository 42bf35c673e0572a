"""An open loop of independent users against the paged engine: Poisson
arrivals at the workload's fixed rate, each request submitted between
ticks once it falls due and timed from its due time (portbench/serving.py).

Set-up: the weights from the seed, the engine (its page pool sized by the
profiling pass unless the workload states `num_blocks`), and one request
whose prompt is one longer than a prefill chunk, run to its end, so that
every tick graph the traffic uses is captured before the window.
"""
from __future__ import annotations

from portbench import serving


def warm(eng, feed) -> None:
    chunk = eng.sc.prefill_chunk
    eng.submit([3] * (chunk + 1), max_new_tokens=2)
    serving.run_until_idle(eng)


def run(cell, **kw):
    return serving.serve_cell(cell, feed_of=serving.OpenFeed, warm=warm, **kw)
