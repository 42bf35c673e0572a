"""The reduction of a profiled slice: busy time, idle gaps by host span,
the breakdown, and the readers on a hand-made trace."""
from __future__ import annotations

import pytest

from portbench import bench


def trace():
    ops = [("void small_m_kernel<bf16>(float*)", 10, 30), ("ampere_gemm", 25, 40),
           ("void paged_decode_kernel<1>(int)", 60, 70), ("elementwise", 95, 130)]
    spans = [("portbench.window", 0, 100), ("portbench.tick", 5, 50),
             ("portbench.submit", 50, 62), ("portbench.tick", 62, 100)]
    return bench.Trace(ops, spans, (0, 100), {"steps": 2, "forwards": 2})


def test_busy_and_gaps():
    t = trace()
    assert t.busy_intervals() == [(10, 40), (60, 70), (95, 100)]
    assert t.busy_s() == pytest.approx(45e-6) and t.window_s == pytest.approx(1e-4)
    gaps = t.gaps_by_host()
    # gaps [0, 10) before any span, [40, 60) and [70, 95) inside ticks
    assert gaps == pytest.approx({"host": 10e-6, "portbench.tick": 20e-6 + 25e-6})


def test_breakdown_names():
    b = trace().breakdown()
    names = [n for n, _ in b["device_ops"]]
    assert "small_m_kernel<bf16>" in names and "paged_decode_kernel<1>" in names
    assert len(b["idle_gaps"]) <= 10


def test_readers_on_trace():
    obs = {"trace": trace(), "peaks": bench.peaks("NVIDIA H100 80GB HBM3"),
           "step_ms": 0.05}
    # 45 us busy over 2 steps of 50 us
    assert bench.reader("idle_pct.serve").read(obs) == pytest.approx(55.0)
    assert bench.reader("torch_ops_ms.serve").read(obs) == pytest.approx(1e3 * 20e-6 / 2)
    assert bench.reader("idle_pct.infer").read({"trace": None}) is None
    assert bench.reader("idle_pct.infer").read(obs) == pytest.approx(55.0)
