"""The port's host spans and counters on the CPU: runtime/spans.py's
`Phases`, the paged engine's tick phases (`stats()["tick"]`) and their
`torch.profiler` ranges, the request handles' four timestamps, the prefix
cache's token counters, the executor's run phases (`capture_stats()`)
and cached_jit's graph phases (`graph_stats()`).  The card's side (a
replay's phases, and no range on the device's timeline) is in
tests/test_torch_gpu.py."""
import time

import pytest
import torch

import repro_torch
from repro_torch import apps as tapps
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.runtime import spans
from repro_torch.runtime.spans import Phases, summed
from repro_torch.serve import PagedServingEngine, ServeConfig, ServingEngine

TICK_PHASES = ("admit", "plan", "stage", "launch", "wait", "emit")
GRAPH_PHASES = ("stage", "launch", "outputs")
PROMPTS = [[3 + i, 17, 5] for i in range(4)]
SHARED = [11, 7, 3, 9, 2, 6, 4, 8]            # one whole block (block_size 8)
CPU = [torch.profiler.ProfilerActivity.CPU]


def _engine(**kw):
    cfg = get_config("phi3-medium-14b").reduced()
    params = get_model(cfg).init(0, "cpu")
    kw.setdefault("num_blocks", 16)
    return PagedServingEngine(cfg, params, ServeConfig(max_len=24, batch=2, **kw), eos_id=-1)


def _ranges(prof, prefix):
    return sorted((e for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda e: e.time_range.start)


def test_phases_time_always_and_open_a_range_only_under_a_profiler(monkeypatch):
    opened = []
    real = spans._HostRange
    monkeypatch.setattr(spans, "_HostRange", lambda name: opened.append(name) or real(name))
    ph = Phases("unit", ("a", "b"))
    for _ in range(2):
        with ph.span("a"):
            time.sleep(0.001)
    assert opened == []
    assert ph.seconds["a"] >= 0.002 and ph.seconds["b"] == 0.0
    with torch.profiler.profile(activities=CPU) as prof:
        with ph.span("b"):
            pass
    assert opened == ["repro_torch.unit.b"]
    got = _ranges(prof, "repro_torch.")
    # a host range: a user annotation would show on the device's timeline too
    assert [e.name for e in got] == ["repro_torch.unit.b"] and not got[0].is_user_annotation
    assert ph.stats() == {"a_s": ph.seconds["a"], "b_s": ph.seconds["b"]}
    other = Phases("unit", ("a",))
    with other.span("a"):
        pass
    assert summed([ph, other], ("a", "b")) == {"a_s": ph.seconds["a"] + other.seconds["a"],
                                               "b_s": ph.seconds["b"]}
    assert summed([], ("a",)) == {"a_s": 0.0}
    with pytest.raises(KeyError):
        with ph.span("c"):
            pass


def test_tick_ranges_nest_under_a_profiler():
    eng = _engine()
    eng.submit(PROMPTS[0], max_new_tokens=4)
    eng.tick()
    with torch.profiler.profile(activities=CPU) as prof:
        eng.tick()
    got = _ranges(prof, "repro_torch.serve.")
    tick, phases = got[0], got[1:]
    assert tick.name == "repro_torch.serve.tick"
    # the first admit is the deadlines' expiry, outside the tick's guarded body
    assert [e.name for e in phases] == [f"repro_torch.serve.{p}"
                                        for p in ("admit",) + TICK_PHASES]
    for e in phases:
        assert tick.time_range.start <= e.time_range.start <= e.time_range.end \
            <= tick.time_range.end
        assert e.cpu_parent is not None and e.cpu_parent.name == tick.name


def test_tick_phases_sum_to_the_tick():
    eng = _engine()
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=6)
    eng.run_until_done()
    st = eng.stats()["tick"]
    assert set(st) == {p + "_s" for p in ("tick",) + TICK_PHASES}
    assert eng.decode_steps > 0 and all(st[p + "_s"] > 0 for p in TICK_PHASES)
    inner = sum(st[p + "_s"] for p in TICK_PHASES)
    assert abs(inner - st["tick_s"]) <= 0.05 * st["tick_s"]


def test_handles_stamp_their_lifecycle_and_keep_the_first_admission():
    eng = _engine(num_blocks=5)
    handles = [eng.submit(p) for p in PROMPTS]
    first = {}
    while eng.tick():
        for h in handles:
            if h.admitted is not None:
                first.setdefault(h.rid, h.admitted)
    assert eng.stats()["scheduler"]["preemptions"] >= 1
    for h in handles:
        assert h.error() is None
        assert h.submitted <= h.admitted <= h.first_token <= h.finished
        assert h.admitted == first[h.rid]
    assert sum(h.preempted for h in handles) == eng.stats()["scheduler"]["preemptions"]


def test_prefix_cache_counts_the_tokens_it_serves(monkeypatch):
    eng = _engine()
    match, reused, asked = eng.prefix.match, [], []

    def counted(prompt):
        bids, n = match(prompt)
        reused.append(n)
        asked.append(len(prompt))
        return bids, n
    monkeypatch.setattr(eng.prefix, "match", counted)
    eng.submit(SHARED + [5, 1])
    eng.run_until_done()
    eng.submit(SHARED + [5, 1])
    eng.submit(SHARED + [13])
    eng.run_until_done()
    st = eng.stats()["prefix_cache"]
    assert reused == [0, 8, 8]
    assert st["hit_tokens"] == sum(reused) == st["hits"] * eng.sc.block_size
    assert st["lookup_tokens"] == sum(asked) == 29


def test_executor_times_its_runs():
    tg, feeds = tapps.tiny_instances("cpu", seed=1)["nerf"]
    app = repro_torch.compile(tg, mode="kitsune")
    params = app.init_params(seed=0, device="cpu")
    for _ in range(3):
        app.run(feeds, params)
    st = app.capture_stats()
    assert st["runs"] == 3 and st["run_s"] > st["key_s"] > 0
    # no graph on the CPU: every run walks the plan
    assert st["graphs"] == 0 and all(st[p + "_s"] == 0.0 for p in GRAPH_PHASES)
    with torch.profiler.profile(activities=CPU) as prof:
        app.run(feeds, params)
    run, key = _ranges(prof, "repro_torch.")
    assert (run.name, key.name) == ("repro_torch.kitsune.run", "repro_torch.kitsune.key")
    assert key.cpu_parent is not None and key.cpu_parent.name == run.name


def test_cached_jit_reports_its_graphs_phases():
    """The legacy engine's cached_jit tick reports its graphs' phases in
    `graph_stats()`: on the CPU no graph is captured, so they read 0."""
    cfg = get_config("phi3-medium-14b").reduced()
    eng = ServingEngine(cfg, get_model(cfg).init(0, "cpu"), ServeConfig(max_len=16, batch=2))
    eng.submit(0, PROMPTS[0])
    eng.run_until_done(max_ticks=8)
    st = eng.graph_stats()
    assert st["graphs"] == st["replays"] == 0
    assert {p + "_s" for p in GRAPH_PHASES} <= set(st)
    assert all(st[p + "_s"] == 0.0 for p in GRAPH_PHASES)


@pytest.mark.parametrize("cell", ["phi3.multiturn", "nerf.render"])
def test_probe_tool_reads_a_tiny_cell(cell):
    """tools/probe_spans.py runs a cell at portbench's tiny size on the CPU
    and reads the window through the program's spans and counters: the
    tick's phases lie inside the tick and the tick inside the window, each
    part of the time outside the tick is a share of it, and the engine's
    submit lies inside the loop's."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    got = subprocess.run([sys.executable, "tools/probe_spans.py", "--workload", cell,
                          "--seed", "3900000123", "--seconds", "2", "--cpu"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    lines = got.stdout.splitlines()
    assert json.loads(lines[-2])["correct"] is True
    probe = json.loads(lines[-1].removeprefix("PROBE "))
    assert probe["span_cost_s"]["off"] > 0
    if cell == "nerf.render":
        assert probe["window_forwards"] > 0
        assert probe["run_host_ms"] == pytest.approx(probe["run_phase_ms"]["run"])
        return
    ph, out = probe["phase_s"], probe["outside_tick"]
    assert probe["window_steps"] > 0 and 0.0 <= probe["prefix_tok_hit"] <= 100.0
    assert 0 < sum(ph[p] for p in TICK_PHASES) <= ph["tick"] < probe["window_s"]
    assert all(out[k] >= 0 for k in ("logits_check_s", "scan_s", "due_s", "finished_s",
                                      "rest_s"))
    assert 0 < out["engine_submit_s"] <= out["submit_s"] <= out["due_s"] + out["finished_s"]
    assert probe["queue_ms"]["p90"] >= 0 and probe["prefill_ms"]["p90"] > 0
