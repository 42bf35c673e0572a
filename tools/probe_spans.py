"""One benchmark cell run as `portbench/run.py` runs it, read through the
program's own spans and counters (runtime/spans.py, the request handles,
the prefix cache's token counters, the executor's run phases).

    python3 tools/probe_spans.py --workload phi3.chat --seed 1 --seconds 51 --trace 0
    python3 tools/probe_spans.py --workload phi3.chat --seed 1 --seconds 5 --cpu  # tiny, no card

The harness's files are left as they are: this process wraps a few of its
functions and reads what passes through them.  The result line is
`portbench/run.py`'s; the readings follow it on one line, `PROBE {json}`:

- serving cells, over the window (from the harness's counter snapshot at
  its start to the one at its close): each tick phase's seconds over the
  window's decode steps (`phase_ms_a_step`), with `tick_host_ms` = (tick -
  wait) / steps and `tick_wait_ms` = wait / steps; `outside_tick`, the
  window's seconds outside the engine's `tick()`, split by the loop's own
  work: `logits_check_s` (the watched requests' logits read back for the
  check), `scan_s` (polling each live handle for tokens after a tick),
  `due_s` and `finished_s` (the traffic's submissions and, closed loop,
  each user's next turn; `engine_submit_s` of both is the engine's
  `submit`), and `rest_s`, the loop itself and its sleeps while nothing is
  pending; `idle_cap_pct` = (window - wait) / window, the most the device
  can idle (it has nothing queued outside `wait` and `launch`), and
  `idle_floor_pct` = (window - wait - launch) / window;
  `prefix_tok_hit` = hit tokens / lookup tokens; over the window's
  finished requests, p50 and p90 of `admitted - submitted` (`queue_ms`)
  and of `first_token - admitted` (`prefill_ms`), and their preemptions;
- app cells, over the window's forwards: each run phase's ms a forward
  and `run_host_ms` = (run - launch) / forwards;
- with `--trace 1`, the profiled slice's idle gaps named by the harness's
  spans and the program's ranges inside them (`gaps`), and in serving
  cells the share of the idle inside the harness's tick span that carries
  a `repro_torch.serve.*` name;
- `span_cost_s`: one span's host seconds with no profiler and with one
  recording.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "portbench"))
import run as pb_run  # noqa: E402  (sets the caches and sys.path as a run does)

import torch  # noqa: E402

from portbench import bench, serving  # noqa: E402
from repro_torch.serve import PagedServingEngine  # noqa: E402

OUT: dict = {}
LOOP_S = dict.fromkeys(("harness_tick", "fed", "keep_logits", "due", "finished", "submit",
                        "engine_submit"), 0.0)


def _timed(fn, key):
    def wrapped(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            LOOP_S[key] += time.perf_counter() - t
    return wrapped


def _wrap_loop() -> None:
    L = serving.Loop
    L._tick = _timed(L._tick, "harness_tick")
    L._fed = _timed(L._fed, "fed")
    L._keep_logits = _timed(L._keep_logits, "keep_logits")
    L.submit = _timed(L.submit, "submit")
    for feed in (serving.OpenFeed, serving.ClosedFeed):
        feed.due = _timed(feed.due, "due")
        feed.finished = _timed(feed.finished, "finished")
    PagedServingEngine.submit = _timed(PagedServingEngine.submit, "engine_submit")
    counters = L.counters

    def snapped(self):
        c = counters(self)
        eng = self.eng
        pc = eng.prefix.stats() if eng.prefix_enabled else {}
        c["probe"] = {"phases": dict(eng.phases.seconds), "steps": eng.decode_steps,
                      "ticks": eng.ticks, "t": time.perf_counter(), "loop": dict(LOOP_S),
                      "hit_tokens": pc.get("hit_tokens", 0),
                      "lookup_tokens": pc.get("lookup_tokens", 0)}
        return c
    L.counters = snapped
    observations = L.observations

    def observed(self, cfg, wl, peaks):
        obs = observations(self, cfg, wl, peaks)
        a, b = self.snap0["probe"], self.snap1["probe"]
        ph = {k: b["phases"][k] - a["phases"][k] for k in a["phases"]}
        loop = {k: b["loop"][k] - a["loop"][k] for k in a["loop"]}
        steps, window = b["steps"] - a["steps"], b["t"] - a["t"]
        OUT.update(window_s=window, window_ticks=b["ticks"] - a["ticks"], window_steps=steps,
                   phase_s=ph, phase_ms_a_step={k: 1e3 * v / steps for k, v in ph.items()},
                   tick_host_ms=1e3 * (ph["tick"] - ph["wait"]) / steps,
                   tick_wait_ms=1e3 * ph["wait"] / steps,
                   idle_cap_pct=100.0 * (window - ph["wait"]) / window,
                   idle_floor_pct=100.0 * (window - ph["wait"] - ph["launch"]) / window)
        check = loop["fed"] + loop["keep_logits"]
        OUT["outside_tick"] = {
            "s": window - ph["tick"], "logits_check_s": check,
            "scan_s": loop["harness_tick"] - ph["tick"] - check,
            "due_s": loop["due"], "finished_s": loop["finished"],
            "submit_s": loop["submit"], "engine_submit_s": loop["engine_submit"],
            "rest_s": window - loop["harness_tick"] - loop["due"] - loop["finished"]}
        looked = b["lookup_tokens"] - a["lookup_tokens"]
        OUT["prefix_tok_hit"] = (100.0 * (b["hit_tokens"] - a["hit_tokens"]) / looked
                                 if looked else None)
        reqs = [s for s in self.in_window() if s.done]
        for name, lo, hi in (("queue_ms", "submitted", "admitted"),
                             ("prefill_ms", "admitted", "first_token")):
            xs = [1e3 * (getattr(s.handle, hi) - getattr(s.handle, lo)) for s in reqs]
            OUT[name] = {q: bench.quantile(xs, f) for q, f in (("p50", 0.5), ("p90", 0.9))
                         } if xs else None
        OUT["preempted"] = sum(s.handle.preempted for s in reqs)
        OUT["window_requests_done"] = len(reqs)
        return obs
    L.observations = observed


def _keep_program_ranges() -> None:
    """Keep the program's host ranges as spans of the reduced profile, so
    that `gaps_by_host` names a gap by the program's phase too."""
    reduce = bench.reduce_profile

    def reduced(prof, torch_mod):
        tr = reduce(prof, torch_mod)
        on_device = 0
        for e in prof.events():
            if e.name.startswith("repro_torch."):
                if e.device_type == torch_mod.autograd.DeviceType.CUDA:
                    on_device += 1
                else:
                    tr.spans.append((e.name, e.time_range.start, e.time_range.end))
        OUT["program_ranges_on_device"] = on_device
        return tr
    bench.reduce_profile = reduced


class _AppRuns:
    """The compiled app, its engine's run seconds kept after each call."""

    def __init__(self, app):
        self._app, self.log = app, []

    def __getattr__(self, name):
        return getattr(self._app, name)

    def run(self, *a, **kw):
        rep = self._app.run(*a, **kw)
        self.log.append(dict(self._app._engine.phases.seconds))
        return rep


def span_cost() -> dict:
    """Host seconds of one span with no profiler, and with one recording."""
    from repro_torch.runtime.spans import Phases
    ph, n, out = Phases("probe", ("a",)), 20000, {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for label in ("off", "on"):
        prof = torch.profiler.profile(activities=acts) if label == "on" else None
        if prof is not None:
            prof.__enter__()
        t = time.perf_counter()
        for _ in range(n):
            with ph.span("a"):
                pass
        out[label] = (time.perf_counter() - t) / n
        if prof is not None:
            prof.__exit__(None, None, None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="the cell cut to portbench/tests' tiny size, on the CPU")
    args = ap.parse_args(argv)
    _wrap_loop()
    _keep_program_ranges()
    if args.cpu:
        from portbench.tests.conftest import tiny_cell
        cell, dev = tiny_cell(args.workload), torch.device("cpu")
    else:
        cell, dev = bench.find_cell(args.workload), torch.device("cuda", 0)
        from repro_torch.kernels import _build
        _build.build_all()
    drv = bench.driver(cell.workload["driver"])
    kw, apps = {}, []
    if "serve" not in cell.workload:
        import repro_torch

        def program(graph, opts):
            apps.append(_AppRuns(repro_torch.compile(graph, opts)))
            return apps[-1]
        kw["program"] = program
    out = drv.run(cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                  device=dev, process_start=pb_run.PROCESS_START, **kw)
    if apps:
        # set-up runs the app three times; the window's forwards follow
        log, n = apps[0].log, out.attempted
        a, b = log[2], log[2 + n]
        d = {k: b[k] - a[k] for k in a}
        OUT["window_forwards"] = n
        OUT["run_phase_ms"] = {k: 1e3 * v / n for k, v in d.items()}
        OUT["run_host_ms"] = 1e3 * (d["run"] - d["launch"]) / n
    if out.trace is not None:
        gaps = out.trace.gaps_by_host()
        OUT["gaps"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:16]
        in_tick = sum(v for k, v in gaps.items() if k.startswith("portbench.tick"))
        named = sum(v for k, v in gaps.items()
                    if k.startswith("portbench.tick/repro_torch.serve"))
        OUT["tick_gap_s"], OUT["tick_gap_named_s"] = in_tick, named
        OUT["busy_s"], OUT["trace_window_s"] = out.trace.busy_s(), out.trace.window_s
    OUT["span_cost_s"] = span_cost()
    device = {"platform": dev.type,
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    for note in out.notes:
        print(note, file=sys.stderr)
    print(json.dumps(bench.result_line(cell, out, bool(args.trace), device)), flush=True)
    print("PROBE " + json.dumps(OUT), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
