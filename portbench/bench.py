"""The harness's shared parts: where its files are, the contract's result
line, host spans, the device trace and its reduction, the per-layer metric
readers, and the checks that a run may print a result at all.

Nothing here imports the program (`repro_torch`): the drivers do, after
`run.py` has found it.  Nothing here or anywhere under `portbench/`
imports jax, jaxlib, flax or the JAX package `repro`.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process once
# its window has closed (compared whole: `repro_torch` is not `repro`)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the names of the program's own CUDA kernels (src/repro_torch/kernels/csrc),
# as the profiler reports them; every other device op is PyTorch's or cuBLAS's
PORT_KERNELS = ("fused_mlp_kernel", "mlp_fwd_wgmma", "small_m_kernel", "mlp_bwd_",
                "simt_attention_kernel", "wgmma_attention_kernel", "flash_decode_kernel",
                "paged_decode_kernel", "decode_combine_kernel", "queue_reduce_kernel")


class BenchError(RuntimeError):
    """A run that cannot produce a result: the program, the card or a file
    is missing, or the run broke a rule of the contract."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"{path} is missing")
    return load_json(path)


@dataclass
class Cell:
    """One entry of BENCHMARK.json's `workloads`, with its configuration
    and workload files read and the metrics it reports."""
    name: str
    entry: dict
    config: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    workload = load_json(HERE / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"]:
        raise BenchError(f"workloads/{name}.json names {workload['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    return Cell(name, entry, config, workload,
                [m for m in bench["end_to_end"] if reports(m, name)],
                [m for m in bench["per_layer"] if reports(m, name)])


def load_module(path: Path, name: str):
    """A harness file that is found by name (a driver, a metric reader)."""
    if not path.exists():
        raise BenchError(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def reader(metric: str):
    """The reader of one per-layer metric: `metrics/<metric>.py`, whose
    `read(obs)` returns the value or None where it finds nothing to read."""
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def peaks(device_kind: str) -> dict:
    """The card's published peaks (peaks.json), by the name
    `torch.cuda.get_device_name()` gives; an H100 not named there takes
    the SXM part's."""
    table = load_json(HERE / "peaks.json")
    return table.get(device_kind, table["NVIDIA H100 80GB HBM3"])


def quantile(values: list[float], q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order
    statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """A profiled slice of a run: device ops and the harness's host spans
    ("portbench.*" record_function ranges) on the profiler's clock (us),
    and the slice itself (`window`)."""
    ops: list[tuple[str, float, float]]
    spans: list[tuple[str, float, float]]
    window: tuple[float, float]
    units: dict = field(default_factory=dict)   # what the slice covered

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _clipped(self):
        lo, hi = self.window
        for name, a, b in self.ops:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                yield name, a, b

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, a, b in sorted(self._clipped(), key=lambda r: r[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def op_seconds(self, match=None) -> float:
        """Seconds of device ops in the slice whose name `match(name)`
        accepts (every op without one); overlapping ops each count."""
        return sum(b - a for n, a, b in self._clipped() if match is None or match(n)) * 1e-6

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for n, a, b in self._clipped():
            key = short_name(n)
            out[key] = out.get(key, 0.0) + (b - a) * 1e-6
        return out

    def gaps_by_host(self) -> dict[str, float]:
        """Device idle time in the slice, by what the host was doing when
        each gap began: the harness spans that covered that moment, inner
        last ("host" where none did)."""
        lo, hi = self.window
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        out: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            names = [n for n, s, e in sorted(self.spans, key=lambda r: r[1])
                     if s <= a < e and n != "portbench.window"]
            key = "/".join(names) or "host"
            out[key] = out.get(key, 0.0) + (b - a) * 1e-6
        return out

    def breakdown(self) -> dict:
        top = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps_by_host().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(name: str) -> str:
    """A device op's name without its return type and argument list."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] or name
                break
    return name[:160]


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


class Profiled:
    """`with Profiled(torch) as prof: ...` profiles the block on the CPU and
    the card, synchronising at both ends, and leaves the reduced `Trace`
    in `prof.trace`.  Inside, `prof.span(name)` marks host work."""

    def __init__(self, torch_mod):
        self.torch = torch_mod
        self.trace: Trace | None = None

    def span(self, name: str):
        return self.torch.profiler.record_function("portbench." + name)

    def __enter__(self):
        t = self.torch
        acts = [t.profiler.ProfilerActivity.CPU, t.profiler.ProfilerActivity.CUDA]
        self._prof = t.profiler.profile(activities=acts)
        t.cuda.synchronize()
        self._prof.__enter__()
        self._win = self.span("window")
        self._win.__enter__()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self._win.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce_profile(self._prof, self.torch)
        return False


def reduce_profile(prof, torch_mod) -> Trace:
    """The device ops and the harness's host spans of a finished profile.
    A harness span also shows on the device's timeline (the span of the
    ops it launched): that copy is left out, it is no device op."""
    cuda = torch_mod.autograd.DeviceType.CUDA
    ops, spans = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench."):
            if e.device_type != cuda:
                spans.append((e.name, a, b))
        elif e.device_type == cuda:
            ops.append((e.name, a, b))
    wins = [(a, b) for n, a, b in spans if n == "portbench.window"]
    if not wins:
        raise BenchError("the profile holds no window span")
    if not ops:
        raise BenchError("the profile holds no device op: the profiler did not trace the card")
    return Trace(ops, spans, wins[0])


# ---------------------------------------------------------------------------
# a run's outcome and its result line
# ---------------------------------------------------------------------------

@dataclass
class Check:
    """One number compared with the reference, and its limit (a reading
    above the limit fails)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: the window's counts and end-to-end
    values, the observations the per-layer readers read, the checks."""
    attempted: int
    failed: int
    end_to_end: dict[str, float]
    obs: dict
    checks: list[Check]
    memory_peak_bytes: int
    trace: Trace | None = None
    notes: list[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


def result_line(cell: Cell, out: Outcome, traced: bool, device: dict) -> dict:
    """The contract's last line: end-to-end metrics in a plain run, the
    per-layer metrics that find something to read in a traced one, and
    the numbers compared, last."""
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = reader(m["name"]).read(out.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in out.end_to_end:
                raise BenchError(f"{cell.name} measured no {m['name']}")
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dict(device)}
    if traced and out.trace is not None:
        line["device"]["busy_s"] = out.trace.busy_s()
        line["device"]["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def log(msg: str) -> None:
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)
