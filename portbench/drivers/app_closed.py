"""A compiled app's forwards back to back (a closed loop of one caller):
the `nerf` configuration through `repro_torch.compile(graph,
CompilerOptions(mode="kitsune"))` under the default "auto" lowering, run
with `CompiledApp.run(feeds, params)` on `batches` batches of `points`
encoded points made on the card, in turn.

Set-up: the graph (`repro_torch.apps.nerf`, held to the configuration's
layer shapes), the weights and the batches from the seed, the compile
(its "auto" verdicts measured on the card), and three runs: the plan's
first run, its capture, its first replay.  The window runs forwards until
`seconds` have passed and ends in a synchronise; `infer_ms` is its length
over the forwards it ran.  No run in the window may build a program or
run uncaptured.  A reservoir sample (drawn from the seed) of the window's
forwards keeps its outputs; after the window they are held to the float32
reference on the same batch and weights (`out_err`: the largest |got -
ref| over the output's RMS, worst over the sample and both outputs).

With `--trace 1`, after the window, `trace_forwards` forwards each after a
synchronise time the host's enqueue of one `run` call alone (a host span
around it), and `trace_forwards` forwards back to back run under the
profiler.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench import bench, traffic
from portbench.reference import nerf as ref_nerf
from portbench.reference import strict_float32

B1_KERNEL = "fused_mlp"


def check_graph(graph, config: dict, points: int) -> None:
    """The program's NeRF graph has the configuration's layers and rows."""
    want = ref_nerf.layer_shapes(config)
    got = {n.name: (n.attrs["d_in"], n.attrs["d_out"]) for n in graph.topo()
           if n.kind == "linear"}
    if got != want:
        raise bench.BenchError(f"repro_torch.apps.nerf's layers {got} are not the "
                               f"configuration's {want}")
    for name in ("pts", "view"):
        rows = graph.nodes[name].out.shape[0]
        if rows != points:
            raise bench.BenchError(f"graph input {name} has {rows} rows, want {points}")


def make_weights(torch, config: dict, seed: int, device) -> dict:
    """{layer: {"w": (fan_in, fan_out)}}: normal * sqrt(2 / fan_in) in the
    configuration's dtype, drawn on `device` from the seed."""
    gen = torch.Generator(device=device).manual_seed((seed + 1) % (1 << 63))
    dtype = getattr(torch, config["dtype"])
    out = {}
    for name, (k, n) in ref_nerf.layer_shapes(config).items():
        w = torch.randn((k, n), generator=gen, device=device, dtype=dtype)
        out[name] = {"w": w.mul_(math.sqrt(2.0 / k))}
    return out


def b1_sites(app) -> list[dict]:
    """The fused-MLP sites the plan runs as B1: each accepted match's rows
    and its linears' (fan_in, fan_out), from the compiled graph."""
    g = app.pipelined.graph
    sites = []
    for pl in app.lowering.pipelines.values():
        for m in pl.matches:
            if m.kernel != B1_KERNEL or not (m.executable and m.accepted):
                continue
            lins = [g.nodes[o] for o in m.ops if g.nodes[o].kind == "linear"]
            rows = math.prod(lins[0].out.shape[:-1])
            sites.append({"rows": rows, "dims": [[n.attrs["d_in"], n.attrs["d_out"]]
                                                 for n in lins]})
    return sites


def out_err(got: dict, want: dict) -> float:
    """max |got - want| / RMS(want), worst over the outputs."""
    worst = 0.0
    for k, w in want.items():
        g = got[k].float()
        rms = w.square().mean().sqrt().clamp(min=1e-30)
        worst = max(worst, float((g - w).abs().max() / rms))
    return worst


def judge(torch, config, weights, batches, sample, precision="float32") -> float:
    """`out_err` of the sampled forwards against the reference in
    `precision` ("float32", or the control's "float8_e4m3fn" run in the
    program's place, judged against float32 in the same way)."""
    strict_float32()
    weights = {name: p["w"] for name, p in weights.items()}
    worst = 0.0
    for b, outputs in sample:
        feeds = batches[b]
        want = ref_nerf.forward_blocks(config, weights, feeds["pts"], feeds["view"])
        got = outputs if precision == "float32" else ref_nerf.forward_blocks(
            config, weights, feeds["pts"], feeds["view"], precision=precision)
        worst = max(worst, out_err(got, want))
    return worst


def run(cell, *, seed: int, seconds: float, traced: bool, device, process_start: float,
        control: bool = False, program=None) -> bench.Outcome:
    import torch
    import repro_torch
    from repro_torch import CompilerOptions, apps
    from repro_torch import kernels as K

    cfg, wl = cell.config, cell.workload
    tp = wl["traffic"]
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    graph = apps.nerf(rays=tp["rays"], samples=tp["samples"])
    check_graph(graph, cfg, tp["points"])
    weights = make_weights(torch, cfg, seed, device)
    batches = traffic.nerf_batches(torch, tp, cfg, seed, device)
    app = (program or repro_torch.compile)(graph, CompilerOptions(mode="kitsune"))
    for i in range(3):
        app.run(batches[i % len(batches)], weights)
    sync()
    builds0 = repro_torch.lowering_count()
    launches0 = K.launch_counts()[B1_KERNEL]
    rng = traffic.rng(seed, 7)
    k = wl["check_sample"]
    sample: list[tuple[int, dict]] = []
    setup_s = time.time() - process_start
    bench.log(f"{cell.name}: set-up {setup_s:.2f} s, window {seconds} s")

    n = uncaptured = 0
    rep = None
    t0 = time.perf_counter()
    while True:
        b = n % len(batches)
        rep = app.run(batches[b], weights)
        now = time.perf_counter()
        uncaptured += cuda and not rep.replayed
        if n < k:
            sample.append((b, rep.outputs))
        else:
            j = int(rng.integers(0, n + 1))
            if j < k:
                sample[j] = (b, rep.outputs)
        n += 1
        if now - t0 >= seconds:
            break
    sync()
    t1 = time.perf_counter()
    window_s = t1 - t0
    builds = repro_torch.lowering_count() - builds0
    launches = K.launch_counts()[B1_KERNEL] - launches0
    if builds or uncaptured:
        raise bench.BenchError(f"the window built {builds} programs and ran {uncaptured} "
                               f"forwards uncaptured")

    trace = None
    host_s = []
    if traced and cuda:
        for i in range(wl["trace_forwards"]):
            sync()
            h0 = time.perf_counter()
            app.run(batches[i % len(batches)], weights)
            host_s.append(time.perf_counter() - h0)
        with bench.Profiled(torch) as prof:
            for i in range(wl["trace_forwards"]):
                with prof.span("run"):
                    app.run(batches[i % len(batches)], weights)
        trace = prof.trace
        trace.units = {"forwards": wl["trace_forwards"]}
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    sites = b1_sites(app)
    boundary = rep.bytes_accessed
    del app, rep
    if cuda:
        torch.cuda.empty_cache()

    limit = wl["limits"]["out_err"]
    t_check = time.perf_counter()
    checks = [bench.Check("out_err", judge(torch, cfg, weights, batches, sample), limit)]
    took = time.perf_counter() - t_check
    if control:
        checks.append(bench.Check("out_err.control", judge(
            torch, cfg, weights, batches, sample, "float8_e4m3fn"), limit))
    obs = {"config": cfg, "points": tp["points"], "infer_ms": 1e3 * window_s / n,
           "peaks": bench.peaks(torch.cuda.get_device_name(device) if cuda else ""),
           "boundary_bytes": boundary, "host_ms": 1e3 * float(np.mean(host_s)) if host_s else None,
           "b1_sites": sites, "trace": trace}
    return bench.Outcome(
        attempted=n, failed=0,
        end_to_end={"infer_ms": 1e3 * window_s / n, "setup_s": setup_s},
        obs=obs, checks=checks, memory_peak_bytes=memory_peak, trace=trace,
        notes=[f"{cell.name}: {n} forwards in {window_s:.3f} s, B1 launches a forward "
               f"{launches / n:g}, sample {len(sample)} forwards, the check took {took:.2f} s"])
