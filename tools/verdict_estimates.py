#!/usr/bin/env python3
"""The estimate tier of the "auto" lowering policy for the full-width
challenge apps, worked out from the cost model alone (no device, no
tensors: the compiler passes run on the operator graphs).

    PYTHONPATH=src python3 tools/verdict_estimates.py [--hw H100|A100]

For every executable kernel match of chip_smoke.py's phases 4-6 graphs
(Llama3-8B with hkv = hq, nerf, dlrm, mgn, graphcast at their published
sizes, the split-reduction graph) prints the roofline estimates of the
kernel and of the op-by-op closure in microseconds, their ratio, and the
tier "auto" gives it on the card: "cost: lowered" / "cost: declined" when
the estimates differ by ESTIMATE_BAND or more, "cost (over the caps)"
when they tie inside the band but the site exceeds MEASURE_CAP_BYTES /
MEASURE_CAP_FLOPS, else "measured" (the microbenchmark decides).
"""
import argparse

from repro_torch import Graph, apps
from repro_torch.core import lower as L
from repro_torch.core.costmodel import A100, H100, cost_kernel_site, cost_vertical
from repro_torch.core.compiler import CompilerOptions, compile as compile_graph


def split_reduction() -> Graph:
    """chip_smoke.py phase 6's graph: x (2048, 1024, 256) bf16 -> x*x ->
    sum over axis 0."""
    g = Graph("split_reduction")
    g.input("x", (2048, 1024, 256), "bfloat16")
    g.elementwise("sq", ["x", "x"], "mul")
    g.reduce("batch_sum", "sq", axis=0)
    g.output("y", "batch_sum")
    return g


def graphs() -> dict[str, Graph]:
    out = {"llama3_8b": apps.llama3_8b(hkv=32)}
    out.update({name: apps.APPS[name]() for name in ("nerf", "dlrm", "mgn", "graphcast")})
    out["split_reduction"] = split_reduction()
    return out


def tier(g, km, est_k: float, est_c: float) -> str:
    if est_k * L.ESTIMATE_BAND <= est_c:
        return "cost: lowered"
    if est_c * L.ESTIMATE_BAND <= est_k:
        return "cost: declined"
    if not L._measurable(g, km):
        return "cost (over the caps): " + ("lowered" if est_k <= est_c else "declined")
    return "measured"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", choices=("H100", "A100"), default="H100")
    hw = {"H100": H100, "A100": A100}[ap.parse_args().hw]
    print(f"estimates on {hw.name} (band {L.ESTIMATE_BAND}, caps "
          f"{L.MEASURE_CAP_BYTES >> 20} MiB / {L.MEASURE_CAP_FLOPS:.0e} flops)")
    print("app | pipeline | kernel | est kernel us | est closure us | closure/kernel | tier")
    for name, graph in graphs().items():
        app = compile_graph(graph, CompilerOptions(mode="kitsune", lowering_policy="always",
                                                   hw=hw))
        g = app.pipelined.graph
        for pipe, pl in sorted(app.lowering.pipelines.items()):
            for km in pl.matches:
                if not km.executable:
                    continue
                est_k = cost_kernel_site(g, list(km.ops), hw).time * 1e6
                est_c = cost_vertical(g, list(km.ops), hw).time * 1e6
                print(f"{name} | {pipe} | {km.label()} | {est_k:.2f} | {est_c:.2f} | "
                      f"{est_c / est_k:.3f} | {tier(g, km, est_k, est_c)}")


if __name__ == "__main__":
    main()
