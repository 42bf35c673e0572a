"""The port's `apps.synthesize_backward` held against the reference's
(`benchmarks/apps.py`) on the five challenge apps: the synthesized training
graphs node for node, their kitsune plans, and the mirrored assertions of
the reference's `tests/test_lowering.py` (plan-only `fused_mlp_bwd`
matches, `queue_reduce` on the split gradient reductions, the
"(plan-only)" tag) and `tests/test_costmodel_invariants.py` (the cost
model's estimates of the paper-size `_train` graphs).  The graphs carry no
weights and are never run.
"""
import pytest

import repro
from benchmarks import apps as japps
from repro.core.costmodel import A100 as JA100

import repro_torch
from repro_torch import apps as tapps
from repro_torch.core.costmodel import A100

TINY = {
    "dlrm": ("dlrm", dict(batch=16, emb_rows=64)),
    "mgn": ("meshgraphnets", dict(batch=16, steps=1)),
    "nerf": ("nerf", dict(rays=4, samples=4)),
    "graphcast": ("graphcast", dict(nodes=16, hidden=16, steps=1)),
    "llama": ("llama3_8b", dict(seq=4, batch=2, n_layers=1, d=16, ff=32, hq=2, hkv=2,
                                hd=8, vocab=32)),
}
# apps whose forward holds a linear -> act -> linear chain (Fig 2c)
CHAINS = ("dlrm", "mgn", "nerf", "graphcast")


def train_graphs(case: str):
    fn, kw = TINY[case]
    return (japps.synthesize_backward(getattr(japps, fn)(**kw)),
            tapps.synthesize_backward(getattr(tapps, fn)(**kw)))


def compile_both(jg, tg):
    japp = repro.compile(jg, repro.CompilerOptions(mode="kitsune", hw=JA100,
                                                   lowering_policy="always"))
    tapp = repro_torch.compile(tg, repro_torch.CompilerOptions(
        mode="kitsune", hw=A100, lowering_policy="always"))
    return japp, tapp


def nodes(g):
    return [(n.name, n.kind, list(n.inputs), tuple(n.out.shape), n.out.dtype, n.flops,
             n.weight_bytes, sorted(n.attrs.items())) for n in g.topo()]


def plan_rows(app):
    return {name: ([(m.kernel, m.ops, m.out, tuple(sorted(m.meta.items())), m.executable,
                     m.accepted) for m in pl.matches], dict(pl.fallbacks))
            for name, pl in sorted(app.lowering.pipelines.items())}


def bwd_matches(app):
    return [m for p in app.lowering.pipelines.values() for m in p.matches
            if m.kernel == "fused_mlp_bwd"]


@pytest.mark.parametrize("case", sorted(TINY))
def test_synthesized_graph_matches_reference(case):
    jg, tg = train_graphs(case)
    assert tg.name == jg.name == f"{jg.name[:-6]}_train"
    assert nodes(tg) == nodes(jg)
    assert repro_torch.graph_fingerprint(tg) == repro.graph_fingerprint(jg)


@pytest.mark.parametrize("case", sorted(TINY))
def test_kitsune_plan_matches_reference(case):
    japp, tapp = compile_both(*train_graphs(case))
    assert plan_rows(tapp) == plan_rows(japp)
    assert tapp.lowering.kernels_used() == japp.lowering.kernels_used()
    assert ("(plan-only)" in tapp.describe()) == ("(plan-only)" in japp.describe())


@pytest.mark.parametrize("case", CHAINS)
def test_backward_multicast_is_plan_only(case):
    """tests/test_lowering.py's `test_backward_graph_multicast_is_plan_only`
    and `test_describe_plan_only_tag`, on every app with a linear chain."""
    _, tapp = compile_both(*train_graphs(case))
    bwd = bwd_matches(tapp)
    assert bwd, "no dX/dW multicast matched in the synthesized backward"
    assert all(not m.executable for m in bwd)
    assert "queue_reduce" in tapp.lowering.kernels_used()
    assert "(plan-only)" in tapp.describe()


@pytest.mark.parametrize("name", ["dlrm", "mgn", "nerf", "graphcast", "llama_ctx"])
def test_paper_size_train_estimates_match_reference(name):
    """The cost model on the paper-size `_train` graphs (the port's side of
    tests/test_costmodel_invariants.py's GRAPHS), equal to the reference's
    in all three modes, and kitsune moving no more DRAM bytes than bsp."""
    japp, tapp = compile_both(japps.synthesize_backward(japps.APPS[name]()),
                              tapps.synthesize_backward(tapps.APPS[name]()))
    for mode in ("bsp", "vertical", "kitsune"):
        je, te = japp.estimate(mode=mode), tapp.estimate(mode=mode)
        assert (te.time, te.dram_bytes, te.subgraph_times) == \
            (je.time, je.dram_bytes, je.subgraph_times), mode
    assert tapp.estimate(mode="kitsune").dram_bytes <= \
        tapp.estimate(mode="bsp").dram_bytes * (1 + 1e-9)
