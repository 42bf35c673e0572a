"""The port's compiler (repro_torch.compile) held against the reference's
on the same graphs: the five tiny challenge apps and the paper-size app
graphs (compiled only, never executed).

Pure-Python compiler state must agree EXACTLY: graph and structural
fingerprints, the sf-node selection, the pipelines, the balance allocations
(both under the A100 spec), the analytic estimates, the kernel lowering
plans and the dedupe keys -- the single-token attention cases
(`llama_tok`) included, which both packages lower to `flash_decode`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro
from benchmarks import apps as japps
from repro.core.costmodel import A100 as JA100

import repro_torch
from repro_torch import apps as tapps
from repro_torch.core.compiler import PASS_NAMES
from repro_torch.core.costmodel import A100, H100

ROOT = Path(__file__).resolve().parents[1]

TINY = {
    "dlrm": dict(fn="dlrm", kw=dict(batch=16, emb_rows=64)),
    "mgn": dict(fn="meshgraphnets", kw=dict(batch=16, steps=1)),
    "nerf": dict(fn="nerf", kw=dict(rays=4, samples=4)),
    "graphcast": dict(fn="graphcast", kw=dict(nodes=16, hidden=16, steps=1)),
    "llama": dict(fn="llama3_8b", kw=dict(seq=4, batch=2, n_layers=1, d=16,
                                          ff=32, hq=2, hkv=2, hd=8, vocab=32)),
    "llama_tok_tiny": dict(fn="llama3_8b",
                           kw=dict(seq=4, batch=2, n_layers=1, d=16, ff=32,
                                   hq=2, hkv=2, hd=8, vocab=32, decode=True)),
}


def graphs(case: str):
    """(reference graph, port graph) for a tiny case or a paper-size app."""
    if case.startswith("paper:"):
        name = case.split(":", 1)[1]
        return japps.APPS[name](), tapps.APPS[name]()
    spec = TINY[case]
    return (getattr(japps, spec["fn"])(**spec["kw"]),
            getattr(tapps, spec["fn"])(**spec["kw"]))


CASES = sorted(TINY) + [f"paper:{n}" for n in sorted(tapps.APPS)]


def compile_both(case: str, mode: str = "kitsune", **kw):
    jg, tg = graphs(case)
    japp = repro.compile(jg, repro.CompilerOptions(
        mode=mode, hw=JA100, lowering_policy=kw.pop("policy", "always"), **kw))
    tapp = repro_torch.compile(tg, repro_torch.CompilerOptions(
        mode=mode, hw=A100, lowering_policy=japp.options.lowering_policy, **kw))
    return japp, tapp


def plan_rows(app):
    out = {}
    for name, pl in sorted(app.lowering.pipelines.items()):
        matches = [(m.kernel, m.ops, m.out, tuple(sorted(m.meta.items())),
                    m.executable, m.accepted,
                    None if m.verdict is None else
                    (m.verdict.decision, m.verdict.source,
                     m.verdict.est_kernel_us, m.verdict.est_closure_us))
                   for m in pl.matches]
        out[name] = (matches, dict(pl.fallbacks))
    return out


@pytest.mark.parametrize("case", CASES)
def test_fingerprints_agree(case):
    jg, tg = graphs(case)
    assert repro.graph_fingerprint(jg) == repro_torch.graph_fingerprint(tg)
    assert (repro.structural_fingerprint(jg)
            == repro_torch.structural_fingerprint(tg))


@pytest.mark.parametrize("case", CASES)
def test_selection_and_pipelines_agree(case):
    japp, tapp = compile_both(case)
    assert ([(sf.name, list(sf.matched_patterns), list(sf.members))
             for sf in japp.selection.sf_nodes]
            == [(sf.name, list(sf.matched_patterns), list(sf.members))
                for sf in tapp.selection.sf_nodes])
    assert list(japp.pipelined.graph.nodes) == list(tapp.pipelined.graph.nodes)

    def pipes(app):
        return [(p.name,
                 [(s.name, s.resource, [o.name for o in s.ops])
                  for s in p.stages],
                 [(q.name, q.producer, list(q.consumers), q.payload_bytes,
                   q.depth) for q in p.queues])
                for p in app.pipelined.pipelines]

    assert pipes(japp) == pipes(tapp)
    assert ([(r.name, r.disabled) for r in japp.pass_records]
            == [(r.name, r.disabled) for r in tapp.pass_records])


@pytest.mark.parametrize("case", CASES)
def test_balance_and_estimates_agree_under_a100(case):
    japp, tapp = compile_both(case)
    def alloc(app):
        return {k: (v.allocation, v.throughput, v.binding)
                for k, v in app.balance_results.items()}

    assert alloc(japp) == alloc(tapp)
    for mode in ("bsp", "vertical", "kitsune"):
        je, te = japp.estimate(mode=mode), tapp.estimate(mode=mode)
        assert (je.time, je.dram_bytes, je.subgraph_times) == \
            (te.time, te.dram_bytes, te.subgraph_times)


@pytest.mark.parametrize("case", CASES)
def test_lowering_plans_agree(case):
    japp, tapp = compile_both(case)
    assert plan_rows(tapp) == plan_rows(japp)
    assert japp.dedupe.struct_keys == tapp.dedupe.struct_keys


@pytest.mark.parametrize("case", ["nerf", "llama", "paper:dlrm",
                                  "paper:llama_ctx", "paper:mgn"])
def test_cost_policy_verdicts_agree(case):
    japp, tapp = compile_both(case, policy="cost")
    assert plan_rows(japp) == plan_rows(tapp)
    assert japp.lowering_verdicts() and all(
        r["source"] == "cost" for r in tapp.lowering_verdicts())


@pytest.mark.parametrize("mode", ["bsp", "vertical"])
def test_non_kitsune_modes_skip_lowering_and_match_dedupe(mode):
    japp, tapp = compile_both("nerf", mode=mode)
    assert japp.lowering is None and tapp.lowering is None
    if mode == "bsp":
        assert japp.dedupe.struct_keys == tapp.dedupe.struct_keys
    else:
        assert japp.dedupe is None and tapp.dedupe is None


def test_port_defaults():
    opts = repro_torch.CompilerOptions()
    # "auto" is the default, as the reference's is
    assert opts.lowering_policy == "auto" and opts.resolved_hw() is H100
    assert (opts.lowering_policy
            == repro.CompilerOptions().lowering_policy)
    assert (H100.n_units, H100.matrix_flops, H100.vector_flops,
            H100.dram_bw, H100.onchip_capacity) == (132, 989e12, 67e12,
                                                    3.35e12, 50e6)
    for policy in ("always", "cost", "auto"):
        assert repro_torch.CompilerOptions(lowering_policy=policy).lowering_policy == policy
    with pytest.raises(ValueError, match="lowering_policy"):
        repro_torch.CompilerOptions(lowering_policy="sometimes")
    # a callable compiles through the capture front-end, given example inputs
    with pytest.raises(TypeError, match="example_inputs"):
        repro_torch.compile(lambda x: x)


def test_describe_names_the_execution_and_unported_parts():
    """describe() names how each mode executes and, under "auto", each
    verdict's tier and numbers; nothing of the lowering is left unported."""
    g = tapps.llama3_8b(**TINY["llama_tok_tiny"]["kw"])
    text = repro_torch.compile(g, mode="kitsune", lowering_policy="always").describe()
    assert "lowered flash_decode[skv=4]: attn_0 -> attn_0" in text
    assert "fallback attn_0" not in text
    assert "not ported" not in text
    app = repro_torch.compile(g, mode="kitsune")
    text = app.describe()
    assert "lowering policy auto" in text and "measured) in" in text
    (row,) = [r for r in app.lowering_verdicts() if r["kernel"] == "flash_decode"]
    word = "accepted" if row["decision"] == "lowered" else "declined"
    assert (f"lowered flash_decode[skv=4] [{word}: measured kernel "
            f"{row['meas_kernel_us']:.1f}us vs closure {row['meas_closure_us']:.1f}us]"
            in text)
    assert "not ported" not in text
    text = repro_torch.compile(g, mode="vertical").describe()
    assert "torch.compile'd on CUDA" in text


def test_pass_manager_order_and_disable():
    g = tapps.nerf(rays=4, samples=4)
    app = repro_torch.compile(g, disable=("lower_kernels",))
    assert app.lowering is None
    assert [r.name for r in app.pass_records] == list(PASS_NAMES)
    seen = []
    pm = repro_torch.PassManager(["select", "epilogue_fuse", "create_queues",
                                  "balance"])
    app = repro_torch.compile(g, pass_manager=pm,
                              dump_ir=lambda name, st: seen.append(name))
    assert seen == ["select", "epilogue_fuse", "create_queues", "balance"]
    assert app.lowering is None and app.pipelined.pipelines
    with pytest.raises(ValueError):
        repro_torch.PassManager(["nope"])


def test_port_imports_no_jax_and_no_reference():
    """repro_torch (serving, training and distributed modules included), and everything
    chip_smoke.py imports, loads without jax and without the reference
    package (checked in a fresh interpreter)."""
    code = (
        "import sys, runpy, json\n"
        "import repro_torch, repro_torch.apps, repro_torch.kernels\n"
        "import repro_torch.kernels._build, repro_torch.core.lower\n"
        "import repro_torch.serve, repro_torch.models, repro_torch.configs\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.train, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.runtime, repro_torch.tree\n"
        "import repro_torch.launch.train, repro_torch.models.encdec\n"
        "import repro_torch.distributed.sharding, repro_torch.distributed.pipeline\n"
        "import repro_torch.core.queue, repro_torch.optim.compression\n"
        "import repro_torch.launch.mesh\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
