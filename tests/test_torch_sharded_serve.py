"""Sharded serving through the capture front-end, every rank a gloo process
on the CPU (the harness of `test_torch_distributed.py`), on a (2, 2)
("data", "model") mesh of four ranks:

  * the legacy and paged engines under the sharder with `compile_mode`
    bsp, vertical and kitsune: each tick traced over the rank's local
    shards, DTensor's collectives nodes of the graph.  Each is held to the
    NULL eager engine on the same prompts: tokens equal, every tick's
    logits within 2e-4 (f32);
  * the paged engine's gather path under the sharder (its view and
    scatter on each rank's local pool shards): tokens and every tick's
    logits bitwise the native path's under the same sharder, eager and
    compiled (kitsune);
  * the traced ticks' graphs: at least one collective node, no sf-node
    (nor pipeline stage) holding one, none bucketed by dedupe, one program
    each in every mode (vertical cut at each), run in graph order, and
    counted by the plan;
  * the reference's sharded compiled legacy tick on four forced host
    devices, (2, 2) too, on reduced gemma3-1b: the port's legacy engine
    under the sharder with compile_mode="kitsune", on the reference's
    weights, gives its tokens and every tick's logits within 2e-4;
  * on one process, a hand-built chain with collective nodes: the same
    rules in all three modes, and each collective costed on the NVLink
    queue level (core/queue.py), not as vector work.

Reduced gemma3-1b and phi3-medium-14b, the same weights on every rank.
One launch of four ranks per config runs every engine, and a third the
port beside the reference (the three launches side by side); the tests
read their results.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import ROOT, _rank_main, run_ranks  # noqa: E402

TOL = 2e-4
ARCHS = ["gemma3-1b", "phi3-medium-14b"]
MODES = ["bsp", "vertical", "kitsune"]
PROMPTS = [[3, 5, 7], [11, 2], [9, 9, 4, 1]]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _legacy(cfg, params, sc, **kw):
    """(done, [each tick's logits]) of the legacy engine on PROMPTS."""
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, sc, **kw)
    step, logits = eng._step, []

    def recorded(*args):
        out = step(*args)
        logits.append(out["logits"].float().clone())
        return out
    eng._step = recorded
    for i, p in enumerate(PROMPTS):
        eng.submit(i, p)
    return eng.run_until_done(60), logits, step


def _paged(cfg, params, sc, **kw):
    """(done, [each tick's logits], engine) of the paged engine on PROMPTS."""
    from repro_torch.serve.engine import PagedServingEngine
    eng = PagedServingEngine(cfg, params, sc, **kw)
    for p in PROMPTS:
        eng.submit(p)
    logits = []
    for _ in range(60):
        left = eng.tick()
        if eng.failed:
            raise next(iter(eng.failed.values()))
        logits.append(eng.last_logits.float().clone())
        if left == 0:
            break
    return eng.done, logits, eng


def _graph_facts(app) -> dict:
    """What the tests assert of one compiled tick's TracedApp."""
    g = app.graph
    coll = [n.name for n in g.topo() if n.kind == "collective"]
    members = {m for sf in app.selection.sf_nodes for m in sf.members}
    members |= {o.name for p in app.pipelined.pipelines for s in p.stages for o in s.ops}
    keys = app.dedupe.struct_keys if app.dedupe is not None else {}
    progs = app._engine.programs
    run = [p.node.name for p in progs if p.node is not None and p.node.kind == "collective"]
    plans = list(app._engine._plans.values())
    return {"collectives": coll, "prims": sorted({g.nodes[c].attrs["collective"] for c in coll}),
            "in_sf": sorted(members & set(coll)), "deduped": sorted(set(keys) & set(coll)),
            "run_order": run, "n_programs": len(progs),
            "plan_collectives": [p.n_collectives for p in plans],
            "group_ranks": sorted({g.nodes[c].attrs.get("group_ranks") for c in coll
                                   if "group_ranks" in g.nodes[c].attrs})}


def case_serve(rank, world, arch):
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.serve.engine import ServeConfig
    sharder = Sharder(make_mesh((2, 2), ("data", "model"), "cpu"))
    cfg = get_config(arch).reduced()
    params = get_model(cfg).init(0, "cpu")
    leg = ServeConfig(max_len=16, batch=2, lowering_policy="always")
    pag = ServeConfig(max_len=16, batch=2, num_blocks=8, max_new_tokens=6,
                      lowering_policy="always")
    out = {}
    out["legacy", "null"] = _legacy(cfg, params, leg)[:2]
    out["paged", "null"] = _paged(cfg, params, pag)[:2]
    out["paged", "native"] = _paged(cfg, params, pag, sharder=sharder)[:2]
    out["paged", "gather"] = _paged(cfg, params, replace(pag, paged_attention="gather"),
                                    sharder=sharder)[:2]
    for mode in MODES:
        sc = replace(leg, compile_mode=mode)
        done, logits, step = _legacy(cfg, params, sc, sharder=sharder)
        out["legacy", mode] = (done, logits)
        out["graph", "legacy", mode] = _graph_facts(step.app)
        sc = replace(pag, compile_mode=mode)
        done, logits, eng = _paged(cfg, params, sc, sharder=sharder)
        out["paged", mode] = (done, logits)
        out["graph", "paged", mode] = [_graph_facts(fn.app) for fn in eng._steps.values()]
    sc = replace(pag, compile_mode="kitsune", paged_attention="gather")
    out["paged", "gather_kitsune"] = _paged(cfg, params, sc, sharder=sharder)[:2]
    return out


def case_ref(rank, world, ref):
    """The legacy engine under a (2, 2) sharder, compile_mode="kitsune", on
    the reference's weights (`ref`, written by REF_SCRIPT)."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import params_from_numpy
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ServeConfig
    with open(ref, "rb") as f:
        params = params_from_numpy(pickle.load(f)["params"], "cpu")
    sharder = Sharder(make_mesh((2, 2), ("data", "model"), "cpu"))
    sc = ServeConfig(max_len=16, batch=2, compile_mode="kitsune", lowering_policy="always")
    return _legacy(get_config(REF_ARCH).reduced(), params, sc, sharder=sharder)[:2]


CASES = {"serve": case_serve, "ref": case_ref}

# The reference's legacy engine with compile_mode="kitsune" under a (2, 2)
# Sharder on four forced host devices, its compiled tick recording each
# tick's logits.  That tick is lowered for replicated inputs and refuses
# the mesh-sharded cache it returns itself (a ValueError on the second tick
# on JAX 0.9), so each tick's state is put back on the mesh replicated
# first, which changes no value.
REF_ARCH = "gemma3-1b"
REF_SCRIPT = """
import pickle, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed.sharding import Sharder
from repro.launch.mesh import _axis_types_kw
from repro.models import get_model
from repro.serve.engine import ServeConfig, ServingEngine
arch, prompts, out = sys.argv[1], eval(sys.argv[2]), sys.argv[3]
cfg = get_config(arch).reduced()
params = get_model(cfg).init(jax.random.PRNGKey(0))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
                         **_axis_types_kw(2))
eng = ServingEngine(cfg, params, ServeConfig(max_len=16, batch=2, compile_mode="kitsune"),
                    sharder=Sharder(mesh))
step, logits, rep = eng._step, [], NamedSharding(mesh, P())
def recorded(p, state):
    out = step(p, jax.device_put(state, rep))
    logits.append(np.asarray(out["logits"], np.float32))
    return out
eng._step = recorded
for i, p in enumerate(prompts):
    eng.submit(i, p)
done = eng.run_until_done(60)
with open(out, "wb") as f:
    pickle.dump({"params": jax.tree.map(np.asarray, params), "done": done,
                 "logits": logits}, f)
"""


def _reference_then_port(tmp):
    """The reference's run (REF_SCRIPT in a subprocess), then the port's
    four ranks on its weights: (reference result, rank results)."""
    ref = tmp / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT), REF_ARCH,
                        repr(PROMPTS), str(ref)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(ref, "rb") as f:
        want = pickle.load(f)
    return want, run_ranks("ref", 4, tmp, script=__file__, timeout=300, ref=str(ref))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each config's four rank results (a future), and under "reference"
    the reference's run and the port's ranks beside it; the three launches
    side by side."""
    with ThreadPoolExecutor(len(ARCHS) + 1) as pool:
        out = {arch: pool.submit(run_ranks, "serve", 4, tmp_path_factory.mktemp(arch),
                                 script=__file__, timeout=300, arch=arch)
               for arch in ARCHS}
        out["reference"] = pool.submit(_reference_then_port,
                                       tmp_path_factory.mktemp("reference"))
        return out


def _close_logits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ["legacy", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_sharded_engine_matches_null_eager(served, arch, engine, mode):
    for res in served[arch].result():
        done, logits = res[engine, mode]
        want_done, want_logits = res[engine, "null"]
        assert done == want_done and len(done) == len(PROMPTS)
        _close_logits(logits, want_logits)


def test_compiled_sharded_legacy_matches_reference(served):
    """The port's compiled legacy tick under the sharder against the
    reference's sharded compiled tick on the same weights and prompts."""
    want, ranks = served["reference"].result()
    assert len(want["done"]) == len(PROMPTS)
    for done, logits in ranks:
        assert done == want["done"]
        _close_logits(logits, [torch.from_numpy(w) for w in want["logits"]])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gather_bitwise_native(served, arch):
    """Eager and compiled: the gather path's view and scatter on local pool
    shards give the native path's tokens and logits bit for bit, and both
    the NULL engine's tokens."""
    for res in served[arch].result():
        done, logits = res["paged", "gather"]
        ndone, nlogits = res["paged", "native"]
        assert done == ndone == res["paged", "null"][0]
        assert len(logits) == len(nlogits)
        assert all(torch.equal(a, b) for a, b in zip(logits, nlogits))
        kdone, klogits = res["paged", "gather_kitsune"]
        assert kdone == done
        _close_logits(klogits, logits)
        kn_done, kn_logits = res["paged", "kitsune"]
        assert all(torch.equal(a, b) for a, b in zip(klogits, kn_logits))


@pytest.mark.parametrize("engine", ["legacy", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_traced_tick_holds_collectives_as_nodes(served, arch, engine):
    for res in served[arch].result():
        for mode in MODES:
            facts = res["graph", engine, mode]
            for f in (facts if isinstance(facts, list) else [facts]):
                assert f["collectives"], (mode, "no collective node")
                assert f["in_sf"] == [] and f["deduped"] == []
                # one program each, in graph order, counted by the plan
                assert f["run_order"] == f["collectives"]
                assert f["plan_collectives"] and all(
                    n == len(f["collectives"]) for n in f["plan_collectives"])
                # the mesh's groups: pairs of ranks of a (2, 2) mesh
                assert f["group_ranks"] and all(len(r) == 2 for r in f["group_ranks"])
                if mode == "vertical":
                    assert f["n_programs"] > len(f["collectives"])


# ---------------------------------------------------------------------------
# the collective node kind on one process
# ---------------------------------------------------------------------------

def _chain_with_collectives():
    """x -> a -> all_reduce -> wait -> b -> all_reduce -> wait -> c -> y, f32
    (8, 64), each of a, b, c two silus; each collective's eval the
    identity, as at world size 1."""
    from repro_torch.core.graph import Graph, Node, TensorSpec
    from repro_torch.core.queue import collective_kind, wire_bytes
    g = Graph("coll")
    g.input("x", (8, 64), "float32")
    prev = "x"
    spec = TensorSpec((8, 64), "float32")
    for i, name in enumerate(("a", "b", "c")):
        g.elementwise(name + "1", [prev], "silu")
        g.elementwise(name, [name + "1"], "silu")
        prev = name
        if name == "c":
            break
        for op in ("all_reduce", "wait_tensor"):
            kind = collective_kind(op)
            node = g.add(Node(f"{op}{i}", "collective", [prev], spec, 0.0, 0.0,
                              {"collective": op, "group_ranks": (0, 1),
                               "wire_bytes": wire_bytes(kind, spec.nbytes, 2) if kind else 0.0,
                               "_eval": lambda t: t.clone()}))
            prev = node.name
    g.output("y", prev)
    return g


def test_collective_nodes_stay_out_of_sf_nodes_and_dedupe():
    from repro_torch.core import select_subgraphs
    from repro_torch.core.pipeline import dedupe_programs
    g = _chain_with_collectives()
    coll = {n.name for n in g.topo() if n.kind == "collective"}
    sel = select_subgraphs(g)
    assert len(sel.sf_nodes) == 3 and not (sel.covered & coll)
    keys = dedupe_programs(g, {sf.name: sf.members for sf in sel.sf_nodes}).struct_keys
    assert not (set(keys) & coll)


@pytest.mark.parametrize("mode", MODES)
def test_collectives_run_as_programs_of_their_own_in_graph_order(mode):
    import repro_torch
    g = _chain_with_collectives()
    app = repro_torch.compile(g, mode=mode)
    order = [p.node.name for p in app._engine.programs
             if p.node is not None and p.node.kind == "collective"]
    assert order == ["all_reduce0", "wait_tensor0", "all_reduce1", "wait_tensor1"]
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    rep = app.run({"x": x})
    assert rep.n_collectives == 4
    want = x
    for _ in range(6):
        want = torch.nn.functional.silu(want)
    torch.testing.assert_close(rep.outputs["y"], want, rtol=TOL, atol=TOL)
    if mode == "vertical":
        # cut at each collective: a, the four collectives, b, c + y
        assert len(app._engine.programs) == 7


def test_collective_costed_on_the_nvlink_queue():
    """On the ring model the dry run counts with (core/queue.py
    `wire_bytes`, the reference's), through the NVLink queue level."""
    from repro_torch.core.costmodel import H100, op_time_bsp
    from repro_torch.core.queue import NVLINK_QUEUE, queue_bandwidth, wire_bytes
    from repro_torch.launch.dryrun import CollectiveRecord, collective_bytes
    g = _chain_with_collectives()
    ar, wait, ew = g.nodes["all_reduce0"], g.nodes["wait_tensor0"], g.nodes["b1"]
    wire = 2 * 8 * 64 * 4 * (2 - 1) / 2
    assert ar.attrs["wire_bytes"] == wire == wire_bytes("all-reduce", 2048, 2)
    assert op_time_bsp(g, ar, H100) == max(wire / queue_bandwidth(NVLINK_QUEUE, wire),
                                           H100.launch_s)
    assert wait.attrs["wire_bytes"] == 0 and op_time_bsp(g, wait, H100) == H100.launch_s
    assert wire_bytes("all-gather", 4096, 4) == 3072
    assert wire_bytes("reduce-scatter", 1024, 4) == 3072
    assert wire_bytes("collective-permute", 4096, 4) == 4096
    assert wire_bytes("all-reduce", 4096, 1) == 0
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "collective-permute"):
        assert collective_bytes([CollectiveRecord(kind, 4096, 4)])[kind] == \
            wire_bytes(kind, 4096, 4)
    assert ar.flops == 0 and ew.flops > 0


if __name__ == "__main__":
    _rank_main(CASES)
