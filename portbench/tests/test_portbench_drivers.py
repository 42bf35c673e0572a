"""Each driver end to end on the CPU at a tiny size (the kernels' plain
versions, float32): one contract line, `correct` true; and with the timed
path broken underneath, `correct` false, once for each fault a cell can
have.  The harness's look for a card (run.py) is skipped: the tests call
the driver as run.py does."""
from __future__ import annotations

import functools
import json
import time

import pytest
import torch

from portbench import bench, serving

from .conftest import tiny_cell

CPU = torch.device("cpu")
CELLS = ["nerf.render", "nerf.netchunk", "phi3.chat", "phi3.multiturn"]


def drive(cell, seed=2**31 + 17, seconds=0.6, **kw):
    drv = bench.driver(cell.workload["driver"])
    out = drv.run(cell, seed=seed, seconds=seconds, traced=False, device=CPU,
                  process_start=time.time(), **kw)
    line = bench.result_line(cell, out, False, {"platform": "cpu", "count": 1,
                                                "memory_peak_bytes": 0})
    return out, line


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_prints_one_line(name):
    cell = tiny_cell(name)
    out, line = drive(cell)
    assert json.loads(json.dumps(line)) == line
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    traced = bench.result_line(cell, out, True, {"platform": "cpu"})
    names = {m["name"] for m in cell.per_layer}
    assert set(traced["metrics"]) <= names


def test_same_seed_same_sample():
    cell = tiny_cell("nerf.render")
    a, _ = drive(cell, seed=5)
    b, _ = drive(cell, seed=5)
    assert a.checks[0].value == b.checks[0].value


# -- faults ------------------------------------------------------------------

class BrokenApp:
    """A compiled app whose outputs are broken where they are produced."""

    def __init__(self, app, fault):
        self.app, self.fault = app, fault

    def run(self, feeds, params):
        rep = self.app.run(feeds, params)
        out = {k: v.clone() for k, v in rep.outputs.items()}
        rgb = out["out_rgb"]
        if self.fault == "answer":
            rgb[3, 1] += 1.0
        elif self.fault == "half":
            rgb[rgb.shape[0] // 2:] = rgb[: rgb.shape[0] // 2].mean(0)
        rep.outputs = out
        return rep

    def __getattr__(self, name):
        return getattr(self.app, name)


@pytest.mark.parametrize("fault", ["answer", "half"])
def test_app_faults_fail(fault):
    import repro_torch

    def program(graph, options):
        return BrokenApp(repro_torch.compile(graph, options), fault)
    out, line = drive(tiny_cell("nerf.render"), program=program)
    assert line["correct"] is False


def broken_engine(fault):
    """The program's engine with its tick broken underneath."""
    def make(arch, params, wl):
        eng = serving.make_engine(arch, params, wl)
        get_step = eng._get_step
        ticks = [0]

        def patched(n_steps, v_blocks):
            step = get_step(n_steps, v_blocks)

            def tick(state):
                if fault == "state":
                    kept = (eng.kp.clone(), eng.vp.clone())
                out = step(state)
                toks = out["tokens_next"].clone()
                ticks[0] += 1
                if fault == "token" and ticks[0] % 3 == 0:
                    toks = (toks + 1) % arch.vocab
                elif fault == "half":
                    toks[toks.shape[0] // 2:] = 0
                elif fault == "state":
                    eng.kp.copy_(kept[0])
                    eng.vp.copy_(kept[1])
                elif fault == "logits":          # the logits drift, the tokens do not
                    out = {**out, "logits": out["logits"] * 1.05}
                return {**out, "tokens_next": toks}
            return tick
        eng._get_step = functools.lru_cache(None)(patched)
        return eng
    return make


@pytest.mark.parametrize("name", ["phi3.chat", "phi3.multiturn"])
@pytest.mark.parametrize("fault", ["token", "half", "state", "logits"])
def test_serving_faults_fail(name, fault):
    out, line = drive(tiny_cell(name), seconds=1.0, program=broken_engine(fault))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", ["phi3.chat", "phi3.multiturn"])
def test_watched_logits_cover_every_fed_position(name, monkeypatch):
    """The check holds the program's own logits at every position each
    watched request fed (from its first uncached position to the one
    before its last token) against the reference's."""
    seen = []
    judge = serving.judge

    def spy(torch_mod, cfg, params, picked, control=False):
        seen.extend(picked)
        return judge(torch_mod, cfg, params, picked, control)
    monkeypatch.setattr(serving, "judge", spy)
    out, line = drive(tiny_cell(name), seconds=1.0)
    assert seen and line["correct"] is True
    for s in seen:
        pos = sorted(s.logits)
        assert pos == list(range(pos[0], len(s.req.prompt) + s.n - 1))
        assert pos[0] <= len(s.req.prompt) - 1
    assert line["checks"]["logit_err"]["value"] < 1e-4
    if name == "phi3.multiturn":         # later turns start past their cached prefix
        assert any(min(s.logits) > 0 for s in seen)
