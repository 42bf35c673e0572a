"""The references against cases worked out by hand, and against the
program's own plain path on the CPU in float32 (the program is imported
here, by the test, never by the references)."""
from __future__ import annotations

import math

import pytest
import torch

from portbench import bench, serving
from portbench.reference import lowp, nerf as ref_nerf, phi3 as ref_phi3

from .conftest import TINY_LM

PHI3 = dict(bench.load_json(bench.HERE / "configs" / "phi3-medium-14b.json"), **TINY_LM)
NERF = bench.load_json(bench.HERE / "configs" / "nerf.json")


def test_nerf_by_hand():
    cfg = dict(NERF, pos_width=1, view_width=1, width=1, depth=2, skip_after=1,
               feature_width=1, view_hidden=1, rgb_out=1)
    w = {k: torch.full(s, 2.0) for k, s in ref_nerf.layer_shapes(cfg).items()}
    out = ref_nerf.forward(cfg, w, torch.tensor([[1.0], [-1.0]]), torch.tensor([[3.0], [3.0]]))
    # p=1: h=relu(2)=2; cat[2,1] -> relu(2*2+2*1)=6; sigma=12; feat=12;
    # rgb_fc=relu(2*12+2*3)=30; rgb=60.  p=-1: h=0; cat[0,-1] -> relu(-2)=0
    assert out["out_sigma"].flatten().tolist() == [12.0, 0.0]
    assert out["out_rgb"].flatten().tolist() == [60.0, 12.0]


def test_nerf_matches_program_plain_path():
    import repro_torch
    from repro_torch import apps
    g = apps.nerf(rays=4, samples=8)
    params = repro_torch.init_params(g, seed=3, dtype=torch.float32, device="cpu", scale=0.2)
    gen = torch.Generator().manual_seed(0)
    feeds = {"pts": torch.randn(32, 60, generator=gen), "view": torch.randn(32, 24, generator=gen)}
    got = repro_torch.compile(g, mode="bsp").run(feeds, params).outputs
    want = ref_nerf.forward(NERF, {k: v["w"] for k, v in params.items()}, feeds["pts"],
                            feeds["view"])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_phi3_by_hand():
    """With zero projections every layer passes x through: the logits are
    the final norm of the scaled embedding times the output head."""
    torch.manual_seed(0)
    params = serving.make_weights(torch, PHI3, 1, "cpu")
    for t in (*params["blocks"]["sub0"]["attn"].values(), *params["blocks"]["sub0"]["mlp"].values()):
        t.zero_()
    seq = [5, 9, 200]
    lg = ref_phi3.logits_at(PHI3, params, [seq], [1])[0]
    x = params["embed"][torch.tensor(seq[:-1])] * math.sqrt(64)
    x = x / torch.sqrt(x.square().mean(-1, keepdim=True) + PHI3["departures"]["rms_norm_eps"])
    torch.testing.assert_close(lg, x @ params["unembed"].t())


def test_phi3_matches_program_forward():
    from repro_torch.models import lm
    params = serving.make_weights(torch, PHI3, 7, "cpu")
    arch = serving.arch_config(PHI3)
    seq = torch.randint(0, 256, (1, 11), generator=torch.Generator().manual_seed(1))
    want = lm.forward(params, seq, arch)[0]
    got = ref_phi3.logits_at(PHI3, params, [seq[0].tolist()], [1])[0]
    torch.testing.assert_close(got, want[:-1], rtol=1e-4, atol=1e-4)


def test_widest_gap():
    ref = [torch.tensor([[1.0, 3.0, 2.0], [0.0, 0.5, 4.0]])]
    assert ref_phi3.widest_gap(ref, [[7, 2, 1]], [1]) == pytest.approx(3.5)
    assert ref_phi3.widest_gap(ref, [[7, 1, 2]], [1]) == 0.0
    picks = [torch.tensor([2, 0])]
    assert ref_phi3.widest_gap(ref, [[7, 1, 2]], [1], picks) == pytest.approx(4.0)


def test_e4m3_rounding():
    x = torch.tensor([[1.0, 448.0, 0.3]])
    q = lowp.to_e4m3(x, -1)
    assert q[0, 1] == 448.0 and q[0, 0] == 1.0
    assert abs(float(q[0, 2]) - 0.3) <= 0.3 * 2 ** -3
