"""Shared pieces of the harness's own tests: the repository on the path,
tiny CPU versions of the cells (the kernels' plain versions run), and a
card fixture for the tests marked `gpu`."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import bench  # noqa: E402

# phi3-medium's layout at widths a CPU test can hold, in float32
TINY_LM = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
           "vocab_size": 256, "torch_dtype": "float32"}
TINY_TRAFFIC = {
    "phi3.chat": {"rate_per_s": 40.0,
                  "prompt": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4,
                             "max": 16},
                  "output": {"dist": "uniform", "min": 2, "max": 6}},
    "phi3.multiturn": {"users": 4, "system_prompt": 12, "window_turns": 4,
                       "message": {"dist": "uniform", "min": 2, "max": 5},
                       "output": {"dist": "uniform", "min": 2, "max": 4},
                       "turns": {"dist": "geometric", "mean": 2.0, "max": 3}},
    "nerf.render": {"rays": 16, "samples": 8, "points": 128, "batches": 3},
    "nerf.netchunk": {"rays": 8, "samples": 8, "points": 64, "batches": 2},
}
# float32 program against the float32 reference: a sound run reads ~0
TINY_LIMITS = {"logit_gap": 1e-3, "logit_err": 1e-3, "out_err": 1e-3}


def tiny_cell(name: str) -> bench.Cell:
    cell = bench.find_cell(name)
    wl = dict(cell.workload, traffic=TINY_TRAFFIC[name], check_sample=2, check_requests=8,
              check_users=4, drain_s=30,
              limits={k: TINY_LIMITS[k] for k in cell.workload["limits"]})
    if "serve" in wl:
        wl["serve"] = dict(wl["serve"], batch=4, max_len=160, block_size=4, num_blocks=256)
        cell.config = dict(cell.config, **TINY_LM)
    else:
        cell.config = dict(cell.config, dtype="float32")
    cell.workload = wl
    return cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size")
    return torch.device("cuda", 0)
