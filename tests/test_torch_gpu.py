"""The port on the card: every CUDA kernel against its plain version, and
the kitsune mode of the tiny challenge apps against bsp with the lowered
sites' launches counted.  All tests carry the `gpu` marker and skip where
no CUDA device is present; this file imports neither jax nor the reference
package, so it also runs where only PyTorch is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-4, bfloat16 2e-2 (tests/test_kernels.py:25); whole
apps 2e-3 in float32 (tests/test_lowering.py:32), with weights divided by
sqrt(fan-in) so that every output's RMS stays well above that tolerance.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import apps
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.fused_mlp import (fused_mlp_fwd_plain,
                                           fused_mlp_swiglu_fwd_plain)
from repro_torch.kernels.queue_reduce import queue_reduce_plain

pytestmark = pytest.mark.gpu
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tensors(cuda, seed, dtype, *shapes, fan_in=False):
    """Seeded numpy draws as CUDA tensors of `dtype`; with fan_in, every
    tensor after the first is scaled by 1/sqrt(rows) so values stay O(1)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        a = rng.standard_normal(shape).astype(np.float32)
        if fan_in and i > 0:
            a /= np.sqrt(shape[0])
        out.append(torch.from_numpy(a).to(cuda, DTYPES[dtype]))
    return out


def close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,d,h,o,act", [(100, 60, 300, 50, "relu"),
                                         (130, 64, 2000, 96, "gelu"),
                                         (256, 128, 1024, 128, "silu")])
def test_fused_mlp_kernels(cuda, m, d, h, o, act, dtype):
    x, w1, wu, w2 = tensors(cuda, 1, dtype, (m, d), (d, h), (d, h), (h, o),
                            fan_in=True)
    before = K.launch_counts()
    close(K.fused_mlp_fwd(x, w1, w2, act=act),
          fused_mlp_fwd_plain(x, w1, w2, act), TOL[dtype])
    close(K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act=act),
          fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, act), TOL[dtype])
    after = K.launch_counts()
    assert after["fused_mlp"] == before["fused_mlp"] + 1
    assert after["fused_mlp_swiglu"] == before["fused_mlp_swiglu"] + 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 8, 2, 200, 200, 64, True),
                                   (2, 4, 4, 256, 256, 128, False),
                                   (1, 2, 1, 70, 130, 8, False)])
def test_flash_attention_kernel(cuda, shape, dtype):
    b, hq, hkv, sq, skv, d, causal = shape
    q, k, v = tensors(cuda, 2, dtype, (b, hq, sq, d), (b, hkv, skv, d),
                      (b, hkv, skv, d))
    close(K.flash_attention(q, k, v, causal=causal),
          flash_attention_plain(q, k, v, causal=causal), TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_queue_reduce_kernel(cuda, op, dtype):
    (x,) = tensors(cuda, 3, dtype, (16, 33, 70))
    close(K.queue_reduce(x, op=op), queue_reduce_plain(x, op), TOL[dtype])
    close(K.queue_reduce(x, op=op, out_dtype=torch.float32),
          queue_reduce_plain(x, op, torch.float32), TOL[dtype])


@pytest.mark.parametrize("name", ["dlrm", "mgn", "nerf", "graphcast", "llama"])
def test_kitsune_on_card_launches_kernels(cuda, name):
    graph, feeds = apps.tiny_instances(cuda, seed=6)[name]
    params = repro_torch.init_params(graph, 0, device=cuda, scale=1.0)
    for leaves in params.values():
        if "w" in leaves:
            leaves["w"] /= leaves["w"].shape[0] ** 0.5
    want = repro_torch.compile(graph, mode="bsp").run(feeds, params).outputs
    app = repro_torch.compile(graph, mode="kitsune")
    before = K.launch_counts()
    got = app.run(feeds, params).outputs
    after = K.launch_counts()
    for k in want:
        assert want[k].float().square().mean().sqrt() >= 2e-2, k
        close(got[k], want[k], 2e-3)
    for m in (m for pl in app.lowering.pipelines.values() for m in pl.matches
              if m.executable):
        assert after[m.kernel] > before[m.kernel], m.kernel
