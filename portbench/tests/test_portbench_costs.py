"""The op and byte functions of the rooflines and of the step shares, held
to counts worked out by hand at the cells' shapes."""
from __future__ import annotations

import pytest

from portbench import bench
from portbench.reference import nerf

H100 = bench.peaks("NVIDIA H100 80GB HBM3")
NERF = bench.load_json(bench.HERE / "configs" / "nerf.json")
PHI3 = bench.load_json(bench.HERE / "configs" / "phi3-medium-14b.json")


def test_nerf_forward_flops():
    # 60*256 + 4*256*256 + 316*256 + 2*256*256 + 256 + 256*256 + 280*128 + 128*3
    per_point = 15360 + 262144 + 80896 + 131072 + 256 + 65536 + 35840 + 384
    assert nerf.flops(NERF, 524288) == 2 * 524288 * per_point == pytest.approx(6.2023e11,
                                                                               rel=1e-4)


def test_b1_site_counts():
    b1 = bench.reader("b1_roofline.infer")
    ops, nbytes = b1.ops_bytes(524288, [[256, 256], [256, 256]])
    assert ops == 2 * 524288 * 256 * 256 * 2
    assert nbytes == 2 * (524288 * 256 + 2 * 256 * 256 + 524288 * 256)
    # bound by bytes: 5.37e8 / 3.35e12 = 0.160 ms > 1.374e11 / 989e12 = 0.139 ms
    assert b1.bound_s([{"rows": 524288, "dims": [[256, 256], [256, 256]]}], H100) == \
        pytest.approx(nbytes / 3.35e12) == pytest.approx(1.6034e-4, rel=1e-3)


def test_b2_decode_counts():
    b2 = bench.reader("b2_roofline.serve")
    ops, nbytes = b2.ops_bytes(32, 5120, 17920)
    assert ops == 2 * 32 * 3 * 5120 * 17920
    assert nbytes == 2 * (3 * 5120 * 17920 + 2 * 32 * 5120)
    # 550.5 MB of weights at 3.35 TB/s: 0.1644 ms, bound by bytes
    assert b2.bound_s(32, 5120, 17920, H100) == pytest.approx(nbytes / 3.35e12)
    assert b2.bound_s(32, 5120, 17920, H100) == pytest.approx(1.6437e-4, rel=1e-3)


def test_b8_decode_counts():
    b8 = bench.reader("b8_roofline.serve")
    ops, nbytes = b8.ops_bytes([100, 1, 300], 40, 10, 128)
    assert ops == 4 * 401 * 40 * 128
    assert nbytes == 2 * (2 * 401 * 10 * 128 + 2 * 3 * 40 * 128)


def test_serve_step_flops():
    mfu = bench.reader("mfu.serve")
    d, f, v = 5120, 17920, 32064
    per_layer = d * 5120 + 2 * d * 1280 + 5120 * d + 3 * d * f
    want = 2 * 2 * (40 * per_layer + d * v) + 4 * 40 * 40 * 128 * (50 + 70)
    assert mfu.step_flops(PHI3, 2, [1, 50, 1, 70]) == want
    # 13.96 B parameters: ~2 x 13.9e9 operations a token for the linears
    assert mfu.step_flops(PHI3, 1, [1]) == pytest.approx(2 * 13.96e9 - 2 * d * v, rel=1e-3)
