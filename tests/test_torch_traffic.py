"""`repro_torch.core.compare_traffic` (Table 2's "Traffic Red.") held
against the reference's `repro.core.compare_traffic` on the five tiny
challenge apps (`apps.tiny_instances`), the same graph shapes, feeds and
weights (the reference's `init_params` carried over through numpy, as
`tests/test_torch_executor.py` does):

  * the same keys;
  * the same program counts in bsp and in kitsune mode;
  * a positive traffic reduction wherever the reference's is positive.

The bytes themselves are not compared across the packages: the
reference's are XLA's `bytes accessed` of each compiled program, the
port's the sum of the tensors crossing each program's boundary, from their
shapes.  Within the port the reduction is held to its own byte counts.
"""
import os
import sys

import numpy as np
import pytest
import torch

import repro.core as jcore

import repro_torch
from repro_torch import apps as tapps
from repro_torch.core import compare_traffic, executor
from repro_torch.core.executor import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_executor import (TINY_KW, jax_feeds, reference_graph,  # noqa: E402
                                 reference_params)

KEYS = {"bsp_bytes", "kitsune_bytes", "traffic_reduction", "bsp_programs",
        "kitsune_programs"}


@pytest.fixture(scope="module")
def both():
    """{app: (the reference's dict, the port's dict)}."""
    out = {}
    for name, (tg, feeds) in tapps.tiny_instances("cpu", seed=1).items():
        jg = reference_graph(name)
        jparams = reference_params(jg)
        want = jcore.compare_traffic(jg, jax_feeds(feeds), jparams)
        got = compare_traffic(tg, feeds, params_from_numpy(jparams, "cpu"))
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", sorted(TINY_KW))
def test_keys_and_program_counts_match_reference(both, name):
    want, got = both[name]
    assert set(got) == set(want) == KEYS
    assert got["bsp_programs"] == want["bsp_programs"]
    assert got["kitsune_programs"] == want["kitsune_programs"]


@pytest.mark.parametrize("name", sorted(TINY_KW))
def test_reduction_positive_where_reference_is(both, name):
    want, got = both[name]
    if want["traffic_reduction"] > 0:
        assert got["traffic_reduction"] > 0
    if got["kitsune_programs"] < got["bsp_programs"]:
        assert got["traffic_reduction"] > 0


@pytest.mark.parametrize("name", sorted(TINY_KW))
def test_reduction_is_the_byte_ratio(both, name):
    _, got = both[name]
    assert got["bsp_bytes"] > 0 and got["kitsune_bytes"] > 0
    np.testing.assert_allclose(got["traffic_reduction"],
                               1.0 - got["kitsune_bytes"] / got["bsp_bytes"], rtol=1e-12)


def test_outputs_that_disagree_are_refused(monkeypatch):
    """compare_traffic holds the two modes' outputs to each other: a graph
    whose kitsune program computes something else fails it."""
    g = repro_torch.Graph("pair")
    g.input("x", (8, 16), "float32")
    g.linear("l1", "x", 32)
    g.elementwise("a", ["l1"], "relu")
    g.linear("l2", "a", 16)
    g.output("y", "l2")
    params = repro_torch.init_params(g, 0, device="cpu")
    feeds = {"x": torch.ones(8, 16)}
    assert compare_traffic(g, feeds, params)["kitsune_programs"] == 1
    real = executor._sf_program

    def wrong(*args, **kw):
        prog = real(*args, **kw)
        fn = prog.fn
        prog.fn = lambda feed, p: {k: v + 1.0 for k, v in fn(feed, p).items()}
        return prog
    monkeypatch.setattr(executor, "_sf_program", wrong)
    executor.clear_executable_cache()
    try:
        with pytest.raises(AssertionError):
            compare_traffic(g, feeds, params)
    finally:
        executor.clear_executable_cache()
