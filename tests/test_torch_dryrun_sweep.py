"""The ten configs `.reduced()` through a train, a prefill and a decode step
(64 tokens, batch 32) on a fake 16 x 16 ("data", "model") group
(`launch/dryrun.reduced_sweep`): 30 sharded forms, each traced and counted
on rank 0's local shards.  A 16-wide axis splits heads, vocabularies and
sequences that the gloo tests' meshes (at most 4 wide) leave whole: the
sweep that found the 16-wide faults ROADMAP C lists.  chip_smoke phase 14d
runs the same sweep on the card's torch release."""
import pytest

from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun as D


@pytest.fixture(scope="module")
def sweep():
    return {(r["arch"], r["kind"]): r for r in D.reduced_sweep()}


def test_sweep_covers_thirty_forms(sweep):
    assert len(ARCHS) == 10 and D.SWEEP_MESH == (16, 16)
    assert sorted(sweep) == sorted((a, k) for a in ARCHS for k in D.SWEEP_KINDS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_form_counts_on_sixteen_wide_axes(sweep, arch):
    for kind in D.SWEEP_KINDS:
        r = sweep[arch, kind]
        assert r["status"] == "ok", (arch, kind, r["status"])
        # rank 0 does work, and a 16-wide mesh moves data between ranks
        assert r["flops"] > 0 and r["collectives"] > 0, (arch, kind)
    # a train step does more than a prefill of the same tokens
    assert sweep[arch, "train"]["flops"] > sweep[arch, "prefill"]["flops"]
