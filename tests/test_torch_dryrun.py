"""The port's dry run (`repro_torch.launch.dryrun`, `inputs`, `report`)
against the reference's `repro.launch.dryrun` and against real ranks:

  * the ring model on the reference's three HLO lines, `_cal_period` for
    all ten configs, and every (arch x shape) cell's stand-ins -- parameter
    tree, batch or decode state -- with the reference's keys, shapes and
    dtypes (the reference's side in one subprocess: importing its dry run
    forces 512 host devices);
  * the extrapolation from depths P and 2P equal to the full-depth count;
  * counts on local shards: a matmul on a fake (16, 16) mesh counts one
    rank's product, a reduced gemma3 train step on (8, 1) exactly 1/8 of
    the (1, 1) step's FLOPs, and the (1, 1) dry run the FLOPs of a real
    step on plain tensors;
  * each kernel op's FLOP formula against `FlopCounterMode` on its plain
    version (kernels/ref.py);
  * the reference test's small-mesh cell on a fake (2, 4) mesh, its row
    holding every key of the reference's schema;
  * the collectives of the dry run on a fake (2, 2) mesh equal, kind by
    kind, CommDebugMode's in a real 4-rank gloo run of the same step, and
    and in the same 4 ranks the sharded step's local microbatches (a batch
    split the count does not divide) equal to the NULL step's contiguous
    ones, and reduced hymba's and xlstm's sharded steps equal to their
    NULL steps;
  * a full-width llama4-maverick cell cut to 2 layers on (16, 16) without
    allocating; `report.main` on rows of both kinds.

Fake process groups live inside `dryrun.fake_world`, which destroys the
group on exit, so no other test in this worker inherits one.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import ENV, ROOT, _rank_main, run_ranks  # noqa: E402

from repro_torch.configs import ARCHS, applicable_shapes, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, InputShape  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import inputs as I  # noqa: E402
from repro_torch.launch import report as R  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

REF_SCRIPT = """
import json, sys
import jax
from repro.launch.dryrun import _cal_period, collective_bytes
from repro.launch.inputs import input_specs, params_specs
from repro.configs import ARCHS, applicable_shapes, get_config
from repro.models import get_model

hlo = '''
%ar = f32[64,512]{1,0} all-reduce(%dot), replica_groups=[2,4]<=[8]
%ag = bf16[128,128]{1,0} all-gather(%x), replica_groups=[1,8]<=[8]
%cp = f32[16]{0} collective-permute(%y), source_target_pairs={{0,1}}
'''

def tree(t):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            [list(v.shape), str(v.dtype)]
            for kp, v in jax.tree_util.tree_flatten_with_path(t)[0]}

res = {"ring": collective_bytes(hlo), "period": {}, "specs": {}}
for name in ARCHS:
    cfg = get_config(name)
    res["period"][name] = _cal_period(cfg)
    specs = {"params": tree(params_specs(cfg, get_model(cfg)))}
    for s in applicable_shapes(cfg):
        specs[s] = tree(input_specs(cfg, s))
    res["specs"][name] = specs
json.dump(res, open(sys.argv[1], "w"))
"""

REF_SCHEMA = {
    "top": {"arch", "shape", "mesh", "chips", "status", "compile_s", "memory", "cost",
            "collectives", "roofline"},
    "memory": {"argument_GiB", "output_GiB", "temp_GiB", "alias_GiB",
               "total_GiB_per_chip", "fits_80GB"},
    "cost": {"flops_per_chip", "bytes_per_chip"},
    "collectives": {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute", "count", "total"},
    "roofline": {"compute_s", "memory_s", "collective_s", "dominant", "bound_s",
                 "model_flops_per_chip", "useful_flops_ratio", "roofline_fraction"},
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _tree(t) -> dict:
    return {path: [list(v.shape), _dtype(v)] for path, v in flatten(t)}


def small_gemma(n_layers: int = 2, window_pattern: str = "LG"):
    """The reference test's small-mesh config (tests/test_dryrun_utils.py)."""
    return dataclasses.replace(get_config("gemma3-1b"), n_layers=n_layers,
                               window_pattern=window_pattern, vocab=2048, d_ff=512,
                               d_model=256, n_heads=4, n_kv_heads=1, head_dim=64)


TRAIN = InputShape("mini_train", 128, 8, "train")


# ---------------------------------------------------------------------------
# against the reference's functions
# ---------------------------------------------------------------------------

def test_ring_model_matches_reference(ref):
    """AR f32[64,512] over 4, AG bf16[128,128] over 8, a permute of
    f32[16]: the reference's HLO lines as the port's records."""
    recs = [D.CollectiveRecord("all-reduce", 64 * 512 * 4, 4),
            D.CollectiveRecord("all-gather", 128 * 128 * 2, 8),
            D.CollectiveRecord("collective-permute", 16 * 4, 0)]
    got = D.collective_bytes(recs)
    assert set(got) == set(ref["ring"])
    for k, v in ref["ring"].items():
        assert got[k] == v, k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cal_period_matches_reference(arch, ref):
    assert D._cal_period(get_config(arch)) == ref["period"][arch]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stand_ins_match_reference(arch, ref):
    """Every applicable cell's stand-ins: the reference's keys, shapes and
    dtypes, and every leaf a meta tensor (no storage)."""
    cfg = get_config(arch)
    want = ref["specs"][arch]
    params = I.params_specs(cfg, get_model(cfg))
    assert _tree(params) == {k: v for k, v in want["params"].items()}
    leaves = [t for _, t in flatten(params)]
    for shape in applicable_shapes(cfg):
        specs = I.input_specs(cfg, shape)
        assert _tree(specs) == want[shape], shape
        leaves += [t for _, t in flatten(specs)]
    assert all(t.is_meta for t in leaves)
    assert sorted(want) == sorted(["params"] + applicable_shapes(cfg))


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------

def _count(cfg, shape, mesh_shape, axes=("data", "model"), device_type="cuda", **kw):
    with D.fake_world(int(torch.tensor(mesh_shape).prod())):
        mesh = make_mesh(mesh_shape, axes, device_type)
        return D.count_step(cfg, shape, mesh, opt_kind="adamw", **kw)


@pytest.mark.parametrize("arch,pattern", [("gemma3-1b", "LG"), ("xlstm-350m", None)])
def test_extrapolation_equals_full_depth(arch, pattern):
    """cal(P) + (L/P - 1)(cal(2P) - cal(P)) == the count at depth L = 3P:
    the port's layer loops are Python loops, counted in full."""
    base = get_config(arch).reduced()
    if pattern:
        base = dataclasses.replace(base, window_pattern=pattern)
    period = D._cal_period(base)
    shape = InputShape("t", 32, 2, "train")
    flops = {k: _count(dataclasses.replace(base, n_layers=k * period), shape, (1, 1)).flops
             for k in (1, 2, 3)}
    assert flops[1] < flops[2] < flops[3]
    assert D.extrapolate(flops[1], flops[2], 3 * period, period) == flops[3]


def test_matmul_counts_the_local_shards():
    """X (4096, 8192) [S(0), R] @ W (8192, 8192) [R, S(0)] on a fake (16, 16)
    mesh: one rank multiplies (256, 512) by (512, 8192) -- 2 * 256 * 512 *
    8192 FLOPs, not the global product -- and leaves a Partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    with D.fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), "cuda")
        x = distribute_tensor(torch.empty(4096, 8192, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(8192, 8192, device="meta"), mesh,
                              [Replicate(), Shard(0)], src_data_rank=None)
        with D.CostCounter(device="meta") as c:
            y = x @ w
        assert c.flops == 2 * 256 * 512 * 8192
        assert tuple(y.placements) == (Shard(0), Partial())
        assert tuple(y.to_local().shape) == (256, 8192)
        assert c.records == []


def test_data_parallel_eighth_and_real_step_equal():
    """A reduced gemma3 train step on a fake (8, 1) mesh counts exactly 1/8
    of the (1, 1) step's FLOPs; the (1, 1) count equals the same counter's
    around a real step on plain CPU tensors (no sharder)."""
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step
    cfg, shape = get_config("gemma3-1b").reduced(), InputShape("t", 32, 8, "train")
    tc = TrainConfig(remat=True)
    one = _count(cfg, shape, (1, 1), tc=tc)
    eight = _count(cfg, shape, (8, 1), tc=tc)
    assert one.records == [] and eight.records
    assert eight.flops * 8 == one.flops
    opt = adamw(1e-3)
    params = get_model(cfg).init(0, "cpu")
    state = {"params": params, "opt": opt.init(params)}
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 32), dtype=torch.int32)}
    with D.CostCounter() as real:
        make_train_step(cfg, opt, tc)(state, batch)
    assert real.flops == one.flops
    assert real.records == []


KERNEL_CASES = {
    "fused_mlp_fwd": lambda r: ((r(32, 16), r(16, 64), r(64, 8), "gelu"),
                                "mlp_ref", (r(32, 16), r(16, 64), r(64, 8), "gelu")),
    "fused_mlp_swiglu_fwd": lambda r: ((r(32, 16), r(16, 64), r(16, 64), r(64, 16), "silu"),
                                       "mlp_swiglu_ref",
                                       (r(32, 16), r(16, 64), r(16, 64), r(64, 16), "silu")),
    "fused_mlp_bwd": lambda r: ((r(32, 16), r(16, 64), r(64, 16), r(32, 16), "gelu"),
                                "mlp_bwd_ref",
                                (r(32, 16), r(16, 64), r(64, 16), r(32, 16), "gelu")),
    "fused_mlp_swiglu_bwd": lambda r: (
        (r(32, 16), r(16, 64), r(16, 64), r(64, 16), r(32, 16), "silu"),
        "mlp_swiglu_bwd_ref", (r(32, 16), r(16, 64), r(16, 64), r(64, 16), r(32, 16), "silu")),
    "flash_attention": lambda r: ((r(2, 4, 16, 8), r(2, 2, 16, 8), r(2, 2, 16, 8), True, None),
                                  "attention_ref", (r(2, 4, 16, 8), r(2, 2, 16, 8),
                                                    r(2, 2, 16, 8))),
    "flash_decode": lambda r: ((r(2, 4, 1, 8), r(2, 2, 32, 8), r(2, 2, 32, 8), None, 32),
                               "decode_ref", (r(2, 4, 1, 8), r(2, 2, 32, 8), r(2, 2, 32, 8))),
}


@pytest.mark.parametrize("op", sorted(KERNEL_CASES) + ["paged_flash_decode", "queue_reduce"])
def test_kernel_flop_formula(op):
    """Each kernel op's registered formula against FlopCounterMode on its
    plain version (B6 / B7 with their hidden-tile recompute: 5 and 8
    GEMMs); B5 is N * R * C, where the plain `torch.sum` counts none."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    kop = getattr(torch.ops.repro_torch, op)
    if op == "paged_flash_decode":
        q, kp, vp = r(2, 4, 1, 8), r(32, 2, 8), r(32, 2, 8)
        tables = torch.arange(8).reshape(2, 4)
        valid = torch.tensor([16, 16])
        kargs, plain = (q, kp, vp, tables, valid, None, 4, None), \
            (lambda: ref.paged_decode_ref(q, kp, vp, tables, valid_len=valid, block_size=4))
    elif op == "queue_reduce":
        x = r(6, 8, 16)
        kargs, plain = (x, "sum"), (lambda: ref.reduce_ref(x, "sum"))
    else:
        kargs, name, pargs = KERNEL_CASES[op](r)
        plain = (lambda: getattr(ref, name)(*pargs))
    with FlopCounterMode(display=False) as kc:
        kop(*kargs)
    with FlopCounterMode(display=False) as pc:
        plain()
    if op == "queue_reduce":
        assert kc.get_total_flops() == 6 * 8 * 16 and pc.get_total_flops() == 0
    else:
        assert kc.get_total_flops() == pc.get_total_flops() > 0
    with D.CostCounter() as cc:
        kop(*kargs)
    assert cc.flops == kc.get_total_flops()


def test_kernel_op_without_formula_raises():
    from torch.utils.flop_counter import flop_registry
    packet = torch.ops.repro_torch.queue_reduce
    formula = flop_registry.pop(packet)
    try:
        with pytest.raises(NotImplementedError, match="no FLOP formula"):
            with D.CostCounter():
                packet(torch.ones(2, 3, 4), "sum")
    finally:
        flop_registry[packet] = formula


def test_small_mesh_cell_end_to_end():
    """tests/test_dryrun_utils.py's reduced gemma3 (2 layers, "LG") on a
    fake (2, 4) mesh: FLOPs, bytes and temp bytes > 0, collectives counted,
    and the row holds every key of the reference's schema, plus the torch
    release that counted it."""
    c = _count(small_gemma(), TRAIN, (2, 4))
    assert c.flops > 0 and c.bytes > 0 and c.temp_bytes > 0 and c.records
    row = D.row(small_gemma(), TRAIN, "2x4", 8, c)
    assert set(row) == REF_SCHEMA["top"] | {"torch"}
    assert row["torch"] == torch.__version__
    for k in ("memory", "cost", "collectives", "roofline"):
        assert set(row[k]) == REF_SCHEMA[k], k
    assert row["collectives"]["count"] == len(c.records)
    rf = row["roofline"]
    assert rf["bound_s"] == max(rf["compute_s"], rf["memory_s"], rf["collective_s"]) > 0
    assert row["memory"]["fits_80GB"]


# ---------------------------------------------------------------------------
# the dry run against real ranks
# ---------------------------------------------------------------------------

def _kind(name: str) -> str:
    for key, kind in (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all")):
        if key in name:
            return kind
    raise KeyError(name)


def case_comm_counts(rank, world):
    """One reduced-gemma3 train step on a real (2, 2) gloo mesh under
    CommDebugMode: its collectives by kind."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step
    cfg = small_gemma()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    sharder = Sharder(mesh)
    opt = adamw(1e-3)
    params = sharder.distribute(get_model(cfg).init(0, "cpu"))
    state = {"params": params, "opt": opt.init(params)}
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN.global_batch, TRAIN.seq_len),
                                     generator=g, dtype=torch.int32)}
    step = make_train_step(cfg, opt, TrainConfig(remat=True), sharder=sharder)
    with CommDebugMode() as comm:
        step(state, batch)
    out = {}
    for op, n in comm.get_comm_counts().items():
        kind = _kind(str(op))
        out[kind] = out.get(kind, 0) + n
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """CASES' 4-rank cases, run once in one gloo group: each rank's results."""
    return run_ranks("four_ranks", 4, tmp_path_factory.mktemp("ranks"), script=__file__,
                     timeout=300)


def test_collectives_match_real_gloo_ranks(four_ranks):
    """The dry run's collectives by kind on a fake (2, 2) mesh (a host mesh,
    as gloo's) equal CommDebugMode's on every rank of a real 4-rank run."""
    from repro_torch.train import TrainConfig
    got = _count(small_gemma(), TRAIN, (2, 2), device_type="cpu",
                 tc=TrainConfig(remat=True))
    counts = {k: v for k, v in D.CostCounter.counts_by_kind(got.records).items() if v}
    real = [r["comm_counts"] for r in four_ranks]
    assert counts and all(r == counts for r in real), (counts, real)


def case_local_microbatches(rank, world):
    """A reduced gemma3 step with 3 microbatches on a (4, 1) gloo mesh,
    where the batch's 4 shards do not divide the count (each microbatch
    is then every rank's local slice), against the NULL step's contiguous
    microbatches on the whole batch: loss and parameters."""
    from repro_torch.distributed.sharding import Sharder, full_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step
    cfg = get_config("gemma3-1b").reduced()
    opt, tc = adamw(1e-3), TrainConfig(remat=True, microbatches=3)
    params = get_model(cfg).init(0, "cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (12, 16), generator=g, dtype=torch.int32)}
    want, wm = make_train_step(cfg, opt, tc)({"params": params, "opt": opt.init(params)}, batch)
    sharder = Sharder(make_mesh((4, 1), ("data", "model"), "cpu"))
    dp = sharder.distribute(params)
    got, gm = make_train_step(cfg, opt, tc, sharder=sharder)({"params": dp, "opt": opt.init(dp)},
                                                             batch)
    return {"loss": (float(gm["loss"]), float(wm["loss"])),
            "diff": max(float((full_tensor(a) - b).abs().max())
                        for (_, a), (_, b) in zip(flatten(got["params"]),
                                                  flatten(want["params"])))}


def test_local_microbatches_match_contiguous_ones(four_ranks):
    for r in (r["local_microbatches"] for r in four_ranks):
        got, want = r["loss"]
        assert abs(got - want) <= 2e-4 * max(1.0, abs(want)), r
        assert r["diff"] <= 2e-4, r


def case_recurrent_steps(rank, world):
    """One train step of reduced hymba and xlstm on a real (2, 2) gloo mesh
    against the NULL step from the same weights: the recurrences on local
    shards (`layers.over_time`), the xLSTM's head splits, log-sigmoid and
    cumsum, at 16-wide-safe forms."""
    from repro_torch.distributed.sharding import Sharder, full_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step
    sharder = Sharder(make_mesh((2, 2), ("data", "model"), "cpu"))
    out = {}
    for arch in ("hymba-1.5b", "xlstm-350m"):
        cfg = get_config(arch).reduced()
        opt, tc = adamw(1e-3), TrainConfig(remat=True)
        params = get_model(cfg).init(0, "cpu")
        g = torch.Generator().manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=g, dtype=torch.int32)}
        want, wm = make_train_step(cfg, opt, tc)({"params": params, "opt": opt.init(params)},
                                                 batch)
        dp = sharder.distribute(params)
        got, gm = make_train_step(cfg, opt, tc, sharder=sharder)(
            {"params": dp, "opt": opt.init(dp)}, batch)
        out[arch] = (float(gm["loss"]), float(wm["loss"]),
                     max(float((full_tensor(a) - b).abs().max())
                         for (_, a), (_, b) in zip(flatten(got["params"]),
                                                   flatten(want["params"]))))
    return out


def test_recurrent_families_sharded_step_matches_null(four_ranks):
    for r in four_ranks:
        for arch, (got, want, diff) in r["recurrent_steps"].items():
            assert abs(got - want) <= 2e-4 * max(1.0, abs(want)), (arch, got, want)
            assert diff <= 2e-4, (arch, diff)


# ---------------------------------------------------------------------------
# no allocation; the report
# ---------------------------------------------------------------------------

def test_full_width_cell_allocates_nothing():
    """llama4-maverick at full width cut to 2 layers (35 GB of bf16
    weights), its decode_32k cell on a fake (16, 16) mesh: process RSS
    grows by under 2 GB."""
    import resource
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"), n_layers=2)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    c = _count(cfg, SHAPES["decode_32k"], (16, 16))
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) * 1024
    assert c.argument_bytes > 2 ** 30 and c.flops > 0
    assert grown < 2e9, grown


def test_report_renders_rows(tmp_path):
    ok = {"arch": "gemma3-1b", "shape": "train_4k", "mesh": "16x16", "chips": 256,
          "status": "ok", "compile_s": 1.0,
          "memory": {"argument_GiB": 1.0, "output_GiB": 1.0, "temp_GiB": 2.0,
                     "alias_GiB": 0.0, "total_GiB_per_chip": 4.0, "fits_80GB": True},
          "cost": {"flops_per_chip": 1e12, "bytes_per_chip": 1e11},
          "collectives": {"all-gather": 1e9, "all-reduce": 0.0, "reduce-scatter": 0.0,
                          "all-to-all": 0.0, "collective-permute": 0.0, "count": 3,
                          "total": 1e9},
          "roofline": {"compute_s": 1e-3, "memory_s": 3e-2, "collective_s": 2e-3,
                       "dominant": "memory", "bound_s": 3e-2, "model_flops_per_chip": 5e11,
                       "useful_flops_ratio": 0.5, "roofline_fraction": 0.017}}
    dec = dict(ok, shape="decode_32k", mesh="2x16x16", chips=512,
               roofline=dict(ok["roofline"], dominant="collective", collective_s=0.5))
    fail = {"arch": "grok-1-314b", "shape": "train_4k", "mesh": "16x16",
            "status": "FAIL: RuntimeError: boom"}
    for i, row in enumerate((ok, dec, fail)):
        (tmp_path / f"r{i}.json").write_text(json.dumps(row))
    buf = io.StringIO()
    R.main(["--dir", str(tmp_path)], out=buf)
    text = buf.getvalue()
    assert "cells traced OK: **2** (single-pod 1, multi-pod 1); failed: 1" in text
    assert "FAIL grok-1-314b x train_4k (16x16): FAIL: RuntimeError: boom" in text
    assert "| arch | shape | mesh | memory/card (GiB) | fits 80GB |" in text
    assert "| gemma3-1b | train_4k | 1.0ms | 30.0ms | 2.0ms | **memory** |" in text
    assert "Dominant-term distribution (single-pod): {'memory': 1}" in text
    assert "Worst roofline fractions: gemma3-1bxtrain_4k=0.017" in text
    assert "Most collective-bound: gemma3-1bxtrain_4k=2.0ms" in text
    for word in ("VMEM", "Pallas", "MXU", "TPU"):
        assert word not in text


def test_report_prints_each_rows_torch_release(tmp_path):
    """Beside each row, both tables name the torch release that counted it
    (a row written before the field existed says "not recorded")."""
    base = {"arch": "gemma3-1b", "shape": "train_4k", "mesh": "16x16", "chips": 256,
            "status": "ok", "compile_s": 1.0,
            "memory": {"total_GiB_per_chip": 4.0, "fits_80GB": True},
            "collectives": {"count": 3, "total": 1e9},
            "roofline": {"compute_s": 1e-3, "memory_s": 3e-2, "collective_s": 2e-3,
                         "dominant": "memory", "useful_flops_ratio": 0.5,
                         "roofline_fraction": 0.017}}
    rows = (dict(base, torch="2.11.0+cu128"), dict(base, arch="phi3-medium-14b"))
    for i, row in enumerate(rows):
        (tmp_path / f"r{i}.json").write_text(json.dumps(row))
    buf = io.StringIO()
    R.main(["--dir", str(tmp_path)], out=buf)
    lines = buf.getvalue().splitlines()
    assert "| arch | shape | mesh | memory/card (GiB) | fits 80GB | colls/step " \
           "| coll GiB/card | trace s | torch |" in lines
    mine = [ln for ln in lines if ln.startswith("| gemma3-1b |")]
    old = [ln for ln in lines if ln.startswith("| phi3-medium-14b |")]
    assert len(mine) == len(old) == 2
    assert all(ln.endswith("| 2.11.0+cu128 |") for ln in mine)
    assert all(ln.endswith("| not recorded |") for ln in old)


def test_dry_run_imports_no_jax_and_no_process_group():
    """The dry-run family loads without jax or the reference package and
    sets nothing up at import: no process group, no XLA flags (a fresh
    interpreter)."""
    code = textwrap.dedent("""
        import json, os, sys
        import torch.distributed as dist
        import repro_torch.launch.dryrun, repro_torch.launch.inputs, repro_torch.launch.report
        bad = sorted(m for m in sys.modules if m in ("jax", "repro")
                     or m.startswith(("jax.", "jaxlib", "repro.")))
        print(json.dumps([bad, dist.is_initialized(), "XLA_FLAGS" in os.environ]))
    """)
    env = {k: v for k, v in ENV.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False, False]


def case_four_ranks(rank, world):
    return {"comm_counts": case_comm_counts(rank, world),
            "local_microbatches": case_local_microbatches(rank, world),
            "recurrent_steps": case_recurrent_steps(rank, world)}


CASES = {"four_ranks": case_four_ranks}

if __name__ == "__main__":
    _rank_main(CASES)
