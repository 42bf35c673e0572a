"""Multi-pod dry run: trace every (arch x shape) cell's sharded step on the
production meshes with nothing allocated, and count per rank its memory,
FLOPs, bytes and collectives and the three roofline terms -- the
counterpart of `repro/launch/dryrun.py` over `torch.distributed`.

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads the compiled artifact.  Here a cell is one eager step:

  * the ranks are a fake process group (`fake_world`: the fake backend of
    `torch.testing._internal.distributed.fake_pg`, this process rank 0 of
    256 or 512), the mesh `launch/mesh.make_production_mesh` over it;
  * every tensor is a fake tensor (`FakeTensorMode`; launch/inputs.py):
    parameters, optimizer state, batch and cache have shapes and no
    storage; the `Sharder` (distributed/sharding.py) lays them out as
    DTensors, and the step runs through DTensor dispatch exactly as on the
    card, kernel ops through their fake and DTensor rules;
  * `CostCounter`, a dispatch mode that lets DTensor desugar each op first,
    sees the ops one rank runs on its local shards and counts their FLOPs
    (`torch.utils.flop_counter` formulas, the eight kernel ops' own
    registered in kernels/ops.py), their bytes (each op's inputs read once
    and outputs written once: an unfused count, in which a kernel op moves
    only its operands and results), every collective with its bytes and
    group size, and the peak of the live local storage.

The fake group sends nothing, so the dry run measures no time: each row
holds counts, and the roofline terms are those counts over the H100's
data-sheet rates (core/costmodel.py).  Importing this module sets nothing
up; `fake_world` makes and destroys the group.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, applicable_shapes, get_config
from ..configs.base import SHAPES, ArchConfig, InputShape
from ..core.costmodel import H100_HBM_BYTES, PEAK_FLOPS_PER_CHIP, roofline
from ..core.executor import executable_cache
from ..core.queue import COLLECTIVE_KINDS, collective_group, collective_kind, wire_bytes
from ..distributed.sharding import NamedSharding, Sharder, cache_placement, place
from ..models import get_model
from ..models.lm import _sub_kinds
from ..optim import adafactor, adamw
from ..optim.optimizers import OptState
from ..serve.engine import serve_step
from ..train import TrainConfig, make_train_step
from ..tree import tree_map
from .inputs import DEVICE, decode_inputs, params_specs, train_inputs
from .mesh import make_mesh, make_production_mesh

OUT_DIR = os.path.join("build", "dryrun_torch")
KERNEL_NAMESPACE = "repro_torch"

# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of `world_size` ranks in which this process is rank
    0 and every collective returns at once, sending nothing (torch's fake
    backend), destroyed on exit.  Refuses to nest in another group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ranks of the production meshes (launch/mesh.py): 16 x 16, or 2 x 16 x 16
PRODUCTION_RANKS = {False: 256, True: 512}


# ---------------------------------------------------------------------------
# collectives: the reference's ring model
# ---------------------------------------------------------------------------

class CollectiveRecord(NamedTuple):
    """One collective one rank took part in: its kind (the reference's HLO
    name), the bytes of its result on this rank, and its group's size."""
    kind: str
    nbytes: float
    group_size: int


def collective_bytes(records) -> dict:
    """Per-rank wire bytes by collective type on the ring model of
    core/queue.py (`wire_bytes`), n the group's size read as at least 2,
    as the reference reads a missing group."""
    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    out["count"] = 0
    for r in records:
        out[r.kind] += wire_bytes(r.kind, float(r.nbytes), max(int(r.group_size), 2))
        out["count"] += 1
    out["total"] = sum(v for k, v in out.items() if k != "count")
    return out


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _tensors(tree) -> list[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


# factories that reserve storage without writing it
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


class CostCounter(TorchDispatchMode):
    """Counts the ops one rank runs: FLOPs, unfused bytes, collectives, and
    (with `track_memory`) the peak of live storage.

    An op on DTensors is left to DTensor (NotImplemented), which runs the
    rank's local ops through this mode again: so every count is of local
    shards.  The ops DTensor runs for itself (`_internal`) are not
    counted.  Around a step on plain tensors the same mode counts every
    op, so a dry run at world size 1 and a real step give the same FLOPs.

    A kernel op (the `repro_torch` namespace) without a FLOP formula
    raises; so does a collective the ring model has no kind for."""

    def __init__(self, *, track_memory: bool = False, device: str | None = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.records: list[CollectiveRecord] = []
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._storages: dict[int, tuple[weakref.ref, int]] = {}
        self.device = device

    # -- memory -----------------------------------------------------------
    def track(self, tensors) -> int:
        """Start tracking the storages of `tensors` (local shards); returns
        the bytes newly tracked."""
        new = 0
        for t in _tensors(tensors):
            t = local(t)
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()

            def freed(_ref, key=key, n=n, me=weakref.ref(self)):
                owner = me()
                if owner is not None and owner._storages.pop(key, None) is not None:
                    owner.live -= n
            self._storages[key] = (weakref.ref(st, freed), n)
            self.live += n
            new += n
        self.peak = max(self.peak, self.live)
        return new

    def storage_ids(self, tensors) -> set[int]:
        return {id(local(t).untyped_storage()) for t in _tensors(tensors)}

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor desugars the op into the rank's local ops, which come
            # back through this mode
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not self._internal(args, kwargs, out):
            self._count(func, args, kwargs, out)
        return out

    def _internal(self, args, kwargs, out) -> bool:
        """An op DTensor runs for itself, not on the rank's local shards: an
        op on global-shaped fake tensors run to propagate metadata (under a
        fake mode DTensor opens for that), or -- with `device` set, as a dry
        run sets it to the stand-ins' -- one touching no tensor on `device`
        (its index math on host tensors)."""
        from torch._guards import detect_fake_mode
        if detect_fake_mode() is not None:
            return True
        if self.device is None:
            return False
        ts = _tensors(args) + _tensors(kwargs) + _tensors(out)
        return not any(t.device.type == self.device for t in ts)

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns in ("_c10d_functional", "_c10d_functional_autograd"):
            kind = collective_kind(name)
            if kind is None:
                return
            nbytes = sum(_nbytes(t) for t in _tensors(out))
            self.records.append(CollectiveRecord(kind, float(nbytes),
                                                 collective_group(args)[1].size()))
            return
        if packet in self._flops_of:
            self.flops += float(self._flops_of[packet](*args, **kwargs, out_val=out))
        elif ns == KERNEL_NAMESPACE:
            raise NotImplementedError(f"dry run: kernel op {func} has no FLOP formula")
        if not func.is_view:
            written = [] if name in _NO_WRITE else _tensors(out)
            self.bytes += float(sum(_nbytes(t) for t in _tensors(args))
                                + sum(_nbytes(t) for t in _tensors(kwargs))
                                + sum(_nbytes(t) for t in written))
        if self.track_memory:
            self.track(out)

    @staticmethod
    def counts_by_kind(records) -> dict[str, int]:
        """How many collectives of each kind."""
        out = {k: 0 for k in COLLECTIVE_KINDS}
        for r in records:
            out[r.kind] += 1
        return out


# ---------------------------------------------------------------------------
# shardings of optimizer state and caches
# ---------------------------------------------------------------------------

def _full_spec(spec: tuple, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def opt_state_shardings(opt_name: str, params, params_sh, sharder: Sharder) -> OptState:
    """The reference's layout of the optimizer state: AdamW's moments as
    their parameters; Adafactor's row factor the spec without its last dim,
    its column factor without its second-to-last, vectors as they are; the
    step replicated."""
    if opt_name == "adamw":
        inner = tree_map(lambda p, sh: (sh, sh), params, params_sh)
    else:
        def fact(p, sh):
            if p.ndim >= 2:
                spec = _full_spec(sh.spec, p.ndim)
                return (NamedSharding(sh.mesh, spec[:-1]),
                        NamedSharding(sh.mesh, spec[:-2] + spec[-1:]))
            return sh
        inner = tree_map(fact, params, params_sh)
    return OptState(step=sharder.replicated(), inner=inner)


def cache_shardings(sharder: Sharder, cache: dict) -> dict:
    """A decode cache's layout as an engine keeps it: each KV leaf (..., B,
    Hkv, S, D) by `cache_placement` (the batch over the batch axes, the KV
    heads over "model" where they divide, else whole -- not the
    reference's sequence split, which the in-place position writes cannot
    address); the recurrent states (hymba's SSM, xLSTM's) replicated."""
    return {name: cache_placement(sharder, t) if name in ("k", "v", "xk", "xv")
            else sharder.replicated() for name, t in cache.items()}


def _batch_sharding(sharder: Sharder, t: torch.Tensor) -> NamedSharding:
    return sharder.named([(t.shape[0], sharder.batch_axes)] + [(d, None) for d in t.shape[1:]])


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellCounts:
    """What one rank's step counted: the dry run's compiled artifact."""
    flops: float
    bytes: float
    records: list
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: int
    trace_s: float

    @property
    def temp_bytes(self) -> int:
        return max(self.total_bytes - self.argument_bytes
                   - max(self.output_bytes - self.alias_bytes, 0), 0)

    @property
    def total_bytes(self) -> int:
        """Peak live bytes of this rank's local shards: arguments, temps
        and the outputs that alias no argument."""
        return max(self.peak_bytes, self.argument_bytes
                   + max(self.output_bytes - self.alias_bytes, 0))


def opt_kind_for(cfg: ArchConfig) -> str:
    """Adafactor for the configs over 100 B parameters, else AdamW."""
    return "adafactor" if cfg.param_count() > 100e9 else "adamw"


def _step_and_args(cfg: ArchConfig, shape: InputShape, sharder: Sharder, opt_kind: str,
                   tc: TrainConfig | None):
    """(fn, args): the cell's step and its stand-ins, placed on the mesh."""
    model = get_model(cfg)
    params = params_specs(cfg, model)
    p_sh = sharder.params_shardings(params)
    dparams = sharder.distribute(params, p_sh)
    if shape.kind in ("train", "prefill"):
        batch = {k: place(v, _batch_sharding(sharder, v))
                 for k, v in train_inputs(cfg, shape).items()}
        if shape.kind == "train":
            opt = adafactor(1e-2) if opt_kind == "adafactor" else adamw(1e-3)
            dopt = tree_map(place, opt.init(params),
                            opt_state_shardings(opt_kind, params, p_sh, sharder))
            if tc is None:
                # the giant MoE configs: 4-way gradient accumulation (the
                # standard memory / throughput dial)
                tc = TrainConfig(remat=True, microbatches=4 if opt_kind == "adafactor" else 1)
            step = make_train_step(cfg, opt, tc, sharder=sharder)
            return step, ({"params": dparams, "opt": dopt}, batch)

        def fwd(params, batch):
            # prefill: hidden states for KV + LAST-token logits only
            with torch.no_grad():
                x = model.forward(params, batch, sharder=sharder, return_hidden=True)
                table = params.get("unembed", params["embed"])
                return x[:, -1] @ table.T
        return fwd, (dparams, batch)
    state = decode_inputs(cfg, shape)
    cache = state["cache"]
    state = {"tokens": place(state["tokens"], _batch_sharding(sharder, state["tokens"])),
             "pos": state["pos"],
             "cache": tree_map(place, cache, cache_shardings(sharder, cache))}

    def sstep(params, state):
        # the port's decode takes a per-slot (B,) position: the scalar
        # stand-in broadcast over the batch
        b = state["tokens"].shape[0]
        with torch.no_grad():
            return serve_step(params, {**state, "pos": state["pos"].expand(b)}, cfg,
                              sharder=sharder)
    return sstep, (dparams, state)


@contextlib.contextmanager
def collector_off():
    """Python's cyclic garbage collector off (as it was after).  A step frees
    most tensors by reference counting; the few it leaves in reference
    cycles (autograd and checkpoint bookkeeping) wait for the collector,
    whose timing depends on the process's history.  With it off they stay
    until the step ends, so a peak counted (or measured) under this is the
    same in every run."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def count_step(cfg: ArchConfig, shape: InputShape, mesh, *, opt_kind: str,
               tc: TrainConfig | None = None) -> CellCounts:
    """Trace one rank's step of (cfg, shape) on `mesh` (a DeviceMesh over
    the fake group) on meta stand-ins and count it, the collector off
    (`collector_off`)."""
    sharder = Sharder(mesh)
    fn, args = _step_and_args(cfg, shape, sharder, opt_kind, tc)
    counter = CostCounter(track_memory=True, device=DEVICE)
    t0 = time.perf_counter()
    arg_bytes = counter.track(args)
    arg_ids = counter.storage_ids(args)
    with counter, collector_off():
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    out_ids = {}
    for t in _tensors(out):
        st = local(t).untyped_storage()
        out_ids[id(st)] = st.nbytes()
    return CellCounts(flops=counter.flops, bytes=counter.bytes, records=list(counter.records),
                      argument_bytes=arg_bytes, output_bytes=sum(out_ids.values()),
                      alias_bytes=sum(n for k, n in out_ids.items() if k in arg_ids),
                      peak_bytes=counter.peak, trace_s=trace_s)


def _mesh_key(mesh) -> tuple:
    return tuple(zip(mesh.mesh_dim_names, mesh.shape))


def _lower_cell(cfg: ArchConfig, shape: InputShape, mesh, *, opt_kind: str,
                tc: TrainConfig | None = None) -> CellCounts:
    """One cell's counts through the process-wide executable cache: a cell
    revisited in one invocation (the same calibration depth across mesh
    variants) is not traced again.  The key hashes the FULL config."""
    key = ("dryrun", repr(cfg), shape.name if SHAPES.get(shape.name) == shape else repr(shape),
           _mesh_key(mesh), opt_kind) + ((repr(tc),) if tc is not None else ())
    return executable_cache().get_or_build(
        key, lambda: count_step(cfg, shape, mesh, opt_kind=opt_kind, tc=tc))


def _cal_period(cfg: ArchConfig) -> int:
    """Calibration depth: one full structural+schedule period."""
    period = len(_sub_kinds(cfg))
    if cfg.window_pattern:
        period = math.lcm(period, len(cfg.window_pattern))
    return period


def extrapolate(c1: float, c2: float, n_layers: int, period: int) -> float:
    """The reference's calibration: cal(P) + (L/P - 1) * (cal(2P) - cal(P)).
    XLA counts a scan body once, so the reference counts depths P and 2P and
    extrapolates; the port's layer loops are Python loops, whose full-depth
    count is exact -- and equal to this for a model whose groups cost the
    same (tests hold the two equal)."""
    return c1 + (n_layers / period - 1.0) * max(c2 - c1, 0.0)


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """6 N D for train (forward + backward), 2 N D forward-only; decode D =
    the batch's tokens, one each."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def device_capacity() -> int:
    """Bytes of device memory a rank may fill: the card's, where one is
    present, else the H100's data-sheet size."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return int(H100_HBM_BYTES)


def row(cfg: ArchConfig, shape: InputShape, mesh_label: str, chips: int,
        c: CellCounts, *, arch: str | None = None) -> dict:
    """The reference's JSON row of one cell from its counts, with the torch
    release that counted it (`torch`)."""
    coll = collective_bytes(c.records)
    terms = roofline(c.flops, c.bytes, coll["total"])
    mf = model_flops(cfg, shape) / chips
    gib = 2 ** 30
    total = c.total_bytes
    return {
        "arch": arch or cfg.name, "shape": shape.name, "mesh": mesh_label, "chips": chips,
        "status": "ok", "torch": torch.__version__,
        "compile_s": round(c.trace_s, 1),
        "memory": {
            "argument_GiB": round(c.argument_bytes / gib, 3),
            "output_GiB": round(c.output_bytes / gib, 3),
            "temp_GiB": round(c.temp_bytes / gib, 3),
            "alias_GiB": round(c.alias_bytes / gib, 3),
            "total_GiB_per_chip": round(total / gib, 3),
            "fits_80GB": bool(total < device_capacity()),
        },
        "cost": {"flops_per_chip": c.flops, "bytes_per_chip": c.bytes},
        "collectives": {k: round(v, 0) if isinstance(v, float) else v
                        for k, v in coll.items()},
        "roofline": {
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s, "dominant": terms.dominant,
            "bound_s": terms.bound_s,
            "model_flops_per_chip": mf,
            "useful_flops_ratio": (mf / c.flops) if c.flops else 0.0,
            "roofline_fraction": (min(mf / PEAK_FLOPS_PER_CHIP, terms.bound_s)
                                  / terms.bound_s) if terms.bound_s else 0.0,
        },
    }


SWEEP_KINDS = ("train", "prefill", "decode")
# the sweep's fake ("data", "model") mesh -- a 16-wide axis, which the gloo
# tests' meshes of at most 4 never reach -- and its steps' tokens and rows
SWEEP_MESH, SWEEP_SEQ, SWEEP_BATCH = (16, 16), 64, 32


def reduced_sweep() -> list[dict]:
    """Every config `.reduced()` through a train, a prefill and a decode
    step of SWEEP_SEQ tokens and SWEEP_BATCH rows on a fake SWEEP_MESH.
    One dict per form: arch, kind, status ("ok" or "FAIL: ..."), flops and
    collectives of rank 0, and the seconds it took.  Opens its own fake
    group."""
    out = []
    with fake_world(math.prod(SWEEP_MESH)):
        mesh = make_mesh(SWEEP_MESH, ("data", "model"), "cuda")
        for arch in ARCHS:
            cfg = get_config(arch).reduced()
            for kind in SWEEP_KINDS:
                shape = InputShape(f"{kind}_{SWEEP_SEQ}", SWEEP_SEQ, SWEEP_BATCH, kind)
                res = {"arch": arch, "kind": kind}
                t0 = time.perf_counter()
                try:
                    c = count_step(cfg, shape, mesh, opt_kind=opt_kind_for(cfg))
                    res.update(status="ok", flops=c.flops, collectives=len(c.records))
                except Exception as exc:  # noqa: BLE001 -- a failed form is the finding
                    res["status"] = f"FAIL: {type(exc).__name__}: {str(exc)[:300]}"
                res["seconds"] = time.perf_counter() - t0
                out.append(res)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    """One (arch, shape) cell on the production mesh: the full-depth step
    traced and counted on rank 0's local shards.  Opens a fake group of the
    mesh's size unless one of that size is already up."""
    import torch.distributed as dist
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    chips = PRODUCTION_RANKS[multi_pod]
    ctx = contextlib.nullcontext() if dist.is_initialized() else fake_world(chips)
    with ctx:
        if dist.get_world_size() != chips:
            raise RuntimeError(f"run_cell: the process group has {dist.get_world_size()} "
                               f"ranks, the production mesh needs {chips}")
        # the card's device type even on a host without one: DTensor picks
        # its collectives by it (a host mesh trades each all-to-all for an
        # all-gather); the meta stand-ins reach no device
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
        counts = _lower_cell(cfg, shape, mesh, opt_kind=opt_kind_for(cfg))
    result = row(cfg, shape, "2x16x16" if multi_pod else "16x16", chips, counts, arch=arch)
    if verbose:
        print(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cells = []
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    for a in archs:
        shapes = applicable_shapes(get_config(a)) if (args.all or not args.shape) \
            else [args.shape]
        for s in shapes:
            for mp in {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]:
                cells.append((a, s, mp))

    for mp in (False, True):           # one fake group per mesh size
        todo = []
        for a, s, m in cells:
            tag = f"{a}__{s}__{'multi' if m else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if m != mp:
                continue
            if os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            todo.append((a, s, tag, path))
        if not todo:
            continue
        with fake_world(PRODUCTION_RANKS[mp]):
            for a, s, tag, path in todo:
                print(f"[run ] {tag}", flush=True)
                try:
                    res = run_cell(a, s, mp, verbose=False)
                except Exception as e:  # noqa: BLE001 -- a failed cell is a bug report
                    res = {"arch": a, "shape": s, "mesh": "2x16x16" if mp else "16x16",
                           "status": f"FAIL: {type(e).__name__}: {str(e)[:400]}"}
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                print(f"[done] {tag}: {res['status']}"
                      + (f" dominant={res['roofline']['dominant']}"
                         f" fits={res['memory']['fits_80GB']}"
                         f" trace_s={res['compile_s']}"
                         if res["status"] == "ok" else ""), flush=True)


if __name__ == "__main__":
    main()
