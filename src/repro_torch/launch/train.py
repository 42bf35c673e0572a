"""Training launcher for the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 100 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --device cpu --steps 3
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch gemma3-1b --reduced --device cpu \\
        --mesh-data 2 --mesh-model 2 --steps 3

Trains on `--device` (default `cuda`) from random weights drawn from
`--seed`, on the synthetic token stream (`data.SyntheticLM`), for the
decoder-only configs (the reference launcher feeds tokens only).  Fault
tolerance: Supervisor + Checkpointer (async saves every `--ckpt-every`
steps and at the last step into `--ckpt`; a directory that already holds a
committed step resumes from it).  AdamW with a cosine schedule, or
Adafactor for configs over 100 B parameters, as the reference launcher
picks.  `--compile-mode bsp|vertical|kitsune` runs the step through the
dataflow pipeline (`train.compile_train_step`: the full forward, backward
and optimizer step traced and compiled, its state donated in place),
compiled on the first step's state and batch, on one device only.

A mesh: `--mesh-data D --mesh-model M` under `torchrun` (or with
torch.distributed's WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT set), one
process per rank, world size D x M.  NCCL on the card, rank r on
`cuda:{LOCAL_RANK}`; gloo under `--device cpu`.  Parameters (and the
optimizer state with them) are placed by `Sharder.params_shardings` on a
("data", "model") DeviceMesh, and the step runs under that sharder
(train.make_train_step).  Only rank 0 prints and writes checkpoints.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import DataConfig, SyntheticLM
from ..distributed.sharding import NULL, Sharder
from ..models import get_model
from ..optim import adafactor, adamw, cosine_schedule
from ..runtime import StragglerMonitor, Supervisor
from ..train import (TrainConfig, compile_train_step, make_train_state,
                     make_train_step)

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compile-mode", default=None,
                    choices=("bsp", "vertical", "kitsune"),
                    help="run the training step through the dataflow pipeline "
                         "(the full fwd+bwd+optimizer step traced and compiled, "
                         "state donated in place) instead of eagerly")
    args = ap.parse_args(argv)
    n_dev = args.mesh_data * args.mesh_model
    if args.compile_mode is not None and n_dev > 1:
        raise SystemExit("--compile-mode drives the single-device dataflow "
                         "pipeline; use mesh 1x1")
    sharder, rank, device = _mesh(args, n_dev)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "encdec":
        raise SystemExit(f"{cfg.name}: the launcher feeds token batches only; an "
                         f"encoder-decoder also needs frame embeddings")
    giant = cfg.param_count() > 100e9
    opt = adafactor(1e-2) if giant else adamw(
        cosine_schedule(3e-4, warmup=20, total=args.steps))
    tc = TrainConfig(remat=True, microbatches=args.microbatches,
                     xent_chunk=min(512, args.seq))
    if args.compile_mode is not None:
        # compiled on the first step (the trace takes that step's state and
        # batch; the Supervisor may restore the state from a checkpoint first)
        compiled = {}

        def step_fn(state, batch):
            if "app" not in compiled:
                t0 = time.perf_counter()
                app = compiled["app"] = compile_train_step(
                    cfg, opt, tc, state=state, batch=batch,
                    compile_mode=args.compile_mode)
                low = app.lowering.summary() if app.lowering is not None \
                    else "no kernel lowering in this mode"
                print(f"compiled ({args.compile_mode}, {len(app.graph.nodes)} nodes, "
                      f"{time.perf_counter() - t0:.1f} s): {low}", flush=True)
            return compiled["app"](state, batch)
    else:
        step_fn = make_train_step(cfg, opt, tc, sharder=sharder)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    ck = Checkpointer(args.ckpt, keep=3, async_save=True)
    sup = Supervisor(ck, checkpoint_every=args.ckpt_every,
                     heartbeat_path=str(Path(args.ckpt) / "heartbeat") if rank == 0 else None)
    mon = StragglerMonitor()
    say = print if rank == 0 else (lambda *a, **k: None)

    def init_state():
        if sharder is NULL:
            return make_train_state(cfg, opt, args.seed, device)
        # every rank draws the same full tensors from the seed and keeps
        # its own slices
        params = sharder.distribute(get_model(cfg).init(args.seed, device))
        return {"params": params, "opt": opt.init(params)}

    def one_step(state, step):
        t0 = time.time()
        batch = {"tokens": torch.from_numpy(data.batch(step)["tokens"]).to(device)}
        state, m = step_fn(state, batch)
        act = mon.record(time.time() - t0)
        if act:
            say(f"[straggler] {act}", flush=True)
        if step % 10 == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {float(m['loss']):.4f}", flush=True)
        return state

    state, report = sup.run(init_state=init_state, step_fn=one_step, n_steps=args.steps)
    say(f"finished: {report}")
    step = ck.latest_step()
    if step is not None and ck.last_save_s is not None:
        say(f"checkpoint: step {step} in {args.ckpt}, last save {ck.last_save_s:.2f} s")
    if sharder is not NULL:
        torch.distributed.destroy_process_group()


def _mesh(args, n_dev: int):
    """(sharder, rank, device).  Without a process group in the environment
    and on a 1 x 1 mesh: NULL on `--device`.  Else one process per rank,
    the world size data x model, NCCL on the card and gloo on the CPU."""
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if n_dev == 1 and world == 0:
        return NULL, 0, torch.device(args.device)
    if world != n_dev:
        raise SystemExit(f"--mesh-data {args.mesh_data} x --mesh-model {args.mesh_model} "
                         f"needs a world size of {n_dev} processes, got {world} (run it "
                         f"under torchrun --nproc-per-node {n_dev})")
    from .mesh import make_mesh
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        torch.distributed.init_process_group("nccl", device_id=device)
    else:
        torch.distributed.init_process_group("gloo")
    mesh = make_mesh((args.mesh_data, args.mesh_model), ("data", "model"), device.type)
    return Sharder(mesh), torch.distributed.get_rank(), device


if __name__ == "__main__":
    main()
