"""Training launcher for the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 100 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --device cpu --steps 3

Trains on `--device` (default `cuda`) from random weights drawn from
`--seed`, on the synthetic token stream (`data.SyntheticLM`), for the
decoder-only configs (the reference launcher feeds tokens only).  Fault
tolerance: Supervisor + Checkpointer (async saves every `--ckpt-every`
steps and at the last step into `--ckpt`; a directory that already holds a
committed step resumes from it).  AdamW with a cosine schedule, or
Adafactor for configs over 100 B parameters, as the reference launcher
picks.  Not ported: `--compile-mode` (needs the capture front-end, ROADMAP
A4) and meshes other than 1 x 1 (ROADMAP A8).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import DataConfig, SyntheticLM
from ..optim import adafactor, adamw, cosine_schedule
from ..runtime import StragglerMonitor, Supervisor
from ..train import TrainConfig, make_train_state, make_train_step

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
    args = ap.parse_args(argv)
    if args.mesh_data * args.mesh_model != 1:
        raise SystemExit("only a 1 x 1 mesh is ported (ROADMAP A8)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "encdec":
        raise SystemExit(f"{cfg.name}: the launcher feeds token batches only; an "
                         f"encoder-decoder also needs frame embeddings")
    device = torch.device(args.device)
    giant = cfg.param_count() > 100e9
    opt = adafactor(1e-2) if giant else adamw(
        cosine_schedule(3e-4, warmup=20, total=args.steps))
    tc = TrainConfig(remat=True, microbatches=args.microbatches,
                     xent_chunk=min(512, args.seq))
    step_fn = make_train_step(cfg, opt, tc)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    ck = Checkpointer(args.ckpt, keep=3, async_save=True)
    sup = Supervisor(ck, checkpoint_every=args.ckpt_every,
                     heartbeat_path=str(Path(args.ckpt) / "heartbeat"))
    mon = StragglerMonitor()

    def one_step(state, step):
        t0 = time.time()
        batch = {"tokens": torch.from_numpy(data.batch(step)["tokens"]).to(device)}
        state, m = step_fn(state, batch)
        act = mon.record(time.time() - t0)
        if act:
            print(f"[straggler] {act}", flush=True)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(m['loss']):.4f}", flush=True)
        return state

    state, report = sup.run(init_state=lambda: make_train_state(cfg, opt, args.seed, device),
                            step_fn=one_step, n_steps=args.steps)
    print(f"finished: {report}")
    step = ck.latest_step()
    if step is not None and ck.last_save_s is not None:
        print(f"checkpoint: step {step} in {args.ckpt}, last save {ck.last_save_s:.2f} s")


if __name__ == "__main__":
    main()
