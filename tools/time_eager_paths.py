#!/usr/bin/env python3
"""Time the eager paths that call the kernels through their
`torch.library` ops on one card, for comparing two trees in one call:
the gemma3-1b training step (phase 8a's), the whisper-small training step
(phase 8b's) and whisper-small decode steps (phase 9d's), each at full
width from seeded weights.

    python3 tools/time_eager_paths.py

Imports chip_smoke.py and src/ from the tree this file lies in and uses
only entry points every tree of the port has, so a copy of this file
placed in another tree's tools/ times that tree.  Prints the card and its
power limit first, then per path the mean host-clock ms of the timed
steps (all but the first), each step ending in a sync; in a tree whose
kernels are `torch.library` ops, also the host microseconds a call of the
fused-MLP forward takes through its op and through its raw wrapper, at
whisper decode's shape.  Needs one card.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402  (puts the tree's src/ on sys.path)
import torch  # noqa: E402

TRAIN_STEPS, DECODE_STEPS = 5, 24


def train_ms(name: str, batch: int, seq: int) -> float:
    cfg = CS.get_config(name)
    opt = CS.adamw(CS.TRAIN_LR)
    state = CS.make_train_state(cfg, opt, seed=0, device="cuda")
    step = CS.make_train_step(cfg, opt, CS.TrainConfig(remat=True, xent_chunk=512))
    at = CS.train_batches(cfg, batch, seq)
    _, _, secs = CS.train_steps(name, state, step, [at(i) for i in range(TRAIN_STEPS)], {})
    del state
    CS.free()
    return 1e3 * sum(secs[1:]) / len(secs[1:])


def decode_ms() -> float:
    cfg = CS.get_config("whisper-small")
    params = CS.get_model(cfg).init(seed=0, device="cuda")
    b, n = CS.WHISPER_BATCH, CS.WHISPER_FRAMES
    gen = torch.Generator(device="cuda").manual_seed(21)
    frames = torch.randn((b, n, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    tok = torch.randint(2, cfg.vocab, (b,), generator=gen, device="cuda")
    secs = []
    with torch.no_grad():
        enc = CS.encdec.encode(params, frames, cfg)
        cache = CS.encdec.build_cross_cache(params, enc, cfg, CS.encdec.init_cache(
            cfg, b, CS.WHISPER_MAX_LEN, enc_len=n, device="cuda"))
        for t in range(DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = CS.encdec.decode_step(params, tok, t, cache, cfg)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    del params, cache
    CS.free()
    return 1e3 * sum(secs[1:]) / len(secs[1:])


def dispatch_us(n: int = 2000) -> tuple[float, float] | None:
    """(raw wrapper, op) host us a call of B1 at (8, 768 -> 3072 -> 768)
    bf16 under no_grad, or None where the kernels are no ops."""
    from repro_torch.kernels import ops
    if not hasattr(ops, "fused_mlp_fwd_op"):
        return None
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, w1, w2 = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                 for s in ((8, 768), (768, 3072), (3072, 768)))
    out = []
    with torch.no_grad():
        for fn in (lambda: CS.K.fused_mlp_fwd(x, w1, w2, act="gelu"),
                   lambda: ops.fused_mlp_fwd_op(x, w1, w2, "gelu")):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            out.append(1e6 * (time.perf_counter() - t0) / n)
    return out[0], out[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("time_eager_paths: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {CS.ROOT}", flush=True)
    CS._build.build_all()
    out = {"gemma3-1b train step": train_ms("gemma3-1b", 4, 2048),
           "whisper-small train step": train_ms("whisper-small", 8, 448),
           "whisper-small decode step": decode_ms()}
    for k, v in out.items():
        print(f"eager {k}: {v:.2f} ms (host clock, mean of all but the first)", flush=True)
    us = dispatch_us()
    if us is not None:
        print(f"B1 (8, 768 -> 3072 -> 768) a call: raw wrapper {us[0]:.1f} us, through its "
              f"op {us[1]:.1f} us (host clock over 2000 calls, a sync at the end)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
