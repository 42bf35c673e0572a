#!/usr/bin/env python3
"""Time whisper-small training steps at full width on one card, as
chip_smoke.py phase 8b trains it, for comparing two trees in one call.

    python3 tools/time_train_step.py
    python3 tools/time_train_step.py --profiles-first 4   # profile, then time

Imports chip_smoke.py and src/ from the tree this file lies in, so to
compare two trees run each tree's copy of this file.  Builds whisper-small
from a seed as phase 8b does (bf16 weights, AdamW, remat, cross entropy in
chunks of 512, batches of 8 x 1500 stub frames and 448 tokens), takes
--profiles-first profiled steps on step 0's batch (as chip_smoke.py
profiles decode ticks and a gemma3-1b step before it trains whisper-small),
then STEPS steps on distinct batches, each printed with its wall time and
the allocator's driver calls, the mean of all but the first, and
chip_smoke.py's torch.profiler split of one more step against that mean.
Prints the card and its power limit first.  Needs one card.
"""
import argparse
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402  (puts the tree's src/ on sys.path)
import torch  # noqa: E402

STEPS = 6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles-first", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_train_step: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {CS.ROOT}", flush=True)
    cfg = CS.get_config("whisper-small")
    opt = CS.adamw(CS.TRAIN_LR)
    state = CS.make_train_state(cfg, opt, seed=0, device="cuda")
    step = CS.make_train_step(cfg, opt, CS.TrainConfig(remat=True, xent_chunk=512))
    at = CS.train_batches(cfg, 8, 448)
    for _ in range(args.profiles_first):   # no unprofiled step time yet: idle reads nan
        CS.profile_train_step("whisper-small (before timing)", step, state, at(0), math.nan)
    state, _, secs = CS.train_steps("whisper-small", state, step,
                                    [at(i) for i in range(STEPS)], {})
    step_s = sum(secs[1:]) / len(secs[1:])
    print(f"whisper-small: {1e3 * step_s:.1f} ms per step (mean of steps 2-{STEPS}), "
          f"{args.profiles_first} profiled steps first", flush=True)
    CS.profile_train_step("whisper-small", step, state, at(0), step_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
