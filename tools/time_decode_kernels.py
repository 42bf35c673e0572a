#!/usr/bin/env python3
"""Time the decode kernels B4 (flash_decode) and B8 (paged_flash_decode)
with bfloat16 and with float8 e4m3 K/V beside a bfloat16 q, at phase 7's
decode shapes (chip_smoke.py): phi3-medium-14b's 8 slots of 40 query / 10
kv heads of 128 at S = 512 and 4096, B8 over its 40-layer pools (32 pages
of 16 a slot), and hymba-1.5b's G = 5, D = 64; ragged valid lengths, cold
L2 (chip_smoke's `cuda_ms`).  Each case is first held to its plain version
(chip_smoke's `check`, bf16 bounds).  Prints the card and power limit, then
one JSON line per case.  Needs one card:

    python3 tools/time_decode_kernels.py [--reps 3]

To compare two trees on one card, copy this file into the other tree's
tools/ and run both in one call, in turns (A, B, B, A).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_decode_plain  # noqa: E402
from repro_torch.kernels.paged_attention import paged_flash_decode_plain  # noqa: E402
from repro_torch.kernels.ref import to_e4m3  # noqa: E402


def kv(t, dtype):
    return to_e4m3(t) if dtype == "e4m3" else t.to(torch.bfloat16)


def cases(gen, dtype):
    rng = np.random.default_rng(21)
    b, bs, n_blocks, v_blocks = 8, 16, 512, 32
    phi3, hymba = get_config("phi3-medium-14b"), get_config("hymba-1.5b")
    for name, cfg, s_len in (("flash_decode", phi3, 512), ("flash_decode_s4096", phi3, 4096),
                             ("flash_decode_hymba", hymba, 512)):
        q = cs.randn(gen, b, cfg.n_heads, 1, cfg.head_dim, dtype=torch.bfloat16)
        k, v = (kv(cs.randn(gen, b, cfg.n_kv_heads, s_len, cfg.head_dim, dtype=torch.float32),
                   dtype) for _ in range(2))
        valid = torch.from_numpy(rng.integers(1, s_len + 1, b).astype(np.int32)).to("cuda")
        yield (name, lambda: K.flash_decode(q, k, v, valid_len=valid),
               lambda: flash_decode_plain(q, k, v, valid_len=valid))
    for name, cfg, n_g in (("paged_flash_decode", phi3, phi3.n_layers),
                           ("paged_flash_decode_hymba", hymba, 32)):
        pool = ((n_blocks + 1) * bs, n_g, 1, cfg.n_kv_heads, cfg.head_dim)
        kp, vp = (kv(cs.randn(gen, *pool, dtype=torch.bfloat16), dtype) for _ in range(2))
        q = cs.randn(gen, b, cfg.n_heads, 1, cfg.head_dim, dtype=torch.bfloat16)
        tables = (1 + torch.randperm(b * v_blocks, generator=gen, device="cuda")).to(
            torch.int32).reshape(b, v_blocks)
        valid = torch.from_numpy(rng.integers(1, v_blocks * bs + 1, b).astype(np.int32)).to(
            "cuda")
        layer = (n_g - 1, 0)
        yield (name, lambda: K.paged_flash_decode(q, kp, vp, tables, valid_len=valid,
                                                  block_size=bs, layer=layer),
               lambda: paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                                block_size=bs, layer=layer))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3, help="timed rounds (min taken)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for dtype in ("bf16", "e4m3"):
        gen = torch.Generator(device="cuda").manual_seed(5)
        for name, kern, plain in cases(gen, dtype):
            err, rel = cs.check(f"{name}[{dtype}]", kern(), plain(), torch.bfloat16)
            ms = min(cs.cuda_ms(kern, 20, cold=True) for _ in range(args.reps))
            print(json.dumps({"name": name, "kv": dtype, "ms": ms, "max_abs_err": err,
                              "rel_err": rel}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
