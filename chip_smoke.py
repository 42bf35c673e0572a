#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each failing the run on any error (no phase's exception is caught):
  1. the card's name, power limit and count;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
     and print the registers and spills ptxas reports for each kernel;
  3. hold each kernel against its plain PyTorch version at the shapes the
     main path gives it, in bf16 and f32, and time kernel, plain version,
     a one-call PyTorch yardstick (never used by the port) and the bound;
     time the forward's two forms at phi3 widths for M in 1..128 (the
     small-M form up to its 64 rows) and print their crossover; B5 at the
     compiler's fan-in and at the folds B2 leaves (Llama widths, decode) and
     B7 leaves (its dX partials at gemma3-1b's widths, the deepest fold of
     training), each first held bitwise to the sequential f32 fold; B6 at
     whisper-small's two training shapes and B7 at gemma3-1b's, each with
     its dX and dW kernels timed apart; B1 at
     whisper-small's two training shapes; the tiled forward's and the bf16
     backward's rows carry the bytes of the f32 partials they wrote; and
     the decode kernels at phase 9's shapes (B2's small-M form at hymba's
     and maverick's FFN widths and B1's at whisper's, with their folds; B8
     and B4 at 5 query heads per kv head, D 64 and 128; B4 at whisper's
     cache); and B4 and B8 reading float8 e4m3 K/V beside a bf16 q (the
     float8 KV cache) at phase 7's shape, B4 at S = 4096, both at hymba's
     G = 5, D = 64, each held to its e4m3 plain version, with the K/V cast
     to bf16 plus SDPA as the yardstick;
  4. the Llama3-8B challenge app at full width (d=4096, ff=14336, 32 heads
     of 128, vocab 128256, seq 2048, batch 4, its 2 layers + LM head, bf16
     weights from a seed; hkv=hq because the graph models GQA without
     materializing it) through `repro_torch.compile` in bsp, vertical and
     kitsune modes, each three times captured (the first run builds the
     programs and captures the plan as one CUDA graph, the others replay
     it; the second replay is the timed one) and once as the uncaptured
     walk (`CompiledApp.uncaptured()`): the replay
     must be bitwise the walk, every mode is held to an f32 run of the
     same graph and weights (MODEL_TOL), no run after the first may build
     anything, every run launches alike, and each kitsune run must launch
     fused_mlp_swiglu and flash_attention exactly twice; phases 4-6 and
     10 lower every site (lowering_policy="always"), since they count each
     site's launches;
  5. nerf, dlrm, mgn and graphcast at their published sizes, kitsune
     against bsp, captured and uncaptured as in 4, with fused_mlp launched
     once per lowered site;
  6. a split-reduction graph, x (2048, 1024, 256) bf16 -> x*x -> sum over
     axis 0, kitsune (queue_reduce) against bsp;
  7. serving: phi3-medium-14b at full width and depth (40 layers, bf16
     weights from a seed, 29.3 GB) behind `PagedServingEngine`, 16 requests
     through 8 slots with chunked prefill, slot refill and prefix hits,
     every tick a replay of a captured CUDA graph (one per bucket; the
     replays must equal the ticks): the native tick must launch
     paged_flash_decode and fused_mlp_swiglu exactly
     40 times per decode step, every fused_mlp_swiglu launch in its small-M
     form, a "gather" run flash_decode as often with
     bitwise-equal tokens, one replay per (mode, bucket) must equal eager
     `paged_tick` on copies of the pools bit for bit (tokens, logits,
     pages), a short async run must serve the native run's tokens, one
     request served alone by an engine whose KV
     pools are sized by the profiling pass (num_blocks=None, as the
     launcher builds it) must equal its tokens in the batch, and the
     reduced config (f32) must serve the same tokens on the card (captured)
     as on the CPU (eager); a one-step tick is profiled eager and replayed;
     then the same weights with kv_cache_dtype="float8_e4m3fn" (e4m3 page
     pools), the engines given the block_s kernels/autotune.py picks for
     B8 over e4m3 pools (`kernels=`, printed beside the bf16 pick): the
     native tick must launch paged_flash_decode in its e4m3 form 40 times a
     decode step, the gather run flash_decode's e4m3 form with bitwise the
     same tokens, each bucket's replay must equal eager paged_tick (pools
     compared through their bytes), request 0 alone on profiled pools must
     equal its tokens in the batch with at least 1.9x the bf16 run's
     default capacity, the first tick's logits must lie within the
     reference's float8 bound (0.15 max|logits| + 0.5) of the bf16 run's,
     and the KV bytes a tick must be half; the reduced config with a float8
     cache, teacher-forced through the replayed tick, must give the CPU's
     logits within MODEL_TOL;
  8. training (phase 3 also holds the backward kernels and each autograd
     Function's gradients): gemma3-1b at full width and depth (26 layers,
     1.00 B bf16 parameters from a seed, AdamW, remat, 4 x 2048 tokens) takes
     3 steps on distinct batches and 5 on one repeated batch, where its loss
     must fall, each step launching fused_mlp_swiglu_bwd 26 and
     fused_mlp_swiglu 52 times (forward + remat recompute), with a
     torch.profiler split of one step; whisper-small (12 + 12 layers, 8 x
     1500 stub frames, 448 tokens) takes 3 steps, each launching
     fused_mlp_bwd 24 times (12 at the encoder's rows, 12 at the
     decoder's) and fused_mlp 36 times (12 at the encoder's rows, 24 --
     forward and remat recompute -- at the decoder's), with a
     torch.profiler split of a fourth step on step 0's batch, whose loss
     must have fallen; the reduced
     gemma3/whisper configs (f32) train the same on the card as on the CPU, and twice
     alike on the card; the training launcher runs gemma3-1b for 4 steps in
     a subprocess and saves its checkpoint;
  9. the model families beyond dense, each model in its own scope, bf16
     weights from a seed: (a) hymba-1.5b at full width, its depth cut to 8
     of its 32 layers (attention + Mamba heads) behind the paged
     engine with per-slot SSM state, phase 7's 16 requests through 8 slots,
     every tick a replay: 8 paged_flash_decode and 8 small-M
     fused_mlp_swiglu launches per decode step, gather == native, request
     0 alone == in the batch, every bucket's replay == eager `paged_tick`
     (pages and SSM state included), prefix caching off by the engine's
     rule, the reduced config's card tokens == its CPU tokens, a profiled
     one-step tick; (b) llama4-maverick at full width cut to 2 layers (a
     dense and a MoE layer of 128 experts, 35 GB): 8 requests, 2
     paged_flash_decode and 1 small-M fused_mlp_swiglu per step, gather ==
     native, replay == eager, reduced card == CPU (no solo == batched:
     capacity routing couples the slots); (c) xlstm-350m at full depth on
     the engine without pages, 8 requests through 4 slots, captured ==
     eager on the card, reduced card == CPU; (d) whisper-small decode: 8 x
     1500 stub frames encoded, the cross cache built, 16 decode steps at
     batch 8 with 12 flash_decode and 12 small-M fused_mlp launches each,
     the first step's logits held to the plain path within MODEL_TOL;
 10. the capture front-end (`repro_torch.compile(fn, example_inputs)`,
     kernels reached through the lowering pass): (a) `compile_train_step`
     on gemma3-1b at full width and depth (batch 4 x 2048, no depth cut:
     trace and passes take ~12-18 s), 3 kitsune steps against 3 eager
     `make_train_step` steps from the same weights, losses within 1e-3 and
     parameters within twice the eager run's own spread over three
     reorderings of its sums (phase 3's bf16 dW rule over the trajectory,
     `hold_train_run`), each kitsune step launching fused_mlp_swiglu 52 and
     fused_mlp_swiglu_bwd 26 times, every step after the first a replay
     of the plan captured after it; then one more step from one state, both
     captured and as the uncaptured walk, bitwise alike, and a profiled
     replay (device time by kernel, idle share); then the same trace
     compiled in bsp mode (`with_mode`, no second trace), 2 bsp steps
     captured and 1 uncaptured; trace and pass seconds, capture seconds and
     graph pool bytes, ms a step of kitsune and bsp (captured and
     uncaptured) and eager, the kitsune run's peak memory; (b) the same
     for whisper-small (8 x 1500 frames, 448 tokens), fused_mlp 36 and
     fused_mlp_bwd 24 a step; (c) the traced zoo forward of gemma3-1b at
     full width (2 x 1024) in kitsune mode, its replay bitwise the
     uncaptured walk and the raw forward, fused_mlp_swiglu 26 times; (d)
     the paged and the legacy engine with compile_mode="kitsune" against
     compile_mode=None on phi3-medium-14b at full width cut to 2 layers (a
     16-step prefill tick of 40 layers would trace ~50k nodes): the same
     tokens, the paged tick launching paged_flash_decode and
     fused_mlp_swiglu, the legacy one flash_decode, each bucket's captured
     plan of the paged tick bitwise its uncaptured walk, trace and compile
     seconds apart from capture and run seconds; and the paged engine again
     with a float8 cache, its traced tick launching paged_flash_decode's
     e4m3 form; (e) a traced
     `paged_decode_atom` at phase 7's decode shape, lowered to
     paged_flash_decode, against its plain version; 10a, 10b and 10d
     also print the verdicts the default policy ("auto") gives their
     apps' sites (the pipelined graph lowered again, nothing traced
     again);
 11. the legacy engine's tick through `cached_jit`: phi3-medium-14b at full
     width and depth (40 layers, batch 8), 8 prompts of 48 tokens decoded
     to a 160-position cache, every tick eager and then every tick after
     the first a replay of one captured graph: bitwise the same tokens, 40
     flash_decode and 40 small-M fused_mlp_swiglu launches a tick; ms a
     tick, capture seconds, graph pool bytes, and three profiled ticks of
     each for the device's idle share; then the same with a float8 KV
     cache, eager and through cached_jit, bitwise alike, flash_decode's
     e4m3 form 40 times a tick;
 12. the compiler's default lowering policy ("auto"): (a) the Llama3-8B
     app and (b) nerf, dlrm, mgn, graphcast and the split-reduction graph
     at phases 4-6's sizes compiled in kitsune mode under "auto" -- every
     site's tier ("cost" or "measured"), decision, estimated and measured
     microseconds and tuned tile, the compile's seconds for verdicts and
     for tiles apart, a second compile that must hit the verdict and tune
     caches at every site, three captured runs held to the same app under
     "always" within MODEL_TOL, ms a run of each; (c) B4 and B8 traced at
     phase 7's decode shape and compiled under "auto": the tuned block_s
     and its time, every candidate of the grid timed with a cold L2 beside
     it, the compiled site held to the plain version; (d) the five tiny
     instances (f32) likewise, where every measured verdict must follow
     its own numbers.  After phases 4-6, `calibrate(H100, ...)` is fitted
     to phases 4-5's timed bsp replays (flops, boundary bytes, programs,
     seconds) and printed;
 13. the distributed layer at world size 1: an NCCL process group of one
     rank (a file:// store under build/) and a (1, 1) ("data", "model")
     DeviceMesh.  (a) gemma3-1b at full width and depth, DIST_STEPS steps
     of `make_train_step(..., sharder=Sharder(mesh))` on DTensor
     parameters and moments against as many NULL steps from the same
     state and batches (2 x 1024 tokens): losses and parameters bitwise
     (or within `hold_train_run`'s reorder bound, said which), the
     fused_mlp_swiglu / fused_mlp_swiglu_bwd / queue_reduce launches
     equal to the NULL run's, ms a step of each, each step's device idle
     share (torch.profiler) and the sharded step's collectives
     (CommDebugMode); (b) `restore_with_resharding` of (a)'s parameters
     onto the mesh's placements, bitwise, with seconds and bytes; (c)
     `run_pipelined` with one stage over gemma3-1b's first four MLP blocks
     (B2 inside the layer) against the sequential call, and
     `error_feedback_allreduce` on NCCL over a gemma3-1b gradient against
     the plain quantize -> dequantize round trip, both bitwise; (d)
     phi3-medium-14b at full width cut to 2 layers through the legacy
     engine (one cached_jit graph) and the paged engine (a captured tick
     a bucket) with `sharder=`, against the NULL engines: the same tokens,
     the same B4 / B8 / B2 launches.  The group is destroyed at the end.
The launch counters are zeroed just before phase 4 and read just after
phase 6 (the compiler's main path), and zeroed and read around each engine
run of phases 7, 9, 10 and 11 (the serving paths), each full-width run of
phases 8 and 10 (the training paths), phase 9's whisper decode steps and
phase 10's traced forward and atom, around each of phase 12's runs
under "auto", and around each of phase 13's runs.  The second-to-last line is the
per-kernel JSON summary: one row per kernel and main-path shape, its
`launches` taken from the run of the path that row belongs to (for the
whisper rows of fused_mlp and fused_mlp_bwd, only that run's launches at
the row's input rows), with every run's own count beside it.  The last
line is {"ok": true, "device": ...}.
"""
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# torch.compile's caches stay inside the checkout
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import apps  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import KernelConfig, _build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import (TrainConfig, compile_train_step,  # noqa: E402
                               make_train_state, make_train_step)
from repro_torch.tree import flatten, leaves  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_plain,  # noqa: E402
                                                 flash_decode_plain)
from repro_torch.kernels import fused_mlp as FM  # noqa: E402
from repro_torch.kernels.fused_mlp import (F32_BLOCK_H, SMALL_M,  # noqa: E402
                                           fused_mlp_bwd_plain,
                                           fused_mlp_fwd_plain,
                                           fused_mlp_swiglu_bwd_plain,
                                           fused_mlp_swiglu_fwd_plain)
from repro_torch.kernels.ref import DACTS  # noqa: E402
from repro_torch.kernels.paged_attention import paged_flash_decode_plain  # noqa: E402
from repro_torch.kernels.queue_reduce import queue_reduce_plain, sequential_fold  # noqa: E402
from repro_torch.kernels.ref import paged_rows, to_e4m3  # noqa: E402
from repro_torch.models import encdec, get_model, zoo  # noqa: E402
from repro_torch.models import atoms as model_atoms  # noqa: E402
from repro_torch.models import lm as model_lm  # noqa: E402
from repro_torch.models.atoms import paged_decode_atom  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.serve import (AsyncServingEngine, CapturedTick,  # noqa: E402
                               PagedKVExecutor, PagedServingEngine, ServeConfig,
                               ServingEngine, paged_tick)
from repro_torch.serve.engine import serve_step  # noqa: E402
from repro_torch.core.cudagraph import graph_stats  # noqa: E402
from repro_torch.core import H100, calibrate  # noqa: E402
from repro_torch.core.executor import verdict_cache  # noqa: E402
from repro_torch.core.compiler import _pipelined_members  # noqa: E402
from repro_torch.core.lower import MEASURE_MARGIN, lower_pipelines, target_for  # noqa: E402
from repro_torch.kernels.flash_attention import decode_tile_candidates  # noqa: E402

PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense FLOP/s, H100 SXM
HBM = 3.35e12                                           # B/s
# bf16: 8 mantissa bits, sums of up to 14336 products in another order, and
# hidden tiles rounded to bf16 where the reference rounds too; f32: the
# reference tests' 2e-4.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# ...and, since an elementwise bound loose against small outputs (causal
# attention averages up to 2048 rows of v, so its outputs are ~0.05) could
# miss a skipped tile, a bound on the relative error ||got - want|| / ||want||.
REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# Whole-model agreement in bf16.  The modes round at different places (bsp
# rounds every op's output to bf16, the kernels keep f32 inside, the
# vertical program lets the compiler keep f32 between fused ops), so
# elementwise bounds would test rounding luck.  Each mode is instead held to
# an f32 run of the same graph and weights: its relative error
# ||out - ref|| / ||ref|| may be at most twice bsp's own (+1e-3), and at
# most MODEL_TOL against bsp itself.
MODEL_TOL = 5e-2
# The backward kernels' bf16 weight gradients against the plain version's
# own spread under reordered sums (see `check`): how many times that spread
# they may differ, and over how many reorderings it is taken.
FLOOR_FACTOR = 2.0
N_REORDER = 3
SOURCES = {
    "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                  "src/repro/kernels/fused_mlp.py:100"),
    "fused_mlp_swiglu": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                         "src/repro/kernels/fused_mlp.py:124"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:118"),
    "queue_reduce": ("src/repro_torch/kernels/csrc/queue_reduce.cu",
                     "src/repro/kernels/queue_reduce.py:57"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention.py:210"),
    "paged_flash_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:61"),
    "fused_mlp_bwd": ("src/repro_torch/kernels/csrc/fused_mlp_bwd.cu",
                      "src/repro/kernels/fused_mlp.py:318"),
    "fused_mlp_swiglu_bwd": ("src/repro_torch/kernels/csrc/fused_mlp_bwd.cu",
                             "src/repro/kernels/fused_mlp.py:264"),
}
# summary rows: phase-3 case -> (kernel, the path whose run counts its
# launches, the shape its times were taken at[, the kernel's input rows, where
# the path runs it at several: only those launches are the row's])
SUMMARY = {
    "fused_mlp": ("fused_mlp", "compiler", "x (524288, 256) -> 256 -> 256, relu"),
    "fused_mlp_swiglu": ("fused_mlp_swiglu", "compiler",
                         "x (8192, 4096) -> 14336 -> 4096, identity"),
    "flash_attention": ("flash_attention", "compiler", "q/k/v (4, 32, 2048, 128), causal"),
    "queue_reduce": ("queue_reduce", "compiler", "(16, 1024, 256) sum over axis 0"),
    "flash_decode": ("flash_decode", "serve_gather",
                     "q (8, 40, 1, 128), k/v (8, 10, 512, 128), ragged valid"),
    "paged_flash_decode": ("paged_flash_decode", "serve_native",
                           "q (8, 40, 1, 128), pools (8208, 40, 1, 10, 128), "
                           "tables (8, 32)"),
    "fused_mlp_swiglu_decode": ("fused_mlp_swiglu", "serve_native",
                                "x (8, 5120) -> 17920 -> 5120, silu (small-M form)"),
    "queue_reduce_decode_fold": ("queue_reduce", "serve_native",
                                 "B2's decode partials (n, 8, 5120) f32 -> bf16"),
    "queue_reduce_train_fold": ("queue_reduce", "train_gemma3",
                                "B7's dX partials (18, 8192, 1152) f32 -> bf16"),
    "fused_mlp_swiglu_train": ("fused_mlp_swiglu", "train_gemma3",
                               "x (8192, 1152) -> 6912 -> 1152, silu"),
    "fused_mlp_swiglu_bwd": ("fused_mlp_swiglu_bwd", "train_gemma3",
                             "x, dy (8192, 1152), 1152 -> 6912 -> 1152, silu"),
    "fused_mlp_bwd": ("fused_mlp_bwd", "train_whisper",
                      "x, dy (12000, 768), 768 -> 3072 -> 768, gelu (encoder)", 8 * 1500),
    "fused_mlp_bwd_dec": ("fused_mlp_bwd", "train_whisper",
                          "x, dy (3584, 768), 768 -> 3072 -> 768, gelu (decoder)", 8 * 448),
    "fused_mlp_train_enc": ("fused_mlp", "train_whisper",
                            "x (12000, 768) -> 3072 -> 768, gelu (encoder)", 8 * 1500),
    "fused_mlp_train_dec": ("fused_mlp", "train_whisper",
                            "x (3584, 768) -> 3072 -> 768, gelu (decoder)", 8 * 448),
    # phase 9
    "fused_mlp_swiglu_hymba": ("fused_mlp_swiglu", "serve_hymba_native",
                               "x (8, 1600) -> 5504 -> 1600, silu (small-M form), hymba-1.5b"),
    "queue_reduce_hymba_fold": ("queue_reduce", "serve_hymba_native",
                                "B2's hymba partials (n, 8, 1600) f32 -> bf16"),
    "paged_flash_decode_hymba": ("paged_flash_decode", "serve_hymba_native",
                                 "q (8, 25, 1, 64), pools (8208, 32, 1, 5, 64), tables (8, 32), "
                                 "G = 5"),
    "flash_decode_hymba": ("flash_decode", "serve_hymba_gather",
                           "q (8, 25, 1, 64), k/v (8, 5, 512, 64), ragged valid, G = 5"),
    "fused_mlp_swiglu_maverick": ("fused_mlp_swiglu", "serve_maverick_native",
                                  "x (8, 5120) -> 16384 -> 5120, silu (small-M form), "
                                  "llama4-maverick dense layer"),
    "queue_reduce_maverick_fold": ("queue_reduce", "serve_maverick_native",
                                   "B2's maverick partials (n, 8, 5120) f32 -> bf16"),
    "paged_flash_decode_maverick": ("paged_flash_decode", "serve_maverick_native",
                                    "q (8, 40, 1, 128), pools (8208, 1, 2, 8, 128), "
                                    "tables (8, 32), G = 5"),
    "flash_decode_maverick": ("flash_decode", "serve_maverick_gather",
                              "q (8, 40, 1, 128), k/v (8, 8, 512, 128), ragged valid, G = 5"),
    "fused_mlp_whisper_decode": ("fused_mlp", "whisper_decode",
                                 "x (8, 768) -> 3072 -> 768, gelu (small-M form), "
                                 "whisper-small decoder"),
    "flash_decode_whisper": ("flash_decode", "whisper_decode",
                             "q (8, 12, 1, 64), k/v (8, 12, 448, 64), valid 16, G = 1"),
    # phase 7's float8 KV cache run
    "flash_decode_e4m3": ("flash_decode", "serve_fp8_gather",
                          "q (8, 40, 1, 128) bf16, k/v (8, 10, 512, 128) e4m3, ragged valid"),
    "paged_flash_decode_e4m3": ("paged_flash_decode", "serve_fp8_native",
                                "q (8, 40, 1, 128) bf16, pools (8208, 40, 1, 10, 128) e4m3, "
                                "tables (8, 32)"),
}
# phase 7: phi3-medium-14b behind the paged engine
SERVE_ARCH = "phi3-medium-14b"
SERVE_CONFIG = dict(max_len=512, batch=8, block_size=16, prefill_chunk=16,
                    num_blocks=512, max_new_tokens=32)
SERVE_REQUESTS = 16
# phase-3 cases timed with a cold L2 (cuda_ms): the decode kernels, whose
# inputs would otherwise stay cached between timed calls
E4M3_CASES = {"flash_decode_e4m3", "flash_decode_e4m3_s4096", "flash_decode_hymba_e4m3",
              "paged_flash_decode_e4m3", "paged_flash_decode_hymba_e4m3"}
COLD_CASES = E4M3_CASES | {"flash_decode", "flash_decode_s4096", "paged_flash_decode",
              "fused_mlp_swiglu_decode", "fused_mlp_swiglu_hymba", "fused_mlp_swiglu_maverick",
              "fused_mlp_whisper_decode", "paged_flash_decode_hymba",
              "paged_flash_decode_maverick", "flash_decode_hymba", "flash_decode_maverick",
              "flash_decode_whisper"}
# phase 9: the families beyond dense, each served (or decoded) at full width
HYMBA, MAVERICK, XLSTM, WHISPER = ("hymba-1.5b", "llama4-maverick-400b-a17b", "xlstm-350m",
                                   "whisper-small")
# maverick's depth cut to one layer group: its dense layer and its MoE layer
# (moe_period 2); the whole model (~800 GB in bf16) fits no single card
MAVERICK_LAYERS = 2
# hymba's depth cut to a quarter of its 32 layers (every layer is alike:
# attention heads beside an SSM) to keep the whole run near its earlier
# length (16 until phase 12 came)
HYMBA_LAYERS = 8
MAVERICK_REQUESTS = 8
XLSTM_CONFIG = dict(SERVE_CONFIG, batch=4)
XLSTM_REQUESTS = 8
# whisper decode: 8 x 1500 stub frames encoded, then 16 decode steps against
# a self-attention cache of the model's 448 trained positions
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_MAX_LEN, WHISPER_STEPS = 8, 1500, 448, 16


def ptxas_entries(log: str) -> list[str]:
    """One line per kernel of an nvcc -Xptxas -v log: the kernel's name with
    its template arguments, its registers and its spills."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled, spill = ln.split("'")[1], ""
            m = re.search(r"([a-z_]+_(?:kernel|wgmma))I(.*?)EEv", mangled)
            if m:
                codes = {"f": "f32", "Lb1E": "true", "Lb0E": "false", "13__nv_fp8_e4m3": "e4m3"}
                args = [codes.get(t, "bf16" if "bfloat16" in t or t.startswith("S") else t[2:-1])
                        for t in re.findall(r"13__nv_fp8_e4m3|13__nv_bfloat16|S\d*_|f|Lb[01]E"
                                            r"|Li\d+E", m.group(2))]
                name = f"{m.group(1)}<{','.join(args)}>"
            else:
                plain = re.search(r"\d+([a-z_]+_(?:kernel|wgmma))E", mangled)
                name = plain.group(1) if plain else mangled
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; {spill}")
            name = None
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Mean device milliseconds per call over `reps` calls after one
    warm-up, each call between its own pair of CUDA events.  A sleep kernel
    first holds the device while the host queues every call, so host launch
    time never shows in the events.  With `cold`, a 64 MB write flushes the
    50 MB L2 cache before each call (for inputs that would otherwise stay
    cached between calls, which the serving loop never sees), and at least
    20 calls are timed."""
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold else None
    events = []
    torch.cuda._sleep(100_000_000)
    for _ in range(max(reps, 20) if cold else reps):
        if cold:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / len(events)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise AssertionError(f"shape {tuple(g.shape)} vs {tuple(w.shape)} "
                             f"or non-finite values")
    return ((g - w).norm() / w.norm()).item()


def worst(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / (tol + tol * |want|)):
    the second is <= 1 exactly when allclose(rtol=atol=tol) holds."""
    d = (got.float() - want.float()).abs()
    ratio = d / (tol + tol * want.float().abs())
    return d.max().item(), ratio.max().item()


def check(name: str, got, want, dtype, floors=None) -> tuple[float, float]:
    """(max |got - want|, relative error), raising if either bound of
    `dtype` is broken; for a tuple of outputs (the backward kernels'
    gradients) every output is held and the worst of each is returned.

    `floors`, where given (the backward kernels' weight gradients in
    bfloat16), are the plain version computed again with its contractions
    summed in other orders (see `reordered`).  Those kernels round t, da,
    dg, du to bf16 as the plain version does; an f32 difference of one ulp
    in a hidden value flips its bf16 rounding and moves a whole row of a
    weight gradient by ulp(t) * |dy|, whatever that gradient element's own
    size, so the plain version breaks atol = rtol = 2e-2 against a
    reordering of itself.  There the kernel is held to the plain version's
    own disagreement: its elementwise ratio may be at most FLOOR_FACTOR
    times the worst of the reorderings' (or <= 1), its max |err| at most
    FLOOR_FACTOR times the larger of theirs and one ulp of the largest
    output (the max |err| of either is that output's own rounding: one ulp
    of whichever large element flipped), and the relative-norm bound is
    unchanged."""
    if isinstance(got, tuple):
        errs = [check(f"{name}[{i}]", g, w, dtype,
                      None if floors is None or floors[0][i] is None
                      else [f[i] for f in floors])
                for i, (g, w) in enumerate(zip(got, want))]
        return max(e for e, _ in errs), max(r for _, r in errs)
    tol = TOL[dtype]
    rel = rel_err(got, want)                  # checks shape and finiteness
    err, ratio = worst(got, want, tol)
    err_limit, ratio_limit = math.inf, 1.0
    if floors is not None:
        f_err, f_ratio = (max(v) for v in zip(*(worst(f, want, tol) for f in floors)))
        top = want.float().abs().max().item()
        ulp = torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top)) if top else 0.0
        err_limit = FLOOR_FACTOR * max(f_err, ulp)
        ratio_limit = max(1.0, FLOOR_FACTOR * f_ratio)
        print(f"{name}: max |err| {err:.4g}, ratio {ratio:.3f}; the plain version against "
              f"{len(floors)} reorderings of itself: max |err| {f_err:.4g}, ratio "
              f"{f_ratio:.3f}; limits {err_limit:.4g}, {ratio_limit:.3f}", flush=True)
    if err > err_limit or ratio > ratio_limit or rel > REL_TOL[dtype]:
        raise AssertionError(f"{name}: max |err| {err:.4g} (limit {err_limit:.4g}), "
                             f"elementwise ratio {ratio:.3f} against atol=rtol={tol} "
                             f"(limit {ratio_limit:.3f}), relative error {rel:.3g} "
                             f"(limit {REL_TOL[dtype]})")
    return err, rel


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def tiled_partials(dtype, x, w1, wu, w2, act) -> dict:
    """{"partial_bytes": the .nbytes of the f32 partials the tiled bf16
    forward writes for these operands (0 where it writes y itself)}, from
    one unfolded launch; {} in float32."""
    if dtype != torch.bfloat16:
        return {}
    raw = FM.forward_in_form("tiled", x, w1, wu, w2, act, fold=False)
    return {"partial_bytes": raw.nbytes if raw.dtype == torch.float32 else 0}


def fold_case(name, x, out_dtype, **extra):
    """A phase-3 case of queue_reduce folding x (N, R, C) into out_dtype by
    sum, first held bitwise to the sequential f32 fold on the card."""
    if not torch.equal(K.queue_reduce(x, out_dtype=out_dtype), sequential_fold(x, out_dtype)):
        raise AssertionError(f"{name}[{x.dtype}]: queue_reduce differs from the sequential "
                             f"f32 fold")
    print(f"{name}[{x.dtype} -> {out_dtype}]: bitwise equal to the sequential f32 fold",
          flush=True)
    return (name,
            lambda: K.queue_reduce(x, out_dtype=out_dtype),
            lambda: queue_reduce_plain(x, "sum", out_dtype),
            lambda: torch.sum(x, dim=0),
            float(x.numel()), nbytes(x) + x[0].numel() * torch.finfo(out_dtype).bits // 8,
            None, extra)


def kernel_cases(gen, dtype):
    """(name, kernel call, plain call, library call, flops, bytes[, reorder,
    extra]) at the main path's shapes."""
    M, D, H = 8192, 4096, 14336                     # Llama3-8B FFN, batch 4 x 2048
    x = randn(gen, M, D, dtype=dtype)
    wg, wu = (randn(gen, D, H, dtype=dtype, scale=D ** -0.5) for _ in range(2))
    wd = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
    yield ("fused_mlp_swiglu",
           lambda: K.fused_mlp_swiglu_fwd(x, wg, wu, wd, act="identity"),
           lambda: fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, "identity"),
           lambda: ((x @ wg) * (x @ wu)) @ wd,
           2.0 * M * D * H * 2 + 2.0 * M * H * D, nbytes(x, wg, wu, wd, x), None,
           tiled_partials(dtype, x, wg, wu, wd, "identity"))
    del x, wg, wu, wd
    R, DI, HN = 4096 * 128, 256, 256                 # NeRF: 4096 rays x 128 samples
    x = randn(gen, R, DI, dtype=dtype)
    w1 = randn(gen, DI, HN, dtype=dtype, scale=DI ** -0.5)
    w2 = randn(gen, HN, HN, dtype=dtype, scale=HN ** -0.5)
    yield ("fused_mlp",
           lambda: K.fused_mlp_fwd(x, w1, w2, act="relu"),
           lambda: fused_mlp_fwd_plain(x, w1, w2, "relu"),
           lambda: torch.relu(x @ w1) @ w2,
           2.0 * R * DI * HN + 2.0 * R * HN * HN, nbytes(x, w1, w2, x), None,
           tiled_partials(dtype, x, w1, None, w2, "relu"))
    del x, w1, w2
    B, NH, S, HD = 4, 32, 2048, 128
    q, k, v = (randn(gen, B, NH, S, HD, dtype=dtype) for _ in range(3))
    yield ("flash_attention",
           lambda: K.flash_attention(q, k, v, causal=True),
           lambda: flash_attention_plain(q, k, v, causal=True),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
           4.0 * B * NH * HD * (S * (S + 1) / 2), nbytes(q, k, v, q))
    del q, k, v
    part = randn(gen, 16, 1024, 256, dtype=dtype)     # phase 6's fan-in partials
    yield fold_case("queue_reduce", part, dtype)
    del part
    # the Llama FFN's f32 partials (bf16: one per cluster of the tiled
    # form, as its source counts them; f32: one per hidden chunk) folded to
    # the output dtype -- queue_reduce's other main-path shape
    n_split = (FM.tiled_geometry(H).partials if dtype == torch.bfloat16
               else -(-H // F32_BLOCK_H))
    fold = randn(gen, n_split, M, D, dtype=torch.float32)
    yield fold_case("queue_reduce_mlp_fold", fold, dtype)
    del fold
    yield from decode_cases(gen, dtype)
    yield from family_cases(gen, dtype)
    yield from train_cases(gen, dtype)


def swiglu_bwd_chain(x, wg, wu, wd, dy):
    """The backward of (silu(x @ wg) * (x @ wu)) @ wd as a chain of cuBLAS
    GEMMs and elementwise ops with the hidden tensors through HBM: the
    yardstick (no single PyTorch call computes an MLP backward)."""
    g, u = x @ wg, x @ wu
    sg = F.silu(g)
    dt = dy @ wd.T
    dg, du = dt * u * DACTS["silu"](g), dt * sg
    return (dg @ wg.T + du @ wu.T, x.T @ dg, x.T @ du, (sg * u).T @ dy)


def mlp_bwd_chain(x, w1, w2, dy):
    """The backward of gelu(x @ w1) @ w2 as a cuBLAS chain (see above)."""
    pre = x @ w1
    da = (dy @ w2.T) * DACTS["gelu"](pre)
    return (da @ w1.T, x.T @ da, F.gelu(pre, approximate="tanh").T @ dy)


def reordered(plain, x, ws, dy, gen):
    """N_REORDER times, `plain`'s weight gradients with the rows and the
    input and output features permuted before and the features restored
    after: the same function, every GEMM's f32 sum taken in another order
    (the floors `check` holds those gradients to).  dX, a sum over H of
    small weights times hidden values, keeps the plain elementwise bound:
    its slot is None."""
    *w_in, w_out = ws
    outs = []
    for _ in range(N_REORDER):
        pm = torch.randperm(x.shape[0], generator=gen, device=x.device)
        pi = torch.randperm(x.shape[1], generator=gen, device=x.device)
        po = torch.randperm(dy.shape[1], generator=gen, device=x.device)
        ii, io = torch.argsort(pi), torch.argsort(po)
        _, *dw_in, dw_out = plain(x[pm][:, pi], *(w[pi] for w in w_in), w_out[:, po],
                                  dy[pm][:, po])
        outs.append((None, *(d[ii] for d in dw_in), dw_out[:, io]))
    return outs


def bwd_parts(x, w1, wu, w2, dy, act) -> dict:
    """The bf16 backward's two kernels apart, for phase 3's row: dx_ms and
    dw_ms time the dX and the dW kernel alone (their f32 partials
    unfolded), partial_bytes is the .nbytes of the partials they wrote (dX's
    from the dX kernel, dW's from the dW kernel), which the folds read
    again."""
    dx_part = FM.bwd_bf16(x, w1, wu, w2, dy, act, parts=1)[0]
    dw_parts = FM.bwd_bf16(x, w1, wu, w2, dy, act, parts=2)[1:]
    partial_bytes = dx_part.nbytes + sum(t.nbytes for t in dw_parts)
    del dx_part, dw_parts
    return {"dx_ms": lambda: FM.bwd_bf16(x, w1, wu, w2, dy, act, parts=1),
            "dw_ms": lambda: FM.bwd_bf16(x, w1, wu, w2, dy, act, parts=2),
            "partial_bytes": partial_bytes}


def train_cases(gen, dtype):
    """Phase 8's MLP kernels at its shapes: gemma3-1b's FFN over 4 x 2048
    tokens (B2 forward, B7 backward) and whisper-small's over the encoder's
    8 x 1500 and the decoder's 8 x 448 rows (B6 backward, B1 forward).
    float32 runs at fewer rows.  Operations count the GEMMs the function needs (B7: g, u, dt, two
    for dX, three for dW = 8; B6: pre, dt, one for dX, two for dW = 5), not
    the kernels' own: they recompute g, u and dt (B6: pre and dt) in both of
    their kernels, 11 GEMMs (B6: 7)."""
    D, H = 1152, 6912
    M = 8192 if dtype == torch.bfloat16 else 1024
    x, dy = randn(gen, M, D, dtype=dtype), randn(gen, M, D, dtype=dtype)
    wg, wu = (randn(gen, D, H, dtype=dtype, scale=D ** -0.5) for _ in range(2))
    wd = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
    gemm = 2.0 * M * D * H
    yield ("fused_mlp_swiglu_train",
           lambda: K.fused_mlp_swiglu_fwd(x, wg, wu, wd, act="silu"),
           lambda: fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, "silu"),
           lambda: (F.silu(x @ wg) * (x @ wu)) @ wd,
           3 * gemm, nbytes(x, wg, wu, wd, x), None,
           tiled_partials(dtype, x, wg, wu, wd, "silu"))
    extra = {}
    if dtype == torch.bfloat16:
        # the two kernels of the call apart (their f32 partials unfolded),
        # and the bytes of the partials they wrote (which the folds read
        # again): dX's from the dX kernel alone, dW's from the dW kernel's
        extra = bwd_parts(x, wg, wu, wd, dy, "silu")
    yield ("fused_mlp_swiglu_bwd",
           lambda: K.fused_mlp_swiglu_bwd(x, wg, wu, wd, dy, act="silu"),
           lambda: fused_mlp_swiglu_bwd_plain(x, wg, wu, wd, dy, "silu"),
           lambda: swiglu_bwd_chain(x, wg, wu, wd, dy),
           8 * gemm, 2 * nbytes(x, wg, wu, wd, dy) - nbytes(dy),
           lambda: reordered(lambda *a: fused_mlp_swiglu_bwd_plain(*a, "silu"), x,
                             (wg, wu, wd), dy, gen), extra)
    del x, dy, wg, wu, wd
    # the deepest fold the training run makes: B7's dX partials at these
    # widths (bf16: one per cluster of hidden chunks, as its source counts
    # them; f32: one per hidden chunk of the WMMA kernel)
    n_fold = (FM.swiglu_bwd_partials(M, H)[0] if dtype == torch.bfloat16
              else -(-H // FM.F32_BWD_BLOCK_H))
    fold = randn(gen, n_fold, M, D, dtype=torch.float32)
    yield fold_case("queue_reduce_train_fold", fold, dtype)
    del fold
    D, H = 768, 3072
    for name, rows in (("fused_mlp_bwd", 8 * 1500), ("fused_mlp_bwd_dec", 8 * 448)):
        M = rows if dtype == torch.bfloat16 else rows // 8
        x, dy = randn(gen, M, D, dtype=dtype), randn(gen, M, D, dtype=dtype)
        w1 = randn(gen, D, H, dtype=dtype, scale=D ** -0.5)
        w2 = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
        yield (name,
               lambda: K.fused_mlp_bwd(x, w1, w2, dy, act="gelu"),
               lambda: fused_mlp_bwd_plain(x, w1, w2, dy, "gelu"),
               lambda: mlp_bwd_chain(x, w1, w2, dy),
               5 * 2.0 * M * D * H, 2 * nbytes(x, w1, w2, dy) - nbytes(dy),
               lambda: reordered(lambda *a: fused_mlp_bwd_plain(*a, "gelu"), x, (w1, w2),
                                 dy, gen),
               bwd_parts(x, w1, None, w2, dy, "gelu") if dtype == torch.bfloat16 else {})
        del dy
        # B1, the forward of the same blocks (encoder; decoder and its remat)
        yield ("fused_mlp_train_" + ("enc" if rows == 8 * 1500 else "dec"),
               lambda: K.fused_mlp_fwd(x, w1, w2, act="gelu"),
               lambda: fused_mlp_fwd_plain(x, w1, w2, "gelu"),
               lambda: F.gelu(x @ w1, approximate="tanh") @ w2,
               2 * 2.0 * M * D * H, nbytes(x, w1, w2, x), None,
               tiled_partials(dtype, x, w1, None, w2, "gelu"))
        del x, w1, w2


def function_grads() -> None:
    """Each autograd Function's gradients on the card (forward kernel,
    backward kernel) against torch.autograd of the plain forward, float32,
    at a mid-size shape."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for gated, (M, D, H, act) in ((True, (2048, 1152, 6912, "silu")),
                                  (False, (1500, 768, 3072, "gelu"))):
        ws = [randn(gen, D, H, dtype=torch.float32, scale=D ** -0.5) for _ in range(1 + gated)]
        ws.append(randn(gen, H, D, dtype=torch.float32, scale=H ** -0.5))
        x = randn(gen, M, D, dtype=torch.float32)
        dy = randn(gen, M, D, dtype=torch.float32)
        ins = [t.requires_grad_() for t in (x, *ws)]
        fn, plain = ((K.mlp_swiglu, fused_mlp_swiglu_fwd_plain) if gated
                     else (K.mlp, fused_mlp_fwd_plain))
        before = K.launch_counts()
        got = torch.autograd.grad(fn(*ins, act=act), ins, dy)
        kern = "fused_mlp_swiglu_bwd" if gated else "fused_mlp_bwd"
        if K.launch_counts()[kern] != before[kern] + 1:
            raise AssertionError(f"{kern} was not launched by the Function's backward")
        want = torch.autograd.grad(plain(*ins, act), ins, dy)
        err, rel = check(f"{fn.__name__} grads", tuple(got), tuple(want), torch.float32)
        print(f"function {fn.__name__} ({M}, {D}->{H}->{D}) {act}: gradients vs autograd "
              f"of the plain forward, max |err| {err:.3g}, rel {rel:.3g} (f32)", flush=True)


def decode_cases(gen, dtype):
    """Phase 7's decode kernels at phi3-medium-14b's shapes: 8 slots, 40
    query heads over 10 kv heads of 128, ragged valid lengths.  Bounds
    count the rows the valid lengths cover (what these inputs need)."""
    cfg = get_config(SERVE_ARCH)
    B, HQ, HKV, HD = SERVE_CONFIG["batch"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    esize = torch.finfo(dtype).bits // 8
    rng = np.random.default_rng(5)
    for s_len, name in ((512, "flash_decode"), (4096, "flash_decode_s4096")):
        q = randn(gen, B, HQ, 1, HD, dtype=dtype)
        k, v = (randn(gen, B, HKV, s_len, HD, dtype=dtype) for _ in range(2))
        valid = torch.from_numpy(rng.integers(1, s_len + 1, B).astype(np.int32)).to("cuda")
        mask = (torch.arange(s_len, device="cuda")[None, :] < valid[:, None])[:, None, None, :]
        rows = int(valid.clamp(max=s_len).sum())
        yield (name,
               lambda: K.flash_decode(q, k, v, valid_len=valid),
               lambda: flash_decode_plain(q, k, v, valid_len=valid),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True),
               4.0 * rows * HQ * HD, 2 * nbytes(q) + 2 * rows * HKV * HD * esize)
        del q, k, v
    # the engine's pool layout (P, G=40, A=1, Hkv, D) and block tables: each
    # slot owns distinct pages up to its valid length, the null page after
    bs, n_blocks = SERVE_CONFIG["block_size"], SERVE_CONFIG["num_blocks"]
    v_blocks = SERVE_CONFIG["max_len"] // bs
    pool = ((n_blocks + 1) * bs, cfg.n_layers, 1, HKV, HD)
    kp, vp = randn(gen, *pool, dtype=dtype), randn(gen, *pool, dtype=dtype)
    q = randn(gen, B, HQ, 1, HD, dtype=dtype)
    valid_np = rng.integers(1, v_blocks * bs + 1, B)
    tables_np = rng.permutation(np.arange(1, n_blocks + 1))[:B * v_blocks].reshape(B, v_blocks)
    tables_np[np.arange(v_blocks)[None, :] >= -(-valid_np // bs)[:, None]] = 0
    tables = torch.from_numpy(tables_np.astype(np.int32)).to("cuda")
    valid = torch.from_numpy(valid_np.astype(np.int32)).to("cuda")
    layer = (cfg.n_layers - 1, 0)
    got = K.paged_flash_decode(q, kp, vp, tables, valid_len=valid, block_size=bs, layer=layer)
    rows_idx = paged_rows(tables, bs)
    ck = kp[rows_idx, layer[0], layer[1]].transpose(1, 2).contiguous()
    cv = vp[rows_idx, layer[0], layer[1]].transpose(1, 2).contiguous()
    if not torch.equal(got, K.flash_decode(q, ck, cv, valid_len=valid, block_s=256)):
        raise AssertionError(f"paged_flash_decode[{dtype}] differs from gather + "
                             f"flash_decode at the same chunk size")
    print(f"paged_flash_decode[{dtype}] bitwise equal to gather + flash_decode", flush=True)
    del ck, cv
    rows = int(valid.sum())
    yield ("paged_flash_decode",
           lambda: K.paged_flash_decode(q, kp, vp, tables, valid_len=valid,
                                        block_size=bs, layer=layer),
           lambda: paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                            block_size=bs, layer=layer),
           None,
           4.0 * rows * HQ * HD,
           2 * nbytes(q) + 2 * rows * HKV * HD * esize + nbytes(tables, valid))
    del kp, vp
    # the FFN at phase 7's decode shape: M = the slot batch
    D, H = cfg.d_model, cfg.d_ff
    x = randn(gen, B, D, dtype=dtype)
    wg, wu = (randn(gen, D, H, dtype=dtype, scale=D ** -0.5) for _ in range(2))
    wd = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
    # what the small-M kernel writes for the fold, as it wrote it
    fold = FM.forward_in_form("small_m", x, wg, wu, wd, "silu", fold=False)
    plan, _ = FM.small_m_plan(0, D, H, D, _build.DTYPE_CODES[dtype], True)
    partial_bytes = fold.nbytes if fold.dtype == torch.float32 else 0
    print(f"small-M form at ({B}, {D}->{H}->{D}) {dtype}: clusters of {plan.cs} blocks, "
          f"output {tuple(fold.shape)} {fold.dtype}, {partial_bytes} bytes of f32 partials "
          f"for queue_reduce", flush=True)
    yield ("fused_mlp_swiglu_decode",
           lambda: K.fused_mlp_swiglu_fwd(x, wg, wu, wd, act="silu"),
           lambda: fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, "silu"),
           lambda: (F.silu(x @ wg) * (x @ wu)) @ wd,
           2.0 * B * D * H * 2 + 2.0 * B * H * D, nbytes(x, wg, wu, wd, x), None,
           {"partial_bytes": partial_bytes})
    del x, wg, wu, wd
    if not partial_bytes:
        print("the small-M form writes y itself at this shape: no decode fold", flush=True)
        return
    # the fold those partials take in the tick, right after B2 wrote them
    # (so timed with a warm L2)
    n_part = fold.shape[0]
    yield fold_case("queue_reduce_decode_fold", fold, dtype,
                    shape=f"({n_part}, {B}, {D}) f32 -> ({B}, {D}) {str(dtype)[6:]}")


E4M3 = torch.float8_e4m3fn
E4M3_YARDSTICK = "K/V .to(bfloat16) + scaled_dot_product_attention"


def e4m3_cases(gen):
    """B4 and B8 reading e4m3 K/V beside a bf16 q (the float8 KV cache):
    at phase 7's decode shape (8 slots, 40 query / 10 kv heads of 128, S =
    512, ragged), at S = 4096, and at hymba-1.5b's (25 / 5 heads of 64, G =
    5), each held to its e4m3 plain version.  K/V are drawn in f32 and cast
    as the cache is written (`to_e4m3`).  Bounds count 1-byte K/V rows of
    the valid lengths.  No PyTorch call takes e4m3 K/V: the yardstick is the
    rows cast to bf16 plus SDPA, timed as one (the paged rows gathered
    through the tables first)."""
    rng = np.random.default_rng(15)
    B = SERVE_CONFIG["batch"]
    bs, n_blocks = SERVE_CONFIG["block_size"], SERVE_CONFIG["num_blocks"]
    v_blocks = SERVE_CONFIG["max_len"] // bs
    phi3, hymba = get_config(SERVE_ARCH), get_config(HYMBA)
    for name, cfg, s_len in (("flash_decode_e4m3", phi3, 512),
                             ("flash_decode_e4m3_s4096", phi3, 4096),
                             ("flash_decode_hymba_e4m3", hymba, 512)):
        HQ, HKV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = randn(gen, B, HQ, 1, HD, dtype=torch.bfloat16)
        k, v = (to_e4m3(randn(gen, B, HKV, s_len, HD, dtype=torch.float32)) for _ in range(2))
        valid = torch.from_numpy(rng.integers(1, s_len + 1, B).astype(np.int32)).to("cuda")
        mask = (torch.arange(s_len, device="cuda")[None, :] < valid[:, None])[:, None, None, :]
        rows = int(valid.sum())
        yield (name,
               lambda: K.flash_decode(q, k, v, valid_len=valid),
               lambda: flash_decode_plain(q, k, v, valid_len=valid),
               lambda: F.scaled_dot_product_attention(q, k.to(torch.bfloat16),
                                                      v.to(torch.bfloat16), attn_mask=mask,
                                                      enable_gqa=True),
               4.0 * rows * HQ * HD, 2 * nbytes(q) + 2 * rows * HKV * HD,
               None, {"library": E4M3_YARDSTICK})
        del q, k, v
    for name, cfg, n_g in (("paged_flash_decode_e4m3", phi3, phi3.n_layers),
                           ("paged_flash_decode_hymba_e4m3", hymba, 32)):
        HQ, HKV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        pool = ((n_blocks + 1) * bs, n_g, 1, HKV, HD)
        kp, vp = (to_e4m3(randn(gen, *pool, dtype=torch.bfloat16)) for _ in range(2))
        q = randn(gen, B, HQ, 1, HD, dtype=torch.bfloat16)
        valid_np = rng.integers(1, v_blocks * bs + 1, B)
        tables_np = rng.permutation(np.arange(1, n_blocks + 1))[:B * v_blocks].reshape(
            B, v_blocks)
        tables_np[np.arange(v_blocks)[None, :] >= -(-valid_np // bs)[:, None]] = 0
        tables = torch.from_numpy(tables_np.astype(np.int32)).to("cuda")
        valid = torch.from_numpy(valid_np.astype(np.int32)).to("cuda")
        layer = (n_g - 1, 0)
        got = K.paged_flash_decode(q, kp, vp, tables, valid_len=valid, block_size=bs, layer=layer)
        rows_idx = paged_rows(tables, bs)
        ck = kp[rows_idx, layer[0], layer[1]].transpose(1, 2).contiguous()
        cv = vp[rows_idx, layer[0], layer[1]].transpose(1, 2).contiguous()
        if not torch.equal(got, K.flash_decode(q, ck, cv, valid_len=valid, block_s=256)):
            raise AssertionError(f"{name} differs from gather + flash_decode at the same "
                                 f"chunk size")
        print(f"{name} bitwise equal to gather + flash_decode", flush=True)
        del ck, cv
        mask = (torch.arange(v_blocks * bs, device="cuda")[None, :]
                < valid[:, None])[:, None, None, :]
        rows = int(valid.sum())

        def yardstick():
            ck = kp[rows_idx, layer[0], layer[1]].transpose(1, 2).to(torch.bfloat16)
            cv = vp[rows_idx, layer[0], layer[1]].transpose(1, 2).to(torch.bfloat16)
            return F.scaled_dot_product_attention(q, ck, cv, attn_mask=mask, enable_gqa=True)
        yield (name,
               lambda: K.paged_flash_decode(q, kp, vp, tables, valid_len=valid,
                                            block_size=bs, layer=layer),
               lambda: paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                                block_size=bs, layer=layer),
               yardstick,
               4.0 * rows * HQ * HD,
               2 * nbytes(q) + 2 * rows * HKV * HD + nbytes(tables, valid),
               None, {"library": "pool rows gathered through the tables, " + E4M3_YARDSTICK})
        del kp, vp, q


def family_cases(gen, dtype):
    """Phase 9's kernels at the shapes its models give them, 8 slots: B2's
    small-M form at hymba-1.5b's FFN (1600 -> 5504 -> 1600; 1600 is no
    multiple of 128) and maverick's dense layer (5120 -> 16384 -> 5120),
    B1's at whisper-small's decoder (768 -> 3072 -> 768, gelu), each with
    its B5 fold where it leaves partials; B8 over hymba's pools (25 q / 5 kv
    heads of 64, 32 layers) and maverick's (40 / 8 of 128, a dense and a
    MoE site): 5 query heads per kv head in the kernels' 8-row bucket; B4 at
    hymba's and maverick's gather views (G = 5) and at whisper's
    self-attention cache (G = 1, D = 64).  Bounds count the rows the valid
    lengths cover."""
    B = SERVE_CONFIG["batch"]
    esize = torch.finfo(dtype).bits // 8
    for name, arch, gated, act in (("fused_mlp_swiglu_hymba", HYMBA, True, "silu"),
                                   ("fused_mlp_swiglu_maverick", MAVERICK, True, "silu"),
                                   ("fused_mlp_whisper_decode", WHISPER, False, "gelu")):
        cfg = get_config(arch)
        D, H = cfg.d_model, cfg.dense_d_ff or cfg.d_ff
        x = randn(gen, B, D, dtype=dtype)
        w1 = randn(gen, D, H, dtype=dtype, scale=D ** -0.5)
        wu = randn(gen, D, H, dtype=dtype, scale=D ** -0.5) if gated else None
        w2 = randn(gen, H, D, dtype=dtype, scale=H ** -0.5)
        fold = FM.forward_in_form("small_m", x, w1, wu, w2, act, fold=False)
        partial_bytes = fold.nbytes if fold.dtype == torch.float32 else 0
        print(f"small-M form at ({B}, {D}->{H}->{D}) {act} {dtype}: output "
              f"{tuple(fold.shape)} {fold.dtype}, {partial_bytes} bytes of f32 partials",
              flush=True)
        if gated:
            yield (name,
                   lambda: K.fused_mlp_swiglu_fwd(x, w1, wu, w2, act=act),
                   lambda: fused_mlp_swiglu_fwd_plain(x, w1, wu, w2, act),
                   lambda: (F.silu(x @ w1) * (x @ wu)) @ w2,
                   2.0 * B * D * H * 3, nbytes(x, w1, wu, w2, x), None,
                   {"partial_bytes": partial_bytes})
        else:
            yield (name,
                   lambda: K.fused_mlp_fwd(x, w1, w2, act=act),
                   lambda: fused_mlp_fwd_plain(x, w1, w2, act),
                   lambda: F.gelu(x @ w1, approximate="tanh") @ w2,
                   2.0 * B * D * H * 2, nbytes(x, w1, w2, x), None,
                   {"partial_bytes": partial_bytes})
        if partial_bytes and gated:
            yield fold_case(name.replace("fused_mlp_swiglu", "queue_reduce") + "_fold", fold,
                            dtype, shape=f"({fold.shape[0]}, {B}, {D}) f32 -> ({B}, {D}) "
                                         f"{str(dtype)[6:]}")
        del x, w1, wu, w2, fold
    rng = np.random.default_rng(9)
    bs, n_blocks = SERVE_CONFIG["block_size"], SERVE_CONFIG["num_blocks"]
    v_blocks = SERVE_CONFIG["max_len"] // bs
    for name, arch, n_g, n_a in (("paged_flash_decode_hymba", HYMBA, 32, 1),
                                 ("paged_flash_decode_maverick", MAVERICK, 1, 2)):
        cfg = get_config(arch)
        HQ, HKV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        pool = ((n_blocks + 1) * bs, n_g, n_a, HKV, HD)
        kp, vp = randn(gen, *pool, dtype=dtype), randn(gen, *pool, dtype=dtype)
        q = randn(gen, B, HQ, 1, HD, dtype=dtype)
        valid_np = rng.integers(1, v_blocks * bs + 1, B)
        tables_np = rng.permutation(np.arange(1, n_blocks + 1))[:B * v_blocks].reshape(
            B, v_blocks)
        tables_np[np.arange(v_blocks)[None, :] >= -(-valid_np // bs)[:, None]] = 0
        tables = torch.from_numpy(tables_np.astype(np.int32)).to("cuda")
        valid = torch.from_numpy(valid_np.astype(np.int32)).to("cuda")
        layer = (n_g - 1, n_a - 1)
        got = K.paged_flash_decode(q, kp, vp, tables, valid_len=valid, block_size=bs,
                                   layer=layer)
        rows_idx = paged_rows(tables, bs)
        ck = kp[rows_idx, layer[0], layer[1]].transpose(1, 2).contiguous()
        cv = vp[rows_idx, layer[0], layer[1]].transpose(1, 2).contiguous()
        if not torch.equal(got, K.flash_decode(q, ck, cv, valid_len=valid, block_s=256)):
            raise AssertionError(f"{name}[{dtype}] differs from gather + flash_decode at the "
                                 f"same chunk size")
        print(f"{name}[{dtype}] bitwise equal to gather + flash_decode", flush=True)
        del ck, cv
        rows = int(valid.sum())
        yield (name,
               lambda: K.paged_flash_decode(q, kp, vp, tables, valid_len=valid,
                                            block_size=bs, layer=layer),
               lambda: paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                                block_size=bs, layer=layer),
               None,
               4.0 * rows * HQ * HD,
               2 * nbytes(q) + 2 * rows * HKV * HD * esize + nbytes(tables, valid))
        del kp, vp, q
    for name, arch, s_len, fixed in (("flash_decode_hymba", HYMBA, SERVE_CONFIG["max_len"], None),
                                     ("flash_decode_maverick", MAVERICK, SERVE_CONFIG["max_len"],
                                      None),
                                     ("flash_decode_whisper", WHISPER, WHISPER_MAX_LEN,
                                      WHISPER_STEPS)):
        cfg = get_config(arch)
        HQ, HKV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = randn(gen, B, HQ, 1, HD, dtype=dtype)
        k, v = (randn(gen, B, HKV, s_len, HD, dtype=dtype) for _ in range(2))
        if fixed is None:
            valid = torch.from_numpy(rng.integers(1, s_len + 1, B).astype(np.int32)).to("cuda")
            rows = int(valid.sum())
            lens = valid[:, None]
        else:
            valid, rows, lens = fixed, B * fixed, fixed
        mask = (torch.arange(s_len, device="cuda")[None, :] < lens)[:, None, None, :]
        yield (name,
               lambda: K.flash_decode(q, k, v, valid_len=valid),
               lambda: flash_decode_plain(q, k, v, valid_len=valid),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True),
               4.0 * rows * HQ * HD, 2 * nbytes(q) + 2 * rows * HKV * HD * esize)
        del q, k, v


def phase_kernels() -> dict:
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(3)
        reps = 5 if dtype == torch.bfloat16 else 2
        cases = kernel_cases(gen, dtype)
        if dtype == torch.bfloat16:
            cases = itertools.chain(cases, e4m3_cases(gen))
        for name, kern, plain, lib, flops, nb, *rest in cases:
            reorder = rest[0] if rest else None
            extra = rest[1] if len(rest) > 1 else {}
            floors = reorder() if reorder and dtype == torch.bfloat16 else None
            err, rel = check(f"{name}[{dtype}]", kern(), plain(), dtype, floors)
            del floors
            cold = name in COLD_CASES
            t_op, t_by = flops / PEAK[dtype], nb / HBM
            if name.startswith("queue_reduce"):
                t_op = flops / PEAK[torch.float32]   # f32 adds, no tensor cores
            row = {"name": name, "dtype": str(dtype).split(".")[-1]
                   + (" q, float8_e4m3fn K/V" if name in E4M3_CASES else ""),
                   "max_abs_err": err, "tol": TOL[dtype], "rel_err": rel,
                   "rel_tol": REL_TOL[dtype],
                   "ms": cuda_ms(kern, reps, cold), "plain_ms": cuda_ms(plain, reps, cold),
                   "library_ms": None if lib is None else cuda_ms(lib, reps, cold),
                   "bound_ms": 1e3 * max(t_op, t_by),
                   "bound_by": "operations" if t_op >= t_by else "bytes"}
            for key, val in extra.items():
                row[key] = cuda_ms(val, reps, cold) if callable(val) else val
            print("kernel " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16:
                rows[name] = row
            torch.cuda.empty_cache()
        del gen
        torch.cuda.empty_cache()
    function_grads()
    mlp_forms()
    return rows


def mlp_forms() -> None:
    """B2's two forward forms at phi3-medium-14b's widths (5120 -> 17920 ->
    5120 silu, bf16) for the row counts a decode batch may have, timed with
    a cold L2 as the serving loop finds the weights: the small-M form (at
    most SMALL_M rows) and the tiled form, each held to the plain version,
    and the largest M at which the small-M form is the faster."""
    cfg = get_config(SERVE_ARCH)
    D, H = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(8)
    wg, wu = (randn(gen, D, H, dtype=torch.bfloat16, scale=D ** -0.5) for _ in range(2))
    wd = randn(gen, H, D, dtype=torch.bfloat16, scale=H ** -0.5)
    times = {}
    for m in (1, 8, 16, 32, 64, 128):
        x = randn(gen, m, D, dtype=torch.bfloat16)
        want = fused_mlp_swiglu_fwd_plain(x, wg, wu, wd, "silu")
        for form in ("small_m", "tiled"):
            if form == "small_m" and m > SMALL_M:
                continue
            run = lambda: FM.forward_in_form(form, x, wg, wu, wd, "silu")  # noqa: E731
            check(f"fused_mlp_swiglu {form} M={m}", run(), want, torch.bfloat16)
            times[form, m] = cuda_ms(run, 20, cold=True)
        print(f"B2 forms at M={m} ({D}->{H}->{D}, silu, bf16): small-M "
              f"{times.get(('small_m', m), float('nan')):.4f} ms, tiled "
              f"{times['tiled', m]:.4f} ms", flush=True)
    wins = [m for (form, m) in times if form == "small_m" and times[form, m] < times["tiled", m]]
    print(f"B2 crossover: the small-M form is faster at M in {wins} (it takes at most "
          f"{SMALL_M} rows; SMALL_M = {SMALL_M})", flush=True)
    if SMALL_M not in wins:
        raise AssertionError(f"the small-M form loses to the tiled form at M = {SMALL_M}: "
                             f"{times}; move SMALL_M to the crossover")


# ---------------------------------------------------------------------------
# phases 4-6: the compiler's main path
# ---------------------------------------------------------------------------

def f32(tree: dict) -> dict:
    return {k: f32(v) if isinstance(v, dict) else
            (v.float() if v.is_floating_point() else v) for k, v in tree.items()}


def run_modes(graph, feeds, params, modes, label, samples=None):
    """Compile and run `graph` in each mode three times captured (the
    first run builds and captures the plan, the others replay it; the
    first replay of a graph also uploads it) and once as the uncaptured
    walk (`CompiledApp.uncaptured()`); return the replays' outputs and
    per-run launch deltas, asserting that no run after the first builds
    anything, that every run launches alike and that the replay is bitwise
    the walk, and hold every mode's outputs to an f32 bsp run (see
    MODEL_TOL).  Each mode's app, and with it its graph, is dropped before
    the next mode is captured.  The compiles lower every kitsune site
    (lowering_policy="always"): these phases count each site's launches;
    phase 12 runs the default policy.  `samples` collects the bsp mode's
    timed replay as calibrate's (flops, bytes, programs, seconds)."""
    outs, deltas = {}, {}
    ref = repro_torch.compile(graph, mode="bsp", capture=False).run(f32(feeds),
                                                                    f32(params)).outputs
    for mode in modes:
        t0 = time.perf_counter()
        app = repro_torch.compile(graph, mode=mode, lowering_policy="always")
        t_compile = time.perf_counter() - t0
        runs = {}
        for form, run_app in (("captured", app), ("uncaptured", app.uncaptured())):
            for i in range(3 if form == "captured" else 1):
                before_builds = repro_torch.lowering_count()
                before = K.launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rep = run_app.run(feeds, params)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                after = K.launch_counts()
                builds = repro_torch.lowering_count() - before_builds
                delta = {k: after[k] - before[k] for k in after}
                print(f"{label} {mode} {form} run {i}: {wall * 1e3:.1f} ms wall"
                      f"{' (capture ' + format(rep.capture_s, '.2f') + ' s)' if rep.capture_s else ''}"
                      f", {rep.n_programs} programs, boundary bytes "
                      f"{rep.bytes_accessed:.6g}, builds {builds}, replayed {rep.replayed}, "
                      f"launches {delta}" + (f", compile passes {t_compile * 1e3:.1f} ms"
                                             if i == 0 and form == "captured" else ""),
                      flush=True)
                if (i or form == "uncaptured") and builds:
                    raise AssertionError(f"{label} {mode} {form} run {i}: built {builds} "
                                         f"programs")
                if rep.replayed != (form == "captured" and i > 0):
                    raise AssertionError(f"{label} {mode} {form} run {i}: replayed "
                                         f"{rep.replayed}")
                if mode in deltas and delta != deltas[mode]:
                    raise AssertionError(f"{label} {mode}: launches differ across runs")
                deltas[mode] = delta
                if samples is not None and mode == "bsp" and form == "captured" and i == 2:
                    samples.append((graph.total_flops(), rep.bytes_accessed, rep.n_programs,
                                    wall))
            runs[form] = rep.outputs
        stats = app.capture_stats()
        print(f"{label} {mode}: graphs {stats['graphs']}, replays {stats['replays']}, graph "
              f"pool {stats['pool_bytes'] / 1e6:.1f} MB", flush=True)
        same = {k: torch.equal(runs["captured"][k], runs["uncaptured"][k]) for k in ref}
        if not all(same.values()):
            raise AssertionError(f"{label} {mode}: replay differs from the walk: {same}")
        print(f"{label} {mode}: the replay is bitwise the uncaptured walk", flush=True)
        outs[mode] = runs["captured"]
        if mode == "kitsune":
            planned = {}
            for pl in app.lowering.pipelines.values():
                for m in pl.matches:
                    if m.executable and m.accepted:
                        planned[m.kernel] = planned.get(m.kernel, 0) + 1
            for kern, n in planned.items():
                if delta[kern] < n or (kern != "queue_reduce" and delta[kern] != n):
                    raise AssertionError(f"{label}: {kern} launched {delta[kern]} "
                                         f"times for {n} lowered sites")
        del app, run_app, runs
        free()
    for k, want in ref.items():
        bsp_err = rel_err(outs["bsp"][k], want)
        for mode in modes:
            err = rel_err(outs[mode][k], want)
            vs_bsp = rel_err(outs[mode][k], outs["bsp"][k])
            max_abs = (outs[mode][k].float() - outs["bsp"][k].float()).abs().max().item()
            print(f"{label} {mode} [{k}] {tuple(want.shape)}: rel err vs f32 "
                  f"{err:.3e}, vs bsp {vs_bsp:.3e} (max |diff| {max_abs:.4g})",
                  flush=True)
            if err > 2 * bsp_err + 1e-3 or vs_bsp > MODEL_TOL:
                raise AssertionError(f"{label} {mode} [{k}]: rel err {err:.3e} "
                                     f"vs bsp's {bsp_err:.3e}, {vs_bsp:.3e} vs bsp")
    return outs, deltas


def llama_case():
    """Phase 4's graph (published widths, 2 layers), bf16 weights and ids
    from seeds."""
    graph = apps.llama3_8b(hkv=32)
    params = repro_torch.init_params(graph, seed=0, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    feeds = {"ids": torch.randint(0, 128256, (4, 2048), generator=gen, device="cuda")}
    return graph, params, feeds


def phase_llama(samples):
    graph, params, feeds = llama_case()
    n_params = sum(t.numel() for p in params.values() for t in p.values())
    print(f"llama3_8b: {n_params / 1e9:.3f} B parameters in bf16", flush=True)
    _, deltas = run_modes(graph, feeds, params, ("bsp", "kitsune", "vertical"), "llama3_8b",
                          samples)
    k = deltas["kitsune"]
    if k["fused_mlp_swiglu"] != 2 or k["flash_attention"] != 2:
        raise AssertionError(f"llama3_8b kitsune launches {k}: want "
                             f"fused_mlp_swiglu x2, flash_attention x2")


def app_cases() -> dict:
    """Phase 5's feeds at the apps' published sizes, from a numpy seed."""
    rng = np.random.default_rng(2)

    def feats(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            "cuda", torch.bfloat16)

    def ids(high, *shape):
        return torch.from_numpy(rng.integers(0, high, shape)).to("cuda")

    return {
        "nerf": ({"pts": feats(524288, 60), "view": feats(524288, 24)}),
        "dlrm": ({"dense_x": feats(8192, 13), "sparse_ids": ids(1_000_000, 8192, 8)}),
        "mgn": ({"nodes": feats(32768, 128), "edges": feats(98304, 128),
                 "edge_idx": ids(32768, 98304)}),
        "graphcast": ({"x": feats(40962, 256), "mesh_idx": ids(40962, 40962)}),
    }


def phase_apps(samples):
    for name, feeds in app_cases().items():
        graph = apps.APPS[name]()
        params = repro_torch.init_params(graph, seed=0, dtype=torch.bfloat16,
                                         device="cuda")
        _, deltas = run_modes(graph, feeds, params, ("bsp", "kitsune"), name, samples)
        if not deltas["kitsune"]["fused_mlp"]:
            raise AssertionError(f"{name}: fused_mlp never launched")
        del params
        torch.cuda.empty_cache()


def split_reduction_case():
    """Phase 6's graph, x (2048, 1024, 256) bf16 -> x*x -> sum over axis 0,
    and its feed from a seed."""
    g = repro_torch.Graph("split_reduction")
    g.input("x", (2048, 1024, 256), "bfloat16")
    g.elementwise("sq", ["x", "x"], "mul")
    g.reduce("batch_sum", "sq", axis=0)
    g.output("y", "batch_sum")
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2048, 1024, 256, generator=gen, device="cuda").to(torch.bfloat16)
    return g, {"x": x}


def phase_split_reduction():
    g, feeds = split_reduction_case()
    _, deltas = run_modes(g, feeds, {}, ("bsp", "kitsune"), "split_reduction")
    if not deltas["kitsune"]["queue_reduce"]:
        raise AssertionError("split_reduction: queue_reduce never launched")


# ---------------------------------------------------------------------------
# phase 7: the serving path
# ---------------------------------------------------------------------------

def serve_prompts(vocab: int) -> dict[int, list[int]]:
    """16 prompts of 32-160 tokens from a numpy seed; the even ones share a
    32-token prefix, so later requests hit the prefix cache."""
    rng = np.random.default_rng(11)
    shared = rng.integers(2, vocab, 32).tolist()
    prompts = {}
    for rid in range(SERVE_REQUESTS):
        n = int(rng.integers(32, 161))
        tail = rng.integers(2, vocab, n).tolist()
        prompts[rid] = (shared + tail)[:n] if rid % 2 == 0 else tail
    return prompts


def serve_run(cfg, params, prompts, label, base=SERVE_CONFIG, kernels=KernelConfig(),
              **overrides):
    """Serve `prompts` to completion with the launch counters zeroed just
    before and read just after; returns (tokens, engine, launches, seconds).
    The engine keeps its first tick's logits as `first_logits` (f32, host),
    and `launches` counts the decode kernels' float8 K/V launches apart
    ("<kernel>_e4m3")."""
    sc = ServeConfig(**{**base, **overrides})
    eng = PagedServingEngine(cfg, params, sc, eos_id=-1, kernels=kernels)
    for rid, p in prompts.items():
        eng.submit(p, rid=rid)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eng.tick()
    eng.first_logits = eng.last_logits.float().cpu()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    launches["fused_mlp_swiglu_small_m"] = K.launches_by_form("fused_mlp_swiglu").get("small_m", 0)
    for kern in ("flash_decode", "paged_flash_decode"):
        launches[f"{kern}_e4m3"] = K.launches_by_dtype(kern).get("float8_e4m3fn", 0)
    st = eng.stats()
    steps = st["decode_steps"]
    print(f"serve {label}: {len(done)} requests, {st['tokens_out']} tokens, "
          f"{st['ticks']} ticks, {steps} decode steps in {wall:.2f} s: "
          f"{st['tokens_out'] / wall:.1f} tokens/s, {1e3 * wall / st['ticks']:.1f} ms "
          f"per tick, {1e3 * wall / steps:.2f} ms per decode step; launches "
          f"{ {k: n for k, n in launches.items() if n} }; prefix cache "
          f"{st.get('prefix_cache', 'off')}; preemptions {st['scheduler']['preemptions']}; "
          f"kv traffic {st.get('kv_traffic', 'none')}", flush=True)
    if st.get("pool", {"active": 0})["active"] != 0 or len(done) != len(prompts):
        raise AssertionError(f"serve {label}: {len(done)} of {len(prompts)} done, "
                             f"pool {st['pool']}")
    check_graphs(label, eng)
    return done, eng, launches, wall


def check_graphs(label, eng) -> dict:
    """Every tick of the run replayed a captured graph: prints the graphs,
    replays, capture seconds and graph pool bytes; fails unless the replays
    equal the ticks and every bucket is a CapturedTick."""
    st = eng.stats()
    g = st["graphs"]
    print(f"serve {label} graphs: {g['graphs']} captured (buckets {sorted(eng._steps)}), "
          f"{g['replays']} replays for {st['ticks']} ticks, {g['warm_up_s']:.2f} s warming up "
          f"and {g['capture_s']:.2f} s capturing, graph pool {g['pool_bytes'] / 1e6:.1f} MB",
          flush=True)
    if (g["replays"] != st["ticks"] or g["graphs"] == 0
            or not all(isinstance(f, CapturedTick) for f in eng._steps.values())):
        raise AssertionError(f"serve {label}: not every tick replayed a graph: {g}, "
                             f"{st['ticks']} ticks")
    return g


def tick_state(cfg, eng, n_steps: int, seed: int) -> dict:
    """A host tick state over `eng`'s pools at phase 7's shape: all slots
    at ragged contexts (64-191 tokens) on distinct pages, each feeding 1 to
    n_steps tokens (slot 1 idle when n_steps > 1, so the masked writes run);
    no tables and pools where the engine keeps no KV."""
    rng = np.random.default_rng(seed)
    b = eng.sc.batch
    n_tok = rng.integers(1, n_steps + 1, b)
    if n_steps > 1:
        n_tok[1] = 0
    state = {"tokens": torch.from_numpy(rng.integers(2, cfg.vocab, (b, n_steps))),
             "n_tok": torch.from_numpy(n_tok), "pos": torch.from_numpy(rng.integers(64, 192, b))}
    if eng.has_kv:
        v = eng.max_blocks
        tables = 1 + np.arange(b * v).reshape(b, v) % eng.pool.num_blocks
        state.update(tables=torch.from_numpy(tables.astype(np.int32)), kp=eng.kp, vp=eng.vp)
    return state


def state_copies(eng) -> dict:
    """Copies of `eng`'s pools and recurrent-state buffers, for an eager
    tick beside the engine's own."""
    out = {k: t.clone() for k, t in eng.aux.items()}
    if eng.has_kv:
        out.update(kp=eng.kp.clone(), vp=eng.vp.clone())
    return out


def kv_tag(cfg) -> str:
    """The tag of a line about a config with a float8 KV cache."""
    return " fp8" if cfg.kv_cache_dtype == "float8_e4m3fn" else ""


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors of one dtype, through their bytes
    (torch.equal takes no float8 tensor)."""
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def captured_equals_eager(cfg, params, eng) -> None:
    """One replay of each of `eng`'s graphs against eager `paged_tick` on
    copies of the pools and the recurrent state: tokens, positions, logits,
    every page but the null page (which takes every idle slot's masked
    writes, in an order the scatter leaves undefined, and is never read
    unmasked) and every recurrent-state entry bit for bit."""
    mode, bs = eng.sc.paged_attention, eng.sc.block_size
    for (n_steps, v_blocks), step in sorted(eng._steps.items()):
        state = tick_state(cfg, eng, n_steps, seed=n_steps)
        copies = state_copies(eng)
        dev = {k: t.to("cuda") for k, t in state.items()}
        want = paged_tick(params, {**dev, **copies}, cfg, block_size=bs,
                          n_steps=n_steps, mode=mode, kernels=eng.kernels)
        got = step(state)
        torch.cuda.synchronize()
        same = {k: torch.equal(got[k], want[k]) for k in ("tokens_next", "pos", "logits")}
        if eng.has_kv:
            same["pages"] = same_bytes(eng.kp[bs:], copies["kp"][bs:]) and same_bytes(
                eng.vp[bs:], copies["vp"][bs:])
        for name in eng.aux:
            same[name] = torch.equal(eng.aux[name], copies[name])
        print(f"serve{kv_tag(cfg)} {mode}: replayed tick ({n_steps} steps, {v_blocks} blocks) "
              f"against eager paged_tick: {same}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"captured {mode} tick ({n_steps}, {v_blocks}) differs "
                                 f"from eager: {same}")
        ms = {}
        for form, tick in (("eager", lambda: paged_tick(params, {**dev, **copies}, cfg,
                                                       block_size=bs, n_steps=n_steps,
                                                       mode=mode, kernels=eng.kernels
                                                       )["tokens_next"].cpu()),
                           ("replayed", lambda: step(state)["tokens_next"].cpu())):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                tick()
            ms[form] = 1e3 * (time.perf_counter() - t0) / 3
        print(f"serve{kv_tag(cfg)} {mode}: tick of {n_steps} steps, host clock (mean of 3): "
              f"eager {ms['eager']:.2f} ms, replayed {ms['replayed']:.2f} ms", flush=True)
        del copies


def profile_decode_ticks(cfg, params, eng, share=None) -> None:
    """Three one-step ticks with all 8 slots decoding at ragged contexts
    (64-191 tokens, pages drawn from `eng`'s pools) under torch.profiler,
    eager `paged_tick` and then a replay of `eng`'s captured graph (host
    copies in and the sampled tokens out included, as the engine ticks):
    device time per kernel and the device's idle share of the tick, whose
    wall time is taken again without the profiler.  `share`: kernel-name
    substrings whose share of the device time is printed."""
    mode, bs = eng.sc.paged_attention, eng.sc.block_size
    state = tick_state(cfg, eng, 1, seed=13)
    dev = {**{k: t.to("cuda") for k, t in state.items()}, **state_copies(eng)}
    replay = eng._get_step(1, eng.max_blocks if eng.has_kv else 0)
    forms = {
        "eager": lambda: paged_tick(params, dev, cfg, block_size=bs, n_steps=1, mode=mode,
                                    kernels=eng.kernels)["tokens_next"].cpu(),
        "replayed": lambda: replay(state)["tokens_next"].cpu()}
    for form, tick in forms.items():
        profile_ticks(f"{cfg.name}{kv_tag(cfg)} {mode} {form} decode tick (1 step, "
                      f"{eng.sc.batch} slots)", tick, share=share)


def profile_ticks(label, tick, n: int = 3, share=None) -> tuple[float, float]:
    """`tick()` (which ends in a host read) once to warm, `n` times for the
    wall clock, `n` times under torch.profiler: prints ms a tick, ms of
    kernels a tick, the device's idle share and the top kernels, and the
    share of the kernel time taken by the kernels whose names hold one of
    `share`; returns (wall ms, kernel ms) a tick."""
    def ticks(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            tick()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k

    ticks(1)
    wall = ticks(n)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ticks(n)
    # kernels only: a CPU op's self device time repeats its kernels' times
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in rows) / (1e3 * n)
    if not rows:
        raise AssertionError(f"profile {label}: the trace holds no kernel")
    print(f"profile {label}: {1e3 * wall:.2f} ms wall, {busy_ms:.2f} ms of kernels, device "
          f"idle {100 * (1 - busy_ms / (1e3 * wall)):.1f} %", flush=True)
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"  {us / (1e3 * n):8.3f} ms/tick {count // n:5d} calls/tick  {key[:90]}",
              flush=True)
    if share:
        part = sum(r[2] for r in rows if any(s in r[0] for s in share)) / (1e3 * n)
        print(f"profile {label}: kernels {share} {part:.3f} ms/tick, "
              f"{100 * part / busy_ms:.1f} % of the kernel time", flush=True)
    return 1e3 * wall, busy_ms


def reduced_card_equals_cpu(cfg) -> None:
    """The reduced config in f32, the same weights on the card and the CPU:
    12 prompts through 4 slots, captured on the card, eager on the CPU;
    first-tick logits within 2e-4 and the same tokens."""
    small = cfg.reduced()
    cpu_params = get_model(small).init(seed=0, device="cpu")
    card_params = to_device(cpu_params, "cuda")
    rng = np.random.default_rng(12)
    small_prompts = {rid: rng.integers(2, small.vocab, int(rng.integers(3, 40))).tolist()
                     for rid in range(12)}
    small_sc = dict(max_len=64, batch=4, block_size=8, prefill_chunk=8, num_blocks=48,
                    max_new_tokens=16)
    small_runs = {}
    for dev, p in (("cpu", cpu_params), ("cuda", card_params)):
        eng = PagedServingEngine(small, p, ServeConfig(**small_sc), eos_id=-1)
        for rid, pr in small_prompts.items():
            eng.submit(pr, rid=rid)
        eng.tick()
        first = eng.last_logits.float().cpu()
        small_runs[dev] = (eng.run_until_done(), first)
        if dev == "cuda":
            check_graphs(f"{small.name}", eng)
    logit_err = (small_runs["cpu"][1] - small_runs["cuda"][1]).abs().max().item()
    print(f"serve {small.name}: first-tick logits card vs CPU max |diff| {logit_err:.3g} "
          f"(limit 2e-4)", flush=True)
    if logit_err > 2e-4 or small_runs["cpu"][0] != small_runs["cuda"][0]:
        raise AssertionError(f"{small.name}: card and CPU disagree (logits {logit_err:.3g})")
    print(f"serve {small.name}: {len(small_runs['cuda'][0])} requests, card tokens equal CPU "
          f"tokens", flush=True)


def phase_serving() -> dict[str, dict[str, int]]:
    """Returns each serving run's launches, per kernel."""
    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    params = get_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    leaves = [t for sub in (params["blocks"]["sub0"]["attn"], params["blocks"]["sub0"]["mlp"])
              for t in sub.values()] + [params["blocks"]["sub0"]["ln1"],
                                        params["blocks"]["sub0"]["ln2"],
                                        params["final_norm"], params["unembed"]]
    step_bytes = nbytes(*leaves) + SERVE_CONFIG["batch"] * nbytes(params["embed"][0])
    n_params = sum(t.numel() for t in leaves) + params["embed"].numel()
    print(f"{SERVE_ARCH}: {n_params / 1e9:.3f} B parameters in bf16 "
          f"({(step_bytes + nbytes(params['embed'])) / 1e9:.2f} GB), {cfg.n_layers} layers, "
          f"drawn in {time.perf_counter() - t_phase:.1f} s", flush=True)
    sc = ServeConfig(**SERVE_CONFIG)
    print(f"PagedKVExecutor.get_max_allowed_kv_blocks() = "
          f"{PagedKVExecutor(cfg, params, sc).get_max_allowed_kv_blocks()} blocks of "
          f"{sc.block_size} tokens", flush=True)
    torch.cuda.empty_cache()
    prompts = serve_prompts(cfg.vocab)
    runs: dict[str, dict[str, int]] = {}
    native, eng, launches, wall = serve_run(cfg, params, prompts, "native")
    steps = eng.stats()["decode_steps"]
    want = {"paged_flash_decode": cfg.n_layers * steps,
            "fused_mlp_swiglu": cfg.n_layers * steps,
            "fused_mlp_swiglu_small_m": cfg.n_layers * steps, "flash_decode": 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"native run launched {launches}, want {want}")
    traffic = eng.stats()["kv_traffic"]
    if traffic["native_bytes_per_tick"] > traffic["gather_bytes_per_tick"]:
        raise AssertionError(f"native tick moves more KV bytes than gather: {traffic}")
    if not eng.stats()["prefix_cache"]["hits"]:
        raise AssertionError("no prefix-cache hit in the native run")
    g = eng.stats()["graphs"]
    capture_s = g["warm_up_s"] + g["capture_s"]
    print(f"decode step: {1e3 * wall / steps:.2f} ms measured (host clock, whole ticks "
          f"over decode steps, {capture_s:.2f} s of warm-up and capture included; "
          f"{1e3 * (wall - capture_s) / steps:.2f} ms without it) against a weight-read "
          f"bound of {1e3 * step_bytes / HBM:.2f} ms ({step_bytes / 1e9:.2f} GB / 3.35 TB/s)",
          flush=True)
    runs["serve_native"] = launches
    bf16 = {"first_logits": eng.first_logits, "traffic": traffic, "step_ms": 1e3 * wall / steps,
            "tokens": native}
    captured_equals_eager(cfg, params, eng)
    profile_decode_ticks(cfg, params, eng)
    del eng
    gc.collect()                     # engines hold cycles: free their pools and graphs
    torch.cuda.empty_cache()

    # a short async run: the tick thread captures its own graphs
    with AsyncServingEngine(cfg, params, ServeConfig(**SERVE_CONFIG), eos_id=-1) as aeng:
        t0 = time.perf_counter()
        handles = {rid: aeng.submit(prompts[rid], rid=rid) for rid in range(4)}
        got = {rid: h.result(timeout=300) for rid, h in handles.items()}
    print(f"serve async: {len(got)} requests in {time.perf_counter() - t0:.2f} s", flush=True)
    check_graphs("async", aeng.engine)
    if got != {rid: native[rid] for rid in got}:
        raise AssertionError("async tokens differ from the native run's")
    print("serve: async tokens equal the native run's", flush=True)
    del aeng
    gc.collect()
    torch.cuda.empty_cache()

    gather, eng, launches, _ = serve_run(cfg, params, prompts, "gather",
                                         paged_attention="gather")
    want = {"flash_decode": cfg.n_layers * eng.stats()["decode_steps"],
            "fused_mlp_swiglu": cfg.n_layers * eng.stats()["decode_steps"],
            "paged_flash_decode": 0}
    if eng.stats()["decode_steps"] != steps or any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"gather run launched {launches} over "
                             f"{eng.stats()['decode_steps']} steps, want {want}")
    if gather != native:
        diff = [rid for rid in native if native[rid] != gather.get(rid)]
        raise AssertionError(f"gather tokens differ from native for requests {diff}")
    print("serve: gather tokens bitwise equal to native", flush=True)
    runs["serve_gather"] = launches
    captured_equals_eager(cfg, params, eng)
    profile_decode_ticks(cfg, params, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # request 0 alone, on pools sized by the profiling pass (the launcher's
    # default): the whole capacity model runs and must leave the card room
    solo, eng, launches, _ = serve_run(cfg, params, {0: prompts[0]}, "solo",
                                       num_blocks=None)
    if solo[0] != native[0]:
        raise AssertionError(f"request 0 alone {solo[0]} != in the batch {native[0]}")
    free, total = torch.cuda.mem_get_info()
    print(f"serve solo: default capacity {eng.pool.num_blocks} blocks "
          f"({nbytes(eng.kp, eng.vp) / 1e9:.2f} GB of KV pools, "
          f"{eng.stats()['graphs']['pool_bytes'] / 1e9:.3f} GB of graph pool); card "
          f"{free / 1e9:.2f} GB free of {total / 1e9:.2f} GB after the run, peak reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB", flush=True)
    print("serve: request 0 alone equals its tokens in the full batch", flush=True)
    runs["serve_solo"] = launches
    bf16["capacity"] = (eng.pool.num_blocks, nbytes(eng.kp, eng.vp))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 7 bf16 runs: {time.perf_counter() - t_phase:.1f} s", flush=True)

    runs.update(phase_serving_fp8(cfg, params, prompts, bf16))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    reduced_card_equals_cpu(cfg)
    reduced_fp8_card_equals_cpu(cfg)
    print(f"phase 7 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs


def tuned_block_s(cfg, kv_dtype) -> dict:
    """The split-K chunk kernels/autotune.py picks for B8 over
    `decode_tile_candidates` at phase 7's decode shape (8 slots, phi3's 40
    query / 10 kv heads of 128 in its 40-layer pools, 32 pages of 16 a slot,
    valid lengths 32-192 as the run's contexts have them), with pools of
    `kv_dtype`: {"block_s": winner, "us": its time}."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    b, bs = SERVE_CONFIG["batch"], SERVE_CONFIG["block_size"]
    v_blocks = SERVE_CONFIG["max_len"] // bs
    pool = ((SERVE_CONFIG["num_blocks"] + 1) * bs, cfg.n_layers, 1, cfg.n_kv_heads,
            cfg.head_dim)
    kp, vp = (randn(gen, *pool, dtype=torch.bfloat16) for _ in range(2))
    if kv_dtype == E4M3:
        kp, vp = to_e4m3(kp), to_e4m3(vp)
    q = randn(gen, b, cfg.n_heads, 1, cfg.head_dim, dtype=torch.bfloat16)
    tables = (1 + torch.randperm(b * v_blocks, generator=gen, device="cuda")).to(
        torch.int32).reshape(b, v_blocks)
    valid = torch.randint(32, 193, (b,), generator=gen, device="cuda", dtype=torch.int32)
    layer = (cfg.n_layers - 1, 0)

    def build(cand):
        return lambda q: K.paged_flash_decode(q, kp, vp, tables, valid_len=valid, block_size=bs,
                                              layer=layer, block_s=cand["block_s"])
    choice = K.autotune(("phase 7 paged_flash_decode", str(kv_dtype)),
                        decode_tile_candidates(v_blocks * bs, page_size=bs), build, (q,))
    del kp, vp
    torch.cuda.empty_cache()
    return choice


def phase_serving_fp8(cfg, params, prompts, bf16: dict) -> dict[str, dict[str, int]]:
    """Phase 7's float8 KV cache run on the same phi3-medium-14b weights
    (kv_cache_dtype="float8_e4m3fn", full width and depth, phase 7's
    ServeConfig and prompts), its engines given B8's tuned block_s for e4m3
    pools (`kernels=`): native (40 e4m3 paged_flash_decode launches a
    decode step), gather (bitwise its tokens, flash_decode in e4m3), one
    replay per bucket against eager paged_tick (pools compared through
    their bytes), request 0 alone on pools sized by the profiling pass
    (about twice the bf16 capacity), the first tick's logits within the
    reference's own float8 bound of the bf16 run's, half the KV bytes a
    tick, and a profiled one-step tick."""
    t0 = time.perf_counter()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn")
    tiles = {str(dt): tuned_block_s(cfg, dt) for dt in (E4M3, torch.bfloat16)}
    print(f"serve fp8: kernels/autotune.py's B8 block_s at phase 7's decode shape: "
          f"e4m3 pools {tiles[str(E4M3)]}, bf16 pools {tiles[str(torch.bfloat16)]}", flush=True)
    kernels = KernelConfig(block_s=tiles[str(E4M3)]["block_s"])
    runs = {}
    native, eng, launches, wall = serve_run(cfg8, params, prompts, "fp8 native",
                                            kernels=kernels)
    steps = eng.stats()["decode_steps"]
    n = cfg.n_layers * steps
    want = {"paged_flash_decode": n, "paged_flash_decode_e4m3": n, "fused_mlp_swiglu": n,
            "fused_mlp_swiglu_small_m": n, "flash_decode": 0}
    if eng.kp.dtype != E4M3 or any(launches[k] != c for k, c in want.items()):
        raise AssertionError(f"fp8 native run: pools {eng.kp.dtype}, launched {launches}, "
                             f"want {want}")
    traffic = eng.stats()["kv_traffic"]
    ratio = {k: bf16["traffic"][k] / traffic[k]
             for k in ("native_bytes_per_tick", "gather_bytes_per_tick")}
    print(f"serve fp8: KV bytes a tick, native {traffic['native_bytes_per_tick']:.0f} and gather "
          f"{traffic['gather_bytes_per_tick']:.0f}, against bf16's "
          f"{bf16['traffic']['native_bytes_per_tick']:.0f} and "
          f"{bf16['traffic']['gather_bytes_per_tick']:.0f}: bf16 / fp8 {ratio}", flush=True)
    if any(r != 2.0 for r in ratio.values()):
        raise AssertionError(f"fp8 KV bytes a tick are not half the bf16 run's: {ratio}")
    err = (eng.first_logits - bf16["first_logits"]).abs().max().item()
    bound = 0.15 * bf16["first_logits"].abs().max().item() + 0.5
    print(f"serve fp8: first tick's logits against the bf16 run's: max |diff| {err:.4g} "
          f"(the reference's float8 bound 0.15 max|logits| + 0.5 = {bound:.4g}); "
          f"{sum(native[rid] == bf16['tokens'][rid] for rid in native)} of "
          f"{len(native)} requests with the bf16 run's tokens", flush=True)
    if not err <= bound:
        raise AssertionError(f"fp8 first-tick logits off the bf16 run's by {err} > {bound}")
    g = eng.stats()["graphs"]
    capture_s = g["warm_up_s"] + g["capture_s"]
    print(f"fp8 decode step: {1e3 * wall / steps:.2f} ms measured (host clock, whole ticks "
          f"over decode steps, {capture_s:.2f} s of warm-up and capture included; "
          f"{1e3 * (wall - capture_s) / steps:.2f} ms without it) against bf16's "
          f"{bf16['step_ms']:.2f} ms", flush=True)
    runs["serve_fp8_native"] = launches
    captured_equals_eager(cfg8, params, eng)
    profile_decode_ticks(cfg8, params, eng, share=["paged_decode_kernel", "decode_combine"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    gather, eng, launches, _ = serve_run(cfg8, params, prompts, "fp8 gather", kernels=kernels,
                                         paged_attention="gather")
    want = {"flash_decode": n, "flash_decode_e4m3": n, "fused_mlp_swiglu": n,
            "paged_flash_decode": 0}
    if eng.stats()["decode_steps"] != steps or any(launches[k] != c for k, c in want.items()):
        raise AssertionError(f"fp8 gather run launched {launches}, want {want}")
    if gather != native:
        diff = [rid for rid in native if native[rid] != gather.get(rid)]
        raise AssertionError(f"fp8 gather tokens differ from native for requests {diff}")
    print("serve fp8: gather tokens bitwise equal to native", flush=True)
    runs["serve_fp8_gather"] = launches
    captured_equals_eager(cfg8, params, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    solo, eng, launches, _ = serve_run(cfg8, params, {0: prompts[0]}, "fp8 solo",
                                       kernels=kernels, num_blocks=None)
    if solo[0] != native[0]:
        raise AssertionError(f"fp8: request 0 alone {solo[0]} != in the batch {native[0]}")
    blocks, kv_bytes = eng.pool.num_blocks, nbytes(eng.kp, eng.vp)
    print(f"serve fp8 solo: default capacity {blocks} blocks ({kv_bytes / 1e9:.2f} GB of e4m3 "
          f"KV pools) against bf16's {bf16['capacity'][0]} blocks "
          f"({bf16['capacity'][1] / 1e9:.2f} GB): {blocks / bf16['capacity'][0]:.3f}x; "
          f"request 0 alone equals its tokens in the batch", flush=True)
    if blocks < 1.9 * bf16["capacity"][0]:
        raise AssertionError(f"fp8 default capacity {blocks} blocks < 1.9 x bf16's "
                             f"{bf16['capacity'][0]}")
    runs["serve_fp8_solo"] = launches
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 7 fp8 runs: {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def reduced_fp8_card_equals_cpu(cfg) -> None:
    """The reduced config (f32) with a float8 cache, the same weights on the
    card and the CPU, teacher-forced through the paged engine's one-step
    tick over fixed tokens (a replayed graph on the card, eager paged_tick
    on the CPU), so that no sampled token can send the two apart: 24 steps
    of 4 slots, the logits within MODEL_TOL (relative) and B8 launched in
    its e4m3 form at every layer and step."""
    small = dataclasses.replace(cfg.reduced(), kv_cache_dtype="float8_e4m3fn")
    cpu_params = get_model(small).init(seed=0, device="cpu")
    toks = np.random.default_rng(14).integers(2, small.vocab, (4, 24))
    sc = ServeConfig(max_len=64, batch=4, block_size=8, prefill_chunk=8, num_blocks=48)
    logits = {}
    for dev, p in (("cpu", cpu_params), ("cuda", to_device(cpu_params, "cuda"))):
        eng = PagedServingEngine(small, p, sc, eos_id=-1)
        step = eng._get_step(1, eng.max_blocks)
        v = eng.max_blocks
        tables = torch.from_numpy(
            (1 + np.arange(4 * v).reshape(4, v) % eng.pool.num_blocks).astype(np.int32))
        before = K.launches_by_dtype("paged_flash_decode").get("float8_e4m3fn", 0)
        out = []
        for t in range(toks.shape[1]):
            state = {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                     "n_tok": torch.ones(4, dtype=torch.int64),
                     "pos": torch.full((4,), t, dtype=torch.int64), "tables": tables,
                     "kp": eng.kp, "vp": eng.vp, **eng.aux}
            out.append(step(state)["logits"].float().cpu())
        logits[dev] = torch.stack(out)
        if dev == "cuda":
            e4m3 = K.launches_by_dtype("paged_flash_decode").get("float8_e4m3fn", 0) - before
            if not isinstance(step, CapturedTick) or e4m3 != small.n_layers * toks.shape[1]:
                raise AssertionError(f"{small.name} fp8: {type(step).__name__}, {e4m3} e4m3 "
                                     f"paged_flash_decode launches")
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    rel = rel_err(logits["cuda"], logits["cpu"])
    print(f"serve {small.name} fp8 cache: {toks.shape[1]} teacher-forced steps of 4 slots, "
          f"card (replayed) vs CPU logits max |diff| {err:.3g}, relative {rel:.3g} (limit "
          f"{MODEL_TOL})", flush=True)
    if rel > MODEL_TOL:
        raise AssertionError(f"{small.name} fp8: card and CPU logits disagree ({rel:.3g})")

# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-3          # AdamW (f32 moments), constant
# |first loss - ln(vocab)|: random logits of spread ~0.7 add ~0.25 to the
# log-sum-exp and the z-loss ~0.02, so the first loss sits near ln(vocab)
FIRST_LOSS_MARGIN = 1.0


def train_batches(cfg, batch: int, seq: int, seed: int = 0):
    """step -> the step's batch on the card: SyntheticLM tokens, and for the
    encoder-decoder 1500 stub frames drawn from (seed, step)."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed))

    def at(step: int) -> dict:
        out = {"tokens": torch.from_numpy(data.batch(step)["tokens"]).to("cuda")}
        if cfg.family == "encdec":
            rng = np.random.default_rng((seed, step))
            out["frame_embeds"] = torch.from_numpy(rng.standard_normal(
                (batch, 1500, cfg.d_model), dtype=np.float32)).to("cuda")
        return out
    return at


def alloc_calls() -> dict[str, int]:
    """The caching allocator's calls into the driver so far: cudaMalloc,
    cudaFree (each a device-wide synchronization) and the retries that
    free its cache to satisfy an allocation."""
    stats = torch.cuda.memory_stats()
    return {"cudaMalloc": stats.get("num_device_alloc", 0),
            "cudaFree": stats.get("num_device_free", 0),
            "retries": stats.get("num_alloc_retries", 0)}


def train_steps(label, state, step_fn, batches, want):
    """Run `step_fn` over `batches` (counters zeroed by the caller before
    the run); each step must launch exactly `want` of the kernels named
    there, and no step after the first may build a program
    (`lowering_count()`).  Returns (state, losses, seconds per step)."""
    losses, secs = [], []
    for i, b in enumerate(batches):
        before = K.launch_counts()
        mem = alloc_calls()
        builds = repro_torch.lowering_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        delta = {k: n - before[k] for k, n in K.launch_counts().items()}
        mem = {k: n - mem[k] for k, n in alloc_calls().items()}
        builds = repro_torch.lowering_count() - builds
        print(f"train {label} step {i}: loss {loss:.5f}, grad norm {m['grad_norm'].item():.4f}, "
              f"{1e3 * secs[-1]:.1f} ms, launches { {k: n for k, n in delta.items() if n} }, "
              f"allocator {mem}, builds {builds}", flush=True)
        bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
        if bad or not math.isfinite(loss) or (i and builds):
            raise AssertionError(f"train {label} step {i}: loss {loss}, launches "
                                 f"(got, want) {bad}, builds {builds}")
        losses.append(loss)
    return state, losses, secs


def profile_train_step(label, step_fn, state, batch, step_s: float) -> float:
    """One step under torch.profiler: device time by kernel, grouped, and
    the device's idle share of an unprofiled step (`step_s`).  Returns the
    step's loss."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out, m = step_fn(state, batch)
        loss = m["loss"].item()
        torch.cuda.synchronize()
    del out
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError(f"profile {label}: the trace holds no kernel")
    busy_ms = sum(r[2] for r in rows) / 1e3
    groups = {"B6/B7 backward (mlp_bwd_dx/dw_wgmma, mlp_bwd_dx/dw_kernel)": ("mlp_bwd",),
              "B1/B2 forward (mlp_fwd_wgmma, small_m_kernel)": ("mlp_fwd_wgmma",
                                                                "fused_mlp_kernel",
                                                                "small_m_kernel"),
              "B5 folds (queue_reduce)": ("queue_reduce",),
              "cuBLAS GEMMs": ("gemm", "nvjet", "xmma", "cutlass", "cublas")}
    split = {g: 0.0 for g in groups}
    split["other (elementwise, reductions, copies)"] = 0.0
    for key, _, us in rows:
        g = next((g for g, keys in groups.items() if any(k in key.lower() for k in keys)),
                 "other (elementwise, reductions, copies)")
        split[g] += us / 1e3
    print(f"profile {label} step: {1e3 * step_s:.1f} ms wall (unprofiled), {busy_ms:.1f} ms of "
          f"kernels, device idle {100 * (1 - busy_ms / (1e3 * step_s)):.1f} %", flush=True)
    for g, ms in split.items():
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} %  {g}", flush=True)
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:5d} calls  {key[:90]}", flush=True)
    return loss


def phase_train_gemma() -> dict[str, int]:
    """8a: gemma3-1b at full width and depth, 4 x 2048 tokens a step."""
    cfg = get_config("gemma3-1b")
    opt = adamw(TRAIN_LR)
    t0 = time.perf_counter()
    state = make_train_state(cfg, opt, seed=0, device="cuda")
    n = sum(p.numel() for p in leaves(state["params"]))
    print(f"train gemma3-1b: {n / 1e9:.3f} B parameters in bf16, {cfg.n_layers} layers, "
          f"AdamW f32 moments, drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    step = make_train_step(cfg, opt, TrainConfig(remat=True, xent_chunk=512))
    at = train_batches(cfg, 4, 2048)
    want = {"fused_mlp_swiglu_bwd": cfg.n_layers, "fused_mlp_swiglu": 2 * cfg.n_layers,
            "fused_mlp_bwd": 0, "fused_mlp": 0}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, distinct, s1 = train_steps("gemma3-1b", state, step, [at(i) for i in range(3)], want)
    repeated = at(3)
    state, rep, s2 = train_steps("gemma3-1b repeated", state, step, [repeated] * 5, want)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if abs(distinct[0] - math.log(cfg.vocab)) > FIRST_LOSS_MARGIN:
        raise AssertionError(f"first loss {distinct[0]} is not within {FIRST_LOSS_MARGIN} "
                             f"of ln({cfg.vocab}) = {math.log(cfg.vocab):.3f}")
    if not rep[-1] < rep[0]:
        raise AssertionError(f"loss did not fall on the repeated batch: {rep}")
    steady = s1[1:] + s2
    step_s = sum(steady) / len(steady)
    print(f"train gemma3-1b: first loss {distinct[0]:.4f} (ln V = {math.log(cfg.vocab):.4f}), "
          f"repeated batch {rep[0]:.4f} -> {rep[-1]:.4f}; {1e3 * step_s:.1f} ms per step "
          f"(mean of steps 2-8; first {1e3 * s1[0]:.1f}), {4 * 2048 / step_s:.0f} tokens/s, "
          f"peak allocated {peak / 1e9:.2f} GB", flush=True)
    profile_train_step("gemma3-1b", step, state, repeated, step_s)
    return launches


def phase_train_whisper() -> tuple[dict[str, int], dict[str, dict[int, int]]]:
    """8b: whisper-small at full width, 8 x (1500 frames, 448 tokens).
    Returns the run's launches, and fused_mlp_bwd's and fused_mlp's by
    input rows."""
    cfg = get_config("whisper-small")
    opt = adamw(TRAIN_LR)
    state = make_train_state(cfg, opt, seed=0, device="cuda")
    n = sum(p.numel() for p in leaves(state["params"]))
    print(f"train whisper-small: {n / 1e9:.3f} B parameters in bf16, {cfg.n_layers} + "
          f"{cfg.n_layers} layers", flush=True)
    step = make_train_step(cfg, opt, TrainConfig(remat=True, xent_chunk=512))
    at = train_batches(cfg, 8, 448)
    # encoder (no remat) and decoder forward, decoder recompute; one
    # backward per block
    want = {"fused_mlp_bwd": 2 * cfg.n_layers, "fused_mlp": 3 * cfg.n_layers,
            "fused_mlp_swiglu_bwd": 0, "fused_mlp_swiglu": 0}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, losses, secs = train_steps("whisper-small", state, step, [at(i) for i in range(3)], want)
    launches = K.launch_counts()
    by_rows = {k: K.launches_by_rows(k) for k in ("fused_mlp_bwd", "fused_mlp")}
    # one backward per encoder block at 8 x 1500 rows, per decoder block at 8
    # x 448; one forward per encoder block, two per decoder block (remat)
    want_rows = {"fused_mlp_bwd": {8 * 1500: 3 * cfg.n_layers, 8 * 448: 3 * cfg.n_layers},
                 "fused_mlp": {8 * 1500: 3 * cfg.n_layers, 8 * 448: 6 * cfg.n_layers}}
    print(f"train whisper-small: launches by rows {by_rows}", flush=True)
    if by_rows != want_rows:
        raise AssertionError(f"launches by rows {by_rows}, want {want_rows}")
    step_s = sum(secs[1:]) / len(secs[1:])
    print(f"train whisper-small: losses {losses}; {1e3 * step_s:.1f} ms per step (steps 2-3), "
          f"{8 * 448 / step_s:.0f} decoder tokens/s ({8 * 1500 / step_s:.0f} frames/s), "
          f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    # the profiled step takes step 0's batch again: its loss must have fallen
    again = profile_train_step("whisper-small", step, state, at(0), step_s)
    print(f"train whisper-small: step 0's batch again after 3 steps: loss {losses[0]:.5f} -> "
          f"{again:.5f}", flush=True)
    if not again < losses[0]:
        raise AssertionError(f"whisper-small: loss on step 0's batch did not fall: {losses[0]} "
                             f"-> {again}")
    return launches, by_rows


def phase_train_card_vs_cpu() -> None:
    """8c: the reduced configs (f32) train 3 steps from the same weights on
    the card (kernels) and on the CPU (plain versions): losses and every
    parameter within 2e-4; two card runs give bitwise-equal losses."""
    for name in ("gemma3-1b", "whisper-small"):
        cfg = get_config(name).reduced()
        opt = adamw(1e-3)
        base = get_model(cfg).init(seed=0, device="cpu")
        rng = np.random.default_rng(5)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 40)))}
        if cfg.family == "encdec":
            batch["frame_embeds"] = torch.from_numpy(
                rng.standard_normal((4, 40, cfg.d_model), dtype=np.float32))

        def run(device):
            params = to_device(base, device)
            state = {"params": params, "opt": opt.init(params)}
            step = make_train_step(cfg, opt, TrainConfig(xent_chunk=16))
            b = {k: v.to(device) for k, v in batch.items()}
            losses = []
            for _ in range(3):
                state, m = step(state, b)
                losses.append(m["loss"].item())
            return losses, state["params"]

        cpu_l, cpu_p = run("cpu")
        card_l, card_p = run("cuda")
        again_l, _ = run("cuda")
        loss_err = max(abs(a - b) for a, b in zip(cpu_l, card_l))
        p_err = max((a.float() - b.float().cpu()).abs().max().item()
                    for (_, a), (_, b) in zip(flatten(cpu_p), flatten(card_p)))
        print(f"train {name} reduced: card vs CPU losses {card_l} / {cpu_l}, max |diff| "
              f"{loss_err:.3g}, parameters max |diff| {p_err:.3g} (limit 2e-4); second card "
              f"run bitwise equal: {again_l == card_l}", flush=True)
        for (path, a), (_, b) in zip(flatten(cpu_p), flatten(card_p)):
            torch.testing.assert_close(b.cpu(), a, rtol=2e-4, atol=2e-4, msg=path)
        if loss_err > 2e-4 * (1 + max(cpu_l)) or again_l != card_l:
            raise AssertionError(f"{name} reduced: card {card_l}, CPU {cpu_l}, again {again_l}")


def phase_train_launcher() -> None:
    """8d: the training launcher in a subprocess on the card, gemma3-1b at
    full width, into a fresh checkpoint directory (a stale one would
    resume), deleted after."""
    ckpt = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build"))
    try:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma3-1b",
               "--steps", "4", "--batch", "8", "--seq", "128", "--ckpt", str(ckpt)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                             env=env)
        wall = time.perf_counter() - t0
        for line in out.stdout.splitlines():
            print(f"  launcher: {line}", flush=True)
        if out.returncode != 0:
            raise AssertionError(f"launcher exited {out.returncode}:\n{out.stderr[-3000:]}")
        size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        print(f"launcher: exit 0 in {wall:.1f} s (interpreter start, init, 4 steps, save); "
              f"checkpoint directory {size / 1e9:.2f} GB", flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def phase_training() -> tuple[dict[str, dict[str, int]],
                              dict[str, dict[str, dict[int, int]]]]:
    """Returns each full-width training run's launches, per kernel, and the
    whisper run's fused_mlp_bwd and fused_mlp launches by input rows."""
    t_phase = time.perf_counter()
    # phase 7's engines hold reference cycles: collect them, or their pools
    # and the phi3 weights (76 GB) stay allocated
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    runs = {"train_gemma3": phase_train_gemma()}
    torch.cuda.empty_cache()
    runs["train_whisper"], whisper_rows = phase_train_whisper()
    torch.cuda.empty_cache()
    phase_train_card_vs_cpu()
    torch.cuda.empty_cache()
    phase_train_launcher()
    print(f"phase 8 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs, {"train_whisper": whisper_rows}


# ---------------------------------------------------------------------------
# phase 9: the model families beyond dense
# ---------------------------------------------------------------------------

def describe(label, cfg, params, t0) -> int:
    """Print the model's size; returns the bytes one decode step reads at
    least: every weight once (the tied LM head's whole table among them)."""
    step_bytes = nbytes(*leaves(params))
    n_params = sum(t.numel() for t in leaves(params))
    print(f"{label}: {n_params / 1e9:.3f} B parameters ({step_bytes / 1e9:.2f} GB), "
          f"{cfg.n_layers} layers, drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    return step_bytes


def decode_step_ms(label, eng, wall, step_bytes) -> None:
    steps = eng.stats()["decode_steps"]
    g = eng.stats()["graphs"]
    capture_s = g["warm_up_s"] + g["capture_s"]
    print(f"{label} decode step: {1e3 * wall / steps:.2f} ms measured (host clock, whole "
          f"ticks over {steps} decode steps, {capture_s:.2f} s of warm-up and capture "
          f"included; "
          f"{1e3 * (wall - capture_s) / steps:.2f} ms without it) against a weight-read "
          f"bound of {1e3 * step_bytes / HBM:.3f} ms ({step_bytes / 1e9:.2f} GB / 3.35 TB/s)",
          flush=True)


def expect_launches(label, launches, want) -> None:
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{label} launched {launches}, want {want}")


def free() -> None:
    """Collect the engines the caller dropped (they hold reference cycles)
    and give their pools and graphs back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


class EagerCardEngine(PagedServingEngine):
    """The paged engine with every tick run eagerly on the card, no graph:
    the oracle a captured run is held to."""

    def _get_step(self, n_steps: int, v_blocks: int):
        tick = functools.partial(paged_tick, self.params, cfg=self.cfg,
                                 block_size=self.sc.block_size, n_steps=n_steps,
                                 mode=self.sc.paged_attention)
        return lambda state: tick({k: t.to(self.device) for k, t in state.items()})


def phase_hymba() -> dict[str, dict[str, int]]:
    """9a: hymba-1.5b at full width, its depth cut to HYMBA_LAYERS, behind
    the paged engine."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(HYMBA), n_layers=HYMBA_LAYERS)
    params = get_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    step_bytes = describe(f"{HYMBA} ({HYMBA_LAYERS} layers)", cfg, params, t0)
    prompts = serve_prompts(cfg.vocab)
    runs = {}
    native, eng, launches, wall = serve_run(cfg, params, prompts, "hymba native")
    steps = eng.stats()["decode_steps"]
    expect_launches("hymba native", launches, {
        "paged_flash_decode": cfg.n_layers * steps, "fused_mlp_swiglu": cfg.n_layers * steps,
        "fused_mlp_swiglu_small_m": cfg.n_layers * steps, "flash_decode": 0})
    if eng.prefix_enabled or "prefix_cache" in eng.stats():
        raise AssertionError("hymba: prefix caching must be off with recurrent state")
    decode_step_ms("hymba native", eng, wall, step_bytes)
    runs["serve_hymba_native"] = launches
    captured_equals_eager(cfg, params, eng)
    profile_decode_ticks(cfg, params, eng)
    del eng
    free()

    gather, eng, launches, wall = serve_run(cfg, params, prompts, "hymba gather",
                                            paged_attention="gather")
    expect_launches("hymba gather", launches, {
        "flash_decode": cfg.n_layers * steps, "fused_mlp_swiglu": cfg.n_layers * steps,
        "paged_flash_decode": 0})
    if gather != native:
        raise AssertionError(f"hymba: gather tokens differ from native for requests "
                             f"{[rid for rid in native if native[rid] != gather.get(rid)]}")
    print("serve hymba: gather tokens bitwise equal to native", flush=True)
    decode_step_ms("hymba gather", eng, wall, step_bytes)
    runs["serve_hymba_gather"] = launches
    captured_equals_eager(cfg, params, eng)
    del eng
    free()

    solo, eng, launches, _ = serve_run(cfg, params, {0: prompts[0]}, "hymba solo")
    if solo[0] != native[0]:
        raise AssertionError(f"hymba: request 0 alone {solo[0]} != in the batch {native[0]}")
    print("serve hymba: request 0 alone equals its tokens in the full batch", flush=True)
    runs["serve_hymba_solo"] = launches
    del params, eng
    free()
    reduced_card_equals_cpu(cfg)
    return runs


def phase_maverick() -> dict[str, dict[str, int]]:
    """9b: llama4-maverick at full width, its depth cut to one dense and one
    MoE layer."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MAVERICK), n_layers=MAVERICK_LAYERS)
    params = get_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    step_bytes = describe(f"{MAVERICK} ({MAVERICK_LAYERS} layers)", cfg, params, t0)
    experts = nbytes(*leaves(params["blocks"]["sub1"]["moe"]["experts"]))
    print(f"maverick: every decode step runs all {cfg.n_experts} experts' capacity slots, "
          f"{experts / 1e9:.2f} GB of expert weights: >= {1e3 * experts / HBM:.2f} ms",
          flush=True)
    prompts = dict(list(serve_prompts(cfg.vocab).items())[:MAVERICK_REQUESTS])
    runs = {}
    native, eng, launches, wall = serve_run(cfg, params, prompts, "maverick native")
    steps = eng.stats()["decode_steps"]
    expect_launches("maverick native", launches, {
        "paged_flash_decode": cfg.n_layers * steps, "fused_mlp_swiglu": steps,
        "fused_mlp_swiglu_small_m": steps, "flash_decode": 0})
    decode_step_ms("maverick native", eng, wall, step_bytes)
    runs["serve_maverick_native"] = launches
    captured_equals_eager(cfg, params, eng)
    profile_decode_ticks(cfg, params, eng)
    del eng
    free()

    gather, eng, launches, _ = serve_run(cfg, params, prompts, "maverick gather",
                                         paged_attention="gather")
    expect_launches("maverick gather", launches, {
        "flash_decode": cfg.n_layers * steps, "fused_mlp_swiglu": steps,
        "paged_flash_decode": 0})
    if gather != native:
        raise AssertionError("maverick: gather tokens differ from native")
    print("serve maverick: gather tokens bitwise equal to native", flush=True)
    runs["serve_maverick_gather"] = launches
    captured_equals_eager(cfg, params, eng)
    del params, eng
    free()
    reduced_card_equals_cpu(get_config(MAVERICK))
    return runs


def phase_xlstm() -> dict[str, dict[str, int]]:
    """9c: xlstm-350m at full depth on the engine without pages."""
    t0 = time.perf_counter()
    cfg = get_config(XLSTM)
    params = get_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    step_bytes = describe(XLSTM, cfg, params, t0)
    prompts = dict(list(serve_prompts(cfg.vocab).items())[:XLSTM_REQUESTS])
    captured, eng, launches, wall = serve_run(cfg, params, prompts, "xlstm captured",
                                              base=XLSTM_CONFIG)
    if eng.has_kv or eng.pool is not None or any(launches.values()):
        raise AssertionError(f"xlstm: pages {eng.has_kv}, launches {launches}")
    decode_step_ms("xlstm captured", eng, wall, step_bytes)
    captured_equals_eager(cfg, params, eng)
    del eng
    free()
    eager = EagerCardEngine(cfg, params, ServeConfig(**XLSTM_CONFIG), eos_id=-1)
    for rid, p in prompts.items():
        eager.submit(p, rid=rid)
    t1 = time.perf_counter()
    done = eager.run_until_done()
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t1) / eager.stats()["decode_steps"]
    print(f"serve xlstm eager on the card: {eager_ms:.2f} ms per decode step", flush=True)
    if done != captured:
        raise AssertionError("xlstm: captured tokens differ from the eager card run's")
    print("serve xlstm: captured tokens equal the eager card run's", flush=True)
    del params, eager
    free()
    reduced_card_equals_cpu(cfg)
    return {"serve_xlstm": launches}


@contextlib.contextmanager
def plain_decode_kernels():
    """The model layers' decode attention and MLP run their kernels' plain
    versions (the chunk math in torch ops) while the block is open."""
    def mlp(x, w1, w2, *, act, cfg=KernelConfig()):
        y = fused_mlp_fwd_plain(x.reshape(-1, x.shape[-1]), w1, w2, act)
        return y.reshape(*x.shape[:-1], w2.shape[1])

    saved = model_layers.k_decode, model_layers.k_mlp
    model_layers.k_decode = lambda q, k, v, valid_len=None, cfg=KernelConfig(): (
        flash_decode_plain(q, k, v, valid_len=valid_len, block_s=cfg.block_s))
    model_layers.k_mlp = mlp
    try:
        yield
    finally:
        model_layers.k_decode, model_layers.k_mlp = saved


def phase_whisper_decode() -> dict[str, dict[str, int]]:
    """9d: whisper-small decode at full width: 8 x 1500 stub frames encoded,
    the cross cache built, 16 greedy decode steps at batch 8."""
    t0 = time.perf_counter()
    cfg = get_config(WHISPER)
    params = get_model(cfg).init(seed=0, device="cuda")
    torch.cuda.synchronize()
    describe(WHISPER, cfg, params, t0)
    b, n = WHISPER_BATCH, WHISPER_FRAMES
    gen = torch.Generator(device="cuda").manual_seed(21)
    frames = torch.randn((b, n, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    tok = torch.randint(2, cfg.vocab, (b,), generator=gen, device="cuda")
    with torch.no_grad():
        t1 = time.perf_counter()
        enc = encdec.encode(params, frames, cfg)
        cache = encdec.build_cross_cache(params, enc, cfg, encdec.init_cache(
            cfg, b, WHISPER_MAX_LEN, enc_len=n, device="cuda"))
        torch.cuda.synchronize()
        print(f"whisper: encoder over {b} x {n} frames and the cross cache in "
              f"{time.perf_counter() - t1:.2f} s", flush=True)
        with plain_decode_kernels():
            want, _ = encdec.decode_step(params, tok, 0, {k: v.clone() for k, v in cache.items()},
                                         cfg)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        first, step_s = None, []
        for t in range(WHISPER_STEPS):
            t1 = time.perf_counter()
            logits, cache = encdec.decode_step(params, tok, t, cache, cfg)
            first = logits.clone() if first is None else first
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
        launches = K.launch_counts()
        launches["fused_mlp_small_m"] = K.launches_by_form("fused_mlp").get("small_m", 0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            encdec.decode_step(params, tok, WHISPER_STEPS, cache, cfg)
            torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t1)
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in rows) / 1e3
    print(f"whisper decode: one profiled step {prof_ms:.2f} ms wall (profiler on), "
          f"{busy_ms:.3f} ms of kernels", flush=True)
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"  {us / 1e3:8.3f} ms {count:5d} calls  {key[:90]}", flush=True)
    wall = sum(step_s[1:]) / (WHISPER_STEPS - 1)
    expect_launches("whisper decode", launches, {
        "flash_decode": cfg.n_layers * WHISPER_STEPS, "fused_mlp": cfg.n_layers * WHISPER_STEPS,
        "fused_mlp_small_m": cfg.n_layers * WHISPER_STEPS, "paged_flash_decode": 0})
    rel = rel_err(first, want)
    dec_bytes = nbytes(*leaves(params["dec"]), params["embed"], params["final_norm"],
                       cache["xk"], cache["xv"])
    print(f"whisper decode: {WHISPER_STEPS} steps at batch {b}, the first {1e3 * step_s[0]:.2f} "
          f"ms, the others {1e3 * wall:.3f} ms each (host clock, eager, a sync after each) "
          f"against a bound of {1e3 * dec_bytes / HBM:.3f} ms "
          f"(decoder weights, LM head and cross cache, {dec_bytes / 1e9:.3f} GB / 3.35 TB/s); "
          f"launches {launches}; first step's logits against the plain path: relative error "
          f"{rel:.3g} (limit {MODEL_TOL})", flush=True)
    if rel > MODEL_TOL:
        raise AssertionError(f"whisper decode: relative error {rel:.3g} against the plain path")
    return {"whisper_decode": launches}


def phase_families() -> dict[str, dict[str, int]]:
    """Returns each phase-9 run's launches, per kernel."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 9 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    runs = {}
    for part in (phase_hymba, phase_maverick, phase_xlstm, phase_whisper_decode):
        t0 = time.perf_counter()
        runs.update(part())
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 9 {part.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase 9 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 10: the capture front-end
# ---------------------------------------------------------------------------

# 10d: phi3-medium-14b at full width, its depth cut: a tick traces every
# decode step of every layer (a 16-step prefill tick of 40 layers is ~50k
# nodes), so each engine holds TRACED_SERVE_LAYERS layers
TRACED_SERVE_LAYERS = 2
TRACED_SERVE_CONFIG = dict(SERVE_CONFIG, num_blocks=128)
TRACED_SERVE_REQUESTS = 8
# 10c: the traced zoo forward's batch (its logits are (2, 1024, 262144) bf16)
ZOO_BATCH, ZOO_SEQ = 2, 1024


def clone_tree(tree):
    return torch.utils._pytree.tree_map(lambda t: t.clone(), tree)


def auto_verdicts(label, app) -> None:
    """The verdicts the default policy ("auto") gives a compiled app's
    sites on this card: its pipelined graph lowered again under "auto"
    (nothing traced again, launches uncounted); prints the tiers, the
    declined sites and the seconds of verdicts and tiles."""
    t0 = time.perf_counter()
    plan = lower_pipelines(app.pipelined.graph, _pipelined_members(app.pipelined),
                           policy="auto", hw=app.options.resolved_hw(),
                           target=target_for(app.state.device, app.options.capture))
    rows = [r for r in plan.verdict_table() if r["executable"]]
    tiers: dict[str, int] = {}
    for r in rows:
        tier = f"{r['kernel']} {r['source']} -> {r['decision']}"
        tiers[tier] = tiers.get(tier, 0) + 1
    measured = list(dict.fromkeys(
        (r["kernel"], round(r["meas_kernel_us"], 2), round(r["meas_closure_us"], 2),
         tuple(sorted((r["tile"] or {}).items())))
        for r in rows if r["source"] == "measured"))
    tiled = list(dict.fromkeys((r["kernel"], tuple(sorted(r["tile"].items())))
                               for r in rows if r["tile"]))
    print(f"{label} under auto: {len(rows)} sites {tiers}; measured, each distinct (kernel "
          f"us, closure us, tile) {measured}; tiles, each distinct {tiled}; verdicts {plan.verdict_s:.3f} s, tiles "
          f"{plan.tune_s:.3f} s, {time.perf_counter() - t0:.2f} s in all", flush=True)


def compiled_train_step(label, cfg, opt, tc, state, batch, mode):
    """`compile_train_step` in `mode`, timed; returns (app, trace s, passes s).
    A kitsune step's sites also get the default policy's verdicts printed."""
    t0 = time.perf_counter()
    app = compile_train_step(cfg, opt, tc, state=state, batch=batch, compile_mode=mode,
                             lowering_policy="always")
    total = time.perf_counter() - t0
    if mode == "kitsune":
        auto_verdicts(f"traced {label}", app)
    trace_s = app.pass_records[0].seconds
    low = app.lowering.summary() if app.lowering is not None else "no kernel lowering"
    print(f"traced {label} {mode}: trace {trace_s:.1f} s ({len(app.graph.nodes)} nodes, "
          f"{len(app.traced.consts)} consts, {len(app.donation)} outputs written into the "
          f"donated state), the other passes {total - trace_s:.1f} s; {low}", flush=True)
    return app, trace_s, total - trace_s


def leaf_spread(got_state, want_state) -> dict[str, tuple[float, float, float]]:
    """Per parameter: (max |err|, elementwise ratio against bf16's
    atol=rtol, relative error) of one run's parameters against another's."""
    out = {}
    for (path, a), (_, b) in zip(flatten(got_state["params"]), flatten(want_state["params"])):
        err, ratio = worst(a, b, TOL[torch.bfloat16])
        out[path] = (err, ratio, rel_err(a, b))
    return out


def hold_train_run(label, got_state, got_losses, want_state, want_losses, spread) -> None:
    """The compiled step's 3-step run against the eager step's from one
    state.  Both launch the same kernels; their sums differ in order (the
    traced attention backward, split reductions), and AdamW turns a
    gradient's last bits into whole bf16 ulps of a parameter.  So each
    parameter is held by phase 3's bf16 dW rule (`check`), taken over the
    trajectory: within FLOOR_FACTOR times the eager run's own spread over
    three reorderings of its sums (`spread`: the same steps on the batch
    rows reversed, and with the chunked attention's online softmax over
    chunks of 512 and of 256 keys instead of 1024) -- elementwise ratio,
    max |err| and relative error alike -- and never looser than phase 3's
    bounds (a ratio of 1 against atol=rtol=2e-2, a relative error of 1e-2).
    Losses within 1e-3 relative."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses))
    worst_rel, bad = 0.0, []
    for path, (err, ratio, rel) in leaf_spread(got_state, want_state).items():
        f_err, f_ratio, f_rel = spread[path]
        err_limit = FLOOR_FACTOR * f_err if ratio > 1.0 else math.inf
        ratio_limit = max(1.0, FLOOR_FACTOR * f_ratio)
        rel_limit = max(REL_TOL[torch.bfloat16], FLOOR_FACTOR * f_rel)
        worst_rel = max(worst_rel, rel)
        if err > err_limit or ratio > ratio_limit or rel > rel_limit:
            bad.append((path, err, ratio, rel, (err_limit, ratio_limit, rel_limit)))
    spread_rel = max(r for _, _, r in spread.values())
    print(f"{label}: losses {got_losses} against eager {want_losses} (max relative "
          f"difference {loss_rel:.3g}, limit 1e-3); parameters' worst relative error "
          f"{worst_rel:.3g} against the eager run, whose own spread over three "
          f"reorderings of its sums reaches {spread_rel:.3g} (limit per parameter "
          f"{FLOOR_FACTOR:g} times its spread, at least atol=rtol=2e-2 and 1e-2)", flush=True)
    if loss_rel > 1e-3 or bad:
        raise AssertionError(f"{label}: losses {got_losses}, eager {want_losses}; "
                             f"parameters out of bounds (path, err, ratio, rel, limits) {bad}")


def eager_spread(name, state, eager, batches, eager_state) -> dict[str, tuple]:
    """The eager run's own spread (`leaf_spread` per parameter, the worst
    of three): the same steps from `state` with their sums reordered -- the
    batch rows reversed, and the chunked attention's online softmax over
    chunks of 512 and of 256 keys instead of 1024."""
    spread: dict[str, tuple[float, float, float]] = {}
    flipped = [{k: v.flip(0) for k, v in b.items()} for b in batches]
    for what, data, chunk in (("batch rows reversed", flipped, None),
                              ("attention in chunks of 512 keys", batches, 512),
                              ("attention in chunks of 256 keys", batches, 256)):
        ctx = (model_atoms.patched(attention=functools.partial(model_lm.chunked_attention,
                                                               chunk=chunk))
               if chunk else contextlib.nullcontext())
        with ctx:
            other, _, _ = train_steps(f"{name} eager ({what})", clone_tree(state), eager,
                                      data, {})
        for path, vals in leaf_spread(other, eager_state).items():
            spread[path] = tuple(max(a, b) for a, b in zip(spread.get(path, vals), vals))
        del other
        free()
    return spread


def phase_traced_train(name, batch, seq, want) -> dict[str, int]:
    """10a / 10b: `compile_train_step` at full width and depth: 3 kitsune
    steps against 3 eager `make_train_step` steps from the same weights and
    batches (`hold_train_run`, against the eager run's own spread over
    three reorderings of its sums), each kitsune step launching
    `want`; then the same trace compiled for bsp, 2 steps captured and 1
    uncaptured.  Prints
    the trace and pass seconds, ms a step of each mode and the peak memory
    of the kitsune run.  Returns the kitsune run's launches."""
    cfg = get_config(name)
    opt = adamw(TRAIN_LR)
    tc = TrainConfig(remat=True, xent_chunk=512)
    state = make_train_state(cfg, opt, seed=0, device="cuda")
    at = train_batches(cfg, batch, seq)
    batches = [at(i) for i in range(3)]
    eager = make_train_step(cfg, opt, tc)
    eager_state, eager_losses, eager_s = train_steps(f"{name} eager", clone_tree(state), eager,
                                                     batches, {})
    spread = eager_spread(name, state, eager, batches, eager_state)
    app, trace_s, pass_s = compiled_train_step(name, cfg, opt, tc, state, batches[0], "kitsune")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, losses, kit_s = train_steps(f"{name} kitsune", state, app, batches, want)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hold_train_run(f"traced {name}", state, losses, eager_state, eager_losses, spread)
    del eager_state
    free()
    walk_s = captured_equals_walk(name, app, state, batches[:1], want)
    box = [state]

    def step():
        box[0], m = app(box[0], batches[0])
        m["loss"].item()
    profile_ticks(f"traced {name} kitsune captured step", step, n=1)
    state = box[0]
    stats = app.capture_stats()
    t0 = time.perf_counter()
    bsp = app.with_mode("bsp")      # the same trace, its passes run for bsp
    bsp_pass_s = time.perf_counter() - t0
    del app
    free()
    plain = {k: 0 for k in want}
    state, _, bsp_s = train_steps(f"{name} bsp captured", state, bsp, batches[:2], plain)
    state, _, bsp_walk_s = train_steps(f"{name} bsp uncaptured", state, bsp.uncaptured(),
                                       batches[:1], plain)
    print(f"traced {name}: ms a step (steps 2-3; bsp captured step 2, uncaptured step 1) "
          f"kitsune captured "
          f"{1e3 * sum(kit_s[1:]) / 2:.1f} (first {1e3 * kit_s[0]:.1f}: its programs built, "
          f"then the plan captured in {stats['capture_s']:.2f} s, graph pool "
          f"{stats['pool_bytes'] / 1e9:.2f} GB), kitsune uncaptured {1e3 * walk_s:.1f}, bsp "
          f"captured {1e3 * bsp_s[1]:.1f}, bsp uncaptured {1e3 * bsp_walk_s[0]:.1f}, eager "
          f"make_train_step {1e3 * sum(eager_s[1:]) / 2:.1f}; trace {trace_s:.1f} s + passes "
          f"{pass_s:.1f} s (bsp: the same trace, passes {bsp_pass_s:.1f} s); depth not cut "
          f"({cfg.n_layers} layers); kitsune peak allocated {peak / 1e9:.2f} GB", flush=True)
    del bsp, state
    free()
    return launches


def captured_equals_walk(label, app, state, batches, want) -> float:
    """`batches` through the captured plan (replays) and through its
    uncaptured walk from copies of one state: every step's state and loss
    bitwise alike, each launching `want`.  Returns the walk's last step's
    seconds."""
    walk_state = clone_tree(state)
    walk = app.uncaptured()
    for i, b in enumerate(batches):
        state, (loss,), _ = train_steps(f"{label} kitsune captured", state, app, [b], want)
        walk_state, (walk_loss,), secs = train_steps(f"{label} kitsune uncaptured",
                                                     walk_state, walk, [b], want)
        same = loss == walk_loss and all(
            torch.equal(a, w) for a, w in zip(leaves(state), leaves(walk_state)))
        if not same:
            raise AssertionError(f"traced {label} step {i}: the replay differs from the "
                                 f"uncaptured walk (loss {loss} against {walk_loss})")
    print(f"traced {label}: {len(batches)} replayed steps bitwise the uncaptured walk's "
          f"(state and loss)", flush=True)
    del walk_state, walk
    return secs[0]


def phase_traced_zoo() -> dict[str, int]:
    """10c: the zoo forward of gemma3-1b at full width and depth, traced
    and compiled in kitsune mode, against the raw forward."""
    zf = zoo.build("gemma3-1b", batch=ZOO_BATCH, seq=ZOO_SEQ, reduced=False, device="cuda")
    with torch.no_grad():
        want = zf.fn(*zf.example_inputs)
    t0 = time.perf_counter()
    app = repro_torch.compile(zf.fn, zf.example_inputs, mode="kitsune",
                              lowering_policy="always")
    compile_s = time.perf_counter() - t0
    app(*zf.example_inputs)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = app(*zf.example_inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    err, rel = check("traced zoo gemma3-1b forward", got, want, torch.bfloat16)
    walk = app.uncaptured()
    walk(*zf.example_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walked = walk(*zf.example_inputs)
    torch.cuda.synchronize()
    walk_wall = time.perf_counter() - t0
    if not torch.equal(got, walked):
        raise AssertionError("traced zoo gemma3-1b forward: the replay differs from the walk")
    print(f"traced zoo gemma3-1b forward ({ZOO_BATCH} x {ZOO_SEQ}, {len(app.graph.nodes)} nodes, "
          f"traced and compiled in {compile_s:.1f} s): kitsune captured {1e3 * wall:.1f} ms "
          f"(bitwise the uncaptured walk, {1e3 * walk_wall:.1f} ms), logits "
          f"max |err| {err:.3g}, relative {rel:.3g} against the raw forward; launches "
          f"{ {k: n for k, n in launches.items() if n} }", flush=True)
    expect_launches("traced zoo", launches, {"fused_mlp_swiglu": zf.cfg.n_layers})
    del app, walk, zf, got, want, walked
    free()
    return launches


def compiled_tick_equals_walk(cfg, params, eng) -> None:
    """One replay of each bucket's captured plan of `eng`'s compiled tick
    on the engine's pools against that plan's uncaptured walk on copies of
    them: tokens, positions, logits and every page but the null page bit
    for bit."""
    bs = eng.sc.block_size
    for (n_steps, v_blocks), step in sorted(eng._steps.items()):
        state = tick_state(cfg, eng, n_steps, seed=n_steps)
        copies = state_copies(eng)
        feed = {k: state[k].to("cuda") for k in ("tokens", "n_tok", "pos", "tables")}
        want = step.app.uncaptured()(params, copies, feed)
        got = step(state)
        torch.cuda.synchronize()
        same = {k: torch.equal(got[k], want[k]) for k in ("tokens_next", "pos", "logits")}
        same["pages"] = (same_bytes(eng.kp[bs:], copies["kp"][bs:])
                         and same_bytes(eng.vp[bs:], copies["vp"][bs:]))
        print(f"traced serve {eng.cfg.kv_cache_dtype} paged: replayed plan ({n_steps} steps, {v_blocks} blocks) against "
              f"its uncaptured walk: {same}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"compiled tick ({n_steps}, {v_blocks}): the replay differs "
                                 f"from the walk: {same}")
        del copies


def phase_traced_serve() -> dict[str, dict[str, int]]:
    """10d: both engines with compile_mode="kitsune" against
    compile_mode=None on phi3-medium-14b at full width, depth cut to
    TRACED_SERVE_LAYERS: the same tokens; each bucket's captured plan of
    the paged engine bitwise its uncaptured walk; and the paged engine
    again with a float8 cache ("paged_fp8": e4m3 pools, B8 in its e4m3
    form)."""
    base = dataclasses.replace(get_config(SERVE_ARCH), n_layers=TRACED_SERVE_LAYERS)
    params = get_model(base).init(seed=0, device="cuda")
    prompts = dict(list(serve_prompts(base.vocab).items())[:TRACED_SERVE_REQUESTS])
    runs = {}
    for engine in ("paged", "legacy", "paged_fp8"):
        out = {}
        cfg = (dataclasses.replace(base, kv_cache_dtype="float8_e4m3fn")
               if engine == "paged_fp8" else base)
        for mode in (None, "kitsune"):
            sc = ServeConfig(**{**TRACED_SERVE_CONFIG, "compile_mode": mode,
                                "lowering_policy": "always"})
            if engine == "legacy":
                sc = ServeConfig(max_len=160, batch=TRACED_SERVE_CONFIG["batch"],
                                 compile_mode=mode, lowering_policy="always")
            t0 = time.perf_counter()
            if engine != "legacy":
                eng = PagedServingEngine(cfg, params, sc, eos_id=-1)
                for rid, p in prompts.items():
                    eng.submit(p, rid=rid)
            else:
                eng = ServingEngine(cfg, params, sc, eos_id=-1)
                for rid, p in prompts.items():
                    eng.submit(rid, p[:48])
            torch.cuda.synchronize()
            K.reset_launch_counts()
            done = eng.run_until_done()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.launch_counts()
            launches["paged_flash_decode_e4m3"] = K.launches_by_dtype(
                "paged_flash_decode").get("float8_e4m3fn", 0)
            out[mode] = done
            ticks = eng.pos if engine == "legacy" else eng.ticks
            if engine != "legacy":
                compiled = [fn.app for fn in eng._steps.values() if hasattr(fn, "app")]
            else:
                compiled = [eng._step.app] if mode else []
            graphs = eng.graph_stats()
            passes_s = sum(r.seconds for a in compiled for r in a.pass_records)
            for a in compiled:
                auto_verdicts(f"traced serve {engine} tick", a)
            print(f"traced serve {engine} compile_mode={mode}: {len(done)} requests, "
                  f"{sum(len(v) for v in done.values())} tokens, {ticks} ticks in {wall:.2f} s, "
                  f"of which {passes_s:.2f} s tracing and compiling {len(compiled)} tick "
                  f"programs and {graphs['capture_s']:.2f} s capturing {graphs['graphs']} "
                  f"graphs after {graphs['warm_up_s']:.2f} s of warm-ups (a compiled plan's "
                  f"warm-up is its first tick) ({graphs['replays']} replays, graph pools "
                  f"{graphs['pool_bytes'] / 1e6:.1f} MB): "
                  f"{wall - passes_s - graphs['warm_up_s'] - graphs['capture_s']:.2f} s in "
                  f"the other ticks; launches { {k: n for k, n in launches.items() if n} }",
                  flush=True)
            if mode is not None:
                runs[f"traced_serve_{engine}"] = launches
                if engine != "legacy":
                    compiled_tick_equals_walk(cfg, params, eng)
            del eng
            free()
        if out[None] != out["kitsune"]:
            diff = [rid for rid in out[None] if out[None][rid] != out["kitsune"].get(rid)]
            raise AssertionError(f"traced serve {engine}: tokens differ for requests {diff}")
        print(f"traced serve {engine}: compile_mode=kitsune tokens == compile_mode=None tokens "
              f"({cfg.n_layers} of phi3-medium-14b's 40 layers)", flush=True)
    want = {"paged_flash_decode": 1, "fused_mlp_swiglu": 1}
    missing = [k for k in want if not runs["traced_serve_paged"][k]]
    fp8 = runs["traced_serve_paged_fp8"]
    if (missing or not runs["traced_serve_legacy"]["flash_decode"]
            or not fp8["paged_flash_decode"]
            or fp8["paged_flash_decode_e4m3"] != fp8["paged_flash_decode"]):
        raise AssertionError(f"traced serve: kernels never launched: {missing} {runs}")
    del params
    free()
    return runs


def phase_traced_paged_atom() -> dict[str, int]:
    """10e: a traced `paged_decode_atom` at phase 7's decode shape and the
    output projection after it, the atom lowered to B8 in kitsune mode,
    against the plain version through the same projection."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    b, hq, hkv, d, bs, v_blocks = 8, 40, 10, 128, 16, 32
    rows = (b * v_blocks + 1) * bs
    q = randn(gen, b, hq, 1, d, dtype=torch.bfloat16)
    kp, vp = (randn(gen, rows, hkv, d, dtype=torch.bfloat16) for _ in range(2))
    tables = (1 + torch.randperm(b * v_blocks, generator=gen, device="cuda")).to(
        torch.int32).reshape(b, v_blocks)
    valid = torch.randint(1, v_blocks * bs + 1, (b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    wo = randn(gen, hq * d, 5120, dtype=torch.bfloat16, scale=(hq * d) ** -0.5)
    atom = paged_decode_atom(bs)

    def site(q, kp, vp, tables, valid):
        """Decode attention, then phi3's output projection."""
        return atom(q, kp, vp, tables, valid).reshape(b, hq * d) @ wo

    app = repro_torch.compile(site, (q, kp, vp, tables, valid), mode="kitsune",
                              lowering_policy="always")
    matches = [m for pl in app.lowering.pipelines.values() for m in pl.matches]
    K.reset_launch_counts()
    got = app(q, kp, vp, tables, valid)
    launches = K.launch_counts()
    want = paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                    block_size=bs).reshape(b, hq * d) @ wo
    err, rel = check("traced paged_decode_atom", got, want, torch.bfloat16)
    print(f"traced paged_decode_atom: plan {[m.label() for m in matches]}, launches "
          f"{ {k: n for k, n in launches.items() if n} }, max |err| {err:.3g}, relative "
          f"{rel:.3g} against the plain version", flush=True)
    expect_launches("traced paged_decode_atom", launches, {"paged_flash_decode": 1})
    return launches


def phase_traced() -> dict[str, dict[str, int]]:
    """Returns each phase-10 run's launches, per kernel."""
    t_phase = time.perf_counter()
    free()
    print(f"phase 10 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    gemma, whisper = get_config("gemma3-1b"), get_config("whisper-small")
    runs = {}
    t0 = time.perf_counter()
    runs["traced_train_gemma3"] = phase_traced_train(
        "gemma3-1b", 4, 2048, {"fused_mlp_swiglu": 2 * gemma.n_layers,
                               "fused_mlp_swiglu_bwd": gemma.n_layers,
                               "fused_mlp": 0, "fused_mlp_bwd": 0})
    print(f"phase 10a: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs["traced_train_whisper"] = phase_traced_train(
        "whisper-small", 8, 448, {"fused_mlp": 3 * whisper.n_layers,
                                  "fused_mlp_bwd": 2 * whisper.n_layers,
                                  "fused_mlp_swiglu": 0, "fused_mlp_swiglu_bwd": 0})
    print(f"phase 10b: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs["traced_zoo_gemma3"] = phase_traced_zoo()
    print(f"phase 10c: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs.update(phase_traced_serve())
    print(f"phase 10d: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs["traced_paged_atom"] = phase_traced_paged_atom()
    print(f"phase 10e: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 11: the legacy engine's tick through cached_jit
# ---------------------------------------------------------------------------

# phi3-medium-14b at full width and depth behind the legacy engine: 8
# prompts of phase 7 cut to 48 tokens, fed one token a tick, then decoded to
# the end of a 160-position cache
LEGACY_CONFIG = dict(max_len=160, batch=8)
LEGACY_PROMPT = 48


class EagerLegacyEngine(ServingEngine):
    """The legacy engine with every tick run eagerly on the card, no graph:
    the oracle its cached_jit tick is held to."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._step = lambda params, cache, feed: serve_step(params, {**feed, "cache": cache},
                                                            self.cfg)

    def graph_stats(self) -> dict:
        return graph_stats(())


def legacy_engine(cls, cfg, params, prompts):
    eng = cls(cfg, params, ServeConfig(**LEGACY_CONFIG), eos_id=-1)
    for rid, p in prompts.items():
        eng.submit(rid, p)
    return eng


def phase_legacy_tick() -> dict[str, dict[str, int]]:
    """11: phi3-medium-14b at full width and depth behind the legacy engine,
    every tick eager (`EagerLegacyEngine`) and then through cached_jit (one
    graph, every later tick a replay): bitwise the same tokens, 40
    flash_decode and 40 small-M fused_mlp_swiglu launches a tick in both;
    ms a tick, capture seconds and graph pool bytes; three ticks of each
    profiled for the device's idle share."""
    t0 = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    params = get_model(cfg).init(seed=0, device="cuda")
    describe(f"legacy {SERVE_ARCH}", cfg, params, t0)
    prompts = {rid: p[:LEGACY_PROMPT] for rid, p in
               list(serve_prompts(cfg.vocab).items())[:LEGACY_CONFIG["batch"]]}
    runs, out, ms = {}, {}, {}
    for form, cls in (("eager", EagerLegacyEngine), ("cached_jit", ServingEngine)):
        eng = legacy_engine(cls, cfg, params, prompts)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out[form] = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        launches["fused_mlp_swiglu_small_m"] = K.launches_by_form("fused_mlp_swiglu").get(
            "small_m", 0)
        g = eng.graph_stats()
        ticks = eng.pos
        ms[form] = 1e3 * (wall - g["warm_up_s"] - g["capture_s"]) / (ticks - g["graphs"])
        print(f"legacy {form}: {len(out[form])} requests, "
              f"{sum(len(v) for v in out[form].values())} tokens, {ticks} ticks in {wall:.2f} s: "
              f"{1e3 * wall / ticks:.2f} ms a tick ({ms[form]:.2f} without the first tick's "
              f"warm-up and capture, {g['warm_up_s']:.2f} + {g['capture_s']:.2f} s); graphs "
              f"{g['graphs']}, replays "
              f"{g['replays']}, graph pool {g['pool_bytes'] / 1e6:.1f} MB; launches "
              f"{ {k: n for k, n in launches.items() if n} }", flush=True)
        want = {"flash_decode": cfg.n_layers * ticks, "fused_mlp_swiglu": cfg.n_layers * ticks,
                "fused_mlp_swiglu_small_m": cfg.n_layers * ticks, "paged_flash_decode": 0}
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"legacy {form}: launched {launches}, want {want}")
        if form == "cached_jit" and (g["graphs"] != 1 or g["replays"] != ticks - 1):
            raise AssertionError(f"legacy cached_jit: {g} over {ticks} ticks: not every tick "
                                 f"after the first replayed the one graph")
        runs[f"legacy_{form}"] = launches
        del eng
        free()
        # three decode ticks of a fresh engine, all slots past their prompts
        eng = legacy_engine(cls, cfg, params, {rid: p[:4] for rid, p in prompts.items()})
        for _ in range(6):
            eng.tick()
        profile_ticks(f"legacy {SERVE_ARCH} {form} tick ({eng.sc.batch} slots, 40 layers)",
                      eng.tick)
        del eng
        free()
    if out["eager"] != out["cached_jit"]:
        diff = [rid for rid in out["eager"] if out["eager"][rid] != out["cached_jit"].get(rid)]
        raise AssertionError(f"legacy: cached_jit tokens differ from eager for requests {diff}")
    print(f"legacy: cached_jit tokens bitwise equal to eager; {ms['eager']:.2f} -> "
          f"{ms['cached_jit']:.2f} ms a tick", flush=True)
    runs.update(legacy_fp8(cfg, params, prompts))
    del params
    free()
    return {"legacy_phi3": runs["legacy_cached_jit"], "legacy_phi3_eager": runs["legacy_eager"],
            "legacy_phi3_fp8": runs["legacy_fp8"]}


def legacy_fp8(cfg, params, prompts) -> dict[str, dict[str, int]]:
    """11, float8 KV cache: the same weights and prompts with
    kv_cache_dtype="float8_e4m3fn" through the legacy engine, eager and
    through cached_jit: bitwise the same tokens, flash_decode's e4m3 form
    40 times a tick."""
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn")
    out, runs = {}, {}
    for form, cls in (("eager", EagerLegacyEngine), ("cached_jit", ServingEngine)):
        eng = legacy_engine(cls, cfg8, params, prompts)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out[form] = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = cfg.n_layers * eng.pos
        e4m3 = K.launches_by_dtype("flash_decode").get("float8_e4m3fn", 0)
        print(f"legacy fp8 {form}: {eng.pos} ticks in {wall:.2f} s ({1e3 * wall / eng.pos:.2f} ms "
              f"a tick, the first tick's warm-up and capture included); cache "
              f"{eng.cache['k'].dtype}; flash_decode e4m3 launches {e4m3}", flush=True)
        if eng.cache["k"].dtype != E4M3 or e4m3 != n or K.launch_counts()["flash_decode"] != n:
            raise AssertionError(f"legacy fp8 {form}: {e4m3} e4m3 flash_decode launches of "
                                 f"{K.launch_counts()['flash_decode']}, want {n}")
        runs[f"legacy_fp8{'_eager' if form == 'eager' else ''}"] = K.launch_counts()
        del eng
        free()
    if out["eager"] != out["cached_jit"]:
        raise AssertionError("legacy fp8: cached_jit tokens differ from eager")
    print("legacy fp8: cached_jit tokens bitwise equal to eager", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 12: the default lowering policy ("auto")
# ---------------------------------------------------------------------------

# phase 7's decode shape: the B4 / B8 sites whose tiles phase 12 tunes
DECODE_B, DECODE_HQ, DECODE_HKV, DECODE_S, DECODE_D, DECODE_BS = 8, 40, 10, 512, 128, 16


def cache_stats() -> tuple[dict, dict]:
    return verdict_cache().stats(), K.tune_cache().stats()


def verdict_rows(label, app) -> list[dict]:
    """Print each executable site's verdict (tier, decision, estimated and
    measured microseconds, tile) and fail unless every site has a tier of
    "auto" and every measured verdict follows its own numbers."""
    rows = [r for r in app.lowering_verdicts() if r["executable"]]
    for r in rows:
        meas = (f", measured kernel {r['meas_kernel_us']:.2f} us vs closure "
                f"{r['meas_closure_us']:.2f} us" if r["source"] == "measured" else "")
        note = f" ({r['note']})" if r["note"] else ""
        print(f"{label} site {r['pipeline']} {r['kernel']} at {r['out']}: {r['source']} -> "
              f"{r['decision']}, est kernel {r['est_kernel_us']:.2f} us vs closure "
              f"{r['est_closure_us']:.2f} us{meas}, tile {r['tile']}{note}", flush=True)
        if r["source"] not in ("cost", "measured"):
            raise AssertionError(f"{label}: {r['kernel']} has no verdict of auto's tiers")
        if r["source"] == "measured":
            want = ("lowered" if r["meas_kernel_us"] * MEASURE_MARGIN <= r["meas_closure_us"]
                    else "declined")
            if r["decision"] != want:
                raise AssertionError(f"{label}: {r['kernel']} {r['decision']}, its numbers "
                                     f"say {want}")
    return rows


def compile_auto(label, graph, example_inputs=None):
    """Compile in kitsune mode under the default policy ("auto"): print the
    compile's seconds, the verdicts' and the tiles' apart, and every site's
    verdict; compile again and fail unless every site hits both caches."""
    v0, t0s = cache_stats()
    args = () if example_inputs is None else (example_inputs,)
    t0 = time.perf_counter()
    app = repro_torch.compile(graph, *args, mode="kitsune")
    compile_s = time.perf_counter() - t0
    v1, t1s = cache_stats()
    low = app.lowering
    print(f"{label} auto: compile {compile_s:.2f} s, verdicts {low.verdict_s:.3f} s, "
          f"tiles {low.tune_s:.3f} s; verdicts decided {v1['misses'] - v0['misses']}, "
          f"tiles chosen {t1s['misses'] - t0s['misses']}", flush=True)
    rows = verdict_rows(label, app)
    again = repro_torch.compile(graph, *args, mode="kitsune")
    v2, t2s = cache_stats()
    n, n_tiles = len(rows), sum(1 for r in rows if r["tile"] is not None)
    if (v2["misses"], t2s["misses"]) != (v1["misses"], t1s["misses"]) or \
            v2["hits"] - v1["hits"] != n or t2s["hits"] - t1s["hits"] != n_tiles:
        raise AssertionError(f"{label}: a second compile missed a cache: verdicts "
                             f"{v1} -> {v2}, tiles {t1s} -> {t2s}, {n} sites, "
                             f"{n_tiles} tiled")
    print(f"{label} auto: a second compile hit both caches at all {n} sites "
          f"({again.lowering.verdict_s:.4f} s verdicts, {again.lowering.tune_s:.4f} s tiles)",
          flush=True)
    return app


def timed_runs(run, n: int = 3):
    """n runs, each ending in a sync; (the last run's output, its seconds,
    the launches each run made, counted from zero around the run)."""
    counts = {}
    for _ in range(n):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
    return out, wall, counts


def auto_against_always(label, graph, feeds, params, launches: dict) -> None:
    """12a/b: the app compiled under "auto" (verdicts, tiles, a second
    compile all hits) and under "always", each run three times captured
    (the last replay timed), outputs held to each other within MODEL_TOL;
    the auto runs' launches (each counted from zero) go into `launches`."""
    app = compile_auto(label, graph)
    out, wall, counts = timed_runs(lambda: app.run(feeds, params).outputs)
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    auto_out = {k: v.clone() for k, v in out.items()}
    del app, out
    free()
    forced = repro_torch.compile(graph, mode="kitsune", lowering_policy="always")
    want, wall_always, _ = timed_runs(lambda: forced.run(feeds, params).outputs)
    for k in want:
        err = rel_err(auto_out[k], want[k])
        print(f"{label} [{k}] auto vs always: rel err {err:.3e}", flush=True)
        if err > MODEL_TOL:
            raise AssertionError(f"{label} [{k}]: auto differs from always by {err:.3e}")
    print(f"{label}: auto {wall * 1e3:.2f} ms, always {wall_always * 1e3:.2f} ms a run "
          f"(replayed, host clock)", flush=True)
    del forced, want, auto_out
    free()


def tuned_decode_tiles(launches: dict) -> None:
    """12c: B4 and B8 traced at phase 7's decode shape (bf16, ragged valid
    lengths) and compiled under "auto": the tile the autotuner chose and
    its time, every candidate of the grid timed as phase 3 times the
    kernels (cold L2) beside it, and the compiled site held to the plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    b, hq, hkv, s_len, d, bs = (DECODE_B, DECODE_HQ, DECODE_HKV, DECODE_S, DECODE_D,
                                DECODE_BS)
    q = randn(gen, b, hq, 1, d, dtype=torch.bfloat16)
    k, v = (randn(gen, b, hkv, s_len, d, dtype=torch.bfloat16) for _ in range(2))
    valid = torch.randint(1, s_len + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    v_blocks = s_len // bs
    rows = (b * v_blocks + 1) * bs
    kp, vp = (randn(gen, rows, hkv, d, dtype=torch.bfloat16) for _ in range(2))
    tables = (1 + torch.randperm(b * v_blocks, generator=gen, device="cuda")).to(
        torch.int32).reshape(b, v_blocks)
    atom = paged_decode_atom(bs)
    cases = {
        "flash_decode": (lambda q, k, v, n: K.decode_attention(q, k, v, valid_len=n) * 2.0,
                         (q, k, v, valid), decode_tile_candidates(s_len),
                         lambda c: K.flash_decode(q, k, v, valid_len=valid, block_s=c),
                         flash_decode_plain(q, k, v, valid_len=valid) * 2.0),
        "paged_flash_decode": (lambda *a: atom(*a) * 2.0, (q, kp, vp, tables, valid),
                               decode_tile_candidates(s_len, page_size=bs),
                               lambda c: K.paged_flash_decode(q, kp, vp, tables,
                                                              valid_len=valid,
                                                              block_size=bs, block_s=c),
                               paged_flash_decode_plain(q, kp, vp, tables, valid_len=valid,
                                                        block_size=bs) * 2.0),
    }
    for name, (fn, inputs, grid, launch, want) in cases.items():
        app = compile_auto(f"tuned {name}", fn, inputs)
        (km,) = [m for p in app.lowering.pipelines.values() for m in p.matches
                 if m.kernel == name]
        got, _, counts = timed_runs(lambda: app(*inputs), n=2)
        for kern, n in counts.items():
            launches[kern] = launches.get(kern, 0) + n
        err, rel = check(f"tuned {name}", got, want, torch.bfloat16)
        times = {c["block_s"]: cuda_ms(lambda c=c: launch(c["block_s"]), 20, cold=True)
                 for c in grid}
        print(f"tuned {name}: winner block_s {km.tile.get('block_s')} at "
              f"{km.tile.get('us', float('nan')):.2f} us (replayed, warm), verdict "
              f"{km.verdict.source} -> {km.verdict.decision}; grid (cold L2, ms) "
              f"{ {c: round(t, 5) for c, t in times.items()} }; max |err| {err:.3g}, "
              f"relative {rel:.3g} against the plain version", flush=True)
        del app


def tiny_instances_auto(launches: dict) -> None:
    """12d: the five tiny instances (f32) on the card under "auto": sites
    inside the band are measured here, as replays of captured candidates
    timed with CUDA events; outputs held to "always" within MODEL_TOL."""
    for name, (graph, feeds) in apps.tiny_instances("cuda", seed=6).items():
        params = repro_torch.init_params(graph, 0, device="cuda", scale=1.0)
        for leaves in params.values():
            if "w" in leaves:
                leaves["w"] /= leaves["w"].shape[0] ** 0.5
        auto_against_always(f"tiny {name}", graph, feeds, params, launches)


def phase_auto() -> dict[str, dict[str, int]]:
    """Phase 12; returns its runs' launches, per kernel."""
    t_phase = time.perf_counter()
    free()
    full: dict[str, int] = {}
    graph, params, feeds = llama_case()
    auto_against_always("llama3_8b", graph, feeds, params, full)
    del params, feeds
    free()
    for name, feeds in app_cases().items():
        graph = apps.APPS[name]()
        params = repro_torch.init_params(graph, seed=0, dtype=torch.bfloat16, device="cuda")
        auto_against_always(name, graph, feeds, params, full)
        del params, feeds
        free()
    graph, feeds = split_reduction_case()
    auto_against_always("split_reduction", graph, feeds, {}, full)
    del feeds
    free()
    print(f"phase 12a/b: {time.perf_counter() - t_phase:.1f} s", flush=True)
    tiles: dict[str, int] = {}
    tuned_decode_tiles(tiles)
    tiny: dict[str, int] = {}
    tiny_instances_auto(tiny)
    print(f"phase 12 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"auto_apps": full, "auto_decode_tiles": tiles, "auto_tiny": tiny}


def to_device(tree: dict, device) -> dict:
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 13: the distributed layer at world size 1 (NCCL, a (1, 1) mesh)
# ---------------------------------------------------------------------------

DIST_TRAIN = dict(batch=2, seq=1024)     # 13a's batch and sequence
DIST_STEPS = 3                           # 13a's steps of each run
DIST_SERVE_LAYERS = 2                    # 13d: phi3-medium-14b cut to 2 layers
DIST_KERNELS = ("fused_mlp_swiglu", "fused_mlp_swiglu_bwd", "queue_reduce")


def leaves_equal(a, b) -> list[str]:
    """Paths whose leaves differ (DTensors compared by their full value)."""
    from repro_torch.distributed.sharding import full_tensor
    bb = dict(flatten(b))
    return [p for p, t in flatten(a) if not torch.equal(full_tensor(t), full_tensor(bb[p]))]


def dist_train(sharder) -> tuple[dict[str, dict[str, int]], dict]:
    """13a: gemma3-1b at full width and depth, DIST_STEPS `make_train_step`
    steps under `sharder` (DTensor parameters and moments) against as many
    NULL steps from the same state and batches: losses and parameters
    bitwise, or within `hold_train_run`'s reorder bound (said which); B2 /
    B7 / B5 launches equal to the NULL run's; ms a step of each (the steps
    after the first), each step's device idle share and the sharded step's
    collectives (CommDebugMode).  Returns the two runs' launches and the
    sharded state."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = get_config("gemma3-1b")
    opt = adamw(TRAIN_LR)
    tc = TrainConfig(remat=True, xent_chunk=512)
    state = make_train_state(cfg, opt, seed=0, device="cuda")
    at = train_batches(cfg, DIST_TRAIN["batch"], DIST_TRAIN["seq"])
    batches = [at(i) for i in range(DIST_STEPS)]
    null_step = make_train_step(cfg, opt, tc)
    K.reset_launch_counts()
    null_state, null_losses, null_s = train_steps("13a gemma3-1b NULL", clone_tree(state),
                                                  null_step, batches, {})
    null_launches = K.launch_counts()
    t0 = time.perf_counter()
    params = sharder.distribute(state["params"])
    sharded = {"params": params, "opt": opt.init(params)}
    place_s = time.perf_counter() - t0
    step = make_train_step(cfg, opt, tc, sharder=sharder)
    K.reset_launch_counts()
    sharded, losses, sh_s = train_steps("13a gemma3-1b sharded", sharded, step, batches, {})
    launches = K.launch_counts()
    bad = {k: (launches[k], null_launches[k]) for k in DIST_KERNELS
           if launches[k] != null_launches[k]}
    if bad or not null_launches["fused_mlp_swiglu"] or not null_launches["fused_mlp_swiglu_bwd"]:
        raise AssertionError(f"13a: sharded launches {launches}, NULL {null_launches}: {bad}")
    differ = leaves_equal(sharded["params"], null_state["params"])
    if losses == null_losses and not differ:
        verdict = "bitwise equal"
    else:
        spread = eager_spread("13a gemma3-1b", state, null_step, batches, null_state)
        plain = {"params": sharder_full(sharded["params"])}
        hold_train_run("13a sharded gemma3-1b", plain, losses, null_state, null_losses, spread)
        verdict = f"within the reorder bound ({len(differ)} leaves not bitwise)"
    steady = {k: sum(v[1:]) / (len(v) - 1) for k, v in (("NULL", null_s), ("sharded", sh_s))}
    print(f"13a gemma3-1b sharded vs NULL ({DIST_TRAIN['batch']} x {DIST_TRAIN['seq']} tokens, "
          f"{DIST_STEPS} steps): losses {losses} vs {null_losses}, parameters {verdict}; "
          f"launches { {k: launches[k] for k in DIST_KERNELS} } each run; ms a step (mean of "
          f"steps 2-{DIST_STEPS}) NULL {1e3 * steady['NULL']:.1f}, sharded "
          f"{1e3 * steady['sharded']:.1f} (x{steady['sharded'] / steady['NULL']:.3f}); first "
          f"steps {1e3 * null_s[0]:.1f} / {1e3 * sh_s[0]:.1f}; placing the state "
          f"{place_s:.2f} s", flush=True)
    with CommDebugMode() as comm:
        step(sharded, batches[0])
    print(f"13a collectives a sharded step (CommDebugMode): total {comm.get_total_counts()}, "
          f"{ {str(k): v for k, v in comm.get_comm_counts().items()} }", flush=True)
    profile_train_step("13a gemma3-1b sharded", step, sharded, batches[0], steady["sharded"])
    profile_train_step("13a gemma3-1b NULL", null_step, null_state, batches[0], steady["NULL"])
    del null_state, state
    free()
    return {"dist_train_null": null_launches, "dist_train_sharded": launches}, sharded


def sharder_full(tree):
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.tree import tree_map
    return tree_map(full_tensor, tree)


def dist_restore(sharder, params) -> None:
    """13b: 13a's parameters saved (rank 0 writes) and restored by
    `restore_with_resharding` onto the mesh's placements: every leaf
    bitwise, with the seconds and bytes of each side."""
    from repro_torch.checkpoint import Checkpointer, restore_with_resharding
    ckpt = Path(tempfile.mkdtemp(prefix="dist_ckpt_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        Checkpointer(str(ckpt)).save(1, {"params": params})
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        like = {"params": sharder_full(params)}
        t0 = time.perf_counter()
        step, out = restore_with_resharding(str(ckpt), like,
                                            {"params": sharder.params_shardings(like["params"])})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        differ = leaves_equal(out["params"], params)
        placed = all(hasattr(t, "placements") for t in leaves(out["params"]))
        print(f"13b restore_with_resharding: step {step}, {len(leaves(params))} leaves, "
              f"{size / 1e9:.3f} GB on disk, save {save_s:.2f} s, restore {restore_s:.2f} s "
              f"({size / 1e9 / restore_s:.2f} GB/s); bitwise: {not differ}; every leaf a "
              f"DTensor on the mesh: {placed}", flush=True)
        if step != 1 or differ or not placed:
            raise AssertionError(f"13b: step {step}, leaves differing {differ[:5]}, placed "
                                 f"{placed}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def dist_pipeline_and_compression(params) -> dict[str, dict[str, int]]:
    """13c: `run_pipelined` with one stage over gemma3-1b's first four MLP
    blocks (B2 inside `layer_fn`) against the sequential call, and
    `error_feedback_allreduce` on NCCL over a gemma3-1b gradient against
    the plain quantize -> dequantize round trip: both bitwise."""
    from repro_torch.distributed.pipeline import run_pipelined
    from repro_torch.kernels import mlp_swiglu
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import (compress_int8, decompress_int8, error_feedback_allreduce,
                                   init_residuals)
    from repro_torch.train.step import chunked_softmax_xent, value_and_grad
    mlp = {k: v[:4].contiguous() for k, v in sharder_full(params)["blocks"]["sub0"]["mlp"].items()}

    def layer_fn(p, x):
        return x + mlp_swiglu(x, p["wg"], p["wu"], p["wd"])
    g = torch.Generator(device="cuda").manual_seed(13)
    xs = torch.randn((4, 256, mlp["wg"].shape[1]), generator=g, device="cuda").to(torch.bfloat16)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = run_pipelined(make_mesh((1,), ("stage",), "cuda"), layer_fn, mlp, xs, 1)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    pipe_launches = K.launch_counts()
    want = xs
    for i in range(4):
        want = layer_fn({k: v[i] for k, v in mlp.items()}, want)
    if not torch.equal(got, want) or pipe_launches["fused_mlp_swiglu"] != 16:
        raise AssertionError(f"13c pipeline: max |diff| {(got - want).abs().max().item()}, "
                             f"launches {pipe_launches}")
    print(f"13c run_pipelined, 1 stage x 4 layers x 4 microbatches of 256 rows: bitwise the "
          f"sequential call, {pipe_launches['fused_mlp_swiglu']} B2 launches, {pipe_s:.3f} s",
          flush=True)

    cfg = get_config("gemma3-1b")
    model = get_model(cfg)
    batch = train_batches(cfg, DIST_TRAIN["batch"], DIST_TRAIN["seq"])(0)
    full = sharder_full(params)

    def loss(p, b):
        hidden = model.forward(p, b, remat=True, return_hidden=True)
        return chunked_softmax_xent(hidden, p["embed"], b["tokens"], 1e-4, chunk=512)
    _, grads = value_and_grad(loss, full, batch)
    t0 = time.perf_counter()
    red, resid = error_feedback_allreduce(grads, init_residuals(grads))
    torch.cuda.synchronize()
    ef_s = time.perf_counter() - t0
    bad = []
    for (path, gr), (_, r), (_, s) in zip(flatten(grads), flatten(red), flatten(resid)):
        e = gr.float()
        local = decompress_int8(*compress_int8(e))
        if not (torch.equal(r, local.to(gr.dtype)) and torch.equal(s, e - local)):
            bad.append(path)
    n = sum(t.numel() for t in leaves(grads))
    print(f"13c error_feedback_allreduce on NCCL over a gemma3-1b gradient ({n / 1e9:.3f} B "
          f"values, {len(leaves(grads))} leaves): reduced and residuals bitwise the plain "
          f"round trip: {not bad}; {ef_s:.3f} s; wire bytes int8 + f32 scales "
          f"{(n + 4 * n / 256) / 1e9:.3f} GB against f32 {4 * n / 1e9:.3f} GB", flush=True)
    if bad:
        raise AssertionError(f"13c compression differs at {bad[:5]}")
    del grads, red, resid, full
    free()
    return {"dist_pipeline": pipe_launches}


def dist_serve(sharder) -> dict[str, dict[str, int]]:
    """13d: phi3-medium-14b at full width cut to DIST_SERVE_LAYERS layers,
    the legacy engine (cached_jit: one captured graph) and the paged engine
    (a captured tick per bucket) with `sharder=` against the NULL engines:
    the same tokens, the same B4 / B8 / B2 launches."""
    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=DIST_SERVE_LAYERS)
    params = get_model(cfg).init(seed=0, device="cuda")
    prompts = {rid: p[:LEGACY_PROMPT] for rid, p in
               list(serve_prompts(cfg.vocab).items())[:LEGACY_CONFIG["batch"]]}
    runs, out = {}, {}
    for engine in ("legacy", "paged"):
        for form, kw in (("null", {}), ("sharded", {"sharder": sharder})):
            if engine == "legacy":
                eng = ServingEngine(cfg, params, ServeConfig(**LEGACY_CONFIG), eos_id=-1, **kw)
                for rid, p in prompts.items():
                    eng.submit(rid, p)
            else:
                eng = PagedServingEngine(cfg, params, ServeConfig(
                    max_len=LEGACY_CONFIG["max_len"], batch=LEGACY_CONFIG["batch"],
                    num_blocks=LEGACY_CONFIG["batch"] * LEGACY_CONFIG["max_len"] // 8 + 8,
                    max_new_tokens=32), eos_id=-1, **kw)
                for rid, p in prompts.items():
                    eng.submit(p, rid=rid)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            out[engine, form] = eng.run_until_done()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.launch_counts()
            g = eng.graph_stats()
            print(f"13d {engine} {form}: {len(out[engine, form])} requests, "
                  f"{sum(len(v) for v in out[engine, form].values())} tokens in {wall:.2f} s; "
                  f"graphs {g['graphs']}, replays {g['replays']}; launches "
                  f"{ {k: n for k, n in launches.items() if n} }", flush=True)
            runs[f"dist_serve_{engine}_{form}"] = launches
            del eng
            free()
        a, b = runs[f"dist_serve_{engine}_null"], runs[f"dist_serve_{engine}_sharded"]
        keys = ("flash_decode", "paged_flash_decode", "fused_mlp_swiglu")
        if out[engine, "null"] != out[engine, "sharded"] or any(a[k] != b[k] for k in keys) \
                or not (a["flash_decode"] or a["paged_flash_decode"]):
            raise AssertionError(f"13d {engine}: tokens equal "
                                 f"{out[engine, 'null'] == out[engine, 'sharded']}, launches "
                                 f"NULL {a}, sharded {b}")
        print(f"13d {engine}: sharded tokens == NULL tokens, launches equal", flush=True)
    return runs


def phase_distributed() -> dict[str, dict[str, int]]:
    """13: a world-size-1 NCCL group on the card and a (1, 1) ("data",
    "model") DeviceMesh; 13a the sharded gemma3-1b train step, 13b the
    elastic restore, 13c the pipeline and the compressed all-reduce, 13d
    the sharded engines.  The group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    store = Path(tempfile.mkdtemp(prefix="dist_store_", dir=ROOT / "build"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        sharder = Sharder(make_mesh((1, 1), ("data", "model"), "cuda"))
        print(f"13: NCCL group (world size 1) and mesh {sharder.mesh} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        runs, params = dist_train(sharder)
        dist_restore(sharder, sharded_params := params["params"])
        runs.update(dist_pipeline_and_compression(sharded_params))
        del params, sharded_params
        free()
        runs.update(dist_serve(sharder))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"phase 13 wall time {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} libraries", flush=True)
    for name, info in built.items():
        print(f"  {name}: nvcc {info['seconds']:.1f} s", flush=True)
        for entry in ptxas_entries(info["log"]):
            print(f"    {entry}", flush=True)

    rows = phase_kernels()

    K.reset_launch_counts()
    samples = []
    phase_llama(samples)
    phase_apps(samples)
    phase_split_reduction()
    compiler_path = K.launch_counts()
    missing = [k for k in ("fused_mlp", "fused_mlp_swiglu", "flash_attention",
                           "queue_reduce") if compiler_path[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the compiler's main path: {missing}")
    print(f"launches on the compiler's main path (phases 4-6): {compiler_path}", flush=True)
    fit = calibrate(H100, samples)
    print(f"calibrate(H100) on phases 4-5's bsp replays {[tuple(f'{x:.4g}' for x in t) for t in samples]} "
          f"(flops, bytes, programs, s): eff {fit.eff:.4g}, launch_s {fit.launch_s:.4g} "
          f"({fit.name})", flush=True)
    torch.cuda.empty_cache()

    paths = {"compiler": compiler_path, **phase_serving()}
    torch.cuda.empty_cache()
    train_paths, rows_by_path = phase_training()
    paths.update(train_paths)
    paths.update(phase_families())
    paths.update(phase_traced())
    t0 = time.perf_counter()
    paths.update(phase_legacy_tick())
    print(f"phase 11 wall time {time.perf_counter() - t0:.1f} s", flush=True)
    paths.update(phase_auto())
    free()
    paths.update(phase_distributed())
    for path, counts in paths.items():
        print(f"launches, {path} run: { {k: n for k, n in counts.items() if n} }", flush=True)

    def launches(path, kern, n_rows=None):
        return paths[path][kern] if n_rows is None else rows_by_path[path][kern].get(n_rows, 0)

    # phase 3 leaves a case out where its shape does not occur (no decode
    # fold when the small-M form writes y itself)
    cases = {case: spec for case, spec in SUMMARY.items() if case in rows}
    missing = [case for case, (kern, path, _, *n_rows) in cases.items()
               if launches(path, kern, *n_rows) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")

    summary = []
    for case, (kern, path, shape, *n_rows) in cases.items():
        row = rows[case]
        source, replaces = SOURCES[kern]
        summary.append({"name": case, "kernel": kern, "route": "cuda", "source": source,
                        "replaces": replaces, "path": path, "shape": row.get("shape", shape),
                        "launches": launches(path, kern, *n_rows),
                        "launches_by_run": {p: c[kern] for p, c in paths.items()
                                            if c.get(kern)},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        **{k: row[k] for k in ("dx_ms", "dw_ms", "partial_bytes", "library")
                           if k in row}})
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
