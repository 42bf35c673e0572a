"""Deterministic synthetic data pipeline: host-shardable, double-buffered.
The counterpart of `repro/data/pipeline.py`, in numpy: the same token
stream, bit for bit, from the same (seed, step, shard).

Production posture: each host generates only its shard of the global batch
(keyed by (step, shard)), so ingestion scales with host count and restart at
step N reproduces the exact stream (checkpoint/restart invariant tested in
test_substrates.py).  Prefetch keeps `depth` batches in flight -- the input
side of compute/comm overlap, and the lever the straggler monitor pulls
(runtime/straggler.py).
"""
from __future__ import annotations

import collections
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard: int = 0
    seed: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


class SyntheticLM:
    """Markov-ish synthetic token stream: learnable structure (so loss
    actually falls during the example training runs) yet fully deterministic
    from (seed, step, shard)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed random bigram transition "table" via hashing -- no memory
        self._mix = np.uint64(0x9E3779B97F4A7C15)

    def _tokens(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * cfg.n_shards + cfg.shard)
        b, s, v = cfg.local_batch, cfg.seq_len, cfg.vocab
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, s)) < 0.15
        rand = rng.integers(0, v, (b, s))
        mul = np.uint64(6364136223846793005)
        add = np.uint64(1442695040888963407)
        for t in range(1, s):
            prev = toks[:, t - 1].astype(np.uint64)
            nxt = ((prev * mul + add) % np.uint64(v)).astype(np.int32)
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def batch(self, step: int) -> dict[str, np.ndarray]:
        toks = self._tokens(step)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batches(cfg: DataConfig, start_step: int = 0, prefetch: int = 2):
    """Prefetching iterator (background thread fills a bounded queue)."""
    src = SyntheticLM(cfg)
    q: collections.deque = collections.deque()
    lock = threading.Condition()
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            batch = src.batch(step)
            with lock:
                while len(q) >= prefetch and not stop.is_set():
                    lock.wait(0.05)
                q.append((step, batch))
                lock.notify_all()
            step += 1

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    def gen():
        try:
            while True:
                with lock:
                    while not q:
                        lock.wait(0.05)
                    item = q.popleft()
                    lock.notify_all()
                yield item
        finally:
            stop.set()
            with lock:
                lock.notify_all()

    return gen()
