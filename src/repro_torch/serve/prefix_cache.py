"""Prefix caching over the block pool: share KV pages across requests whose
prompts start identically.

Keys are CHAINED block hashes, exactly like the executable cache keys its
compiled artifacts: block i's key covers the whole prefix [0, (i+1)*bs), so a
lookup walks the chain and stops at the first miss -- a match is always a
prefix match, never an interior one.  Hits take a refcount on the physical
block via `BlockPool.reuse` (resurrecting it from the evictable LRU if it was
parked); the pool reports evictions back through `on_evict` so the map never
points at a recycled page.

Reuse is capped at len(prompt)-1 tokens: the logits that produce the first
generated token come from re-processing the LAST prompt token, so at least
one token must always run through the model (same rule as vLLM).

Insertion happens at request COMPLETION: by then every prompt position has
been written, so all full prompt blocks are safe to publish.  A key that is
already present keeps its existing block (first writer wins); the duplicate
page simply returns to the free list when its request releases it.
"""
from __future__ import annotations

from typing import Hashable, Sequence

from .block_pool import BlockPool


def block_key(prev: Hashable | None, tokens: Sequence[int]) -> Hashable:
    """Chained key for one full block given the previous block's key."""
    return ("pfx", prev, tuple(int(t) for t in tokens))


class PrefixCache:
    """Chained-hash map from prompt-prefix blocks to live pool pages."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.bs = pool.block_size
        self._map: dict[Hashable, int] = {}
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserts = 0
        self.evictions = 0

    # BlockPool.on_evict: a tagged page got recycled for a new allocation.
    def on_evict(self, key: Hashable, bid: int) -> None:
        if self._map.get(key) == bid:
            del self._map[key]
            self.evictions += 1

    def match(self, prompt: Sequence[int]) -> tuple[list[int], int]:
        """Longest cached prefix of `prompt` in whole blocks.

        Returns (block_ids, n_tokens_reused); each returned block already
        carries a reference for the caller (release with pool.decref).
        """
        self.lookup_tokens += len(prompt)
        max_blocks = max(0, (len(prompt) - 1) // self.bs)
        bids: list[int] = []
        key: Hashable | None = None
        for i in range(max_blocks):
            key = block_key(key, prompt[i * self.bs:(i + 1) * self.bs])
            bid = self._map.get(key)
            if bid is None or not self.pool.is_alive(bid):
                self.misses += 1
                break
            self.pool.reuse(bid)
            bids.append(bid)
            self.hits += 1
        self.hit_tokens += len(bids) * self.bs
        return bids, len(bids) * self.bs

    def insert(self, prompt: Sequence[int], bids: Sequence[int]) -> int:
        """Publish the full prompt blocks of a finished request.

        `bids` is the request's block-table prefix (one physical id per
        logical block actually allocated).  Returns #blocks newly published.
        """
        n_full = min(len(prompt) // self.bs, len(bids))
        key: Hashable | None = None
        new = 0
        for i in range(n_full):
            key = block_key(key, prompt[i * self.bs:(i + 1) * self.bs])
            cur = self._map.get(key)
            if cur is not None and self.pool.is_alive(cur):
                continue                      # first writer wins
            self._map[key] = int(bids[i])
            self.pool.tag(int(bids[i]), key)
            self.inserts += 1
            new += 1
        return new

    def stats(self) -> dict:
        """`entries`: cached blocks; `hits`: blocks `match` served; `misses`:
        lookups that stopped before their last whole block; `hit_tokens`:
        prompt tokens `match` served (hits x block size); `lookup_tokens`:
        prompt tokens `match` was asked about; `inserts` and `evictions`:
        blocks published and recycled."""
        return {"entries": len(self._map), "hits": self.hits,
                "misses": self.misses, "hit_tokens": self.hit_tokens,
                "lookup_tokens": self.lookup_tokens, "inserts": self.inserts,
                "evictions": self.evictions}
