"""Paged KV block pool: the allocator behind the paged serving engine.

The KV cache is a flat array of fixed-size PAGES instead of one contiguous
(B, max_len) region per slot: each page holds `block_size` token positions of
one sequence (all layers' K or V at once), and a per-slot BLOCK TABLE maps
logical block index -> physical page id.  Admission then reasons in blocks
("can the pool cover this prompt?") instead of whole max_len slots, which is
what lets the engine hold more concurrent sequences than contiguous slots
would fit in the same memory.

Physical page 0 is the reserved NULL page: it is never allocated, block
tables of idle slots / beyond-valid view blocks point at it, and the tick
program redirects all masked-out scatter writes there.  Garbage in page 0 is
harmless by construction -- every gather from it lands at attention positions
>= the slot's valid length, which the per-slot mask sends to exp(-1e30) == 0.

Blocks are refcounted so the prefix cache can share one physical page across
requests.  A block whose refcount drops to zero while it carries a cache tag
parks on an EVICTABLE LRU instead of the free list; `alloc()` reclaims from
it (oldest first, notifying the tag owner) only after the free list runs dry.

Invariant (asserted by `check()`):
    free + evictable + active == num_blocks        (page 0 excluded)
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Hashable

NULL_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The pool has no free and no evictable block left."""


class BlockPool:
    """Refcounted fixed-size page allocator with an evictable LRU tier.

    `num_blocks` counts USABLE blocks; physical ids run 1..num_blocks
    (id 0 is the reserved null page and is never handed out).
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 on_evict: Callable[[Hashable, int], None] | None = None,
                 fault=None):
        if num_blocks < 1:
            raise ValueError(f"need at least one usable block, got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._on_evict = on_evict
        # optional serve.faults.FaultInjector: the "pool.alloc" site lets
        # tests/chaos benches script exhaustion without filling the pool
        self.fault = fault
        self._free: deque[int] = deque(range(1, num_blocks + 1))
        self._ref: dict[int, int] = {}            # bid -> refcount (active only)
        self._evictable: OrderedDict[int, None] = OrderedDict()  # LRU order
        self._tag: dict[int, Hashable] = {}       # bid -> prefix-cache key
        self.allocs = 0
        self.evictions = 0

    # -- capacity views ----------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def evictable_count(self) -> int:
        return len(self._evictable)

    @property
    def active_count(self) -> int:
        return len(self._ref)

    @property
    def available(self) -> int:
        """Blocks an allocation burst could obtain right now."""
        return len(self._free) + len(self._evictable)

    # -- allocation --------------------------------------------------------
    def alloc(self) -> int:
        """Return a fresh block (ref=1), evicting a cached block if needed."""
        if self.fault is not None and self.fault.check("pool.alloc"):
            raise OutOfBlocks("injected fault at pool.alloc")
        if self._free:
            bid = self._free.popleft()
        elif self._evictable:
            bid, _ = self._evictable.popitem(last=False)   # oldest first
            tag = self._tag.pop(bid)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(tag, bid)
        else:
            raise OutOfBlocks(
                f"pool exhausted: {self.num_blocks} blocks all active")
        self._ref[bid] = 1
        self.allocs += 1
        return bid

    def incref(self, bid: int) -> None:
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        """Drop one reference; at zero the block parks (tagged) or frees."""
        n = self._ref[bid] - 1
        if n > 0:
            self._ref[bid] = n
            return
        del self._ref[bid]
        if bid in self._tag:
            self._evictable[bid] = None            # newest at the MRU end
        else:
            self._free.append(bid)

    def reuse(self, bid: int) -> None:
        """Take a reference on a cached block (possibly parked evictable)."""
        if bid in self._ref:
            self._ref[bid] += 1
        else:
            del self._evictable[bid]
            self._ref[bid] = 1

    # -- prefix-cache tagging ----------------------------------------------
    def tag(self, bid: int, key: Hashable) -> None:
        """Mark an ACTIVE block as holding the prefix identified by `key`."""
        assert bid in self._ref, f"tagging non-active block {bid}"
        self._tag[bid] = key

    def tag_of(self, bid: int) -> Hashable | None:
        return self._tag.get(bid)

    def is_alive(self, bid: int) -> bool:
        """Cached block still holding its data (active or parked)?"""
        return bid in self._ref or bid in self._evictable

    # -- accounting --------------------------------------------------------
    def check(self) -> dict:
        """Assert the conservation invariant and return a stats snapshot."""
        stats = self.stats()
        total = stats["free"] + stats["evictable"] + stats["active"]
        assert total == self.num_blocks, (
            f"block leak: free={stats['free']} evictable={stats['evictable']} "
            f"active={stats['active']} != {self.num_blocks}")
        assert NULL_BLOCK not in self._ref and NULL_BLOCK not in self._free, \
            "null page escaped into circulation"
        return stats

    def stats(self) -> dict:
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free": len(self._free),
                "evictable": len(self._evictable),
                "active": len(self._ref),
                "allocs": self.allocs,
                "evictions": self.evictions}

    def __repr__(self) -> str:
        return (f"BlockPool({self.num_blocks}x{self.block_size}, "
                f"free={self.free_count}, evictable={self.evictable_count}, "
                f"active={self.active_count})")
