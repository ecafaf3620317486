"""Host-side paged-KV block allocator + prefix cache.

A copy of ray_tpu/serve/paged_kv.py (pure Python, copied rather than
imported, since this package imports nothing of ray_tpu). It manages the
device pool made by models.llama.init_kv_pool: the device side only sees
block tables; allocation, refcounts, prefix hashing and LRU eviction of
reusable blocks live here.

Prefix caching: FULL prompt blocks are content-addressed by a rolling hash of
the token chain (hash(prev_chain, block_tokens)); a new request reuses the
longest cached block-aligned prefix (refcount++) and only prefills its suffix.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional


class NoFreeBlocks(RuntimeError):
    """Pool exhausted (after evicting all reusable cached blocks)."""


class BlockPool:
    def __init__(self, num_blocks: int, block_size: int):
        # block 0 is reserved as the garbage target for unallocated table
        # entries (reads of it are masked in attention)
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}
        # chain_hash -> block id, LRU-ordered for eviction; blocks here may
        # have refcount 0 (reusable) but stay allocated until evicted
        self._prefix: "OrderedDict[int, int]" = OrderedDict()
        self._block_chain: dict[int, int] = {}  # block id -> its chain hash
        self._lock = threading.Lock()
        self.prefix_hits = 0
        self.prefix_queries = 0

    # ------------------------------------------------------------ allocation
    def alloc(self, n: int = 1) -> list[int]:
        with self._lock:
            out: list[int] = []
            for _ in range(n):
                bid = self._take_one()
                if bid is None:
                    for b in out:  # roll back a partial grab
                        self._release_one(b)
                    raise NoFreeBlocks(f"no free KV blocks (need {n})")
                out.append(bid)
            return out

    def _take_one(self) -> Optional[int]:
        if self._free:
            bid = self._free.pop()
        else:
            bid = self._evict_one()
            if bid is None:
                return None
        self._ref[bid] = 1
        return bid

    def _evict_one(self) -> Optional[int]:
        """Reclaim the least-recently-used ZERO-REF cached prefix block."""
        for chain, bid in self._prefix.items():
            if self._ref.get(bid, 0) == 0:
                del self._prefix[chain]
                self._block_chain.pop(bid, None)
                self._ref.pop(bid, None)
                return bid
        return None

    def free(self, block_ids: list[int]) -> None:
        with self._lock:
            for bid in block_ids:
                self._release_one(bid)

    def _release_one(self, bid: int) -> None:
        n = self._ref.get(bid, 0) - 1
        if n > 0:
            self._ref[bid] = n
            return
        if bid in self._block_chain:
            # cached prefix block: keep it allocated at refcount 0 (reusable);
            # eviction reclaims it under pressure
            self._ref[bid] = 0
        else:
            self._ref.pop(bid, None)
            self._free.append(bid)

    # ------------------------------------------------------------ prefix cache
    @staticmethod
    def _chain(prev: int, tokens: tuple) -> int:
        return hash((prev, tokens))

    def lookup_prefix(self, prompt: list[int]) -> tuple[list[int], int]:
        """Longest cached block-aligned prefix: returns (block ids with one
        ref taken each, cached token count)."""
        with self._lock:
            self.prefix_queries += 1
            bs = self.block_size
            chain = 0
            hit_ids: list[int] = []
            for start in range(0, len(prompt) - bs + 1, bs):
                chain = self._chain(chain, tuple(prompt[start:start + bs]))
                bid = self._prefix.get(chain)
                if bid is None:
                    break
                hit_ids.append(bid)
                self._prefix.move_to_end(chain)  # LRU touch
            for bid in hit_ids:
                self._ref[bid] = self._ref.get(bid, 0) + 1
            if hit_ids:
                self.prefix_hits += 1
            return hit_ids, len(hit_ids) * bs

    def register_prefix(self, prompt: list[int], block_ids: list[int],
                        skip_blocks: int = 0) -> None:
        """Content-address the FULL blocks of a prompt for reuse (partial last
        blocks stay private — they are still written to)."""
        with self._lock:
            bs = self.block_size
            chain = 0
            n_full = len(prompt) // bs
            for j in range(n_full):
                chain = self._chain(chain, tuple(prompt[j * bs:(j + 1) * bs]))
                if j < skip_blocks or j >= len(block_ids):
                    continue  # already-cached prefix keeps its existing entry
                bid = block_ids[j]
                if chain not in self._prefix and bid not in self._block_chain:
                    self._prefix[chain] = bid
                    self._block_chain[bid] = chain

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            cached_free = sum(1 for b in self._block_chain if self._ref.get(b, 0) == 0)
            return {
                "num_blocks": self.num_blocks,
                "free_blocks": len(self._free) + cached_free,
                "allocated_blocks": self.num_blocks - 1 - len(self._free) - cached_free,
                "cached_blocks": len(self._prefix),
                "prefix_hits": self.prefix_hits,
                "prefix_queries": self.prefix_queries,
            }
