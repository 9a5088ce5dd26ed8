"""Position-frequency LRU diagnostic (cc/mcts/position_cache.h:11-58).

Counts how often board positions recur across a run — num_queries /
num_hits / approximate unique-position count over a bounded LRU. The
reference keeps a mutex-guarded per-process cache; nothing in its tree
search consumes it (diagnostics only), and the same is true here.

Array adaptation: positions arrive as BATCHES of zobrist hash lanes
(uint32[..., 2], the additive 128->64-bit lanes of game/board.py) pulled
to host at harvest points, so insertion is batch-first; order within a
batch follows array order like the reference's sequential Insert calls.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np


class PositionCache:
    """Bounded LRU mapping position hash -> occurrence count."""

    def __init__(self, max_size: int = 1 << 16):
        self.max_size = max_size
        self._cache: "OrderedDict[int, int]" = OrderedDict()
        self.num_queries = 0
        self.num_hits = 0
        self.num_unique_positions_approx = 0

    def insert(self, board_hash: int) -> int:
        """Insert or bump one position; returns its current count
        (Insert, position_cache.h:36-51)."""
        self.num_queries += 1
        count = self._cache.pop(board_hash, None)
        if count is None:
            self.num_unique_positions_approx += 1
            self._cache[board_hash] = 1
            if len(self._cache) > self.max_size:
                self._cache.popitem(last=False)
            return 1
        self.num_hits += 1
        self._cache[board_hash] = count + 1
        return count + 1

    def insert_batch(self, hashes: np.ndarray) -> np.ndarray:
        """Insert a [..., 2] uint32 hash-lane array (or [...] precombined
        uint64); returns the per-position counts with the input's leading
        shape."""
        h = np.asarray(hashes)
        if h.ndim >= 1 and h.shape[-1] == 2 and h.dtype == np.uint32:
            h = (h[..., 0].astype(np.uint64) << np.uint64(32)) \
                | h[..., 1].astype(np.uint64)
        flat = h.reshape(-1)
        out = np.empty(flat.shape, np.int64)
        for i, v in enumerate(flat.tolist()):
            out[i] = self.insert(int(v))
        return out.reshape(h.shape)

    @property
    def hit_rate(self) -> float:
        return self.num_hits / self.num_queries if self.num_queries else 0.0
