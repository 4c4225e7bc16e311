"""Vectorized count-min frequency sketch for cache admission.

TinyLFU-style admission: the sketch counts *misses* per key, and a fill
is admitted only once the key's estimated frequency reaches the
configured threshold.  One-touch scan traffic therefore never displaces
resident blocks, while anything in the zipf/hotspot working set clears
the bar on its second access.

Everything is batched numpy: hashing is multiply-shift over uint64
(wrapping multiply, xor-shift mix), updates are one ``np.add.at`` per
hash row, and estimates are a row-wise ``np.minimum`` reduction.  The
sketch ages by halving every counter after a fixed number of updates,
so stale popularity decays instead of pinning the admission gate open.
"""
from __future__ import annotations

import numpy as np


class FrequencySketch:
    """Count-min sketch over int64 cache keys, width must be a power of two."""

    def __init__(
        self,
        width: int = 1024,
        n_hashes: int = 4,
        decay_every: int | None = None,
        seed: int = 0xCAFE,
    ) -> None:
        if width <= 0 or width & (width - 1):
            raise ValueError("sketch width must be a power of two")
        self.width = width
        self._mask = np.uint64(width - 1)
        self.table = np.zeros((n_hashes, width), dtype=np.uint32)
        rng = np.random.default_rng(seed)
        # Odd multipliers so the multiply-shift hash is a bijection on u64.
        self.salts = rng.integers(1, 1 << 62, size=n_hashes, dtype=np.uint64)
        self.salts = (self.salts << np.uint64(1)) | np.uint64(1)
        self.decay_every = int(decay_every) if decay_every else width * 8
        self._updates = 0

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        k = keys.astype(np.uint64, copy=False)
        h = k[None, :] * self.salts[:, None]  # wraps mod 2^64
        h ^= h >> np.uint64(33)
        return (h & self._mask).astype(np.int64)

    def add(self, keys: np.ndarray) -> None:
        """Count one access for each key (duplicates count individually)."""
        keys = np.asarray(keys)
        if keys.size == 0:
            return
        rows = self._rows(keys)
        for r in range(self.table.shape[0]):
            np.add.at(self.table[r], rows[r], 1)
        self._updates += int(keys.size)
        if self._updates >= self.decay_every:
            self.table >>= 1
            self._updates = 0

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        """Estimated access count per key (count-min upper bound)."""
        keys = np.asarray(keys)
        if keys.size == 0:
            return np.zeros(0, dtype=np.uint32)
        rows = self._rows(keys)
        est = self.table[0][rows[0]]
        for r in range(1, self.table.shape[0]):
            est = np.minimum(est, self.table[r][rows[r]])
        return est

    def clear(self) -> None:
        self.table[:] = 0
        self._updates = 0
