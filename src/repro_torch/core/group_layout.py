"""Group-based data layout: the compact stripe table (CST) (paper §3.2).

For every Zone-Append segment the CST stores a (k+m, S) matrix of stripe IDs
-- the sequence number of the stripe *within its stripe group* that each
chunk slot holds.  Stripe IDs take ceil(log2 G) bits, rounded up to whole
bytes exactly as the paper's prototype does (uint8 for G <= 256, uint16 for
G <= 65536).

Degraded reads resolve a lost chunk by searching the G slots of its group on
each surviving drive for the matching stripe ID -- a k*G bounded scan.  The
table exposes access counters so benchmarks can report query overhead.
"""
from __future__ import annotations

import math

import numpy as np

NO_STRIPE = None  # sentinel filled value is the dtype max


def stripe_id_dtype(group_size: int) -> np.dtype:
    bits = max(1, math.ceil(math.log2(max(group_size, 2))))
    nbytes = -(-bits // 8)
    return {1: np.dtype(np.uint8), 2: np.dtype(np.uint16)}.get(
        nbytes, np.dtype(np.uint32)
    )


class CompactStripeTable:
    """Per-segment stripe-ID matrix with byte-rounded entries."""

    def __init__(self, n_drives: int, n_stripes: int, group_size: int):
        self.group_size = group_size
        self.dtype = stripe_id_dtype(group_size)
        self.fill = np.iinfo(self.dtype).max
        self.table = np.full((n_drives, n_stripes), self.fill, dtype=self.dtype)
        self.entries_accessed = 0  # degraded-read query counter

    def memory_bytes(self) -> int:
        return self.table.nbytes

    def record(self, drive: int, chunk_idx: int, stripe_id_in_group: int) -> None:
        assert stripe_id_in_group < max(self.group_size, 2)
        self.table[drive, chunk_idx] = stripe_id_in_group

    def record_many(
        self, drive: int, chunk_idxs: np.ndarray, stripe_ids: np.ndarray
    ) -> None:
        """Vectorized :meth:`record` for one drive (bulk group commit)."""
        assert stripe_ids.size == 0 or int(stripe_ids.max()) < max(self.group_size, 2)
        self.table[drive, np.asarray(chunk_idxs, np.int64)] = stripe_ids

    def stripe_id_at(self, drive: int, chunk_idx: int) -> int:
        self.entries_accessed += 1
        return int(self.table[drive, chunk_idx])

    def find_in_group(self, drive: int, group_idx: int, stripe_id: int) -> int | None:
        """Chunk index on ``drive`` holding ``stripe_id`` within group; None if absent."""
        g0 = group_idx * self.group_size
        window = self.table[drive, g0 : g0 + self.group_size]
        self.entries_accessed += window.shape[0]
        hits = np.nonzero(window == stripe_id)[0]
        if hits.size == 0:
            return None
        return int(g0 + hits[0])

    def group_members(self, group_idx: int, stripe_id: int) -> dict[int, int]:
        """drive -> chunk_idx for every drive holding ``stripe_id`` in the group."""
        out = {}
        for d in range(self.table.shape[0]):
            hit = self.find_in_group(d, group_idx, stripe_id)
            if hit is not None:
                out[d] = hit
        return out
