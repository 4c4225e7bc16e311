"""Logical-to-physical (L2P) table with CLOCK-based offloading (paper §3.1).

The L2P maps each logical block address to a packed PBA
``(segment id, drive id, zone offset)``.  Two modes:

* fully resident -- one flat int64 array (the paper's default);
* memory-capped -- entries are grouped into 1024-entry *entry groups*; a
  CLOCK (second-chance) policy evicts non-recently-used groups into 4 KiB
  *mapping blocks* written through the normal write path (LSB-tagged LBA
  field so recovery can tell them from user blocks), with a small in-memory
  mapping table gid -> PBA.

The table is deliberately storage-backend-agnostic: eviction/refill go
through two callbacks supplied by the owning array.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

DEFAULT_ENTRIES_PER_GROUP = 1024  # 4-byte entries -> one 4 KiB mapping block
ENTRIES_PER_GROUP = DEFAULT_ENTRIES_PER_GROUP  # back-compat alias
NO_PBA = np.int64(-1)

# PBA packing: seg_id << 40 | drive << 32 | offset
_SEG_SHIFT = 40
_DRIVE_SHIFT = 32
_OFF_MASK = (1 << 32) - 1
_DRIVE_MASK = (1 << 8) - 1


def pack_pba(seg_id: int, drive: int, offset: int) -> int:
    assert 0 <= offset <= _OFF_MASK and 0 <= drive <= _DRIVE_MASK
    return (seg_id << _SEG_SHIFT) | (drive << _DRIVE_SHIFT) | offset


def unpack_pba(pba: int) -> tuple[int, int, int]:
    pba = int(pba)
    return pba >> _SEG_SHIFT, (pba >> _DRIVE_SHIFT) & _DRIVE_MASK, pba & _OFF_MASK


def unpack_pba_many(pbas: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ``unpack_pba``: int64 array -> (seg, drive, off) arrays."""
    pbas = np.asarray(pbas, dtype=np.int64)
    return (
        pbas >> _SEG_SHIFT,
        (pbas >> _DRIVE_SHIFT) & _DRIVE_MASK,
        pbas & _OFF_MASK,
    )


def pack_pba_many(
    seg_id: int, drives: np.ndarray, offsets: np.ndarray
) -> np.ndarray:
    """Vectorized ``pack_pba`` for one segment (group-commit bookkeeping)."""
    return (
        (np.int64(seg_id) << _SEG_SHIFT)
        | (np.asarray(drives, np.int64) << _DRIVE_SHIFT)
        | np.asarray(offsets, np.int64)
    )


class L2PTable:
    def __init__(
        self,
        n_blocks: int,
        *,
        memory_limit_entries: Optional[int] = None,
        write_mapping_block: Optional[Callable[[int, np.ndarray], None]] = None,
        read_mapping_block: Optional[Callable[[int], Optional[np.ndarray]]] = None,
        entries_per_group: int = DEFAULT_ENTRIES_PER_GROUP,
    ):
        self.n_blocks = n_blocks
        self.epg = entries_per_group
        self.n_groups = -(-n_blocks // entries_per_group)
        self.offload = memory_limit_entries is not None
        self.limit_groups = (
            max(1, memory_limit_entries // entries_per_group) if self.offload else None
        )
        self._write_cb = write_mapping_block
        self._read_cb = read_mapping_block
        # Fires on every CLOCK eviction (clean or dirty) with the evicted
        # group image -- the array's cache tier uses it to keep offloaded
        # mapping blocks warm beyond the resident budget.
        self.evict_listener: Optional[Callable[[int, np.ndarray], None]] = None
        if not self.offload:
            self.flat = np.full(n_blocks, NO_PBA, dtype=np.int64)
        else:
            self.resident: dict[int, np.ndarray] = {}
            self.dirty: set[int] = set()
            self.refbit = np.zeros(self.n_groups, dtype=np.uint8)
            # resident-group bitmap mirroring ``resident.keys()``: the CLOCK
            # sweep reads candidates from one ``flatnonzero`` instead of
            # rebuilding a sorted Python list per eviction
            self.resident_mask = np.zeros(self.n_groups, dtype=bool)
            self.hand = 0
        # stats
        self.misses = 0
        self.evictions = 0
        self.lookups = 0

    # -- helpers ------------------------------------------------------------

    def _group_of(self, lba: int) -> tuple[int, int]:
        return lba // self.epg, lba % self.epg

    def _fault_in(self, gid: int) -> np.ndarray:
        if gid in self.resident:
            self.refbit[gid] = 1
            return self.resident[gid]
        self.misses += 1
        entries = self._read_cb(gid) if self._read_cb else None
        if entries is None:
            entries = np.full(self.epg, NO_PBA, dtype=np.int64)
        self.resident[gid] = entries
        self.resident_mask[gid] = True
        self.refbit[gid] = 1
        # The faulting group is pinned: the caller is about to read or mutate
        # the returned array, so evicting it here would orphan that update
        # (a clean eviction writes nothing back and the store is lost).
        self._maybe_evict(pinned=gid)
        return entries

    def _maybe_evict(self, pinned: Optional[int] = None) -> None:
        while len(self.resident) > self.limit_groups:
            # CLOCK sweep over resident groups in gid order from the hand:
            # one bitmap scan yields the (already sorted) candidates.
            gids = np.flatnonzero(self.resident_mask)
            n = int(gids.size)
            start = int(np.searchsorted(gids, self.hand))
            if start == n:
                start = 0
            for step in range(2 * n + 1):
                g = int(gids[(start + step) % n])
                if g == pinned:
                    continue
                if self.refbit[g]:
                    self.refbit[g] = 0
                    continue
                self._evict(g)
                self.hand = int(gids[(start + step + 1) % n])
                break
            else:  # all referenced twice around: evict the hand's group
                g = int(gids[start])
                if g == pinned:
                    g = int(gids[(start + 1) % n])
                self._evict(g)

    def _evict(self, gid: int) -> None:
        entries = self.resident.pop(gid)
        self.resident_mask[gid] = False
        self.evictions += 1
        if self.evict_listener is not None:
            self.evict_listener(gid, entries)
        if gid in self.dirty:
            self.dirty.discard(gid)
            if self._write_cb is not None:
                self._write_cb(gid, entries)

    # -- public API ---------------------------------------------------------

    def get(self, lba: int) -> int:
        self.lookups += 1
        if not self.offload:
            return int(self.flat[lba])
        gid, idx = self._group_of(lba)
        return int(self._fault_in(gid)[idx])

    def set(self, lba: int, pba: int) -> None:
        if not self.offload:
            self.flat[lba] = pba
            return
        gid, idx = self._group_of(lba)
        self._fault_in(gid)[idx] = pba
        self.dirty.add(gid)

    def _group_runs(self, lbas: np.ndarray):
        """Yield ``(gid, positions)`` per distinct entry group, ascending gid.

        One stable argsort replaces the per-group boolean masks (O(n log n)
        instead of O(groups * n) -- the difference between a noticeable stall
        and a non-event for recovery-scale bulk installs).  Positions keep
        their original relative order within each group."""
        if lbas.size == 0:
            return
        gids = lbas // self.epg
        order = np.argsort(gids, kind="stable")
        sg = gids[order]
        starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
        ends = np.r_[starts[1:], sg.size]
        for s, e in zip(starts, ends):
            yield int(sg[s]), order[s:e]

    def get_many(self, lbas: np.ndarray) -> np.ndarray:
        """Vectorized lookup: int array of LBAs -> int64 array of PBAs.

        Flat mode is a single numpy gather; offload mode faults in each
        distinct entry group once and gathers within it, so a sequential
        multi-block read costs O(groups) faults instead of O(blocks)."""
        lbas = np.asarray(lbas, dtype=np.int64)
        self.lookups += int(lbas.size)
        if not self.offload:
            return self.flat[lbas].copy()
        out = np.empty(lbas.shape, dtype=np.int64)
        for g, pos in self._group_runs(lbas):
            entries = self.resident.get(g)  # one dict probe per *group*
            if entries is None:
                entries = self._fault_in(g)
            else:
                self.refbit[g] = 1
            out[pos] = entries[lbas[pos] % self.epg]
        return out

    def set_many(self, lbas: np.ndarray, pbas: np.ndarray) -> None:
        """Vectorized update; later entries win on duplicate LBAs (numpy
        fancy-assignment order), matching a sequential ``set`` loop."""
        lbas = np.asarray(lbas, dtype=np.int64)
        pbas = np.asarray(pbas, dtype=np.int64)
        if not self.offload:
            self.flat[lbas] = pbas
            return
        for g, pos in self._group_runs(lbas):
            entries = self.resident.get(g)  # one dict probe per *group*
            if entries is None:
                entries = self._fault_in(g)
            else:
                self.refbit[g] = 1
            entries[lbas[pos] % self.epg] = pbas[pos]
            self.dirty.add(g)

    def compare_and_clear(self, lba: int, pba: int) -> None:
        """Invalidate the mapping only if it still points at ``pba`` (GC races)."""
        if self.get(lba) == pba:
            self.set(lba, int(NO_PBA))

    def flush(self) -> None:
        """Write back every dirty resident group (used before clean shutdown)."""
        if not self.offload:
            return
        for gid in sorted(self.dirty):
            if self._write_cb is not None:
                self._write_cb(gid, self.resident[gid])
        self.dirty.clear()

    def load_group(self, gid: int, entries: np.ndarray) -> None:
        """Recovery helper: install a group image."""
        if not self.offload:
            lo = gid * self.epg
            hi = min(lo + self.epg, self.n_blocks)
            self.flat[lo:hi] = entries[: hi - lo]
        else:
            self.resident[gid] = entries.copy()
            self.resident_mask[gid] = True
            self.refbit[gid] = 1
            self._maybe_evict()

    def drop_group(self, gid: int) -> None:
        """Recovery helper: forget a resident group (its mapping block is newer)."""
        if self.offload:
            self.resident.pop(gid, None)
            self.resident_mask[gid] = False
            self.dirty.discard(gid)

    def memory_bytes(self) -> int:
        if not self.offload:
            return self.n_blocks * 4  # paper counts 4-byte entries
        return len(self.resident) * self.epg * 4
