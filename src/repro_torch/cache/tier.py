"""ZNS-aware device-resident cache tier.

The cache models a small fast device (CMB/DRAM tier or a cache-grade
ZNS namespace) sitting in front of the ZapRAID array.  Its layout
mirrors the array's own staging arenas (`core/array.py`):

* **Arena** — one int32-packed payload arena ``data_i32`` of
  ``n_zones * zone_cap_blocks`` slots with a uint8 view ``data_u8``,
  exactly the representation the write-path arenas and the fused
  encode kernels use, so promotion on read-fill and demotion are plain
  row gathers with zero host repacking.
* **Zones** — slots are grouped into zones filled append-only through a
  per-zone write pointer.  Eviction is *segment/zone-granular*: a whole
  victim zone is reset at once (reset-friendly, like the flash-cache
  paper), never block-by-block.  The victim is the full zone with the
  fewest referenced live blocks (CLOCK at zone granularity: every reset
  is one clock tick that clears all reference bits, so survivors must
  be re-referenced to stay protected).
* **Keys** — the cache indexes *logical* keys using the array's LSB
  discrimination trick: ``lba << 1`` for user blocks and
  ``(gid << 1) | 1`` for offloaded L2P mapping blocks.  Because keys are
  logical, GC relocation and drive rebuild (which move physical copies
  only) need no cache maintenance at all; the only coherence points are
  commit-time refresh on overwrite and mapping-block commit.
* **Admission** — a count-min :class:`~repro_torch.cache.sketch.FrequencySketch`
  counts misses; a read-fill is admitted only once the key has been
  seen ``admit_threshold`` times, so one-touch scans never displace the
  working set.  Mapping blocks and explicit warm fills bypass the gate
  (``force=True``) — they are small metadata in ZapRAID's own spirit.

All bookkeeping (lookup, fill, refresh, invalidate, zone reset) is
vectorized over numpy bitmaps; there are no per-block Python loops on
the batched paths.

Write policy is write-through refresh: a committed overwrite updates a
resident copy in place and never dirties the cache, so demotion is a
zone reset with no writeback.

When a :class:`repro_torch.sim.device.TimedCacheDevice` is attached, every
batch of hits books cache-device service time on the virtual clock via
``engine.touch_io``, so the timed handler pipeline automatically
completes cache hits at cache-tier latency instead of NAND latency.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cache.sketch import FrequencySketch

NO_SLOT = -1


def user_key(lba: int) -> int:
    """Cache key for a user logical block (LSB 0, like the OOB encoding)."""
    return lba << 1


def meta_key(gid: int) -> int:
    """Cache key for an offloaded L2P mapping-group block (LSB 1)."""
    return (gid << 1) | 1


@dataclasses.dataclass
class CacheConfig:
    """Geometry + policy for the cache tier.

    The arena holds ``n_zones * zone_cap_blocks`` block slots of
    ``block_bytes`` each (``block_bytes`` must be int32-aligned).
    """

    n_zones: int = 8
    zone_cap_blocks: int = 64
    block_bytes: int = 256
    admit_threshold: int = 2
    sketch_width: int = 1024
    sketch_hashes: int = 4
    sketch_decay_every: int | None = None
    sketch_seed: int = 0xCAFE


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    fills: int = 0
    refreshes: int = 0
    rejects: int = 0
    invalidations: int = 0
    zone_resets: int = 0

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class ZnsCacheTier:
    """Zone-structured, logically-keyed block cache (see module docstring)."""

    def __init__(
        self,
        cfg: CacheConfig,
        logical_blocks: int,
        timed_dev=None,
    ) -> None:
        if cfg.block_bytes % 4 != 0:
            raise ValueError("block_bytes must be a multiple of 4 (int32 lanes)")
        self.cfg = cfg
        self.n_slots = cfg.n_zones * cfg.zone_cap_blocks
        lanes = cfg.block_bytes // 4
        # Same packing as _StripeArena: int32 arena + uint8 view, one buffer.
        self.data_i32 = np.zeros((self.n_slots, lanes), dtype=np.int32)
        self.data_u8 = self.data_i32.view(np.uint8).reshape(
            self.n_slots, cfg.block_bytes
        )
        # keys[slot] = cache key resident in that slot, -1 if empty/invalid.
        self.keys = np.full(self.n_slots, -1, dtype=np.int64)
        # Direct-map index over the (user | meta) key space: key -> slot.
        self.slot_of = np.full(2 * logical_blocks, NO_SLOT, dtype=np.int64)
        # CLOCK reference bitmap, cleared wholesale on every zone reset.
        self.ref = np.zeros(self.n_slots, dtype=np.uint8)
        # Per-zone write pointer (blocks filled) and fill generation.
        self.wp = np.zeros(cfg.n_zones, dtype=np.int64)
        self.zone_seq = np.zeros(cfg.n_zones, dtype=np.int64)
        self._seq = 1
        self.zone_seq[0] = 1
        self.active = 0
        self.sketch = FrequencySketch(
            width=cfg.sketch_width,
            n_hashes=cfg.sketch_hashes,
            decay_every=cfg.sketch_decay_every,
            seed=cfg.sketch_seed,
        )
        self.stats = CacheStats()
        self.timed_dev = timed_dev
        # Observability hook (repro_torch.obs via repro_torch.core.handlers): called as
        # ``obs_event(name, **args)`` on lookups and zone resets.  None (the
        # default) keeps the batched paths at one attribute test.
        self.obs_event = None

    # ------------------------------------------------------------- lookup

    def lookup_many(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched probe: returns ``(hit_mask, hit_rows)``.

        ``hit_rows`` are the payloads for ``keys[hit_mask]`` in order.
        Hits set reference bits and book cache-device time; misses feed
        the admission sketch.
        """
        keys = np.asarray(keys, dtype=np.int64)
        slots = self.slot_of[keys]
        hit = slots >= 0
        n_hit = int(np.count_nonzero(hit))
        self.stats.hits += n_hit
        self.stats.misses += int(keys.size) - n_hit
        if self.obs_event is not None:
            self.obs_event("cache.lookup", hits=n_hit,
                           misses=int(keys.size) - n_hit)
        if n_hit:
            hs = slots[hit]
            self.ref[hs] = 1
            self._book(n_hit)
            rows = self.data_u8[hs]
        else:
            rows = np.zeros((0, self.cfg.block_bytes), dtype=np.uint8)
        miss_keys = keys[~hit]
        if miss_keys.size:
            self.sketch.add(miss_keys)
        return hit, rows

    def lookup_one(self, key: int) -> np.ndarray | None:
        """Scalar probe; returns a payload view or None on miss."""
        slot = int(self.slot_of[key])
        if slot < 0:
            self.stats.misses += 1
            self.sketch.add(np.array([key], dtype=np.int64))
            if self.obs_event is not None:
                self.obs_event("cache.lookup", hits=0, misses=1)
            return None
        self.stats.hits += 1
        self.ref[slot] = 1
        self._book(1)
        if self.obs_event is not None:
            self.obs_event("cache.lookup", hits=1, misses=0)
        return self.data_u8[slot]

    def contains_many(self, keys: np.ndarray) -> np.ndarray:
        """Side-effect-free residency mask (no stats, no ref bits)."""
        return self.slot_of[np.asarray(keys, dtype=np.int64)] >= 0

    def contains_run(self, lba: int, n_blocks: int) -> bool:
        """True iff user blocks ``[lba, lba + n_blocks)`` are all resident."""
        if n_blocks == 1:
            return bool(self.slot_of[lba << 1] >= 0)
        keys = np.arange(lba, lba + n_blocks, dtype=np.int64) << 1
        return bool((self.slot_of[keys] >= 0).all())

    def gather_packed(self, slots: np.ndarray) -> np.ndarray:
        """Int32-lane gather of resident rows (zero-copy handoff shape)."""
        return self.data_i32[np.asarray(slots, dtype=np.int64)]

    # --------------------------------------------------------------- fill

    def fill_many(
        self, keys: np.ndarray, blocks: np.ndarray, *, force: bool = False
    ) -> None:
        """Read-fill / promotion path.

        Keys already resident are refreshed in place.  New keys pass the
        frequency-sketch admission gate unless ``force`` is set, then
        are appended at the active zone's write pointer; zone resets
        happen inline when the arena is full.  Bookkeeping is committed
        chunk-by-chunk as zones fill so a victim reset always sees a
        consistent index, even if it cannibalizes an earlier chunk of
        the same batch.
        """
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        blocks = np.asarray(blocks, dtype=np.uint8).reshape(
            keys.size, self.cfg.block_bytes
        )
        slots = self.slot_of[keys]
        present = slots >= 0
        n_present = int(np.count_nonzero(present))
        if n_present:
            ps = slots[present]
            self.data_u8[ps] = blocks[present]
            self.ref[ps] = 1
            self.stats.refreshes += n_present
        new = ~present
        if not new.any():
            return
        nk = keys[new]
        nb = blocks[new]
        if not force:
            admit = self.sketch.estimate(nk) >= self.cfg.admit_threshold
            n_rej = int(nk.size - np.count_nonzero(admit))
            if n_rej:
                self.stats.rejects += n_rej
            nk = nk[admit]
            nb = nb[admit]
        if nk.size == 0:
            return
        # Dedupe within the batch (a read batch may repeat an LBA).
        if nk.size > 1:
            _, first = np.unique(nk, return_index=True)
            if first.size != nk.size:
                first.sort()
                nk = nk[first]
                nb = nb[first]
        self._append(nk, nb)
        self.stats.fills += int(nk.size)

    def fill_one(self, key: int, block: np.ndarray, *, force: bool = False) -> None:
        self.fill_many(
            np.array([key], dtype=np.int64), block[None, :], force=force
        )

    def _append(self, nk: np.ndarray, nb: np.ndarray) -> None:
        cap = self.cfg.zone_cap_blocks
        got = 0
        n = int(nk.size)
        while got < n:
            if self.wp[self.active] == cap:
                self.active = self._next_zone()
            space = cap - int(self.wp[self.active])
            take = min(n - got, space)
            base = self.active * cap + int(self.wp[self.active])
            sl = np.arange(base, base + take, dtype=np.int64)
            self.wp[self.active] += take
            kk = nk[got : got + take]
            self.data_u8[sl] = nb[got : got + take]
            self.keys[sl] = kk
            self.slot_of[kk] = sl
            self.ref[sl] = 1  # one zone-reset grace period for fresh fills
            got += take

    def _next_zone(self) -> int:
        empty = np.flatnonzero(self.wp == 0)
        z = int(empty[0]) if empty.size else self._evict_zone()
        self._seq += 1
        self.zone_seq[z] = self._seq
        return z

    def _evict_zone(self) -> int:
        """Zone-granular CLOCK: reset the zone with the fewest referenced
        live blocks (live count breaks ties, then oldest fill)."""
        cap = self.cfg.zone_cap_blocks
        live = (self.keys >= 0).reshape(self.cfg.n_zones, cap)
        refd = (self.ref > 0).reshape(self.cfg.n_zones, cap) & live
        score = refd.sum(axis=1) * (cap + 1) + live.sum(axis=1)
        z = int(np.lexsort((self.zone_seq, score))[0])
        self._reset_zone(z)
        return z

    def _reset_zone(self, z: int) -> None:
        cap = self.cfg.zone_cap_blocks
        sl = slice(z * cap, (z + 1) * cap)
        ks = self.keys[sl]
        livek = ks[ks >= 0]
        if livek.size:
            self.slot_of[livek] = NO_SLOT
        self.keys[sl] = -1
        self.wp[z] = 0
        # One clock tick: every resident block must be re-referenced to
        # stay protected through the next reset.
        self.ref[:] = 0
        self.stats.zone_resets += 1
        if self.obs_event is not None:
            self.obs_event("cache.zone_reset", zone=z, evicted=int(livek.size))

    # ---------------------------------------------------------- coherence

    def refresh_many(self, keys: np.ndarray, blocks: np.ndarray) -> None:
        """Write-path coherence: update resident copies in place.

        Non-resident keys are left alone (no write-allocate) — the read
        path re-fills them on demand if they stay hot.
        """
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        slots = self.slot_of[keys]
        m = slots >= 0
        n = int(np.count_nonzero(m))
        if not n:
            return
        blocks = np.asarray(blocks, dtype=np.uint8).reshape(
            keys.size, self.cfg.block_bytes
        )
        ms = slots[m]
        self.data_u8[ms] = blocks[m]
        self.ref[ms] = 1
        self.stats.refreshes += n

    def refresh_one(self, key: int, block: np.ndarray) -> None:
        slot = int(self.slot_of[key])
        if slot < 0:
            return
        self.data_u8[slot] = block
        self.ref[slot] = 1
        self.stats.refreshes += 1

    def invalidate_many(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        slots = self.slot_of[keys]
        m = slots >= 0
        n = int(np.count_nonzero(m))
        if not n:
            return
        ms = slots[m]
        self.keys[ms] = -1
        self.ref[ms] = 0
        self.slot_of[keys[m]] = NO_SLOT
        self.stats.invalidations += n

    def invalidate_one(self, key: int) -> None:
        slot = int(self.slot_of[key])
        if slot < 0:
            return
        self.keys[slot] = -1
        self.ref[slot] = 0
        self.slot_of[key] = NO_SLOT
        self.stats.invalidations += 1

    # ------------------------------------------------------------- timing

    def _book(self, n_blocks: int) -> None:
        if self.timed_dev is not None:
            self.timed_dev.book_read(n_blocks, self.timed_dev.engine.now)

    def reset_timing(self) -> None:
        if self.timed_dev is not None:
            self.timed_dev.reset_timing()

    # --------------------------------------------------------------- misc

    def clear(self) -> None:
        """Drop all contents and counters (cold cache)."""
        self.data_i32[:] = 0
        self.keys[:] = -1
        self.slot_of[:] = NO_SLOT
        self.ref[:] = 0
        self.wp[:] = 0
        self.zone_seq[:] = 0
        self._seq = 1
        self.zone_seq[0] = 1
        self.active = 0
        self.sketch.clear()
        self.stats.reset()

    def resident_count(self) -> int:
        return int(np.count_nonzero(self.keys >= 0))
