"""ZapRAID controller: a log-structured RAID volume over simulated ZNS drives.

Implements the paper end to end:

* log-structured segments over k+m zones with header/data/footer regions
  (§3.1) and replicated header descriptors;
* group-based data layout (§3.2): Zone-Append segments commit stripes in
  groups of G with a *globally shuffled* completion order (modeling device
  reordering) and record placements in a byte-rounded compact stripe table;
* hybrid data management (§3.3): small-chunk vs large-chunk open segments,
  one small segment reserved for Zone Append, write-size threshold C_l;
* block metadata in OOB + footer, parity-redundant LBA/ts on parity chunks;
* crash consistency (§3.4): header scan -> partial-stripe discard ->
  full-stripe rewrite -> L2P/CST rebuild (footers for sealed, OOB scan for
  open segments), mapping-block-aware L2P recovery;
* degraded reads (CST group search), full-drive recovery (§3.5);
* greedy garbage collection with validity bitmaps (§4);
* L2P offloading with CLOCK eviction into LSB-tagged mapping blocks (§3.1).

The LBA field stored in block metadata is shifted left by one bit: user
blocks use ``lba << 1`` and mapping blocks ``(gid << 1) | 1`` -- the same
LSB-discrimination trick as the paper (which relies on 4 KiB alignment).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import segment as seg_mod
from repro_torch.core.group_layout import CompactStripeTable
from repro_torch.core.l2p import (
    NO_PBA,
    L2PTable,
    pack_pba,
    pack_pba_many,
    unpack_pba,
    unpack_pba_many,
)
from repro_torch.kernels import ops as kops
from repro_torch.core.raid import (
    StripeCodec,
    check_device,
    decode_meta,
    decode_meta_batch,
    make_scheme,
    parity_oob,
    parity_oob_batch,
)
from repro_torch.core.segment import (
    SegmentClass,
    SegmentInfo,
    SegmentState,
    pack_footer,
    pack_header,
    solve_stripes_per_segment,
    unpack_footer,
    unpack_header,
)
from repro_torch.core.zns import (
    INVALID_LBA,
    OOB_DTYPE,
    CrashBudget,
    DeviceCrashed,
    DriveFailed,
    SimZnsDrive,
    ZnsConfig,
    ZoneState,
    make_array_drives,
)
from repro_torch.integrity.checksum import crc32c_many


class IntegrityError(RuntimeError):
    """Unrepairable corruption: a stripe has lost more blocks (corrupt or
    unreadable media, on top of failed/rebuilding drives) than its parity
    can reconstruct.  Raised *instead of* ever returning wrong bytes to a
    reader -- the loud-failure contract of the verify-on-read and scrub
    paths."""


@dataclasses.dataclass
class ZapRaidConfig:
    scheme: str = "raid5"
    n_drives: int = 4
    group_size: int = 256          # G (>=2 => Zone Append; ==1 => Zone Write)
    chunk_blocks: int = 1          # C in single-class mode
    logical_blocks: int = 2048
    # hybrid data management (§3.3); when enabled, single-class fields unused
    hybrid: bool = False
    n_small: int = 1               # N_s open small-chunk segments
    n_large: int = 0               # N_l open large-chunk segments
    small_chunk_blocks: int = 1    # C_s
    large_chunk_blocks: int = 4    # C_l (also the write-size threshold)
    # L2P offloading
    l2p_memory_limit_entries: Optional[int] = None
    # GC
    gc_free_segments_low: int = 1  # trigger GC when free segments/drive < this
    # Reserved-zone escrow: zones per drive only GC restage may consume.
    # Foreground segment opens refuse to dip below this floor, so a GC pass
    # at very high utilization always has somewhere to restage survivors
    # (fixes the zone-exhaustion deadlock).  Left at 0, the escrow
    # auto-sizes from group geometry on near-full arrays -- see
    # ZapRAIDArray.reserved_zones().
    gc_reserved_zones: int = 0
    # integrity: verify checksums on every read datapath (scalar + batched);
    # a mismatching or unreadable block is treated as erased, reconstructed
    # through parity, and repaired in place.  Off by default: the checksum
    # *store* is always maintained at commit time, only the read-side verify
    # pass is optional (bit-identity with pre-integrity baselines).
    verify_reads: bool = False
    # datapath: the device the stripe codec runs on ("cuda" launches the
    # CUDA kernels; "cpu" runs their plain torch versions).  "cuda" with no
    # GPU present raises at construction -- there is no silent CPU fallback.
    device: str = "cuda"
    batched: bool = True           # group-level fused encode + vectorized I/O
    # double-buffered group commits: the fused encode for group g+1 is
    # launched (asynchronously, on the current CUDA stream) before group
    # g's chunks are committed to the drives, with explicit syncs at reads,
    # flush, seal, GC and crash-arming.  Only active on the untimed
    # functional path (the timed pipeline's group barrier is already a sync
    # point).
    overlap: bool = True
    append_seed: int = 1234
    # Zone-Append completion-order source: "timed" derives the disorder from
    # the discrete-event device model (fastest command wins the write
    # pointer; requires a timed pipeline, repro_torch.sim); "rng" is the seeded
    # permutation fallback used by the standalone functional simulator.
    append_order: str = "timed"

    def __post_init__(self) -> None:
        check_device(self.device)

    def chunk_sizes(self) -> list[tuple[int, int]]:
        """[(seg_class, chunk_blocks)] for the open-segment classes in use."""
        if not self.hybrid:
            return [(int(SegmentClass.SMALL), self.chunk_blocks)]
        out = []
        if self.n_small:
            out.append((int(SegmentClass.SMALL), self.small_chunk_blocks))
        if self.n_large:
            out.append((int(SegmentClass.LARGE), self.large_chunk_blocks))
        return out


@dataclasses.dataclass
class Stats:
    host_blocks_written: int = 0
    device_blocks_written: int = 0
    stripes_committed: int = 0
    padded_blocks: int = 0
    reads: int = 0
    degraded_reads: int = 0
    cst_entries_accessed: int = 0
    gc_runs: int = 0
    gc_blocks_moved: int = 0
    recovery_blocks_read: int = 0
    meta_blocks_written: int = 0
    # host<->device transfer accounting (bumped by the codec): the
    # device-resident datapath's figure of merit is copies *per group*, not
    # per stripe -- see bench_read_batched / DESIGN.md §9.
    h2d_copies: int = 0
    h2d_bytes: int = 0
    d2h_copies: int = 0
    d2h_bytes: int = 0
    # cache tier (repro_torch.cache), all zero when no cache is attached
    cache_hits: int = 0
    cache_misses: int = 0
    l2p_cache_hits: int = 0      # mapping-block fault-ins served by the cache
    l2p_cache_misses: int = 0    # ... that had to read media
    l2p_cache_offloads: int = 0  # CLOCK evictions spilled into the cache
    # integrity (verify-on-read + scrub), all zero with verification off
    integrity_corruptions_detected: int = 0  # checksum-mismatch blocks seen
    integrity_unreadable_hits: int = 0       # UNC sectors encountered
    integrity_blocks_repaired: int = 0       # blocks rewritten in place
    integrity_scrub_passes: int = 0          # completed scrub_once() sweeps
    integrity_scrub_blocks: int = 0          # blocks bulk-verified by scrub

    def write_amp(self) -> float:
        if self.host_blocks_written == 0:
            return 0.0
        return self.device_blocks_written / self.host_blocks_written


class _StripeArena:
    """Preallocated int32-packed staging arena for one segment class.

    Host blocks are packed exactly once: ``write()`` slice-assigns payload
    bytes into ``pay_u8``, which is a dtype *view* of the int32 lane buffer
    ``pay_i32`` the fused group encode consumes -- no ``np.stack``, no
    re-packing, no per-stripe allocation on the steady-state path.  Slot 0 is
    a permanently-zero row used to pad partial groups up to the codec's
    power-of-two shape buckets with a single fancy-index gather.

    Sized for two full stripe groups plus slack: one group staged in the
    segment's ``group_buffer`` while the previous (double-buffered) group is
    still pending commit, plus the in-flight stripe.
    """

    def __init__(self, k: int, chunk_blocks: int, block_bytes: int, group_size: int):
        assert block_bytes % 4 == 0, "int32 lane packing needs 4-byte blocks"
        self.k = k
        self.c = chunk_blocks
        self.n_slots = 2 * max(group_size, 1) + 4
        lanes = chunk_blocks * block_bytes // 4
        self.pay_i32 = np.zeros((self.n_slots, k, lanes), dtype=np.int32)
        self.pay_u8 = self.pay_i32.view(np.uint8).reshape(
            self.n_slots, k * chunk_blocks, block_bytes
        )
        cap = k * chunk_blocks
        self.lbas = np.full((self.n_slots, cap), -1, dtype=np.int64)
        self.ts = np.zeros((self.n_slots, cap), dtype=np.uint64)
        self.gids = np.full((self.n_slots, cap), -1, dtype=np.int64)
        self._free = list(range(self.n_slots - 1, 0, -1))  # slot 0 = zero pad

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        self._free.append(slot)

    def gather_packed(self, slots: np.ndarray) -> np.ndarray:
        """(len(slots), k, lanes) int32 gather -- the fused-encode input."""
        return self.pay_i32[slots]


class _InFlightStripe:
    """Accumulates k*C data blocks before encode+commit (paper §3.1).

    Backed by a :class:`_StripeArena` slot when one is available (the
    batched datapath), falling back to private arrays otherwise (legacy
    datapath, or a drained arena)."""

    def __init__(
        self,
        k: int,
        chunk_blocks: int,
        block_bytes: int,
        arena: Optional[_StripeArena] = None,
    ):
        self.k = k
        self.c = chunk_blocks
        self.capacity = k * chunk_blocks
        self.arena = None
        self.slot = None
        if arena is not None:
            slot = arena.acquire()
            if slot is not None:
                self.arena, self.slot = arena, slot
                self.blocks = arena.pay_u8[slot]
                self.lbas = arena.lbas[slot]
                self.ts = arena.ts[slot]
                self.meta_gids = arena.gids[slot]
                # reused slot: reset staging metadata in place (payload bytes
                # are overwritten on add / zeroed by pad_to_full)
                self.lbas[:] = -1
                self.ts[:] = 0
                self.meta_gids[:] = -1
        if self.arena is None:
            self.blocks = np.zeros((self.capacity, block_bytes), dtype=np.uint8)
            self.lbas = np.full(self.capacity, -1, dtype=np.int64)  # -1 = padding
            self.ts = np.zeros(self.capacity, dtype=np.uint64)
            self.meta_gids = np.full(self.capacity, -1, dtype=np.int64)
        self.fill = 0

    def release(self) -> None:
        if self.arena is not None:
            self.arena.release(self.slot)
            self.arena = None

    def add(self, lba: int, block: np.ndarray, ts: int, meta_gid: int = -1) -> None:
        i = self.fill
        self.blocks[i] = block
        self.lbas[i] = lba
        self.ts[i] = ts
        self.meta_gids[i] = meta_gid
        self.fill += 1

    def add_many(
        self, lbas: np.ndarray, blocks: np.ndarray, ts: int,
        meta_gids: Optional[np.ndarray] = None,
    ) -> None:
        """Bulk slice-assign a run of blocks (must fit in remaining capacity)."""
        n = lbas.shape[0]
        i = self.fill
        assert i + n <= self.capacity, (i, n, self.capacity)
        self.blocks[i : i + n] = blocks
        self.lbas[i : i + n] = lbas
        self.ts[i : i + n] = ts
        self.meta_gids[i : i + n] = -1 if meta_gids is None else meta_gids
        self.fill += n

    @property
    def full(self) -> bool:
        return self.fill == self.capacity

    def pad_to_full(self) -> int:
        """Flush path: pad in place -- zero the unfilled arena tail directly
        instead of staging explicit padding blocks through a second copy."""
        pad = self.capacity - self.fill
        if pad and self.arena is not None:
            self.blocks[self.fill :] = 0  # reused slot may hold stale payload
        self.fill = self.capacity
        return pad


class _OpenSegment:
    """Runtime state of one open segment."""

    def __init__(self, info: SegmentInfo, block_bytes: int):
        self.info = info
        self.block_bytes = block_bytes
        n, s, c = info.n_drives, info.n_stripes, info.chunk_blocks
        self.cst = CompactStripeTable(n, s, info.group_size) if info.uses_append else None
        # full per-zone metadata buffer (for footer writes at seal time)
        self.meta = np.zeros((n, s * c), dtype=OOB_DTYPE)
        self.meta["lba"] = INVALID_LBA
        self.group_buffer: list[dict] = []  # staged stripes of the current group

    @property
    def seg_id(self) -> int:
        return self.info.seg_id


class _SegmentRecord:
    """Controller-side record for any live (open or sealed) segment."""

    def __init__(self, info: SegmentInfo):
        self.info = info
        n, s, c = info.n_drives, info.n_stripes, info.chunk_blocks
        self.valid = np.zeros((n, s * c), dtype=bool)  # data-region validity
        self.valid_count = 0
        self.cst: Optional[CompactStripeTable] = None

    def data_capacity(self) -> int:
        k = self.info.k
        return self.info.n_stripes * self.info.chunk_blocks * k


class ZapRAIDArray:
    """The user-facing block volume (paper Figure 3)."""

    def __init__(
        self,
        cfg: ZapRaidConfig,
        zns_cfg: ZnsConfig,
        drives: Optional[list[SimZnsDrive]] = None,
        *,
        _recovering: bool = False,
    ):
        self.cfg = cfg
        self.zns_cfg = zns_cfg
        self.scheme = make_scheme(cfg.scheme, cfg.n_drives)
        self.codec = StripeCodec(self.scheme, device=cfg.device)
        self.stats = Stats()
        self.codec.copy_stats = self.stats
        self.budget = CrashBudget(None)
        self.drives = drives or make_array_drives(cfg.n_drives, zns_cfg, self.budget)
        for d in self.drives:
            d.budget = self.budget
        self.ts_counter = 1
        self.next_seg_id = 0
        self.rng = np.random.default_rng(cfg.append_seed)
        # Timed-pipeline hooks (repro_torch.sim / repro_torch.core.handlers).  When a
        # discrete-event engine drives this array, ``append_plan_fn`` maps a
        # Zone-Append group's ops to their timing-derived completion order
        # (replacing the RNG permutation), and ``commit_listener`` observes
        # every persisted stripe for latency attribution.  Both default to
        # None: the standalone functional array is unchanged.
        self.append_plan_fn = None   # (info, [(s_i, drive_idx)]) -> issue order
        self.commit_listener = None  # (info, built, per_drive_off) -> None
        # Observes every fused-encode sync: (info, n_stripes, host_us).  The
        # timed pipeline uses it to thread encode completions through the
        # engine's accounting so latency stats stay honest about host-side
        # codec stalls (virtual time is unaffected: the encode is host work).
        self.encode_listener = None
        # Observability hook (repro_torch.obs via repro_torch.core.handlers): called as
        # ``obs_event(name, **args)`` at instrumentation points the array
        # alone can see -- degraded decodes, GC pass begin/end.  None (the
        # default) keeps every fast path at one attribute test.
        self.obs_event = None

        # zone allocation: per-drive free zone list (LIFO)
        self.free_zones: list[list[int]] = [
            list(range(zns_cfg.n_zones - 1, -1, -1)) for _ in range(cfg.n_drives)
        ]
        self.segments: dict[int, _SegmentRecord] = {}
        self.open_segments: dict[int, _OpenSegment] = {}
        # open segment ids by class: small[0] is the Zone-Append one
        self.small_ids: list[int] = []
        self.large_ids: list[int] = []
        self._rr_small = 0
        self._rr_large = 0
        self._pending_meta: list[int] = []  # gids awaiting mapping-block write
        self._meta_staging: dict[int, np.ndarray] = {}  # gid -> entries in flight
        # In-flight image count per gid: pending-queue entries plus staged
        # mapping blocks not yet committed.  ``_meta_staging`` is dropped when
        # the count returns to zero (every queued image durable) -- stripe
        # commit re-stamps block timestamps, so a ts match cannot detect this.
        self._meta_refs: dict[int, int] = {}
        self._buffered: dict[int, tuple] = {}  # lba -> (stripe, slot), uncommitted
        self.mapping_table: dict[int, int] = {}  # gid -> pba of mapping block

        self.l2p = L2PTable(
            cfg.logical_blocks,
            memory_limit_entries=cfg.l2p_memory_limit_entries,
            write_mapping_block=self._queue_mapping_block,
            read_mapping_block=self._read_mapping_block,
            entries_per_group=zns_cfg.block_bytes // 4,
        )
        self._in_flight: dict[int, _InFlightStripe] = {}  # per segment class
        # device-resident staging: one packed arena per segment class, and at
        # most one built-but-uncommitted (double-buffered) stripe group
        self._arenas: dict[int, _StripeArena] = {}
        self._pending_group: Optional[dict] = None
        # Latest committed write-timestamp per LBA / mapping group.  Commits
        # can complete out of order across segments (a buffered Zone-Append
        # group lands after a later Zone-Write stripe), so L2P updates are
        # timestamp-guarded.
        self._lba_ts = np.zeros(cfg.logical_blocks, dtype=np.uint64)
        self._gid_ts: dict[int, int] = {}
        # (seg_id, drive_idx) pairs whose zone is awaiting a paced rebuild:
        # the drive has been replaced (healthy but empty there), so reads of
        # those zones must route through reconstruction until the rebuild
        # actor reaches them.  Empty outside a paced rebuild.
        self._rebuild_pending: set[tuple[int, int]] = set()
        # Optional cache tier (repro_torch.cache.ZnsCacheTier) -- see attach_cache.
        self.cache = None
        # True while gc_once() is restaging survivors: segment opens may dip
        # into the gc_reserved_zones escrow only then.
        self._gc_active = False
        # Degraded-mode write width: the physical drives new segments span.
        # Healthy arrays use every drive (member index == drive index, the
        # historical layout, bit-identical).  ``fail_drive`` re-rotates onto
        # the survivors so new stripe groups open at survivor width; rebuild
        # re-widens (see _rewiden).  Mixed widths coexist: every segment
        # carries its own ``drive_ids`` member map.
        self._active_ids: tuple[int, ...] = tuple(range(cfg.n_drives))
        # per-width scheme/codec caches (narrow survivor-width variants of
        # cfg.scheme; the kernel coeff matrices are already lru-cached)
        self._schemes: dict[int, object] = {cfg.n_drives: self.scheme}
        self._codecs: dict[int, StripeCodec] = {cfg.n_drives: self.codec}

        if not _recovering:
            self._open_initial_segments()

    # ------------------------------------------------------------------ util

    def _now(self) -> int:
        self.ts_counter += 1
        return self.ts_counter

    def _layout_for(self, chunk_blocks: int) -> tuple[int, int]:
        return solve_stripes_per_segment(
            self.zns_cfg.zone_cap_blocks, chunk_blocks, self.zns_cfg.block_bytes
        )

    # ---------------------------------------------- mixed-width scheme/codec

    def _scheme_for_width(self, width: int):
        """The cfg scheme instantiated at ``width`` drives (survivor width).

        Raises RuntimeError when the scheme cannot operate that narrow
        (raid6 below 3 drives, raid01 below 2)."""
        sch = self._schemes.get(width)
        if sch is None:
            min_w = 2 if self.scheme.mirror else self.scheme.m + 1
            if width < max(min_w, 1):
                raise RuntimeError(
                    f"{self.cfg.scheme} is not writable at width {width}"
                )
            sch = make_scheme(self.cfg.scheme, width)
            self._schemes[width] = sch
        return sch

    def _codec_for_width(self, width: int) -> StripeCodec:
        codec = self._codecs.get(width)
        if codec is None:
            codec = StripeCodec(self._scheme_for_width(width), device=self.cfg.device)
            codec.copy_stats = self.stats
            self._codecs[width] = codec
        return codec

    def _scheme_for(self, info: SegmentInfo):
        return self._scheme_for_width(info.n_drives)

    def _codec_for(self, info: SegmentInfo) -> StripeCodec:
        return self._codec_for_width(info.n_drives)

    def _active_drive_ids(self) -> tuple[int, ...]:
        """Healthy drives new segments may span (mirror widths stay even)."""
        ids = tuple(i for i, d in enumerate(self.drives) if not d.failed)
        if self.scheme.mirror and len(ids) % 2:
            ids = ids[:-1]  # a mirror stripe needs drive pairs
        return ids

    def reserved_zones(self) -> int:
        """Effective GC escrow: zones/drive foreground opens must leave.

        An explicit ``cfg.gc_reserved_zones`` always wins.  Left at 0, the
        escrow *auto-sizes from group geometry* once the array runs
        near-full: when the scarcest drive is down to its last few free
        zones (within ``gc_free_segments_low + 1`` of the auto reserve),
        one restage destination per open segment class is reserved so a GC
        pass at high utilization always has somewhere to restage survivors
        (ROADMAP "smaller known issues").  Roomy arrays see an escrow of
        0 -- historical behavior, bit-identical.

        Auto-sizing needs a live GC watermark: with
        ``gc_free_segments_low == 0`` nothing would clean proactively
        before the floor binds mid-seal, so the escrow would starve
        foreground instead of protecting GC -- such configs (manual-GC
        benches, aging harnesses) keep escrow 0.  It also needs real
        zone headroom: on capacity-tight geometries (a handful of zones
        per drive, logical span close to physical) GC's steady state can
        sit *exactly* at the watermark, and reserving a zone there would
        push the array below its own GC exit threshold for good -- so
        drives with fewer than ``4 * (auto + watermark + 1)`` zones keep
        the historical auto-sizing behavior but still get the 1-zone
        minimum below.

        Manual-GC configs (``gc_free_segments_low == 0``) used to run
        escrow-less: nothing cleans proactively, so foreground could eat
        every last zone -- after which even a *manual* ``gc_once()`` would
        deadlock opening its restage destination.  They now fall back to a
        *1-zone minimum* whenever GC is possible at all (the geometry
        admits at least one segment beyond the open ones), so a GC pass
        always keeps one restage destination.  The fallback minimum gates
        *segment opens only*: it is excluded from ``free_segment_count()``
        so anything reading the watermark arithmetic is unchanged.
        Capacity-tight geometries with a live watermark keep historical
        behavior -- there the inline watermark GC is the protection, and a
        floor would push the array below its own GC exit threshold."""
        if self.cfg.gc_reserved_zones:
            return self.cfg.gc_reserved_zones
        auto = self._auto_reserved_zones()
        if auto:
            return auto
        # fallback: manual-GC configs keep one restage destination zone
        if (
            self.cfg.gc_free_segments_low < 1
            and self.zns_cfg.n_zones >= len(self.cfg.chunk_sizes()) + 2
        ):
            return 1
        return 0

    def _auto_reserved_zones(self) -> int:
        """Geometry-auto-sized escrow (the watermark-shifting part)."""
        if self.cfg.gc_free_segments_low < 1:
            return 0
        auto = len(self.cfg.chunk_sizes())
        headroom = auto + self.cfg.gc_free_segments_low + 1
        if self.zns_cfg.n_zones < 4 * headroom:
            return 0
        return auto if self._min_free_zones() <= headroom else 0

    def _min_free_zones(self) -> int:
        """Scarcest healthy drive's free-zone count (failed drives cannot
        gate foreground opens: new segments span survivors only)."""
        counts = [
            len(fz) for fz, d in zip(self.free_zones, self.drives) if not d.failed
        ]
        return min(counts) if counts else 0

    def free_segment_count(self) -> int:
        """Free segments available to *foreground* writes per drive.

        The GC escrow (``reserved_zones()``) is invisible here unless a
        GC pass is in flight, so GC-trigger watermarks fire before the
        escrow is all that is left.  Only the explicit / auto-sized escrow
        shifts this count; the 1-zone fallback open floor does not (it
        protects exhaustion without perturbing GC schedules)."""
        free = self._min_free_zones()
        if not self._gc_active:
            free -= self.cfg.gc_reserved_zones or self._auto_reserved_zones()
        return max(free, 0)

    def has_staged(self) -> bool:
        """True while foreground work sits in volatile staging: buffered
        blocks of partially filled stripes, a built-but-uncommitted stripe
        group (double buffering), or mapping blocks awaiting their metadata
        write.  The timed pipeline's timeout-flush tick and the service
        tier's idle detection use this to decide whether a ``flush()`` is
        still owed before the system may go quiet."""
        return (
            bool(self._buffered)
            or self._pending_group is not None
            or bool(self._pending_meta)
        )

    # ------------------------------------------------------------- cache tier

    def attach_cache(self, cache) -> None:
        """Install a read/write cache tier (``repro_torch.cache.ZnsCacheTier``).

        The cache indexes *logical* keys (LBA for user blocks, mapping-group
        id for offloaded L2P blocks), so GC relocation and drive rebuild --
        which move physical copies only -- need no cache maintenance.  The
        coherence points are commit-time refresh on overwrite and
        mapping-block commit (both inside the timestamp guards), plus
        read-miss fills.  When the L2P offloads, CLOCK evictions spill the
        evicted group image into the cache so later fault-ins skip media."""
        self.cache = cache
        if self.l2p.offload:
            self.l2p.evict_listener = self._on_l2p_evict

    def _on_l2p_evict(self, gid: int, entries: np.ndarray) -> None:
        if self.cache is None:
            return
        self.stats.l2p_cache_offloads += 1
        self.cache.fill_one(
            (gid << 1) | 1, self._serialize_mapping(entries), force=True
        )

    # -------------------------------------------------------- segment opening

    def _open_initial_segments(self) -> None:
        if not self.cfg.hybrid:
            sid = self._open_segment(SegmentClass.SMALL, self.cfg.chunk_blocks,
                                     self.cfg.group_size)
            self.small_ids = [sid]
        else:
            for i in range(self.cfg.n_small):
                g = self.cfg.group_size if i == 0 else 1  # only one ZA segment
                self.small_ids.append(
                    self._open_segment(SegmentClass.SMALL,
                                       self.cfg.small_chunk_blocks, g)
                )
            for _ in range(self.cfg.n_large):
                self.large_ids.append(
                    self._open_segment(SegmentClass.LARGE,
                                       self.cfg.large_chunk_blocks, 1)
                )

    def _open_segment(self, seg_class: int, chunk_blocks: int, group_size: int) -> int:
        # New segments span the current active drive set: every drive when
        # healthy (member index == drive index), the survivors when degraded.
        drive_ids = self._active_ids
        scheme = self._scheme_for_width(len(drive_ids))
        # Foreground opens stop short of the escrowed zones; only GC restage
        # (self._gc_active) may consume them, so a GC pass at full utilization
        # always has a destination segment (the deadlock fix, ROADMAP item 4).
        floor = 0 if self._gc_active else self.reserved_zones()
        for p in drive_ids:
            if len(self.free_zones[p]) <= floor:
                raise RuntimeError("out of free zones; GC required")
        zone_ids = tuple(self.free_zones[p].pop() for p in drive_ids)
        s, _ = self._layout_for(chunk_blocks)
        info = SegmentInfo(
            seg_id=self.next_seg_id,
            scheme_name=self.scheme.name,
            k=scheme.k,
            m=scheme.m,
            zone_ids=zone_ids,
            chunk_blocks=chunk_blocks,
            group_size=group_size,
            seg_class=int(seg_class),
            create_ts=self._now(),
            n_stripes=s,
            drive_ids=drive_ids,
        )
        self.next_seg_id += 1
        # write the replicated header chunk to every member zone
        hdr_block = pack_header(info, self.zns_cfg.block_bytes)
        hdr_chunk = np.zeros((chunk_blocks, self.zns_cfg.block_bytes), np.uint8)
        hdr_chunk[0] = hdr_block
        oobs = np.zeros(chunk_blocks, dtype=OOB_DTYPE)
        oobs["lba"] = INVALID_LBA
        for p, z in zip(drive_ids, zone_ids):
            self.drives[p].zone_write(z, 0, hdr_chunk, oobs)
            self.stats.device_blocks_written += chunk_blocks
        rec = _SegmentRecord(info)
        self.segments[info.seg_id] = rec
        ost = _OpenSegment(info, self.zns_cfg.block_bytes)
        rec.cst = ost.cst
        self.open_segments[info.seg_id] = ost
        return info.seg_id

    # ------------------------------------------------------------- write path

    def write(self, lba: int, data: np.ndarray) -> None:
        """Write ``data`` (n_blocks x block_bytes uint8) at logical ``lba``."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim == 1:
            data = data.reshape(1, -1)
        n = data.shape[0]
        assert data.shape[1] == self.zns_cfg.block_bytes
        assert 0 <= lba and lba + n <= self.cfg.logical_blocks, (lba, n)
        seg_class = self._classify(n)
        if self.cfg.batched:
            self._append_blocks(
                seg_class, np.arange(lba, lba + n, dtype=np.int64), data, 0
            )
        else:
            for i in range(n):
                self._append_block(seg_class, lba + i, data[i], 0)
        self.stats.host_blocks_written += n
        self.maybe_gc()

    def _classify(self, n_blocks: int) -> int:
        if not self.cfg.hybrid or not self.large_ids:
            return int(SegmentClass.SMALL)
        if not self.small_ids:
            return int(SegmentClass.LARGE)
        return (
            int(SegmentClass.SMALL)
            if n_blocks < self.cfg.large_chunk_blocks
            else int(SegmentClass.LARGE)
        )

    def _chunk_blocks_for(self, seg_class: int) -> int:
        if not self.cfg.hybrid:
            return self.cfg.chunk_blocks
        return (
            self.cfg.small_chunk_blocks
            if seg_class == int(SegmentClass.SMALL)
            else self.cfg.large_chunk_blocks
        )

    def _group_size_for(self, seg_class: int) -> int:
        if not self.cfg.hybrid:
            return self.cfg.group_size
        return self.cfg.group_size if seg_class == int(SegmentClass.SMALL) else 1

    def _new_stripe(self, seg_class: int) -> _InFlightStripe:
        """Fresh in-flight stripe, arena-backed on the batched datapath.

        Stripe capacity follows the *active* write width (k shrinks while
        degraded); arenas are keyed per (class, k) so re-widening gets its
        full-width arena back without reallocating."""
        k = self._scheme_for_width(len(self._active_ids)).k
        arena = None
        if self.cfg.batched and self.zns_cfg.block_bytes % 4 == 0:
            arena = self._arenas.get((seg_class, k))
            if arena is None:
                arena = _StripeArena(
                    k, self._chunk_blocks_for(seg_class),
                    self.zns_cfg.block_bytes, self._group_size_for(seg_class),
                )
                self._arenas[(seg_class, k)] = arena
        return _InFlightStripe(
            k, self._chunk_blocks_for(seg_class),
            self.zns_cfg.block_bytes, arena,
        )

    def _append_block(
        self, seg_class: int, lba: int, block: np.ndarray, ts: int, meta_gid: int = -1
    ) -> None:
        # A new write supersedes any still-uncommitted buffered copy of the
        # same LBA (issue order must win even though commit order differs).
        if lba >= 0:
            buf = self._buffered.pop(lba, None)
            if buf is not None:
                old_stripe, slot = buf
                old_stripe.lbas[slot] = -1  # cancel: becomes padding
        stripe = self._in_flight.get(seg_class)
        if stripe is None:
            stripe = self._new_stripe(seg_class)
            self._in_flight[seg_class] = stripe
        if lba >= 0:
            self._buffered[lba] = (stripe, stripe.fill)
        if meta_gid >= 0:
            # staged-in-stripe mapping-block image holds a staging ref until
            # its stripe commits (see _meta_unref)
            self._meta_refs[meta_gid] = self._meta_refs.get(meta_gid, 0) + 1
        stripe.add(lba, block, ts, meta_gid)
        if stripe.full:
            self._dispatch_stripe(seg_class)

    def _append_blocks(
        self,
        seg_class: int,
        lbas: np.ndarray,
        blocks: np.ndarray,
        ts: int,
        meta_gids: Optional[np.ndarray] = None,
    ) -> None:
        """Bulk ``_append_block``: stage a run of blocks, dispatching each
        stripe as it fills.  Payload copies are vectorized slice assignments;
        only the per-LBA buffered-write bookkeeping stays scalar (dict ops).
        Mapping blocks ride the same path (``lbas`` entry -1 with the group
        id in ``meta_gids``); they never enter the buffered-write map.

        Semantically identical to calling ``_append_block`` per block in
        order (including superseding still-buffered copies of the same LBA).
        """
        n = lbas.shape[0]
        i = 0
        while i < n:
            stripe = self._in_flight.get(seg_class)
            if stripe is None:
                stripe = self._new_stripe(seg_class)
                self._in_flight[seg_class] = stripe
            take = min(stripe.capacity - stripe.fill, n - i)
            base = stripe.fill
            if meta_gids is not None:
                for g in meta_gids[i : i + take]:
                    if g >= 0:
                        g = int(g)
                        self._meta_refs[g] = self._meta_refs.get(g, 0) + 1
            stripe.add_many(
                lbas[i : i + take], blocks[i : i + take], ts,
                None if meta_gids is None else meta_gids[i : i + take],
            )
            # bookkeeping after the bulk copy so a duplicate LBA later in this
            # same slice correctly cancels the slot staged earlier in it
            for j in range(i, i + take):
                lba = int(lbas[j])
                if lba < 0:
                    continue  # mapping block / padding
                buf = self._buffered.pop(lba, None)
                if buf is not None:
                    old_stripe, slot = buf
                    old_stripe.lbas[slot] = -1  # cancel: becomes padding
                self._buffered[lba] = (stripe, base + (j - i))
            i += take
            if stripe.full:
                self._dispatch_stripe(seg_class)

    def _commit_all_staged(self) -> None:
        """Pad+commit every in-flight stripe and staged Zone-Append group."""
        progressed = True
        while progressed:
            progressed = False
            for seg_class, stripe in list(self._in_flight.items()):
                if stripe.fill > 0:
                    self.stats.padded_blocks += stripe.pad_to_full()
                    self._dispatch_stripe(seg_class)
                    progressed = True
            for ost in list(self.open_segments.values()):
                if ost.group_buffer:
                    self._commit_group(ost)
                    progressed = True
            if self._pending_group is not None:
                self._sync_pending()
                progressed = True

    def flush(self) -> None:
        """Timeout path (§3.5): pad partial in-flight stripes and commit, then
        flush staged Zone-Append groups, then persist pending mapping blocks.

        Mapping blocks are committed only when no user write is in flight and
        only in metadata-pure stripes: this guarantees a mapping block's
        content covers every user commit with a smaller timestamp, which is
        the invariant the crash-recovery freshness comparison relies on."""
        self._commit_all_staged()
        while self._pending_meta:
            self._drain_meta()
            self._commit_all_staged()

    # -- segment selection (paper §3.3 policy) --------------------------------

    def _select_segment(self, seg_class: int) -> _OpenSegment:
        if seg_class == int(SegmentClass.LARGE) and self.large_ids:
            i = self._rr_large % len(self.large_ids)
            self._rr_large += 1
            return self._rotation_slot(self.large_ids, i, SegmentClass.LARGE,
                                       self.cfg.large_chunk_blocks, 1)
        ids = self.small_ids
        cb = (self.cfg.small_chunk_blocks if self.cfg.hybrid
              else self.cfg.chunk_blocks)
        if len(ids) == 1:
            return self._rotation_slot(ids, 0, SegmentClass.SMALL, cb,
                                       self.cfg.group_size)
        # N_s > 1: round-robin the Zone-Write segments, spill to the reserved
        # Zone-Append segment every cycle (models "no idle ZW segment").
        i = (self._rr_small % len(ids) + 1) % len(ids)
        self._rr_small += 1
        gsz = self.cfg.group_size if i == 0 else 1
        return self._rotation_slot(ids, i, SegmentClass.SMALL, cb, gsz)

    def _rotation_slot(
        self, ids: list, i: int, seg_class, chunk_blocks: int, group_size: int
    ) -> _OpenSegment:
        """Rotation slot -> open segment, re-opening a stale slot.

        A segment roll-over that failed at the reserved-zone floor (loud
        RuntimeError mid-seal) leaves the slot pointing at the sealed
        segment.  Retrying the open here lets a later GC restage
        (floor-exempt via ``_gc_active``) heal the rotation and un-wedge the
        array, while a foreground retry hits the same loud error again."""
        sid = ids[i]
        ost = self.open_segments.get(sid)
        if ost is None:
            ids[i] = sid = self._open_segment(
                int(seg_class), chunk_blocks, group_size
            )
            ost = self.open_segments[sid]
        return ost

    def _pending_count(self, ost: _OpenSegment) -> int:
        """Stripes built-but-uncommitted (double-buffered) for this segment."""
        pend = self._pending_group
        if pend is not None and pend["ost"] is ost:
            return len(pend["seqs"])
        return 0

    def _dispatch_stripe(self, seg_class: int) -> None:
        stripe = self._in_flight.pop(seg_class)
        ost = self._select_segment(seg_class)
        if ost.info.uses_append:
            # stage the RAW stripe; parity encode + timestamping happen at
            # group-commit time so on-disk timestamps reflect commit order.
            ost.group_buffer.append(stripe)
            gsz = ost.info.group_size
            staged = (
                ost.info.stripes_written
                + self._pending_count(ost)
                + len(ost.group_buffer)
            )
            if staged % gsz == 0 or staged == ost.info.n_stripes:
                self._commit_group(ost)
        else:
            built = self._build_stripe(ost, stripe, ost.info.stripes_written)
            self._commit_zone_write(ost, built)
            stripe.release()
        self._maybe_seal(ost)

    # -- stripe construction ---------------------------------------------------

    def _build_stripe(
        self, ost: _OpenSegment, stripe: _InFlightStripe, stripe_seq: int
    ) -> dict:
        """Encode parity; return a commit-ready stripe dict (not yet placed).

        Block timestamps are (re)assigned here -- i.e., at commit time -- so
        the on-disk timestamp order equals the commit order; superseded
        buffered copies were already cancelled in ``_append_block``."""
        info = ost.info
        k, m, c = info.k, info.m, info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        codec = self._codec_for(info)
        commit_ts = self._now()
        stripe.ts[:] = commit_ts
        for slot in range(stripe.capacity):
            lba = int(stripe.lbas[slot])
            if lba >= 0:
                buf = self._buffered.get(lba)
                if buf is not None and buf[0] is stripe and buf[1] == slot:
                    del self._buffered[lba]
        data = stripe.blocks.reshape(k, c * bb)
        parity = codec.encode_np(data).reshape(m, c, bb) if m else np.zeros(
            (0, c, bb), np.uint8
        )
        meta_mask = stripe.meta_gids >= 0
        pad_mask = (stripe.lbas < 0) & ~meta_mask
        lba_fields = np.empty(stripe.capacity, dtype=np.uint64)
        lba_fields[meta_mask] = (
            stripe.meta_gids[meta_mask].astype(np.uint64) << np.uint64(1)
        ) | np.uint64(1)
        lba_fields[pad_mask] = INVALID_LBA
        user_mask = ~meta_mask & ~pad_mask
        lba_fields[user_mask] = stripe.lbas[user_mask].astype(np.uint64) << np.uint64(1)
        data_oob = np.zeros((k, c), dtype=OOB_DTYPE)
        data_oob["lba"] = lba_fields.reshape(k, c)
        data_oob["ts"] = stripe.ts.reshape(k, c)
        data_oob["stripe"] = stripe_seq
        if m:
            p_lba, p_ts = parity_oob(
                codec, data_oob["lba"], data_oob["ts"]
            )
            par_oob = np.zeros((m, c), dtype=OOB_DTYPE)
            par_oob["lba"] = p_lba
            par_oob["ts"] = p_ts
            par_oob["stripe"] = stripe_seq
        else:
            par_oob = np.zeros((0, c), dtype=OOB_DTYPE)
        return {
            "seq": stripe_seq,
            "data": stripe.blocks.reshape(k, c, bb),
            "parity": parity,
            "data_oob": data_oob,
            "par_oob": par_oob,
            "lbas": stripe.lbas.reshape(k, c),
            "ts": stripe.ts.reshape(k, c),
            "meta_gids": stripe.meta_gids.reshape(k, c),
        }

    def _build_group(
        self, ost: _OpenSegment, raws: list[_InFlightStripe], seq0: int
    ) -> dict:
        """Build a whole stripe group and *dispatch* its fused parity encode.

        Bit-identical to the per-stripe ``_build_stripe`` loop -- same commit
        timestamp sequence, same cancellation of superseded buffered copies,
        same completion-order draw -- but the payload is gathered from the
        int32-packed staging arena in one fancy index (power-of-two bucketed
        via the arena's permanent zero slot) and handed to the codec's
        async entry point.  The returned group dict carries the
        un-materialized device parity; :meth:`_commit_built_group` syncs on
        it, which is what makes double-buffered commits overlap host commit
        work for group g with the encode of group g+1.
        """
        info = ost.info
        k, m, c = info.k, info.m, info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        scheme = self._scheme_for(info)
        codec = self._codec_for(info)
        s_count = len(raws)
        # commit timestamps: the same values s_count sequential _now() calls
        # would produce, assigned in staging order
        ts0 = self.ts_counter
        self.ts_counter += s_count
        ts_vec = np.arange(ts0 + 1, ts0 + s_count + 1, dtype=np.uint64)
        arena = raws[0].arena
        if arena is not None and all(r.arena is arena for r in raws):
            slots = np.fromiter((r.slot for r in raws), np.int64, s_count)
            target = 1 << max(0, (s_count - 1).bit_length())
            if target != s_count:
                slots_padded = np.concatenate(
                    [slots, np.zeros(target - s_count, np.int64)]  # zero slot
                )
            else:
                slots_padded = slots
            packed = arena.gather_packed(slots_padded)  # (S_pad, k, lanes)
            lbas_all = arena.lbas[slots]                # gather: fresh copies
            gids_all = arena.gids[slots]
        else:  # arena drained / unaligned blocks: stack + host-side pack
            stacked = np.stack([r.blocks for r in raws]).reshape(s_count, k, c * bb)
            padded, _ = StripeCodec._pad_batch(stacked)
            packed = kops.pack_bytes_np(padded)
            lbas_all = np.stack([r.lbas for r in raws])
            gids_all = np.stack([r.meta_gids for r in raws])
        # data payload for the drive commits: a dtype view of the same gather
        data_all = kops.unpack_bytes_np(packed)[:s_count].reshape(s_count, k, c, bb)
        if m and not scheme.mirror:
            parity_dev = codec.encode_batch_async(packed)
        else:
            parity_dev = None  # mirror copies / RAID-0: no device work
        # superseded-copy cancellation marked these slots as padding already;
        # every still-nonnegative LBA is owned by its staging slot
        for lba in lbas_all.ravel():
            if lba >= 0:
                self._buffered.pop(int(lba), None)
        ts_all = np.broadcast_to(ts_vec[:, None], (s_count, k * c))
        seqs = np.arange(seq0, seq0 + s_count, dtype=np.int64)
        meta_mask = gids_all >= 0
        pad_mask = (lbas_all < 0) & ~meta_mask
        user_mask = ~meta_mask & ~pad_mask
        lba_fields = np.empty((s_count, k * c), dtype=np.uint64)
        lba_fields[meta_mask] = (
            gids_all[meta_mask].astype(np.uint64) << np.uint64(1)
        ) | np.uint64(1)
        lba_fields[pad_mask] = INVALID_LBA
        lba_fields[user_mask] = lbas_all[user_mask].astype(np.uint64) << np.uint64(1)
        data_oob = np.zeros((s_count, k, c), dtype=OOB_DTYPE)
        data_oob["lba"] = lba_fields.reshape(s_count, k, c)
        data_oob["ts"] = ts_all.reshape(s_count, k, c)
        data_oob["stripe"] = seqs[:, None, None]
        if m:
            p_lba, p_ts = parity_oob_batch(
                codec, data_oob["lba"], data_oob["ts"]
            )
            par_oob = np.zeros((s_count, m, c), dtype=OOB_DTYPE)
            par_oob["lba"] = p_lba
            par_oob["ts"] = p_ts
            par_oob["stripe"] = seqs[:, None, None]
        else:
            par_oob = np.zeros((s_count, 0, c), dtype=OOB_DTYPE)
        # Zone-Append completion order is drawn at build time so the RNG /
        # device-plan sequence matches the synchronous commit path even when
        # the drive commit itself is deferred one group.
        ops_list = [
            (s_i, d) for s_i in range(s_count) for d in range(info.n_drives)
        ]
        if self.append_plan_fn is not None:
            order = np.asarray(self.append_plan_fn(info, ops_list), np.int64)
        else:
            order = self.rng.permutation(len(ops_list)).astype(np.int64)
        return {
            "ost": ost,
            "raws": raws,
            "seqs": seqs,
            "data_all": data_all,
            "parity_dev": parity_dev,
            "data_oob": data_oob,
            "par_oob": par_oob,
            "lbas_all": lbas_all.reshape(s_count, k, c),
            "ts_all": np.ascontiguousarray(ts_all).reshape(s_count, k, c),
            "gids_all": gids_all.reshape(s_count, k, c),
            "order": order,
        }

    def _role_payload(self, built: dict, role: int):
        k = built["data"].shape[0]
        if role < k:
            return built["data"][role], built["data_oob"][role]
        return built["parity"][role - k], built["par_oob"][role - k]

    # -- commit paths -----------------------------------------------------------

    def _commit_zone_write(self, ost: _OpenSegment, built: dict) -> None:
        """Ordered Zone Write commit: every chunk lands at the static offset."""
        info = ost.info
        c = info.chunk_blocks
        scheme = self._scheme_for(info)
        seq = built["seq"]
        off = info.data_start() + seq * c
        for drive_idx in range(info.n_drives):
            role = scheme.drive_to_role(drive_idx, seq)
            payload, oobs = self._role_payload(built, role)
            zone = info.zone_ids[drive_idx]
            self.drives[info.drive_ids[drive_idx]].zone_write(zone, off, payload, oobs)
            self.stats.device_blocks_written += c
            ost.meta[drive_idx, off - c : off] = oobs  # data-region index = off - C
        info.stripes_written += 1
        self.stats.stripes_committed += 1
        self._finish_stripe_bookkeeping(ost, built, {d: off for d in range(info.n_drives)})

    def _commit_group(self, ost: _OpenSegment) -> None:
        """Zone-Append group commit with globally shuffled completion order.

        On the batched datapath this builds the group, dispatches its fused
        encode asynchronously, commits the *previous* deferred group (whose
        encode has been running meanwhile), and -- when overlap is on and no
        sync point forces otherwise -- leaves the new group pending for the
        next commit/sync, i.e. double-buffering."""
        info = ost.info
        if not ost.group_buffer:
            return
        if not self.cfg.batched:
            self._commit_group_legacy(ost)
            return
        pend = self._pending_group
        pc = len(pend["seqs"]) if (pend is not None and pend["ost"] is ost) else 0
        seq0 = info.stripes_written + pc
        grp = self._build_group(ost, ost.group_buffer, seq0)
        ost.group_buffer = []
        end_of_segment = seq0 + len(grp["seqs"]) == info.n_stripes
        self._sync_pending()  # overlaps with grp's in-flight encode
        defer = (
            self.cfg.overlap
            and not end_of_segment
            and self.budget.remaining is None
            and self.append_plan_fn is None
            and self.commit_listener is None
        )
        if defer:
            self._pending_group = grp
        else:
            self._commit_built_group(grp)

    def _sync_pending(self) -> None:
        """Explicit sync point: commit the deferred (double-buffered) group."""
        if self._pending_group is not None:
            grp = self._pending_group
            self._pending_group = None
            self._commit_built_group(grp)

    def _commit_built_group(self, grp: dict) -> None:
        """Materialize the group's device parity and commit it to the drives.

        Normal path: one bulk Zone-Append run per drive (the per-drive issue
        subsequence of the shuffled completion order) plus fully vectorized
        CST/L2P/validity bookkeeping.  With a crash budget armed the scalar
        per-command loop is kept so power loss cuts at exact block
        granularity, like NAND."""
        ost = grp["ost"]
        info = ost.info
        m, c = info.m, info.chunk_blocks
        n = info.n_drives
        bb = self.zns_cfg.block_bytes
        scheme = self._scheme_for(info)
        codec = self._codec_for(info)
        narrow = len(info.drive_ids) < self.cfg.n_drives
        if narrow and self.obs_event is not None:
            self.obs_event("commit_narrow.begin", seg_id=info.seg_id,
                           width=info.n_drives)
        seqs = grp["seqs"]
        s_count = len(seqs)
        if scheme.mirror:
            parity_all = grp["data_all"]
        elif m:
            t0 = time.perf_counter() if self.encode_listener else 0.0
            parity_np = codec.materialize(grp["parity_dev"])
            if self.encode_listener is not None:
                self.encode_listener(
                    info, s_count, (time.perf_counter() - t0) * 1e6
                )
            parity_all = kops.unpack_bytes_np(parity_np)[:s_count].reshape(
                s_count, m, c, bb
            )
        else:
            parity_all = np.zeros((s_count, 0, c, bb), np.uint8)
        codeword = np.concatenate([grp["data_all"], parity_all], axis=1)
        oob_code = np.concatenate([grp["data_oob"], grp["par_oob"]], axis=1)
        rot = scheme.rotation_many(seqs)
        order = grp["order"]
        offsets = np.empty((s_count, n), dtype=np.int64)
        if self.budget.remaining is not None:
            crashed = None
            for oi in order:
                s_i, drive_idx = divmod(int(oi), n)
                role = int((drive_idx - rot[s_i]) % n)
                zone = info.zone_ids[drive_idx]
                try:
                    off = self.drives[info.drive_ids[drive_idx]].zone_append_commit(
                        zone, codeword[s_i, role], oob_code[s_i, role]
                    )
                except DeviceCrashed as e:
                    crashed = e
                    break
                offsets[s_i, drive_idx] = off
                self.stats.device_blocks_written += c
                ost.meta[drive_idx, off - c : off + 0] = oob_code[s_i, role]
            if crashed is not None:
                for raw in grp["raws"]:
                    raw.release()
                raise crashed
            for d in range(n):
                ost.cst.record_many(
                    d, (offsets[:, d] - info.data_start()) // c,
                    seqs % info.group_size,
                )
        else:
            # one vectorized checksum pass over the whole codeword -- the
            # payload arrays are uint8 views of the packed int32 arenas, so
            # this is the "CRC at commit time on the arenas" point; the
            # per-drive commits below just gather their slice of it
            crc_all = crc32c_many(codeword.reshape(-1, bb)).reshape(
                s_count, n, c
            )
            for d in range(n):
                mask = (order % n) == d
                s_list = order[mask] // n
                roles = (d - rot[s_list]) % n
                payload = codeword[s_list, roles]
                oobs = oob_code[s_list, roles]
                zone = info.zone_ids[d]
                offs = self.drives[info.drive_ids[d]].zone_append_commit_many(
                    zone, payload, oobs, crc_all[s_list, roles]
                )
                self.stats.device_blocks_written += payload.shape[0] * c
                base = int(offs[0]) - c
                ost.meta[d, base : base + offs.shape[0] * c] = oobs.reshape(-1)
                offsets[s_list, d] = offs
                ost.cst.record_many(
                    d, (offs - info.data_start()) // c,
                    seqs[s_list] % info.group_size,
                )
        info.stripes_written += s_count
        self.stats.stripes_committed += s_count
        self._finish_group_bookkeeping(ost, grp, offsets, codeword, parity_all)
        for raw in grp["raws"]:
            raw.release()
        if narrow and self.obs_event is not None:
            self.obs_event("commit_narrow.end", seg_id=info.seg_id)

    def _commit_group_legacy(self, ost: _OpenSegment) -> None:
        """Per-stripe build + per-command commit (``batched=False``)."""
        info = ost.info
        c = info.chunk_blocks
        scheme = self._scheme_for(info)
        narrow = len(info.drive_ids) < self.cfg.n_drives
        if narrow and self.obs_event is not None:
            self.obs_event("commit_narrow.begin", seg_id=info.seg_id,
                           width=info.n_drives)
        staged = [
            self._build_stripe(ost, raw, info.stripes_written + i)
            for i, raw in enumerate(ost.group_buffer)
        ]
        ops = []
        for s_i, built in enumerate(staged):
            for drive_idx in range(info.n_drives):
                ops.append((s_i, drive_idx))
        if self.append_plan_fn is not None:
            # timed mode: completion order falls out of the device model --
            # the fastest command of the batch wins the write pointer
            order = self.append_plan_fn(info, ops)
        else:
            order = self.rng.permutation(len(ops))
        offsets: dict[tuple[int, int], int] = {}
        crashed = None
        for oi in order:
            s_i, drive_idx = ops[oi]
            built = staged[s_i]
            role = scheme.drive_to_role(drive_idx, built["seq"])
            payload, oobs = self._role_payload(built, role)
            zone = info.zone_ids[drive_idx]
            try:
                off = self.drives[info.drive_ids[drive_idx]].zone_append_commit(
                    zone, payload, oobs
                )
            except DeviceCrashed as e:
                crashed = e
                break
            offsets[(s_i, drive_idx)] = off
            self.stats.device_blocks_written += c
            ost.meta[drive_idx, off - c : off + 0] = oobs
        if crashed is not None:
            for raw in ost.group_buffer:
                raw.release()
            ost.group_buffer = []
            raise crashed
        # all appends of the group persisted -> record CST, L2P, ack
        for s_i, built in enumerate(staged):
            per_drive_off = {d: offsets[(s_i, d)] for d in range(info.n_drives)}
            for drive_idx, off in per_drive_off.items():
                chunk_idx = (off - info.data_start()) // c
                ost.cst.record(drive_idx, chunk_idx, built["seq"] % info.group_size)
            info.stripes_written += 1
            self.stats.stripes_committed += 1
            self._finish_stripe_bookkeeping(ost, built, per_drive_off)
        for raw in ost.group_buffer:
            raw.release()
        ost.group_buffer = []
        if narrow and self.obs_event is not None:
            self.obs_event("commit_narrow.end", seg_id=info.seg_id)

    def _finish_stripe_bookkeeping(
        self, ost: _OpenSegment, built: dict, per_drive_off: dict[int, int]
    ) -> None:
        """Post-persist: update L2P / mapping table / validity, ack writes."""
        info = ost.info
        rec = self.segments[info.seg_id]
        k, c = info.k, info.chunk_blocks
        scheme = self._scheme_for(info)
        seq = built["seq"]
        for role in range(k):
            drive_idx = scheme.role_to_drive(role, seq)
            off = per_drive_off[drive_idx]
            for b in range(c):
                lba = int(built["lbas"][role, b])
                gid = int(built["meta_gids"][role, b])
                ts = int(built["ts"][role, b]) if "ts" in built else 0
                blk_off = off + b
                pba = pack_pba(info.seg_id, drive_idx, blk_off)
                didx = blk_off - info.data_start()
                if gid >= 0:  # mapping block
                    self._meta_unref(gid)
                    if ts < self._gid_ts.get(gid, 0):
                        continue  # a newer mapping block already committed
                    self._gid_ts[gid] = ts
                    old = self.mapping_table.get(gid, int(NO_PBA))
                    if old != int(NO_PBA):
                        self._invalidate(old)
                    self.mapping_table[gid] = pba
                    rec.valid[drive_idx, didx] = True
                    rec.valid_count += 1
                    if self.cache is not None:
                        # the committed bytes are what a future fault-in
                        # would read from media: keep the cache copy warm
                        self.cache.fill_one(
                            (gid << 1) | 1, built["data"][role, b], force=True
                        )
                elif lba >= 0:  # user block
                    if ts < int(self._lba_ts[lba]):
                        continue  # stale at birth: a newer write already won
                    self._lba_ts[lba] = ts
                    old = self.l2p.get(lba)
                    if old != int(NO_PBA):
                        self._invalidate(old)
                    self.l2p.set(lba, pba)
                    rec.valid[drive_idx, didx] = True
                    rec.valid_count += 1
                    if self.cache is not None:  # overwrite coherence point
                        self.cache.refresh_one(lba << 1, built["data"][role, b])
        if self.commit_listener is not None:
            self.commit_listener(info, built, per_drive_off)

    def _finish_group_bookkeeping(
        self,
        ost: _OpenSegment,
        grp: dict,
        offsets: np.ndarray,
        codeword: np.ndarray,
        parity_all: np.ndarray,
    ) -> None:
        """Vectorized ``_finish_stripe_bookkeeping`` for a whole group.

        User-block L2P/validity updates collapse into one ``get_many`` /
        ``set_many`` / fancy-index pass (user LBAs are unique within a group:
        duplicates were cancelled into padding at staging time).  Mapping
        blocks are rare and keep the ordered scalar body; so does the whole
        user loop when the L2P offloads, because CLOCK eviction decisions --
        and hence which mapping blocks hit the media -- depend on the exact
        per-block access order the scalar path defines."""
        info = ost.info
        rec = self.segments[info.seg_id]
        k, c = info.k, info.chunk_blocks
        n = info.n_drives
        seqs = grp["seqs"]
        s_count = len(seqs)
        rot = self._scheme_for(info).rotation_many(seqs)
        drive_of = (np.arange(k)[None, :] + rot[:, None]) % n          # (S, k)
        base_off = np.take_along_axis(offsets, drive_of, axis=1)       # (S, k)
        blk_off = base_off[:, :, None] + np.arange(c)[None, None, :]   # (S, k, c)
        drive_f = np.broadcast_to(drive_of[:, :, None], (s_count, k, c)).ravel()
        blk_f = blk_off.ravel()
        pba_f = pack_pba_many(info.seg_id, drive_f, blk_f)
        didx_f = blk_f - info.data_start()
        lba_f = grp["lbas_all"].ravel()
        ts_f = grp["ts_all"].ravel()
        gid_f = grp["gids_all"].ravel()
        if self.cache is not None:
            bb = self.zns_cfg.block_bytes
            data_f = grp["data_all"].reshape(-1, bb)  # aligns with lba_f/gid_f
        for i in np.flatnonzero(gid_f >= 0):  # mapping blocks
            gid, ts = int(gid_f[i]), int(ts_f[i])
            self._meta_unref(gid)
            if ts < self._gid_ts.get(gid, 0):
                continue  # a newer mapping block already committed
            self._gid_ts[gid] = ts
            old = self.mapping_table.get(gid, int(NO_PBA))
            if old != int(NO_PBA):
                self._invalidate(old)
            self.mapping_table[gid] = int(pba_f[i])
            rec.valid[drive_f[i], didx_f[i]] = True
            rec.valid_count += 1
            if self.cache is not None:
                self.cache.fill_one((gid << 1) | 1, data_f[i], force=True)
        user_idx = np.flatnonzero(lba_f >= 0)
        if self.l2p.offload:
            for i in user_idx:
                lba, ts = int(lba_f[i]), int(ts_f[i])
                if ts < int(self._lba_ts[lba]):
                    continue  # stale at birth: a newer write already won
                self._lba_ts[lba] = ts
                old = self.l2p.get(lba)
                if old != int(NO_PBA):
                    self._invalidate(old)
                self.l2p.set(lba, int(pba_f[i]))
                rec.valid[drive_f[i], didx_f[i]] = True
                rec.valid_count += 1
                if self.cache is not None:  # overwrite coherence point
                    self.cache.refresh_one(lba << 1, data_f[i])
        elif user_idx.size:
            lba_u = lba_f[user_idx]
            ok = ts_f[user_idx].astype(np.uint64) >= self._lba_ts[lba_u]
            ui = user_idx[ok]
            lba_u = lba_u[ok]
            self._lba_ts[lba_u] = ts_f[ui]
            old = self.l2p.get_many(lba_u)
            self._invalidate_many(old)
            self.l2p.set_many(lba_u, pba_f[ui])
            rec.valid[drive_f[ui], didx_f[ui]] = True
            rec.valid_count += int(ui.size)
            if self.cache is not None and ui.size:  # overwrite coherence point
                self.cache.refresh_many(lba_u << 1, data_f[ui])
        if self.commit_listener is not None:
            for s_i in range(s_count):
                built = {
                    "seq": int(seqs[s_i]),
                    "data": codeword[s_i, :k],
                    "parity": parity_all[s_i],
                    "data_oob": grp["data_oob"][s_i],
                    "par_oob": grp["par_oob"][s_i],
                    "lbas": grp["lbas_all"][s_i],
                    "ts": grp["ts_all"][s_i],
                    "meta_gids": grp["gids_all"][s_i],
                }
                per_drive_off = {d: int(offsets[s_i, d]) for d in range(n)}
                self.commit_listener(info, built, per_drive_off)

    def _invalidate_many(self, pbas: np.ndarray) -> None:
        """Vectorized ``_invalidate`` (old copies superseded by a group)."""
        pbas = pbas[pbas != int(NO_PBA)]
        if pbas.size == 0:
            return
        segs, drvs, offs = unpack_pba_many(pbas)
        for seg_id in np.unique(segs):
            rec = self.segments.get(int(seg_id))
            if rec is None:
                continue
            sel = segs == seg_id
            didx = offs[sel] - rec.info.data_start()
            d = drvs[sel]
            inb = (didx >= 0) & (didx < rec.valid.shape[1])
            d, didx = d[inb], didx[inb]
            cur = rec.valid[d, didx]
            rec.valid[d, didx] = False
            rec.valid_count -= int(cur.sum())

    def _invalidate(self, pba: int) -> None:
        seg_id, drive, off = unpack_pba(pba)
        rec = self.segments.get(seg_id)
        if rec is None:
            return
        didx = off - rec.info.data_start()
        if 0 <= didx < rec.valid.shape[1] and rec.valid[drive, didx]:
            rec.valid[drive, didx] = False
            rec.valid_count -= 1

    # -- sealing -----------------------------------------------------------------

    def _maybe_seal(self, ost: _OpenSegment) -> None:
        info = ost.info
        if info.stripes_written + self._pending_count(ost) < info.n_stripes:
            return
        if ost.group_buffer:
            self._commit_group(ost)
        self._sync_pending()  # the tail group must land before the footer
        self._seal_segment(ost)

    def _seal_segment(self, ost: _OpenSegment) -> None:
        """Write footer regions (per-zone own metadata) and finish zones.

        Footer serialization is deterministic, so a partially-written footer
        (crash mid-seal) is resumed from the zone's write pointer: the
        already-persisted prefix is identical by construction (§3.4).
        """
        info = ost.info
        footer_start = info.data_start() + info.n_stripes * info.chunk_blocks
        for drive_idx in range(info.n_drives):
            drive = self.drives[info.drive_ids[drive_idx]]
            zone = info.zone_ids[drive_idx]
            foot = pack_footer(ost.meta[drive_idx], self.zns_cfg.block_bytes)
            wp = int(drive.wp[zone])
            skip = wp - footer_start
            assert 0 <= skip <= foot.shape[0], (wp, footer_start, foot.shape)
            if skip < foot.shape[0]:
                rest = foot[skip:]
                oobs = np.zeros(rest.shape[0], dtype=OOB_DTYPE)
                oobs["lba"] = INVALID_LBA
                drive.zone_write(zone, wp, rest, oobs)
                self.stats.device_blocks_written += rest.shape[0]
            drive.finish_zone(zone)
        info.state = int(SegmentState.SEALED)
        del self.open_segments[info.seg_id]
        # replace the open-segment slot with a fresh segment of the same class
        if info.seg_id in self.small_ids:
            i = self.small_ids.index(info.seg_id)
            self.small_ids[i] = self._open_segment(
                SegmentClass(info.seg_class), info.chunk_blocks, info.group_size
            )
        elif info.seg_id in self.large_ids:
            i = self.large_ids.index(info.seg_id)
            self.large_ids[i] = self._open_segment(
                SegmentClass(info.seg_class), info.chunk_blocks, info.group_size
            )

    # ------------------------------------------------------------------ reads

    def read(self, lba: int, n_blocks: int = 1) -> np.ndarray:
        self._sync_pending()  # read-your-writes: deferred group must land
        self.stats.reads += n_blocks
        # single-block reads keep the scalar path: the gather/group machinery
        # costs more than it saves below ~2 blocks (random-read hot path)
        if not self.cfg.batched or n_blocks == 1:
            out = np.zeros((n_blocks, self.zns_cfg.block_bytes), dtype=np.uint8)
            for i in range(n_blocks):
                out[i] = self._read_block(lba + i)
            return out
        return self._read_blocks(np.arange(lba, lba + n_blocks, dtype=np.int64))

    def _read_blocks(self, lbas: np.ndarray) -> np.ndarray:
        """Vectorized multi-block read: one L2P gather, then one numpy gather
        per (segment, drive) the blocks land on; blocks on failed drives are
        collected and reconstructed in one fused decode per surviving-role
        set (the batched degraded-read path).

        With a cache tier attached this is a read-through layer: one batched
        ``lookup_many`` filters the hits (served at cache-device latency),
        only the misses touch the L2P and the drives, and every mapped miss
        -- including reconstructed degraded blocks -- is offered back for
        admission."""
        out = np.zeros((lbas.shape[0], self.zns_cfg.block_bytes), dtype=np.uint8)
        idx = np.arange(lbas.shape[0], dtype=np.int64)
        if self.cache is not None:
            hit, rows = self.cache.lookup_many(lbas << 1)
            n_hit = rows.shape[0]
            if n_hit:
                out[idx[hit]] = rows
                self.stats.cache_hits += n_hit
            self.stats.cache_misses += int(lbas.size) - n_hit
            idx = idx[~hit]
            if idx.size == 0:
                return out
            lbas = lbas[idx]
        pbas = self.l2p.get_many(lbas)
        mapped = idx[pbas != int(NO_PBA)]
        if mapped.size == 0:
            return out
        verify = self.cfg.verify_reads
        segs, drives, offs = unpack_pba_many(pbas[pbas != int(NO_PBA)])
        # faulted: (seg, member, out idxs, zone offs, repairable) -- the last
        # flag is True for media faults on a live drive (checksum mismatch /
        # UNC), where the reconstructed bytes are rewritten in place
        faulted: list[tuple[int, int, np.ndarray, np.ndarray, bool]] = []
        for key in {(int(s), int(d)) for s, d in zip(segs, drives)}:
            seg_id, drive_idx = key  # drive_idx is the segment-member index
            sel = (segs == seg_id) & (drives == drive_idx)
            idxs = mapped[sel]
            s_info = self.segments[seg_id].info
            zone = s_info.zone_ids[drive_idx]
            if (seg_id, drive_idx) in self._rebuild_pending:
                faulted.append((seg_id, drive_idx, idxs, offs[sel], False))
                continue
            drive = self.drives[s_info.drive_ids[drive_idx]]
            try:
                got = drive.read_blocks(zone, offs[sel])
            except DriveFailed:
                faulted.append((seg_id, drive_idx, idxs, offs[sel], False))
                continue
            if verify:
                ok = self._verify_media(drive, zone, offs[sel], got)
                if not ok.all():
                    bad = ~ok
                    faulted.append(
                        (seg_id, drive_idx, idxs[bad], offs[sel][bad], True)
                    )
                    out[idxs[ok]] = got[ok]
                    continue
            out[idxs] = got
        for seg_id, drive_idx, idxs, f_offs, repair in faulted:
            rec = self.segments[seg_id]
            info = rec.info
            c = info.chunk_blocks
            didx = f_offs - info.data_start()
            chunk_idxs, inv = np.unique(didx // c, return_inverse=True)
            chunks, _ = self._reconstruct_chunks(
                rec, drive_idx, chunk_idxs, verify=verify
            )
            out[idxs] = chunks[inv, didx % c]
            self.stats.degraded_reads += int(idxs.size)
            if repair:
                self._repair_in_place(rec, drive_idx, f_offs, out[idxs])
        if self.cache is not None:
            # Offer every mapped miss (reconstructed blocks included) for
            # admission: a warm cache absorbs reconstruction traffic.
            self.cache.fill_many(lbas[pbas != int(NO_PBA)] << 1, out[mapped])
        return out

    def _read_block(self, lba: int) -> np.ndarray:
        if self.cache is not None:
            row = self.cache.lookup_one(lba << 1)
            if row is not None:
                self.stats.cache_hits += 1
                return row.copy()
            self.stats.cache_misses += 1
        pba = self.l2p.get(lba)
        if pba == int(NO_PBA):
            return np.zeros(self.zns_cfg.block_bytes, dtype=np.uint8)
        out = self._read_pba(pba)
        if self.cache is not None:
            self.cache.fill_one(lba << 1, out)
        return out

    def _read_pba(self, pba: int) -> np.ndarray:
        seg_id, drive_idx, off = unpack_pba(pba)  # drive_idx = member index
        if (seg_id, drive_idx) in self._rebuild_pending:
            return self._degraded_read(seg_id, drive_idx, off)
        info = self.segments[seg_id].info
        try:
            drive = self.drives[info.drive_ids[drive_idx]]
            out = drive.read(info.zone_ids[drive_idx], off, 1)[0].copy()
        except DriveFailed:
            return self._degraded_read(seg_id, drive_idx, off)
        if self.cfg.verify_reads:
            offs = np.array([off], dtype=np.int64)
            zone = info.zone_ids[drive_idx]
            if not self._verify_media(drive, zone, offs, out[None, :]).all():
                rec = self.segments[seg_id]
                out = self._degraded_read(seg_id, drive_idx, off)
                self._repair_in_place(rec, drive_idx, offs, out[None, :])
        return out

    # -- integrity: verify / repair (PR 10) -----------------------------------

    def _verify_media(
        self, drive, zone: int, offs: np.ndarray, blocks: np.ndarray
    ) -> np.ndarray:
        """Per-block verdict for a gather: checksum matches and readable.

        Bumps detection counters for every failing block; callers route the
        failures into reconstruction."""
        ok = crc32c_many(blocks) == drive.crc_blocks(zone, offs)
        unc = drive.unc_blocks(zone, offs)
        ok &= ~unc
        n_bad = int((~ok).sum())
        if n_bad:
            self.stats.integrity_corruptions_detected += n_bad
            self.stats.integrity_unreadable_hits += int(unc.sum())
        return ok

    def _repair_in_place(
        self,
        rec: _SegmentRecord,
        member: int,
        offs: np.ndarray,
        blocks: np.ndarray,
        *,
        refresh_cache: bool = True,
    ) -> None:
        """Rewrite reconstructed bytes over corrupt media (no log relocation
        -- L2P and CST are untouched) and re-sync any cache-resident copy.

        ``refresh_cache`` must be False for parity-role blocks: their OOB
        lba field is parity-encoded metadata, not a cache key."""
        info = rec.info
        drive = self.drives[info.drive_ids[member]]
        zone = info.zone_ids[member]
        offs = np.asarray(offs, dtype=np.int64)
        blocks = np.asarray(blocks, dtype=np.uint8).reshape(offs.size, -1)
        drive.repair_blocks(zone, offs, blocks)
        self.stats.integrity_blocks_repaired += int(offs.size)
        if self.obs_event is not None:
            self.obs_event("integrity.repair", seg_id=info.seg_id,
                           member=member, n_blocks=int(offs.size))
        if refresh_cache and self.cache is not None:
            # The OOB lba field *is* the cache key encoding (lba<<1 user,
            # (gid<<1)|1 mapping) for data-role blocks, so a repair can
            # refresh resident copies directly -- a warm cache must never
            # keep serving pre-repair bytes.
            keys = drive.oob[zone, offs]["lba"]
            live = (keys != INVALID_LBA) & (
                keys < np.uint64(2 * self.cfg.logical_blocks)
            )
            if live.any():
                self.cache.refresh_many(keys[live].astype(np.int64),
                                        blocks[live])

    # -- degraded read (§3.5) -------------------------------------------------

    def _degraded_read(self, seg_id: int, failed_drive: int, off: int) -> np.ndarray:
        self.stats.degraded_reads += 1
        rec = self.segments[seg_id]
        info = rec.info
        c = info.chunk_blocks
        didx = off - info.data_start()
        chunk_idx = didx // c
        blk_in_chunk = didx % c
        if self.cfg.verify_reads:
            chunk, _ = self._reconstruct_chunk_checked(rec, failed_drive, chunk_idx)
        else:
            chunk = self._reconstruct_chunk(rec, failed_drive, chunk_idx)
        return chunk[blk_in_chunk]

    def _reconstruct_chunk(
        self, rec: _SegmentRecord, failed_drive: int, chunk_idx: int
    ) -> np.ndarray:
        """Decode the chunk at (failed member, chunk_idx) from survivors."""
        info = rec.info
        c = info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        scheme = self._scheme_for(info)
        codec = self._codec_for(info)
        seq, member_chunks = self._chunk_members(rec, failed_drive, chunk_idx)
        lost_role = scheme.drive_to_role(failed_drive, seq)
        if scheme.mirror:
            # read the surviving twin copy directly
            twin = (lost_role + scheme.k) % (2 * scheme.k)
            for d, cidx in member_chunks.items():
                if scheme.drive_to_role(d, seq) == twin:
                    zone = info.zone_ids[d]
                    return self.drives[info.drive_ids[d]].read(
                        zone, info.data_start() + cidx * c, c
                    ).copy()
            raise RuntimeError("mirror copy also lost")
        rows, roles = [], []
        for d, cidx in member_chunks.items():
            if len(rows) == scheme.k:
                break
            zone = info.zone_ids[d]
            off0 = info.data_start() + cidx * c
            rows.append(
                self.drives[info.drive_ids[d]].read(zone, off0, c).reshape(c * bb)
            )
            roles.append(scheme.drive_to_role(d, seq))
        if len(rows) < scheme.k:
            raise RuntimeError("not enough surviving chunks to decode")
        data = codec.decode_np(np.stack(rows), tuple(roles)).reshape(
            scheme.k, c, bb
        )
        if lost_role < scheme.k:
            return data[lost_role]
        # lost chunk was parity: re-encode
        par = codec.encode_np(data.reshape(scheme.k, c * bb))
        return par.reshape(scheme.m, c, bb)[lost_role - scheme.k]

    def _reconstruct_chunk_checked(
        self, rec: _SegmentRecord, failed_member: int, chunk_idx: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Verified scalar reconstruction of one lost/corrupt chunk.

        Survivor candidates whose media fails verification are skipped in
        favor of alternates (raid6 tolerates one more loss, mirrors fall to
        the twin); when fewer than ``k`` intact chunks remain the stripe is
        unrepairable and a loud :class:`IntegrityError` surfaces instead of
        garbage bytes.  Returns ``(chunk (c, bb), oobs (c,))``."""
        info = rec.info
        c = info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        scheme = self._scheme_for(info)
        codec = self._codec_for(info)
        seq, members = self._chunk_members(rec, failed_member, chunk_idx)
        lost_role = scheme.drive_to_role(failed_member, seq)
        oobs = np.zeros(c, dtype=OOB_DTYPE)
        oobs["lba"] = INVALID_LBA
        oobs["stripe"] = seq
        if scheme.mirror:
            twin = (lost_role + scheme.k) % (2 * scheme.k)
            for d, cidx in members.items():
                if scheme.drive_to_role(d, seq) != twin:
                    continue
                drive = self.drives[info.drive_ids[d]]
                zone = info.zone_ids[d]
                offs = info.data_start() + cidx * c + np.arange(c)
                blocks = drive.read_blocks(zone, offs)
                if self._verify_media(drive, zone, offs, blocks).all():
                    return blocks.copy(), drive.read_oob_blocks(zone, offs).copy()
            raise IntegrityError(
                f"segment {info.seg_id} stripe {seq}: mirror copy of member "
                f"{failed_member} also lost or corrupt"
            )
        rows, roles, lba_rows, ts_rows = [], [], [], []
        for d, cidx in members.items():
            if len(rows) == scheme.k:
                break
            drive = self.drives[info.drive_ids[d]]
            zone = info.zone_ids[d]
            offs = info.data_start() + cidx * c + np.arange(c)
            blocks = drive.read_blocks(zone, offs)
            if not self._verify_media(drive, zone, offs, blocks).all():
                continue  # corrupt survivor: try an alternate member
            roob = drive.read_oob_blocks(zone, offs)
            rows.append(blocks.reshape(c * bb))
            lba_rows.append(roob["lba"])
            ts_rows.append(roob["ts"])
            roles.append(scheme.drive_to_role(d, seq))
        if len(rows) < scheme.k:
            raise IntegrityError(
                f"segment {info.seg_id} stripe {seq}: only {len(rows)} intact "
                f"chunk(s) of the {scheme.k} needed to reconstruct member "
                f"{failed_member} -- unrepairable double fault"
            )
        data = codec.decode_np(np.stack(rows), tuple(roles)).reshape(
            scheme.k, c, bb
        )
        d_lba, d_ts = decode_meta(
            codec, np.stack(lba_rows), np.stack(ts_rows), tuple(roles)
        )
        if lost_role < scheme.k:
            oobs["lba"] = d_lba[lost_role]
            oobs["ts"] = d_ts[lost_role]
            return data[lost_role].copy(), oobs
        par = codec.encode_np(data.reshape(scheme.k, c * bb)).reshape(
            scheme.m, c, bb
        )
        p_lba, p_ts = parity_oob(codec, d_lba, d_ts)
        oobs["lba"] = p_lba[lost_role - scheme.k]
        oobs["ts"] = p_ts[lost_role - scheme.k]
        return par[lost_role - scheme.k].copy(), oobs

    # -- batched reconstruction (rebuild datapath) ----------------------------

    def _chunk_members(
        self, rec: _SegmentRecord, failed_drive: int, chunk_idx: int
    ) -> tuple[int, dict[int, int]]:
        """(stripe seq, {surviving member -> chunk idx}) for one lost chunk."""
        info = rec.info
        if info.uses_append:
            cst = rec.cst
            assert cst is not None, "CST missing for append segment"
            sid = cst.stripe_id_at(failed_drive, chunk_idx)
            group_idx = chunk_idx // info.group_size
            seq = group_idx * info.group_size + sid
            members = {}
            for d in range(info.n_drives):
                if (
                    d == failed_drive
                    or self.drives[info.drive_ids[d]].failed
                    or (info.seg_id, d) in self._rebuild_pending
                ):
                    continue
                hit = cst.find_in_group(d, group_idx, sid)
                if hit is not None:
                    members[d] = hit
            self.stats.cst_entries_accessed = cst.entries_accessed
        else:
            seq = chunk_idx
            members = {
                d: chunk_idx
                for d in range(info.n_drives)
                if d != failed_drive
                and not self.drives[info.drive_ids[d]].failed
                and (info.seg_id, d) not in self._rebuild_pending
            }
        return seq, members

    def _reconstruct_chunks(
        self,
        rec: _SegmentRecord,
        failed_drive: int,
        chunk_idxs: np.ndarray,
        verify: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ``_reconstruct_chunk`` + ``_reconstruct_oob`` over a zone.

        Survivor payloads and OOB rows are gathered with one scatter-read per
        surviving drive, then decoded in one fused call per distinct
        surviving-role set (parity rotation yields at most ``n`` such sets).
        With ``verify`` the survivor gathers are checksum-checked in bulk;
        chunks whose picked survivors fail fall back to the verified scalar
        path (:meth:`_reconstruct_chunk_checked`), which tries alternate
        members and raises :class:`IntegrityError` when the stripe is
        unrepairable.  Returns ``(chunks (N, c, bb), oobs (N, c))``.
        """
        if self.obs_event is not None:
            self.obs_event("degraded.begin", seg_id=rec.info.seg_id,
                           n_chunks=len(chunk_idxs),
                           failed_drive=failed_drive)
        try:
            return self._reconstruct_chunks_obs(
                rec, failed_drive, chunk_idxs, verify
            )
        finally:
            if self.obs_event is not None:
                self.obs_event("degraded.end", seg_id=rec.info.seg_id)

    def _reconstruct_chunks_obs(self, rec, failed_drive, chunk_idxs,
                                verify=False):
        """Body of ``_reconstruct_chunks`` (split so the obs hook can
        bracket the survivor gathers + fused decode with begin/end)."""
        info = rec.info
        scheme = self._scheme_for(info)
        codec = self._codec_for(info)
        k, m, c = scheme.k, scheme.m, info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        n = len(chunk_idxs)
        out = np.zeros((n, c, bb), np.uint8)
        oobs = np.zeros((n, c), dtype=OOB_DTYPE)
        oobs["lba"] = INVALID_LBA
        seqs = np.empty(n, dtype=np.int64)
        chosen: list[list[tuple[int, int]]] = []  # per chunk: [(member, cidx)] * k
        roles_of: list[tuple[int, ...]] = []
        lost_roles = np.empty(n, dtype=np.int64)
        twin_src: list[tuple[int, int]] = []  # mirror: (member, cidx) of the twin
        for pos, chunk_idx in enumerate(int(ci) for ci in chunk_idxs):
            seq, members = self._chunk_members(rec, failed_drive, chunk_idx)
            seqs[pos] = seq
            lost_role = scheme.drive_to_role(failed_drive, seq)
            lost_roles[pos] = lost_role
            if scheme.mirror:
                twin = (lost_role + scheme.k) % (2 * scheme.k)
                src = next(
                    (
                        (d, cidx) for d, cidx in members.items()
                        if scheme.drive_to_role(d, seq) == twin
                    ),
                    None,
                )
                if src is None:
                    raise RuntimeError("mirror copy also lost")
                twin_src.append(src)
                chosen.append([])
                roles_of.append(())
                continue
            picks = list(members.items())[: scheme.k]
            if len(picks) < scheme.k:
                raise RuntimeError("not enough surviving chunks to decode")
            chosen.append(picks)
            roles_of.append(
                tuple(scheme.drive_to_role(d, seq) for d, _ in picks)
            )
        oobs["stripe"] = seqs[:, None]
        # positions whose bulk-gathered survivors failed verification fall
        # back to the verified scalar path (alternate members / loud error)
        bad_positions: set[int] = set()
        if scheme.mirror:
            # one gather per twin drive for payload and OOB alike
            by_drive: dict[int, list[int]] = {}
            for pos, (d, _) in enumerate(twin_src):
                by_drive.setdefault(d, []).append(pos)
            for d, poss in by_drive.items():
                drive = self.drives[info.drive_ids[d]]
                zone = info.zone_ids[d]
                offs = np.concatenate([
                    info.data_start() + twin_src[p][1] * c + np.arange(c)
                    for p in poss
                ])
                raw = drive.read_blocks(zone, offs)
                out[poss] = raw.reshape(-1, c, bb)
                oobs[poss] = drive.read_oob_blocks(zone, offs).reshape(-1, c)
                if verify:
                    okc = self._verify_media(drive, zone, offs, raw) \
                        .reshape(-1, c).all(axis=1)
                    bad_positions.update(
                        p for p, good in zip(poss, okc) if not good
                    )
            for pos in sorted(bad_positions):
                out[pos], oobs[pos] = self._reconstruct_chunk_checked(
                    rec, failed_drive, int(chunk_idxs[pos])
                )
            return out, oobs
        # gather survivor payload + metadata rows, one scatter-read per drive
        rows = np.empty((n, k, c * bb), np.uint8)
        rows_lba = np.empty((n, k, c), np.uint64)
        rows_ts = np.empty((n, k, c), np.uint64)
        by_drive2: dict[int, list[tuple[int, int, int]]] = {}  # d -> (pos, row, cidx)
        for pos, picks in enumerate(chosen):
            for row, (d, cidx) in enumerate(picks):
                by_drive2.setdefault(d, []).append((pos, row, cidx))
        for d, entries in by_drive2.items():
            drive = self.drives[info.drive_ids[d]]
            zone = info.zone_ids[d]
            offs = np.concatenate([
                info.data_start() + cidx * c + np.arange(c)
                for _, _, cidx in entries
            ])
            raw = drive.read_blocks(zone, offs)
            blocks = raw.reshape(-1, c * bb)
            roobs = drive.read_oob_blocks(zone, offs).reshape(-1, c)
            okc = None
            if verify:
                okc = self._verify_media(drive, zone, offs, raw) \
                    .reshape(-1, c).all(axis=1)
            for e, (pos, row, _) in enumerate(entries):
                if okc is not None and not okc[e]:
                    bad_positions.add(pos)
                rows[pos, row] = blocks[e]
                rows_lba[pos, row] = roobs[e]["lba"]
                rows_ts[pos, row] = roobs[e]["ts"]
        # one fused decode per distinct surviving-role set
        role_sets = sorted({
            r for p, r in enumerate(roles_of) if p not in bad_positions
        })
        for roles in role_sets:
            poss = np.array([
                p for p, r in enumerate(roles_of)
                if r == roles and p not in bad_positions
            ])
            data = codec.decode_batch_np(rows[poss], roles).reshape(
                len(poss), k, c, bb
            )
            d_lba, d_ts = decode_meta_batch(
                codec, rows_lba[poss], rows_ts[poss], roles
            )
            lost = lost_roles[poss]
            for data_role in np.unique(lost[lost < k]):
                sel = poss[lost == data_role]
                out[sel] = data[lost == data_role, int(data_role)]
                oobs["lba"][sel] = d_lba[lost == data_role, int(data_role)]
                oobs["ts"][sel] = d_ts[lost == data_role, int(data_role)]
            par_sel = lost >= k
            if np.any(par_sel):
                par = codec.encode_batch_np(
                    data[par_sel].reshape(-1, k, c * bb)
                ).reshape(-1, m, c, bb)
                p_lba, p_ts = parity_oob_batch(
                    codec, d_lba[par_sel], d_ts[par_sel]
                )
                for e, pos in enumerate(poss[par_sel]):
                    role = int(lost_roles[pos]) - k
                    out[pos] = par[e, role]
                    oobs["lba"][pos] = p_lba[e, role]
                    oobs["ts"][pos] = p_ts[e, role]
        for pos in sorted(bad_positions):
            out[pos], oobs[pos] = self._reconstruct_chunk_checked(
                rec, failed_drive, int(chunk_idxs[pos])
            )
        return out, oobs

    # ------------------------------------------------------- L2P offload plumbing

    def _queue_mapping_block(self, gid: int, entries: np.ndarray) -> None:
        # Staged until the mapping block is durably committed: fault-ins of
        # this group must see the staged entries, not the stale on-SSD block.
        self._meta_staging[gid] = entries.copy()
        self._pending_meta.append(gid)
        self._meta_refs[gid] = self._meta_refs.get(gid, 0) + 1

    def _meta_unref(self, gid: int) -> None:
        """One queued image of ``gid`` became durable; drop the host-side
        staging copy once no in-flight image remains."""
        refs = self._meta_refs.get(gid, 0) - 1
        if refs > 0:
            self._meta_refs[gid] = refs
        elif refs == 0:
            del self._meta_refs[gid]
            self._meta_staging.pop(gid, None)  # durable now
        # refs < 0: a GC-restaged copy of an already-durable block -- no
        # staging existed for it, nothing to do.

    def _drain_meta(self) -> None:
        while self._pending_meta:
            gid = self._pending_meta.pop(0)
            if self.l2p.offload and gid in self.l2p.resident:
                # the group was faulted back in after eviction: the resident
                # copy is the freshest image -- serialize that one, and clear
                # its dirty bit (the on-SSD block is now current).
                entries = self.l2p.resident[gid].copy()
                self.l2p.dirty.discard(gid)
                self._meta_staging[gid] = entries
            else:
                entries = self._meta_staging.get(gid)
            if entries is None:
                # superseded (faulted back in and re-evicted): release the
                # pending entry's ref without writing anything
                self._meta_unref(gid)
                continue
            block = self._serialize_mapping(entries)
            ts = self._now()
            # _append_block takes the in-stripe ref before we release the
            # pending one, so refs never dip to zero across the handoff
            self._append_block(self._classify(1), -1, block, ts, meta_gid=gid)
            self._meta_unref(gid)
            self.stats.meta_blocks_written += 1

    def _serialize_mapping(self, entries: np.ndarray) -> np.ndarray:
        """Pack int64 PBAs into 32-bit on-disk entries (seg<<20|drive<<16|off)."""
        out = np.full(self.zns_cfg.block_bytes // 4, 0xFFFFFFFF, dtype=np.uint32)
        for i, pba in enumerate(entries):
            pba = int(pba)
            if pba == int(NO_PBA):
                continue
            seg, drive, off = unpack_pba(pba)
            assert seg < (1 << 12) and drive < 16 and off < (1 << 16), (
                "array too large for 32-bit mapping entries"
            )
            out[i] = (seg << 20) | (drive << 16) | off
        return out.view(np.uint8)

    def _deserialize_mapping(self, block: np.ndarray) -> np.ndarray:
        raw = block.view(np.uint32)
        out = np.full(raw.shape[0], NO_PBA, dtype=np.int64)
        live = raw != 0xFFFFFFFF
        seg = (raw[live] >> 20).astype(np.int64)
        drive = ((raw[live] >> 16) & 0xF).astype(np.int64)
        off = (raw[live] & 0xFFFF).astype(np.int64)
        out[live] = (seg << 40) | (drive << 32) | off
        return out

    def _read_mapping_block(self, gid: int) -> Optional[np.ndarray]:
        staged = self._meta_staging.get(gid)
        if staged is not None:
            return staged.copy()  # evicted but not yet durable
        pba = self.mapping_table.get(gid)
        if pba is None:
            return None
        if self.cache is not None:
            # Mapping-table cache: fault-ins beyond the CLOCK resident
            # budget are served from the cache tier instead of media.
            row = self.cache.lookup_one((gid << 1) | 1)
            if row is not None:
                self.stats.l2p_cache_hits += 1
                return self._deserialize_mapping(row)
            self.stats.l2p_cache_misses += 1
        block = self._read_pba(pba)
        if self.cache is not None:
            self.cache.fill_one((gid << 1) | 1, block, force=True)
        return self._deserialize_mapping(block)

    # -------------------------------------------------------------------- GC

    def maybe_gc(self) -> None:
        while self.free_segment_count() < self.cfg.gc_free_segments_low:
            before = self.free_segment_count()
            if not self.gc_once():
                break
            if self.free_segment_count() <= before:
                # a pass that nets no free segment cannot converge on the
                # watermark (everything live, restage consumes what the
                # victim frees) -- stop instead of collecting in a loop
                break

    def _gc_select_victim(self) -> Optional[_SegmentRecord]:
        """Greedy cost-benefit victim scoring (§4), vectorized across all
        sealed segments: ``score = (1 - u) / (1 + u) * age`` with ``u`` the
        valid fraction -- the classic LFS cost-benefit policy instead of a
        plain min-valid scan.  Shared by the scalar and batched datapaths so
        both collect the same victim sequence (bit-identity)."""
        recs = [
            r for r in self.segments.values()
            if r.info.state == int(SegmentState.SEALED)
        ]
        if not recs:
            return None
        n = len(recs)
        valid = np.fromiter((r.valid_count for r in recs), np.float64, n)
        cap = np.fromiter((r.data_capacity() for r in recs), np.float64, n)
        u = valid / np.maximum(cap, 1.0)
        age = np.maximum(
            self.ts_counter
            - np.fromiter((r.info.create_ts for r in recs), np.float64, n),
            1.0,
        )
        score = np.where(u < 1.0, (1.0 - u) / (1.0 + u) * age, -np.inf)
        best = int(np.argmax(score))
        if not np.isfinite(score[best]):
            return None  # every sealed segment is fully live
        return recs[best]

    def _gc_collect_batched(
        self, rec: _SegmentRecord
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Gather the victim's live blocks: one payload gather + one OOB
        gather per drive, liveness split with numpy masks (no per-block
        loops, no ``(lba, block)`` tuple lists).  A failed drive routes
        through the fused whole-chunk reconstruction instead of per-block
        degraded reads.  Returns ``(user_lbas, user_blocks, meta_gids,
        meta_blocks)`` in scalar collection order (drive-major, ascending
        data index)."""
        info = rec.info
        c = info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        lba_parts: list[np.ndarray] = []
        blk_parts: list[np.ndarray] = []
        for drive_idx in range(info.n_drives):
            didxs = np.flatnonzero(rec.valid[drive_idx])
            if didxs.size == 0:
                continue
            drive = self.drives[info.drive_ids[drive_idx]]
            zone = info.zone_ids[drive_idx]
            if (
                drive.failed
                or (info.seg_id, drive_idx) in self._rebuild_pending
            ):
                chunk_idxs, inv = np.unique(didxs // c, return_inverse=True)
                chunks, oob_all = self._reconstruct_chunks(rec, drive_idx, chunk_idxs)
                blocks = chunks[inv, didxs % c]
                lba_parts.append(oob_all["lba"][inv, didxs % c].astype(np.uint64))
                self.stats.degraded_reads += int(didxs.size)
            else:
                offs = info.data_start() + didxs
                # read_blocks gathers via advanced indexing: already a fresh
                # array, no defensive copy needed
                blocks = drive.read_blocks(zone, offs)
                oob_arr = drive.read_oob_blocks(zone, offs)
                lba_parts.append(oob_arr["lba"].astype(np.uint64))
            blk_parts.append(blocks)
        if not lba_parts:
            empty = np.zeros(0, np.int64)
            none = np.zeros((0, bb), np.uint8)
            return empty, none, empty, none
        lba_fields = np.concatenate(lba_parts)
        blocks = blk_parts[0] if len(blk_parts) == 1 else np.concatenate(blk_parts)
        live = lba_fields != INVALID_LBA
        is_meta = ((lba_fields & np.uint64(1)) != 0) & live
        user = live & ~is_meta
        keys = (lba_fields >> np.uint64(1)).astype(np.int64)
        return keys[user], blocks[user], keys[is_meta], blocks[is_meta]

    def _gc_collect_scalar(
        self, rec: _SegmentRecord
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-block collection baseline (``batched=False``): one read + OOB
        read per live block, per-block degraded reads on a failed drive."""
        info = rec.info
        c = info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        u_lbas: list[int] = []
        u_blocks: list[np.ndarray] = []
        m_gids: list[int] = []
        m_blocks: list[np.ndarray] = []
        for drive_idx in range(info.n_drives):
            drive = self.drives[info.drive_ids[drive_idx]]
            zone = info.zone_ids[drive_idx]
            pending = (info.seg_id, drive_idx) in self._rebuild_pending
            for didx in np.flatnonzero(rec.valid[drive_idx]):
                off = info.data_start() + int(didx)
                try:
                    if pending:
                        raise DriveFailed("zone awaiting paced rebuild")
                    block = drive.read(zone, off, 1)[0].copy()
                    oob = drive.read_oob(zone, off, 1)[0]
                except DriveFailed:
                    block = self._degraded_read(info.seg_id, drive_idx, off)
                    oob = self._reconstruct_oob(rec, drive_idx, int(didx) // c)[
                        int(didx) % c
                    ]
                lba_field = int(oob["lba"])
                if lba_field == int(INVALID_LBA):
                    continue
                if lba_field & 1:
                    m_gids.append(lba_field >> 1)
                    m_blocks.append(block)
                else:
                    u_lbas.append(lba_field >> 1)
                    u_blocks.append(block)

        def pack(lbas: list[int], blks: list[np.ndarray]):
            if not lbas:
                return np.zeros(0, np.int64), np.zeros((0, bb), np.uint8)
            return np.array(lbas, np.int64), np.stack(blks)

        ul, ub = pack(u_lbas, u_blocks)
        mg, mb = pack(m_gids, m_blocks)
        return ul, ub, mg, mb

    def gc_once(self) -> bool:
        """Greedy GC (§4): collect the best cost-benefit victim's live blocks
        and restage them through the normal write path, then reclaim the
        victim's zones.  On the batched datapath collection is one gather +
        OOB read per drive, liveness/eligibility are numpy masks over
        ``l2p.get_many``, and the survivors bulk-stage straight into the
        int32-packed arenas (the fused group re-encode); mapping blocks
        batch the same way.  The scalar path stays as the bit-identical
        per-block baseline."""
        # deferred commits must land first: GC reads validity/L2P state that a
        # pending group is about to update (its old copies would look live)
        self._sync_pending()
        rec = self._gc_select_victim()
        if rec is None:
            return False
        self.stats.gc_runs += 1
        if self.obs_event is not None:
            self.obs_event("gc.begin", seg_id=rec.info.seg_id)
        moved0 = self.stats.gc_blocks_moved
        # Restage segment opens may consume the reserved-zone escrow while
        # this pass runs (cleared before both exits below).
        self._gc_active = True
        info = rec.info
        self._restage_live(rec)
        self.flush()
        self._release_segment(rec)
        self._gc_active = False
        if self.obs_event is not None:
            self.obs_event("gc.end", seg_id=info.seg_id,
                           blocks_moved=self.stats.gc_blocks_moved - moved0)
        return True

    def _restage_live(self, rec: _SegmentRecord) -> None:
        """Collect ``rec``'s live blocks and restage the still-eligible ones
        through the normal write path (the middle of a GC pass; also the
        re-widening relocation of survivor-width segments -- see _rewiden)."""
        info = rec.info
        if self.cfg.batched:
            u_lbas, u_blocks, m_gids, m_blocks = self._gc_collect_batched(rec)
        else:
            u_lbas, u_blocks, m_gids, m_blocks = self._gc_collect_scalar(rec)
        # rewrites go to a large-chunk segment when hybrid (§3.3)
        target_class = (
            int(SegmentClass.LARGE)
            if (self.cfg.hybrid and self.large_ids)
            else int(SegmentClass.SMALL)
        )
        if self.cfg.batched and not self.l2p.offload:
            # GC'd LBAs are unique (one live copy each), so eligibility can be
            # decided up front and the survivors staged in one bulk append.
            if u_lbas.size:
                pbas = self.l2p.get_many(u_lbas)
                segs, _, _ = unpack_pba_many(pbas)
                buffered = np.fromiter(
                    (int(l) in self._buffered for l in u_lbas), bool, u_lbas.size
                )
                sel = np.flatnonzero(
                    (pbas != int(NO_PBA)) & (segs == info.seg_id) & ~buffered
                )
                if sel.size:
                    self._append_blocks(target_class, u_lbas[sel], u_blocks[sel], 0)
                    self.stats.gc_blocks_moved += int(sel.size)
        else:
            # scalar restage -- also the L2P-offload path, where CLOCK
            # eviction decisions depend on the exact per-block access order
            for i in range(u_lbas.size):
                lba = int(u_lbas[i])
                if lba in self._buffered:
                    continue  # a newer user write is in flight; old copy is dead
                pba = self.l2p.get(lba)
                if pba == int(NO_PBA) or unpack_pba(pba)[0] != info.seg_id:
                    continue  # stale by now
                self._append_block(target_class, lba, u_blocks[i], 0)
                self.stats.gc_blocks_moved += 1
        if self.cfg.batched and m_gids.size:
            # mapping blocks batch regardless of L2P offload: the mapping
            # table is a plain dict (no CLOCK), so upfront eligibility and
            # bulk staging are order-equivalent to the scalar loop
            mt = np.fromiter(
                (self.mapping_table.get(int(g), int(NO_PBA)) for g in m_gids),
                np.int64, m_gids.size,
            )
            msegs, _, _ = unpack_pba_many(mt)
            msel = np.flatnonzero((mt != int(NO_PBA)) & (msegs == info.seg_id))
            if msel.size:
                self._append_blocks(
                    target_class,
                    np.full(msel.size, -1, np.int64),
                    m_blocks[msel], 0,
                    meta_gids=m_gids[msel],
                )
                self.stats.gc_blocks_moved += int(msel.size)
        elif m_gids.size:
            for i in range(m_gids.size):
                gid = int(m_gids[i])
                pba = self.mapping_table.get(gid)
                if pba is None or unpack_pba(pba)[0] != info.seg_id:
                    continue
                self._append_block(target_class, -1, m_blocks[i], 0, meta_gid=gid)
                self.stats.gc_blocks_moved += 1

    def _release_segment(self, rec: _SegmentRecord) -> None:
        """Reclaim every member zone of ``rec`` and drop the segment.

        A failed member's zone is returned to that drive's free list without
        a device reset (the drive cannot take commands; ``replace()`` wipes
        its media wholesale), so GC keeps reclaiming while degraded."""
        info = rec.info
        for drive_idx in range(info.n_drives):
            p = info.drive_ids[drive_idx]
            if not self.drives[p].failed:
                self.drives[p].reset_zone(info.zone_ids[drive_idx])
            self.free_zones[p].append(info.zone_ids[drive_idx])
            self._rebuild_pending.discard((info.seg_id, drive_idx))
        self.open_segments.pop(info.seg_id, None)
        del self.segments[info.seg_id]

    # -------------------------------------------------------------- drive fail

    def fail_drive(self, drive_idx: int) -> None:
        """Mark a drive failed and re-rotate writes onto the survivors.

        Staged blocks (partial stripes, buffered Zone-Append groups) are
        drained host-side and restaged at survivor width, so the array stays
        fully writable while degraded: new segments open at k-1 data + m
        parity on the healthy drives, existing full-width open segments
        freeze until rebuild re-adopts them.  When the scheme cannot operate
        at the survivor width (raid6 past two failures, raid0 data loss) the
        rotation is left alone and the next write raises."""
        self._sync_pending()  # the deferred group still owns healthy drives
        self.drives[drive_idx].fail()
        try:
            self._scheme_for_width(len(self._active_drive_ids()))
        except RuntimeError:
            return  # not writable this narrow; reads still decode
        staged = self._drain_staged()
        self._rebuild_rotation()
        self._restage_drained(staged)

    def _drain_staged(self) -> list[tuple[int, int, np.ndarray, int]]:
        """Pull every volatile staged block back to the host: in-flight
        partial stripes and buffered (uncommitted) Zone-Append stripes.
        Returns [(seg_class, lba, block, meta_gid)] in staging order and
        releases the arena slots -- the caller restages after changing the
        write rotation (fail_drive / _rewiden)."""
        self._sync_pending()
        staged: list[tuple[int, int, np.ndarray, int]] = []

        def collect(seg_class: int, stripe: _InFlightStripe) -> None:
            for i in range(stripe.fill):
                lba = int(stripe.lbas[i])
                gid = int(stripe.meta_gids[i])
                if lba < 0 and gid < 0:
                    continue  # padding or a cancelled superseded copy
                if lba >= 0:
                    self._buffered.pop(lba, None)
                staged.append((seg_class, lba, stripe.blocks[i].copy(), gid))
            stripe.release()

        for ost in self.open_segments.values():
            for stripe in ost.group_buffer:
                collect(ost.info.seg_class, stripe)
            ost.group_buffer = []
        for seg_class, stripe in list(self._in_flight.items()):
            collect(seg_class, stripe)
        self._in_flight.clear()
        return staged

    def _restage_drained(self, staged: list[tuple[int, int, np.ndarray, int]]) -> None:
        for seg_class, lba, block, gid in staged:
            self._append_block(seg_class, lba, block, 0, meta_gid=gid)
            if gid >= 0:
                # the drained copy's staging ref moves to the re-appended one
                self._meta_unref(gid)

    def _rebuild_rotation(self) -> None:
        """Point the open-segment rotation at the current active drive set.

        Re-adopts existing open segments that span exactly the active drives
        (in seg_id order) and opens fresh ones at active width for the rest.
        Open segments at other widths stay open but leave the rotation --
        frozen full-width segments while degraded, survivor-width segments
        after a re-widening rebuild (the latter are then relocated away by
        _rewiden)."""
        ids = self._active_drive_ids()
        self._scheme_for_width(len(ids))  # raises if unwritable this narrow
        self._active_ids = ids
        by_class: dict[tuple[int, bool], list[int]] = {}
        for sid in sorted(self.open_segments):
            ost = self.open_segments[sid]
            info = ost.info
            if info.drive_ids != ids:
                continue
            if info.stripes_written + self._pending_count(ost) >= info.n_stripes:
                continue  # data-complete: will seal, not take new stripes
            if any((sid, d) in self._rebuild_pending for d in range(info.n_drives)):
                continue
            by_class.setdefault(
                (info.seg_class, info.uses_append), []
            ).append(sid)

        def take(seg_class: int, chunk_blocks: int, group_size: int) -> int:
            lst = by_class.get((int(seg_class), group_size > 1))
            if lst:
                return lst.pop(0)
            return self._open_segment(seg_class, chunk_blocks, group_size)

        if not self.cfg.hybrid:
            self.small_ids = [
                take(SegmentClass.SMALL, self.cfg.chunk_blocks, self.cfg.group_size)
            ]
            self.large_ids = []
            return
        small, large = [], []
        for i in range(self.cfg.n_small):
            g = self.cfg.group_size if i == 0 else 1  # only one ZA segment
            small.append(take(SegmentClass.SMALL, self.cfg.small_chunk_blocks, g))
        for _ in range(self.cfg.n_large):
            large.append(take(SegmentClass.LARGE, self.cfg.large_chunk_blocks, 1))
        self.small_ids, self.large_ids = small, large

    def _rewiden(self) -> None:
        """Re-widen after rebuild: move writes back to the full drive set and
        relocate survivor-width segments onto full-width stripes.

        Narrow groups are read (fused decode where a member is still
        failed), re-encoded at the active width through the normal write
        path, and their zones reclaimed -- the re-widening backfill.  With
        multiple failures (raid6) only segments *narrower than the current
        active width* relocate; full-width segments holding a still-failed
        member wait for that drive's own rebuild."""
        try:
            ids = self._active_drive_ids()
            self._scheme_for_width(len(ids))
        except RuntimeError:
            return  # still too degraded to write; nothing to re-widen onto
        staged = self._drain_staged()
        self._rebuild_rotation()
        self._restage_drained(staged)
        narrow = [
            rec for sid, rec in sorted(self.segments.items())
            if len(rec.info.drive_ids) < len(ids)
        ]
        if not narrow:
            return
        if self.obs_event is not None:
            self.obs_event("rewiden.begin", n_segments=len(narrow))
        self._gc_active = True  # relocation may consume the GC escrow
        try:
            for rec in narrow:
                self._restage_live(rec)
                self.flush()
                self._release_segment(rec)
        finally:
            self._gc_active = False
        if self.obs_event is not None:
            self.obs_event("rewiden.end", n_segments=len(narrow))

    def rebuild_drive(self, drive_idx: int) -> None:
        """Full-drive recovery (§3.5) onto a replacement drive, then
        re-widen: survivor-width segments written while degraded are
        re-encoded at full width and backfilled across all drives."""
        self._sync_pending()
        self.drives[drive_idx].replace()
        scaffold: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for rec in sorted(self.segments.values(), key=lambda r: r.info.seg_id):
            self._rebuild_segment(rec, drive_idx, scaffold)
        self._rewiden()

    def _rebuild_scaffold(
        self, scaffold: dict, chunk_blocks: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Header/OOB/metadata scratch buffers, allocated once per chunk size
        and reused across every rebuilt segment (not per segment)."""
        tmpl = scaffold.get(chunk_blocks)
        if tmpl is None:
            c = chunk_blocks
            bb = self.zns_cfg.block_bytes
            hdr_chunk = np.zeros((c, bb), np.uint8)
            hdr_oob = np.zeros(c, dtype=OOB_DTYPE)
            hdr_oob["lba"] = INVALID_LBA
            s_max, _ = self._layout_for(c)
            meta_buf = np.zeros(s_max * c, dtype=OOB_DTYPE)
            tmpl = (hdr_chunk, hdr_oob, meta_buf)
            scaffold[chunk_blocks] = tmpl
        return tmpl

    def _rebuild_segment(
        self, rec: _SegmentRecord, drive_idx: int, scaffold: dict
    ) -> None:
        """Reconstruct one segment's zone onto the (already replaced) drive.

        ``rebuild_drive`` calls this for every live segment; the timed
        pipeline's paced rebuild actor calls it one segment per tick so the
        reconstruction traffic contends with foreground I/O over time.
        ``drive_idx`` is the *physical* drive: segments the replaced drive is
        not a member of (survivor-width groups written while it was failed)
        are skipped here -- re-widening relocates them instead (_rewiden).
        ``scaffold`` is the caller-held scratch-buffer cache (see
        :meth:`_rebuild_scaffold`) -- required, so the per-segment
        reallocation this refactor removed cannot quietly return."""
        info = rec.info
        if drive_idx not in info.drive_ids:
            return
        member = info.drive_ids.index(drive_idx)
        new = self.drives[drive_idx]
        scheme = self._scheme_for(info)
        zone = info.zone_ids[member]
        c = info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        hdr_chunk, hdr_oob, meta_buf = self._rebuild_scaffold(scaffold, c)
        hdr_chunk[:] = 0
        hdr_chunk[0] = pack_header(info, bb)
        new.zone_write(zone, 0, hdr_chunk, hdr_oob)
        # how far was this zone written? mirror a surviving zone's shape:
        # sealed => full layout; open => per-CST/our records
        ost = self.open_segments.get(info.seg_id)
        if ost is not None:
            n_chunks = self._zone_chunk_count(rec, member)
        else:
            n_chunks = info.n_stripes
        meta = meta_buf[: n_chunks * c]
        meta[:] = np.zeros((), dtype=OOB_DTYPE)
        meta["lba"] = INVALID_LBA
        if self.cfg.batched and n_chunks:
            # whole-zone batched reconstruction: per-drive gather reads,
            # one fused decode per surviving-role set, one ordered write
            chunks, oob_all = self._reconstruct_chunks(
                rec, member, np.arange(n_chunks),
                verify=self.cfg.verify_reads,
            )
            meta[:] = oob_all.reshape(-1)
            new.zone_write(
                zone, info.data_start(), chunks.reshape(-1, bb), meta
            )
            self.stats.recovery_blocks_read += n_chunks * scheme.k * c
        else:
            for chunk_idx in range(n_chunks):
                chunk = self._reconstruct_chunk(rec, member, chunk_idx)
                oobs = self._reconstruct_oob(rec, member, chunk_idx)
                off = info.data_start() + chunk_idx * c
                new.zone_write(zone, off, chunk, oobs)
                meta[chunk_idx * c : (chunk_idx + 1) * c] = oobs
                self.stats.recovery_blocks_read += scheme.k * c
        if ost is not None:
            ost.meta[member, : n_chunks * c] = meta
        if info.state == int(SegmentState.SEALED):
            foot = pack_footer(meta, bb)
            foot_oob = np.zeros(foot.shape[0], dtype=OOB_DTYPE)
            foot_oob["lba"] = INVALID_LBA
            new.zone_write(zone, int(new.wp[zone]), foot, foot_oob)
            new.finish_zone(zone)
        self._rebuild_pending.discard((info.seg_id, member))

    def _zone_chunk_count(self, rec: _SegmentRecord, drive_idx: int) -> int:
        """Chunks committed to (open) segment on this drive = stripes written."""
        return rec.info.stripes_written

    def _reconstruct_oob(
        self, rec: _SegmentRecord, failed_drive: int, chunk_idx: int
    ) -> np.ndarray:
        """Rebuild the lost chunk's OOB entries from survivors (parity OOB)."""
        info = rec.info
        c = info.chunk_blocks
        scheme = self._scheme_for(info)
        codec = self._codec_for(info)
        seq, members = self._chunk_members(rec, failed_drive, chunk_idx)
        lost_role = scheme.drive_to_role(failed_drive, seq)
        out = np.zeros(c, dtype=OOB_DTYPE)
        out["stripe"] = seq
        if scheme.mirror:
            # copy OOB from the surviving mirror twin
            twin = (lost_role + scheme.k) % (2 * scheme.k)
            for d, cidx in members.items():
                if scheme.drive_to_role(d, seq) == twin:
                    zone = info.zone_ids[d]
                    return self.drives[info.drive_ids[d]].read_oob(
                        zone, info.data_start() + cidx * c, c
                    ).copy()
            raise RuntimeError("mirror OOB lost")
        # The metadata is protected by the same erasure code as the payload
        # (parity_oob); gather k surviving (lba, ts) rows and decode.
        rows_lba, rows_ts, roles = [], [], []
        for d, cidx in members.items():
            if len(roles) == scheme.k:
                break
            zone = info.zone_ids[d]
            oob = self.drives[info.drive_ids[d]].read_oob(
                zone, info.data_start() + cidx * c, c
            )
            rows_lba.append(oob["lba"].astype(np.uint64))
            rows_ts.append(oob["ts"].astype(np.uint64))
            roles.append(scheme.drive_to_role(d, seq))
        data_lba, data_ts = decode_meta(
            codec, np.stack(rows_lba), np.stack(rows_ts), tuple(roles)
        )
        if lost_role < scheme.k:
            out["lba"] = data_lba[lost_role]
            out["ts"] = data_ts[lost_role]
        else:
            p_lba, p_ts = parity_oob(codec, data_lba, data_ts)
            out["lba"] = p_lba[lost_role - scheme.k]
            out["ts"] = p_ts[lost_role - scheme.k]
        return out

    # ------------------------------------------------------------------ scrub

    def scrub_segment(self, seg_id: int) -> dict:
        """Bulk-verify one sealed segment and repair every detected fault.

        Per member zone the whole written extent is gathered in one read
        and checked against the drive's checksum store (plus the UNC
        mask).  Detected faults are repaired in place by provenance:

        * header region -- regenerated from the controller's
          ``SegmentInfo`` (the header is a replicated descriptor);
        * footer region -- repacked from the zone's own OOB area (the
          footer is a serialization of it);
        * data region -- reconstructed through parity
          (:meth:`_reconstruct_chunks` with survivor verification), which
          raises :class:`IntegrityError` if a stripe has lost more blocks
          than the code tolerates.

        Members on failed or rebuild-pending drives are skipped -- the
        rebuild path owns them.  Returns per-pass counters."""
        rec = self.segments[seg_id]
        if rec.info.state != int(SegmentState.SEALED):
            raise ValueError(f"segment {seg_id} is not sealed")
        if self.obs_event is not None:
            self.obs_event("scrub.begin", seg_id=seg_id)
        try:
            return self._scrub_segment_obs(rec)
        finally:
            if self.obs_event is not None:
                self.obs_event("scrub.end", seg_id=seg_id)

    def _scrub_segment_obs(self, rec: _SegmentRecord) -> dict:
        info = rec.info
        c = info.chunk_blocks
        bb = self.zns_cfg.block_bytes
        ds = info.data_start()
        data_end = ds + info.n_stripes * c
        scheme = self._scheme_for(info)
        counters = {"verified": 0, "detected": 0, "repaired": 0,
                    "skipped_members": 0}
        for member in range(info.n_drives):
            drive = self.drives[info.drive_ids[member]]
            if drive.failed or (info.seg_id, member) in self._rebuild_pending:
                counters["skipped_members"] += 1
                continue
            zone = info.zone_ids[member]
            wp = int(drive.wp[zone])
            if wp == 0:
                continue
            offs = np.arange(wp, dtype=np.int64)
            blocks = drive.read_blocks(zone, offs)
            before = self.stats.integrity_corruptions_detected
            ok = self._verify_media(drive, zone, offs, blocks)
            counters["verified"] += wp
            counters["detected"] += (
                self.stats.integrity_corruptions_detected - before
            )
            self.stats.integrity_scrub_blocks += wp
            bad = offs[~ok]
            if bad.size == 0:
                continue
            hbad = bad[bad < ds]
            if hbad.size:
                hdr_chunk = np.zeros((c, bb), np.uint8)
                hdr_chunk[0] = pack_header(info, bb)
                self._repair_in_place(rec, member, hbad, hdr_chunk[hbad],
                                      refresh_cache=False)
                counters["repaired"] += int(hbad.size)
            fbad = bad[bad >= data_end]
            if fbad.size:
                entries = drive.read_oob(zone, ds, data_end - ds)
                foot = pack_footer(entries, bb)
                self._repair_in_place(rec, member, fbad,
                                      foot[fbad - data_end],
                                      refresh_cache=False)
                counters["repaired"] += int(fbad.size)
            dbad = bad[(bad >= ds) & (bad < data_end)]
            if dbad.size:
                didx = dbad - ds
                chunk_idxs, inv = np.unique(didx // c, return_inverse=True)
                chunks, _ = self._reconstruct_chunks(
                    rec, member, chunk_idxs, verify=True
                )
                good = chunks[inv, didx % c]
                # cache keys only exist for data-role blocks (a parity
                # block's OOB lba is erasure-coded metadata, not a key);
                # mirror twins both carry real keys
                data_role = np.empty(chunk_idxs.size, dtype=bool)
                for i, ci in enumerate(chunk_idxs):
                    seq, _ = self._chunk_members(rec, member, int(ci))
                    role = scheme.drive_to_role(member, seq)
                    data_role[i] = scheme.mirror or role < scheme.k
                is_data = data_role[inv]
                for sel, refresh in ((is_data, True), (~is_data, False)):
                    if sel.any():
                        self._repair_in_place(
                            rec, member, dbad[sel], good[sel],
                            refresh_cache=refresh,
                        )
                counters["repaired"] += int(dbad.size)
        return counters

    def scrub_once(self) -> dict:
        """One whole-array scrub pass over every sealed segment.

        The timed pipeline's paced actor walks segments one per tick
        instead (:meth:`HandlerPipeline.schedule_scrub`); this synchronous
        form is for tests and crash-free tooling."""
        self._sync_pending()
        totals = {"verified": 0, "detected": 0, "repaired": 0,
                  "skipped_members": 0, "segments": 0}
        for seg_id in sorted(self.segments):
            if self.segments[seg_id].info.state != int(SegmentState.SEALED):
                continue
            r = self.scrub_segment(seg_id)
            for key in ("verified", "detected", "repaired",
                        "skipped_members"):
                totals[key] += r[key]
            totals["segments"] += 1
        self.stats.integrity_scrub_passes += 1
        return totals

    # ------------------------------------------------------------ crash + misc

    def arm_crash(self, blocks_from_now: int) -> None:
        """Next ``blocks_from_now`` block commits succeed; later ones crash."""
        # a deferred group predates the arming (the synchronous path would
        # already have committed it), so land it before the budget bites
        self._sync_pending()
        self.budget.remaining = blocks_from_now

    def disarm_crash(self) -> None:
        self.budget.remaining = None

    def logical_utilization(self) -> float:
        self._sync_pending()
        live = sum(r.valid_count for r in self.segments.values())
        return live / max(1, self.cfg.logical_blocks)
