"""Simulated ZNS SSD device model.

Faithful functional model of the paper's device abstraction (§2.1):

* append-only zones with per-zone write pointers and EMPTY/OPEN/FULL states;
* 4 KiB logical blocks (configurable) with a per-page out-of-band (OOB)
  metadata area (LBA u64, write-timestamp u64, stripe-id u32 -- 20 bytes, as
  in §3.1);
* ``zone_write`` -- ordered, offset must equal the write pointer, one
  outstanding command per zone;
* ``zone_append`` -- device assigns the offset and returns it; a *batch* of
  appends to one zone may complete in any order (the device model permutes
  completion order with a seeded RNG -- this is exactly the disorder the
  compact stripe table must absorb);
* explicit ``reset_zone`` / ``finish_zone``; bounded open zones.

Crash injection: the array owns a shared ``CrashBudget``; every block commit
decrements it, and when it hits zero the device stops persisting (simulating
power loss mid-group).  Completed commits stay durable, exactly like NAND.

Integrity (PR 10): every committed block carries a CRC32C in a per-block
checksum store (``self.crc``, the simulated DIF/OOB checksum lane).  The
store always reflects what the *host* wrote -- media faults
(:meth:`corrupt_bit_rot`, :meth:`corrupt_torn_write`,
:meth:`corrupt_misdirected_write`, :meth:`mark_unreadable`) perturb the
data plane or the UNC mask only, so a verify pass detects them as
checksum mismatches / unreadable sectors.  Reads keep their historical
non-raising contract; verification layers (``array`` verify-on-read, the
scrub actor, recovery scans) consult :meth:`crc_blocks` /
:meth:`unc_blocks` and repair in place via :meth:`repair_blocks`.

The data plane (block payloads) lives in numpy; parity math over it runs
through the CUDA kernels in ``repro_torch.kernels``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from repro_torch.integrity.checksum import crc32c_many

OOB_DTYPE = np.dtype([("lba", "<u8"), ("ts", "<u8"), ("stripe", "<u4")])
OOB_ENTRY_BYTES = 20  # paper §3.1: 8 (LBA) + 8 (timestamp) + 4 (stripe id)
INVALID_LBA = np.uint64(0xFFFFFFFFFFFFFFFF)


class ZoneState(enum.IntEnum):
    EMPTY = 0
    OPEN = 1
    FULL = 2
    OFFLINE = 3


class DeviceCrashed(Exception):
    """Raised when a write is attempted after the crash budget is exhausted."""


class DriveFailed(Exception):
    """Raised when reading a failed drive."""


class UncorrectableError(Exception):
    """UNC-style media error: a block is flagged unreadable.

    Raised by the *verifying* read layers (``read_verified`` here, the
    array's verify-on-read / scrub paths) when a gather touches a sector
    the device can no longer return -- the host must reconstruct it from
    parity or surface the loss loudly."""


class TooManyOpenZones(Exception):
    """Raised when opening a zone would exceed ``ZnsConfig.max_open_zones``.

    The paper (§2.1) bounds the number of simultaneously open zones -- the
    device holds per-open-zone buffer/XOR resources -- so the controller must
    seal or reset before opening more."""


@dataclasses.dataclass
class ZnsConfig:
    n_zones: int = 16
    zone_cap_blocks: int = 1024  # zone capacity in blocks
    block_bytes: int = 4096
    max_open_zones: int = 8

    @property
    def capacity_blocks(self) -> int:
        return self.n_zones * self.zone_cap_blocks


class CrashBudget:
    """Shared block-commit budget for crash injection (None = no crash)."""

    def __init__(self, blocks: Optional[int] = None):
        self.remaining = blocks

    def consume(self) -> bool:
        """Consume one block commit; False if the power is already out."""
        if self.remaining is None:
            return True
        if self.remaining <= 0:
            return False
        self.remaining -= 1
        return True


class SimZnsDrive:
    """One simulated ZNS SSD."""

    def __init__(self, cfg: ZnsConfig, drive_id: int, budget: Optional[CrashBudget] = None):
        self.cfg = cfg
        self.drive_id = drive_id
        self.budget = budget or CrashBudget(None)
        self.data = np.zeros(
            (cfg.n_zones, cfg.zone_cap_blocks, cfg.block_bytes), dtype=np.uint8
        )
        self.oob = np.zeros((cfg.n_zones, cfg.zone_cap_blocks), dtype=OOB_DTYPE)
        self.oob["lba"] = INVALID_LBA
        # Per-block CRC32C store (simulated DIF lane) + unreadable mask.
        self.crc = np.zeros((cfg.n_zones, cfg.zone_cap_blocks), dtype=np.uint32)
        self.unc = np.zeros((cfg.n_zones, cfg.zone_cap_blocks), dtype=bool)
        self.wp = np.zeros(cfg.n_zones, dtype=np.int64)
        self.state = np.full(cfg.n_zones, ZoneState.EMPTY, dtype=np.int32)
        self.failed = False
        # Device counters (used by benchmarks / write-amplification accounting)
        self.blocks_written = 0
        self.zone_resets = 0
        self.media_faults = 0      # injected sub-drive faults (all kinds)
        self.blocks_repaired = 0   # in-place repairs via repair_blocks

    # -- state management ---------------------------------------------------

    def _check_alive(self):
        if self.failed:
            raise DriveFailed(f"drive {self.drive_id} failed")

    def open_zone_count(self) -> int:
        return int(np.sum(self.state == ZoneState.OPEN))

    def _open_zone(self, zone: int) -> None:
        """EMPTY -> OPEN transition, enforcing the bounded-open-zones limit."""
        if self.state[zone] != ZoneState.EMPTY:
            return
        if self.open_zone_count() >= self.cfg.max_open_zones:
            raise TooManyOpenZones(
                f"drive {self.drive_id}: opening zone {zone} would exceed "
                f"max_open_zones={self.cfg.max_open_zones}"
            )
        self.state[zone] = ZoneState.OPEN

    def reset_zone(self, zone: int) -> None:
        self._check_alive()
        self.wp[zone] = 0
        self.state[zone] = ZoneState.EMPTY
        self.data[zone] = 0
        self.oob[zone] = np.zeros((), dtype=OOB_DTYPE)
        self.oob[zone]["lba"] = INVALID_LBA
        self.crc[zone] = 0
        self.unc[zone] = False
        self.zone_resets += 1

    def finish_zone(self, zone: int) -> None:
        self._check_alive()
        self.state[zone] = ZoneState.FULL

    # -- writes -------------------------------------------------------------

    def _commit_block(self, zone: int, block: np.ndarray, oob_entry, crc=None) -> bool:
        """Persist one block at the write pointer.  False => power lost."""
        if not self.budget.consume():
            return False
        off = int(self.wp[zone])
        assert off < self.cfg.zone_cap_blocks, (zone, off)
        self.data[zone, off] = block
        self.oob[zone, off] = oob_entry
        self.crc[zone, off] = crc if crc is not None \
            else crc32c_many(block[None])[0]
        self.unc[zone, off] = False
        self.wp[zone] = off + 1
        self.blocks_written += 1
        if self.wp[zone] == self.cfg.zone_cap_blocks:
            self.state[zone] = ZoneState.FULL
        return True

    def _commit_blocks(
        self, zone: int, blocks: np.ndarray, oobs: np.ndarray, crcs=None
    ) -> None:
        """Persist a contiguous run of blocks at the write pointer.

        When no crash budget is armed the whole run lands in two slice
        assignments (the hot path for group commits); with a budget armed we
        fall back to per-block commits so power loss cuts at exact block
        granularity, like NAND.

        ``crcs`` lets the caller pass checksums it already computed on the
        packed arenas (the group committer does one vectorized pass over
        the whole codeword); otherwise they are computed here.
        """
        n = blocks.shape[0]
        if crcs is None:
            crcs = crc32c_many(blocks)
        if self.budget.remaining is None:
            off = int(self.wp[zone])
            assert off + n <= self.cfg.zone_cap_blocks, (zone, off, n)
            self.data[zone, off : off + n] = blocks
            self.oob[zone, off : off + n] = oobs
            self.crc[zone, off : off + n] = crcs
            self.unc[zone, off : off + n] = False
            self.wp[zone] = off + n
            self.blocks_written += n
            if self.wp[zone] == self.cfg.zone_cap_blocks:
                self.state[zone] = ZoneState.FULL
            return
        for i in range(n):
            if not self._commit_block(zone, blocks[i], oobs[i], crcs[i]):
                raise DeviceCrashed(f"crash on drive={self.drive_id}")

    def zone_write(
        self, zone: int, offset: int, blocks: np.ndarray, oobs: np.ndarray, crcs=None
    ) -> None:
        """Ordered write: ``offset`` must equal the zone write pointer."""
        self._check_alive()
        if offset != int(self.wp[zone]):
            raise ValueError(
                f"zone_write offset {offset} != wp {int(self.wp[zone])} (zone {zone})"
            )
        self._open_zone(zone)
        self._commit_blocks(zone, blocks, oobs, crcs)

    def zone_append_begin(self, zone: int) -> None:
        self._check_alive()
        self._open_zone(zone)

    def zone_append_commit(
        self, zone: int, blocks: np.ndarray, oobs: np.ndarray, crcs=None
    ) -> int:
        """Commit one append command (a contiguous chunk); returns its offset.

        The *caller* (the array's group committer) is responsible for issuing
        commands of a batch in permuted completion order; the device only
        guarantees that each command lands contiguously at the current wp.
        """
        self._check_alive()
        self._open_zone(zone)
        off = int(self.wp[zone])
        self._commit_blocks(zone, blocks, oobs, crcs)
        return off

    def zone_append_commit_many(
        self, zone: int, chunks: np.ndarray, oobs: np.ndarray, crcs=None
    ) -> np.ndarray:
        """Commit a run of append commands to one zone in the given order.

        ``chunks`` is (n_cmds, chunk_blocks, block_bytes) and ``oobs`` is
        (n_cmds, chunk_blocks); command i lands at ``offsets[i]``, exactly as
        n_cmds sequential :meth:`zone_append_commit` calls would -- but the
        media update is two slice assignments for the whole run (the group
        committer's per-drive hot path).  Returns the per-command offsets.

        Only valid with no crash budget armed: per-block power-loss
        granularity needs the scalar path (the caller falls back to it)."""
        assert self.budget.remaining is None, "bulk append needs the scalar path"
        self._check_alive()
        self._open_zone(zone)
        n_cmds, c, bb = chunks.shape
        off0 = int(self.wp[zone])
        self._commit_blocks(zone, chunks.reshape(n_cmds * c, bb),
                            oobs.reshape(n_cmds * c),
                            None if crcs is None else
                            np.asarray(crcs).reshape(n_cmds * c))
        return off0 + c * np.arange(n_cmds, dtype=np.int64)

    # -- reads --------------------------------------------------------------

    def read(self, zone: int, offset: int, n_blocks: int) -> np.ndarray:
        self._check_alive()
        return self.data[zone, offset : offset + n_blocks]

    def read_oob(self, zone: int, offset: int, n_blocks: int) -> np.ndarray:
        self._check_alive()
        return self.oob[zone, offset : offset + n_blocks]

    def read_blocks(self, zone: int, offsets: np.ndarray) -> np.ndarray:
        """Gather scattered blocks of one zone: (len(offsets), block_bytes)."""
        self._check_alive()
        return self.data[zone, np.asarray(offsets, dtype=np.int64)]

    def read_scattered(self, zones: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """Cross-zone gather: block ``offsets[i]`` of ``zones[i]`` for each i.

        The recovery scanner's primitive -- e.g. every zone's header block in
        one command instead of one read per zone."""
        self._check_alive()
        return self.data[
            np.asarray(zones, dtype=np.int64), np.asarray(offsets, dtype=np.int64)
        ]

    def read_oob_blocks(self, zone: int, offsets: np.ndarray) -> np.ndarray:
        """Gather scattered OOB entries of one zone."""
        self._check_alive()
        return self.oob[zone, np.asarray(offsets, dtype=np.int64)]

    # -- integrity: checksum store + UNC mask --------------------------------

    def crc_blocks(self, zone: int, offsets: np.ndarray) -> np.ndarray:
        """Gather stored checksums of one zone's blocks (host DIF lane)."""
        self._check_alive()
        return self.crc[zone, np.asarray(offsets, dtype=np.int64)]

    def crc_scattered(self, zones: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        self._check_alive()
        return self.crc[
            np.asarray(zones, dtype=np.int64), np.asarray(offsets, dtype=np.int64)
        ]

    def unc_blocks(self, zone: int, offsets: np.ndarray) -> np.ndarray:
        """Unreadable-sector mask for a gather (True => UNC on read)."""
        self._check_alive()
        return self.unc[zone, np.asarray(offsets, dtype=np.int64)]

    def unc_scattered(self, zones: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        self._check_alive()
        return self.unc[
            np.asarray(zones, dtype=np.int64), np.asarray(offsets, dtype=np.int64)
        ]

    def read_verified(self, zone: int, offset: int, n_blocks: int) -> np.ndarray:
        """Checked contiguous read: raises :class:`UncorrectableError` on a
        UNC sector instead of returning whatever is on the media."""
        self._check_alive()
        if self.unc[zone, offset : offset + n_blocks].any():
            raise UncorrectableError(
                f"drive {self.drive_id}: UNC in zone {zone} "
                f"[{offset}, {offset + n_blocks})"
            )
        return self.data[zone, offset : offset + n_blocks]

    def repair_blocks(self, zone: int, offsets: np.ndarray, blocks: np.ndarray) -> None:
        """In-place media repair: rewrite blocks that parity reconstructed.

        Unlike a log append this does *not* move the write pointer or touch
        the OOB area -- the logical location (L2P, CST) of the block is
        unchanged; only the rotted payload is replaced, its checksum
        recomputed, and any UNC flag cleared (a successful rewrite
        reallocates the sector, like a NAND read-retry + rewrite)."""
        self._check_alive()
        offs = np.asarray(offsets, dtype=np.int64)
        blocks = np.asarray(blocks, dtype=np.uint8).reshape(
            offs.size, self.cfg.block_bytes
        )
        self.data[zone, offs] = blocks
        self.crc[zone, offs] = crc32c_many(blocks)
        self.unc[zone, offs] = False
        self.blocks_repaired += int(offs.size)

    def written_mask(self) -> np.ndarray:
        """(n_zones, cap) bool: True where a block has been committed."""
        return (
            np.arange(self.cfg.zone_cap_blocks, dtype=np.int64)[None, :]
            < self.wp[:, None]
        )

    # -- integrity: media-fault application ----------------------------------
    #
    # All fault hooks perturb the data plane / UNC mask only -- never the
    # checksum store, which models the host-written DIF lane.  That is what
    # makes every injected fault *detectable*: a verify pass sees a stored
    # checksum that no longer matches the media (or an UNC flag).

    def corrupt_bit_rot(self, zone: int, off: int, byte: int = 0, bit: int = 0) -> None:
        """Flip one bit of a committed block (retention/read-disturb rot)."""
        self.data[zone, off, byte] ^= np.uint8(1 << bit)
        self.media_faults += 1

    def corrupt_torn_write(self, zone: int, n_blocks: int) -> int:
        """Lose the tail of the most recent commit to this zone: the last
        ``n_blocks`` before the write pointer revert to erased (zeros) while
        wp/OOB/checksums still reflect the intended write -- the classic
        torn/partial-write fault.  Returns how many blocks were torn."""
        end = int(self.wp[zone])
        lo = max(0, end - n_blocks)
        if end > lo:
            self.data[zone, lo:end] = 0
            self.media_faults += end - lo
        return end - lo

    def corrupt_misdirected_write(
        self, zone: int, off: int, src_zone: int, src_off: int
    ) -> None:
        """A write aimed elsewhere landed here: the victim block's media is
        overwritten with another block's payload (its stored checksum now
        mismatches), modeling a firmware misdirected write."""
        self.data[zone, off] = self.data[src_zone, src_off]
        self.media_faults += 1

    def mark_unreadable(self, zone: int, off: int) -> None:
        """Latent sector error: reads of this block return UNC."""
        self.unc[zone, off] = True
        self.media_faults += 1

    # -- failure ------------------------------------------------------------

    def fail(self) -> None:
        """Full-drive failure: all data is gone."""
        self.failed = True

    def replace(self) -> None:
        """Swap in a fresh drive (same identity, empty media).

        Lifetime counters (``blocks_written``, ``zone_resets``) are carried
        over: they account the *array slot's* device traffic, and resetting
        them on a swap would corrupt write-amplification accounting across a
        rebuild."""
        self.data[:] = 0
        self.oob[:] = np.zeros((), dtype=OOB_DTYPE)
        self.oob["lba"] = INVALID_LBA
        self.crc[:] = 0
        self.unc[:] = False
        self.wp[:] = 0
        self.state[:] = ZoneState.EMPTY
        self.failed = False


def make_array_drives(
    n_drives: int, cfg: ZnsConfig, budget: Optional[CrashBudget] = None
) -> list[SimZnsDrive]:
    budget = budget or CrashBudget(None)
    return [SimZnsDrive(cfg, i, budget) for i in range(n_drives)]


# Persistent per-drive state: the media planes plus the flags and counters a
# crash leaves behind.  A drive image is a dict of numpy arrays and ints, so it
# moves between this package and any other model of the same drive layout.
_IMAGE_PLANES = ("data", "oob", "crc", "unc", "wp", "state")
_IMAGE_COUNTERS = ("blocks_written", "zone_resets", "media_faults",
                   "blocks_repaired")


def drive_images(drives: list) -> list[dict]:
    """One dict per drive: copies of ``data``, ``oob``, ``crc``, ``unc``,
    ``wp``, ``state``, the ``failed`` flag and the device counters."""
    out = []
    for d in drives:
        img = {name: np.array(getattr(d, name), copy=True) for name in _IMAGE_PLANES}
        img["failed"] = bool(d.failed)
        img.update({name: int(getattr(d, name)) for name in _IMAGE_COUNTERS})
        out.append(img)
    return out


def drives_from_numpy(
    images: list[dict], cfg: ZnsConfig, budget: Optional[CrashBudget] = None
) -> list[SimZnsDrive]:
    """Build :class:`SimZnsDrive` s from :func:`drive_images` dicts (copied
    in, checked against ``cfg``), sharing one crash budget."""
    drives = make_array_drives(len(images), cfg, budget)
    for d, img in zip(drives, images):
        for name in _IMAGE_PLANES:
            plane = getattr(d, name)
            src = np.asarray(img[name])
            if src.shape != plane.shape or src.dtype != plane.dtype:
                raise ValueError(
                    f"drive {d.drive_id} {name}: image {src.shape} {src.dtype} "
                    f"does not match {plane.shape} {plane.dtype}"
                )
            plane[...] = src
        d.failed = bool(img["failed"])
        for name in _IMAGE_COUNTERS:
            setattr(d, name, int(img[name]))
    return drives
