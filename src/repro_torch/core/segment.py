"""Segment layout arithmetic and (de)serialization (paper §3.1).

A segment spans k+m zones (one per drive).  Within each zone:

    [ header: C blocks ][ data region: S*C blocks ][ footer: ceil(S*C/204) ]

* header -- replicated segment descriptor (RAID scheme, k, m, zone ids,
  chunk size, group size, segment id, creation timestamp);
* data region -- S stripes of C-block chunks;
* footer -- per-block metadata (LBA u64, ts u64, stripe u32 = 20 bytes) for
  every data-region block *of that zone*, 204 entries per 4 KiB block.

``solve_stripes_per_segment`` reproduces the paper's arithmetic: for the
ZN540 zone (275 712 blocks, C=1) it yields header 1, data 274 366, footer
1 345 blocks.
"""
from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np

from repro_torch.core.zns import OOB_DTYPE, OOB_ENTRY_BYTES
from repro_torch.integrity.checksum import CRC_BYTES, crc32c_many, crc32c_pack

HEADER_MAGIC = b"ZAPR"
HEADER_VERSION = 3


class FooterError(ValueError):
    """Loud failure: a zone footer is truncated or fails its checksum.

    Raised by :func:`unpack_footer` instead of ever returning garbage
    mappings; recovery catches it and falls back to the OOB-area scan."""


class SegmentState(enum.IntEnum):
    OPEN = 0
    SEALED = 1
    FREE = 2


class SegmentClass(enum.IntEnum):
    SMALL = 0  # small-chunk segment (hybrid data management, §3.3)
    LARGE = 1  # large-chunk segment


def footer_entries_per_block(block_bytes: int) -> int:
    return block_bytes // OOB_ENTRY_BYTES  # 4096 // 20 = 204


def footer_slack_bytes(block_bytes: int) -> int:
    """Bytes left in a footer block after ``epb`` packed entries (16 at
    4 KiB blocks) -- where the in-band footer checksum lives."""
    return block_bytes - footer_entries_per_block(block_bytes) * OOB_ENTRY_BYTES


def footer_has_crc(block_bytes: int) -> bool:
    """True when the geometry leaves room for the in-band footer CRC32C.

    Slack-less geometries (e.g. 80/100-byte test blocks pack entries
    exactly) skip the in-band checksum; their footers are still covered
    by the drive's per-block checksum store."""
    return footer_slack_bytes(block_bytes) >= CRC_BYTES


def solve_stripes_per_segment(zone_cap_blocks: int, chunk_blocks: int, block_bytes: int) -> tuple[int, int]:
    """Max stripes S per segment s.t. header + S*C + ceil(S*C/epb) <= cap.

    Returns (S, footer_blocks).
    """
    epb = footer_entries_per_block(block_bytes)
    c = chunk_blocks
    avail = zone_cap_blocks - c  # header costs one chunk
    # S*C + ceil(S*C/epb) <= avail; solve for the largest S.
    s = avail // c
    while s > 0:
        data = s * c
        foot = -(-data // epb)
        if c + data + foot <= zone_cap_blocks:
            break
        s -= 1
    if s <= 0:
        raise ValueError("zone too small for even one stripe")
    return s, -(-s * c // epb)


@dataclasses.dataclass
class SegmentInfo:
    seg_id: int
    scheme_name: str
    k: int
    m: int
    zone_ids: tuple[int, ...]  # zone index on each of the k+m drives
    chunk_blocks: int
    group_size: int  # G; 1 => Zone Write, >1 => Zone Append groups
    seg_class: int  # SegmentClass
    create_ts: int
    n_stripes: int = 0  # filled from layout at open time
    state: int = int(SegmentState.OPEN)
    stripes_written: int = 0  # controller-side cursor (stripes fully persisted)
    drive_ids: tuple[int, ...] = ()  # member index -> physical drive index

    def __post_init__(self) -> None:
        if not self.drive_ids:
            self.drive_ids = tuple(range(self.k + self.m))

    @property
    def n_drives(self) -> int:
        return self.k + self.m

    @property
    def uses_append(self) -> bool:
        return self.group_size > 1

    def data_start(self) -> int:
        return self.chunk_blocks  # header occupies the first chunk

    def group_span_blocks(self) -> int:
        return self.group_size * self.chunk_blocks

    def n_groups(self) -> int:
        return -(-self.n_stripes // self.group_size)


_HEADER_FMT = "<4sHHqHH" + "q" + "qqHq"  # see pack_header


def pack_header(info: SegmentInfo, block_bytes: int) -> np.ndarray:
    """Serialize a SegmentInfo into one block (replicated per zone)."""
    zone_blob = struct.pack(f"<{len(info.zone_ids)}q", *info.zone_ids)
    drive_blob = struct.pack(f"<{len(info.drive_ids)}H", *info.drive_ids)
    name_b = info.scheme_name.encode()
    payload = struct.pack(
        "<4sHHqHHqqHqH",
        HEADER_MAGIC,
        HEADER_VERSION,
        len(name_b),
        info.seg_id,
        info.k,
        info.m,
        info.chunk_blocks,
        info.group_size,
        info.seg_class,
        info.create_ts,
        len(info.zone_ids),
    ) + name_b + zone_blob + drive_blob
    if len(payload) > block_bytes:
        raise ValueError("header does not fit in one block")
    buf = np.zeros(block_bytes, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf


def header_candidates(blocks: np.ndarray) -> np.ndarray:
    """Vectorized pre-filter for a batch of would-be header blocks.

    ``blocks`` is (n, block_bytes) uint8; returns a bool mask of rows whose
    magic and version fields match, so the batched recovery scanner only
    struct-unpacks real headers instead of every written zone's block 0."""
    if blocks.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    magic = np.frombuffer(HEADER_MAGIC, dtype=np.uint8)
    ok = (blocks[:, :4] == magic[None, :]).all(axis=1)
    ver = blocks[:, 4].astype(np.uint16) | (blocks[:, 5].astype(np.uint16) << 8)
    return ok & (ver == HEADER_VERSION)


def unpack_header(block: np.ndarray) -> SegmentInfo | None:
    raw = block.tobytes()
    head_sz = struct.calcsize("<4sHHqHHqqHqH")
    if len(raw) < head_sz:
        return None
    (magic, ver, name_len, seg_id, k, m, chunk_blocks, group_size, seg_class,
     create_ts, n_zones) = struct.unpack("<4sHHqHHqqHqH", raw[:head_sz])
    if magic != HEADER_MAGIC or ver != HEADER_VERSION:
        return None
    off = head_sz
    name = raw[off : off + name_len].decode()
    off += name_len
    zone_ids = struct.unpack(f"<{n_zones}q", raw[off : off + 8 * n_zones])
    off += 8 * n_zones
    drive_ids = struct.unpack(f"<{n_zones}H", raw[off : off + 2 * n_zones])
    return SegmentInfo(
        seg_id=seg_id, scheme_name=name, k=k, m=m, zone_ids=tuple(zone_ids),
        chunk_blocks=chunk_blocks, group_size=group_size, seg_class=seg_class,
        create_ts=create_ts, drive_ids=tuple(drive_ids),
    )


def pack_footer(oob_entries: np.ndarray, block_bytes: int) -> np.ndarray:
    """Serialize the data region's OOB entries of one zone into footer blocks.

    When the geometry has slack (:func:`footer_has_crc`) each footer block
    carries a CRC32C of its packed entry area in the first 4 slack bytes,
    so a recovery scan can tell an intact footer from a rotted one without
    trusting the mappings it is about to install."""
    epb = footer_entries_per_block(block_bytes)
    n = oob_entries.shape[0]
    n_blocks = -(-n // epb)
    raw = np.zeros(n_blocks * epb, dtype=OOB_DTYPE)
    raw[:n] = oob_entries
    entry_bytes = epb * OOB_ENTRY_BYTES
    flat = raw.view(np.uint8).reshape(n_blocks, entry_bytes)
    out = np.zeros((n_blocks, block_bytes), dtype=np.uint8)
    out[:, :entry_bytes] = flat
    if footer_has_crc(block_bytes):
        out[:, entry_bytes : entry_bytes + CRC_BYTES] = crc32c_pack(
            crc32c_many(flat)
        )
    return out


def footer_crc_ok(blocks: np.ndarray, block_bytes: int) -> np.ndarray:
    """Per-block validity mask for footer blocks.

    All-True on slack-less geometries (nothing to check in-band)."""
    n_blocks = blocks.shape[0]
    if not footer_has_crc(block_bytes):
        return np.ones(n_blocks, dtype=bool)
    entry_bytes = footer_entries_per_block(block_bytes) * OOB_ENTRY_BYTES
    stored = np.ascontiguousarray(
        blocks[:, entry_bytes : entry_bytes + CRC_BYTES]
    ).view("<u4").reshape(n_blocks)
    return crc32c_many(np.ascontiguousarray(blocks[:, :entry_bytes])) == stored


def unpack_footer(
    blocks: np.ndarray, n_entries: int, block_bytes: int, *, strict: bool = False
) -> np.ndarray:
    """Deserialize footer blocks back into OOB entries.

    Raises :class:`FooterError` when the blocks cannot possibly hold
    ``n_entries`` (truncated footer) and, with ``strict``, when any
    block's in-band checksum mismatches -- never silently returns short
    or corrupt mappings."""
    epb = footer_entries_per_block(block_bytes)
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(blocks.shape[0], -1)
    if blocks.shape[1] < epb * OOB_ENTRY_BYTES:
        raise FooterError(
            f"footer blocks of {blocks.shape[1]} bytes cannot hold "
            f"{epb} entries (need {epb * OOB_ENTRY_BYTES})"
        )
    if blocks.shape[0] * epb < n_entries:
        raise FooterError(
            f"truncated footer: {blocks.shape[0]} blocks hold at most "
            f"{blocks.shape[0] * epb} entries, need {n_entries}"
        )
    if strict:
        ok = footer_crc_ok(blocks[:, :block_bytes], block_bytes)
        if not ok.all():
            bad = np.flatnonzero(~ok)
            raise FooterError(
                f"footer checksum mismatch in block(s) {bad.tolist()}"
            )
    flat = np.ascontiguousarray(blocks[:, : epb * OOB_ENTRY_BYTES]).reshape(-1)
    entries = flat.view(OOB_DTYPE)[:n_entries]
    return entries.copy()
