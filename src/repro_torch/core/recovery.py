"""Crash recovery (paper §3.4).

``recover_array(drives, cfg, zns_cfg)`` rebuilds a consistent ZapRAIDArray
from the persistent state of the drives after a crash, in the paper's order:

1. **Segment table** -- scan zone headers; a segment is valid iff every one
   of its zones has at least the header persisted (Case 1); segments with
   any missing-header zone are discarded and their zones reset (Case 2).
2. **Stripes** -- for every open segment, count persisted chunks per stripe
   id (OOB scan); stripes with fewer than k+m chunks are *partial*.  A
   segment holding partial stripes is *dirty*: its fully-persisted winning
   blocks are rewritten into a fresh segment and the old zones reclaimed
   (ZNS cannot patch in place).  Data-complete-but-unfooted segments get
   their footer recomputed and are sealed.
3. **L2P + CST** -- sealed segments replay their footers (fast path), open
   segments their OOB areas; the latest write-timestamp wins per LBA.
   Mapping blocks (LSB-tagged LBA field) feed a temporary table; entry
   groups whose mapping block is newer than every user entry in the group
   stay offloaded on the SSD (paper §3.1/§3.4).

Because writes are acknowledged only after the whole stripe persists,
discarding partial stripes never loses acknowledged data.

With ``cfg.batched`` (the default) the scan pipeline is vectorized end to
end: one cross-zone header gather per drive with a vectorized magic
pre-filter, whole-data-region OOB scans resolved with numpy (no per-chunk
Python loops), winner resolution as one lexsort over every harvested
``(key, ts, pba)`` triple (latest ts wins, first-encountered wins ties --
exactly the scalar dict semantics), and bulk L2P/validity installation via
``set_many`` / ``_mark_valid_many``.  ``cfg.batched=False`` keeps the
per-chunk/per-block scan loops as the bit-identical scalar baseline; both
paths share the vectorized installer, so recovered state is identical by
construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.array import ZapRaidConfig, ZapRAIDArray, _OpenSegment, _SegmentRecord
from repro_torch.core.group_layout import CompactStripeTable
from repro_torch.core.l2p import NO_PBA, pack_pba, pack_pba_many, unpack_pba, unpack_pba_many
from repro_torch.core.segment import (
    FooterError,
    SegmentInfo,
    SegmentState,
    header_candidates,
    solve_stripes_per_segment,
    unpack_footer,
    unpack_header,
)
from repro_torch.integrity.checksum import crc32c_many
from repro_torch.core.zns import (
    INVALID_LBA,
    OOB_DTYPE,
    SimZnsDrive,
    ZnsConfig,
    ZoneState,
)


class RecoveryError(RuntimeError):
    """Crash state the scanner cannot safely resolve (fail-loud path)."""


@dataclasses.dataclass
class _FoundSegment:
    info: SegmentInfo
    wps: list[int]
    footer_blocks: int = 0
    sealed: bool = False
    dirty: bool = False
    complete_seqs: set = dataclasses.field(default_factory=set)
    # member -> (n_chunks, C) OOB rows for the persisted data-region prefix
    meta: dict = dataclasses.field(default_factory=dict)
    # members whose physical drive is failed: media unreadable, metadata is
    # synthesized from the survivors' parity OOB after install
    absent: set = dataclasses.field(default_factory=set)
    # member whose zone a crashed rebuild left behind the sealed others;
    # its zone is reset and rewritten from survivors after install
    rebuild_member: int | None = None

    def present(self) -> list[int]:
        skip = self.absent
        if self.rebuild_member is not None:
            skip = skip | {self.rebuild_member}
        return [d for d in range(self.info.n_drives) if d not in skip]

    def data_end(self) -> int:
        return self.info.data_start() + self.info.n_stripes * self.info.chunk_blocks

    def seal_end(self) -> int:
        return self.data_end() + self.footer_blocks

    def data_complete(self) -> bool:
        return all(self.wps[d] >= self.data_end() for d in self.present())

    def complete_arr(self) -> np.ndarray:
        return np.fromiter(sorted(self.complete_seqs), np.int64, len(self.complete_seqs))


def _note_segment(found, info, drives, zns_cfg) -> None:
    s, foot = solve_stripes_per_segment(
        zns_cfg.zone_cap_blocks, info.chunk_blocks, zns_cfg.block_bytes
    )
    info.n_stripes = s
    fs = _FoundSegment(info=info, wps=[0] * len(info.zone_ids), footer_blocks=foot)
    for member, zid in enumerate(info.zone_ids):
        d = drives[info.drive_ids[member]]
        if d.failed:
            fs.absent.add(member)  # stale media; never trust a dead drive
            fs.wps[member] = -1
        else:
            fs.wps[member] = int(d.wp[zid])
    found[info.seg_id] = fs


def _scan_headers(drives, zns_cfg, stats) -> dict[int, _FoundSegment]:
    """Per-zone header reads + unpack (the scalar baseline).

    A header copy whose media checksum mismatches (or that reads UNC) is
    skipped, so a rotted copy loses to an intact replica on another
    member instead of installing garbage geometry."""
    found: dict[int, _FoundSegment] = {}
    for d in drives:
        if d.failed:
            continue
        for z in range(zns_cfg.n_zones):
            if d.state[z] == ZoneState.EMPTY or d.wp[z] == 0:
                continue
            block = d.read(z, 0, 1)
            stats.recovery_blocks_read += 1
            zero = np.zeros(1, np.int64)
            if (
                bool(d.unc_blocks(z, zero)[0])
                or int(d.crc_blocks(z, zero)[0]) != int(crc32c_many(block)[0])
            ):
                continue  # rotted copy: an intact replica must win
            info = unpack_header(block[0])
            if info is None or info.seg_id in found:
                continue
            _note_segment(found, info, drives, zns_cfg)
    return found


def _scan_headers_batched(drives, zns_cfg, stats) -> dict[int, _FoundSegment]:
    """One cross-zone header gather per drive + vectorized magic pre-filter.

    Checksum validation is part of the same bulk pass: copies whose media
    CRC mismatches or that read UNC are dropped before unpacking."""
    found: dict[int, _FoundSegment] = {}
    for d in drives:
        if d.failed:
            continue
        zs = np.flatnonzero((np.asarray(d.state) != ZoneState.EMPTY) & (d.wp > 0))
        if zs.size == 0:
            continue
        zeros = np.zeros(zs.size, np.int64)
        blocks = d.read_scattered(zs, zeros)
        stats.recovery_blocks_read += int(zs.size)
        intact = (
            (crc32c_many(blocks) == d.crc_scattered(zs, zeros))
            & ~d.unc_scattered(zs, zeros)
        )
        for i in np.flatnonzero(header_candidates(blocks) & intact):
            info = unpack_header(blocks[i])
            if info is None or info.seg_id in found:
                continue
            _note_segment(found, info, drives, zns_cfg)
    return found


def _read_zone_oob(fs: _FoundSegment, drives, member: int, stats):
    """(n_chunks, C) OOB rows of one zone's persisted data prefix, or None."""
    info = fs.info
    c = info.chunk_blocks
    data_start = info.data_start()
    usable = min(fs.wps[member], fs.data_end()) - data_start
    n_chunks = max(0, usable) // c  # trailing partial chunks are dropped
    if n_chunks <= 0:
        return None
    z = info.zone_ids[member]
    oob = drives[info.drive_ids[member]].read_oob(z, data_start, n_chunks * c)
    stats.recovery_blocks_read += n_chunks * c
    return oob.reshape(n_chunks, c).copy()


def _ragged_tail(fs: _FoundSegment) -> bool:
    """A drive with committed blocks beyond whole chunks is also dirty."""
    c = fs.info.chunk_blocks
    data_start = fs.info.data_start()
    for member in fs.present():
        usable = min(fs.wps[member], fs.data_end()) - data_start
        if usable > 0 and usable % c != 0:
            return True
    return False


def _scan_stripes(fs: _FoundSegment, drives, stats) -> None:
    """OOB-scan the data region; classify complete vs partial stripes
    (scalar baseline: per-chunk Python loop).  Completeness is judged over
    the *present* members: chunks on a failed drive are reconstructible
    from parity, so they never gate a stripe."""
    per_seq_count: dict[int, int] = {}
    for member in fs.present():
        rows = _read_zone_oob(fs, drives, member, stats)
        if rows is None:
            continue
        fs.meta[member] = rows
        for chunk in range(rows.shape[0]):
            seq = int(rows["stripe"][chunk, 0])
            per_seq_count[seq] = per_seq_count.get(seq, 0) + 1
    n = len(fs.present())
    fs.complete_seqs = {s for s, cnt in per_seq_count.items() if cnt == n}
    fs.dirty = any(cnt != n for cnt in per_seq_count.values()) or _ragged_tail(fs)


def _scan_stripes_batched(fs: _FoundSegment, drives, stats) -> None:
    """Vectorized ``_scan_stripes``: per-drive bulk OOB read, stripe-id
    completeness via one ``np.unique`` count over all drives' chunks."""
    seq_parts: list[np.ndarray] = []
    for member in fs.present():
        rows = _read_zone_oob(fs, drives, member, stats)
        if rows is None:
            continue
        fs.meta[member] = rows
        seq_parts.append(rows["stripe"][:, 0].astype(np.int64))
    n = len(fs.present())
    if seq_parts:
        seqs, counts = np.unique(np.concatenate(seq_parts), return_counts=True)
        fs.complete_seqs = set(seqs[counts == n].tolist())
        fs.dirty = bool((counts != n).any())
    fs.dirty = fs.dirty or _ragged_tail(fs)


def _read_sealed_meta(fs: _FoundSegment, drives, zns_cfg, stats) -> None:
    """Fast path: replay footers instead of scanning the whole OOB area.

    Each member's footer is validated before its mappings are trusted:
    the media checksum store first, then the in-band footer CRC
    (``unpack_footer(strict=True)``).  A member whose footer is rotted,
    torn, or UNC falls back to that zone's OOB-area scan -- same
    entries, slower path -- rather than installing garbage mappings."""
    info = fs.info
    c = info.chunk_blocks
    n_entries = info.n_stripes * c
    all_seqs: list[np.ndarray] = []
    for member in fs.present():
        z = info.zone_ids[member]
        d = drives[info.drive_ids[member]]
        foot = d.read(z, fs.data_end(), fs.footer_blocks)
        stats.recovery_blocks_read += foot.shape[0]
        offs = fs.data_end() + np.arange(fs.footer_blocks, dtype=np.int64)
        try:
            if (
                d.unc_blocks(z, offs).any()
                or (crc32c_many(foot) != d.crc_blocks(z, offs)).any()
            ):
                raise FooterError(
                    f"segment {info.seg_id} member {member}: footer fails "
                    "the media checksum"
                )
            entries = unpack_footer(
                foot, n_entries, zns_cfg.block_bytes, strict=True
            )
        except FooterError:
            # rotted footer: the OOB area holds the same per-block
            # metadata (the footer is a serialization of it)
            entries = d.read_oob(z, info.data_start(), n_entries).copy()
            stats.recovery_blocks_read += n_entries
        rows = entries.reshape(info.n_stripes, c)
        fs.meta[member] = rows
        all_seqs.append(rows["stripe"][:, 0].astype(np.int64))
    fs.complete_seqs = set(np.unique(np.concatenate(all_seqs)).tolist())
    fs.sealed = True
    fs.dirty = False


def recover_array(
    drives: list[SimZnsDrive], cfg: ZapRaidConfig, zns_cfg: ZnsConfig
) -> ZapRAIDArray:
    arr = ZapRAIDArray(cfg, zns_cfg, drives, _recovering=True)
    arr.disarm_crash()
    stats = arr.stats
    batched = cfg.batched

    found = (
        _scan_headers_batched(drives, zns_cfg, stats)
        if batched
        else _scan_headers(drives, zns_cfg, stats)
    )
    valid, discard = [], []
    for fs in found.values():
        healthy = [d for d in range(fs.info.n_drives) if d not in fs.absent]
        behind = [d for d in healthy if fs.wps[d] < fs.data_end()]
        rest_sealed = all(
            fs.wps[d] >= fs.seal_end() for d in healthy if d not in behind
        )
        if behind and rest_sealed and len(healthy) > len(behind):
            # Some members are mid-zone while every other member carries a
            # finished footer: normal commit order (seal starts only after
            # ALL members are data-complete) cannot produce this -- a crash
            # interrupted a rebuild rewriting those zones.
            if len(behind) > 1:
                raise RecoveryError(
                    f"segment {fs.info.seg_id}: {len(behind)} members are "
                    "mid-zone while the rest are sealed -- crash during a "
                    "rebuild left multiple zones inconsistent; restore from "
                    "the replica or re-run rebuild from a healthy mirror"
                )
            if len(healthy) - 1 < fs.info.k:
                raise RecoveryError(
                    f"segment {fs.info.seg_id}: crash during rebuild and "
                    "not enough surviving members to reconstruct"
                )
            fs.rebuild_member = behind[0]
            valid.append(fs)
            continue
        # Crash while a rebuild was rewriting an *open* segment's zone: the
        # replaced member's zone is wiped (no header) while survivors carry
        # headers and possibly data.  A crash during _open_segment leaves
        # the same shape with an empty prefix -- rewriting the header from
        # the survivors is correct (and harmless) for both.
        headerless = [d for d in healthy if fs.wps[d] < fs.info.chunk_blocks]
        if headerless and len(headerless) < len(healthy):
            if not any(fs.wps[d] > fs.info.data_start() for d in healthy):
                # no survivor holds data: crash during _open_segment itself
                # (paper Case 2) -- the segment is empty, discard it
                discard.append(fs)
                continue
            if len(headerless) > 1:
                raise RecoveryError(
                    f"segment {fs.info.seg_id}: {len(headerless)} member "
                    "zones have no header while others hold data -- crash "
                    "left multiple zones wiped; restore from the replica"
                )
            if len(healthy) - 1 < fs.info.k:
                raise RecoveryError(
                    f"segment {fs.info.seg_id}: a member zone is wiped and "
                    "not enough surviving members to reconstruct it"
                )
            fs.rebuild_member = headerless[0]
            valid.append(fs)
            continue
        if behind and len(behind) == len(healthy):
            # Fully-unsealed segment: normal commits advance members one
            # group at a time, so write pointers can never spread by more
            # than one group span.  A wider spread means a rebuild crashed
            # mid-way through rewriting one member's zone -- data beyond
            # the laggard's pointer is reconstructible but not attributable,
            # so fail loudly rather than silently drop those stripes.
            lead = max(fs.wps[d] for d in healthy)
            lag = min(fs.wps[d] for d in healthy)
            span = max(1, fs.info.group_size) * fs.info.chunk_blocks
            if lag >= fs.info.chunk_blocks and lead - lag > span:
                raise RecoveryError(
                    f"segment {fs.info.seg_id}: member write pointers "
                    f"spread {lead - lag} blocks (> one group span) -- "
                    "crash mid-rebuild left a zone partially rewritten; "
                    "re-run the rebuild from a healthy mirror"
                )
        # paper Case 2: any zone below the header size => discard segment
        if any(fs.wps[d] < fs.info.chunk_blocks for d in healthy):
            discard.append(fs)
        else:
            valid.append(fs)
    for fs in discard:
        for member, z in enumerate(fs.info.zone_ids):
            p = fs.info.drive_ids[member]
            if not drives[p].failed and drives[p].wp[z] > 0:
                drives[p].reset_zone(z)

    for fs in valid:
        if fs.rebuild_member is not None:
            if all(fs.wps[d] >= fs.seal_end() for d in fs.present()):
                _read_sealed_meta(fs, drives, zns_cfg, stats)  # survivors only
            else:
                # open segment with a wiped member: scan the survivors'
                # OOB prefix; the zone rewrite below restores the member
                if batched:
                    _scan_stripes_batched(fs, drives, stats)
                else:
                    _scan_stripes(fs, drives, stats)
                if fs.dirty:
                    raise RecoveryError(
                        f"segment {fs.info.seg_id}: partial stripes on "
                        "the survivors of a crashed rebuild -- winners "
                        "cannot be safely re-read; re-run the rebuild"
                    )
            continue
        fully_sealed = all(fs.wps[d] >= fs.seal_end() for d in fs.present())
        if fully_sealed:
            _read_sealed_meta(fs, drives, zns_cfg, stats)
        elif batched:
            _scan_stripes_batched(fs, drives, stats)
        else:
            _scan_stripes(fs, drives, stats)
        if fs.dirty and fs.absent:
            raise RecoveryError(
                f"segment {fs.info.seg_id}: partial stripes on a degraded "
                "segment (member drive failed) -- winners cannot be "
                "re-read; replace the drive and rebuild before recovering"
            )

    clean = [fs for fs in valid if not fs.dirty]
    dirty = [fs for fs in valid if fs.dirty]
    arr.next_seg_id = max((fs.info.seg_id for fs in valid), default=-1) + 1

    for fs in clean:
        _install_segment(arr, fs, zns_cfg)

    # free-zone lists = complement of zones referenced by live segments
    used = [set() for _ in drives]
    for fs in valid:
        for member, z in enumerate(fs.info.zone_ids):
            used[fs.info.drive_ids[member]].add(z)
    arr.free_zones = [
        [z for z in range(zns_cfg.n_zones - 1, -1, -1) if z not in used[i]]
        for i in range(len(drives))
    ]
    for i, d in enumerate(drives):
        if d.failed:
            continue
        for z in arr.free_zones[i]:
            if d.wp[z] > 0:
                d.reset_zone(z)

    _restore_open_slots(arr)

    # ---- crashed-rebuild zones: rewrite from survivors --------------------
    scaffold: dict = {}
    for fs in clean:
        if fs.rebuild_member is not None:
            _rewrite_rebuild_zone(arr, fs, drives, zns_cfg, scaffold)
    # ---- failed-drive members: synthesize metadata from parity OOB --------
    for fs in clean:
        if fs.absent:
            _synthesize_absent_meta(arr, fs)

    # ---- latest-wins metadata resolution over ALL valid segments ----------
    if batched:
        u_keys, u_ts, u_pbas, m_keys, m_ts, m_pbas = _harvest_meta_batched(arr, valid)
    else:
        user_wins: dict[int, tuple[int, int]] = {}
        map_wins: dict[int, tuple[int, int]] = {}
        for fs in valid:
            _harvest_meta(arr, fs, user_wins, map_wins)
        u_keys, u_ts, u_pbas = _wins_arrays(user_wins)
        m_keys, m_ts, m_pbas = _wins_arrays(map_wins)

    # Fast-forward the timestamp clock past everything on disk, and seed the
    # per-LBA commit timestamps so post-recovery writes are never "stale".
    max_ts = max(int(np.max(u_ts, initial=0)), int(np.max(m_ts, initial=0)))
    arr.ts_counter = max(arr.ts_counter, max_ts + 1)
    arr._lba_ts[u_keys] = u_ts.astype(np.uint64)
    for i in range(m_keys.size):
        arr._gid_ts[int(m_keys[i])] = int(m_ts[i])

    dirty_ids = {fs.info.seg_id for fs in dirty}
    # ---- re-inject winning blocks that live in dirty segments -------------
    reinjected_gids = _reinject(
        arr, dirty, u_keys, u_ts, u_pbas, m_keys, m_ts, m_pbas, dirty_ids, drives
    )
    arr.flush()
    for fs in dirty:
        for member, z in enumerate(fs.info.zone_ids):
            p = fs.info.drive_ids[member]
            if not drives[p].failed:
                drives[p].reset_zone(z)
            arr.free_zones[p].append(z)

    # ---- apply the remaining (clean-segment) wins --------------------------
    _apply_wins(
        arr, u_keys, u_ts, u_pbas, m_keys, m_ts, m_pbas, dirty_ids, reinjected_gids
    )

    # ---- re-seal data-complete segments missing their footers --------------
    for ost in list(arr.open_segments.values()):
        if ost.info.stripes_written >= ost.info.n_stripes:
            arr._seal_segment(ost)
    # a crash between a rebuild's scaffold phase and its re-widening pass
    # leaves survivor-width segments behind: finish the relocation now
    arr._rewiden()
    arr._drain_meta()
    return arr


def _rewrite_rebuild_zone(arr, fs: _FoundSegment, drives, zns_cfg, scaffold) -> None:
    """Finish a crashed rebuild: the mid-zone member is reset and rewritten
    from the sealed survivors.  The lost zone's original append order is
    unknowable, so it is rewritten in canonical stripe order and that layout
    recorded in the CST -- self-consistent with every later read/rebuild."""
    info = fs.info
    b = fs.rebuild_member
    p = info.drive_ids[b]
    z = info.zone_ids[b]
    if drives[p].wp[z] > 0 or drives[p].state[z] != ZoneState.EMPTY:
        drives[p].reset_zone(z)
    rec = arr.segments[info.seg_id]
    n_stripes = info.n_stripes if fs.sealed else int(rec.info.stripes_written)
    if info.uses_append and rec.cst is not None and n_stripes:
        idx = np.arange(n_stripes)
        rec.cst.record_many(b, idx, idx % info.group_size)
    arr._rebuild_segment(rec, p, scaffold)
    c = info.chunk_blocks
    if fs.sealed:
        # read back the rewritten footer so winner harvesting sees member b
        foot = drives[p].read(z, fs.data_end(), fs.footer_blocks)
        arr.stats.recovery_blocks_read += foot.shape[0]
        entries = unpack_footer(foot, info.n_stripes * c, zns_cfg.block_bytes)
        fs.meta[b] = entries.reshape(info.n_stripes, c)
    elif n_stripes:
        # open segment: read back the rewritten OOB prefix instead
        rows = drives[p].read_oob(z, info.data_start(), n_stripes * c)
        arr.stats.recovery_blocks_read += n_stripes * c
        fs.meta[b] = rows.reshape(n_stripes, c).copy()
        ost = arr.open_segments.get(info.seg_id)
        if ost is not None:
            ost.meta[b, : n_stripes * c] = fs.meta[b].reshape(-1)


def _synthesize_absent_meta(arr, fs: _FoundSegment) -> None:
    """Reconstruct a failed member's OOB rows from the survivors' parity
    OOB so its winners still install (reads reconstruct through parity).
    Append segments get canonical CST rows for the absent member: the dead
    zone's real arrival order is unknowable, and the replacement rebuild
    will rewrite the zone in exactly this order."""
    info = fs.info
    rec = arr.segments[info.seg_id]
    c = info.chunk_blocks
    n_chunks = info.n_stripes if fs.sealed else int(info.stripes_written)
    if n_chunks <= 0:
        return
    ost = arr.open_segments.get(info.seg_id)
    for b in sorted(fs.absent):
        if info.uses_append and rec.cst is not None:
            idx = np.arange(n_chunks)
            rec.cst.record_many(b, idx, idx % info.group_size)
        rows = np.zeros((n_chunks, c), dtype=OOB_DTYPE)
        for chunk_idx in range(n_chunks):
            rows[chunk_idx] = arr._reconstruct_oob(rec, b, chunk_idx)
        fs.meta[b] = rows
        if ost is not None:
            ost.meta[b, : n_chunks * c] = rows.reshape(-1)


def _install_segment(arr: ZapRAIDArray, fs: _FoundSegment, zns_cfg) -> None:
    info = fs.info
    rec = _SegmentRecord(info)
    arr.segments[info.seg_id] = rec
    c = info.chunk_blocks

    def fill_open_meta(ost: _OpenSegment) -> None:
        for d, rows in fs.meta.items():
            ost.meta[d, : rows.shape[0] * c] = rows.reshape(-1)

    if fs.sealed or fs.data_complete():
        info.state = int(SegmentState.SEALED)
        info.stripes_written = info.n_stripes
        if not fs.sealed:
            # data region complete, footer missing: keep as open so the
            # re-seal pass below writes the footer.
            info.state = int(SegmentState.OPEN)
            ost = _OpenSegment(info, zns_cfg.block_bytes)
            fill_open_meta(ost)
            arr.open_segments[info.seg_id] = ost
            rec.cst = ost.cst
    else:
        info.state = int(SegmentState.OPEN)
        info.stripes_written = min(
            (rows.shape[0] for rows in fs.meta.values()), default=0
        )
        ost = _OpenSegment(info, zns_cfg.block_bytes)
        fill_open_meta(ost)
        arr.open_segments[info.seg_id] = ost
        rec.cst = ost.cst
    if info.uses_append:
        if rec.cst is None:
            rec.cst = CompactStripeTable(info.n_drives, info.n_stripes, info.group_size)
        for d, rows in fs.meta.items():
            rec.cst.record_many(
                d,
                np.arange(rows.shape[0]),
                rows["stripe"][:, 0].astype(np.int64) % info.group_size,
            )
        if info.seg_id in arr.open_segments:
            arr.open_segments[info.seg_id].cst = rec.cst


def _restore_open_slots(arr: ZapRAIDArray) -> None:
    """Re-adopt scanned open segments as the active write slots.

    Delegates to the array's degraded-aware rotation: open segments spanning
    exactly the active (healthy) drive set are reused in segment-id order;
    anything else -- including survivor-width segments once the drive set is
    healthy again -- is left in place and fresh segments open at the active
    width (``_rewiden`` relocates the narrow leftovers at the end)."""
    arr._rebuild_rotation()


def _harvest_meta(arr, fs: _FoundSegment, user_wins, map_wins) -> None:
    """Scalar harvest baseline: per-chunk/per-block loops into win dicts."""
    info = fs.info
    c = info.chunk_blocks
    scheme = arr._scheme_for(info)  # per-segment: widths may be mixed
    for d, rows_all in fs.meta.items():
        for chunk in range(rows_all.shape[0]):
            rows = rows_all[chunk]
            seq = int(rows["stripe"][0])
            if not fs.sealed and seq not in fs.complete_seqs:
                continue
            if scheme.drive_to_role(d, seq) >= scheme.k:
                continue  # parity chunk
            for b in range(c):
                lba_field = int(rows["lba"][b])
                if lba_field == int(INVALID_LBA):
                    continue
                ts = int(rows["ts"][b])
                pba = pack_pba(info.seg_id, d, info.data_start() + chunk * c + b)
                if lba_field & 1:
                    gid = lba_field >> 1
                    if gid not in map_wins or map_wins[gid][0] < ts:
                        map_wins[gid] = (ts, pba)
                else:
                    lba = lba_field >> 1
                    if lba >= arr.cfg.logical_blocks:
                        continue
                    if lba not in user_wins or user_wins[lba][0] < ts:
                        user_wins[lba] = (ts, pba)


def _harvest_meta_batched(arr, valid):
    """Vectorized harvest + winner resolution over every valid segment.

    Gathers one ``(lba_field, ts, pba)`` triple per live data-region block
    with numpy masks (complete-stripe filter, parity-role filter), then
    resolves the per-key winner with a single lexsort: latest ts wins, and
    among equal timestamps the first-encountered entry wins -- exactly the
    scalar dict's strict-greater update semantics."""
    fields, tss, pbas = [], [], []
    for fs in valid:
        info = fs.info
        scheme = arr._scheme_for(info)  # per-segment: widths may be mixed
        k = scheme.k
        c = info.chunk_blocks
        ds = info.data_start()
        comp = fs.complete_arr() if not fs.sealed else None
        for d, rows in fs.meta.items():
            seqs = rows["stripe"][:, 0].astype(np.int64)
            keep = scheme.drive_to_role_many(d, seqs) < k
            if comp is not None:
                keep &= np.isin(seqs, comp)
            ci = np.flatnonzero(keep)
            if ci.size == 0:
                continue
            f = rows["lba"][ci].ravel().astype(np.uint64)
            live = f != INVALID_LBA
            if not live.any():
                continue
            offs = (ds + ci[:, None] * c + np.arange(c)[None, :]).ravel()
            fields.append(f[live])
            tss.append(rows["ts"][ci].ravel().astype(np.int64)[live])
            pbas.append(pack_pba_many(info.seg_id, d, offs)[live])
    empty = np.zeros(0, np.int64)
    if not fields:
        return empty, empty, empty, empty, empty, empty
    f = np.concatenate(fields)
    t = np.concatenate(tss)
    p = np.concatenate(pbas)
    is_map = (f & np.uint64(1)) != 0
    keys = (f >> np.uint64(1)).astype(np.int64)
    um = ~is_map & (keys < arr.cfg.logical_blocks)
    u = _resolve_winners(keys[um], t[um], p[um])
    m = _resolve_winners(keys[is_map], t[is_map], p[is_map])
    return (*u, *m)


def _resolve_winners(keys, ts, pbas):
    """Latest-ts-wins per key; first-encountered wins ties."""
    if keys.size == 0:
        return keys, ts, pbas
    idx = np.arange(keys.size)
    order = np.lexsort((-idx, ts, keys))
    kk = keys[order]
    last = np.flatnonzero(np.r_[kk[1:] != kk[:-1], True])
    w = order[last]
    return keys[w], ts[w], pbas[w]


def _wins_arrays(wins: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Win dict -> (keys, ts, pbas) arrays (scalar harvest adapter)."""
    n = len(wins)
    keys = np.fromiter(wins.keys(), np.int64, n)
    ts = np.fromiter((v[0] for v in wins.values()), np.int64, n)
    pbas = np.fromiter((v[1] for v in wins.values()), np.int64, n)
    return keys, ts, pbas


def _reinject(
    arr, dirty, u_keys, u_ts, u_pbas, m_keys, m_ts, m_pbas, dirty_ids, drives
) -> set[int]:
    """Rewrite winning blocks whose only copy lives in a dirty segment."""
    by_seg: dict[int, _FoundSegment] = {fs.info.seg_id: fs for fs in dirty}
    reinjected_gids: set[int] = set()
    if not dirty_ids:
        return reinjected_gids

    def read_from_dirty(pba: int) -> np.ndarray:
        seg_id, d, off = unpack_pba(pba)
        fs = by_seg[seg_id]
        p = fs.info.drive_ids[d]  # d is the segment-member index
        return drives[p].read(fs.info.zone_ids[d], off, 1)[0].copy()

    dirty_arr = np.fromiter(sorted(dirty_ids), np.int64, len(dirty_ids))
    ud = np.flatnonzero(np.isin(unpack_pba_many(u_pbas)[0], dirty_arr))
    md = np.flatnonzero(np.isin(unpack_pba_many(m_pbas)[0], dirty_arr))
    items = [
        (int(u_ts[i]), int(u_keys[i]), int(u_pbas[i]), 0) for i in ud
    ] + [
        (int(m_ts[i]), int(m_keys[i]), int(m_pbas[i]), 1) for i in md
    ]
    items.sort()
    for ts, key, pba, is_map in items:
        payload = read_from_dirty(pba)
        arr.stats.recovery_blocks_read += 1
        if is_map:
            arr._append_block(arr._classify(1), -1, payload, ts, meta_gid=key)
            reinjected_gids.add(key)
        else:
            arr._append_block(arr._classify(1), key, payload, ts)
    return reinjected_gids


def _apply_wins(
    arr: ZapRAIDArray,
    u_keys, u_ts, u_pbas, m_keys, m_ts, m_pbas,
    dirty_ids, reinjected_gids,
) -> None:
    """Install the surviving winners: mapping table + bulk L2P (``set_many``)
    + bulk validity (``_mark_valid_many``), preserving the paper's stay-
    offloaded rule for entry groups whose mapping block is newest."""
    epg = arr.l2p.epg
    dirty_arr = (
        np.fromiter(sorted(dirty_ids), np.int64, len(dirty_ids))
        if dirty_ids else np.zeros(0, np.int64)
    )
    u_dirty = np.isin(unpack_pba_many(u_pbas)[0], dirty_arr)
    gids_of = u_keys // epg
    n_groups = arr.l2p.n_groups
    gmax = np.full(n_groups, -1, np.int64)
    ub = gids_of < n_groups
    np.maximum.at(gmax, gids_of[ub], u_ts[ub])
    # groups whose authoritative copy moved during re-injection: the on-SSD
    # mapping block is stale, so the group must stay resident
    dirty_winner_gids = set(np.unique(gids_of[u_dirty]).tolist())
    m_dirty = np.isin(unpack_pba_many(m_pbas)[0], dirty_arr)
    offloaded: list[int] = []
    map_installed: list[int] = []
    for i in range(m_keys.size):
        gid, mts, pba = int(m_keys[i]), int(m_ts[i]), int(m_pbas[i])
        if gid not in reinjected_gids and not m_dirty[i]:
            arr.mapping_table[gid] = pba
            map_installed.append(pba)
        if (
            arr.l2p.offload
            and mts >= (int(gmax[gid]) if gid < n_groups else -1)
            and gid not in dirty_winner_gids
            and gid not in reinjected_gids
        ):
            offloaded.append(gid)
    _mark_valid_many(arr, np.fromiter(map_installed, np.int64, len(map_installed)))
    off_arr = np.fromiter(offloaded, np.int64, len(offloaded))
    u_off = np.isin(gids_of, off_arr)
    install = ~u_dirty & ~u_off
    arr.l2p.set_many(u_keys[install], u_pbas[install])
    # dirty winners were re-injected (L2P points at the new copy already);
    # offloaded-group entries stay on the SSD but their blocks are live
    _mark_valid_many(arr, u_pbas[~u_dirty])
    for gid in offloaded:
        entries = arr._read_mapping_block(gid)
        if entries is None:
            continue
        live = np.asarray(entries, np.int64)
        _mark_valid_many(arr, live[live != int(NO_PBA)])
        arr.l2p.drop_group(gid)
    arr._drain_meta()


def _mark_valid_many(arr: ZapRAIDArray, pbas: np.ndarray) -> None:
    """Vectorized ``_mark_valid``: set validity bits + counts per segment."""
    pbas = np.unique(np.asarray(pbas, np.int64))
    if pbas.size == 0:
        return
    segs, drvs, offs = unpack_pba_many(pbas)
    for seg_id in np.unique(segs):
        rec = arr.segments.get(int(seg_id))
        if rec is None:
            continue
        sel = segs == seg_id
        didx = offs[sel] - rec.info.data_start()
        d = drvs[sel]
        inb = (didx >= 0) & (didx < rec.valid.shape[1])
        d, didx = d[inb], didx[inb]
        cur = rec.valid[d, didx]
        rec.valid[d, didx] = True
        rec.valid_count += int((~cur).sum())
