"""ZapRAID-backed checkpoint engine.

The paper's log-structured RAID becomes the trainer's checkpoint substrate:

* every training-state leaf is serialized into 4 KiB blocks and streamed
  through a ``ZapRAIDArray`` whose *drives* model independent storage lanes
  (one per failure domain -- a host, a pod's NVMe set, ...);
* checkpoints are erasure-coded (RAID-5/6) across lanes at write time by the
  codec's XOR/GF(256) kernels (CUDA on ``device="cuda"``, their plain torch
  versions on ``"cpu"``), so losing up to m lanes still restores --
  ``restore`` transparently takes the degraded-read path of §3.5;
* checkpoints are *log-structured*: a new save appends; old checkpoints
  become stale blocks reclaimed by the array's GC -- exactly the paper's
  workload;
* Zone-Append group commits let the k+m lane writers complete out of order
  inside each stripe group (the paper's §3.2 insight), with the compact
  stripe table absorbing the disorder -- the checkpoint writer never issues
  a cross-lane barrier except at group boundaries;
* a small manifest (step -> leaf extents) is kept in memory and serialized
  into the log itself under reserved LBAs, so ``CheckpointEngine.attach``
  can mount an existing array after a crash (crash consistency inherited
  from §3.4 recovery).

The state is any nesting of dicts, lists and tuples over tensors, numpy
arrays and Python scalars.  It is flattened in the JAX package's order and
named as there (``checkpoint/_tree.py``), so the same state puts the same
bytes on the media and the same manifest in the log.  A restored leaf is a
tensor of the manifest's dtype on the device of the ``like`` leaf, or a numpy
array where ``like`` holds one.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _tree
from repro_torch.core.array import ZapRaidConfig, ZapRAIDArray
from repro_torch.core.raid import check_device
from repro_torch.core.recovery import recover_array
from repro_torch.core.zns import ZnsConfig

MANIFEST_LBAS = 64  # reserved logical region for the manifest


@dataclasses.dataclass
class CheckpointConfig:
    n_lanes: int = 4
    scheme: str = "raid5"
    group_size: int = 16
    chunk_blocks: int = 4
    block_bytes: int = 4096
    zone_cap_blocks: int = 4096
    n_zones: int = 64
    keep_last: int = 2
    # the device the lanes' stripe codec runs on: "cuda" launches the CUDA
    # kernels (raising without a GPU), "cpu" runs their plain versions
    device: str = "cuda"

    def __post_init__(self) -> None:
        check_device(self.device)

    def zap_cfg(self, logical_blocks: int) -> ZapRaidConfig:
        return ZapRaidConfig(
            scheme=self.scheme,
            n_drives=self.n_lanes,
            group_size=self.group_size,
            chunk_blocks=self.chunk_blocks,
            logical_blocks=logical_blocks,
            gc_free_segments_low=2,
            device=self.device,
        )

    def zns_cfg(self) -> ZnsConfig:
        return ZnsConfig(
            n_zones=self.n_zones,
            zone_cap_blocks=self.zone_cap_blocks,
            block_bytes=self.block_bytes,
        )


def _restore_leaf(blocks: np.ndarray, ent: dict, like) -> Any:
    """A leaf rebuilt from its extent's blocks and manifest entry."""
    raw = torch.from_numpy(blocks.reshape(-1)[: ent["nbytes"]])
    return _tree.leaf_from_bytes(raw, ent["dtype"], ent["shape"], like)


@dataclasses.dataclass
class SaveTicket:
    """Future for an async (service-tier) checkpoint save."""

    step: int
    t_issue: float
    manifest: dict
    n_extents: int
    done: bool = False
    t_done: float = math.nan
    cb: Optional[Callable[["SaveTicket"], None]] = None

    @property
    def latency_us(self) -> float:
        return self.t_done - self.t_issue


@dataclasses.dataclass
class RestoreTicket:
    """Future for an async (service-tier) checkpoint restore."""

    step: int
    t_issue: float
    n_extents: int
    done: bool = False
    t_done: float = math.nan
    state: Any = None
    cb: Optional[Callable[["RestoreTicket"], None]] = None

    @property
    def latency_us(self) -> float:
        return self.t_done - self.t_issue


class CheckpointEngine:
    def __init__(
        self,
        cfg: CheckpointConfig,
        logical_blocks: int = 1 << 14,
        *,
        array: Optional[ZapRAIDArray] = None,
        lba_base: int = 0,
        lba_span: Optional[int] = None,
    ):
        """``array`` lets many engines share one volume (e.g. the timed
        array behind a block service), each confined to its own logical
        window ``[lba_base, lba_base + lba_span)`` with its manifest at
        ``lba_base`` -- the many-training-jobs layout."""
        self.cfg = cfg
        self.logical_blocks = logical_blocks
        self.array = array if array is not None else ZapRAIDArray(
            cfg.zap_cfg(logical_blocks), cfg.zns_cfg()
        )
        self.lba_base = lba_base
        self.lba_span = logical_blocks - lba_base if lba_span is None else lba_span
        assert self.lba_span > MANIFEST_LBAS, "window too small for a manifest"
        assert self.lba_base + self.lba_span <= logical_blocks
        self.catalog: dict[int, dict] = {}  # step -> manifest
        self._alloc_ptr = lba_base + MANIFEST_LBAS  # bump allocator, ring
        self.saves = 0

    @classmethod
    def build_timed(
        cls,
        cfg: CheckpointConfig,
        logical_blocks: int = 1 << 14,
        *,
        seed: int = 0,
        flush_interval_us: float = 1000.0,
        **engine_kw,
    ):
        """Checkpoint engine over a discrete-event timed pipeline.

        Returns ``(ckpt, pipe)``; wrap ``pipe`` in a
        :class:`repro_torch.service.BlockDeviceService` and use
        :meth:`save_async`/:meth:`restore_async` to stream checkpoints as
        admission-controlled tenant traffic."""
        from repro_torch.core.handlers import HandlerPipeline

        pipe = HandlerPipeline.build_timed(
            cfg.zap_cfg(logical_blocks), cfg.zns_cfg(), seed=seed,
            flush_interval_us=flush_interval_us, **engine_kw,
        )
        return cls(cfg, logical_blocks, array=pipe.array), pipe

    # ------------------------------------------------------------- space

    def _alloc(self, n_blocks: int) -> int:
        lo = self.lba_base + MANIFEST_LBAS
        hi = self.lba_base + self.lba_span
        if self._alloc_ptr + n_blocks > hi:
            self._alloc_ptr = lo  # wrap: old extents become stale
        lba = self._alloc_ptr
        self._alloc_ptr += n_blocks
        return lba

    # ------------------------------------------------------------- save

    def _ensure_lanes(self) -> None:
        """Hot-spare semantics: *writes* require all lanes, so a failed lane
        is rebuilt (replacement drive + §3.5 full-drive recovery) before a
        save.  *Reads* never need this -- restore() runs degraded."""
        for i, d in enumerate(self.array.drives):
            if d.failed:
                self.array.rebuild_drive(i)

    def _stage_save(self, step: int, state) -> tuple[dict, list[tuple[int, np.ndarray]]]:
        """Serialize ``state`` into block extents: allocation + packing,
        shared by the sync and async save paths."""
        bb = self.cfg.block_bytes
        leaves, _ = _tree.flatten_with_path(state)
        manifest = {"step": step, "leaves": {}}
        extents: list[tuple[int, np.ndarray]] = []
        for name, leaf in leaves:
            dtype, shape, _ = _tree.leaf_meta(leaf)
            flat = _tree.host_bytes(leaf)
            n_blocks = max(1, -(-flat.size // bb))
            lba = self._alloc(n_blocks)
            buf = np.zeros((n_blocks, bb), np.uint8)
            buf.reshape(-1)[: flat.size] = flat
            extents.append((lba, buf))
            manifest["leaves"][name] = {
                "lba": lba,
                "n_blocks": n_blocks,
                "nbytes": int(flat.size),
                "dtype": dtype,
                "shape": shape,
            }
        return manifest, extents

    def save(self, step: int, state) -> dict:
        """Append a checkpoint for ``step``; returns its manifest."""
        self._ensure_lanes()
        manifest, extents = self._stage_save(step, state)
        for lba, buf in extents:
            self.array.write(lba, buf)
        self.array.flush()
        self.catalog[step] = manifest
        self._write_manifest()
        self.saves += 1
        self._retire_old()
        return manifest

    def _manifest_blocks(self) -> np.ndarray:
        bb = self.cfg.block_bytes
        blob = json.dumps(self.catalog).encode()
        n_blocks = -(-len(blob) // (bb - 8))
        assert n_blocks <= MANIFEST_LBAS, "manifest too large for reserved region"
        buf = np.zeros((n_blocks, bb), np.uint8)
        header = np.frombuffer(
            np.int64(len(blob)).tobytes() , np.uint8
        )
        flat = np.frombuffer(blob, np.uint8)
        buf[0, :8] = header
        rest = buf.reshape(-1)[8:]
        rest[: flat.size] = flat
        return buf

    def _write_manifest(self) -> None:
        self.array.write(self.lba_base, self._manifest_blocks())
        self.array.flush()

    # ------------------------------------------------- async (service tier)

    def save_async(self, step: int, state, *, service, tenant: str = "ckpt",
                   at: Optional[float] = None, cb=None) -> SaveTicket:
        """Stream a checkpoint through a block service as tenant traffic.

        One write request per leaf extent enters the tenant's submission
        queue (subject to its QoS class: token bucket, queue cap, in-flight
        share); the manifest is submitted only after *every* extent has
        acked, preserving the crash-ordering invariant of the sync path
        (a manifest never points at unwritten extents).  The returned
        ticket resolves at the manifest's device-completion time.

        Unlike :meth:`save`, failed lanes are not rebuilt inline -- in the
        timed world a rebuild is an engine actor
        (``HandlerPipeline.schedule_rebuild``), not a synchronous call."""
        manifest, extents = self._stage_save(step, state)
        self.catalog[step] = manifest
        self.saves += 1
        self._retire_old()
        mblocks = self._manifest_blocks()
        ticket = SaveTicket(
            step=step,
            t_issue=service.engine.now if at is None else at,
            manifest=manifest, n_extents=len(extents), cb=cb,
        )
        remaining = [len(extents)]

        def manifest_done(req) -> None:
            ticket.done = True
            ticket.t_done = req.t_done
            if ticket.cb:
                ticket.cb(ticket)

        def leaf_done(_req) -> None:
            remaining[0] -= 1
            if remaining[0] == 0:
                service.submit_write(tenant, self.lba_base, mblocks,
                                     cb=manifest_done)

        if not extents:
            service.submit_write(tenant, self.lba_base, mblocks, at=at,
                                 cb=manifest_done)
        for lba, buf in extents:
            service.submit_write(tenant, lba, buf, at=at, cb=leaf_done)
        return ticket

    def restore_async(self, step: int, like, *, service, tenant: str = "ckpt",
                      at: Optional[float] = None, cb=None) -> RestoreTicket:
        """Async restore: one read request per leaf extent; the ticket
        resolves (with ``.state`` holding the rebuilt pytree) when the last
        read acks.  Degraded lanes restore transparently -- the reads take
        the array's reconstruction path and simply book more device time."""
        manifest = self.catalog.get(step)
        if manifest is None:
            raise KeyError(f"no checkpoint for step {step}")
        flat, treedef = _tree.flatten_with_path(like)
        entries = [manifest["leaves"][name] for name, _ in flat]
        results: list[Any] = [None] * len(entries)
        ticket = RestoreTicket(
            step=step,
            t_issue=service.engine.now if at is None else at,
            n_extents=len(entries), cb=cb,
        )
        remaining = [len(entries)]

        def leaf_done(idx: int, ent: dict, req) -> None:
            results[idx] = _restore_leaf(req.result, ent, flat[idx][1])
            remaining[0] -= 1
            if remaining[0] == 0:
                ticket.state = _tree.unflatten(treedef, results)
                ticket.done = True
                ticket.t_done = req.t_done
                if ticket.cb:
                    ticket.cb(ticket)

        for idx, ent in enumerate(entries):
            service.submit_read(
                tenant, ent["lba"], ent["n_blocks"], at=at,
                cb=lambda req, i=idx, e=ent: leaf_done(i, e, req),
            )
        return ticket

    def _retire_old(self) -> None:
        steps = sorted(self.catalog)
        for s in steps[: -self.cfg.keep_last]:
            del self.catalog[s]
        # stale extents are reclaimed lazily by array GC on overwrite

    # ------------------------------------------------------------ restore

    def restore(self, step: int, like) -> Any:
        """Rebuild the state pytree for ``step`` (``like`` supplies the tree
        structure).  Works identically with failed lanes (degraded reads)."""
        manifest = self.catalog.get(step)
        if manifest is None:
            raise KeyError(f"no checkpoint for step {step}")
        flat, treedef = _tree.flatten_with_path(like)
        out = []
        for name, leaf in flat:
            ent = manifest["leaves"][name]
            blocks = self.array.read(ent["lba"], ent["n_blocks"])
            out.append(_restore_leaf(blocks, ent, leaf))
        return _tree.unflatten(treedef, out)

    # -------------------------------------------------------- fault paths

    def fail_lane(self, lane: int) -> None:
        self.array.fail_drive(lane)

    def rebuild_lane(self, lane: int) -> None:
        self.array.rebuild_drive(lane)

    def crash_and_remount(self) -> "CheckpointEngine":
        """Simulate a host crash: recover the array from the drives and
        re-read the manifest from the log."""
        drives = self.array.drives
        new = CheckpointEngine.__new__(CheckpointEngine)
        new.cfg = self.cfg
        new.logical_blocks = self.logical_blocks
        new.array = recover_array(
            drives, self.cfg.zap_cfg(self.logical_blocks), self.cfg.zns_cfg()
        )
        new.lba_base = self.lba_base
        new.lba_span = self.lba_span
        new.catalog = {}
        new._alloc_ptr = self.lba_base + MANIFEST_LBAS
        new.saves = 0
        new._load_manifest()
        return new

    def _load_manifest(self) -> None:
        bb = self.cfg.block_bytes
        first = self.array.read(self.lba_base, 1)
        size = int(np.frombuffer(first[0, :8].tobytes(), np.int64)[0])
        if size <= 0 or size > MANIFEST_LBAS * bb:
            return  # no manifest yet
        n_blocks = -(-(size + 8) // bb)
        blocks = self.array.read(self.lba_base, n_blocks)
        blob = blocks.reshape(-1)[8 : 8 + size].tobytes()
        raw = json.loads(blob)
        self.catalog = {int(k): v for k, v in raw.items()}
        if self.catalog:
            last = max(
                e["lba"] + e["n_blocks"]
                for m in self.catalog.values()
                for e in m["leaves"].values()
            )
            self._alloc_ptr = max(self.lba_base + MANIFEST_LBAS, last)

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        s = self.array.stats
        return {
            "saves": self.saves,
            "device_blocks_written": s.device_blocks_written,
            "write_amp": s.write_amp(),
            "gc_runs": s.gc_runs,
            "degraded_reads": s.degraded_reads,
        }
