"""SPDK-style request pipeline (paper §4) over the ZapRAID array.

The paper decomposes request handling into seven handlers on SPDK threads:
dispatch, device I/O, completion, indexing, encoding, segment-state tracking,
and cleaning.  This module provides that decomposition in two modes:

**Synchronous mode** (``engine=None``) -- the original explicit event
pipeline over the functional array: each ``tick()`` drains one round of
events, stages execute inline, counters expose per-stage activity.

**Timed mode** (``engine=``:class:`repro_torch.sim.Engine`) -- the stages become
producers/consumers of *scheduled events* on a discrete-event engine:

  dispatch        -> fires at the request's arrival time; classifies writes,
                     fills in-flight stripes (functional), registers the
                     request as pending until its stripe persists
  encoding        -> accounted per committed stripe (CUDA parity path)
  device I/O      -> every Zone Write / Zone Append / read books service
                     time on the TimedDrive queues (one Zone Write in
                     flight per zone, qd<=4 Zone Appends per zone); group
                     commits get their completion *order* from the booked
                     times -- the fastest append wins the write pointer
  completion      -> write acks fire at the stripe's device completion
                     time (+ host CPU cost); reads at their device time
  indexing        -> L2P updates ride the commit event; acks call back
  segment state   -> group barriers are real waits (a group's appends
                     cannot start before the previous group fully landed);
                     the periodic examination maps to timeout flush ticks
  cleaning        -> GC runs inline on the same virtual timeline, its I/O
                     contending with foreground traffic on the drives

Latency attribution works through two array hooks (``commit_listener``,
``append_plan_fn``) rather than rewriting the functional array as
coroutines: state changes execute instantly, device time is booked forward,
and later events observe the bookings as queueing delay (see
``repro_torch.sim.engine``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.array import ZapRaidConfig, ZapRAIDArray
from repro_torch.core.zns import ZnsConfig


@dataclasses.dataclass
class Event:
    kind: str      # WRITE | READ | ENCODE | DEV_IO | COMPLETE | INDEX | SEAL | CLEAN
    payload: Any
    callback: Optional[Callable] = None


@dataclasses.dataclass
class _PendingWrite:
    """A submitted write waiting for its stripe(s) to persist."""

    tenant: str
    t_submit: float
    t_dispatch: float
    remaining: set          # lbas not yet durably committed
    callback: Optional[Callable]
    t_done: float = 0.0     # max device completion over covering stripes
    buffer_wait_us: float = 0.0
    device_us: float = 0.0


class HandlerPipeline:
    """Event-driven facade over ZapRAIDArray mirroring the paper's stages."""

    STAGES = ("dispatch", "encoding", "device_io", "completion",
              "indexing", "segment_state", "cleaning")

    def __init__(
        self,
        array: ZapRAIDArray,
        engine=None,
        recorder=None,
        flush_interval_us: float = 1000.0,
    ):
        self.array = array
        self.queues: dict[str, collections.deque] = {
            s: collections.deque() for s in self.STAGES
        }
        self.counters = {s: 0 for s in self.STAGES}
        self.completed: list[Any] = []
        self.engine = engine
        self.recorder = recorder
        self.flush_interval_us = flush_interval_us
        if engine is not None:
            if recorder is None:
                from repro_torch.sim.stats import LatencyRecorder
                self.recorder = LatencyRecorder()
            self.service = array.drives[0].service
            self._pending: dict[int, list[_PendingWrite]] = {}
            self._open_reqs = 0
            self._barriers: dict[int, float] = {}  # seg_id -> group-done time
            self._last_write_dispatch = 0.0
            # External work source (e.g. the block service's submission
            # queues): the timeout-flush tick keeps re-arming while it
            # reports work, so a drained submission queue still flushes
            # partially filled stripes (see ensure_flush_ticks).
            self.busy_hook: Optional[Callable[[], bool]] = None
            self._flush_tick_armed = False
            # Optional obs tracer (repro_torch.obs) -- see attach_obs.  None keeps
            # every hook site at a single attribute test.
            self.tracer = None
            self._obs_marks: dict[str, float] = {}
            array.commit_listener = self._on_stripe_commit
            array.encode_listener = self._on_group_encode
            if array.cfg.append_order == "timed":
                array.append_plan_fn = self._plan_group

    # -- construction ---------------------------------------------------------

    @classmethod
    def build_timed(
        cls,
        cfg: ZapRaidConfig,
        zns_cfg: ZnsConfig,
        *,
        engine=None,
        service=None,
        recorder=None,
        seed: int = 0,
        flush_interval_us: float = 1000.0,
    ) -> "HandlerPipeline":
        """Construct engine + timed drives + array + pipeline in one call.

        The array's codec runs on ``cfg.device`` (``"cuda"`` by default, which
        raises without a GPU); virtual time never depends on it."""
        from repro_torch.sim.device import make_timed_drives
        from repro_torch.sim.engine import Engine
        engine = engine or Engine()
        drives = make_timed_drives(
            cfg.n_drives, zns_cfg, engine, service=service, seed=seed
        )
        array = ZapRAIDArray(cfg, zns_cfg, drives=drives)
        return cls(array, engine=engine, recorder=recorder,
                   flush_interval_us=flush_interval_us)

    def attach_cache(self, cache) -> None:
        """Attach a ``repro_torch.cache.ZnsCacheTier`` to the array; in timed mode
        a :class:`~repro_torch.sim.device.TimedCacheDevice` is created on the
        engine so hits complete at cache-device latency on the virtual
        clock (their ``touch_io`` feeds the same ``io_watermark`` that
        prices drive reads)."""
        if self.engine is not None and cache.timed_dev is None:
            from repro_torch.sim.device import TimedCacheDevice
            cache.timed_dev = TimedCacheDevice(self.engine)
        self.array.attach_cache(cache)
        if self.tracer is not None:
            # a cache attached after attach_obs still gets instrumented
            cache.obs_event = self._on_obs_event
            if cache.timed_dev is not None:
                cache.timed_dev.tracer = self.tracer

    def attach_obs(self, tracer=None):
        """Install a :class:`repro_torch.obs.Tracer` across every layer.

        Wires the tracer into the drives (per-channel command spans), the
        cache device, and the array's ``obs_event`` hook (degraded decode,
        GC passes, cache lookups); the pipeline itself adds commit-barrier
        and rebuild spans.  Returns the tracer so callers can export.
        Detach by passing the same sites ``None`` -- or simply build a
        fresh pipeline: tracing-off pipelines never see these hooks.
        """
        assert self.engine is not None, "obs requires a timed pipeline"
        if tracer is None:
            from repro_torch.obs import Tracer
            tracer = Tracer(self.engine)
        self.tracer = tracer
        for d in self.array.drives:
            d.tracer = tracer
        self.array.obs_event = self._on_obs_event
        cache = self.array.cache
        if cache is not None:
            cache.obs_event = self._on_obs_event
            if cache.timed_dev is not None:
                cache.timed_dev.tracer = tracer
        return tracer

    def _on_obs_event(self, name: str, **args) -> None:
        """Adapter: array/cache instrumentation points -> tracer spans.

        Begin/end pairs (``gc.begin``/``gc.end``, ``degraded.begin``/
        ``degraded.end``) become spans from the begin instant to the I/O
        watermark at the end instant -- the window the pass's device
        bookings occupy; point events become instants on their track."""
        tr = self.tracer
        if tr is None:
            return
        eng = self.engine
        if name.endswith(".begin"):
            self._obs_marks[name[:-6]] = eng.now
            return
        if name.endswith(".end"):
            key = name[:-4]
            t0 = self._obs_marks.pop(key, eng.now)
            span_name = {
                "gc": "gc.pass",
                "degraded": "degraded.decode",
                "commit_narrow": "stripe.commit_narrow",
                "rewiden": "rebuild.rewiden",
                "scrub": "scrub.segment",
            }.get(key, key)
            tr.span("array", span_name, t0, max(t0, eng.io_watermark, eng.now),
                    cat="background", **args)
            return
        if name == "cache.lookup":
            tr.instant("cache", name, eng.now, **args)
        elif name == "cache.zone_reset":
            tr.instant("cache", name, eng.now, **args)
        else:
            tr.instant("array", name, eng.now, **args)

    # -- submission (application-facing, like the bdev layer) ---------------

    def submit_write(self, lba: int, data: np.ndarray, cb=None, *,
                     at: Optional[float] = None, tenant: str = "host"):
        if self.engine is None:
            self.queues["dispatch"].append(Event("WRITE", (lba, data), cb))
            return
        t = self.engine.now if at is None else at
        self._open_reqs += 1
        self.ensure_flush_ticks()
        # dispatch fires after the host-side submission cost; latency is
        # still measured from the arrival instant t
        self.engine.at(t + self.service.cpu_dispatch_us,
                       self._ev_write, lba, data, cb, tenant, t)

    def submit_read(self, lba: int, n_blocks: int = 1, cb=None, *,
                    at: Optional[float] = None, tenant: str = "host"):
        if self.engine is None:
            self.queues["dispatch"].append(Event("READ", (lba, n_blocks), cb))
            return
        t = self.engine.now if at is None else at
        self._open_reqs += 1
        self.ensure_flush_ticks()
        self.engine.at(t + self.service.cpu_dispatch_us,
                       self._ev_read, lba, n_blocks, cb, tenant, t)

    # -- timed-mode events ---------------------------------------------------

    def _ev_write(self, lba: int, data: np.ndarray, cb, tenant: str, t_submit: float):
        eng = self.engine
        self.counters["dispatch"] += 1
        self._last_write_dispatch = eng.now
        n = data.shape[0] if data.ndim == 2 else 1
        req = _PendingWrite(
            tenant=tenant, t_submit=t_submit, t_dispatch=eng.now,
            remaining=set(range(lba, lba + n)), callback=cb,
        )
        for l in req.remaining:
            self._pending.setdefault(l, []).append(req)
        self.recorder.notes["W_blocks"] = self.recorder.notes.get("W_blocks", 0) + n
        # functional write at the dispatch instant; commits triggered by it
        # (stripe fills, group barriers, GC) book device time forward and
        # resolve pending requests through the commit listener
        self.array.write(lba, data)

    def _ev_read(self, lba: int, n_blocks: int, cb, tenant: str, t_submit: float):
        eng = self.engine
        self.counters["dispatch"] += 1
        self.counters["device_io"] += 1
        mark = eng.mark_io()
        out = self.array.read(lba, n_blocks)
        t_dev = max(eng.io_watermark, eng.now)
        self.recorder.notes["R_blocks"] = self.recorder.notes.get("R_blocks", 0) + n_blocks
        eng.at(t_dev + self.service.cpu_complete_us, self._ev_read_done,
               lba, out, cb, tenant, t_submit, t_dev - mark)

    def _ev_read_done(self, lba, out, cb, tenant, t_submit, device_us):
        self.counters["completion"] += 1
        self.completed.append((lba, out))
        self.recorder.record(tenant, "R", t_submit, self.engine.now,
                             stages={"device_us": device_us})
        self._open_reqs -= 1
        if cb:
            cb(out)

    def _ev_write_done(self, req: _PendingWrite):
        self.counters["completion"] += 1
        self.counters["indexing"] += 1
        self.recorder.record(
            req.tenant, "W", req.t_submit, self.engine.now,
            stages={"buffer_wait_us": req.buffer_wait_us,
                    "device_us": req.device_us},
        )
        self._open_reqs -= 1
        if req.callback:
            req.callback(self.engine.now)

    def _ev_flush_tick(self):
        """Timeout path (paper: periodic in-flight examination): pad+commit
        staged stripes when no *write* has arrived for one interval (read
        traffic must not keep half-filled stripes pinned in the buffer)."""
        if self.engine.now - self._last_write_dispatch >= self.flush_interval_us:
            self.array.flush()
            self.counters["segment_state"] += 1
            self.array.maybe_gc()
            self.counters["cleaning"] += 1

    # -- self-rescheduling timeout flush (service tier / open-ended traffic) --

    def _busy(self) -> bool:
        """Work outstanding anywhere: dispatched requests still pending, or
        an attached front end (busy_hook) holding queued/scheduled work."""
        return self._open_reqs > 0 or bool(self.busy_hook and self.busy_hook())

    def ensure_flush_ticks(self) -> None:
        """Arm the periodic timeout-flush tick (idempotent).

        Unlike the fixed tick train ``replay`` used to pre-schedule over the
        arrival span, this tick *re-arms itself* for as long as the pipeline
        is busy -- including work that only exists in an attached service
        tier's submission queues, where no write has been dispatched yet.
        Without it, a dispatcher that drains its submission queue mid-stripe
        would leave the partial stripe staged forever: no further write
        arrives to fill it and no flush event exists to pad it.  The chain
        stops (and can be re-armed by the next submission) once the system
        is fully idle, so an idle timed pipeline schedules no events."""
        if self.engine is None or not self.flush_interval_us:
            return
        if self._flush_tick_armed:
            return
        self._flush_tick_armed = True
        self.engine.after(self.flush_interval_us, self._ev_flush_tick_auto)

    def _ev_flush_tick_auto(self) -> None:
        self._flush_tick_armed = False
        self._ev_flush_tick()
        if self._busy():
            self.ensure_flush_ticks()

    # -- array hooks (timed mode) -------------------------------------------

    def _plan_group(self, info, ops):
        """Zone-Append group planner: real barrier wait + timing-driven order."""
        from repro_torch.sim.device import plan_group_appends
        eng = self.engine
        barrier = self._barriers.get(info.seg_id, 0.0)
        floor = max(eng.now, barrier)
        if barrier > eng.now:
            self.recorder.note("group_barrier_wait_us", barrier - eng.now)
            if self.tracer is not None:
                self.tracer.span("array", "stripe.commit_barrier",
                                 eng.now, barrier, cat="commit",
                                 seg_id=info.seg_id)
        # ops index drives by segment-member position; map to the physical
        # drives the segment spans (identity when healthy, survivors when
        # the group was opened at degraded width)
        member_drives = [self.array.drives[p] for p in info.drive_ids]
        order, group_done = plan_group_appends(
            member_drives, info.zone_ids, ops, info.chunk_blocks, floor
        )
        self._barriers[info.seg_id] = group_done
        self.counters["segment_state"] += 1
        return order

    def _on_group_encode(self, info, n_stripes: int, host_us: float) -> None:
        """Encode-completion event from the device-resident datapath.

        The fused group encode runs on the accelerator while the committer
        prepares the drive payloads; the sync stall the committer actually
        paid (host wall time of the materialize) is threaded into the
        recorder -- ``notes["encode_sync_us"]`` totals the stall and
        ``note_counts["encode_sync_us"]`` counts the groups -- so timed-mode
        stats stay honest about codec cost.  Virtual
        time is untouched: with the timed pipeline attached, group commits
        are synchronous (the group barrier is already a sync point)."""
        # one note per group: notes["encode_sync_us"] accumulates the total
        # stall, note_counts["encode_sync_us"] counts encoded groups
        self.recorder.note("encode_sync_us", host_us)

    def _on_stripe_commit(self, info, built, per_drive_off):
        """Resolve pending writes covered by a just-persisted stripe."""
        eng = self.engine
        self.counters["encoding"] += 1
        self.counters["device_io"] += len(per_drive_off)
        t_done = eng.now
        for d, off in per_drive_off.items():
            # d is the segment-member index; translate to the physical drive
            t = self.array.drives[info.drive_ids[d]].chunk_completion(
                info.zone_ids[d], off)
            if t is not None and t > t_done:
                t_done = t
        for lba in built["lbas"].ravel():
            lba = int(lba)
            if lba < 0:
                continue
            reqs = self._pending.pop(lba, None)
            if not reqs:
                continue
            for req in reqs:
                req.t_done = max(req.t_done, t_done)
                req.buffer_wait_us = max(req.buffer_wait_us, eng.now - req.t_dispatch)
                req.device_us = max(req.device_us, t_done - eng.now)
                req.remaining.discard(lba)
                if not req.remaining:
                    eng.at(req.t_done + self.service.cpu_complete_us,
                           self._ev_write_done, req)

    # -- workload replay (timed mode) ---------------------------------------

    def replay(self, requests, payload_fn=None):
        """Replay a :mod:`repro_torch.sim.workload` request stream to completion.

        Writes carry deterministic pseudo-random payloads unless
        ``payload_fn(request) -> (n_blocks, block_bytes) uint8`` is given.
        Returns the latency recorder."""
        assert self.engine is not None, "replay requires a timed pipeline"
        bb = self.array.zns_cfg.block_bytes
        rng = np.random.default_rng(0xFEED)
        t_end = 0.0
        for r in requests:
            t_end = max(t_end, r.t_us)
            if r.op == "W":
                data = (payload_fn(r) if payload_fn else
                        rng.integers(0, 256, (r.n_blocks, bb), dtype=np.uint8))
                self.submit_write(r.lba, data, at=r.t_us, tenant=r.tenant)
            else:
                self.submit_read(r.lba, r.n_blocks, at=r.t_us, tenant=r.tenant)
        # the tick re-arms itself while requests are outstanding, so traffic
        # that queues past the last arrival still gets timeout flushes
        self.ensure_flush_ticks()
        self.drain()
        return self.recorder

    def precondition(self, writes) -> None:
        """Install media state outside the measured timeline.

        ``writes`` is an iterable of ``(lba, data)``.  The functional writes
        execute instantly, then every device-time booking -- and every
        recorder note / stage counter the warm-up produced -- is discarded,
        so the measured workload starts against a warm array on idle drives
        with clean stats."""
        assert self.engine is not None
        for lba, data in writes:
            self.array.write(lba, data)
        self.array.flush()
        for d in self.array.drives:
            d.reset_timing()
        cache = self.array.cache
        if cache is not None:
            # warm contents survive; timing and hit counters restart clean
            cache.reset_timing()
            cache.stats.reset()
        self._barriers.clear()
        rec = self.recorder
        rec.samples.clear()
        rec.stage_sums.clear()
        rec.stage_counts.clear()
        rec.tenant_stage_sums.clear()
        rec.tenant_stage_counts.clear()
        rec.notes.clear()
        rec.note_counts.clear()
        self.counters = {s: 0 for s in self.STAGES}
        if self.tracer is not None:
            # warm-up spans are not part of the measured window
            self.tracer.clear()
            self._obs_marks.clear()

    # -- failure/rebuild/GC actors (timed mode) -----------------------------

    def schedule_drive_failure(self, drive_idx: int, at: float) -> None:
        self.engine.at(at, self.array.fail_drive, drive_idx)

    def attach_faults(self, plan, *, seed: int = 0) -> "Any":
        """Arm a :class:`repro_torch.sim.faults.FaultPlan` on this pipeline's
        engine; returns the armed :class:`~repro_torch.sim.faults.FaultInjector`
        (its ``log`` records every fired event).  ``seed`` drives the
        injector's fire-time victim sampling for media faults."""
        from repro_torch.sim.faults import FaultInjector
        return FaultInjector(self, plan, seed=seed).arm()

    def schedule_rebuild(
        self, drive_idx: int, at: float, interval_us: float = 0.0
    ) -> None:
        """Full-drive rebuild as an engine actor contending for device time.

        With ``interval_us == 0`` the whole rebuild books at once (one burst
        of device traffic).  With ``interval_us > 0`` the rebuild is *paced*:
        open segments are reconstructed up front (they still take appends),
        then sealed segments one per tick, with every not-yet-rebuilt zone
        registered in the array's ``_rebuild_pending`` set so foreground
        reads route through reconstruction instead of returning the
        replacement drive's zeroed media."""
        if interval_us <= 0.0:
            self.engine.at(at, self._ev_rebuild, drive_idx)
        else:
            self.engine.at(at, self._ev_rebuild_start, drive_idx, interval_us)

    def _ev_rebuild(self, drive_idx: int) -> None:
        eng = self.engine
        mark = eng.mark_io()
        self.array.rebuild_drive(drive_idx)
        self.recorder.note("rebuild_device_us", max(0.0, eng.io_watermark - mark))
        if self.tracer is not None:
            self.tracer.span("array", "rebuild.full", eng.now,
                             max(eng.now, eng.io_watermark),
                             cat="background", drive=drive_idx)

    def _ev_rebuild_start(self, drive_idx: int, interval_us: float) -> None:
        arr = self.array
        eng = self.engine
        mark = eng.mark_io()
        arr._sync_pending()
        arr.drives[drive_idx].replace()
        scaffold: dict = {}
        sealed = []  # (seg_id, member index of the replaced drive)
        for rec in sorted(arr.segments.values(), key=lambda r: r.info.seg_id):
            if drive_idx not in rec.info.drive_ids:
                # survivor-width segment written while the drive was failed;
                # the final re-widening pass relocates it
                continue
            if rec.info.seg_id in arr.open_segments:
                # open segments take new appends between ticks, so their
                # zones must be whole before foreground writes resume
                arr._rebuild_segment(rec, drive_idx, scaffold)
            else:
                member = rec.info.drive_ids.index(drive_idx)
                arr._rebuild_pending.add((rec.info.seg_id, member))
                sealed.append((rec.info.seg_id, member))
        self.recorder.note("rebuild_device_us", max(0.0, eng.io_watermark - mark))
        if sealed:
            eng.at(eng.now + interval_us, self._ev_rebuild_step,
                   drive_idx, sealed, 0, interval_us, scaffold)
        else:
            eng.at(eng.now + interval_us, self._ev_rewiden)

    def _ev_rebuild_step(
        self, drive_idx: int, sealed: list, i: int, interval_us: float, scaffold: dict
    ) -> None:
        arr = self.array
        eng = self.engine
        seg_id, member = sealed[i]
        rec = arr.segments.get(seg_id)
        if rec is not None:
            mark = eng.mark_io()
            arr._rebuild_segment(rec, drive_idx, scaffold)
            self.recorder.note("rebuild_device_us", max(0.0, eng.io_watermark - mark))
            if self.tracer is not None:
                self.tracer.span("array", "rebuild.segment", eng.now,
                                 max(eng.now, eng.io_watermark),
                                 cat="background", drive=drive_idx,
                                 seg_id=seg_id)
        else:
            # the segment was GC'd while pending; nothing left to rebuild
            arr._rebuild_pending.discard((seg_id, member))
        self.counters["segment_state"] += 1
        if i + 1 < len(sealed):
            eng.at(eng.now + interval_us, self._ev_rebuild_step,
                   drive_idx, sealed, i + 1, interval_us, scaffold)
        else:
            # every zone is whole again: relocate survivor-width segments
            # back to full width on the rebuilt drive set
            eng.at(eng.now + interval_us, self._ev_rewiden)

    def _ev_rewiden(self) -> None:
        arr = self.array
        eng = self.engine
        # No mark_io() here: this actor fires *after* the last rebuild step,
        # and resetting the shared watermark then would let the final
        # rebuild.segment span outrun the run's max(now, io_watermark) bound.
        before = max(eng.now, eng.io_watermark)
        arr._rewiden()
        self.recorder.note("rebuild_device_us", max(0.0, eng.io_watermark - before))

    def schedule_gc(
        self,
        at: float,
        interval_us: float,
        n_ticks: int = 1,
        watermark: Optional[int] = None,
    ) -> None:
        """Rate-limited background-GC actor: every ``interval_us`` run at
        most one ``gc_once`` pass while free segments sit below
        ``watermark`` (default: one above the array's inline-GC trigger, so
        the actor cleans *proactively* and the write path rarely stalls on
        an inline GC burst).  Collection and restage book device time on the
        timed drives, so foreground tail latency under GC pressure becomes a
        measurable QoS figure (``notes["gc_device_us"]`` totals the actor's
        device traffic, ``note_counts`` its runs)."""
        if watermark is None:
            watermark = self.array.cfg.gc_free_segments_low + 1
        self.engine.at(at, self._ev_gc_tick, interval_us, n_ticks, watermark)

    def _ev_gc_tick(self, interval_us: float, remaining: int, watermark: int) -> None:
        arr = self.array
        eng = self.engine
        if arr.free_segment_count() < watermark:
            mark = eng.mark_io()
            arr.gc_once()
            self.counters["cleaning"] += 1
            self.recorder.note("gc_device_us", max(0.0, eng.io_watermark - mark))
        if remaining > 1:
            eng.at(eng.now + interval_us, self._ev_gc_tick,
                   interval_us, remaining - 1, watermark)

    def schedule_scrub(
        self,
        at: float,
        interval_us: float,
        n_passes: int = 1,
        yield_to_foreground: bool = True,
    ) -> None:
        """Paced background-scrub actor: walk every sealed segment, one per
        ``interval_us`` tick, bulk-verifying its zones against the checksum
        store and repairing detected faults through parity
        (:meth:`ZapRAIDArray.scrub_segment`).  Each step's gathers and
        repair writes book device time on the timed drives, so scrub
        traffic contends with foreground I/O the same way GC and rebuild
        do; with ``yield_to_foreground`` a tick that finds requests in
        flight defers its segment to the next tick instead of stealing
        device time from them.  ``notes["scrub_device_us"]`` totals the
        actor's device traffic.  ``n_passes`` whole-array passes run
        back to back (each re-snapshots the sealed set)."""
        self.engine.at(at, self._ev_scrub_start,
                       interval_us, n_passes, yield_to_foreground)

    def _ev_scrub_start(
        self, interval_us: float, remaining: int, yield_fg: bool
    ) -> None:
        from repro_torch.core.segment import SegmentState
        arr = self.array
        arr._sync_pending()
        sealed = sorted(
            sid for sid, rec in arr.segments.items()
            if rec.info.state == int(SegmentState.SEALED)
        )
        if sealed:
            self._ev_scrub_step(sealed, 0, interval_us, remaining, yield_fg)
        else:
            arr.stats.integrity_scrub_passes += 1
            if remaining > 1:
                self.engine.at(self.engine.now + interval_us,
                               self._ev_scrub_start,
                               interval_us, remaining - 1, yield_fg)

    def _ev_scrub_step(
        self, sealed: list, i: int, interval_us: float, remaining: int,
        yield_fg: bool,
    ) -> None:
        from repro_torch.core.segment import SegmentState
        arr = self.array
        eng = self.engine
        if yield_fg and self._open_reqs > 0:
            # foreground requests in flight: give them the device and try
            # this segment again next tick
            eng.at(eng.now + interval_us, self._ev_scrub_step,
                   sealed, i, interval_us, remaining, yield_fg)
            return
        seg_id = sealed[i]
        rec = arr.segments.get(seg_id)
        if rec is not None and rec.info.state == int(SegmentState.SEALED):
            mark = eng.mark_io()
            arr.scrub_segment(seg_id)
            self.counters["cleaning"] += 1
            self.recorder.note("scrub_device_us",
                               max(0.0, eng.io_watermark - mark))
        if i + 1 < len(sealed):
            eng.at(eng.now + interval_us, self._ev_scrub_step,
                   sealed, i + 1, interval_us, remaining, yield_fg)
        else:
            arr.stats.integrity_scrub_passes += 1
            if remaining > 1:
                eng.at(eng.now + interval_us, self._ev_scrub_start,
                       interval_us, remaining - 1, yield_fg)

    # -- stages (synchronous mode) ------------------------------------------

    def _dispatch(self, ev: Event):
        if ev.kind == "WRITE":
            lba, data = ev.payload
            # classification + in-flight stripe fill; the array emits the
            # encode+device-io work inline (synchronous simulator), which we
            # account to the downstream stages.
            self.array.write(lba, data)
            self.counters["encoding"] += 1
            self.counters["device_io"] += 1
            self.queues["indexing"].append(Event("INDEX", ("ack", lba), ev.callback))
        else:
            lba, n = ev.payload
            self.queues["device_io"].append(Event("DEV_IO", ("read", lba, n), ev.callback))

    def _device_io(self, ev: Event):
        op = ev.payload[0]
        if op == "read":
            _, lba, n = ev.payload
            out = self.array.read(lba, n)
            self.queues["completion"].append(Event("COMPLETE", (lba, out), ev.callback))

    def _completion(self, ev: Event):
        lba, out = ev.payload
        self.completed.append((lba, out))
        if ev.callback:
            ev.callback(out)

    def _indexing(self, ev: Event):
        kind, lba = ev.payload
        if ev.callback:
            ev.callback(lba)

    def _segment_state(self):
        # group barriers / sealing are folded into the array's commit path;
        # the periodic examination (paper: every 1us) maps to this tick.
        self.array.flush()

    def _cleaning(self):
        self.array.maybe_gc()

    # -- scheduler -----------------------------------------------------------

    def tick(self, flush: bool = False) -> int:
        """Drain one round of events (one 'poll loop' iteration)."""
        if self.engine is not None:
            return self.engine.run()
        n = 0
        for stage, fn in (
            ("dispatch", self._dispatch),
            ("device_io", self._device_io),
            ("completion", self._completion),
            ("indexing", self._indexing),
        ):
            q = self.queues[stage]
            for _ in range(len(q)):
                fn(q.popleft())
                self.counters[stage] += 1
                n += 1
        if flush:
            self._segment_state()
            self.counters["segment_state"] += 1
            self._cleaning()
            self.counters["cleaning"] += 1
        return n

    def drain(self) -> None:
        if self.engine is not None:
            eng = self.engine
            eng.run()
            for _ in range(64):
                if not self._open_reqs:
                    break
                # quiesce: timeout-flush whatever is still staged, then let
                # the resulting ack events fire
                self.array.flush()
                self.counters["segment_state"] += 1
                self.array.maybe_gc()
                self.counters["cleaning"] += 1
                eng.run()
            assert not self._open_reqs, "timed drain left unresolved requests"
            return
        while self.tick():
            pass
        self.tick(flush=True)
