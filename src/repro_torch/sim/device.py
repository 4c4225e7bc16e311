"""Timed ZNS drives: per-zone command queues over the functional simulator.

``TimedDrive`` subclasses :class:`repro_torch.core.zns.SimZnsDrive`, so the media
state (data, OOB, write pointers, crash budget) stays exactly the functional
model's; what it adds is *device-time accounting* on every command:

* **Zone Write** -- one in-flight command per zone (§2.1): a write to zone z
  cannot start before the previous write to z completed;
* **Zone Append** -- up to ``append_qd`` (default 4, the ZN540 saturation
  point) commands in flight per zone; per-command service time grows with
  the in-flight depth exactly as the calibrated throughput curve dictates;
* **reads** -- contend with writes for the drive's internal channels;
* **channels** -- every command additionally occupies one of ``n_channels``
  per-drive servers, so heavy writes (GC, rebuild) delay reads and vice
  versa -- the mechanism behind the GC-cliff and degraded-read-under-load
  tails.

Service times are sampled from :mod:`repro_torch.core.perfmodel` means with
multiplicative lognormal jitter from a per-drive seeded RNG.  The jitter is
what makes Zone-Append completion *disorder* emerge from timing: the
fastest command of a batch wins the write pointer (see
``plan_group_appends``), replacing the seeded RNG permutation the functional
array uses standalone.

Bookings are pure arithmetic over floats -- the functional operation itself
executes instantly (see ``repro_torch.sim.engine`` module docstring) -- so a
``TimedDrive`` behaves identically to a ``SimZnsDrive`` as far as every
existing test and recovery path is concerned.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core import perfmodel as pm
from repro_torch.core.zns import CrashBudget, SimZnsDrive, ZnsConfig
from repro_torch.sim.engine import Engine


@dataclasses.dataclass
class ServiceModel:
    """Per-command service-time distribution parameters."""

    block_bytes: int
    n_channels: int = 4      # internal parallelism shared by reads and writes
    append_qd: int = 4       # max in-flight Zone Appends per zone (ZN540 §2.2)
    read_cmd_max_blocks: int = 8   # a gather splits into commands of this size
    jitter_sigma: float = 0.18  # lognormal sigma on every sampled service time
    cpu_dispatch_us: float = 0.7   # host-side cost arrival -> device submission
    cpu_complete_us: float = 0.5   # host-side completion/callback cost

    def _kib(self, n_blocks: int) -> float:
        return n_blocks * self.block_bytes / 1024.0

    def zone_write_us(self, n_blocks: int) -> float:
        return pm.zone_write_cmd_latency_us(self._kib(n_blocks))

    def zone_append_us(self, n_blocks: int, qd: int) -> float:
        return pm.zone_append_cmd_latency_us(self._kib(n_blocks), qd)

    def read_us(self, n_blocks: int) -> float:
        return pm.read_cmd_latency_us(self._kib(n_blocks))


class TimedDrive(SimZnsDrive):
    """A ``SimZnsDrive`` whose commands occupy virtual device time."""

    def __init__(
        self,
        cfg: ZnsConfig,
        drive_id: int,
        budget: Optional[CrashBudget] = None,
        *,
        engine: Engine,
        service: ServiceModel,
        seed: int = 0,
    ):
        super().__init__(cfg, drive_id, budget)
        self.engine = engine
        self.service = service
        self.jitter_rng = np.random.default_rng(seed)
        # Optional repro_torch.obs.Tracer: every booked command emits a span on
        # this drive's track.  None (the default) costs one attribute test.
        self.tracer = None
        self._trace_track = f"drive{drive_id}"
        self.reset_timing()

    def reset_timing(self) -> None:
        """Discard all queue/channel bookings (fresh hardware at ``now``)."""
        now = self.engine.now
        self.t_zone_free = np.full(self.cfg.n_zones, now)   # Zone Write: 1/zone
        self.za_slots: dict[int, list[float]] = {}          # Zone Append: qd/zone
        self.channels = [now] * self.service.n_channels
        self._planned: dict[int, deque] = {}                # pre-planned append times
        self.chunk_done: dict[tuple[int, int], float] = {}  # (zone, off) -> t_done
        self.busy_us = 0.0                                  # total service time booked

    # -- booking arithmetic -------------------------------------------------

    def _jitter(self) -> float:
        return float(np.exp(self.jitter_rng.normal(0.0, self.service.jitter_sigma)))

    def _grab_channel(self, floor: float) -> float:
        """Earliest start >= floor with a free channel; caller books the end."""
        i = int(np.argmin(self.channels))
        return max(floor, self.channels[i])

    def _book_channel(self, t_done: float) -> None:
        i = int(np.argmin(self.channels))
        self.channels[i] = t_done

    def book_zone_write(self, zone: int, n_blocks: int, floor: float) -> float:
        """Book one Zone Write command; returns its completion time."""
        start = self._grab_channel(max(floor, float(self.t_zone_free[zone])))
        svc = self.service.zone_write_us(n_blocks) * self._jitter()
        done = start + svc
        self.t_zone_free[zone] = done
        self._book_channel(done)
        self.busy_us += svc
        self.engine.touch_io(done)
        if self.tracer is not None:
            self.tracer.span(self._trace_track, "zone_write", start, done,
                             zone=zone, n_blocks=n_blocks)
        return done

    def book_append(self, zone: int, n_blocks: int, floor: float) -> float:
        """Book one Zone Append command; returns its completion time.

        At most ``append_qd`` appends are in flight per zone: when the slots
        are full the command waits for the earliest one to retire.  The
        sampled service time depends on how many siblings are still in
        flight at start (the intra-zone-parallelism curve)."""
        slots = self.za_slots.setdefault(zone, [])
        start = self._grab_channel(floor)
        busy = sorted(s for s in slots if s > start)
        if len(busy) >= self.service.append_qd:
            start = busy[len(busy) - self.service.append_qd]
            busy = [s for s in busy if s > start]
        qd_now = len(busy) + 1
        svc = self.service.zone_append_us(n_blocks, qd_now) * self._jitter()
        done = start + svc
        busy.append(done)
        self.za_slots[zone] = busy[-self.service.append_qd:]
        self._book_channel(done)
        self.busy_us += svc
        self.engine.touch_io(done)
        if self.tracer is not None:
            self.tracer.span(self._trace_track, "zone_append", start, done,
                             zone=zone, n_blocks=n_blocks, qd=qd_now)
        return done

    def book_read(self, n_blocks: int, floor: float) -> float:
        """Book a read of ``n_blocks`` (channel contention; no wp ordering).

        Large gathers (GC valid-block sweeps, rebuild survivor reads) split
        into commands of at most ``read_cmd_max_blocks`` -- each pays the
        NAND access cost, so a whole-zone gather occupies real device time
        instead of amortizing away into one cheap command.  The commands
        fan out across the free channels like a real scatter-read."""
        max_b = max(1, self.service.read_cmd_max_blocks)
        done = floor
        remaining = n_blocks
        while remaining > 0:
            nb = min(remaining, max_b)
            start = self._grab_channel(floor)
            svc = self.service.read_us(nb) * self._jitter()
            t = start + svc
            self._book_channel(t)
            self.busy_us += svc
            done = max(done, t)
            remaining -= nb
            if self.tracer is not None:
                self.tracer.span(self._trace_track, "read", start, t,
                                 n_blocks=nb)
        self.engine.touch_io(done)
        return done

    def plan_completion(self, zone: int, t_done: float) -> None:
        """Queue a pre-planned append completion time (see plan_group_appends)."""
        self._planned.setdefault(zone, deque()).append(t_done)

    def clear_planned(self) -> None:
        """Drop leftover pre-planned times (an aborted group never consumed
        them; a fresh plan must not inherit stale completion timestamps)."""
        self._planned.clear()

    # -- timed command surface (functional op + booking) ----------------------

    def zone_write(self, zone: int, offset: int, blocks, oobs, crcs=None) -> None:
        super().zone_write(zone, offset, blocks, oobs, crcs)
        done = self.book_zone_write(zone, blocks.shape[0], self.engine.now)
        self.chunk_done[(zone, offset)] = done

    def zone_append_commit(self, zone: int, blocks, oobs, crcs=None) -> int:
        off = super().zone_append_commit(zone, blocks, oobs, crcs)
        planned = self._planned.get(zone)
        if planned:
            done = planned.popleft()
            self.engine.touch_io(done)
        else:
            done = self.book_append(zone, blocks.shape[0], self.engine.now)
        self.chunk_done[(zone, off)] = done
        return off

    def zone_append_commit_many(self, zone: int, chunks, oobs, crcs=None) -> np.ndarray:
        offs = super().zone_append_commit_many(zone, chunks, oobs, crcs)
        planned = self._planned.get(zone)
        c = chunks.shape[1]
        for off in offs:
            # the per-zone planned queue is in completion-time order, which
            # is exactly the per-zone issue order of the group committer
            if planned:
                done = planned.popleft()
                self.engine.touch_io(done)
            else:
                done = self.book_append(zone, c, self.engine.now)
            self.chunk_done[(zone, int(off))] = done
        return offs

    def read(self, zone: int, offset: int, n_blocks: int):
        out = super().read(zone, offset, n_blocks)
        self.book_read(n_blocks, self.engine.now)
        return out

    def read_blocks(self, zone: int, offsets):
        out = super().read_blocks(zone, offsets)
        self.book_read(len(offsets), self.engine.now)
        return out

    def read_scattered(self, zones, offsets):
        out = super().read_scattered(zones, offsets)
        self.book_read(len(offsets), self.engine.now)
        return out

    def repair_blocks(self, zone: int, offsets, blocks) -> None:
        # an in-place repair is a write command on the zone's queue: scrub
        # and verify-on-read repairs contend with foreground traffic
        super().repair_blocks(zone, offsets, blocks)
        self.book_zone_write(zone, len(offsets), self.engine.now)

    def replace(self) -> None:
        super().replace()
        self.reset_timing()  # fresh hardware: empty queues, idle channels

    def chunk_completion(self, zone: int, offset: int) -> Optional[float]:
        return self.chunk_done.get((zone, offset))


@dataclasses.dataclass
class CacheServiceModel:
    """Service model for the cache tier: CMB/DRAM-class block reads.

    Deterministic (no jitter) so warm-cache scenarios replay bit- and
    time-identically — the cache benchmark rows gate unscaled in CI."""

    read_us: float = 3.0          # per-command service time at the cache tier
    cmd_max_blocks: int = 16      # a batch of hits splits into commands
    n_channels: int = 8


class TimedCacheDevice:
    """Virtual-time model of the cache device in front of the array.

    Mirrors ``TimedDrive``'s channel booking: a batch of ``n_blocks``
    hits splits into commands of at most ``cmd_max_blocks`` fanned over
    the free channels, each taking a flat ``read_us``.  Completions are
    reported through ``engine.touch_io`` so the handler pipeline's
    ``io_watermark`` convention prices cache hits with zero plumbing."""

    def __init__(self, engine: Engine, model: Optional[CacheServiceModel] = None):
        self.engine = engine
        self.model = model or CacheServiceModel()
        self.tracer = None   # optional repro_torch.obs.Tracer, same contract as
        self.reset_timing()  # TimedDrive.tracer

    def reset_timing(self) -> None:
        self.channels = [self.engine.now] * self.model.n_channels
        self.busy_us = 0.0

    def book_read(self, n_blocks: int, floor: float) -> float:
        max_b = max(1, self.model.cmd_max_blocks)
        done = floor
        remaining = n_blocks
        while remaining > 0:
            nb = min(remaining, max_b)
            i = int(np.argmin(self.channels))
            start = max(floor, self.channels[i])
            t = start + self.model.read_us
            self.channels[i] = t
            self.busy_us += self.model.read_us
            done = max(done, t)
            remaining -= nb
            if self.tracer is not None:
                self.tracer.span("cache-dev", "cache_read", start, t,
                                 n_blocks=nb)
        self.engine.touch_io(done)
        return done


def make_timed_drives(
    n_drives: int,
    cfg: ZnsConfig,
    engine: Engine,
    *,
    service: Optional[ServiceModel] = None,
    budget: Optional[CrashBudget] = None,
    seed: int = 0,
) -> list[TimedDrive]:
    service = service or ServiceModel(block_bytes=cfg.block_bytes)
    budget = budget or CrashBudget(None)
    return [
        TimedDrive(cfg, i, budget, engine=engine, service=service, seed=seed + 101 * i)
        for i in range(n_drives)
    ]


def plan_group_appends(
    drives: list[TimedDrive],
    zone_ids: tuple[int, ...],
    ops: list[tuple[int, int]],
    chunk_blocks: int,
    floor: float,
) -> tuple[list[int], float]:
    """Plan a Zone-Append group: timing decides the completion order.

    ``ops`` is the submission-order list of ``(stripe_index, drive_index)``
    commands of one stripe group.  Every command is booked on its drive's
    zone (qd-limited) starting no earlier than ``floor`` (the group barrier),
    then the batch is sorted by completion time: that order *is* the order
    chunks land at the write pointers -- the fastest command wins.  The
    planned completion times are queued on each drive so the subsequent
    ``zone_append_commit`` calls (issued in the returned order) attribute
    the right time to the right chunk.

    Returns ``(issue_order, group_done_time)``.
    """
    for d in {d for _, d in ops}:
        drives[d].clear_planned()  # stale entries from a crash-aborted group
    done = []
    for idx, (_, d) in enumerate(ops):
        t = drives[d].book_append(zone_ids[d], chunk_blocks, floor)
        done.append((t, idx))
    done.sort()
    for t, idx in done:
        _, d = ops[idx]
        drives[d].plan_completion(zone_ids[d], t)
    return [idx for _, idx in done], done[-1][0]
