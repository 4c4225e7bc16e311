"""Fault-injection harness: drive and media faults on the virtual clock.

Wraps the timed pipeline's failure/rebuild actors and the drives'
media-fault hooks in a declarative plan so tests and benchmarks can
inject faults mid-write, mid-GC, or mid-rebuild and assert the array
stays available throughout:

* :class:`FaultEvent` -- one scheduled fault.  Drive-level kinds:
  ``fail`` and ``rebuild`` (replace + reconstruct).  Media-level kinds
  (silent sub-drive faults): ``bit_rot`` (flip a bit in a
  committed block), ``torn_write`` (the tail of the most recent commit
  reverts to erased), ``misdirected_write`` (a victim block is
  overwritten with another block's payload), ``unreadable`` (latent
  sector error: the block reads back UNC).  Media events may pin an
  exact ``(zone, off)`` victim or leave it at -1 to sample uniformly
  from the drive's written blocks at fire time;
* :class:`FaultPlan`  -- an ordered script of events.  Build one
  explicitly (:meth:`FaultPlan.scripted`) or sample from a seeded RNG
  (:meth:`FaultPlan.probabilistic`) -- fail/repair cycles, a weighted
  media-fault mix (``media_mix`` kind weights over a Poisson process
  with mean gap ``media_mtbf_us``), or both in one plan;
* :class:`FaultInjector` -- arms a plan on a ``HandlerPipeline``'s
  engine.  Every fired event is appended to ``injector.log`` as
  ``(t_us, kind, drive)`` so callers can assert what actually happened
  and correlate it with latency samples.

The injector deliberately reuses the array's own entry points
(``fail_drive`` / ``rebuild_drive`` via the pipeline's rebuild actors;
the drives' ``corrupt_*`` hooks), so an injected failure exercises
exactly the degraded-write rotation, paced reconstruction, verify-on-
read, and scrub paths foreground code uses -- nothing is mocked.
Probabilistic fail/rebuild cycles stay serialized (one drive out at a
time) so every plan is valid for ``m >= 1`` schemes; media faults are
an independent process and freely overlap a drive outage.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FaultEvent", "FaultPlan", "FaultInjector", "MEDIA_KINDS"]

MEDIA_KINDS = ("bit_rot", "torn_write", "misdirected_write", "unreadable")
_DRIVE_KINDS = ("fail", "rebuild")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    t_us: float
    kind: str          # "fail" | "rebuild" | one of MEDIA_KINDS
    drive: int
    interval_us: float = 0.0  # rebuild pacing; 0 => one-burst rebuild
    zone: int = -1     # media kinds: victim zone (-1 => sample at fire time)
    off: int = -1      # media kinds: victim block offset (-1 => sample)
    count: int = 1     # media kinds: blocks hit by this event

    def __post_init__(self) -> None:
        if self.kind not in _DRIVE_KINDS + MEDIA_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass
class FaultPlan:
    events: list

    @classmethod
    def scripted(cls, events) -> "FaultPlan":
        """Explicit schedule; events are sorted by fire time."""
        evs = sorted(events, key=lambda e: e.t_us)
        return cls(events=evs)

    @classmethod
    def probabilistic(
        cls,
        *,
        n_drives: int,
        horizon_us: float,
        mtbf_us: float | None = None,
        repair_after_us: float = 0.0,
        seed: int,
        rebuild_interval_us: float = 0.0,
        media_mix: dict[str, float] | None = None,
        media_mtbf_us: float | None = None,
        media_count: int = 1,
    ) -> "FaultPlan":
        """Seeded fault sampling over ``[0, horizon_us)``.

        Two independent processes share one RNG stream:

        * **fail/repair cycles** (when ``mtbf_us`` is set): exponential
          inter-failure gaps with mean ``mtbf_us``, uniform victim
          drive, fixed repair delay.  Cycles are serialized (a drive is
          always repaired before the next failure), so plans stay valid
          for single-parity schemes.
        * **media faults** (when ``media_mix`` is set): a Poisson
          process with mean gap ``media_mtbf_us`` whose event kind is
          drawn from the normalized ``media_mix`` weights (keys from
          :data:`MEDIA_KINDS`), uniform victim drive, ``media_count``
          blocks per event; victims are sampled from the drive's
          written blocks at fire time.

        One plan can therefore drive full-drive failures *and* bit rot
        in the same run -- media faults land during outages too, which
        is exactly the double-fault territory scrub must survive.
        """
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        if mtbf_us is not None:
            t = float(rng.exponential(mtbf_us))
            while t < horizon_us:
                drive = int(rng.integers(0, n_drives))
                events.append(FaultEvent(t_us=t, kind="fail", drive=drive))
                t_repair = t + repair_after_us
                events.append(
                    FaultEvent(t_us=t_repair, kind="rebuild", drive=drive,
                               interval_us=rebuild_interval_us)
                )
                t = t_repair + float(rng.exponential(mtbf_us))
        if media_mix:
            bad = set(media_mix) - set(MEDIA_KINDS)
            if bad:
                raise ValueError(f"unknown media fault kind(s) {sorted(bad)}")
            if media_mtbf_us is None:
                raise ValueError("media_mix requires media_mtbf_us")
            kinds = sorted(media_mix)
            w = np.array([media_mix[k] for k in kinds], dtype=np.float64)
            if w.sum() <= 0:
                raise ValueError("media_mix weights must sum to > 0")
            w = w / w.sum()
            t = float(rng.exponential(media_mtbf_us))
            while t < horizon_us:
                kind = kinds[int(rng.choice(len(kinds), p=w))]
                drive = int(rng.integers(0, n_drives))
                events.append(FaultEvent(t_us=t, kind=kind, drive=drive,
                                         count=media_count))
                t += float(rng.exponential(media_mtbf_us))
        return cls.scripted(events)


class FaultInjector:
    """Arms a :class:`FaultPlan` on a timed ``HandlerPipeline``."""

    def __init__(self, pipeline, plan: FaultPlan, *, seed: int = 0):
        assert pipeline.engine is not None, "fault injection requires a timed pipeline"
        self.pipeline = pipeline
        self.plan = plan
        # Fire-time RNG: victim (zone, off) sampling for media events whose
        # plan left the target at -1 (the written set isn't known plan-time).
        self.rng = np.random.default_rng(seed)
        self.log: list[tuple[float, str, int]] = []

    def arm(self) -> "FaultInjector":
        for ev in self.plan.events:
            self.pipeline.engine.at(ev.t_us, self._fire, ev)
        return self

    def _fire(self, ev: FaultEvent) -> None:
        pipe = self.pipeline
        if ev.kind in MEDIA_KINDS:
            if self._fire_media(ev):
                self.log.append((pipe.engine.now, ev.kind, ev.drive))
            return
        self.log.append((pipe.engine.now, ev.kind, ev.drive))
        if ev.kind == "fail":
            pipe.array.fail_drive(ev.drive)
        elif ev.interval_us > 0.0:
            pipe._ev_rebuild_start(ev.drive, ev.interval_us)
        else:
            pipe._ev_rebuild(ev.drive)

    # -- media faults --------------------------------------------------------

    def _pick_written(self, drive, n: int):
        """Sample ``n`` distinct written (zone, off) victims, or None."""
        mask = drive.written_mask()
        flat = np.flatnonzero(mask.reshape(-1))
        if flat.size == 0:
            return None
        take = self.rng.choice(flat, size=min(n, flat.size), replace=False)
        cap = drive.cfg.zone_cap_blocks
        return take // cap, take % cap

    def _fire_media(self, ev: FaultEvent) -> bool:
        """Apply one media fault; returns False if it had no target (the
        drive is failed/offline or nothing has been written yet)."""
        drive = self.pipeline.array.drives[ev.drive]
        if drive.failed:
            return False
        if ev.kind == "torn_write":
            if ev.zone >= 0:
                zone = ev.zone
            else:
                written = np.flatnonzero(drive.wp > 0)
                if written.size == 0:
                    return False
                zone = int(self.rng.choice(written))
            return drive.corrupt_torn_write(zone, max(1, ev.count)) > 0
        if ev.zone >= 0 and ev.off >= 0:
            zones = np.full(max(1, ev.count), ev.zone, dtype=np.int64)
            offs = np.full(max(1, ev.count), ev.off, dtype=np.int64)
        else:
            picked = self._pick_written(drive, max(1, ev.count))
            if picked is None:
                return False
            zones, offs = picked
        for z, o in zip(zones.tolist(), offs.tolist()):
            if ev.kind == "bit_rot":
                byte = int(self.rng.integers(0, drive.cfg.block_bytes))
                drive.corrupt_bit_rot(z, o, byte=byte,
                                      bit=int(self.rng.integers(0, 8)))
            elif ev.kind == "misdirected_write":
                src = self._pick_written(drive, 1)
                if src is None:
                    return False
                drive.corrupt_misdirected_write(
                    z, o, int(src[0][0]), int(src[1][0])
                )
            else:  # unreadable
                drive.mark_unreadable(z, o)
        return True
