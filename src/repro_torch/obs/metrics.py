"""Metrics registry + periodic sampler actor for the timed stack.

A :class:`MetricsRegistry` holds three instrument kinds:

* **counters** -- monotone totals (``inc``): committed stripes, GC blocks
  moved, cache hits, zone resets;
* **gauges** -- point-in-time levels (``set``): open zones per drive,
  staging-arena and cache occupancy, per-tenant queue depth, in-flight
  window usage, token-bucket levels, the GC escrow;
* **histograms** -- log2-bucketed distributions (``observe``): per-sample
  latencies the SLO monitor has already windowed.

The :class:`MetricsSampler` is an engine actor in the mold of the
pipeline's self-re-arming flush tick: every ``interval_us`` of *virtual*
time it runs its collector (a plain callable that reads simulator state
into the registry) and appends one row to ``series`` -- the time-series
JSON exported next to the ``BENCH_*`` rows.  It re-arms only while the
pipeline/service reports outstanding work, so an idle engine schedules no
events and a run's event count stays bounded.  Sampling is observe-only:
collectors read state, never book device time, so the virtual timeline is
bit-identical with and without a sampler attached.

:func:`standard_collector` wires the catalog the obs layer ships: zone
states per drive, arena/cache occupancy, per-tenant service levels,
GC/rebuild progress, token buckets, and the reserved-zone escrow.
"""
from __future__ import annotations

import json
import math
from collections import defaultdict
from typing import Callable, Optional

_HIST_BUCKETS = 24   # log2 buckets: [1, 2), [2, 4), ... us


class Histogram:
    """Power-of-two-bucketed value distribution (microseconds)."""

    def __init__(self, n_buckets: int = _HIST_BUCKETS):
        self.counts = [0] * n_buckets
        self.n = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        b = 0 if v < 1.0 else min(len(self.counts) - 1, int(math.log2(v)) + 1)
        self.counts[b] += 1
        self.n += 1
        self.total += v

    def snapshot(self) -> dict:
        return {"n": self.n, "total": self.total, "counts": list(self.counts)}


class MetricsRegistry:
    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    def inc(self, name: str, v: float = 1.0) -> None:
        self.counters[name] += v

    def set(self, name: str, v: float) -> None:
        self.gauges[name] = float(v)

    def observe(self, name: str, v: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.observe(v)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.snapshot() for k, h in self.histograms.items()},
        }

    def clear(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()


class MetricsSampler:
    """Self-re-arming engine actor recording one registry row per tick."""

    def __init__(
        self,
        engine,
        registry: MetricsRegistry,
        collect: Callable[[MetricsRegistry], None],
        *,
        interval_us: float = 50.0,
        busy_fn: Optional[Callable[[], bool]] = None,
        max_samples: int = 100_000,
    ):
        self.engine = engine
        self.registry = registry
        self.collect = collect
        self.interval_us = interval_us
        self.busy_fn = busy_fn
        self.max_samples = max_samples
        self.series: list[dict] = []
        self._armed = False
        self._stopped = False

    def start(self, at: float = 0.0) -> None:
        self._stopped = False
        if not self._armed:
            self._armed = True
            self.engine.at(max(at, self.engine.now), self._tick)

    def stop(self) -> None:
        self._stopped = True

    def sample_once(self) -> dict:
        """One collector pass + series row at the current virtual time."""
        self.collect(self.registry)
        row = {
            "t_us": self.engine.now,
            "counters": dict(self.registry.counters),
            "gauges": dict(self.registry.gauges),
        }
        if len(self.series) < self.max_samples:
            self.series.append(row)
        return row

    def _tick(self) -> None:
        self._armed = False
        if self._stopped:
            return
        self.sample_once()
        # Re-arm while the tracked workload (busy_fn) is live -- or, absent
        # a busy signal, while *anything else* is still scheduled: the
        # sampler then stops exactly when the simulation goes idle and
        # never keeps the engine alive on its own.
        busy = self.busy_fn() if self.busy_fn is not None else False
        if busy or self.engine.pending():
            self._armed = True
            self.engine.after(self.interval_us, self._tick)

    def clear(self) -> None:
        self.series.clear()
        self.registry.clear()

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "interval_us": self.interval_us,
                "series": self.series,
                "histograms": {
                    k: h.snapshot() for k, h in self.registry.histograms.items()
                },
            }, f)
            f.write("\n")


def validate_metrics_series(doc: dict) -> None:
    """Schema check for an exported metrics time-series document."""
    assert isinstance(doc.get("series"), list), "missing series"
    t_prev = -math.inf
    prev_counters: dict[str, float] = {}
    for row in doc["series"]:
        assert isinstance(row.get("t_us"), (int, float)), row
        assert row["t_us"] >= t_prev, "time-series not monotone in t_us"
        t_prev = row["t_us"]
        assert isinstance(row.get("counters"), dict), row
        assert isinstance(row.get("gauges"), dict), row
        for k, v in row["counters"].items():
            assert v >= prev_counters.get(k, 0.0), f"counter {k} decreased"
        prev_counters.update(row["counters"])


def standard_collector(pipe, svc=None) -> Callable[[MetricsRegistry], None]:
    """The stock metric catalog over a timed pipeline (+ optional service).

    Samples, per tick: zone states and reset totals per drive, staging
    buffer and arena occupancy, cache occupancy/hit counters, GC and
    rebuild progress, the reserved-zone escrow level, and -- when a
    block service (a ``BlockDeviceService``) is given --
    per-tenant queue depth, in-flight window usage, and token levels.
    """
    from repro_torch.core.zns import ZoneState

    arr = pipe.array

    def collect(reg: MetricsRegistry) -> None:
        for d in arr.drives:
            p = f"drive{d.drive_id}"
            st = d.state
            reg.set(f"{p}/zones_empty", int((st == int(ZoneState.EMPTY)).sum()))
            reg.set(f"{p}/zones_open", int((st == int(ZoneState.OPEN)).sum()))
            reg.set(f"{p}/zones_full", int((st == int(ZoneState.FULL)).sum()))
            reg.set(f"{p}/zones_offline",
                    int((st == int(ZoneState.OFFLINE)).sum()))
            reg.counters[f"{p}/zone_resets"] = float(d.zone_resets)
            reg.counters[f"{p}/blocks_written"] = float(d.blocks_written)
            busy = getattr(d, "busy_us", None)
            if busy is not None:
                reg.counters[f"{p}/busy_us"] = max(
                    busy, reg.counters.get(f"{p}/busy_us", 0.0))
        reg.set("array/staged_blocks", len(arr._buffered))
        reg.set("array/open_segments", len(arr.open_segments))
        reg.set("array/free_segments", arr.free_segment_count())
        reg.set("array/gc_reserved_zones", arr.reserved_zones())
        reg.counters["array/stripes_committed"] = float(
            arr.stats.stripes_committed)
        reg.counters["array/gc_runs"] = float(arr.stats.gc_runs)
        reg.counters["array/gc_blocks_moved"] = float(arr.stats.gc_blocks_moved)
        reg.set("array/rebuild_pending_zones", len(arr._rebuild_pending))
        # end-to-end integrity: detections/repairs are monotone counters,
        # the media-fault total comes from the drives' own hooks so a CI
        # gate can assert injected == detected after a scrub pass
        reg.counters["integrity/corruptions_detected"] = float(
            arr.stats.integrity_corruptions_detected)
        reg.counters["integrity/unreadable_hits"] = float(
            arr.stats.integrity_unreadable_hits)
        reg.counters["integrity/blocks_repaired"] = float(
            arr.stats.integrity_blocks_repaired)
        reg.counters["integrity/scrub_passes"] = float(
            arr.stats.integrity_scrub_passes)
        reg.counters["integrity/scrub_blocks"] = float(
            arr.stats.integrity_scrub_blocks)
        # max-folded like busy_us: a drive replacement mid-run must not
        # make the fleet-wide total step backwards
        reg.counters["integrity/media_faults_injected"] = max(
            float(sum(d.media_faults for d in arr.drives)),
            reg.counters.get("integrity/media_faults_injected", 0.0))
        # 1.0 while any member drive is failed: SLO monitors and dashboards
        # can separate degraded-width commits from healthy-path latency
        reg.set("array/degraded_mode",
                float(any(d.failed for d in arr.drives)))
        cache = arr.cache
        if cache is not None:
            reg.set("cache/resident_blocks", cache.resident_count())
            reg.counters["cache/hits"] = float(cache.stats.hits)
            reg.counters["cache/misses"] = float(cache.stats.misses)
            reg.counters["cache/zone_resets"] = float(cache.stats.zone_resets)
        if svc is not None:
            now = svc.engine.now
            reg.set("service/inflight", svc.inflight)
            reg.set("service/window", svc.max_inflight)
            for name, ten in svc.tenants.items():
                tp = f"tenant/{name}"
                reg.set(f"{tp}/queue_depth", ten.queue_depth())
                reg.set(f"{tp}/inflight", ten.inflight)
                reg.counters[f"{tp}/completed"] = float(ten.completed)
                reg.counters[f"{tp}/rejected"] = float(ten.rejected)
                if ten.bucket is not None:
                    reg.set(f"{tp}/tokens", ten.bucket.peek(now))
            for cls, n in svc._class_inflight.items():
                reg.set(f"class/{cls}/inflight", n)
                cap = svc.class_caps.get(cls)
                if cap is not None:
                    reg.set(f"class/{cls}/cap", cap)

    return collect
