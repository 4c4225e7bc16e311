"""Per-request latency recording for the timed engine.

``LatencyRecorder`` collects one sample per completed request -- tenant, op,
submit and completion virtual times, and an optional per-stage breakdown
(buffer wait, device queueing, device service, post-processing) -- and
reduces them to the distribution figures the paper reports: p50/p95/p99/p999,
mean, max.  ``to_bench_rows`` emits ``(name, us, derived)`` tuples in the
exact shape ``benchmarks.run`` prints and serializes, so timed scenarios
drop into the ``BENCH_*.json`` perf-trajectory format unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Optional

import numpy as np

PERCENTILES = (50.0, 95.0, 99.0, 99.9)
_PCT_NAMES = ("p50", "p95", "p99", "p999")


@dataclasses.dataclass(frozen=True)
class Sample:
    tenant: str
    op: str               # "R" | "W"
    t_submit: float
    t_done: float

    @property
    def latency_us(self) -> float:
        return self.t_done - self.t_submit


class LatencyRecorder:
    def __init__(self):
        self.samples: list[Sample] = []
        self.stage_sums: dict[str, float] = defaultdict(float)
        self.stage_counts: dict[str, int] = defaultdict(int)
        # per-tenant breakdown of the same stages, keyed (tenant, stage):
        # the service tier uses it to attribute queue-wait vs service time
        # per client (QoS accounting)
        self.tenant_stage_sums: dict[tuple[str, str], float] = defaultdict(float)
        self.tenant_stage_counts: dict[tuple[str, str], int] = defaultdict(int)
        self.notes: dict[str, float] = defaultdict(float)
        self.note_counts: dict[str, int] = defaultdict(int)

    # -- collection ---------------------------------------------------------

    def record(
        self,
        tenant: str,
        op: str,
        t_submit: float,
        t_done: float,
        stages: Optional[dict[str, float]] = None,
    ) -> None:
        self.samples.append(Sample(tenant, op, t_submit, t_done))
        for k, v in (stages or {}).items():
            self.stage_sums[k] += v
            self.stage_counts[k] += 1
            self.tenant_stage_sums[(tenant, k)] += v
            self.tenant_stage_counts[(tenant, k)] += 1

    def note(self, key: str, value_us: float) -> None:
        """Accumulate an engine-level delay (e.g. group-barrier waits)."""
        self.notes[key] += value_us
        self.note_counts[key] += 1

    # -- reduction ----------------------------------------------------------

    def latencies(self, op: Optional[str] = None, tenant: Optional[str] = None) -> np.ndarray:
        return np.array([
            s.latency_us for s in self.samples
            if (op is None or s.op == op) and (tenant is None or s.tenant == tenant)
        ])

    @staticmethod
    def _reduce(lat: np.ndarray) -> dict:
        """Percentile reduction with an explicit empty-set guard: a tenant
        with zero samples in the selection yields ``n == 0`` and NaN
        figures instead of falling through to ``np.percentile`` on an
        empty array (or a KeyError at the caller)."""
        if lat.size == 0:
            out = {"n": 0, "mean": float("nan"), "max": float("nan")}
            out.update({name: float("nan") for name in _PCT_NAMES})
            return out
        out = {"n": int(lat.size), "mean": float(lat.mean()), "max": float(lat.max())}
        for name, q in zip(_PCT_NAMES, np.percentile(lat, PERCENTILES)):
            out[name] = float(q)
        return out

    def percentiles(self, op: Optional[str] = None, tenant: Optional[str] = None) -> dict:
        """{n, mean, max, p50, p95, p99, p999} over the selected samples."""
        return self._reduce(self.latencies(op, tenant))

    def windowed_percentiles(
        self,
        t_lo: float,
        t_hi: float,
        op: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> dict:
        """Percentiles over samples *completing* in ``(t_lo, t_hi]``.

        The SLO monitor's view of the world: only completions inside the
        trailing window count, so the figure tracks current conditions
        instead of averaging over the whole run.  Safe on empty windows
        (``n == 0``, NaN figures)."""
        lat = np.array([
            s.latency_us for s in self.samples
            if t_lo < s.t_done <= t_hi
            and (op is None or s.op == op)
            and (tenant is None or s.tenant == tenant)
        ])
        return self._reduce(lat)

    def stage_means(self, tenant: Optional[str] = None) -> dict[str, float]:
        """Mean per-stage delay, optionally restricted to one tenant."""
        if tenant is None:
            return {
                k: self.stage_sums[k] / max(1, self.stage_counts[k])
                for k in sorted(self.stage_sums)
            }
        return {
            k: self.tenant_stage_sums[(t, k)] / max(1, self.tenant_stage_counts[(t, k)])
            for t, k in sorted(self.tenant_stage_sums)
            if t == tenant
        }

    def span_us(self) -> float:
        if not self.samples:
            return 0.0
        return max(s.t_done for s in self.samples) - min(s.t_submit for s in self.samples)

    def throughput_mib_s(self, block_bytes: int, op: str = "W") -> float:
        """Goodput over the virtual-time span.  Block count comes from the
        ``"{op}_blocks"`` note when the pipeline recorded one (multi-block
        requests), else falls back to one block per sample."""
        span = self.span_us()
        if span <= 0:
            return 0.0
        n = self.notes.get(f"{op}_blocks", float(len(self.latencies(op))))
        return n * block_bytes / (span / 1e6) / (1 << 20)

    # -- export -------------------------------------------------------------

    def summary(self) -> dict:
        tenants = sorted({s.tenant for s in self.samples})
        out = {
            "ops": {op: self.percentiles(op=op) for op in ("R", "W")},
            "tenants": {
                t: {
                    **{op: self.percentiles(op=op, tenant=t) for op in ("R", "W")},
                    "stage_means_us": self.stage_means(tenant=t),
                }
                for t in tenants
            },
            "stage_means_us": self.stage_means(),
            "notes_us": {
                k: {"total": self.notes[k], "count": self.note_counts[k]}
                for k in sorted(self.notes)
            },
        }
        return out

    def to_bench_rows(self, prefix: str) -> list[tuple[str, float, str]]:
        """(name, us_per_call, derived) rows, BENCH_*.json-compatible."""
        rows = []
        for op, tag in (("W", "write"), ("R", "read")):
            p = self.percentiles(op=op)
            if p.get("n"):
                rows.append((
                    f"{prefix}/{tag}_p50", p["p50"],
                    f"p99={p['p99']:.1f}us_p999={p['p999']:.1f}us_n={p['n']}",
                ))
        return rows

    def to_json(self, path: str, prefix: str) -> None:
        out = {
            name: {"us_per_call": round(us, 2), "derived": derived}
            for name, us, derived in self.to_bench_rows(prefix)
        }
        with open(path, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
            f.write("\n")
