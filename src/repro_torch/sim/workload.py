"""Workloads for the timed engine: trace replay + synthetic generators.

Everything produces a time-ordered list of :class:`Request` -- the open-loop
arrival stream the timed pipeline replays.  Sources:

* ``parse_msr_trace`` -- MSR-Cambridge-style CSV traces
  (``Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime`` with the
  timestamp in Windows 100 ns ticks), the format the paper's Exp#10-style
  trace evaluations use.  Offsets/sizes in bytes are mapped onto the
  array's logical block space (wrapping, so arbitrarily large traces replay
  against small simulated volumes).
* ``synthetic`` -- sequential / uniform-random / zipfian-hotspot address
  streams with Poisson or bursty (on-off modulated Poisson) arrivals.
* ``multi_tenant`` -- merge several :class:`TenantSpec` streams into one
  arrival-ordered workload; per-request tenant tags flow through to the
  latency recorder so per-tenant QoS (p99 under a noisy neighbour) falls
  out of the stats.

All randomness is drawn from per-tenant seeded generators: a workload is a
pure function of its spec, so timed runs are reproducible bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    t_us: float          # arrival (submission) time, virtual microseconds
    tenant: str
    op: str              # "R" | "W"
    lba: int
    n_blocks: int = 1


# ---------------------------------------------------------------- traces


def parse_msr_trace(
    text: str | Iterable[str],
    *,
    block_bytes: int,
    logical_blocks: int,
    tenant: str = "trace",
    time_scale: float = 1.0,
) -> list[Request]:
    """Parse an MSR-Cambridge-format trace into timestamped requests.

    ``time_scale`` compresses (<1) or stretches (>1) inter-arrival gaps --
    handy for replaying hour-long traces against seconds of virtual time.
    Lines that do not parse (headers, blanks) are skipped.
    """
    lines = text.splitlines() if isinstance(text, str) else text
    rows: list[tuple[int, str, int, int]] = []
    for line in lines:
        parts = line.strip().split(",")
        if len(parts) < 6:
            continue
        try:
            ticks = int(parts[0])
            offset = int(parts[4])
            size = int(parts[5])
        except ValueError:
            continue  # header or malformed row
        op = "W" if parts[3].strip().lower().startswith("w") else "R"
        n = max(1, -(-size // block_bytes))
        n = min(n, logical_blocks)
        lba = (offset // block_bytes) % (logical_blocks - n + 1)
        rows.append((ticks, op, int(lba), int(n)))
    rows.sort()  # traces are not always time-ordered; rebase after sorting
    if not rows:
        return []
    t0 = rows[0][0]
    return [
        Request((ticks - t0) / 10.0 * time_scale, tenant, op, lba, n)
        for ticks, op, lba, n in rows
    ]


# ---------------------------------------------------------- synthetic streams


def _arrivals(
    rng: np.random.Generator,
    n_ops: int,
    rate_iops: float,
    *,
    burst_factor: float = 1.0,
    burst_on_frac: float = 0.5,
    burst_period_us: float = 10_000.0,
) -> np.ndarray:
    """Open-loop arrival times: Poisson, optionally on-off burst modulated.

    With ``burst_factor > 1`` the stream alternates ON windows (first
    ``burst_on_frac`` of every ``burst_period_us``) at ``burst_factor x``
    the base rate and OFF windows at ``1/burst_factor x`` -- the classic
    bursty multi-tenant client."""
    if burst_factor <= 1.0:
        return np.cumsum(rng.exponential(1e6 / rate_iops, n_ops))
    rate_on = rate_iops * burst_factor
    rate_off = rate_iops / burst_factor
    out = np.empty(n_ops)
    now = 0.0
    for i in range(n_ops):
        on = (now % burst_period_us) < burst_on_frac * burst_period_us
        now += rng.exponential(1e6 / (rate_on if on else rate_off))
        out[i] = now
    return out


def _addresses(
    rng: np.random.Generator,
    kind: str,
    n_ops: int,
    logical_blocks: int,
    n_blocks: int,
    *,
    hot_frac: float = 0.1,
    hot_prob: float = 0.8,
) -> np.ndarray:
    # valid start LBAs are [0, logical_blocks - n_blocks], inclusive -- the
    # same modulus parse_msr_trace uses
    span = max(1, logical_blocks - n_blocks + 1)
    if kind == "seq":
        return (np.arange(n_ops, dtype=np.int64) * n_blocks) % span
    if kind == "uniform":
        return rng.integers(0, span, n_ops)
    if kind == "hotspot":  # zipfian-hotspot: hot_prob of ops on hot_frac of space
        hot_span = max(1, int(span * hot_frac))
        hot = rng.random(n_ops) < hot_prob
        addr = rng.integers(0, span, n_ops)
        addr[hot] = rng.integers(0, hot_span, int(hot.sum()))
        return addr
    if kind == "zipf":  # heavy-tailed ranks scattered over the address space
        ranks = rng.zipf(1.2, n_ops).astype(np.int64) % span
        return (ranks * np.int64(2654435761)) % span  # Knuth-hash dispersion
    raise ValueError(f"unknown address kind: {kind}")


@dataclasses.dataclass
class TenantSpec:
    """One client of a multi-tenant workload.

    ``arrival`` selects the arrival process:

    * ``"open"``   -- open-loop: timestamps are drawn up front (Poisson /
      bursty) and requests are fired at those instants regardless of how
      the device keeps up -- queueing delay is *observed*;
    * ``"closed"`` -- closed-loop: a fixed ``window`` of requests is kept
      outstanding and the next one is submitted only when a previous one
      completes (plus ``think_time_us``).  Submission times therefore
      depend on completions, so ``synthetic`` emits the op/address stream
      with ``t_us = 0`` and a driver with completion callbacks -- see
      the block service's ``ClosedLoopClient`` -- assigns the real times.
      This is the knob queue-depth sweeps are expressed with.
    """

    name: str
    kind: str = "uniform"        # seq | uniform | hotspot | zipf
    n_ops: int = 1000
    rate_iops: float = 20_000.0
    read_frac: float = 0.0
    n_blocks: int = 1
    burst_factor: float = 1.0    # >1 => bursty on-off arrivals
    burst_on_frac: float = 0.5
    burst_period_us: float = 10_000.0
    hot_frac: float = 0.1
    hot_prob: float = 0.8
    seed: int = 0
    arrival: str = "open"        # open | closed
    window: int = 4              # closed-loop outstanding-request window
    think_time_us: float = 0.0   # closed-loop delay completion -> next submit


def synthetic(spec: TenantSpec, logical_blocks: int) -> list[Request]:
    """Generate one tenant's request stream.

    Open-loop specs carry real arrival timestamps; closed-loop specs carry
    the deterministic op/address sequence with ``t_us = 0`` (the submission
    instants are decided at run time by the closed-loop driver)."""
    if spec.arrival not in ("open", "closed"):
        raise ValueError(f"unknown arrival mode: {spec.arrival}")
    rng = np.random.default_rng(spec.seed + 0x5EED)
    if spec.arrival == "closed":
        t = np.zeros(spec.n_ops)
    else:
        t = _arrivals(
            rng, spec.n_ops, spec.rate_iops,
            burst_factor=spec.burst_factor,
            burst_on_frac=spec.burst_on_frac,
            burst_period_us=spec.burst_period_us,
        )
    addr = _addresses(
        rng, spec.kind, spec.n_ops, logical_blocks, spec.n_blocks,
        hot_frac=spec.hot_frac, hot_prob=spec.hot_prob,
    )
    is_read = rng.random(spec.n_ops) < spec.read_frac
    return [
        Request(float(t[i]), spec.name, "R" if is_read[i] else "W",
                int(addr[i]), spec.n_blocks)
        for i in range(spec.n_ops)
    ]


def multi_tenant(specs: list[TenantSpec], logical_blocks: int) -> list[Request]:
    """Merge tenant streams into one arrival-ordered workload."""
    reqs: list[Request] = []
    for spec in specs:
        if spec.arrival != "open":
            raise ValueError(
                f"tenant {spec.name!r}: closed-loop streams have no arrival "
                "times to merge on; drive them with a closed-loop client"
            )
        reqs.extend(synthetic(spec, logical_blocks))
    reqs.sort(key=lambda r: (r.t_us, r.tenant))
    return reqs
