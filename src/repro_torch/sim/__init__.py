"""Discrete-event timed I/O engine over the functional ZapRAID simulator.

Layers (see DESIGN.md §8):

* :mod:`repro_torch.sim.engine`   -- virtual clock + event heap;
* :mod:`repro_torch.sim.device`   -- ``TimedDrive``: per-zone command queues with
  perfmodel-sampled service times over ``SimZnsDrive``;
* :mod:`repro_torch.sim.workload` -- MSR-style trace parsing + synthetic and
  multi-tenant generators;
* :mod:`repro_torch.sim.stats`    -- per-request latency recording, percentiles,
  BENCH_*.json export.

The timed request pipeline itself lives in :mod:`repro_torch.core.handlers`
(``HandlerPipeline`` with an engine attached); this package holds the
engine-side primitives it schedules on.
"""
from repro_torch.sim.device import ServiceModel, TimedDrive, make_timed_drives, plan_group_appends
from repro_torch.sim.engine import Engine
from repro_torch.sim.faults import FaultEvent, FaultInjector, FaultPlan
from repro_torch.sim.stats import LatencyRecorder
from repro_torch.sim.workload import Request, TenantSpec, multi_tenant, parse_msr_trace, synthetic

__all__ = [
    "Engine",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "LatencyRecorder",
    "Request",
    "ServiceModel",
    "TenantSpec",
    "TimedDrive",
    "make_timed_drives",
    "multi_tenant",
    "parse_msr_trace",
    "plan_group_appends",
    "synthetic",
]
