"""Observability for the timed ZapRAID stack (DESIGN.md §13).

Four parts.  The first three are observe-only on the virtual clock:

* :mod:`repro_torch.obs.trace` -- span tracing with a Chrome/Perfetto
  ``trace_event`` JSON exporter (request-scoped async spans + resource
  tracks for drives/cache/array);
* :mod:`repro_torch.obs.metrics` -- counters/gauges/histograms plus the
  periodic :class:`MetricsSampler` actor and the stock
  :func:`standard_collector` catalog;
* :mod:`repro_torch.obs.slo` -- the windowed-p99 :class:`SloMonitor` driving
  dynamic per-class admission through
  ``BlockDeviceService.class_caps``.

The fourth, :mod:`repro_torch.obs.spans`, is on the host and device clock:
named ``torch.profiler`` spans at the model path's layer boundaries (train
step, Mamba-2 block, attention, serve loop), recorded only while a
profiler records, which the benchmark's traced runs read.

Every hook site in the stack guards on ``tracer is None`` /
``obs_event is None`` (the defaults), so with nothing attached the
timed and untimed datapaths execute bit-identically to a build without
this package.
"""
from repro_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    MetricsSampler,
    standard_collector,
    validate_metrics_series,
)
from repro_torch.obs.slo import SloMonitor
from repro_torch.obs.trace import Tracer, validate_trace_events

__all__ = [
    "Histogram",
    "MetricsRegistry",
    "MetricsSampler",
    "SloMonitor",
    "Tracer",
    "standard_collector",
    "validate_metrics_series",
    "validate_trace_events",
]
