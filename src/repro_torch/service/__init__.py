"""Async block-device service front end over the timed engine.

Layers:

* :mod:`repro_torch.service.request`    -- ``IoRequest`` futures + the shared
  :class:`CompletionQueue` (the ``zns_raid_write/read(..., cb_fn, args)``
  surface of the real system);
* :mod:`repro_torch.service.qos`        -- QoS classes (strict priority, EDF
  deadlines, token-bucket shaping, queue-depth caps) and admission state;
* :mod:`repro_torch.service.dispatcher` -- per-tenant submission queues and
  the dispatcher actor enforcing the in-flight window and the QoS policy,
  plus :class:`ClosedLoopClient` for fixed-window (queue-depth sweep) load
  generation;
* :mod:`repro_torch.service.scenario`   -- canned multi-tenant scenarios
  (checkpoint traffic under serving, read QD sweeps, degraded reads behind
  the cache tier) shared by the serving launcher and ``chip_smoke.py``
  (imported lazily by callers: it pulls in the checkpoint engine).

Acks fire at the device-completion times the discrete-event engine
computes, never at Python-call return; virtual time never depends on the
device the codec runs on.
"""
from repro_torch.service.dispatcher import BlockDeviceService, ClosedLoopClient, Tenant
from repro_torch.service.qos import LATENCY, THROUGHPUT, QosClass, TokenBucket
from repro_torch.service.request import (
    DONE,
    INFLIGHT,
    QUEUED,
    REJECTED,
    CompletionQueue,
    IoRequest,
)

__all__ = [
    "BlockDeviceService",
    "ClosedLoopClient",
    "CompletionQueue",
    "DONE",
    "INFLIGHT",
    "IoRequest",
    "LATENCY",
    "QUEUED",
    "QosClass",
    "REJECTED",
    "THROUGHPUT",
    "Tenant",
    "TokenBucket",
]
