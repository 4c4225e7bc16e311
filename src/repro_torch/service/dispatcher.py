"""Async block-device service: per-tenant submission queues + dispatcher.

This is the front end the real ZapRAID exposes to applications -- an async
block device with completion callbacks -- layered over the timed
:class:`repro_torch.core.handlers.HandlerPipeline`:

* **submission queues** -- one FIFO per tenant.  ``submit_write/read``
  return an :class:`IoRequest` future immediately; the request *arrives*
  (enters its queue, or is rejected by admission control) at its arrival
  instant on the virtual clock.
* **dispatcher actor** -- pulls requests from the submission queues onto
  the array, never holding more than ``max_inflight`` outstanding (the
  device queue depth being modelled).  Under ``policy="qos"`` the next
  request is chosen by strict class priority, then earliest deadline, then
  arrival order; ``policy="fifo"`` ignores classes entirely (global arrival
  order) and exists as the baseline QoS is measured against.  Tenants whose
  token bucket is empty are ineligible until it refills; the dispatcher
  schedules its own wake-up at the earliest refill instant so shaping does
  not depend on unrelated traffic to make progress.
* **completion queue** -- acks fire at the device-completion times the
  timed engine computes, *not* at Python-call return: the pipeline
  resolves a write when its stripe's slowest chunk lands and a read at its
  device time, and the service then stamps ``t_done``, fires ``cb_fn``, and
  pushes the request onto the shared :class:`CompletionQueue`.
* **stats** -- every completion records into a :class:`LatencyRecorder`
  with a per-tenant ``queue_wait_us`` (arrival -> dispatch, the admission/
  scheduling delay) vs ``service_us`` (dispatch -> ack, the device) split.

The service registers itself as the pipeline's ``busy_hook`` so the
timeout-flush tick keeps running while work exists only in submission
queues -- a drained queue must still pad+commit partially filled stripes
(see ``HandlerPipeline.ensure_flush_ticks``).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.service.qos import THROUGHPUT, QosClass, TokenBucket
from repro_torch.service.request import (
    DONE,
    INFLIGHT,
    QUEUED,
    REJECTED,
    CompletionQueue,
    IoRequest,
)


class Tenant:
    """Per-tenant service state: submission queue, shaping, counters."""

    def __init__(self, name: str, qos: QosClass, t0: float = 0.0):
        self.name = name
        self.qos = qos
        self.queue: deque[IoRequest] = deque()
        self.bucket = (
            TokenBucket(qos.rate_iops, qos.burst, t0) if qos.rate_iops > 0 else None
        )
        self.inflight = 0
        self.accepted = 0
        self.rejected = 0
        self.completed = 0

    def queue_depth(self) -> int:
        return len(self.queue)

    def outstanding(self) -> int:
        return len(self.queue) + self.inflight


class BlockDeviceService:
    """Submission/completion-queue block-device facade over a timed pipeline."""

    def __init__(
        self,
        pipe,
        *,
        max_inflight: int = 32,
        policy: str = "qos",
        recorder=None,
        cache_bypass: bool = True,
    ):
        assert pipe.engine is not None, "the service requires a timed pipeline"
        assert policy in ("qos", "fifo"), policy
        self.pipe = pipe
        self.engine = pipe.engine
        self.policy = policy
        self.max_inflight = max_inflight
        # Reads fully resident in the array's cache tier skip the submission
        # queue and the in-flight window: a cache hit needs no device queue
        # slot, so latency-class tenants see hits without queueing behind
        # checkpoint traffic.  Only active when a cache is attached.
        self.cache_bypass = cache_bypass
        self.cache_bypasses = 0
        self.tenants: dict[str, Tenant] = {}
        # Dynamic per-class in-flight overrides (repro_torch.obs.SloMonitor): the
        # dispatcher consults this before the frozen QosClass default, so an
        # SLO controller can shrink/restore a class's share at runtime.
        # Empty by default -- static QoS behavior is untouched.
        self.class_caps: dict[str, int] = {}
        # Optional span tracer (repro_torch.obs.Tracer); None = zero-cost no-op.
        self.tracer = None
        self.cq = CompletionQueue()
        if recorder is None:
            from repro_torch.sim.stats import LatencyRecorder
            recorder = LatencyRecorder()
        self.recorder = recorder
        self.inflight = 0
        self._class_inflight: dict[str, int] = {}
        self._live = 0          # scheduled arrivals + queued + inflight
        self._seq = 0
        self._wake_at = math.inf
        # flush ticks must outlive the pipeline's own idle detection while
        # the service still holds queued or scheduled work
        pipe.busy_hook = lambda: self._live > 0

    # -- tenants -------------------------------------------------------------

    def register(self, name: str, qos: QosClass = THROUGHPUT) -> Tenant:
        assert name not in self.tenants, f"tenant {name!r} already registered"
        ten = Tenant(name, qos, self.engine.now)
        self.tenants[name] = ten
        self._class_inflight.setdefault(qos.name, 0)
        return ten

    # -- submission (the zns_raid_write/read surface) ------------------------

    def submit_write(self, tenant: str, lba: int, data: np.ndarray, *,
                     at: Optional[float] = None, cb=None) -> IoRequest:
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim == 1:
            data = data.reshape(1, -1)
        req = IoRequest(tenant=tenant, op="W", lba=lba,
                        n_blocks=data.shape[0], data=data, cb_fn=cb)
        return self._submit(req, at)

    def submit_read(self, tenant: str, lba: int, n_blocks: int = 1, *,
                    at: Optional[float] = None, cb=None) -> IoRequest:
        req = IoRequest(tenant=tenant, op="R", lba=lba,
                        n_blocks=n_blocks, cb_fn=cb)
        return self._submit(req, at)

    def _submit(self, req: IoRequest, at: Optional[float]) -> IoRequest:
        assert req.tenant in self.tenants, f"unknown tenant {req.tenant!r}"
        t = self.engine.now if at is None else max(at, self.engine.now)
        req.seq = self._seq
        self._seq += 1
        self._live += 1
        self.pipe.ensure_flush_ticks()
        self.engine.at(t, self._ev_arrive, req)
        return req

    # -- events --------------------------------------------------------------

    def _ev_arrive(self, req: IoRequest) -> None:
        ten = self.tenants[req.tenant]
        req.t_submit = self.engine.now
        req.deadline = req.t_submit + ten.qos.deadline_us
        tr = self.tracer
        if tr is not None:
            req.trace_id = req.seq
            tr.req_begin(req.trace_id, "io.request", req.t_submit,
                         tenant=req.tenant, op=req.op, lba=req.lba,
                         n_blocks=req.n_blocks, qos=ten.qos.name)
        if ten.outstanding() >= ten.qos.queue_cap:
            # NVMe queue-full: reject at admission, complete with an error
            req.status = REJECTED
            ten.rejected += 1
            self._live -= 1
            if tr is not None:
                tr.req_instant(req.trace_id, "admission.reject", req.t_submit,
                               queue_cap=ten.qos.queue_cap)
                tr.req_end(req.trace_id, "io.request", req.t_submit,
                           status=REJECTED)
            self.cq.push(req)
            if req.cb_fn:
                req.cb_fn(req)
            return
        cache = self.pipe.array.cache if self.cache_bypass else None
        if (
            req.op == "R"
            and cache is not None
            and cache.contains_run(req.lba, req.n_blocks)
        ):
            # full cache hit: dispatch immediately, outside the window
            ten.accepted += 1
            req.bypass = True
            self.cache_bypasses += 1
            if tr is not None:
                tr.req_instant(req.trace_id, "cache.bypass", req.t_submit)
            self._dispatch(req)
            return
        ten.accepted += 1
        if tr is not None:
            tr.req_begin(req.trace_id, "sq.wait", req.t_submit)
        ten.queue.append(req)
        self._pump()

    def _ev_wake(self) -> None:
        self._wake_at = math.inf
        self._pump()

    def _pump(self) -> None:
        """Dispatch until the window is full or nothing is eligible."""
        now = self.engine.now
        while self.inflight < self.max_inflight:
            req = self._pop_next(now)
            if req is None:
                break
            self._dispatch(req)
        self._arm_token_wake(now)

    def _eligible(self, ten: Tenant, now: float) -> bool:
        if not ten.queue:
            return False
        if self.policy == "qos":
            cap = self.class_caps.get(ten.qos.name, ten.qos.max_inflight)
            if cap and self._class_inflight[ten.qos.name] >= cap:
                return False
        if ten.bucket is not None and ten.bucket.peek(now) < 1.0:
            return False
        return True

    def _pop_next(self, now: float) -> Optional[IoRequest]:
        best: Optional[Tenant] = None
        best_key = None
        for ten in self.tenants.values():
            if not self._eligible(ten, now):
                continue
            head = ten.queue[0]
            if self.policy == "fifo":
                key = (head.t_submit, head.seq)
            else:
                key = (ten.qos.priority, head.deadline, head.t_submit, head.seq)
            if best_key is None or key < best_key:
                best, best_key = ten, key
        if best is None:
            return None
        if best.bucket is not None:
            best.bucket.take(now)
        return best.queue.popleft()

    def _dispatch(self, req: IoRequest) -> None:
        ten = self.tenants[req.tenant]
        req.status = INFLIGHT
        req.t_dispatch = self.engine.now
        if not req.bypass:  # cache-hit reads don't hold a window slot
            ten.inflight += 1
            self.inflight += 1
            self._class_inflight[ten.qos.name] += 1
        tr = self.tracer
        if tr is not None:
            t = req.t_dispatch
            if not req.bypass:
                tr.req_end(req.trace_id, "sq.wait", t)
                tr.req_instant(req.trace_id, "qos.dispatch", t,
                               klass=ten.qos.name,
                               class_inflight=self._class_inflight[ten.qos.name],
                               inflight=self.inflight, window=self.max_inflight)
            tr.req_begin(req.trace_id, "device.service", t)
        if req.op == "W":
            self.pipe.submit_write(
                req.lba, req.data, tenant=req.tenant,
                cb=lambda _t_ack, r=req: self._ev_complete(r, None),
            )
        else:
            self.pipe.submit_read(
                req.lba, req.n_blocks, tenant=req.tenant,
                cb=lambda out, r=req: self._ev_complete(r, out),
            )

    def _ev_complete(self, req: IoRequest, result) -> None:
        ten = self.tenants[req.tenant]
        req.status = DONE
        req.t_done = self.engine.now
        req.result = result
        if not req.bypass:
            ten.inflight -= 1
            self.inflight -= 1
            self._class_inflight[ten.qos.name] -= 1
        ten.completed += 1
        self._live -= 1
        tr = self.tracer
        if tr is not None:
            tr.req_end(req.trace_id, "device.service", req.t_done)
            tr.req_end(req.trace_id, "io.request", req.t_done,
                       latency_us=req.latency_us, status=DONE)
        self.recorder.record(
            req.tenant, req.op, req.t_submit, req.t_done,
            stages={"queue_wait_us": req.queue_wait_us,
                    "service_us": req.service_us},
        )
        self.cq.push(req)
        if req.cb_fn:
            req.cb_fn(req)
        self._pump()

    def _arm_token_wake(self, now: float) -> None:
        """If dispatch is blocked only by empty token buckets, self-schedule
        a pump at the earliest refill so shaping makes progress on its own."""
        if self.inflight >= self.max_inflight:
            return  # a completion will pump
        t_next = math.inf
        for ten in self.tenants.values():
            if not ten.queue or ten.bucket is None:
                continue
            if self.policy == "qos":
                cap = self.class_caps.get(ten.qos.name, ten.qos.max_inflight)
                if cap and self._class_inflight[ten.qos.name] >= cap:
                    continue
            t_next = min(t_next, ten.bucket.next_ready(now))
        if t_next < self._wake_at and t_next < math.inf and t_next > now:
            self._wake_at = t_next
            self.engine.at(t_next, self._ev_wake)

    # -- draining / stats ----------------------------------------------------

    def drain(self) -> None:
        """Run the engine until every submitted request has completed."""
        self.pipe.drain()
        assert self._live == 0, "service drain left live requests"

    def summary(self) -> dict:
        return {
            "policy": self.policy,
            "max_inflight": self.max_inflight,
            "cache_bypasses": self.cache_bypasses,
            "tenants": {
                name: {
                    "qos": ten.qos.name,
                    "accepted": ten.accepted,
                    "rejected": ten.rejected,
                    "completed": ten.completed,
                }
                for name, ten in sorted(self.tenants.items())
            },
            "latency": self.recorder.summary(),
        }


class ClosedLoopClient:
    """Fixed-outstanding-window load driver (closed-loop arrival mode).

    Consumes a :mod:`repro_torch.sim.workload` request list (arrival timestamps
    ignored -- generate with ``TenantSpec(arrival="closed")``), keeps at
    most ``window`` requests outstanding, and submits the next op
    ``think_time_us`` after each completion.  This is how queue-depth
    sweeps are expressed: the window *is* the offered queue depth, and
    throughput as a function of it is the ZNS saturation curve.

    Rejected submissions (possible when the tenant's ``queue_cap`` is below
    the window) count as completions so the loop always terminates.
    """

    def __init__(self, service: BlockDeviceService, tenant: str, requests, *,
                 window: int = 4, think_time_us: float = 0.0,
                 payload_fn=None, seed: int = 0xC10):
        self.service = service
        self.tenant = tenant
        self.reqs = list(requests)
        self.window = max(1, window)
        self.think_time_us = think_time_us
        self._payload_fn = payload_fn
        self._rng = np.random.default_rng(seed)
        self._bb = service.pipe.array.zns_cfg.block_bytes
        self._next = 0
        self.completed = 0
        self.rejected = 0

    def start(self, at: float = 0.0) -> None:
        self.service.engine.at(at, self._ev_start)

    def _ev_start(self) -> None:
        for _ in range(min(self.window, len(self.reqs))):
            self._issue()

    def _payload(self, r) -> np.ndarray:
        if self._payload_fn is not None:
            return self._payload_fn(r)
        return self._rng.integers(0, 256, (r.n_blocks, self._bb), dtype=np.uint8)

    def _issue(self) -> None:
        r = self.reqs[self._next]
        self._next += 1
        if r.op == "W":
            self.service.submit_write(self.tenant, r.lba, self._payload(r),
                                      cb=self._on_done)
        else:
            self.service.submit_read(self.tenant, r.lba, r.n_blocks,
                                     cb=self._on_done)

    def _on_done(self, req: IoRequest) -> None:
        if req.status == REJECTED:
            self.rejected += 1
        self.completed += 1
        if self._next < len(self.reqs):
            if self.think_time_us > 0:
                self.service.engine.after(self.think_time_us, self._issue)
            else:
                self._issue()

    def done(self) -> bool:
        return self.completed == len(self.reqs)
