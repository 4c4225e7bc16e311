"""The traced run: ``torch.profiler`` over a steady stretch, reduced to what
the per-layer metrics read.

``capture(fn)`` runs ``fn`` under the profiler (CPU and CUDA activities)
inside the span ``bench.window`` and ends with a device synchronisation
inside it, so the window holds all the device work ``fn`` queued.  The raw
profiler events are reduced by :func:`reduce` into a :class:`Trace`:

* device intervals: kernels, copies and sets (no device-side annotations);
* host events: the operators and the benchmark's spans (``bench.*``), each
  thread's events nested by time, and each device interval owned by the
  operator that launched it (the profiler's correlation id);
* the busy time, the union of the device intervals inside the window (not
  a sum of kernel times, which counts overlap twice);
* the device time owned by an operator or a span and its descendants, and
  the number of outermost calls of an operator.

The reduction works on plain tuples, so it is tested without a card.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}


@dataclasses.dataclass
class Host:
    start: int
    end: int
    name: str
    tid: int
    id: int
    parent: "Host | None" = None


@dataclasses.dataclass
class Device:
    start: int
    end: int
    name: str
    link: int


def events_of(prof) -> tuple[list[Host], list[Device]]:
    """Host (frontend) and device events of a finished ``torch.profiler``
    session, times in ns."""
    from torch.autograd import DeviceType

    hosts, devices = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0 and not e.is_async():
                hosts.append(Host(start, end, e.name(), e.start_thread_id(), e.correlation_id()))
        elif _is_device_work(e):
            devices.append(Device(start, end, e.name(), e.linked_correlation_id()))
    return hosts, devices


def _is_device_work(e) -> bool:
    """A kernel, copy or set: not a device-side annotation (older profilers
    have no ``activity_type``; their annotations are user annotations)."""
    if e.is_user_annotation() or e.name().startswith("bench."):
        return False
    kind = getattr(e, "activity_type", None)
    return kind is None or kind() in DEVICE_ACTIVITIES


def _nest(hosts: list[Host]) -> None:
    """Set each host event's parent: the innermost event of its thread that
    contains it."""
    by_thread: dict[int, list[Host]] = defaultdict(list)
    for h in hosts:
        by_thread[h.tid].append(h)
    for evs in by_thread.values():
        evs.sort(key=lambda h: (h.start, -h.end))
        stack: list[Host] = []
        for h in evs:
            while stack and stack[-1].end < h.end:
                stack.pop()
            h.parent = stack[-1] if stack else None
            stack.append(h)


def _union(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of [start, end) intervals clipped to [lo, hi), sorted."""
    out: list[list[int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    hosts: list[Host]
    devices: list[Device]
    window: tuple[int, int]
    busy: list[tuple[int, int]]
    owner: dict[int, Host]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def _under(self, d: Device, name: str) -> bool:
        h = self.owner.get(d.link)
        while h is not None:
            if h.name == name:
                return True
            h = h.parent
        return False

    def device_s(self, name: str) -> float:
        """Seconds of device work launched under a host event called
        ``name`` (an operator or a span) or any of its descendants."""
        return sum(d.end - d.start for d in self.devices if self._under(d, name)) / 1e9

    def calls(self, name: str) -> int:
        """Outermost host events called ``name``."""
        def nested(h):
            p = h.parent
            while p is not None:
                if p.name == name:
                    return True
                p = p.parent
            return False
        return sum(1 for h in self.hosts if h.name == name and not nested(h))

    def top_device_ops(self, k: int = 10) -> list[list]:
        tot: dict[str, int] = defaultdict(int)
        for d in self.devices:
            tot[d.name[:200]] += d.end - d.start
        return [[n, t / 1e9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle device time inside the window, by the innermost benchmark
        span (``bench.*``) open on the host when each gap began."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted((h for h in self.hosts if h.name.startswith("bench.")),
                       key=lambda h: h.start)
        tot: dict[str, int] = defaultdict(int)
        for s, e in gaps:
            inner = None
            for h in spans:
                if h.start > s:
                    break
                if h.end > s and (inner is None or h.start >= inner.start):
                    inner = h
            tot[inner.name if inner else "outside spans"] += e - s
        return [[n, t / 1e9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def reduce(hosts: list[Host], devices: list[Device]) -> Trace:
    windows = [h for h in hosts if h.name == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"trace: expected one {WINDOW!r} span, found {len(windows)}")
    lo, hi = windows[0].start, windows[0].end
    _nest(hosts)
    owner = {h.id: h for h in hosts}
    devices = [d for d in devices if d.end > lo and d.start < hi]
    busy = _union(((d.start, d.end) for d in devices), lo, hi)
    return Trace(hosts, devices, (lo, hi), busy, owner)


def capture(fn) -> Trace:
    """Run ``fn()`` under the profiler inside the ``bench.window`` span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    return reduce(*events_of(prof))
