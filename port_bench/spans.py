"""Device time, launches and idle gaps of a traced run, put down to the
program's own spans (the port's ``repro_torch/obs/spans.py``).

Two rules tie a device interval (kernel, copy or set) to a span, both
through the host operator that launched it (``Trace.owner``):

* **nested**: the operator nests, on its own thread, under a span of that
  name (``Trace.device_s``' rule);
* **during**: the operator began while a span of that name was open, on any
  thread.  Autograd launches the backward's kernels, remat's recompute
  among them, from a thread of its own while the calling thread waits
  inside the span, so the forward and the backward need this rule.

The span names are spelled here rather than imported from the program, so
that the readers run against a program without spans and find nothing.
Every function reads only the public fields of ``trace.Trace``.
"""
from __future__ import annotations

import bisect

FORWARD = "repro_torch.forward"
BACKWARD = "repro_torch.backward"
ADAMW = "repro_torch.adamw"
MAMBA = "repro_torch.mamba"
ATTENTION = "repro_torch.attention"
SERVE = "repro_torch.serve"
PREFILL = "repro_torch.prefill"
NAMES = (FORWARD, BACKWARD, ADAMW, MAMBA, ATTENTION, SERVE, PREFILL)
SCAN = "repro_torch::ssd_scan"   # the SSD scan's operator (kernels/ssd_scan.py)


def opened(trace, name: str) -> list:
    """The host spans called ``name``."""
    return [h for h in trace.hosts if h.name == name]


class _Open:
    """The union of host intervals, asked whether a time lies inside it."""

    def __init__(self, hosts):
        merged: list[list[int]] = []
        for h in sorted(hosts, key=lambda h: h.start):
            if merged and h.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], h.end)
            else:
                merged.append([h.start, h.end])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def __bool__(self) -> bool:
        return bool(self.starts)

    def __contains__(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ends[i]


def during(trace, *names: str) -> list:
    """Device intervals launched by an operator that began while a span
    called one of ``names`` was open, on any thread."""
    inside = _Open(h for h in trace.hosts if h.name in names)
    if not inside:
        return []
    out = []
    for d in trace.devices:
        h = trace.owner.get(d.link)
        if h is not None and h.start in inside:
            out.append(d)
    return out


def nested(trace, name: str, *, began_during: str | None = None,
           outside: str | None = None) -> list:
    """Device intervals launched under a span called ``name`` on the
    launching thread; with ``began_during``, only under such a span that
    began while a span of that name was open (on any thread); with
    ``outside``, not under a host event called ``outside``."""
    began = _Open(opened(trace, began_during)) if began_during else None
    out = []
    for d in trace.devices:
        h, hit = trace.owner.get(d.link), False
        while h is not None:
            if h.name == outside:
                hit = False
                break
            if h.name == name and (began is None or h.start in began):
                hit = True
            h = h.parent
        if hit:
            out.append(d)
    return out


def device_s(devices) -> float:
    """Summed seconds of device intervals."""
    return sum(d.end - d.start for d in devices) / 1e9


def union_s(trace, devices) -> float:
    """Seconds of the union of device intervals, inside the traced window."""
    lo, hi = trace.window
    total, reach = 0, lo
    for s, e in sorted((max(d.start, lo), min(d.end, hi)) for d in devices):
        s = max(s, reach)
        if e > s:
            total += e - s
            reach = e
    return total / 1e9


def gaps(trace) -> list[tuple[int, int]]:
    """The card's idle intervals inside the traced window."""
    lo, hi = trace.window
    edges = [lo] + [x for iv in trace.busy for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def serve_idle_s(trace) -> float | None:
    """Idle seconds of the card in gaps that begin while the serving thread
    is inside a ``SERVE`` span and outside a ``PREFILL`` span: the cost of
    the serve loop's own host work and synchronisations.  None without a
    ``SERVE`` span."""
    serves = opened(trace, SERVE)
    if not serves:
        return None
    tids = {h.tid for h in serves}
    serving = _Open(serves)
    prefill = _Open(h for h in opened(trace, PREFILL) if h.tid in tids)
    return sum(e - s for s, e in gaps(trace) if s in serving and s not in prefill) / 1e9
