"""Span tracing on the virtual clock (Chrome/Perfetto ``trace_event`` JSON).

The timed stack already *knows* every interval a request spends somewhere
-- submission-queue wait, QoS dispatch, cache probe, group commit barrier,
per-drive channel service, degraded decode -- because those intervals are
exactly the bookings the discrete-event engine computes.  The tracer turns
them into a `trace_event`_ JSON file a tail request can be opened in
(``chrome://tracing`` or https://ui.perfetto.dev).

Two span families map onto the two shapes the format offers:

* **request-scoped spans** -- one async-nestable track per
  the block service's ``IoRequest`` (``ph: "b"/"e"/"n"`` events
  keyed by the request's service-wide ``seq``).  Requests overlap freely
  in virtual time, so they cannot share a synchronous thread track;
  async ids give every request its own nested lane
  (``io.request`` > ``sq.wait`` / ``device.service``, with
  ``qos.dispatch`` / ``cache.bypass`` / ``admission.reject`` instants).
* **resource-scoped spans** -- complete events (``ph: "X"``) on named
  tracks (``drive0``..``driveN``, ``cache-dev``, ``array``): Zone
  Write / Zone Append / read channel service, commit-barrier waits, GC
  and rebuild passes, degraded decodes.  Tracks are materialized as
  threads of one synthetic process; export greedily packs overlapping
  spans of a track into lanes (``drive0``, ``drive0 #1``, ...) so the
  viewer never renders mis-nested slices.

Timestamps are the engine's virtual microseconds verbatim -- the
``trace_event`` ``ts`` unit -- so the viewer's ruler *is* the simulated
timeline.  The tracer is observe-only: it never books device time, never
touches the engine, and every hook site guards on ``tracer is None``
(the default), so tracing-off runs execute the exact same instruction
stream as before the hooks existed.
"""
from __future__ import annotations

import json
from typing import Optional

TRACE_PID = 1
_LANES_PER_TRACK = 64   # tid stride reserved per resource track


class Tracer:
    """Collects virtual-time spans; exports Chrome ``trace_event`` JSON."""

    def __init__(self, engine=None, *, max_events: int = 500_000):
        self.engine = engine
        self.max_events = max_events
        self.events: list[dict] = []   # resource X-spans + request async events
        self.dropped = 0
        self._tracks: dict[str, int] = {}   # track name -> base tid

    # -- recording ----------------------------------------------------------

    def _room(self) -> bool:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return False
        return True

    def _track_tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks) * _LANES_PER_TRACK
            self._tracks[track] = tid
        return tid

    def span(self, track: str, name: str, t0: float, t1: float,
             cat: str = "device", **args) -> None:
        """Record a completed span ``[t0, t1]`` on a resource track."""
        if not self._room():
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": float(t0), "dur": max(0.0, float(t1) - float(t0)),
            "pid": TRACE_PID, "tid": self._track_tid(track),
            "args": args,
        })

    def instant(self, track: str, name: str, t: float,
                cat: str = "mark", **args) -> None:
        if not self._room():
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": float(t), "pid": TRACE_PID,
            "tid": self._track_tid(track), "args": args,
        })

    # request-scoped async-nestable spans (id = IoRequest.seq)

    def _req(self, ph: str, rid: int, name: str, t: float, args: dict) -> None:
        if not self._room():
            return
        self.events.append({
            "name": name, "cat": "request", "ph": ph,
            "ts": float(t), "pid": TRACE_PID, "tid": 0,
            "id": f"req{rid}", "args": args,
        })

    def req_begin(self, rid: int, name: str, t: float, **args) -> None:
        self._req("b", rid, name, t, args)

    def req_end(self, rid: int, name: str, t: float, **args) -> None:
        self._req("e", rid, name, t, args)

    def req_instant(self, rid: int, name: str, t: float, **args) -> None:
        self._req("n", rid, name, t, args)

    def clear(self) -> None:
        """Discard everything recorded so far (see ``precondition``)."""
        self.events.clear()
        self.dropped = 0

    # -- export -------------------------------------------------------------

    def _packed_lanes(self) -> tuple[list[dict], dict[int, str]]:
        """Assign overlapping X-spans of each track to disjoint lanes.

        Returns the event list with lane-adjusted tids plus the tid ->
        display-name map for the thread_name metadata records."""
        names: dict[int, str] = {}
        by_track: dict[int, list[dict]] = {}
        out: list[dict] = []
        for ev in self.events:
            if ev["ph"] == "X":
                by_track.setdefault(ev["tid"], []).append(ev)
            else:
                out.append(ev)
        track_of = {tid: name for name, tid in self._tracks.items()}
        for base, spans in by_track.items():
            spans.sort(key=lambda e: (e["ts"], -e["dur"]))
            lane_free: list[float] = []
            for ev in spans:
                for lane, t_free in enumerate(lane_free):
                    if ev["ts"] >= t_free - 1e-9:
                        break
                else:
                    lane = len(lane_free)
                    lane_free.append(0.0)
                lane = min(lane, _LANES_PER_TRACK - 1)
                lane_free[lane] = ev["ts"] + ev["dur"]
                ev = dict(ev, tid=base + lane)
                tname = track_of.get(base, f"track{base}")
                names[ev["tid"]] = tname if lane == 0 else f"{tname} #{lane}"
                out.append(ev)
        return out, names

    def to_trace_events(self) -> list[dict]:
        """The full ``traceEvents`` list, metadata records included."""
        events, names = self._packed_lanes()
        meta = [{
            "name": "process_name", "ph": "M", "pid": TRACE_PID, "tid": 0,
            "ts": 0.0, "args": {"name": "zapraid-sim"},
        }]
        for tid in sorted(names):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": TRACE_PID,
                "tid": tid, "ts": 0.0, "args": {"name": names[tid]},
            })
        events.sort(key=lambda e: (e["ts"], e["tid"]))
        return meta + events

    def export(self, path: str) -> dict:
        """Write Perfetto-loadable JSON; returns summary counters."""
        events = self.to_trace_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
            f.write("\n")
        return {"events": len(events), "dropped": self.dropped}


def validate_trace_events(events: list[dict]) -> None:
    """Schema check for an exported ``traceEvents`` list.

    Raises ``AssertionError`` on the first malformed record: every event
    needs name/ph/pid/ts, complete events need a non-negative ``dur``,
    async begin/end events must balance per (id, name) with begin <= end
    and children strictly nested inside their ``io.request`` root.
    """
    open_stack: dict[str, list[tuple[str, float]]] = {}
    for ev in events:
        assert isinstance(ev.get("name"), str) and ev["name"], ev
        assert ev.get("ph") in ("X", "B", "E", "b", "e", "n", "i", "M"), ev
        assert isinstance(ev.get("pid"), int), ev
        assert isinstance(ev.get("ts"), (int, float)), ev
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), (int, float)) and ev["dur"] >= 0, ev
        if ev["ph"] in ("b", "e", "n"):
            assert isinstance(ev.get("id"), str) and ev["id"], ev
        if ev["ph"] == "b":
            open_stack.setdefault(ev["id"], []).append((ev["name"], ev["ts"]))
        elif ev["ph"] == "e":
            stack = open_stack.get(ev["id"])
            assert stack, f"async end without begin: {ev}"
            name, t0 = stack.pop()
            assert name == ev["name"], f"mis-nested async spans: {ev} vs {name}"
            assert ev["ts"] >= t0, f"span ends before it begins: {ev}"
    leftovers = {k: v for k, v in open_stack.items() if v}
    assert not leftovers, f"unclosed async spans: {leftovers}"
