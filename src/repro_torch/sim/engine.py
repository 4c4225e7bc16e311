"""Discrete-event simulation core: virtual clock + event heap.

The engine is deliberately tiny: a monotonically advancing virtual clock in
microseconds and a heap of ``(time, seq, callback, args)`` entries.  Events
scheduled for the same instant fire in scheduling order (the ``seq``
tie-break), which keeps every run bit-deterministic for a given workload and
seed -- the property the timed-disorder consistency tests rely on.

Two conventions the rest of ``repro_torch.sim`` builds on:

* **Function-first, time-follows.**  The functional simulator executes state
  changes instantly at the moment an event fires; the timed device layer
  (``repro_torch.sim.device``) *books* the device time those operations would have
  occupied into the future.  Later events observe the bookings as queueing
  delay.  This gives latency-faithful results without rewriting the
  functional array as coroutines.
* **The I/O watermark.**  ``engine.io_watermark`` is bumped by every timed
  device operation to that operation's completion time.  A pipeline stage
  that wants to know "when did the device work triggered by this call
  finish?" resets the watermark to ``now`` before the call and reads it
  after -- the single-threaded event loop makes this race-free.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, Callable


class Engine:
    """Virtual clock (microseconds) + event heap."""

    def __init__(self):
        self.now: float = 0.0
        self.io_watermark: float = 0.0
        self._heap: list[tuple[float, int, Callable, tuple]] = []
        self._seq = 0
        self.events_fired = 0

    # -- scheduling ---------------------------------------------------------

    def at(self, t: float, fn: Callable, *args: Any) -> None:
        """Schedule ``fn(*args)`` at virtual time ``t`` (clamped to now)."""
        heapq.heappush(self._heap, (max(t, self.now), self._seq, fn, args))
        self._seq += 1

    def after(self, delay_us: float, fn: Callable, *args: Any) -> None:
        self.at(self.now + delay_us, fn, *args)

    # -- execution ----------------------------------------------------------

    def run(self, until: float = math.inf) -> int:
        """Fire events in time order until the heap drains (or ``until``).

        Returns the number of events fired.  The clock is left at the last
        fired event's time (it never runs ahead to ``until``: virtual time
        only advances when something happens).
        """
        fired = 0
        while self._heap and self._heap[0][0] <= until:
            t, _, fn, args = heapq.heappop(self._heap)
            self.now = t
            fn(*args)
            fired += 1
        self.events_fired += fired
        return fired

    def pending(self) -> int:
        return len(self._heap)

    def touch_io(self, t_done: float) -> None:
        """Record a timed device completion (see module docstring)."""
        if t_done > self.io_watermark:
            self.io_watermark = t_done

    def mark_io(self) -> float:
        """Reset the I/O watermark to ``now``; returns the mark."""
        self.io_watermark = self.now
        return self.now
