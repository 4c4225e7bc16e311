"""Request and completion-queue objects for the async block-device front end.

The real ZapRAID is exposed as a user-space block device with a
completion-callback API (``zns_raid_write/read(..., cb_fn, args)``); this
module is that surface for the simulator.  An :class:`IoRequest` doubles as
the future: it is returned synchronously from ``submit_*``, carries the
callback, and is filled in (status, timestamps, read payload) by the
dispatcher when the device-completion event fires on the virtual timeline.

A single shared :class:`CompletionQueue` collects every finished request in
completion order -- including admission rejections, which complete with
``status == "rejected"`` like an NVMe error completion -- so an application
can poll/drain it exactly like a CQ instead of (or in addition to) taking
callbacks.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np

QUEUED = "queued"        # admitted, waiting in the tenant's submission queue
INFLIGHT = "inflight"    # dispatched onto the array, device time booking
DONE = "done"            # ack fired at the device-completion time
REJECTED = "rejected"    # admission control refused it (queue-depth cap)


@dataclasses.dataclass
class IoRequest:
    """One block-device command with future/callback semantics."""

    tenant: str
    op: str                                   # "R" | "W"
    lba: int
    n_blocks: int = 1
    data: Optional[np.ndarray] = None         # write payload (n_blocks, bb)
    cb_fn: Optional[Callable[["IoRequest"], None]] = None
    seq: int = -1                             # service-wide submission order
    t_submit: float = math.nan                # arrival at the service
    t_dispatch: float = math.nan              # pulled onto the array
    t_done: float = math.nan                  # device completion (+host cost)
    deadline: float = math.inf                # absolute; EDF key within class
    status: str = QUEUED
    result: Any = None                        # read payload once DONE
    bypass: bool = False                      # served via the cache tier fast
                                              # path, outside the QoS window
    trace_id: int = -1                        # async-span id in the obs
                                              # tracer (-1: not traced)

    def done(self) -> bool:
        return self.status in (DONE, REJECTED)

    def ok(self) -> bool:
        return self.status == DONE

    @property
    def queue_wait_us(self) -> float:
        return self.t_dispatch - self.t_submit

    @property
    def service_us(self) -> float:
        return self.t_done - self.t_dispatch

    @property
    def latency_us(self) -> float:
        return self.t_done - self.t_submit


class CompletionQueue:
    """Shared completion ring fed by the dispatcher in completion order."""

    def __init__(self):
        self._q: collections.deque[IoRequest] = collections.deque()
        self.pushed = 0

    def push(self, req: IoRequest) -> None:
        self._q.append(req)
        self.pushed += 1

    def drain(self) -> list[IoRequest]:
        """Pop everything currently completed (like reaping a CQ)."""
        out = list(self._q)
        self._q.clear()
        return out

    def __len__(self) -> int:
        return len(self._q)
