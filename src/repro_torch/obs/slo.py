"""SLO monitor: windowed-p99 observation driving dynamic admission.

The gap it closes: the QoS dispatcher's per-class in-flight
shares are static (frozen into the block service's ``QosClass``), so
a checkpoint burst sized for the average case still inflates the serving
tenant's tail when drives are slow, GC runs, or a drive is down.  The
monitor closes the loop:

* every ``interval_us`` of virtual time it computes the observed p99 of
  the protected tenant over the trailing ``window_us`` of completions
  (:meth:`repro_torch.sim.stats.LatencyRecorder.windowed_percentiles` -- the
  shared, empty-safe helper);
* if that p99 drifts past ``objective_p99_us``, it *halves* the target
  class's effective in-flight cap (``BlockDeviceService.class_caps``, a
  dispatcher-level override of the frozen class default) down to
  ``floor``;
* once the observed p99 sits back under ``restore_frac * objective``,
  the cap is restored one slot per tick -- multiplicative decrease,
  additive increase, the classic congestion-control shape, so recovery
  is fast and re-admission is gentle.

The monitor is an observe-and-actuate engine actor: it reads the sample
stream (never books device time) and writes exactly one knob.  With no
monitor constructed, ``class_caps`` stays empty and the dispatcher's
behavior is bit-identical to the static policy.
"""
from __future__ import annotations

import math
from typing import Optional


class SloMonitor:
    """Windowed-p99 feedback controller over a ``BlockDeviceService``."""

    def __init__(
        self,
        service,
        tenant: str,
        objective_p99_us: float,
        *,
        klass: str = "ckpt",
        op: str = "R",
        window_us: float = 2_000.0,
        interval_us: float = 500.0,
        min_samples: int = 12,
        floor: int = 1,
        restore_frac: float = 0.7,
        registry=None,
    ):
        self.service = service
        self.engine = service.engine
        self.tenant = tenant
        self.objective_p99_us = objective_p99_us
        self.klass = klass
        self.op = op
        self.window_us = window_us
        self.interval_us = interval_us
        self.min_samples = min_samples
        self.floor = max(1, floor)
        self.restore_frac = restore_frac
        self.registry = registry
        self.default_cap: Optional[int] = None   # resolved at first tick
        self.history: list[dict] = []     # one row per tick
        self.actions: list[dict] = []     # one row per cap change
        self._armed = False
        self._stopped = False

    # -- lifecycle ----------------------------------------------------------

    def start(self, at: float = 0.0) -> None:
        self._stopped = False
        if not self._armed:
            self._armed = True
            self.engine.at(max(at, self.engine.now), self._tick)

    def stop(self) -> None:
        self._stopped = True

    # -- controller ---------------------------------------------------------

    def _resolve_default_cap(self) -> int:
        if self.default_cap is None:
            for ten in self.service.tenants.values():
                if ten.qos.name == self.klass:
                    self.default_cap = ten.qos.max_inflight or \
                        self.service.max_inflight
                    break
            else:
                self.default_cap = self.service.max_inflight
        return self.default_cap

    def current_cap(self) -> int:
        return self.service.class_caps.get(self.klass,
                                           self._resolve_default_cap())

    def _set_cap(self, new: int, p99: float, n: int) -> None:
        self.service.class_caps[self.klass] = new
        self.actions.append({
            "t_us": self.engine.now, "cap": new, "p99_us": p99, "n": n,
        })
        # a freed/shrunk window changes who is eligible right now
        self.service._pump()

    def _tick(self) -> None:
        self._armed = False
        if self._stopped:
            return
        now = self.engine.now
        pct = self.service.recorder.windowed_percentiles(
            now - self.window_us, now, op=self.op, tenant=self.tenant
        )
        cap = self.current_cap()
        default = self._resolve_default_cap()
        p99 = pct["p99"]
        if pct["n"] >= self.min_samples and not math.isnan(p99):
            if p99 > self.objective_p99_us and cap > self.floor:
                self._set_cap(max(self.floor, cap // 2), p99, pct["n"])
            elif p99 < self.restore_frac * self.objective_p99_us \
                    and cap < default:
                self._set_cap(cap + 1, p99, pct["n"])
        self.history.append({
            "t_us": now, "n": pct["n"], "p99_us": p99,
            "cap": self.current_cap(),
        })
        if self.registry is not None:
            self.registry.set(f"slo/{self.tenant}/window_p99_us",
                              0.0 if math.isnan(p99) else p99)
            self.registry.set(f"slo/{self.klass}/cap", self.current_cap())
            if not math.isnan(p99):
                self.registry.observe(f"slo/{self.tenant}/p99_us", p99)
        if self.service._live > 0:
            self._armed = True
            self.engine.after(self.interval_us, self._tick)

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict:
        caps = [a["cap"] for a in self.actions]
        return {
            "objective_p99_us": self.objective_p99_us,
            "default_cap": self._resolve_default_cap(),
            "final_cap": self.current_cap(),
            "min_cap": min(caps) if caps else self._resolve_default_cap(),
            "n_shrinks": sum(
                1 for a, b in zip([self._resolve_default_cap()] + caps, caps)
                if b < a
            ),
            "n_restores": sum(
                1 for a, b in zip([self._resolve_default_cap()] + caps, caps)
                if b > a
            ),
            "ticks": len(self.history),
        }
