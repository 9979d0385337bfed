"""Per-tenant SLO burn rates over the flight-event stream (the port of
``tpulab/obs/slo.py``; pure Python).

An SLO is a budgeted promise: "99.9% of tenant X's online requests
succeed" leaves 0.1% of them as the **error budget**.  The *burn rate*
is the window's observed bad fraction divided by that budget: 1.0
exhausts the budget exactly over the objective period, 10 exhausts it
ten times early, 0 is a clean window.  Every objective is evaluated over
a **fast** window (~5 min) and a **slow** window (~1 h).

Two objectives per (tenant, request class), both read from the wide
events the flight recorder assembles (``flight.add_tap(tracker.observe)``):

- **availability**: a terminal outcome other than SUCCESS counts against
  the budget (client-side CANCELLED is excluded from both sides);
- **latency**: an ``e2e_s`` above ``latency_objective_s`` counts against
  the latency budget (``1 - latency_target``).

The **batch** request class is tracked but left out of
:meth:`SLOTracker.scale_signal`, the fast-window burn an autoscaler may
read as a secondary scale-up trigger.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

__all__ = ["SLOTracker"]

#: outcomes excluded from the availability objective entirely — the
#: client abandoned the request; the server did not fail it
_NEUTRAL_OUTCOMES = ("CANCELLED",)


class SLOTracker:
    """Multi-window burn-rate accounting per (tenant, request class).

    ``clock`` is injectable so tests can move time without sleeping;
    ``metrics`` is an optional
    :class:`~tpulab_torch.utils.metrics.SLOMetrics` (per-event counters are
    updated on :meth:`observe`; the burn-rate gauges on
    :meth:`export` — call it from the scrape/fleetz path, not per
    request).  ``max_tenants`` bounds label cardinality the way any
    per-tenant exporter must: events beyond the cap are counted
    (``tenants_dropped``), not tracked."""

    def __init__(self, availability_objective: float = 0.999,
                 latency_objective_s: float = 2.0,
                 latency_target: float = 0.95,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 max_tenants: int = 256,
                 events_per_key: int = 8192,
                 clock: Callable[[], float] = time.time,
                 metrics=None):
        if not 0.0 < availability_objective < 1.0:
            raise ValueError("availability_objective must be in (0, 1)")
        if not 0.0 < latency_target < 1.0:
            raise ValueError("latency_target must be in (0, 1)")
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        self.availability_objective = float(availability_objective)
        self.latency_objective_s = float(latency_objective_s)
        self.latency_target = float(latency_target)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.max_tenants = int(max_tenants)
        self.events_per_key = int(events_per_key)
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        # (tenant, request_class) -> deque of (t, error, breach)
        self._events: Dict[tuple, deque] = {}
        #: observability of the tracker itself
        self.observed_total = 0
        self.tenants_dropped = 0

    # -- ingestion (the flight-recorder tap) ---------------------------------
    def observe(self, event: Dict[str, Any]) -> None:
        """Account one completed request's wide event (flight-recorder
        schema: ``tenant``, ``request_class`` (absent = online),
        ``outcome``, ``e2e_s``).  Cheap and exception-free — it rides
        the request completion path."""
        outcome = str(event.get("outcome", "SUCCESS") or "SUCCESS")
        if outcome in _NEUTRAL_OUTCOMES:
            return
        tenant = str(event.get("tenant") or "anonymous")
        req_class = str(event.get("request_class") or "online")
        error = outcome not in ("SUCCESS", "")
        e2e = event.get("e2e_s")
        breach = (e2e is not None
                  and float(e2e) > self.latency_objective_s)
        now = float(self._clock())
        key = (tenant, req_class)
        with self._lock:
            ring = self._events.get(key)
            if ring is None:
                if len(self._events) >= self.max_tenants:
                    self.tenants_dropped += 1
                    return
                ring = deque(maxlen=self.events_per_key)
                self._events[key] = ring
            ring.append((now, error, breach))
            self.observed_total += 1
        m = self._metrics
        if m is not None:
            m.note_request(tenant, req_class, error=error, breach=breach)

    # -- burn rates ----------------------------------------------------------
    def _window_locked(self, ring: deque, now: float,
                       window_s: float) -> Dict[str, float]:
        cutoff = now - window_s
        n = errors = breaches = 0
        for t, err, br in ring:
            if t < cutoff:
                continue
            n += 1
            errors += err
            breaches += br
        avail_budget = 1.0 - self.availability_objective
        lat_budget = 1.0 - self.latency_target
        return {"requests": n, "errors": errors, "breaches": breaches,
                "availability_burn":
                    (errors / n) / avail_budget if n else 0.0,
                "latency_burn":
                    (breaches / n) / lat_budget if n else 0.0}

    def burn_rates(self) -> Dict[str, Dict[str, Dict[str, dict]]]:
        """``{tenant: {request_class: {"fast": {...}, "slow": {...}}}}``
        with per-window request/error counts and both burn rates —
        the fleetz/debugz document."""
        now = float(self._clock())
        out: Dict[str, Dict[str, Dict[str, dict]]] = {}
        with self._lock:
            keys = list(self._events.items())
        for (tenant, req_class), ring in keys:
            with self._lock:
                # prune anything older than the slow window so a
                # long-lived tracker's memory tracks traffic, not uptime
                cutoff = now - self.slow_window_s
                while ring and ring[0][0] < cutoff:
                    ring.popleft()
                fast = self._window_locked(ring, now, self.fast_window_s)
                slow = self._window_locked(ring, now, self.slow_window_s)
            out.setdefault(tenant, {})[req_class] = {"fast": fast,
                                                     "slow": slow}
        return out

    def scale_signal(self) -> float:
        """The autoscaler's secondary trigger: the worst fast-window
        burn rate (availability or latency) over NON-batch classes.
        Batch is excluded by construction — deferrable work must not
        scale the fleet."""
        worst = 0.0
        for tenant_rates in self.burn_rates().values():
            for req_class, windows in tenant_rates.items():
                if req_class == "batch":
                    continue
                fast = windows["fast"]
                worst = max(worst, fast["availability_burn"],
                            fast["latency_burn"])
        return worst

    # -- export --------------------------------------------------------------
    def export(self) -> Dict[str, Dict[str, Dict[str, dict]]]:
        """Refresh the ``_slo_*`` burn gauges (when ``metrics`` is
        armed) and return the burn-rate document — call from the
        scrape/fleetz path."""
        rates = self.burn_rates()
        m = self._metrics
        if m is not None:
            for tenant, per_class in rates.items():
                for req_class, windows in per_class.items():
                    for window, vals in windows.items():
                        m.set_burn(tenant, req_class, window,
                                   vals["availability_burn"],
                                   vals["latency_burn"])
        return rates

    def snapshot(self) -> Dict[str, Any]:
        """Objectives + current burn document (debugz/fleetz section)."""
        return {"availability_objective": self.availability_objective,
                "latency_objective_s": self.latency_objective_s,
                "latency_target": self.latency_target,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "observed_total": self.observed_total,
                "tenants_dropped": self.tenants_dropped,
                "burn_rates": self.burn_rates()}
