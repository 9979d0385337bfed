"""Queue-wait-driven fleet autoscaling: scale up on admission pressure,
drain before retiring on scale-down (the port of
``tpulab/fleet/autoscaler.py``; its decisions are tpulab's).

The reference ships Kubernetes examples precisely because at fleet scale
elasticity — not the chip — is the unit of cost (PAPER.md §0), and the
adaptive-orchestration line in PAPERS.md frames placement and elasticity
as ONE scheduling problem.  This controller is the elasticity half of
the fleet layer, deliberately built on signals the serving stack already
measures instead of inventing new ones:

- **scale-up** fires when the admission queue-wait EWMA
  (:attr:`tpulab_torch.serving.AdmissionController.queue_wait_ewma_s` — the
  time admitted requests actually spent queued, exported for exactly
  this) holds above ``up_wait_s`` for ``hold`` consecutive evaluations,
  OR when the replica set observes overload fast-fails
  (RESOURCE_EXHAUSTED rejections, ``replica_set.overloads``) at
  ``up_overloads`` or more per evaluation window.  Waiting requests and
  shed requests are the two faces of the same deficit.
- **scale-down** fires when the wait EWMA holds below ``down_wait_s``
  (and no overloads arrive) for ``hold`` evaluations with more than
  ``min_replicas`` active.  The victim — the least-loaded active
  replica, newest on ties — is never killed: it is marked **draining**
  (the new ``StatusResponse.draining`` field + the router-local flag, so
  no router sends it new work and the HRW ring re-ranks around it —
  minimal digest movement is the point of rendezvous hashing), the
  provider runs the existing drain path (readiness flips, in-flight
  unary AND token streams complete; tpulab_torch._api.InferenceManager.drain),
  and only a *drained* replica is retired.  An in-flight token stream on
  the victim finishes on the victim — token parity is test-enforced.

``ReplicaProvider`` is the pluggable boundary to real infrastructure: a
deployment implements spawn/drain/retire against its scheduler
(k8s/GCE/…); tests and bench use :class:`InProcessReplicaProvider`,
which spawns loopback replicas in this process — the same zero-infra
discipline the replica sets follow.

The controller is deliberately synchronous and edge-driven:
``evaluate()`` is ONE control tick (drive it from a cron, a test, or
``run_in_background``).  Drains complete asynchronously — ``evaluate()``
starts them and later ticks finish the retirement — so a slow drain
never blocks the scale-up path.  ``cooldown_s`` spaces actions;
``hold`` consecutive-breach evaluations de-flap both directions.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("tpulab_torch.fleet")

__all__ = ["ReplicaProvider", "InProcessReplicaProvider", "FleetAutoscaler",
           "spawn_with_retry"]


def spawn_with_retry(spawn_once: Callable[[], str], attempts: int = 4,
                     backoff_s: float = 0.05, cap_s: float = 2.0) -> str:
    """Run one provider spawn attempt under the ``fleet.spawn`` chaos
    trip, retrying with exponential backoff.  ``error`` fails the
    attempt outright; ``drop`` models a spawn that never comes up (the
    scheduler lost the request) — both degrade to retry-with-backoff,
    like every transient real-infrastructure spawn failure.  The final
    failure propagates: a fleet that cannot spawn at all must say so."""
    from tpulab_torch import chaos

    delay = backoff_s
    last: Optional[BaseException] = None
    for attempt in range(max(1, int(attempts))):
        try:
            if chaos.trip("fleet.spawn") == "drop":
                raise chaos.ChaosError("injected drop at fleet.spawn")
            return spawn_once()
        except Exception as e:  # noqa: BLE001 - every flavor retries
            last = e
            log.warning("fleet spawn attempt %d/%d failed (%s: %s); "
                        "retrying in %.2fs", attempt + 1, attempts,
                        type(e).__name__, e, delay)
            time.sleep(delay)
            delay = min(delay * 2, cap_s)
    assert last is not None
    raise last


class ReplicaProvider:
    """The infrastructure boundary: how replicas come to exist, drain
    and go away.  Implementations own the replica lifecycle; the
    autoscaler owns the *decision* and the routing-side bookkeeping."""

    def spawn(self) -> str:
        """Bring up one replica; returns its routable address."""
        raise NotImplementedError

    def drain(self, address: str, timeout_s: float = 30.0) -> bool:
        """Flip the replica draining (readiness false, Status reports
        ``draining=true``) and wait for in-flight work to finish.
        Returns True when fully drained within the budget — ``timeout_s``
        is a HARD cap on how long the call may block (the conformance
        contract both providers are tested against)."""
        raise NotImplementedError

    def retire(self, address: str) -> None:
        """Tear the (drained) replica down and release its resources."""
        raise NotImplementedError

    def is_alive(self, address: str) -> Optional[bool]:
        """Liveness evidence for the supervisor's drain-vs-death call:
        True/False when the provider can observe the replica's life
        directly (a subprocess it holds), None when it cannot (an
        address it never spawned — externally managed); None makes the
        supervisor fall back to RPC-probe-streak evidence alone."""
        return None


class InProcessReplicaProvider(ReplicaProvider):
    """Loopback replicas in this process (tests/bench): ``factory()``
    returns a SERVING :class:`tpulab_torch.InferenceManager` (``serve()``
    already called, ``server.bound_port`` live) or a ``(manager,
    closer)`` pair when extra teardown is needed — ``closer`` may be a
    callable or an object with ``shutdown()`` (e.g. the engine)."""

    def __init__(self, factory: Callable[[], object],
                 settle_s: float = 0.0):
        self._factory = factory
        #: drain settle window forwarded to InferenceManager.drain —
        #: 0 in-process (there is no external balancer to observe the
        #: readiness flip; tests must not wait 10 s for nothing)
        self._settle_s = settle_s
        self._lock = threading.Lock()
        self._replicas: Dict[str, tuple] = {}  # addr -> (manager, closer)

    def spawn(self) -> str:
        def once() -> str:
            made = self._factory()
            mgr, closer = made if isinstance(made, tuple) else (made, None)
            addr = f"127.0.0.1:{mgr.server.bound_port}"
            with self._lock:
                self._replicas[addr] = (mgr, closer)
            return addr
        return spawn_with_retry(once)

    def adopt(self, address: str, manager, closer=None) -> None:
        """Register an externally created replica (the fleet's seed
        members) so drain/retire can reach it."""
        with self._lock:
            self._replicas[address] = (manager, closer)

    def manager_of(self, address: str):
        with self._lock:
            entry = self._replicas.get(address)
        return None if entry is None else entry[0]

    def drain(self, address: str, timeout_s: float = 30.0) -> bool:
        with self._lock:
            entry = self._replicas.get(address)
        if entry is None:
            return True  # unknown = already gone
        mgr = entry[0]
        # timeout_s is a HARD cap (provider conformance contract, shared
        # with SubprocessReplicaProvider): InferenceManager.drain waits
        # max(timeout, settle_s), so an uncapped settle window would let
        # this call overstay the caller's budget
        return bool(mgr.drain(timeout=timeout_s,
                              settle_s=min(self._settle_s, timeout_s)))

    def is_alive(self, address: str) -> Optional[bool]:
        """An adopted/spawned in-process replica lives exactly as long
        as it remains registered; unknown addresses are None (no
        process to observe)."""
        with self._lock:
            return True if address in self._replicas else None

    def retire(self, address: str) -> None:
        with self._lock:
            entry = self._replicas.pop(address, None)
        if entry is None:
            return
        mgr, closer = entry
        try:
            mgr.shutdown()
        except Exception:  # pragma: no cover - teardown best-effort
            log.exception("retiring replica %s failed", address)
        if closer is not None:
            try:
                closer() if callable(closer) else closer.shutdown()
            except Exception:  # pragma: no cover
                log.exception("closing replica %s extras failed", address)

    def close(self) -> None:
        with self._lock:
            addrs = list(self._replicas)
        for a in addrs:
            self.retire(a)


class FleetAutoscaler:
    """The scale controller (module docstring).  ``replica_set`` is the
    routing membership it mutates (:class:`tpulab_torch.rpc.replica`
    ``_BaseReplicaSet`` surface: ``add_replica`` / ``set_draining`` /
    ``retire_replica`` / ``active_count`` / ``inflight`` /
    ``overloads``); ``provider`` owns replica lifecycle;
    ``wait_signal`` returns the current admission queue-wait EWMA in
    seconds (e.g. ``lambda: admission.queue_wait_ewma_s``, or a max over
    per-replica controllers) — None disables the wait trigger and only
    overloads can scale up.  ``metrics`` is an optional
    :class:`tpulab_torch.utils.metrics.FleetMetrics`."""

    def __init__(self, replica_set, provider: ReplicaProvider,
                 wait_signal: Optional[Callable[[], float]] = None,
                 up_wait_s: float = 0.5, down_wait_s: float = 0.05,
                 up_overloads: int = 1,
                 min_replicas: int = 1, max_replicas: int = 8,
                 hold: int = 2, cooldown_s: float = 0.0,
                 drain_timeout_s: float = 30.0, metrics=None,
                 batch_drain: Optional[Callable[[str], None]] = None,
                 journal=None,
                 slo_signal: Optional[Callable[[], float]] = None,
                 slo_scale_up: bool = False,
                 up_slo_burn: float = 10.0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self._rs = replica_set
        self._provider = provider
        self._wait_signal = wait_signal
        self.up_wait_s = float(up_wait_s)
        self.down_wait_s = float(down_wait_s)
        self.up_overloads = int(up_overloads)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.hold = max(1, int(hold))
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._metrics = metrics
        #: offline batch lane hook (tpulab_torch.batch, docs/SERVING.md
        #: "Offline batch lane"): called with the victim address the
        #: moment a scale-down drain starts, BEFORE the provider drain —
        #: batch work drains FIRST (the scheduler stops feeding and
        #: cancels its preemptible in-flight items, whose delivered
        #: tokens are already checkpointed), so the drain only waits on
        #: online streams.  Note the autoscaler already IGNORES batch
        #: pressure by construction: its wait signal is the admission
        #: queue-wait EWMA, which batch-class admissions never feed.
        self._batch_drain = batch_drain
        #: control-plane event journal (tpulab_torch.obs.journal): every
        #: decision lands with its evidence — scale_up / drain_start
        #: carry the wait-EWMA, overload delta and SLO burn the tick
        #: evaluated; drain_timeout and scale_down close the story
        self._journal = journal
        #: per-tenant SLO burn as a SECONDARY scale-up trigger
        #: (tpulab_torch.obs.slo.SLOTracker.scale_signal — already excludes
        #: the batch class), behind a default-OFF flag: burn-driven
        #: scaling is an operator opt-in, never a surprise.  Both the
        #: flag and the signal must be set for it to fire.
        self._slo_signal = slo_signal
        self.slo_scale_up = bool(slo_scale_up) and slo_signal is not None
        self.up_slo_burn = float(up_slo_burn)
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._last_overloads = int(getattr(replica_set, "overloads", 0))
        self._last_action_t = 0.0
        # one in-flight drain at a time: victim address + worker state
        self._drain_addr: Optional[str] = None
        self._drain_done = threading.Event()
        self._drain_ok = False
        #: counters (observability / test assertions)
        self.scale_ups = 0
        self.scale_downs = 0
        self.drains = 0

    # -- signals ------------------------------------------------------------
    def _queue_wait_s(self) -> float:
        if self._wait_signal is None:
            return 0.0
        try:
            return float(self._wait_signal())
        except Exception:  # a torn-down controller must not kill the loop
            log.exception("fleet wait_signal failed; treating as 0")
            return 0.0

    def _overload_delta(self) -> int:
        now = int(getattr(self._rs, "overloads", 0))
        delta = now - self._last_overloads
        self._last_overloads = now
        return max(0, delta)

    def _slo_burn(self) -> float:
        if not self.slo_scale_up:
            return 0.0
        try:
            return float(self._slo_signal())
        except Exception:  # a torn-down tracker must not kill the loop
            log.exception("fleet slo_signal failed; treating as 0")
            return 0.0

    def _journal_event(self, kind: str, **fields) -> None:
        j = self._journal
        if j is None:
            return
        try:
            j.record(kind, **fields)
        except Exception:  # noqa: BLE001 - journal must not break scaling
            log.exception("autoscaler journal write failed")

    # -- the control tick ---------------------------------------------------
    def evaluate(self) -> str:
        """One control tick.  Returns the action taken: ``""`` (none),
        ``"scale_up"``, ``"drain_started"``, ``"scale_down"`` (a drain
        completed and the victim retired), ``"draining"`` (a drain is
        still in flight — no new action starts under it)."""
        with self._lock:
            finished = self._finish_drain_locked()
            if finished:
                return "scale_down"
            if self._drain_addr is not None:
                return "draining"
            wait = self._queue_wait_s()
            overloads = self._overload_delta()
            slo_burn = self._slo_burn()  # 0.0 unless armed AND opted in
            self._note_signals(wait)
            active = self._rs.active_count
            burning = self.slo_scale_up and slo_burn >= self.up_slo_burn
            pressured = (overloads >= self.up_overloads
                         or (self._wait_signal is not None
                             and wait >= self.up_wait_s)
                         or burning)
            idle = (wait <= self.down_wait_s and overloads == 0
                    and not burning)
            self._up_streak = self._up_streak + 1 if pressured else 0
            self._down_streak = self._down_streak + 1 if idle else 0
            now = time.monotonic()
            cooling = now - self._last_action_t < self.cooldown_s
            evidence = {"wait_ewma_s": round(wait, 6),
                        "overload_delta": overloads}
            if self.slo_scale_up:
                evidence["slo_burn"] = round(slo_burn, 4)
            if (self._up_streak >= self.hold and not cooling
                    and active < self.max_replicas):
                self._up_streak = 0
                self._last_action_t = now
                return self._scale_up_locked(evidence)
            if (self._down_streak >= self.hold and not cooling
                    and active > self.min_replicas):
                self._down_streak = 0
                self._last_action_t = now
                return self._start_drain_locked(evidence)
        return ""

    # -- actions (CALLER HOLDS self._lock) ----------------------------------
    def _scale_up_locked(self, evidence: Optional[dict] = None) -> str:
        addr = self._provider.spawn()
        self._rs.add_replica(addr)
        self.scale_ups += 1
        log.info("fleet scale-up: added replica %s (active=%d)",
                 addr, self._rs.active_count)
        m = self._metrics
        if m is not None:
            m.note_scale(up=True)
            m.set_replicas(self._rs.active_count)
        self._journal_event("scale_up", address=addr,
                            active=self._rs.active_count,
                            **(evidence or {}))
        return "scale_up"

    def _pick_victim_locked(self) -> Optional[str]:
        """Least-loaded active replica; newest on ties (scale down what
        was scaled up).  The controlling router's own inflight view plus
        the server-reported queue hint — the same gauges routing uses."""
        active = self._rs.active_addresses()
        if len(active) <= self.min_replicas:
            return None
        inflight = dict(zip(self._rs.addresses, self._rs.inflight))
        hints = self._rs.load_hints()
        return min(reversed(active),
                   key=lambda a: (inflight.get(a, 0) + hints.get(a, 0)))

    def _start_drain_locked(self, evidence: Optional[dict] = None) -> str:
        victim = self._pick_victim_locked()
        if victim is None:
            return ""
        # routing first: no router-side pick may land on the victim from
        # this instant; the HRW ring re-ranks around it (ring_moves)
        self._rs.set_draining(victim, True)
        if self._batch_drain is not None:
            # batch drains first: preemptible work yields its lanes now
            # (delivered tokens are durable; the job resumes elsewhere/
            # later), so the provider drain below only waits on online
            # streams
            try:
                self._batch_drain(victim)
            except Exception:  # pragma: no cover - hook must not block
                log.exception("batch_drain hook failed for %s", victim)
        self.drains += 1
        m = self._metrics
        if m is not None:
            m.note_drain()
        self._drain_addr = victim
        self._drain_done.clear()
        self._drain_ok = False
        self._journal_event("drain_start", address=victim,
                            **(evidence or {}))
        log.info("fleet scale-down: draining replica %s", victim)

        def run() -> None:
            ok = False
            try:
                ok = self._provider.drain(victim,
                                          timeout_s=self.drain_timeout_s)
            except Exception:  # pragma: no cover - drain must not wedge
                log.exception("drain of %s failed", victim)
            self._drain_ok = ok
            self._drain_done.set()

        threading.Thread(target=run, name="fleet-drain",
                         daemon=True).start()
        return "drain_started"

    def _finish_drain_locked(self) -> bool:
        if self._drain_addr is None or not self._drain_done.is_set():
            return False
        victim = self._drain_addr
        self._drain_addr = None
        if not self._drain_ok:
            # drain timed out: keep the victim draining (it still serves
            # its stuck in-flight work, gets nothing new) and retry the
            # retirement on a later tick rather than dropping streams
            log.warning("drain of %s did not complete in %.1fs; replica "
                        "stays draining, retirement deferred",
                        victim, self.drain_timeout_s)
            self._journal_event("drain_timeout", address=victim,
                                timeout_s=self.drain_timeout_s)
            self._drain_addr = victim
            self._drain_done.clear()

            def retry() -> None:
                ok = False
                try:
                    ok = self._provider.drain(
                        victim, timeout_s=self.drain_timeout_s)
                except Exception:  # pragma: no cover
                    log.exception("drain retry of %s failed", victim)
                self._drain_ok = ok
                self._drain_done.set()

            threading.Thread(target=retry, name="fleet-drain-retry",
                             daemon=True).start()
            return False
        self._rs.retire_replica(victim)
        self._provider.retire(victim)
        self.scale_downs += 1
        log.info("fleet scale-down: retired drained replica %s "
                 "(active=%d)", victim, self._rs.active_count)
        m = self._metrics
        if m is not None:
            m.note_scale(up=False)
            m.set_replicas(self._rs.active_count)
        self._journal_event("scale_down", address=victim,
                            drain_ok=True,
                            active=self._rs.active_count)
        return True

    # -- telemetry ----------------------------------------------------------
    def _note_signals(self, wait_s: float) -> None:
        m = self._metrics
        if m is not None:
            m.set_queue_wait(wait_s)

    def wait_for_drain(self, timeout_s: float = 30.0) -> bool:
        """Test/bench convenience: block until the in-flight drain (if
        any) completes and the victim is retired.  Returns True when no
        drain remains pending."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._drain_addr is None:
                    return True
                self._finish_drain_locked()
                if self._drain_addr is None:
                    return True
            self._drain_done.wait(timeout=0.05)
        return False

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"scale_ups": self.scale_ups,
                    "scale_downs": self.scale_downs,
                    "drains": self.drains,
                    "draining": self._drain_addr,
                    "active": self._rs.active_count,
                    "slo_scale_up": self.slo_scale_up,
                    "up_slo_burn": self.up_slo_burn}
