"""Deterministic fault injection — the port's own copy of the part of
``tpulab/chaos.py`` its injection points use (tpulab_torch imports
nothing of tpulab); the semantics are identical.

A hot path plants a named **injection point**, one ``chaos.trip("<point>")``
call that costs one module-global ``is None`` branch while nothing is
armed.  Armed, a :class:`FaultSchedule` maps points to rules::

    with chaos.inject("engine.verify=error+1", seed=7) as sched:
        ...
    assert sched.fired("engine.verify") == 1

or through the environment, read once at import, so a replica process
inherits its parent's schedule::

    TPULAB_CHAOS="rpc.stream=kill@4" python -m tpulab_torch.fleet.replica_main

(``TPULAB_CHAOS_SEED`` seeds it).

Rule grammar (``;``-separated)::

    <point>=<action>[:<value>][@<after>][+<times>][%<prob>]

    action  error  raise ChaosError at the point (transient fault)
            delay  sleep <value> seconds
            drop   black-hole the operation (points that declare drop
                   support honor it; others treat it as error)
            kill   os._exit(86): process death
    @N      skip the first N occurrences of the point (default 0)
    +K      fire at most K times (default unlimited)
    %P      fire with probability P per eligible occurrence, drawn from
            the schedule's seeded RNG (default 1.0: deterministic)

Injection points planted in the port:

    rpc.client.unary          ClientUnary.start, before the call: error
                              fails the call's future; drop black-holes it
                              (the future resolves only by its timeout)
    rpc.client.stream_recv    ClientStreaming read loop, per response:
                              error tears the stream down like a dead
                              replica (the consumer sees the stream fail)
    rpc.server.generate_token GenerateContext dense loop, per token: error
                              ends the stream with a retryable INTERNAL
    rpc.stream                GenerateContext token-EMIT site, per token
                              (dense AND paged paths): error kills the
                              stream mid-flight with a retryable INTERNAL
                              (the batcher request is cancelled, its lane
                              and pages freed); drop latches the stream
                              STALLED: it stops emitting but stays open
                              with no final
    serving.admission         AdmissionController.admit: error/drop force
                              a RESOURCE_EXHAUSTED rejection (reason
                              ``chaos``), delay models a slow decision
    engine.step               GenerationSession.step, per dense decode
                              step: error ends that stream with INTERNAL
                              and returns its cache slot
    engine.verify   ContinuousBatcher speculative verify dispatch, once per
                    speculative dispatch BEFORE it is issued: error/drop
                    degrade the dispatch's lanes to plain decode blocks for
                    the rest of each request (nothing was emitted yet, so
                    never a corrupt or duplicated token)
    kvcache.swap    KVOffloadManager swap-out / restore / demote / promote
                    (tpulab_torch.kvcache), once per call: error/drop
                    degrade that swap to the pre-offload recompute path
                    (a preempted lane re-prefills, a prefix entry is
                    recomputed; the lane or entry is never corrupted, the
                    failure is counted in ``swap_failures``)
    device.transfer Bindings.copy_to_device (tpulab_torch.engine.buffers),
                    once per request before its inputs' copies: error
                    fails that request's dispatch, which returns its
                    buffers slot (no execution token is held yet) and
                    hands the exception to its future
    disagg.ship     KVShipper export / import (tpulab_torch.disagg), once
                    per call on each side: error/drop lose that KV
                    shipment, and the decode replica degrades to a local
                    prefill — never a corrupt lane or a stuck request
    fabric.pull     the fleet KV fabric (tpulab_torch.kvfabric), tripped
                    on BOTH sides of a cross-replica prefix fetch: the
                    owner's export (error/drop answer an honest
                    NOT_FOUND) and the fetcher's pull (error/drop abandon
                    the fetch); either way the request degrades to a
                    local prefill, never a corrupt or partial adoption
    modelstore.swap WeightMultiplexer swap-out / swap-in
                    (tpulab_torch.modelstore): error/drop at swap-out
                    lose that model's weight snapshot (its device memory
                    still frees; the next acquire cold-rebuilds), at
                    swap-in discard the host copy and serve a cold
                    rebuild instead: degraded weights are always REBUILT
                    weights, never a corrupt serve
    hbm.pressure    HBMArbiter decision sites (tpulab_torch.hbm): one trip
                    per pressed tenant per pressure round (demote-KV,
                    evict-model) and one at the denial — error/drop
                    suppress that decision, so the requester degrades to
                    its static-budget behavior (the multiplexer waits on
                    its own budget, the batcher queues on its current
                    pool).  The ledger is never touched on a tripped path
    batch.run       BatchScheduler run loop (tpulab_torch.batch), once per
                    scheduler pass: error/drop kill the batch runner
                    mid-job — in-flight items are cancelled, delivered
                    tokens stay in the JSONL checkpoint, and the next
                    run() resumes from them with zero re-decode
    fleet.route     GenerationReplicaSet._pick_affine, at the head of the
                    prefix-affinity decision: error fails the decision,
                    drop disables affinity for the request; both fall
                    back to the load-based pick
    fleet.spawn     spawn_with_retry (tpulab_torch.fleet.autoscaler), once
                    per provider spawn attempt: error fails the attempt,
                    drop models a spawn that never came up; both retry
                    with backoff
    fleet.probe     FleetSupervisor.probe, once per member classification:
                    error/drop forgo that member's probe this tick (no
                    evidence, retried next tick), so probe chaos delays
                    healing and never declares a healthy replica dead
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger("tpulab_torch.chaos")

#: the armed schedule; ``None`` (the default) is the one branch every
#: injection point pays
_ARMED: Optional["FaultSchedule"] = None

#: optional fire observer ``fn(point, action)`` (the metrics bridge,
#: :class:`tpulab_torch.utils.metrics.ChaosMetrics`); called only when a
#: rule fires, outside the schedule lock, before the action executes (so a
#: ``kill`` is counted on its way out)
_OBSERVER = None

_ACTIONS = ("error", "delay", "drop", "kill")

#: exit code of the ``kill`` action, distinguishable from a real crash
KILL_EXIT_CODE = 86


class ChaosError(RuntimeError):
    """The injected transient fault (``error`` action).  A RuntimeError on
    purpose: callers survive it through their generic failure handling."""


class FaultRule:
    """One point's behavior: action + occurrence window + probability."""

    __slots__ = ("point", "action", "value", "after", "times", "prob")

    def __init__(self, point: str, action: str, value: float = 0.0,
                 after: int = 0, times: Optional[int] = None,
                 prob: float = 1.0):
        if action not in _ACTIONS:
            raise ValueError(f"unknown chaos action {action!r} "
                             f"(want one of {_ACTIONS})")
        if not 0.0 <= prob <= 1.0:
            raise ValueError("prob must be in [0, 1]")
        self.point = point
        self.action = action
        self.value = float(value)
        self.after = int(after)
        self.times = times
        self.prob = float(prob)

    @classmethod
    def parse(cls, spec: str) -> "FaultRule":
        """``point=action[:value][@after][+times][%prob]``."""
        point, _, rhs = spec.partition("=")
        if not rhs:
            raise ValueError(f"chaos rule {spec!r}: want point=action[...]")
        kw = dict(value=0.0, after=0, times=None, prob=1.0)
        # peel modifiers right-to-left; each marker appears at most once
        for marker, key, conv in (("%", "prob", float), ("+", "times", int),
                                  ("@", "after", int)):
            if marker in rhs:
                rhs, _, raw = rhs.rpartition(marker)
                kw[key] = conv(raw)
        action, _, val = rhs.partition(":")
        if val:
            kw["value"] = float(val)
        return cls(point.strip(), action.strip(), **kw)

    def __repr__(self) -> str:
        return (f"FaultRule({self.point}={self.action}:{self.value}"
                f"@{self.after}+{self.times}%{self.prob})")


class FaultSchedule:
    """Seeded, deterministic rule set driving the injection points;
    occurrence counters and the RNG sit behind one lock."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._seen: Dict[str, int] = {}    # point -> occurrences observed
        self._fired: Dict[str, int] = {}   # point -> rule activations
        self._per_rule_fired = [0] * len(self.rules)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultSchedule":
        rules = [FaultRule.parse(part)
                 for part in spec.split(";") if part.strip()]
        return cls(rules, seed=seed)

    def occurrences(self, point: str) -> int:
        """How many times ``point`` was reached while armed."""
        with self._lock:
            return self._seen.get(point, 0)

    def fired(self, point: str) -> int:
        """How many times a rule activated at ``point``."""
        with self._lock:
            return self._fired.get(point, 0)

    def fired_snapshot(self) -> Dict[str, int]:
        """Copy of every point's activation count, diffed around a request
        window by the flight recorder to attribute a fired rule to the
        requests in flight."""
        with self._lock:
            return dict(self._fired)

    def seen_snapshot(self) -> Dict[str, int]:
        """Copy of every point's occurrence count (the debugz view)."""
        with self._lock:
            return dict(self._seen)

    def fire(self, point: str) -> Optional[str]:
        """Apply the first matching eligible rule.  Returns ``"drop"`` when
        a drop rule fires, raises :class:`ChaosError` for ``error``, sleeps
        for ``delay``, exits the process for ``kill``; None when nothing
        fires."""
        action = None
        value = 0.0
        with self._lock:
            n = self._seen.get(point, 0)
            self._seen[point] = n + 1
            for i, rule in enumerate(self.rules):
                if rule.point != point or n < rule.after:
                    continue
                if (rule.times is not None
                        and self._per_rule_fired[i] >= rule.times):
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                self._per_rule_fired[i] += 1
                self._fired[point] = self._fired.get(point, 0) + 1
                action, value = rule.action, rule.value
                break
        if action is None:
            return None
        obs = _OBSERVER
        if obs is not None:
            try:
                obs(point, action)
            except Exception:  # an observer must not change the injection
                pass
        log.debug("chaos: %s at %s (value=%s)", action, point, value)
        if action == "delay":
            if value > 0:
                time.sleep(value)
            return None
        if action == "error":
            raise ChaosError(f"injected fault at {point}")
        if action == "kill":
            os._exit(KILL_EXIT_CODE)
        return "drop"


def trip(point: str) -> Optional[str]:
    """THE injection point.  Disarmed cost: one global load + one branch.
    Returns ``"drop"`` when an armed drop rule fires."""
    s = _ARMED
    if s is None:
        return None
    return s.fire(point)


def arm(schedule: Optional[FaultSchedule]) -> None:
    """Install (or with ``None`` remove) the process-wide schedule."""
    global _ARMED
    _ARMED = schedule


def armed() -> Optional[FaultSchedule]:
    return _ARMED


def fired_snapshot() -> Dict[str, int]:
    """Per-point activation counts of the armed schedule ({} disarmed)."""
    s = _ARMED
    return {} if s is None else s.fired_snapshot()


def set_observer(fn) -> None:
    """Install (or with ``None`` remove) the process-wide fire observer
    ``fn(point, action)``."""
    global _OBSERVER
    _OBSERVER = fn


class inject:
    """Context manager arming a schedule (a :class:`FaultSchedule` or a
    spec string) for a ``with`` block; nested use restores the previously
    armed schedule on exit."""

    def __init__(self, schedule, seed: int = 0):
        if isinstance(schedule, str):
            schedule = FaultSchedule.parse(schedule, seed=seed)
        self.schedule = schedule
        self._prev: Optional[FaultSchedule] = None

    def __enter__(self) -> FaultSchedule:
        self._prev = _ARMED
        arm(self.schedule)
        return self.schedule

    def __exit__(self, *exc) -> None:
        arm(self._prev)


def _arm_from_env() -> None:
    """``TPULAB_CHAOS`` arms at import, so a replica process inherits the
    schedule through its environment (``TPULAB_CHAOS_SEED`` seeds it)."""
    spec = os.environ.get("TPULAB_CHAOS", "").strip()
    if not spec:
        return
    seed = int(os.environ.get("TPULAB_CHAOS_SEED", "0"))
    arm(FaultSchedule.parse(spec, seed=seed))
    log.warning("chaos armed from TPULAB_CHAOS=%r (seed=%d)", spec, seed)


_arm_from_env()
