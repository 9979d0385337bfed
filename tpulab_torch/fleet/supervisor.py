"""FleetSupervisor: the self-healing half of the control plane (the port
of ``tpulab/fleet/supervisor.py``; its decisions are tpulab's).

The autoscaler (tpulab_torch.fleet.autoscaler) changes fleet SIZE on purpose;
this supervisor repairs fleet MEMBERSHIP when reality diverges from
intent — a replica process crashes, wedges, or gets OOM-killed.  Each
:meth:`probe` tick (drive it from a control loop or directly) classifies every member and feeds every membership change
through the replica set's tombstone surface (``retire_replica`` /
``add_replica``), so the HRW prefix-affinity ring re-homes only ~1/N of
digests per churn event — cache warmth survives a crash the same way it
survives a scale event.

Classification — the drain-vs-death distinction k8s gets from preStop
vs containerStatuses, reconstructed from our own evidence:

- **draining** (breaker state, set by the autoscaler or reported by the
  replica itself): deliberately finishing its work.  NEVER a death, no
  matter what probes say — the autoscaler owns its retirement.
- **dead**: the provider can see the process exited
  (``is_alive() is False``), or ``unreachable_probes`` consecutive RPC
  probe failures on a member whose liveness the provider cannot observe
  (a one-probe blip never kills a replica — transient loopback hiccups
  and chaos-injected probe faults degrade to retry-on-next-tick).
- **retired** (tombstoned by a completed scale-down): the lineage ends;
  nothing to heal.

A dead member is tombstoned immediately (routers stop picking it within
one tick) and its **lineage** — the slot, not the address — is
respawned under exponential backoff.  ``crash_loop_deaths`` deaths of
one lineage inside ``crash_loop_window_s`` open the **crash-loop
breaker**: the lineage is quarantined (no further spawn budget burned —
the CrashLoopBackOff analogue), ``FleetMetrics.crash_loops`` fires the
alert, and a human (or a config fix) calls :meth:`unquarantine`.

The ``fleet.probe`` chaos trip sits at the head of each member's
classification: ``error`` and ``drop`` both forgo that member's probe
this tick — evidence discarded, retried next tick — so injected probe
chaos can delay healing but never cause a spurious death.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

log = logging.getLogger("tpulab_torch.fleet")

__all__ = ["FleetSupervisor"]


class _Lineage:
    """One replica slot's history across respawns: the address changes
    on every respawn; the lineage (and its crash accounting) persists."""

    __slots__ = ("address", "deaths", "quarantined", "respawn_due",
                 "backoff_s", "streak", "respawns", "spawn_failures")

    def __init__(self, address: str):
        self.address = address
        self.deaths: deque = deque()        # death timestamps (window)
        self.quarantined = False
        self.respawn_due: Optional[float] = None
        self.backoff_s = 0.0
        self.streak = 0                     # consecutive failed probes
        self.respawns = 0
        self.spawn_failures = 0


class FleetSupervisor:
    """Module docstring.  ``replica_set`` is the routing membership
    (``_BaseReplicaSet`` surface), ``provider`` the replica lifecycle
    (:class:`~tpulab_torch.fleet.autoscaler.ReplicaProvider`); ``clock`` is
    injectable for sleepless backoff/window tests."""

    def __init__(self, replica_set, provider,
                 probe_timeout_s: float = 5.0,
                 respawn_backoff_s: float = 0.5,
                 respawn_backoff_cap_s: float = 30.0,
                 crash_loop_window_s: float = 60.0,
                 crash_loop_deaths: int = 3,
                 unreachable_probes: int = 3,
                 metrics=None, clock=time.monotonic, journal=None):
        self._rs = replica_set
        self._provider = provider
        #: control-plane event journal (tpulab_torch.obs.journal.EventJournal
        #: surface) — every classification lands as one structured
        #: event: replica_death (with its evidence — exit code vs probe
        #: streak — and the scheduled backoff), replica_respawn,
        #: spawn_failure, replica_quarantine / replica_unquarantine
        self._journal = journal
        self.probe_timeout_s = float(probe_timeout_s)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_backoff_cap_s = float(respawn_backoff_cap_s)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self.crash_loop_deaths = int(crash_loop_deaths)
        self.unreachable_probes = int(unreachable_probes)
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._lineages: Dict[str, _Lineage] = {}   # keyed by CURRENT addr
        #: lifetime counters (observability / test assertions)
        self.deaths = 0
        self.respawns = 0
        self.crash_loops = 0
        self.probes_forgone = 0

    # -- the control tick ---------------------------------------------------
    def probe(self) -> Dict[str, List[str]]:
        """One supervision tick: classify every member, heal what died.
        Returns the addresses acted on: ``{"deaths": [...], "respawns":
        [...], "quarantined": [...]}``."""
        from tpulab_torch import chaos

        actions: Dict[str, List[str]] = {"deaths": [], "respawns": [],
                                         "quarantined": []}
        now = self._clock()
        states = self._rs.breaker_states()
        with self._lock:
            self._adopt_locked(states)
        health = self._rs.health(timeout=self.probe_timeout_s)

        with self._lock:
            for lin in list(self._lineages.values()):
                addr = lin.address
                state = states.get(addr)
                if state == "retired":
                    # tombstoned underneath us: either our own death
                    # handling (respawn pending) or a completed
                    # scale-down — a graceful end of the lineage
                    if lin.respawn_due is None and not lin.quarantined:
                        del self._lineages[addr]
                    continue
                if state == "draining":
                    lin.streak = 0  # deliberate exit, not evidence
                    continue
                if lin.respawn_due is not None:
                    continue  # already dead, waiting out the backoff
                try:
                    if chaos.trip("fleet.probe") == "drop":
                        raise chaos.ChaosError(
                            "injected drop at fleet.probe")
                except chaos.ChaosError:
                    # probe forgone: no evidence this tick, retry next —
                    # injected probe chaos never kills a healthy replica
                    self.probes_forgone += 1
                    continue
                evidence = self._death_evidence_locked(addr, lin, health)
                if evidence is not None:
                    self._note_death_locked(lin, now, actions, evidence)
            self._respawn_due_locked(now, actions)
        return actions

    def _journal_event(self, kind: str, **fields) -> None:
        j = self._journal
        if j is None:
            return
        try:
            j.record(kind, **fields)
        except Exception:  # noqa: BLE001 - journal must not break healing
            log.exception("supervisor journal write failed")

    # -- classification (CALLER HOLDS self._lock) ---------------------------
    def _adopt_locked(self, states: Dict[str, str]) -> None:
        """Track every non-retired member the routing set knows —
        including replicas the autoscaler just added — as a lineage."""
        for addr, state in states.items():
            if state == "retired" or addr in self._lineages:
                continue
            if any(lin.address == addr for lin in self._lineages.values()):
                continue
            self._lineages[addr] = _Lineage(addr)

    def _death_evidence_locked(self, addr: str, lin: _Lineage,
                               health: Dict[str, dict]) -> Optional[dict]:
        """None = alive (or not yet provably dead); otherwise the
        structured evidence behind the death call — what the journal
        records and a postmortem reads first."""
        alive = None
        try:
            alive = self._provider.is_alive(addr)
        except Exception:  # pragma: no cover - evidence, not control
            pass
        if alive is False:
            # the process provably exited while not draining; the exit
            # code (when the provider held the process) distinguishes a
            # clean-but-unexpected exit from a crash or an injected kill
            exit_code = None
            try:
                if hasattr(self._provider, "exit_code"):
                    exit_code = self._provider.exit_code(addr)
            except Exception:  # pragma: no cover - evidence best-effort
                pass
            return {"evidence": "exit", "exit_code": exit_code}
        h = health.get(addr)
        reachable = bool(h and h.get("live"))
        if reachable:
            lin.streak = 0
            return None
        lin.streak += 1
        if lin.streak < self.unreachable_probes:
            return None
        # live-but-unreachable past the streak threshold: force the
        # teardown so the slot's resources actually free before respawn
        log.warning("replica %s unreachable for %d probes; declaring "
                    "dead", addr, lin.streak)
        return {"evidence": "probe_streak", "streak": lin.streak}

    def _note_death_locked(self, lin: _Lineage, now: float,
                           actions: Dict[str, List[str]],
                           evidence: Optional[dict] = None) -> None:
        addr = lin.address
        self._rs.retire_replica(addr)
        try:
            self._provider.retire(addr)  # reap / force-kill a zombie
        except Exception:  # pragma: no cover - teardown best-effort
            log.exception("reaping dead replica %s failed", addr)
        self.deaths += 1
        actions["deaths"].append(addr)
        m = self._metrics
        if m is not None and hasattr(m, "note_death"):
            m.note_death()
        lin.streak = 0
        lin.deaths.append(now)
        while lin.deaths and now - lin.deaths[0] > self.crash_loop_window_s:
            lin.deaths.popleft()
        if len(lin.deaths) >= self.crash_loop_deaths:
            # crash-loop breaker: stop burning spawn budget; page a human
            lin.quarantined = True
            lin.respawn_due = None
            self.crash_loops += 1
            actions["quarantined"].append(addr)
            if m is not None and hasattr(m, "note_crash_loop"):
                m.note_crash_loop()
            self._journal_event("replica_death", address=addr,
                                recent_deaths=len(lin.deaths),
                                **(evidence or {}))
            self._journal_event("replica_quarantine", address=addr,
                                recent_deaths=len(lin.deaths),
                                window_s=self.crash_loop_window_s)
            log.error("replica lineage %s crash-looped (%d deaths in "
                      "%.0fs): quarantined — unquarantine() to resume",
                      addr, len(lin.deaths), self.crash_loop_window_s)
            return
        lin.backoff_s = min(
            self.respawn_backoff_s * (2 ** (len(lin.deaths) - 1)),
            self.respawn_backoff_cap_s)
        lin.respawn_due = now + lin.backoff_s
        self._journal_event("replica_death", address=addr,
                            recent_deaths=len(lin.deaths),
                            respawn_backoff_s=lin.backoff_s,
                            **(evidence or {}))
        log.warning("replica %s died (%d recent deaths); respawn in "
                    "%.2fs", addr, len(lin.deaths), lin.backoff_s)

    def _respawn_due_locked(self, now: float,
                            actions: Dict[str, List[str]]) -> None:
        for old_addr, lin in list(self._lineages.items()):
            if (lin.quarantined or lin.respawn_due is None
                    or now < lin.respawn_due):
                continue
            try:
                new_addr = self._provider.spawn()
            except Exception:  # noqa: BLE001 - spawn failure = backoff
                lin.spawn_failures += 1
                lin.backoff_s = min(max(lin.backoff_s * 2,
                                        self.respawn_backoff_s),
                                    self.respawn_backoff_cap_s)
                lin.respawn_due = now + lin.backoff_s
                self._journal_event("spawn_failure", lineage=old_addr,
                                    spawn_failures=lin.spawn_failures,
                                    retry_in_s=lin.backoff_s)
                log.exception("respawn for lineage %s failed; next "
                              "attempt in %.2fs", old_addr, lin.backoff_s)
                continue
            self._rs.add_replica(new_addr)
            lin.respawn_due = None
            lin.respawns += 1
            self.respawns += 1
            actions["respawns"].append(new_addr)
            self._journal_event("replica_respawn", lineage=old_addr,
                                address=new_addr,
                                respawns=lin.respawns)
            m = self._metrics
            if m is not None and hasattr(m, "note_respawn"):
                m.note_respawn()
            # the lineage continues under its new address
            del self._lineages[old_addr]
            lin.address = new_addr
            self._lineages[new_addr] = lin
            log.info("replica lineage %s respawned as %s", old_addr,
                     new_addr)

    # -- operator surface ---------------------------------------------------
    def unquarantine(self, address: str) -> bool:
        """Re-arm a crash-looped lineage (after the underlying cause is
        fixed): clears the breaker and schedules an immediate respawn."""
        with self._lock:
            lin = self._lineages.get(address)
            if lin is None or not lin.quarantined:
                return False
            lin.quarantined = False
            lin.deaths.clear()
            lin.backoff_s = 0.0
            lin.respawn_due = self._clock()
            self._journal_event("replica_unquarantine", address=address)
            return True

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"deaths": self.deaths,
                    "respawns": self.respawns,
                    "crash_loops": self.crash_loops,
                    "probes_forgone": self.probes_forgone,
                    "lineages": {
                        a: {"quarantined": lin.quarantined,
                            "recent_deaths": len(lin.deaths),
                            "respawn_due_in_s":
                                (None if lin.respawn_due is None else
                                 round(lin.respawn_due - self._clock(),
                                       3)),
                            "unreachable_streak": lin.streak,
                            "respawns": lin.respawns,
                            "spawn_failures": lin.spawn_failures}
                        for a, lin in self._lineages.items()}}
