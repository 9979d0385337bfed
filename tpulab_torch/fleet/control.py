"""FleetController: one router node's control-plane loop (the port of
``tpulab/fleet/control.py``; its decisions are tpulab's).

Every router runs one of these; the lease (tpulab_torch.fleet.election)
decides which node's controller is ACTIVE.  Each :meth:`tick`:

- **elector tick** — renew or try to acquire the lease.
- **as leader**: run the supervisor probe (heal deaths), run one
  autoscaler evaluation (exactly one node may — concurrent autoscalers
  would spawn/retire against each other), then publish the membership
  snapshot under the fencing token.  A :class:`StaleLeaderError` on
  publish means leadership was lost mid-tick: the elector resigns and
  NONE of this node's membership writes land — the fencing guarantee.
- **as follower**: read the latest published snapshot and converge the
  local replica set on it (``apply_membership``): adopt new members,
  flag drains, tombstone retirements.  Followers keep routing the whole
  time; within one lease TTL of a leader death some follower's tick
  acquires the lease and the control loop continues.

Drive it from a thread (:meth:`start`/:meth:`stop`) or call
:meth:`tick` from your own loop/cron — the controller is edge-driven
and synchronous like the autoscaler it wraps.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

from tpulab_torch.fleet.election import (LeaderElector, StaleLeaderError,
                                         apply_membership,
                                         membership_snapshot)

log = logging.getLogger("tpulab_torch.fleet")

__all__ = ["FleetController"]


class FleetController:
    """Module docstring.  ``supervisor`` and ``autoscaler`` are
    optional — a node can follow membership without running either —
    but only a node that has them can usefully lead."""

    def __init__(self, replica_set, elector: LeaderElector,
                 supervisor=None, autoscaler=None, metrics=None,
                 journal=None):
        self._rs = replica_set
        self.elector = elector
        self.supervisor = supervisor
        self.autoscaler = autoscaler
        self._metrics = metrics
        #: control-plane event journal (tpulab_torch.obs.journal): the
        #: controller journals its OWN transitions — membership_publish
        #: (token + store seq + the view) and elect_fenced (a publish
        #: rejected by the fencing check mid-tick).  Pass the same
        #: journal to the elector/supervisor/autoscaler for the full
        #: takeover story in one file.
        self._journal = journal
        #: the last membership document this node published (leader) or
        #: applied (follower) — the one view leader and followers must
        #: agree on, surfaced in :meth:`snapshot` for the debugz fleet
        #: section
        self.last_membership: Optional[Dict[str, Any]] = None
        self._applied_seq = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: lifetime counters
        self.leader_ticks = 0
        self.follower_ticks = 0
        self.snapshots_applied = 0

    def tick(self) -> Dict[str, Any]:
        """One control pass.  Returns what happened (shape depends on
        role): ``{"leader": bool, ...}``."""
        with self._lock:
            leading = self.elector.tick()
            m = self._metrics
            if m is not None and hasattr(m, "set_leader"):
                m.set_leader(leading)
            return (self._leader_tick_locked() if leading
                    else self._follower_tick_locked())

    def _leader_tick_locked(self) -> Dict[str, Any]:
        self.leader_ticks += 1
        out: Dict[str, Any] = {"leader": True}
        if self.supervisor is not None:
            out["supervision"] = self.supervisor.probe()
        if self.autoscaler is not None:
            out["scale_action"] = self.autoscaler.evaluate()
        token = self.elector.fencing_token
        if token is not None:
            try:
                doc = self.elector.backend.publish_membership(
                    membership_snapshot(self._rs), token)
                out["published"] = True
                if doc is not None:
                    self.last_membership = doc
                    self._journal_event(
                        "membership_publish", token=int(doc["token"]),
                        store_seq=int(doc["seq"]),
                        members=doc.get("members", []),
                        draining=doc.get("draining", []),
                        retired=doc.get("retired", []))
            except StaleLeaderError:
                # fenced off mid-tick: a new leader exists; stand down
                log.warning("membership publish fenced (token %s); "
                            "resigning", token)
                self._journal_event("elect_fenced", token=int(token))
                self.elector.resign()
                out["leader"] = False
                out["fenced"] = True
        return out

    def _journal_event(self, kind: str, **fields) -> None:
        j = self._journal
        if j is None:
            return
        try:
            j.record(kind, node_id=self.elector.node_id, **fields)
        except Exception:  # noqa: BLE001 - journal must not break control
            log.exception("controller journal write failed")

    def _follower_tick_locked(self) -> Dict[str, Any]:
        self.follower_ticks += 1
        out: Dict[str, Any] = {"leader": False}
        snap = self.elector.backend.read_membership()
        if snap and int(snap.get("seq", 0)) > self._applied_seq:
            out["applied"] = apply_membership(self._rs, snap)
            self._applied_seq = int(snap["seq"])
            self.snapshots_applied += 1
            self.last_membership = snap
        return out

    # -- background loop ----------------------------------------------------
    def start(self, interval_s: float = 0.5) -> None:
        """Tick on a daemon thread every ``interval_s`` (keep it WELL
        under the lease TTL)."""
        if self._thread is not None:
            raise RuntimeError("controller already started")
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # the loop must outlive one bad tick
                    log.exception("fleet controller tick failed")

        self._thread = threading.Thread(target=run, name="fleet-control",
                                        daemon=True)
        self._thread.start()

    def stop(self, resign: bool = True) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if resign:
            self.elector.resign()

    def snapshot(self) -> Dict[str, Any]:
        """Debugz ``fleet`` section (docs/OBSERVABILITY.md): election +
        supervision + autoscaling state in one document."""
        out: Dict[str, Any] = {
            "election": self.elector.snapshot(),
            "leader_ticks": self.leader_ticks,
            "follower_ticks": self.follower_ticks,
            "snapshots_applied": self.snapshots_applied,
            # the published view this node last wrote (leader) or
            # converged on (follower): token + store seq + membership —
            # what leader and follower debugz must AGREE on
            "membership": self.last_membership,
        }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.snapshot()
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.snapshot()
        return out
