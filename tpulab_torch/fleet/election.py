"""Lease-based leader election with fencing tokens (the port of
``tpulab/fleet/election.py``: the same lease protocol and the same
``lease.json`` / ``membership.json`` documents, so routers of either
package can share one lease directory).

N routers can each run a
:class:`~tpulab_torch.rpc.replica.GenerationReplicaSet` against one fleet
safely — routing is idempotent — but the CONTROL
decisions (``FleetAutoscaler.evaluate``, ``FleetSupervisor.probe``,
membership edits) must have exactly one author or two routers will
spawn/retire against each other.  The classic answer is a lease: one
record ``{holder, token, expires_at}`` in a store all routers share.
Whoever writes their name into an expired/absent lease leads; the
leader renews before the TTL runs out; when a leader dies, its lease
simply expires and the next ``tick()`` of any follower takes over —
bounded takeover in one TTL, no failure detector needed.

**Fencing token**: every acquisition (not renewal) increments a
monotonic counter, and every leader-authored write — here the
membership snapshot — carries it.  A paused/partitioned old leader that
wakes up and writes with its stale token is REJECTED
(:class:`StaleLeaderError`): the token is the proof-of-currency that
makes "at most one leader ACTS" true even when "at most one leader
THINKS it leads" transiently is not (the Chubby/fencing construction).

:class:`LeaseBackend` is the pluggable store boundary;
:class:`FileLeaseBackend` implements it over an ``fcntl.flock``-guarded
JSON file — correct for N routers on one host (tests, single-node
deployments) and shape-identical to an etcd/ZooKeeper/k8s-Lease
implementation.  This module is deliberately **stdlib-only**: a control
process can load it without importing (or paying for) the serving
stack.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

log = logging.getLogger("tpulab_torch.fleet")

__all__ = ["StaleLeaderError", "LeaseBackend", "FileLeaseBackend",
           "LeaderElector", "membership_snapshot", "apply_membership"]


class StaleLeaderError(RuntimeError):
    """A leader-authored write carried a fencing token older than the
    lease's current one: the author lost leadership and must stand
    down, not retry."""


class LeaseBackend:
    """The pluggable lease + membership store.  All methods are atomic
    with respect to each other."""

    def try_acquire(self, node_id: str, ttl_s: float) -> Optional[int]:
        """Acquire the lease iff it is absent, expired, or already ours.
        Returns the fencing token (a NEW, larger token on a fresh
        acquisition; the current one on an idempotent re-acquire), or
        None while someone else validly holds it."""
        raise NotImplementedError

    def renew(self, node_id: str, token: int, ttl_s: float) -> bool:
        """Extend our lease.  False = we no longer hold it (expired and
        taken, or fenced off) — the caller must stop leading NOW."""
        raise NotImplementedError

    def release(self, node_id: str, token: int) -> None:
        """Give the lease up early (clean shutdown hands off faster
        than TTL expiry)."""
        raise NotImplementedError

    def holder(self) -> Tuple[Optional[str], int]:
        """(current valid holder or None, current fencing token)."""
        raise NotImplementedError

    def publish_membership(self, snapshot: Dict[str, Any],
                           token: int) -> Optional[Dict[str, Any]]:
        """Leader-authored membership write, fenced: raises
        :class:`StaleLeaderError` unless ``token`` is the lease's
        current token.  Returns the published document (stamped with
        ``token`` and the store's monotonic ``seq``)."""
        raise NotImplementedError

    def read_membership(self) -> Optional[Dict[str, Any]]:
        """Latest published membership snapshot (followers poll this),
        or None before the first publication."""
        raise NotImplementedError


class FileLeaseBackend(LeaseBackend):
    """Module docstring: one ``fcntl.flock``-guarded directory holding
    ``lease.json`` and ``membership.json``.  ``clock`` is injectable so
    tests can expire leases without sleeping; real deployments share
    wall-clock time the way any TTL-lease system does (the TTL must
    dwarf clock skew)."""

    def __init__(self, path: str,
                 clock: Callable[[], float] = time.time):
        self._dir = path
        os.makedirs(path, exist_ok=True)
        self._lockpath = os.path.join(path, "lock")
        self._leasepath = os.path.join(path, "lease.json")
        self._memberpath = os.path.join(path, "membership.json")
        self._clock = clock

    # -- the one mutual-exclusion primitive ---------------------------------
    def _locked(self):
        import fcntl

        class _Lock:
            def __init__(self, path):
                self._path = path

            def __enter__(self):
                self._fd = os.open(self._path,
                                   os.O_RDWR | os.O_CREAT, 0o644)
                fcntl.flock(self._fd, fcntl.LOCK_EX)
                return self

            def __exit__(self, *exc):
                fcntl.flock(self._fd, fcntl.LOCK_UN)
                os.close(self._fd)

        return _Lock(self._lockpath)

    def _read(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def _write(path: str, doc: Dict[str, Any]) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: readers never see a torn file

    def _lease_locked(self) -> Tuple[Optional[Dict[str, Any]], float]:
        now = self._clock()
        lease = self._read(self._leasepath)
        return lease, now

    # -- LeaseBackend -------------------------------------------------------
    def try_acquire(self, node_id: str, ttl_s: float) -> Optional[int]:
        with self._locked():
            lease, now = self._lease_locked()
            if lease is not None and lease["expires_at"] > now:
                if lease["holder"] == node_id:
                    # idempotent re-acquire doubles as a renewal
                    lease["expires_at"] = now + ttl_s
                    self._write(self._leasepath, lease)
                    return int(lease["token"])
                return None
            token = int(lease["token"]) + 1 if lease else 1
            self._write(self._leasepath, {"holder": node_id,
                                          "token": token,
                                          "expires_at": now + ttl_s})
            return token

    def renew(self, node_id: str, token: int, ttl_s: float) -> bool:
        with self._locked():
            lease, now = self._lease_locked()
            if (lease is None or lease["holder"] != node_id
                    or int(lease["token"]) != int(token)
                    or lease["expires_at"] <= now):
                return False
            lease["expires_at"] = now + ttl_s
            self._write(self._leasepath, lease)
            return True

    def release(self, node_id: str, token: int) -> None:
        with self._locked():
            lease, now = self._lease_locked()
            if (lease is not None and lease["holder"] == node_id
                    and int(lease["token"]) == int(token)):
                lease["expires_at"] = 0.0  # expired; token preserved
                self._write(self._leasepath, lease)

    def holder(self) -> Tuple[Optional[str], int]:
        with self._locked():
            lease, now = self._lease_locked()
            if lease is None:
                return None, 0
            valid = lease["expires_at"] > now
            return (lease["holder"] if valid else None,
                    int(lease["token"]))

    def publish_membership(self, snapshot: Dict[str, Any],
                           token: int) -> Dict[str, Any]:
        with self._locked():
            lease, _ = self._lease_locked()
            current = int(lease["token"]) if lease else 0
            if int(token) != current:
                raise StaleLeaderError(
                    f"fencing token {token} is stale (current {current})")
            prev = self._read(self._memberpath)
            doc = dict(snapshot)
            doc["token"] = int(token)
            doc["seq"] = (int(prev["seq"]) + 1) if prev else 1
            self._write(self._memberpath, doc)
            return doc

    def read_membership(self) -> Optional[Dict[str, Any]]:
        with self._locked():
            return self._read(self._memberpath)


class LeaderElector:
    """One router's side of the lease protocol: call :meth:`tick` on
    every control-loop pass (period WELL under ``ttl_s`` — a leader
    that ticks slower than its TTL deposes itself).  ``metrics`` is an
    optional :class:`~tpulab_torch.utils.metrics.FleetMetrics`
    (``set_leader`` gauge + transition counter)."""

    def __init__(self, backend: LeaseBackend, node_id: Optional[str] = None,
                 ttl_s: float = 2.0, metrics=None, journal=None,
                 journal_renew_every: int = 0):
        self.backend = backend
        self.node_id = node_id or f"{os.uname().nodename}:{os.getpid()}"
        self.ttl_s = float(ttl_s)
        self._metrics = metrics
        #: control-plane event journal
        #: (tpulab_torch.obs.journal.EventJournal surface:
        #: ``record(kind, **fields)``) — injected as a plain
        #: object so this module stays stdlib-only.  Transitions journal
        #: as elect_acquire / elect_lost / elect_resign, each stamped
        #: with the fencing token; steady-state successful renewals are
        #: heartbeats, not transitions, and journal only every
        #: ``journal_renew_every``-th time (0 = never — the default;
        #: the lease file itself holds the live expiry).
        self._journal = journal
        self.journal_renew_every = int(journal_renew_every)
        self._token: Optional[int] = None
        self._lock = threading.Lock()
        #: observability counters
        self.acquisitions = 0
        self.losses = 0
        self.renews = 0

    def _journal_event(self, kind: str, **fields) -> None:
        j = self._journal
        if j is None:
            return
        try:
            j.record(kind, node_id=self.node_id, **fields)
        except Exception:  # noqa: BLE001 - journal must not break election
            log.exception("election journal write failed")

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._token is not None

    @property
    def fencing_token(self) -> Optional[int]:
        with self._lock:
            return self._token

    def tick(self) -> bool:
        """Renew-or-acquire.  Returns True when this node leads AFTER
        the tick."""
        with self._lock:
            if self._token is not None:
                if self.backend.renew(self.node_id, self._token,
                                      self.ttl_s):
                    self.renews += 1
                    if (self.journal_renew_every > 0
                            and self.renews
                            % self.journal_renew_every == 0):
                        self._journal_event("elect_renew",
                                            token=self._token,
                                            renews=self.renews)
                    return True
                # fenced or expired-and-taken: stand down immediately
                log.warning("leader lease lost by %s (token %s)",
                            self.node_id, self._token)
                lost_token, self._token = self._token, None
                self.losses += 1
                self._journal_event("elect_lost", token=lost_token)
                self._note(False)
                return False
            token = self.backend.try_acquire(self.node_id, self.ttl_s)
            if token is None:
                self._note(False)
                return False
            self._token = token
            self.acquisitions += 1
            log.info("leadership acquired by %s (fencing token %d)",
                     self.node_id, token)
            self._journal_event("elect_acquire", token=token)
            self._note(True)
            return True

    def resign(self) -> None:
        """Clean handoff: release the lease so a peer takes over on its
        next tick instead of waiting out the TTL."""
        with self._lock:
            if self._token is None:
                return
            try:
                self.backend.release(self.node_id, self._token)
            finally:
                released, self._token = self._token, None
                self.losses += 1
                self._journal_event("elect_resign", token=released)
                self._note(False)

    def _note(self, leading: bool) -> None:
        m = self._metrics
        if m is not None and hasattr(m, "set_leader"):
            m.set_leader(leading)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"node_id": self.node_id,
                    "is_leader": self._token is not None,
                    "fencing_token": self._token,
                    "ttl_s": self.ttl_s,
                    "acquisitions": self.acquisitions,
                    "losses": self.losses,
                    "renews": self.renews}


# -- membership snapshots (leader publishes, followers apply) -----------------
def membership_snapshot(replica_set) -> Dict[str, Any]:
    """The leader's view of the fleet, in addresses — the only identity
    that survives the process boundary."""
    states = replica_set.breaker_states()
    return {"members": replica_set.active_addresses(),
            "draining": sorted(replica_set.draining_addresses()),
            "retired": sorted(a for a, s in states.items()
                              if s == "retired")}


def apply_membership(replica_set, snapshot: Dict[str, Any]) -> Dict[str, int]:
    """Make a follower's replica set converge on the leader's published
    view: adopt unknown members, flag drains, tombstone retirements.
    Never un-drains and never un-retires — both are one-way transitions
    locally, and a follower that briefly lags the leader must not
    resurrect a dying replica.  Returns counts of actions taken."""
    known = set(replica_set.addresses)
    states = replica_set.breaker_states()
    added = drained = retired = 0
    for addr in snapshot.get("members", ()):
        if addr not in known:
            replica_set.add_replica(addr)
            added += 1
    for addr in snapshot.get("draining", ()):
        if addr not in known:
            continue  # never adopted it; nothing to drain
        if states.get(addr) not in ("draining", "retired"):
            replica_set.set_draining(addr, True)
            drained += 1
    for addr in snapshot.get("retired", ()):
        if addr in known and states.get(addr) != "retired":
            replica_set.retire_replica(addr)
            retired += 1
    return {"added": added, "drained": drained, "retired": retired}
