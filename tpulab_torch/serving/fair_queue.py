"""Deficit-round-robin fair queue over per-tenant FIFOs (the port's own
copy of ``tpulab/serving/fair_queue.py``).

The admission queue (serving/admission.py) must not be a single FIFO: one
greedy tenant filling it turns every other tenant's requests into
tail-of-queue stragglers — the starvation mode the "millions of users"
north star makes routine, and the cost/fairness balancing the
adaptive-orchestration line in PAPERS.md argues a shared frontend needs.
Deficit round robin (Shreedhar & Varghese) gives cost-weighted fairness
with O(1) amortized work: each tenant owns a FIFO and a deficit counter;
visiting a tenant replenishes its deficit by ``quantum`` cost units, and
its head request is served once the deficit covers the request's cost.
Tenants submitting cheap requests therefore drain more of them per round;
tenants submitting expensive ones wait proportionally — but *every*
tenant is visited every round, so none starves.

Entries are any objects exposing ``tenant`` (str), ``cost`` (number, in
the same units as ``quantum`` — here estimated tokens), ``priority``
(int, higher = more important) and ``seq`` (int arrival order).  Within a
tenant, higher priority dequeues first (FIFO inside a class) — the same
ordering ContinuousBatcher applies post-admission.

NOT thread-safe: the caller (AdmissionController) holds its own lock.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional


class DeficitRoundRobinQueue:
    """Cost-weighted fair queue across tenants (module docstring)."""

    def __init__(self, quantum: int = 512):
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        self.quantum = int(quantum)
        self._fifos: Dict[str, Deque[object]] = {}
        self._ring: List[str] = []    # active-tenant rotation order
        self._cursor = 0              # next tenant to visit
        self._deficit: Dict[str, float] = {}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def tenants(self) -> List[str]:
        return list(self._ring)

    def depths(self) -> Dict[str, int]:
        """Queued entries per tenant (the debugz live view)."""
        return {t: len(q) for t, q in self._fifos.items()}

    def deficit_of(self, tenant: str) -> float:
        """The tenant's carried DRR deficit (0.0 for idle tenants) —
        sampled into admission tickets so a wide event can say how much
        fair-queue credit the request's tenant held at dispatch."""
        return self._deficit.get(tenant, 0.0)

    def push(self, item) -> None:
        """Enqueue; higher ``priority`` jumps ahead within the tenant's
        FIFO (stable within a priority class)."""
        t = item.tenant
        q = self._fifos.get(t)
        if q is None:
            q = self._fifos[t] = deque()
            self._deficit[t] = 0.0
            # new tenants join BEHIND the cursor: they wait their turn in
            # the current round instead of jumping the rotation
            self._ring.insert(self._cursor, t)
            if len(self._ring) > 1:
                self._cursor = (self._cursor + 1) % len(self._ring)
        if q and item.priority > q[-1].priority:
            # rare path (priority inversions inside one tenant's backlog):
            # walk from the tail to keep the common FIFO append O(1)
            i = len(q)
            while i > 0 and q[i - 1].priority < item.priority:
                i -= 1
            q.insert(i, item)
        else:
            q.append(item)
        self._len += 1

    def _drop_tenant(self, tenant: str) -> None:
        i = self._ring.index(tenant)
        self._ring.pop(i)
        if i < self._cursor:
            self._cursor -= 1
        if self._ring:
            self._cursor %= len(self._ring)
        else:
            self._cursor = 0
        del self._fifos[tenant]
        del self._deficit[tenant]

    def pop(self) -> Optional[object]:
        """Next entry in DRR order (None when empty).  Terminates because
        every full rotation adds ``quantum`` to each non-empty tenant's
        deficit, so some head request becomes affordable."""
        if not self._len:
            return None
        while True:
            tenant = self._ring[self._cursor]
            q = self._fifos[tenant]
            head = q[0]
            deficit = self._deficit[tenant] + self.quantum
            if deficit >= head.cost:
                q.popleft()
                self._len -= 1
                if q:
                    # carry the surplus, but advance: one entry per visit
                    # keeps the rotation granularity; the carried deficit
                    # is what weights cheap-request tenants up
                    self._deficit[tenant] = deficit - head.cost
                    self._cursor = (self._cursor + 1) % len(self._ring)
                else:
                    self._drop_tenant(tenant)  # idle tenants keep no credit
                return head
            self._deficit[tenant] = deficit
            self._cursor = (self._cursor + 1) % len(self._ring)

    def requeue_front(self, item, refund: float = 0.0) -> None:
        """Put a popped entry back at the head of its tenant's FIFO (the
        dispatcher could not place it yet — e.g. the KV pool can't hold
        its cost).  ``refund`` restores the deficit the pop charged; a
        dropped tenant rejoins the ring at the cursor so it is visited
        next."""
        t = item.tenant
        q = self._fifos.get(t)
        if q is None:
            q = self._fifos[t] = deque()
            self._deficit[t] = 0.0
            self._ring.insert(self._cursor, t)
        q.appendleft(item)
        self._deficit[t] += refund
        self._len += 1

    def peek_lowest_priority(self) -> Optional[object]:
        """The shed candidate: globally lowest priority; ties broken by
        YOUNGEST arrival (largest seq) so the oldest request in a class
        keeps the progress it has paid queue time for."""
        worst = None
        for q in self._fifos.values():
            for item in q:
                if (worst is None or item.priority < worst.priority
                        or (item.priority == worst.priority
                            and item.seq > worst.seq)):
                    worst = item
        return worst

    def remove(self, item) -> bool:
        """Remove a specific entry (shed / wait-timeout / deadline expiry);
        False when it is no longer queued (raced with a pop)."""
        q = self._fifos.get(item.tenant)
        if q is None:
            return False
        try:
            q.remove(item)
        except ValueError:
            return False
        self._len -= 1
        if not q:
            self._drop_tenant(item.tenant)
        return True
