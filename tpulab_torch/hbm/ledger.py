"""Byte-accurate device-memory ledger (the port of ``tpulab/hbm/ledger.py``,
the accounting half of :mod:`tpulab_torch.hbm`).

One ledger per device records every byte a tenant holds on the card as
a ``(tenant, tag)`` claim:

- the KV page pool claims its page store under ``("kv", "pool")`` and
  resizes the claim when the elastic pool grows or shrinks;
- the weight multiplexer claims each hot model under
  ``("weights", model_name)`` for exactly as long as its own byte
  accounting holds the bytes (a write-behind swap-out releases the claim
  when the host copy LANDS);
- program scratch is claimed per program and shape key under
  ``("scratch", (name, shape-key))``
  (:class:`~tpulab_torch.hbm.scratch.MeasuredJit`).

Claims are pure bookkeeping: the ledger never allocates.  Every claim
mirrors a *tracked* allocation (the
:mod:`tpulab_torch.cuda.allocators` blocks or a tenant's own
byte-accurate gauge), so :meth:`DeviceHBMLedger.verify` can cross-check
the ledger against the live gauges at any time.  What the ledger does
not see is what PyTorch's caching allocator holds beyond the tracked
tensors (freed blocks it keeps reserved, transient copies of a pool
resize): ``torch.cuda.memory_allocated`` and ``memory_reserved`` are the
figures to read beside :attr:`DeviceHBMLedger.total_claimed`.

The key is ``(tenant, tag)`` rather than a flat name so that a per-axis
ledger under a mesh extends to ``(tenant, tag, axis)`` claims without a
refactor.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Tuple

__all__ = ["DeviceHBMLedger"]


class DeviceHBMLedger:
    """Byte-accurate ``(tenant, tag) -> bytes`` device-memory ledger.

    ``capacity_bytes`` is the device budget the arbiter trades within
    (weights + KV pages + compiled scratch).  The ledger itself never
    refuses a claim — enforcement (pressure, denial) is the
    :class:`~tpulab_torch.hbm.arbiter.HBMArbiter`'s job — but headroom can go
    negative and :meth:`headroom_bytes` reports it honestly.

    Thread-safe; every mutation notifies waiters (the arbiter blocks on
    :meth:`wait_for_change` while write-behind reclaims land).
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be > 0")
        self.capacity_bytes = int(capacity_bytes)
        self._claims: Dict[Tuple[str, Hashable], int] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    # -- mutations -----------------------------------------------------------
    def claim(self, tenant: str, tag: Hashable, nbytes: int) -> None:
        """Record ``nbytes`` held by ``(tenant, tag)``.  Claiming an
        existing key is an error — use :meth:`resize` (a silent
        double-claim is exactly the accounting bug this ledger exists to
        make impossible)."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("claim bytes must be >= 0")
        key = (tenant, tag)
        with self._cv:
            if key in self._claims:
                raise ValueError(f"claim {key!r} already recorded "
                                 f"({self._claims[key]} bytes)")
            self._claims[key] = nbytes
            self._cv.notify_all()

    def release(self, tenant: str, tag: Hashable) -> int:
        """Drop a claim; returns the bytes it held (0 for unknown keys —
        release is idempotent so degraded paths can always call it)."""
        with self._cv:
            n = self._claims.pop((tenant, tag), 0)
            if n:
                self._cv.notify_all()
            return n

    def resize(self, tenant: str, tag: Hashable, nbytes: int) -> None:
        """Re-record a claim at its tenant's current tracked size (elastic
        pool grow/shrink).  Unknown keys are created — resize is the
        idempotent upsert the byte-gauge mirrors use."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("claim bytes must be >= 0")
        with self._cv:
            if nbytes == 0:
                self._claims.pop((tenant, tag), None)
            else:
                self._claims[(tenant, tag)] = nbytes
            self._cv.notify_all()

    # -- views ---------------------------------------------------------------
    @property
    def total_claimed(self) -> int:
        with self._lock:
            return sum(self._claims.values())

    @property
    def headroom_bytes(self) -> int:
        """``capacity - total claimed``; may be negative (over-committed
        discovery, e.g. scratch measured after the fact) — consumers clamp
        where a negative figure has no meaning."""
        with self._lock:
            return self.capacity_bytes - sum(self._claims.values())

    def tenant_bytes(self, tenant: str) -> int:
        with self._lock:
            return sum(n for (t, _), n in self._claims.items()
                       if t == tenant)

    def tenant_claims(self, tenant: str) -> int:
        """Number of live claims a tenant holds."""
        with self._lock:
            return sum(1 for (t, _) in self._claims if t == tenant)

    def claims(self) -> List[Tuple[str, Hashable, int]]:
        """Snapshot of every live claim (tenant, tag, bytes)."""
        with self._lock:
            return [(t, tag, n) for (t, tag), n in self._claims.items()]

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted({t for (t, _) in self._claims})

    # -- the invariant -------------------------------------------------------
    def verify(self, gauges: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
        """Cross-check per-tenant claimed bytes against live tracked
        gauges (``{tenant: gauge_bytes}``).  Returns the mismatches as
        ``{tenant: (claimed, gauge)}`` — empty means the ledger agrees
        byte-for-byte with every gauge handed in.  The hbm tests call
        this after EVERY arbiter op; it is also the contract the Status
        RPC's ``free_hbm_bytes`` rests on."""
        out: Dict[str, Tuple[int, int]] = {}
        for tenant, gauge in gauges.items():
            claimed = self.tenant_bytes(tenant)
            if claimed != int(gauge):
                out[tenant] = (claimed, int(gauge))
        return out

    # -- waiting -------------------------------------------------------------
    def wait_for_change(self, timeout: float) -> None:
        """Block until any claim changes (write-behind landings release
        claims from transfer-collector threads) or ``timeout`` elapses."""
        with self._cv:
            self._cv.wait(timeout=timeout)
