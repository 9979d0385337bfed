"""KV offload manager: device<->host tiering policy over the paged pool
(the port of ``tpulab/kvcache/offload.py``).

Pool pressure used to destroy state: a preempted request re-prefilled
prompt + generated tokens, an evicted prefix-cache entry was simply
gone.  This module turns both into *demotions* to a host-RAM tier
(:class:`~tpulab_torch.kvcache.host_store.HostKVStore`) and back:

- **Preemption** — :meth:`KVOffloadManager.swap_out` snapshots the
  victim lane's live KV pages device->host *asynchronously*: the page
  gather is enqueued inline, the copy to host memory rides the
  :class:`~tpulab_torch.cuda.transfer.TransferEngine` side stream and
  collector thread, so the scheduler never waits for a swap-out
  (write-behind).  On resume, :meth:`restore` scatters the snapshot into
  freshly allocated pages and the request continues decoding with ZERO
  prefill dispatches.
- **Prefix-cache eviction** — :meth:`demote` moves an evicted entry's
  page to the host tier keyed by its prompt digest; :meth:`promote`
  brings it back on the next lookup hit.

Every degraded path is the pre-offload behavior: a snapshot that was
dropped (budget), failed (a failed transfer) or chaos-tripped
(``kvcache.swap``) leaves the request on the exact re-prefill path, and
each one is counted (``swap_drops`` / ``swap_failures``) and logged.  An
exception of the gather or the scatter itself is not caught here: it
goes to the batcher's recovery path (the requests fail, the pool
resets).  The one exception is running out of device memory for a
gather, which tpulab's catch-all also degrades.

Ordering: the gather and the scatter run on the CALLER's current stream
(the scheduler thread's), in order with every forward that writes the
pool there.  The gather is enqueued BEFORE the victim's pages are
released, so any later write into a recycled page is ordered after the
gather's read; the side stream's copy waits on an event recorded after
the gather.  A restore's host-to-device copy and its ``index_copy_`` are
enqueued on the same stream before the lane's next forward, so that
forward reads the restored pages.  The pool is written IN PLACE:
``restore`` and ``promote`` return the pool tensor itself (tpulab's
return a new, donated buffer), or None on a degraded path, which leaves
the pool untouched.

Under a mesh (``PagedKVPool(mesh=)``) the gather and the scatter are the
pool's collectives (:meth:`~tpulab_torch.engine.paged.PagedKVPool.
gather_pages`, ``scatter_pages``): every rank's KV heads are gathered to
the coordinator and scattered back, so the host tier and the wire hold
UNSHARDED pages, and a snapshot taken at one axis size restores at
another or on one device.

tpulab pads the page index to a power of two (onto scratch page 0) to
bound its jit cache; eager PyTorch has no such cache, so the port gathers
and scatters exactly the pages named and never writes any other page.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from typing import Any, List, Optional

import numpy as np
import torch

from tpulab_torch import chaos
from tpulab_torch.cuda.transfer import TransferEngine
from tpulab_torch.kvcache.host_store import HostKVStore
from tpulab_torch.ops.ragged_attention import pool_bytes

log = logging.getLogger("tpulab_torch.kvcache")

#: default host-tier budget (bytes) when ``kv_offload=True`` constructs the
#: manager implicitly
DEFAULT_HOST_BUDGET = 256 << 20

#: swap-handle states
_PENDING, _RESIDENT, _DROPPED, _FAILED = range(4)


class SwapHandle:
    """One lane snapshot's lifecycle token.  Returned by ``swap_out``;
    consumed by ``restore``.  ``wait()`` is the write-behind fence —
    True once the snapshot is resident in the host tier."""

    __slots__ = ("key", "n_pages", "length", "_done", "_state")

    def __init__(self, key, n_pages: int, length: int):
        self.key = key
        self.n_pages = n_pages
        self.length = length            # resident positions the snapshot covers
        self._done = threading.Event()
        self._state = _PENDING

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True when the snapshot landed in the host tier; False while
        still in flight (timeout) or when it was dropped/failed."""
        self._done.wait(timeout)
        return self._state == _RESIDENT

    @property
    def resident(self) -> bool:
        return self._state == _RESIDENT


class KVOffloadManager:
    """Device<->host KV tiering for one :class:`PagedKVPool` (module
    docstring).  ``transfer`` is an optional shared
    :class:`~tpulab_torch.cuda.transfer.TransferEngine` (one is owned
    otherwise); ``metrics`` an optional observer with
    ``observe_swap_out(seconds, nbytes)`` and ``observe_swap_in(seconds,
    nbytes)`` (host seconds: write-behind latency from the gather to the
    landed snapshot; restore time up to the enqueued scatter)."""

    #: bound on how long a resume waits for its write-behind snapshot to
    #: land before falling back to re-prefill
    RESTORE_WAIT_S = 10.0

    def __init__(self, pool, host_budget_bytes: int = DEFAULT_HOST_BUDGET,
                 store: Optional[HostKVStore] = None,
                 transfer: Optional[TransferEngine] = None, metrics=None):
        self.pool = pool
        # identity check, not truthiness: an EMPTY store is falsy
        self.store = store if store is not None else HostKVStore(
            host_budget_bytes, pinned=pool.device.type == "cuda")
        self._owns_transfer = transfer is None
        self._transfer = transfer or TransferEngine(name="kvswap")
        self.metrics = metrics
        # one page carries every layer's K+V rows for its S slots, every
        # rank's KV heads under a mesh (the tier holds unsharded pages)
        shape = tuple(getattr(pool, "logical_shape", pool.kv.shape))
        self.page_nbytes = (int(np.prod(shape)) // shape[1]
                            * pool.kv.element_size())
        #: a pool under a mesh gathers and scatters every rank's heads
        #: itself (collectives the coordinator publishes to the followers)
        self._sharded = getattr(pool, "mesh", None) is not None
        self._lock = threading.Lock()
        self._ops_cv = threading.Condition(self._lock)
        self._seq = 0
        self._pending_ops = 0   # write-behind copies still in flight
        # -- counters -------------------------------------------------------
        self.swap_outs = 0              # lane snapshots landed in the tier
        self.swap_ins = 0               # lane snapshots restored
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.swap_failures = 0          # chaos / transfer degradations
        self.swap_drops = 0             # host-budget-refused snapshots
        self.demotions = 0              # prefix pages demoted to host
        self.promotions = 0             # prefix pages promoted back
        self.recompute_tokens_saved = 0  # prefill tokens resumes skipped

    def _index(self, pages: List[int], kv: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.long).to(kv.device)

    def _gather(self, pages: List[int], kv: torch.Tensor) -> torch.Tensor:
        """``kv[:, pages]`` on the caller's stream (every rank's KV heads,
        gathered to the coordinator, under a mesh).  Running out of device
        memory raises ChaosError (the degrade path); any other failure
        propagates."""
        try:
            if self._sharded:
                return self.pool.gather_pages(pages)
            got = pool_bytes(kv).index_select(1, self._index(pages, kv))
            return got.view(kv.dtype)
        except torch.OutOfMemoryError as e:
            raise chaos.ChaosError(f"snapshot gather: {e}") from e

    def _fetch(self, gathered: torch.Tensor, land) -> None:
        """Write-behind: the copy to host, then ``land(host, t0)`` on the
        collector thread; counted in the drain fence."""
        with self._lock:
            self._pending_ops += 1
        t0 = _time.perf_counter()
        try:
            fut = self._transfer.fetch(gathered)
        except BaseException:
            self._op_done()
            raise

        def settle(f):
            try:
                land(f, t0)
            finally:
                self._op_done()

        fut.add_done_callback(settle)

    def _op_done(self) -> None:
        with self._ops_cv:
            self._pending_ops -= 1
            self._ops_cv.notify_all()

    # -- lane swap (preemption) ----------------------------------------------
    def swap_out(self, pages: List[int], length: int, kv: torch.Tensor,
                 key=None) -> Optional[SwapHandle]:
        """Snapshot ``pages`` (covering positions ``[0, length)``) to the
        host tier.  Enqueues the gather and returns at once; the copy to
        host and the store happen behind the decode loop (write-behind).
        None = degraded (chaos, out of device memory): the caller keeps
        the re-prefill path.

        ``key`` overrides the minted ``("lane", seq)`` store key — the
        disaggregation path keys finished-prefill exports by prompt
        digest (``("ship", digest)``)."""
        if not pages or length <= 0:
            return None
        try:
            if chaos.trip("kvcache.swap") == "drop":
                raise chaos.ChaosError("injected swap drop")
            gathered = self._gather(pages, kv)
        except chaos.ChaosError as e:
            self.swap_failures += 1
            log.warning("KV swap-out degraded to recompute path: %s", e)
            return None
        n = len(pages)
        with self._lock:
            self._seq += 1
            handle = SwapHandle(key if key is not None
                                else ("lane", self._seq), n, length)
        self._fetch(gathered, lambda f, t0: self._on_fetched(handle, f, t0))
        return handle

    def _on_fetched(self, handle: SwapHandle, fut, t0: float) -> None:
        """Collector-thread completion: land the snapshot in the host tier
        (the fetched copy is dropped afterwards, so the only host copy is
        the budgeted one)."""
        try:
            host = fut.result()
            stored = self.store.put(handle.key, host)
        except Exception:  # noqa: BLE001 - a failed transfer degrades
            handle._state = _FAILED
            self.swap_failures += 1
            log.exception("KV swap-out fetch failed")
        else:
            nbytes = host.numel() * host.element_size()
            if stored:
                handle._state = _RESIDENT
                self.swap_outs += 1
                self.swap_out_bytes += nbytes
                if self.metrics is not None:
                    self.metrics.observe_swap_out(
                        _time.perf_counter() - t0, nbytes)
            else:
                # budget refusal, counted apart from transfer failures so
                # an undersized host budget is diagnosable on its own
                handle._state = _DROPPED
                self.swap_drops += 1
                log.warning(
                    "KV swap-out dropped: host tier refused %d bytes "
                    "(budget %d, headroom %d) — host budget undersized?",
                    nbytes, self.store.budget_bytes,
                    self.store.headroom_bytes)
        finally:
            handle._done.set()

    def _scatter(self, pages: List[int], data: torch.Tensor,
                 kv: torch.Tensor) -> torch.Tensor:
        """``kv[:, pages] = data`` in place, on the caller's stream (a
        page-locked source copies asynchronously).  An fp8 pool is
        written through its bytes: ``index_copy_`` has no fp8 kernel.
        Under a mesh the pool scatters each rank its KV heads."""
        if self._sharded:
            self.pool.scatter_pages(pages, data)
            return kv
        pool_bytes(kv).index_copy_(
            1, self._index(pages, kv),
            pool_bytes(data.to(kv.device, non_blocking=True)))
        return kv

    def restore(self, handle: SwapHandle, pages: List[int],
                kv: torch.Tensor) -> Optional[torch.Tensor]:
        """Scatter ``handle``'s snapshot into ``pages`` (freshly allocated
        by the caller, same count).  Returns the pool tensor, or None when
        the snapshot is unavailable (still in flight past
        :data:`RESTORE_WAIT_S`, dropped, failed, evicted or chaos-tripped)
        — the caller then re-prefills exactly as before offload existed.

        Degradation boundary: every failure BEFORE the scatter returns
        None with ``kv`` untouched.  A failure in the scatter itself
        propagates to the scheduler's pool-reset recovery path, as any
        failed step does."""
        t0 = _time.perf_counter()
        try:
            if chaos.trip("kvcache.swap") == "drop":
                raise chaos.ChaosError("injected swap drop")
            if not handle.wait(self.RESTORE_WAIT_S):
                raise chaos.ChaosError("snapshot unavailable")
            data = self.store.pop(handle.key)
            if data is None or len(pages) != handle.n_pages:
                raise chaos.ChaosError("snapshot evicted from host tier")
        except chaos.ChaosError as e:
            self.swap_failures += 1
            self.store.remove(handle.key)
            log.warning("KV swap-in degraded to re-prefill: %s", e)
            return None
        kv = self._scatter(pages, data, kv)
        nbytes = handle.n_pages * self.page_nbytes
        self.swap_ins += 1
        self.swap_in_bytes += nbytes
        self.recompute_tokens_saved += handle.length
        if self.metrics is not None:
            self.metrics.observe_swap_in(_time.perf_counter() - t0, nbytes)
        return kv

    def discard(self, handle: SwapHandle) -> None:
        """Forget a snapshot that will never be restored (request
        cancelled/expired while queued)."""
        self.store.remove(handle.key)

    # -- KV shipping (tpulab_torch.disagg) -------------------------------------
    def take_snapshot(self, handle: SwapHandle,
                      timeout: Optional[float] = None
                      ) -> Optional[torch.Tensor]:
        """One-shot read of a snapshot's host payload for wire export.
        Waits out the write-behind fence, then POPS the entry — after a
        successful export the only copy is the wire payload.  None when
        the snapshot was dropped/failed or evicted."""
        if not handle.wait(self.RESTORE_WAIT_S if timeout is None
                           else timeout):
            return None
        return self.store.pop(handle.key)

    def adopt(self, key, tensor: torch.Tensor,
              length: int) -> Optional[SwapHandle]:
        """Land an externally produced snapshot (a shipped-KV import) in
        the host tier and mint the already-RESIDENT handle that
        :meth:`restore` consumes.  None when the budget refuses it
        (counted in ``swap_drops``; the caller degrades to local
        prefill)."""
        if not self.store.put(key, tensor):
            self.swap_drops += 1
            log.warning("shipped KV snapshot refused by host tier "
                        "(%d bytes, budget %d)",
                        tensor.numel() * tensor.element_size(),
                        self.store.budget_bytes)
            return None
        handle = SwapHandle(key, int(tensor.shape[1]), int(length))
        handle._state = _RESIDENT
        handle._done.set()
        return handle

    # -- prefix-cache tiering ------------------------------------------------
    def demote(self, digest: bytes, page: int, kv: torch.Tensor) -> None:
        """Write-behind copy of one evicted prefix page to the host tier
        (called by the cache's eviction path BEFORE the page is released:
        stream order makes the snapshot safe, see module docstring)."""
        try:
            if chaos.trip("kvcache.swap") == "drop":
                raise chaos.ChaosError("injected swap drop")
            gathered = self._gather([page], kv)
        except chaos.ChaosError as e:
            self.swap_failures += 1
            log.warning("prefix demotion skipped: %s", e)
            return

        def land(f, t0):
            try:
                if self.store.put(("px", digest), f.result()):
                    self.demotions += 1
                    self.swap_out_bytes += self.page_nbytes
                    if self.metrics is not None:
                        self.metrics.observe_swap_out(
                            _time.perf_counter() - t0, self.page_nbytes)
            except Exception:  # noqa: BLE001 - the entry just drops
                self.swap_failures += 1
                log.exception("prefix demotion fetch failed")

        self._fetch(gathered, land)

    def has_prefix(self, digest: bytes) -> bool:
        return ("px", digest) in self.store

    def promote(self, digest: bytes, page: int,
                kv: torch.Tensor) -> Optional[torch.Tensor]:
        """Upload a demoted prefix page into ``page``.  Returns the pool
        tensor, or None (miss/failure — the caller releases the page and
        recomputes)."""
        t0 = _time.perf_counter()
        try:
            if chaos.trip("kvcache.swap") == "drop":
                raise chaos.ChaosError("injected swap drop")
            data = self.store.pop(("px", digest))
            if data is None:
                return None
        except chaos.ChaosError as e:
            self.swap_failures += 1
            log.warning("prefix promotion degraded to recompute: %s", e)
            return None
        kv = self._scatter([page], data, kv)
        self.promotions += 1
        self.swap_in_bytes += self.page_nbytes
        if self.metrics is not None:
            self.metrics.observe_swap_in(_time.perf_counter() - t0,
                                         self.page_nbytes)
        return kv

    # -- load signals ---------------------------------------------------------
    def headroom_pages(self) -> int:
        """How many more KV pages the host tier can absorb without
        evicting."""
        return self.store.headroom_bytes // max(1, self.page_nbytes)

    def demotable_pages(self, prefix_cache: Any) -> int:
        """Device pages that pressure could DEMOTE instead of drop right
        now: capped both by what the cache holds and by host headroom."""
        cached = len(prefix_cache) if prefix_cache is not None else 0
        return min(cached, self.headroom_pages())

    # -- lifecycle ------------------------------------------------------------
    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every write-behind copy (lane swap-outs AND prefix
        demotions) has settled.  False on timeout."""
        with self._ops_cv:
            return self._ops_cv.wait_for(lambda: self._pending_ops == 0,
                                         timeout)

    def close(self) -> None:
        self.drain(timeout=2.0)
        if self._owns_transfer:
            self._transfer.shutdown()
        self.store.clear()
