"""Weight multiplexer: N models time-share one card's memory (the port of
``tpulab/modelstore/multiplexer.py``, with tpulab's bench row
:func:`benchmark_multi_model`).

Every registered model's parameters live in exactly ONE tier at a time —
**hot** (on the card, byte-accurately accounted against
``hbm_budget_bytes``, next to the
:class:`~tpulab_torch.engine.paged.PagedKVPool` pages the same device
holds) or **cold** (the budgeted host tier,
:class:`~tpulab_torch.modelstore.host_store.HostParamStore`) — and the
:class:`WeightMultiplexer` moves them between tiers on demand:

- **Swap-out** (eviction) rides the same write-behind
  :class:`~tpulab_torch.cuda.transfer.TransferEngine` path the KV tier
  uses: the device-to-host copy runs on the engine's side stream (after
  an event recorded on the caller's current stream) and lands on its
  collector thread, the device accounting releases only when the copy is
  resident, and acquirers waiting for headroom are woken then — never a
  torn copy, never double-freed memory.  The engine holds the device
  tensors until their copy's event has completed, so their memory cannot
  be handed to other work first.
- **Swap-in** pops the host copy and re-places it through the adapter's
  own placement: the tensors the host tier holds are the device form
  ``detach()`` returned (a compiled model's placed tree, layout changes
  and bf16 copies included), copied back as they are with their strides,
  and complete on every stream before ``acquire`` returns.  Promoted
  weights are bit-identical to the bytes that left the device.
- **Degradation** (``modelstore.swap`` chaos point, transfer failures,
  host-budget refusals): a failed swap-out loses the snapshot — the
  model is LOST and its next acquire does a **cold rebuild** through the
  registered rebuild function; a failed swap-in discards the host copy and
  rebuilds in place.  Every degraded path serves correct (rebuilt)
  weights.

Pinning & working-set protection: an acquired lease is a refcount —
models with live leases (a decode stream mid-flight, an Infer request in
the runner) are NEVER eviction candidates; ``pinned=True`` models are
permanently resident.  An admission frontend reads
:meth:`WeightMultiplexer.can_admit` so requests for a model that cannot
be made resident *right now* queue instead of thrashing the hot set.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch

from tpulab_torch import chaos
from tpulab_torch.cuda.allocators import place_tree
from tpulab_torch.modelstore.host_store import (DEFAULT_HOST_BUDGET,
                                                HostParamStore, tree_flatten,
                                                tree_nbytes)

log = logging.getLogger("tpulab_torch.modelstore")

#: entry states (a model is in exactly one)
_HOT = "hot"                 # params resident in HBM, servable
_COLD = "cold"               # params resident in the host tier
_LOST = "lost"               # params in NO tier: next acquire cold-rebuilds
_SWAP_IN = "swapping_in"     # claimed by an acquire, attach in progress
_SWAP_OUT = "swapping_out"   # write-behind device->host copy in flight


class ModelLease:
    """One request's hold on a hot model (a refcount, not a lock): the
    model cannot be evicted while any lease is live.  Context manager;
    ``release()`` is idempotent."""

    __slots__ = ("name", "_mux", "_entry", "_released")

    def __init__(self, mux: "WeightMultiplexer", entry: "_ModelEntry"):
        self.name = entry.name
        self._mux = mux
        self._entry = entry
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._mux._release(self._entry)

    def __enter__(self) -> "ModelLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _ModelEntry:
    __slots__ = ("name", "adapter", "nbytes", "pinned", "state", "refs")

    def __init__(self, name: str, adapter, nbytes: int, pinned: bool,
                 state: str):
        self.name = name
        self.adapter = adapter
        self.nbytes = int(nbytes)
        self.pinned = bool(pinned)
        self.state = state
        self.refs = 0


# -- adapters ----------------------------------------------------------------
def _settled(device) -> None:
    """Wait for the copies this thread enqueued on ``device`` (a swap-in's
    host-to-device copies): the weights are then complete for every
    stream that reads them, whichever thread's stream serves the next
    forward."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class CompiledModelAdapter:
    """Multiplexes a dense :class:`~tpulab_torch.engine.runtime.
    CompiledModel` (the Infer path).  Weights re-place through the model's
    tracked device allocator (``allocate_tree``), so the allocator's gauge
    and the multiplexer agree byte for byte; the bucket programs take the
    weights as an argument, so a swap never rebuilds one.

    The host tier holds the device form ``detach()`` returns — the tree
    the model's ``place_fn`` made at compile (layouts, bf16 copies) — and
    ``attach`` puts it back as it is, never transforming it again; a cold
    rebuild places a fresh build through ``place_fn`` on the device.

    ``builder`` (tpulab's name; e.g. ``lambda: build_model(name)``) is the
    cold-rebuild path; when given, the Model's own host param reference
    is dropped so the budgeted host tier holds the only host copy."""

    def __init__(self, compiled, builder: Optional[Callable] = None):
        self.compiled = compiled
        self._rebuild_fn = builder
        if builder is not None:
            # the budgeted tier is the host copy now; rebuilds re-derive
            compiled.model.params = None

    def resident(self) -> bool:
        return self.compiled.device_params is not None

    def param_bytes(self) -> int:
        src = (self.compiled.device_params
               if self.compiled.device_params is not None
               else self.compiled.model.params)
        return tree_nbytes(src)

    def busy(self) -> bool:
        return False  # in-flight Infer requests hold leases; nothing else

    def detach(self):
        return self.compiled.device_params

    def on_detached(self) -> None:
        self.compiled.release_weights()

    def attach(self, host_tree) -> None:
        c = self.compiled
        if c.allocator is not None:
            c.weights_addr, c.device_params = c.allocator.allocate_tree(
                host_tree)
        else:  # pragma: no cover - an untracked CompiledModel
            from tpulab_torch.engine.runtime import tree_to
            c.device_params = tree_to(host_tree, c.device)
        _settled(c.device)

    def rebuild(self):
        model = self.compiled.model
        if self._rebuild_fn is not None:
            params = self._rebuild_fn().params
        elif model.params is not None:
            params = model.params
        else:
            raise RuntimeError(
                f"model {model.name!r}: weights lost from every tier and "
                "no rebuild function registered for a cold rebuild")
        if model.place_fn is not None:
            return model.place_fn(params, self.compiled.device)
        from tpulab_torch.engine.runtime import tree_to
        return tree_to(params, self.compiled.device)


class BatcherAdapter:
    """Multiplexes a :class:`~tpulab_torch.engine.paged.ContinuousBatcher`'s
    target weights (the Generate path).  The batcher's programs take the
    weights as arguments, so attach/detach is pure placement onto the
    pool's device.  ``detach`` drops ``batcher.params`` only (tpulab's
    semantics): a speculating batcher's early-exit draft shares the
    target's tensors and keeps them alive, so it frees the card's memory
    only for a batcher without a draft, whose caller holds no other
    reference to the tree.

    Eviction safety: a batcher with active lanes or queued work refuses
    to detach (``busy()``), independently of the lease refcount — the
    hard floor under "a decode-in-flight model is never evicted".

    A batcher under a mesh (tpulab swaps its Megatron shards onto their
    placements) is refused: every rank would have to move its shards
    together, which the sharded batcher's followers do not replay yet.
    """

    def __init__(self, batcher, builder: Optional[Callable] = None):
        if getattr(batcher, "mesh", None) is not None:
            raise NotImplementedError(
                "a BatcherAdapter over a batcher under a mesh is not ported "
                "to tpulab_torch yet (ROADMAP queue 1: parallelism, item 5: "
                "BatcherAdapter and kv_publish under a mesh)")
        self.batcher = batcher
        self._rebuild_fn = builder
        self._placement = batcher.pool.device

    def resident(self) -> bool:
        return self.batcher.params is not None

    def param_bytes(self) -> int:
        return tree_nbytes(self.batcher.params)

    def busy(self) -> bool:
        b = self.batcher
        return (int(getattr(b, "active_lanes", 0)) > 0
                or int(getattr(b, "queued_requests", 0)) > 0)

    def detach(self):
        if self.busy():
            raise RuntimeError("batcher has in-flight work; refusing to "
                               "detach its weights")
        dev = self.batcher.params
        self.batcher.params = None
        return dev

    def on_detached(self) -> None:
        pass  # device memory frees when the fetch drops its reference

    def attach(self, host_tree) -> None:
        tree = place_tree(host_tree, self._placement)
        _settled(self._placement)
        self.batcher.params = tree

    def rebuild(self):
        if self._rebuild_fn is None:
            raise RuntimeError(
                "batcher weights lost from every tier and no rebuild "
                "function registered for a cold rebuild")
        built = self._rebuild_fn()
        # accept either a raw param tree or a Model-like with .params
        return getattr(built, "params", built)


class WeightMultiplexer:
    """Hot-set manager over one device's weight HBM (module docstring).

    ``hbm_budget_bytes`` caps combined hot-model weight bytes (KV pools /
    activations are outside it — size it at what's left after the pools);
    ``store`` / ``host_budget_bytes`` configure the cold tier;
    ``transfer`` optionally shares a TransferEngine; ``metrics`` an
    optional duck-typed observer (``observe_swap_in(seconds, nbytes)``,
    ``observe_swap_out(seconds, nbytes)``; tpulab's ``ModelStoreMetrics``
    is not ported); ``hbm`` an :class:`~tpulab_torch.hbm.HBMArbiter`,
    whose weights tenant this store becomes."""

    #: default bound on how long an acquire waits for headroom (models
    #: with live leases never evict — a long decode can hold this long)
    ACQUIRE_TIMEOUT_S = 120.0

    def __init__(self, hbm_budget_bytes: int,
                 store: Optional[HostParamStore] = None,
                 host_budget_bytes: int = DEFAULT_HOST_BUDGET,
                 transfer=None, metrics=None, hbm=None):
        if hbm_budget_bytes <= 0:
            raise ValueError("hbm_budget_bytes must be > 0")
        self.hbm_budget_bytes = int(hbm_budget_bytes)
        # the HBM economy (tpulab_torch.hbm): with an arbiter this store is
        # the WEIGHTS tenant — acquires for a cold model request bytes
        # through the pressure protocol (which may demote idle KV), a KV
        # burst may press cold unleased models out, and every byte the
        # internal accounting holds is mirrored as a ledger claim.  A
        # denied request degrades to the static hbm_budget_bytes path —
        # exactly the pre-arbiter behavior.
        self._hbm = hbm
        if hbm is not None:
            from tpulab_torch.hbm import WEIGHTS_TENANT
            self._hbm_tenant = WEIGHTS_TENANT
            hbm.register(WEIGHTS_TENANT, reclaim=self._hbm_reclaim,
                         reclaimable=self._hbm_evictable_bytes,
                         gauge=lambda: self.hbm_bytes_in_use)
        # identity check, not truthiness (an empty store is falsy)
        self.store = store if store is not None \
            else HostParamStore(host_budget_bytes)
        if transfer is None:
            from tpulab_torch.cuda.transfer import TransferEngine
            transfer = TransferEngine(name="wswap")
            self._owns_transfer = True
        else:
            self._owns_transfer = False
        self._transfer = transfer
        self.metrics = metrics
        # re-entrant: a swap-out's completion callback runs inline (under
        # the lock its initiator holds) when the copy settles before the
        # callback is attached
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._entries: "OrderedDict[str, _ModelEntry]" = OrderedDict()
        self._hbm_bytes = 0          # hot + both swap directions (reserved)
        self._pending_ops = 0        # write-behind copies still in flight
        self._pending_out_bytes = 0  # HBM that frees when those copies land
        # -- counters (ModelStoreMetrics.poll advances from these) ----------
        self.swap_ins = 0            # host->device promotions served
        self.swap_outs = 0           # device->host snapshots landed
        self.swap_in_bytes = 0
        self.swap_out_bytes = 0
        self.evictions = 0           # swap-outs initiated by HBM pressure
        self.cold_rebuilds = 0       # acquires served by a fresh build
        self.swap_failures = 0       # chaos/transfer degradations
        self.swap_drops = 0          # host-budget-refused snapshots

    # -- registration --------------------------------------------------------
    def register(self, name: str, adapter, pinned: bool = False,
                 params: Any = None) -> None:
        """Register a servable under ``name``.  A resident adapter enters
        HOT (trimming colder idle models to budget, write-behind); a
        non-resident one enters COLD when ``params`` (its host tree) is
        given, else LOST — its first acquire cold-rebuilds."""
        with self._cv:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            resident = bool(adapter.resident())
            nbytes = int(adapter.param_bytes()) if resident \
                else int(tree_nbytes(params)) if params is not None else 0
            state = _HOT if resident else _LOST
            if not resident and params is not None:
                if self.store.put(name, params):
                    state = _COLD
                else:
                    self.swap_drops += 1
            e = _ModelEntry(name, adapter, nbytes, pinned, state)
            self._entries[name] = e
            if resident:
                self._hbm_bytes += e.nbytes
                self._ledger_claim(e)
                if self._hbm is None:
                    # static budget: trim colder idle models to fit.  The
                    # economy has no static split to trim to — residency
                    # holds until another tenant's pressure presses it out
                    self._trim_locked()

    def pin(self, name: str, on: bool = True) -> None:
        with self._cv:
            self._entries[name].pinned = bool(on)
            self._cv.notify_all()

    # -- HBM economy (tpulab_torch.hbm): the weights tenant ------------------
    def _ledger_claim(self, e: "_ModelEntry") -> None:
        """Mirror a ``_hbm_bytes += e.nbytes`` into the device ledger —
        called at every site that adds hot bytes, so per-model claims sum
        exactly to this store's byte gauge (the verify() invariant)."""
        if self._hbm is not None:
            self._hbm.mirror_claim(self._hbm_tenant, e.name, e.nbytes)

    def _ledger_release(self, e: "_ModelEntry") -> None:
        if self._hbm is not None:
            self._hbm.release(self._hbm_tenant, e.name)

    def _hbm_evictable_bytes(self) -> int:
        """Non-mutating estimate for the arbiter/admission: hot bytes a
        pressure round could evict right now (unleased, unpinned, not
        busy — the same floor can_admit stands on: leased and pinned
        models are NEVER victims)."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.state == _HOT and not e.pinned and e.refs == 0
                       and not e.adapter.busy())

    def _hbm_reclaim(self, nbytes: int) -> int:
        """Arbiter pressure hook: a KV burst (or scratch discovery) needs
        device bytes — initiate write-behind swap-outs of cold unleased
        models, coldest first, until the target is covered or nothing is
        evictable.  Returns the bytes initiated (they land — and release
        their ledger claims — on the transfer collector thread)."""
        initiated = 0
        with self._cv:
            while initiated < int(nbytes):
                victim = self._evictable_locked()
                if victim is None:
                    break
                size = victim.nbytes
                if not self._swap_out_locked(victim):
                    break
                initiated += size
        return initiated

    # -- introspection -------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def models(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def resident_models(self) -> List[str]:
        """Names currently hot (HBM-resident), coldest first — the
        Status RPC's residency report."""
        with self._lock:
            return [n for n, e in self._entries.items() if e.state == _HOT]

    def host_models(self) -> List[str]:
        """Names whose weights sit in the host tier right now."""
        return [k for k in self.store.keys() if isinstance(k, str)]

    @property
    def hbm_bytes_in_use(self) -> int:
        """Weight bytes accounted against the HBM budget (hot models plus
        swaps in either direction that have not settled)."""
        with self._lock:
            return self._hbm_bytes

    def state_of(self, name: str) -> str:
        with self._lock:
            return self._entries[name].state

    def lease_counts(self) -> Dict[str, Dict[str, Any]]:
        """Per-model residency + lease refcounts + pins (the debugz live
        view): ``{name: {"state", "refs", "pinned", "bytes"}}``."""
        with self._lock:
            return {n: {"state": e.state, "refs": int(e.refs),
                        "pinned": bool(e.pinned), "bytes": int(e.nbytes)}
                    for n, e in self._entries.items()}

    # -- admission signal ----------------------------------------------------
    def can_admit(self, name: str) -> bool:
        """Could ``name`` be made resident without touching any leased /
        pinned / busy model?  The admission frontend queues (not rejects)
        requests while this is False — a burst on one model waits for
        another model's working set instead of thrashing it."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return True  # unmanaged model: no opinion
            if e.state in (_HOT, _SWAP_IN):
                return True
            evictable = sum(
                v.nbytes for v in self._entries.values()
                if v.state == _HOT and not v.pinned and v.refs == 0
                and not v.adapter.busy())
            nbytes = e.nbytes
            if self._hbm is None:
                return (self._hbm_bytes - evictable + nbytes
                        <= self.hbm_budget_bytes)
        # arbitrated: the economy's headroom — free ledger bytes plus what
        # pressure on the OTHER tenants (demotable KV) plus own evictions
        # could free — replaces the static-budget arithmetic
        arb = self._hbm
        return (max(0, arb.free_hbm_bytes)
                + arb.reclaimable_bytes(exclude=self._hbm_tenant)
                + evictable >= nbytes)

    # -- acquire / release ---------------------------------------------------
    def acquire(self, name: str, timeout: Optional[float] = None
                ) -> ModelLease:
        """Make ``name`` resident and return a lease pinning it hot.
        Blocks (bounded) while headroom requires write-behind evictions to
        land or leased models to release; raises ``TimeoutError`` past
        ``timeout`` and ``KeyError`` for an unregistered name."""
        end = _time.monotonic() + (self.ACQUIRE_TIMEOUT_S
                                   if timeout is None else timeout)
        arbiter_denied = False
        with self._cv:
            e = self._entries[name]
            while True:
                if e.state == _HOT:
                    e.refs += 1
                    self._entries.move_to_end(name)
                    return ModelLease(self, e)
                if e.state in (_SWAP_IN, _SWAP_OUT):
                    # another acquire is promoting it / its demotion is
                    # still landing: wait for the state to settle
                    self._wait_locked(end, f"model {name!r} swap in flight")
                    continue
                # COLD or LOST: first let the economy decide (the arbiter
                # may demote idle KV for these bytes); a denial degrades
                # to the static hbm_budget_bytes path below for the rest
                # of this acquire — the pre-arbiter behavior
                if self._hbm is not None and not arbiter_denied:
                    prior = e.state
                    e.state = _SWAP_IN  # peers wait while we negotiate
                    self._cv.release()
                    try:
                        granted = self._hbm.request(
                            self._hbm_tenant, e.name, e.nbytes,
                            timeout=max(0.0, end - _time.monotonic()))
                    finally:
                        self._cv.acquire()
                    if granted:
                        self._hbm_bytes += e.nbytes
                        break
                    e.state = prior
                    arbiter_denied = True
                    self._cv.notify_all()
                    continue
                # claim the swap-in once static headroom exists
                if self._hbm_bytes + e.nbytes <= self.hbm_budget_bytes:
                    e.state = _SWAP_IN
                    self._hbm_bytes += e.nbytes
                    self._ledger_claim(e)
                    break
                # initiate evictions only beyond what in-flight swap-outs
                # will already free when they land (write-behind: the
                # accounting releases at landing, not at initiation)
                projected = self._hbm_bytes - self._pending_out_bytes
                if (projected + e.nbytes > self.hbm_budget_bytes
                        and self._evict_locked()):
                    continue
                self._wait_locked(
                    end, f"no evictable HBM headroom for {name!r} "
                    f"({self._hbm_bytes}+{e.nbytes} over "
                    f"{self.hbm_budget_bytes}B budget)")
        return self._swap_in(e)

    def _wait_locked(self, end: float, what: str) -> None:
        remaining = end - _time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"modelstore acquire timed out: {what}")
        self._cv.wait(timeout=min(0.05, remaining))

    def _release(self, e: _ModelEntry) -> None:
        with self._cv:
            if e.refs > 0:
                e.refs -= 1
            self._cv.notify_all()

    # -- swap-in (caller claimed _SWAP_IN; runs outside the lock) ------------
    def _swap_in(self, e: _ModelEntry) -> ModelLease:
        t0 = _time.perf_counter()
        host = self.store.pop(e.name)
        promoted = host is not None
        try:
            if chaos.trip("modelstore.swap") == "drop":
                raise chaos.ChaosError("injected modelstore swap drop")
        except chaos.ChaosError as ex:
            if promoted:
                # degraded swap-in: DISCARD the popped host copy and serve
                # a cold rebuild instead — stale/garbled promotion bytes
                # can never reach the device (never a corrupt serve)
                host, promoted = None, False
                self.swap_failures += 1
                log.warning("model %s swap-in degraded to cold rebuild: %s",
                            e.name, ex)
        try:
            if host is None:
                host = e.adapter.rebuild()
            e.adapter.attach(host)
        except BaseException:
            with self._cv:
                e.state = _LOST
                self._hbm_bytes -= e.nbytes
                self._ledger_release(e)
                self._cv.notify_all()
            raise
        dt = _time.perf_counter() - t0
        with self._cv:
            if promoted:
                self.swap_ins += 1
                self.swap_in_bytes += e.nbytes
            else:
                self.cold_rebuilds += 1
            e.state = _HOT
            e.refs = 1
            self._entries.move_to_end(e.name)
            self._cv.notify_all()
        if promoted and self.metrics is not None:
            self.metrics.observe_swap_in(dt, e.nbytes)
        return ModelLease(self, e)

    # -- eviction (write-behind swap-out) ------------------------------------
    def _evictable_locked(self) -> Optional[_ModelEntry]:
        for e in self._entries.values():  # OrderedDict = LRU order
            if (e.state == _HOT and not e.pinned and e.refs == 0
                    and not e.adapter.busy()):
                return e
        return None

    def _evict_locked(self) -> bool:
        victim = self._evictable_locked()
        if victim is None:
            return False
        return self._swap_out_locked(victim)

    def _trim_locked(self) -> None:
        """Kick write-behind evictions until the hot set (net of swap-outs
        already in flight) fits the budget, or nothing is evictable.
        Non-blocking: accounting converges when the copies land."""
        while (self._hbm_bytes - self._pending_out_bytes
               > self.hbm_budget_bytes):
            if not self._evict_locked():
                break

    def _swap_out_locked(self, e: _ModelEntry) -> bool:
        act = None
        try:
            if chaos.trip("modelstore.swap") == "drop":
                act = "drop"
        except chaos.ChaosError:
            act = "error"
        try:
            dev = e.adapter.detach()
        except Exception as ex:  # noqa: BLE001 - raced into busy: back off
            # a submit outside the lease contract can make the victim busy
            # between the evictability check and the detach — it simply
            # stays hot and the caller looks elsewhere / waits
            log.warning("model %s refused detach (%s); eviction backed "
                        "off", e.name, ex)
            return False
        self.evictions += 1
        if act is not None:
            # degraded swap-out: the snapshot is simply LOST — HBM frees,
            # no host copy, and the next acquire cold-rebuilds (the
            # degrade is losing work, never corrupting weights)
            e.adapter.on_detached()
            del dev
            e.state = _LOST
            self._hbm_bytes -= e.nbytes
            self._ledger_release(e)
            self.swap_failures += 1
            log.warning("model %s swap-out degraded (chaos %s): weights "
                        "dropped, next acquire cold-rebuilds", e.name, act)
            self._cv.notify_all()
            return True
        e.state = _SWAP_OUT
        self._pending_ops += 1
        self._pending_out_bytes += e.nbytes
        t0 = _time.perf_counter()
        # the engine moves dicts of tensors: the tree goes as its leaves
        leaves, rebuild = tree_flatten(dev)
        del dev
        fut = self._transfer.fetch({str(i): t for i, t in enumerate(leaves)})
        del leaves
        fut.add_done_callback(
            lambda f: self._on_swapped_out(e, f, t0, rebuild))
        return True

    def _on_swapped_out(self, e: _ModelEntry, fut, t0: float,
                        rebuild) -> None:
        """TransferEngine-collector-thread completion: land the host copy,
        free the device copy, release the HBM accounting, wake waiters."""
        stored = False
        try:
            flat = fut.result()
            host = rebuild([flat[str(i)] for i in range(len(flat))])
            # the fetched tree is this swap's private page-locked copy:
            # the tier adopts it instead of copying it a second time
            stored = self.store.put(e.name, host, adopt=True)
        except Exception:  # noqa: BLE001 - collector thread must live
            self.swap_failures += 1
            log.exception("model %s swap-out fetch failed; next acquire "
                          "cold-rebuilds", e.name)
        else:
            if stored:
                self.swap_outs += 1
                self.swap_out_bytes += e.nbytes
                if self.metrics is not None:
                    self.metrics.observe_swap_out(
                        _time.perf_counter() - t0, e.nbytes)
            else:
                self.swap_drops += 1
                log.warning(
                    "model %s swap-out dropped: host tier refused %d bytes "
                    "(budget %d) — host budget undersized?", e.name,
                    e.nbytes, self.store.budget_bytes)
        finally:
            try:
                e.adapter.on_detached()
            except Exception:  # noqa: BLE001 - accounting must still settle
                log.exception("model %s on_detached failed", e.name)
            with self._cv:
                e.state = _COLD if stored else _LOST
                self._hbm_bytes -= e.nbytes
                self._ledger_release(e)
                self._pending_out_bytes -= e.nbytes
                self._pending_ops -= 1
                self._cv.notify_all()

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every write-behind swap-out has settled (tests,
        shutdown).  False on timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending_ops == 0,
                                     timeout)

    def close(self) -> None:
        self.drain(timeout=2.0)
        if self._owns_transfer:
            self._transfer.shutdown()
        self.store.clear()


# -- the bench row ------------------------------------------------------------
def benchmark_multi_model(switches: int = 6, steps: int = 8,
                          prompt_len: int = 8, vocab: int = 128,
                          d_model: int = 64, n_layers: int = 2,
                          n_heads: int = 4, params=None,
                          device=None) -> Dict[str, Any]:
    """tpulab's bench ``multi_model`` row: an interleaved two-model trace
    (a transformer LLM through the paged batcher and a ViT-S classifier at
    32 x 32) under weight pressure: the budget holds ONE model's weights,
    so every switch swaps.

    Multiplexer **on**: switches ride host-tier swap-ins.  **Off**: every
    switch is a serial cold rebuild (re-init + re-place).  Both modes must
    give identical outputs (``parity`` / ``llm_parity``); the headline is
    mean swap-in against cold-build latency and the evictions.  The LLM
    batcher takes the split plan (``ragged=False``), tpulab's default at
    this max_len, in f32."""
    import numpy as np

    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.paged import ContinuousBatcher, _bench_tree
    from tpulab_torch.models.vit import init_vit_params, vit_apply

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, vocab, (prompt_len,), np.int32)
    image = torch.from_numpy(
        rng.standard_normal((1, 32, 32, 3)).astype(np.float32)).to(dev)

    def build_llm_params():
        return _bench_tree(params, dev, vocab, d_model, n_heads, n_layers,
                           4 * d_model)

    def build_vit_params():
        return init_vit_params(variant="s", image_size=32, patch_size=16,
                               num_classes=10, seed=0, device=dev)

    def vit_fn(p, x):
        with torch.inference_mode():
            return vit_apply(p, {"input": x}, n_heads=6, n_layers=12,
                             patch_size=16,
                             compute_dtype=torch.float32)["logits"]

    class _VitServable:
        """A dense model with the multiplexer's adapter protocol (the real
        path uses CompiledModelAdapter; the swap mechanics are shared)."""

        def __init__(self):
            self.device_params = build_vit_params()

        def resident(self):
            return self.device_params is not None

        def param_bytes(self):
            return tree_nbytes(self.device_params or build_vit_params())

        def busy(self):
            return False

        def detach(self):
            out, self.device_params = self.device_params, None
            return out

        def on_detached(self):
            pass

        def attach(self, host_tree):
            self.device_params = place_tree(host_tree, dev)
            _settled(dev)

        def rebuild(self):
            return build_vit_params()

    def run(mux_on: bool) -> Dict[str, Any]:
        cb = ContinuousBatcher(build_llm_params(), n_heads=n_heads,
                               n_layers=n_layers, lanes=2,
                               max_len=prompt_len + steps + 4,
                               compute_dtype=torch.float32,
                               ragged=False, device=dev)
        vit = _VitServable()
        llm_bytes = tree_nbytes(cb.params)
        vit_bytes = vit.param_bytes()
        # the bigger model plus half the smaller, never both: every switch
        # in the trace must swap
        budget = (max(llm_bytes, vit_bytes)
                  + min(llm_bytes, vit_bytes) // 2)
        mux = None
        if mux_on:
            mux = WeightMultiplexer(budget)
            mux.register("llm", BatcherAdapter(cb, build_llm_params))
            mux.register("vit", vit)
        tokens: List[List[int]] = []
        logits: List[np.ndarray] = []
        swap_in_s: List[float] = []
        cold_s: List[float] = []
        t_all = _time.perf_counter()
        try:
            for i in range(switches):
                want_llm = i % 2 == 0
                name = "llm" if want_llm else "vit"
                t0 = _time.perf_counter()
                if mux is not None:
                    was_cold = mux.state_of(name) != _HOT
                    rebuilds0 = mux.cold_rebuilds
                    lease = mux.acquire(name)
                    mux.drain()
                    if was_cold:
                        (cold_s if mux.cold_rebuilds > rebuilds0
                         else swap_in_s).append(_time.perf_counter() - t0)
                else:
                    # serial-rebuild baseline: the other model's weights
                    # are dropped and this one is rebuilt from scratch
                    if want_llm and cb.params is None:
                        cb.params = place_tree(build_llm_params(), dev)
                        _settled(dev)
                        cold_s.append(_time.perf_counter() - t0)
                    elif not want_llm and vit.device_params is None:
                        vit.attach(build_vit_params())
                        cold_s.append(_time.perf_counter() - t0)
                    lease = None
                try:
                    if want_llm:
                        fut = cb.submit(prompt, steps)
                        tokens.append([int(t) for t in
                                       fut.result(timeout=300)])
                    else:
                        logits.append(vit_fn(vit.device_params,
                                             image).cpu().numpy())
                finally:
                    if lease is not None:
                        lease.release()
                if mux is None:  # the baseline drops the model it used
                    if want_llm:
                        cb.params = None
                    else:
                        vit.device_params = None
            wall = _time.perf_counter() - t_all
            out = {
                "wall_s": wall,
                "llm_tokens": tokens,
                "vit_logits_digest": [round(float(np.abs(x).sum()), 4)
                                      for x in logits],
                "cold_build_ms_mean": (1e3 * float(np.mean(cold_s))
                                       if cold_s else None),
                "swap_in_ms_mean": (1e3 * float(np.mean(swap_in_s))
                                    if swap_in_s else None),
            }
            if mux is not None:
                out.update(evictions=mux.evictions, swap_ins=mux.swap_ins,
                           swap_outs=mux.swap_outs,
                           cold_rebuilds=mux.cold_rebuilds,
                           hbm_budget_mb=budget / 2**20)
            return out
        finally:
            cb.shutdown()
            if mux is not None:
                mux.close()

    on, off = run(True), run(False)
    llm_parity = on.pop("llm_tokens") == off.pop("llm_tokens")
    vit_parity = (on.pop("vit_logits_digest")
                  == off.pop("vit_logits_digest"))
    son, soff = on.get("swap_in_ms_mean"), off.get("cold_build_ms_mean")
    return {
        "switches": switches, "steps": steps,
        "mux_on": on, "mux_off": off,
        "llm_parity": llm_parity, "vit_parity": vit_parity,
        "parity": llm_parity and vit_parity,
        "swap_in_faster_than_cold_build": (
            son is not None and soff is not None and son < soff),
    }
