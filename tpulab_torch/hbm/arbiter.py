"""HBM arbiter: the pressure protocol between device-memory tenants (the
port of ``tpulab/hbm/arbiter.py``, with tpulab's bench row
:func:`benchmark_hbm_arbiter`).

The :class:`~tpulab_torch.hbm.ledger.DeviceHBMLedger` says who holds
what; the :class:`HBMArbiter` decides who gets the NEXT byte.  Tenants
register with up to three hooks:

- ``reclaim(nbytes) -> int`` — asked to free ``nbytes`` of device
  memory.  The KV tenant demotes live-but-idle KV to the host tier and
  shrinks its elastic page pool (the batcher services the request at its
  next tick boundary); the weights tenant initiates write-behind
  swap-outs of cold unleased models.  Returns the bytes the tenant
  *expects* to free (0 = nothing reclaimable right now); actual ledger
  releases land asynchronously and wake the arbiter.
- ``reclaimable() -> int`` — non-mutating estimate of what ``reclaim``
  could free, for an admission frontend's honest headroom number.
- ``gauge() -> int`` — the tenant's live tracked device bytes, for
  :meth:`verify` (the ledger-vs-allocator invariant the tests enforce).

:meth:`request` is the only way bytes are GRANTED: it atomically claims
from ledger headroom when available, otherwise runs pressure rounds —
each round asks every *other* tenant to reclaim the deficit, then waits
for write-behind releases to land.  Rounds where no tenant can help are
counted; two barren rounds (or the timeout) end in a **denial** and the
requester degrades to its static-budget behavior — the no-livelock
guarantee when every tenant is at budget.

Chaos (``hbm.pressure``): the trip point guards every decision site —
pressing the KV tenant (demote-KV), pressing the weights tenant
(evict-model), and the denial itself.  ``error``/``drop`` suppress that
decision: the pressure simply does not happen and the requester falls
back to static-budget behavior.  The ledger is never touched on a
tripped path, so a chaos storm can never corrupt the accounting — only
forgo optimization.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Callable, Dict, Hashable, List, Optional

from tpulab_torch import chaos
from tpulab_torch.hbm.ledger import DeviceHBMLedger

__all__ = ["HBMArbiter", "KV_TENANT", "WEIGHTS_TENANT", "SCRATCH_TENANT"]

#: canonical tenant names (the ledger key's first half); the 2D-mesh
#: work extends tags, not these
KV_TENANT = "kv"
WEIGHTS_TENANT = "weights"
SCRATCH_TENANT = "scratch"


class _Tenant:
    __slots__ = ("name", "reclaim", "reclaimable", "gauge")

    def __init__(self, name: str, reclaim=None, reclaimable=None,
                 gauge=None):
        self.name = name
        self.reclaim = reclaim
        self.reclaimable = reclaimable
        self.gauge = gauge


class HBMArbiter:
    """One device's HBM economy (module docstring).

    ``capacity_bytes`` is the budget every tenant together rents within.
    ``measure_scratch`` arms per-program scratch claims
    (:class:`~tpulab_torch.hbm.scratch.MeasuredJit`); tests that need a
    tight deterministic budget turn it off.  ``metrics`` is a duck-typed
    observer kept for tpulab's signature (tpulab's ``HBMMetrics`` is not
    ported; nothing here calls it)."""

    #: default bound on how long a blocking request runs pressure rounds
    REQUEST_TIMEOUT_S = 10.0
    #: per-round wait for write-behind reclaims to land
    PRESSURE_POLL_S = 0.02
    #: consecutive rounds with nothing reclaimable before an early denial
    #: (the no-livelock guard: both-tenants-at-budget resolves in two
    #: rounds, not at the timeout)
    BARREN_ROUNDS = 2
    #: how long a round's reclaim promise is trusted to be in flight —
    #: no re-press while promised bytes may still be landing (prevents
    #: over-reclaim: a squeezed pool must lose the deficit, not double it)
    PROMISE_GRACE_S = 0.5

    def __init__(self, capacity_bytes: int, metrics=None,
                 measure_scratch: bool = True):
        self.ledger = DeviceHBMLedger(capacity_bytes)
        self.measure_scratch = bool(measure_scratch)
        self.metrics = metrics
        self._tenants: Dict[str, _Tenant] = {}
        self._reg_lock = threading.Lock()
        #: outstanding blocking requests (id -> (tenant, nbytes)): bytes
        #: freed under pressure are RESERVED for the waiters — another
        #: tenant's claim cannot steal them back mid-squeeze (without
        #: this, the squeezed tenant's own refill request wins the race
        #: for its just-reclaimed bytes and the presser starves)
        self._waiting: Dict[int, tuple] = {}
        self._wait_seq = 0
        # -- counters (tpulab's names) --------------------------------------
        self.grants = 0           # requests satisfied (with or without
        #                           pressure)
        self.pressure_events = 0  # pressure rounds run
        self.demotions_forced = 0   # rounds where the KV tenant reclaimed
        self.evictions_forced = 0   # rounds where the weights tenant did
        self.denials = 0          # requests denied (timeout / barren)
        self.reclaims_by_tenant: Dict[str, int] = {}

    # -- registration --------------------------------------------------------
    def register(self, name: str,
                 reclaim: Optional[Callable[[int], int]] = None,
                 reclaimable: Optional[Callable[[], int]] = None,
                 gauge: Optional[Callable[[], int]] = None) -> None:
        with self._reg_lock:
            if name in self._tenants:
                raise ValueError(f"HBM tenant {name!r} already registered")
            self._tenants[name] = _Tenant(name, reclaim, reclaimable, gauge)

    def _tenant_list(self) -> List[_Tenant]:
        with self._reg_lock:
            return list(self._tenants.values())

    # -- ledger mirrors ------------------------------------------------------
    # These record what a tenant's byte-accurate accounting already holds
    # (registration of existing residency, elastic-pool resizes, static-
    # fallback acquisitions).  They are bookkeeping, not grants — the
    # ledger stays exact even when a tenant proceeds on its static path,
    # which is why verify() holds on every degraded branch.
    def claim(self, tenant: str, tag: Hashable, nbytes: int) -> None:
        self.ledger.claim(tenant, tag, nbytes)

    def mirror_claim(self, tenant: str, tag: Hashable, nbytes: int) -> None:
        self.ledger.resize(tenant, tag, nbytes)

    def release(self, tenant: str, tag: Hashable) -> int:
        return self.ledger.release(tenant, tag)

    def record_scratch(self, tag: Hashable, nbytes: int) -> None:
        """Per-program scratch claim (tpulab_torch.hbm.scratch)."""
        if self.measure_scratch:
            self.ledger.resize(SCRATCH_TENANT, tag, nbytes)

    # -- views ---------------------------------------------------------------
    @property
    def capacity_bytes(self) -> int:
        return self.ledger.capacity_bytes

    @property
    def free_hbm_bytes(self) -> int:
        """THE headroom number (Status RPC gauge, admission's honest
        input): capacity minus every tenant's claims — weights, KV pages
        and compiled scratch together, never two optimistic per-tenant
        estimates."""
        return self.ledger.headroom_bytes

    def reclaimable_bytes(self, exclude: Optional[str] = None) -> int:
        """Bytes the OTHER tenants estimate pressure could free right now
        (admission counts this next to free headroom — demotable KV and
        evictable cold models are capacity, just not free capacity)."""
        total = 0
        for t in self._tenant_list():
            if t.name == exclude or t.reclaimable is None:
                continue
            try:
                total += max(0, int(t.reclaimable()))
            except Exception:  # a torn-down tenant must not wedge callers
                pass
        return total

    def gauges(self) -> Dict[str, int]:
        """Live tracked device bytes per tenant that registered a gauge."""
        out: Dict[str, int] = {}
        for t in self._tenant_list():
            if t.gauge is not None:
                try:
                    out[t.name] = int(t.gauge())
                except Exception:
                    pass
        return out

    def reservations(self) -> List[Dict[str, Any]]:
        """Live anti-steal reservations: bytes freed under pressure that
        are being held for blocked requesters (the debugz view of
        ``_waiting`` — empty in steady state)."""
        with self.ledger._cv:
            return [{"tenant": t, "bytes": int(n)}
                    for t, n in self._waiting.values()]

    def verify(self) -> Dict[str, Any]:
        """Ledger-vs-gauges cross-check (empty dict = consistent)."""
        return self.ledger.verify(self.gauges())

    # -- the decision --------------------------------------------------------
    def request(self, tenant: str, tag: Hashable, nbytes: int,
                timeout: Optional[float] = None,
                probe: bool = False) -> bool:
        """Grant ``nbytes`` to ``(tenant, tag)`` — atomically claimed in
        the ledger on success.  When headroom is short, pressure rounds
        ask the other tenants to reclaim the deficit (demote-KV /
        evict-model, each a chaos decision site) and wait for the
        releases to land.  ``probe=True`` runs at most one pressure
        round and returns immediately without counting a denial — the
        batcher's per-tick grow probe, cheap enough to retry every tick.

        False = denied: the requester must degrade to its pre-arbiter
        static-budget behavior (the mux waits on its own budget, the
        batcher queues on its current pool)."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return True
        end = _time.monotonic() + (self.REQUEST_TIMEOUT_S
                                   if timeout is None else max(0.0, timeout))
        barren = 0
        expected_headroom = None  # promised bytes still landing
        promise_end = 0.0
        wid = None
        try:
            while True:
                if self._try_claim(tenant, tag, nbytes, wid):
                    self.grants += 1
                    return True
                if wid is None and not probe:
                    # entering the pressure path: reserve the bytes this
                    # request is squeezing for — no other tenant's claim
                    # may take them while the reclaim lands
                    led = self.ledger
                    with led._cv:
                        self._wait_seq += 1
                        wid = self._wait_seq
                        self._waiting[wid] = (tenant, nbytes)
                headroom = self.ledger.headroom_bytes
                now = _time.monotonic()
                if (expected_headroom is not None
                        and headroom < expected_headroom
                        and now < promise_end):
                    # a prior round's reclaim is still landing (write-
                    # behind copies, the batcher's tick-boundary
                    # service): wait it out instead of pressing again —
                    # re-pressing would make tenants over-reclaim
                    # (shrink twice for one deficit)
                    self.ledger.wait_for_change(
                        min(self.PRESSURE_POLL_S, max(0.001, end - now)))
                    continue
                deficit = nbytes - headroom
                initiated = self._pressure_round(tenant, deficit)
                if initiated:
                    expected_headroom = headroom + initiated
                    promise_end = now + self.PROMISE_GRACE_S
                if probe:
                    if initiated and self._try_claim(tenant, tag, nbytes,
                                                     wid):
                        self.grants += 1
                        return True
                    return False  # probes retry next tick; not a denial
                barren = 0 if initiated else barren + 1
                now = _time.monotonic()
                if barren >= self.BARREN_ROUNDS or now >= end:
                    return self._deny(tenant, nbytes)
                self.ledger.wait_for_change(
                    min(self.PRESSURE_POLL_S, max(0.001, end - now)))
        finally:
            if wid is not None:
                led = self.ledger
                with led._cv:
                    self._waiting.pop(wid, None)
                    led._cv.notify_all()

    def _try_claim(self, tenant: str, tag: Hashable, nbytes: int,
                   wid=None) -> bool:
        led = self.ledger
        with led._cv:
            key = (tenant, tag)
            have = led._claims.get(key, 0)
            # bytes reserved for OTHER waiting requesters are off-limits
            # (a waiter's own reservation never blocks its own claim)
            reserved = sum(n for w, (t, n) in self._waiting.items()
                           if t != tenant and w != wid)
            if (led.capacity_bytes - sum(led._claims.values()) - reserved
                    >= nbytes - have):
                led._claims[key] = have + nbytes
                led._cv.notify_all()
                return True
            return False

    def _pressure_round(self, requester: str, deficit: int) -> int:
        """One round of cross-tenant pressure.  Returns the bytes the
        pressed tenants expect to free (0 = barren round).  Each press is
        a chaos decision site: error/drop suppress that press — the
        degrade is a skipped optimization, never a ledger mutation."""
        self.pressure_events += 1
        initiated = 0
        for t in self._tenant_list():
            if t.name == requester or t.reclaim is None:
                continue
            try:
                if chaos.trip("hbm.pressure") == "drop":
                    continue  # pressure black-holed: static degrade
            except chaos.ChaosError:
                continue      # injected fault: same degrade, never corrupt
            try:
                got = max(0, int(t.reclaim(int(deficit)) or 0))
            except Exception:  # a broken tenant must not wedge requests
                got = 0
            if got > 0:
                initiated += got
                self.reclaims_by_tenant[t.name] = (
                    self.reclaims_by_tenant.get(t.name, 0) + 1)
                if t.name == KV_TENANT:
                    self.demotions_forced += 1
                elif t.name == WEIGHTS_TENANT:
                    self.evictions_forced += 1
        return initiated

    def _deny(self, tenant: str, nbytes: int) -> bool:
        try:
            chaos.trip("hbm.pressure")  # the deny decision site
        except chaos.ChaosError:
            pass  # an injected fault at deny still denies, atomically
        self.denials += 1
        return False


# -- the bench row ------------------------------------------------------------
def benchmark_hbm_arbiter(lanes: int = 4, steps: int = 24,
                          prompt_len: int = 8, page_size: int = 8,
                          d_model: int = 256, n_heads: int = 4,
                          n_layers: int = 4, vocab: int = 256,
                          n_llm: int = 12, dtype=None, params=None,
                          device=None) -> Dict[str, Any]:
    """tpulab's bench ``hbm_arbiter`` row: a model-swap + KV-burst trace
    under device-memory oversubscription, arbiter ON against a static
    split.

    One capacity holds EITHER the burst's grown page pool OR a second
    dense model's weights (model B, a flat f32 vector of exactly the
    pool's elastic range), never both.  Static split: the pool stays at
    its small share (lanes cut to what it carries) and B stays resident.
    Arbiter on: the burst grows the pool by evicting B (write-behind
    swap-out), and B's next acquire presses the KV tenant back down
    (demote + shrink).  Both modes must give the same greedy tokens and
    model outputs (``parity``); the batchers take the split plan
    (``ragged=False``), tpulab's default at this max_len."""
    import numpy as np
    import torch

    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.paged import (ContinuousBatcher, _bench_prompts,
                                           _bench_tree)
    from tpulab_torch.modelstore import WeightMultiplexer, tree_nbytes

    dtype = dtype or torch.float32
    dev = resolve_device(device)
    prompts = _bench_prompts(n_llm, prompt_len, vocab)
    max_len = prompt_len + steps + 2
    pages_per_req = (max_len + page_size - 1) // page_size
    full_pages = lanes * pages_per_req + 1      # the burst's working set
    small_pages = pages_per_req + 1             # the static KV share
    # the elastic pool snaps to its size ladder (small * 2^k): the burst's
    # reachable top is the first rung >= full
    top_pages = small_pages
    while top_pages < full_pages:
        top_pages *= 2
    page_nbytes = (n_layers * 2 * page_size * d_model
                   * torch.empty((), dtype=dtype).element_size())
    # B at exactly the pool's elastic range: B hot and the full burst are
    # mutually exclusive under ``capacity`` (top rung + half a page)
    b_words = (top_pages - small_pages) * page_nbytes // 4
    capacity = top_pages * page_nbytes + page_nbytes // 2
    params = _bench_tree(params, dev, vocab, d_model, n_heads, n_layers,
                         4 * d_model)

    def build_model_b():
        r = np.random.default_rng(7)
        return {"w": torch.from_numpy(
            r.standard_normal((b_words,)).astype(np.float32))}

    class _Servable:
        def __init__(self):
            self.device_params = self._place(build_model_b())

        @staticmethod
        def _place(tree):
            return {k: v.to(dev) for k, v in tree.items()}

        def resident(self):
            return self.device_params is not None

        def param_bytes(self):
            return tree_nbytes(self.device_params or build_model_b())

        def busy(self):
            return False

        def detach(self):
            out, self.device_params = self.device_params, None
            return out

        def on_detached(self):
            pass

        def attach(self, host_tree):
            self.device_params = self._place(host_tree)

        def rebuild(self):
            return build_model_b()

    def run(arbiter_on: bool) -> Dict[str, Any]:
        b = _Servable()
        b_bytes = b.param_bytes()
        arb = (HBMArbiter(capacity, measure_scratch=False)
               if arbiter_on else None)
        # the static split runs only the lanes its fixed pool carries; the
        # arbiter mode runs them all (the pool grows to meet the burst)
        run_lanes = lanes if arbiter_on else max(
            1, (small_pages - 1) // pages_per_req)
        cb = ContinuousBatcher(
            params, n_heads=n_heads, n_layers=n_layers, lanes=run_lanes,
            max_len=max_len, page_size=page_size, n_pages=small_pages,
            compute_dtype=dtype, ragged=False, device=dev,
            kv_offload=True, hbm=arb)
        mux = WeightMultiplexer(max(b_bytes, 1), hbm=arb)
        mux.register("b", b)

        tokens: List[List[int]] = []
        outs: List[float] = []

        def b_op():
            lease = mux.acquire("b")
            try:
                outs.append(round(float(torch.tanh(
                    b.device_params["w"][:256]).sum()), 4))
            finally:
                lease.release()

        # warm-up, as tpulab's: two waves (the first grows the pool
        # mid-burst under the arbiter, the second runs at the grown size)
        # and one model op through the squeeze path
        for _ in range(2):
            for f in [cb.submit(p, steps) for p in prompts[:lanes]]:
                f.result(timeout=300)
        b_op()
        outs.clear()
        d0 = dict(denials=arb.denials, demotions=arb.demotions_forced,
                  evictions=arb.evictions_forced) if arb else {}
        pre0, grow0, shrink0 = cb.preemptions, cb.hbm_grows, cb.hbm_shrinks
        t0 = _time.perf_counter()
        b_op()  # model op before the burst: B hot, pool squeezed
        futs = [cb.submit(p, steps) for p in prompts]
        # a model op lands mid-burst: the arbiter must squeeze KV back
        futs[0].result(timeout=300)
        b_op()
        for f in futs:
            tokens.append([int(t) for t in f.result(timeout=300)])
        b_op()  # and one after: swap back in (bit-exact either way)
        wall = max(1e-6, _time.perf_counter() - t0)
        out = {
            "wall_s": wall,
            "goodput_ops_s": (len(futs) + 3) / wall,
            "tokens": tokens, "model_outs": outs,
            "pool_pages_final": cb.pool.n_pages,
            "preemptions": cb.preemptions - pre0,
        }
        if arb is not None:
            out.update(
                demotions=arb.demotions_forced - d0["demotions"],
                evictions=arb.evictions_forced - d0["evictions"],
                denials=arb.denials - d0["denials"],
                grows=cb.hbm_grows - grow0,
                shrinks=cb.hbm_shrinks - shrink0,
                free_hbm_mb=arb.free_hbm_bytes / 2**20)
        cb.shutdown()
        mux.close()
        return out

    on, off = run(True), run(False)
    parity = (on.pop("tokens") == off.pop("tokens")
              and on.pop("model_outs") == off.pop("model_outs"))
    return {
        "lanes": lanes, "steps": steps, "n_llm": n_llm,
        "small_pages": small_pages, "full_pages": full_pages,
        "arbiter_on": on, "static_split": off,
        "parity": parity,
        "goodput_ratio": on["goodput_ops_s"] / max(1e-9,
                                                   off["goodput_ops_s"]),
    }
