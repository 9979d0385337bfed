"""Admission control & QoS for the serving frontend (the port of
``tpulab/serving/admission.py``; the same decisions, reasons and hints).

trtlab's only backpressure is implicit — callers block on resource-pool
leases (SURVEY §2.5) — which collapses under heavy traffic: every request
is accepted, queues grow without bound, and decode steps are burned on
requests whose deadlines expired while they waited.  This module is the
explicit admission layer the ROADMAP north star calls for: decide AT THE
RPC BOUNDARY whether a request should run, wait, or fail fast — before it
consumes a lane, KV pages, or a session lease (the cost/performance/
resilience balancing of the adaptive-orchestration line in PAPERS.md).

:class:`AdmissionController` composes, in decision order:

1. **Token-bucket rate limits** — global and per-tenant (identity from
   the request's ``tenant_id`` field or the ``tpulab-tenant`` gRPC
   metadata key).  Rate rejections fail fast with a ``retry_after_ms``
   hint; they never occupy queue space.
2. **Bounded inflight + queue-depth caps, cost-aware** — estimated cost
   is ``prompt tokens + steps``; a request is only dispatched when the
   attached load source (a :class:`~tpulab_torch.engine.paged.ContinuousBatcher`)
   has the free KV pages and lane headroom to run it.
3. **Deadline-aware early rejection** — predicted queue wait (EWMA of
   observed service time × queue position) exceeding the remaining
   ``deadline_ms`` rejects immediately instead of burning decode steps on
   a request that cannot finish in time.
4. **Priority-ordered load shedding** — when the bounded queue overflows,
   the globally lowest-priority queued request is shed first; an arrival
   that does not outrank the lowest queued request is itself rejected.
5. **Deficit-round-robin fair queuing** (serving/fair_queue.py) — queued
   admissions dispatch in cost-weighted round robin across tenants, so
   one greedy tenant cannot starve the rest.

Every rejection carries a machine-readable ``reason`` and a
``retry_after_ms`` hint; the RPC layer maps it to the
``RESOURCE_EXHAUSTED`` status and clients honor the hint with jittered
backoff (``rpc/client.py::jittered_backoff_s``, replica sets route away).

The ``serving.admission`` chaos trip point (tpulab.chaos) forces the
overload path on demand: an ``error``/``drop`` rule converts to a
rejection (reason ``chaos``), ``delay`` models a slow admission decision.

Disarmed cost: services built without a controller pay one ``is None``
branch per request — the default-off contract.

The port adds one knob: ``AdmissionController(clock=...)``, the time
source of every decision (token-bucket refills, queue waits, the
service-time EWMA, the waiting bound; tpulab reads ``time.monotonic`` and
``time.perf_counter``, one clock on Linux), ``time.monotonic`` by
default, so scripted sequences replay deterministically.  ``metrics=`` is
an observer such as :class:`tpulab_torch.utils.metrics.AdmissionMetrics`
(the port of tpulab's, with tpulab's metric names).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from tpulab_torch import chaos
from tpulab_torch.core.deadline import Deadline
from tpulab_torch.serving.fair_queue import DeficitRoundRobinQueue

#: gRPC metadata key carrying the tenant identity (the request's
#: ``tenant_id`` field is the primary channel; metadata rides along for
#: middleboxes that never parse the payload — mirrors the trace-id pair)
TENANT_METADATA_KEY = "tpulab-tenant"

#: tenant label for requests that carry no identity
DEFAULT_TENANT = "default"

#: request classes (the offline batch lane, docs/SERVING.md "Offline
#: batch lane").  ONLINE is interactive traffic — today's behavior,
#: unchanged.  BATCH is preemptible bulk work (scoring, evals,
#: distillation traces) that admits STRICTLY below any online priority:
#: it dispatches only when no online request waits, rides its own
#: fair queue so a batch flood never moves an online tenant's DRR
#: deficit, and is excluded from the queue-wait EWMA the fleet
#: autoscaler scales on (preemptible work must never buy replicas).
REQUEST_CLASS_ONLINE = "online"
REQUEST_CLASS_BATCH = "batch"
REQUEST_CLASSES = (REQUEST_CLASS_ONLINE, REQUEST_CLASS_BATCH)

#: rejection reasons (the ``reason`` label on AdmissionMetrics.rejected)
REJECT_REASONS = ("global_rate", "tenant_rate", "queue_full", "shed",
                  "deadline", "queue_timeout", "chaos")


def tenant_of_request(request, grpc_context=None,
                      default: str = DEFAULT_TENANT) -> str:
    """Server-side tenant recovery: the request's ``tenant_id`` field
    first, else the ``tpulab-tenant`` invocation metadata, else the
    default tenant (mirrors TraceContext.of_request)."""
    t = getattr(request, "tenant_id", "")
    if t:
        return str(t)
    if grpc_context is not None and hasattr(grpc_context,
                                            "invocation_metadata"):
        try:
            for k, v in grpc_context.invocation_metadata() or ():
                if k == TENANT_METADATA_KEY and v:
                    return str(v)
        except Exception:  # pragma: no cover - exotic grpc shims
            pass
    return default


class AdmissionRejected(RuntimeError):
    """The admission controller refused the request.  ``reason`` is one
    of :data:`REJECT_REASONS`; ``retry_after_ms`` is the server's backoff
    hint (0 = no hint, e.g. the request's own deadline was the limit)."""

    def __init__(self, reason: str, message: str, retry_after_ms: int = 0):
        super().__init__(message)
        self.reason = reason
        self.retry_after_ms = int(retry_after_ms)


@dataclass
class AdmissionConfig:
    """Admission knobs (docs/SERVING.md).  ``max_inflight`` bounds
    concurrently admitted requests; ``max_queue_depth`` bounds waiting
    ones — together they are the whole memory footprint of overload.
    Rates are requests/second (0 disables a bucket); bursts default to
    one second of rate (min 1).  ``drr_quantum`` is the fair-queue
    quantum in cost units (estimated tokens).  ``expected_service_s``
    seeds the service-time EWMA the wait predictor uses before any
    completion has been observed."""

    max_inflight: int = 8
    max_queue_depth: int = 32
    global_rate: float = 0.0
    global_burst: float = 0.0
    tenant_rate: float = 0.0
    tenant_burst: float = 0.0
    drr_quantum: int = 512
    admit_wait_s: float = 30.0
    min_retry_after_ms: int = 25
    max_retry_after_ms: int = 5000
    expected_service_s: float = 0.0
    #: distinct per-tenant buckets kept before the stalest is evicted
    #: (an unauthenticated tenant header must not be a memory leak)
    tenant_bucket_cap: int = 4096
    #: per-model admission-cost multipliers (multi-model serving,
    #: docs/SERVING.md "Multi-model serving"): a heavyweight model's
    #: requests charge more of the shared capacity than a tiny one's.
    #: Models not listed cost 1.0x.
    model_costs: Optional[Dict[str, float]] = None
    #: per-model base-priority boosts added to each request's own
    #: priority (shedding order + queue ranking): a latency-critical
    #: model's traffic outranks a batch model's at overflow
    model_priorities: Optional[Dict[str, int]] = None
    #: bound on WAITING batch-class admissions (the batch lane's own
    #: fair queue, never shared with online waiters); None = the online
    #: ``max_queue_depth`` value
    max_batch_queue_depth: Optional[int] = None
    #: arbiter headroom floor for batch dispatch: with an HBM arbiter
    #: armed, batch work only dispatches while ``free_hbm_bytes`` stays
    #: at or above this — spare capacity means ACTUALLY spare, not
    #: bytes a pressure round is about to hand to an online tenant
    batch_min_free_hbm_bytes: int = 0


class TokenBucket:
    """Lazy-refill token bucket.  NOT internally locked — the controller's
    lock guards it (``clock`` injectable for deterministic tests)."""

    __slots__ = ("rate", "burst", "_tokens", "_t", "_clock")

    def __init__(self, rate: float, burst: float = 0.0, clock=time.monotonic):
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(1.0, self.rate)
        self._tokens = self.burst
        self._clock = clock
        self._t = clock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill(self._clock())
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 if already)."""
        self._refill(self._clock())
        missing = n - self._tokens
        return 0.0 if missing <= 0 else missing / self.rate


class AdmissionTicket:
    """One admitted request's capacity hold; ``release()`` (or context
    exit) returns it and dispatches the next queued admission."""

    __slots__ = ("tenant", "cost", "model", "queue_wait_s", "drr_deficit",
                 "request_class", "_ctrl", "_t_admit", "_released")

    def __init__(self, ctrl: "AdmissionController", tenant: str, cost: int,
                 queue_wait_s: float, model: str = "",
                 drr_deficit: float = 0.0,
                 request_class: str = REQUEST_CLASS_ONLINE):
        self.tenant = tenant
        self.cost = cost
        self.model = model
        #: "online" or "batch" (REQUEST_CLASSES) — batch tickets never
        #: feed the queue-wait EWMA the autoscaler scales on
        self.request_class = request_class
        self.queue_wait_s = queue_wait_s
        #: the tenant's deficit-round-robin credit at dispatch (0.0 on
        #: the no-queue fast path) — a wide event (tpulab.obs) records it
        #: so "why did this tenant's request wait" is answerable per
        #: request, not just per aggregate
        self.drr_deficit = drr_deficit
        self._ctrl = ctrl
        self._t_admit = ctrl._clock()
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._ctrl._on_release(self)

    def __enter__(self) -> "AdmissionTicket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _Waiter:
    """A queued admission request (entry in the DRR queue)."""

    __slots__ = ("tenant", "cost", "model", "priority", "deadline", "seq",
                 "event", "ticket", "reject", "t_enqueue", "request_class")

    def __init__(self, tenant: str, cost: int, priority: int,
                 deadline: Optional[Deadline], seq: int, model: str = "",
                 request_class: str = REQUEST_CLASS_ONLINE,
                 t_enqueue: float = 0.0):
        self.tenant = tenant
        self.cost = cost
        self.model = model
        self.request_class = request_class
        self.priority = priority
        self.deadline = deadline
        self.seq = seq
        self.event = threading.Event()
        self.ticket: Optional[AdmissionTicket] = None
        self.reject: Optional[AdmissionRejected] = None
        self.t_enqueue = t_enqueue


class AdmissionController:
    """The serving frontend's admission decision (module docstring).

    ``load`` is an optional load source for cost-aware admission — any
    object exposing ContinuousBatcher's surface (``lanes``,
    ``active_lanes``, ``queued_requests``, ``page_size``,
    ``pool.free_pages``); absent attributes disable that signal.
    ``metrics`` is an optional duck-typed observer (tpulab's
    ``AdmissionMetrics`` surface: ``set_pressure``, ``note_admitted``,
    ``note_rejected``); ``trace`` an optional ChromeTraceRecorder (one
    ``admission`` span per decision, timed on ``time.perf_counter`` as the
    recorder expects); ``clock`` the decisions' time source (module
    docstring).
    """

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 load=None, metrics=None, trace=None, modelstore=None,
                 hbm=None, clock=None):
        self.config = config or AdmissionConfig()
        #: the time source of every decision (module docstring)
        self._clock = clock or time.monotonic
        self._load = load
        self._metrics = metrics
        self.trace = trace
        #: optional tpulab_torch.modelstore.WeightMultiplexer — the per-model
        #: capacity gate: a request for a model that cannot be made
        #: HBM-resident without evicting a leased/pinned/decode-active
        #: model QUEUES (never thrashes the hot working set); adopted by
        #: build_infer_service when a modelstore is served
        self.modelstore = modelstore
        #: optional tpulab_torch.hbm.HBMArbiter — the unified device-memory
        #: economy.  Armed, _capacity_ok_locked consults the arbiter's
        #: ONE headroom number (free + reclaimable-under-pressure bytes)
        #: instead of summing the KV tier's and the modelstore's
        #: optimistic per-tenant estimates; adopted by
        #: build_infer_service when an arbiter is served
        self.hbm = hbm
        cfg = self.config
        self._lock = threading.Lock()
        self._queue = DeficitRoundRobinQueue(quantum=cfg.drr_quantum)
        #: batch-class waiters ride their OWN fair queue (docs/SERVING.md
        #: "Offline batch lane"): a batch flood must not occupy online
        #: queue slots or move any online tenant's DRR deficit, and batch
        #: dispatch happens only when no online waiter remains
        self._batch_queue = DeficitRoundRobinQueue(quantum=cfg.drr_quantum)
        self._inflight = 0
        self._seq = 0
        self._global_bucket = (TokenBucket(cfg.global_rate, cfg.global_burst,
                                           clock=self._clock)
                               if cfg.global_rate > 0 else None)
        self._tenant_buckets: Dict[str, TokenBucket] = {}
        self._service_ewma = (cfg.expected_service_s
                              if cfg.expected_service_s > 0 else None)
        #: EWMA of the queue wait admitted requests ACTUALLY paid
        #: (ticket.queue_wait_s at admit; 0.0 rides the no-queue fast
        #: path, pulling the average down when capacity is plentiful) —
        #: the fleet autoscaler's scale-up/down signal
        #: (tpulab.fleet.FleetAutoscaler wait_signal, docs/SERVING.md
        #: "Fleet routing & autoscaling")
        self._queue_wait_ewma: Optional[float] = None
        # -- observability (test-assertable without prometheus) -------------
        self.admitted_total = 0
        self.batch_admitted_total = 0
        self.rejected_total = 0
        self.shed_total = 0
        self.rejected_by_reason: Dict[str, int] = {}
        self.peak_queue_depth = 0
        #: live admitted requests per model name (the multi-model load
        #: view; "" aggregates requests that carried no model)
        self.model_inflight: Dict[str, int] = {}

    # -- load signals --------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """ONLINE waiters only: queued batch work is preemptible filler
        that yields its capacity within one tick, so it must not make
        this replica look loaded to routers (or to the autoscaler)."""
        with self._lock:
            return len(self._queue)

    @property
    def batch_queue_depth(self) -> int:
        """Waiting batch-class admissions (the offline lane's backlog)."""
        with self._lock:
            return len(self._batch_queue)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def queue_depths(self) -> Dict[str, int]:
        """Queued admissions per tenant (the debugz live view); batch
        tenants are namespaced ``batch:<tenant>`` — their waiters live
        in the offline lane's own fair queue."""
        with self._lock:
            depths = self._queue.depths()
            for t, n in self._batch_queue.depths().items():
                depths[f"batch:{t}"] = n
            return depths

    @property
    def queue_wait_ewma_s(self) -> float:
        """EWMA of the queue wait admitted ONLINE requests actually paid
        (seconds; 0.0 before any admission) — the load signal the fleet
        autoscaler scales on: waiting requests mean the fleet is short a
        replica long before anything is rejected.  Batch-class
        admissions are excluded by construction: the offline lane waits
        for spare capacity on purpose, and preemptible filler must
        never look like demand worth buying a replica for."""
        with self._lock:
            return self._queue_wait_ewma or 0.0

    def _capacity_ok_locked(self, cost: int, model: str = "") -> bool:
        """Cost-aware dispatch gate: the load source must have the free KV
        pages to hold ``cost`` tokens and lane headroom to schedule the
        request soon (at most one lane-set's worth queued inside the
        engine — the admission queue is where waiting happens).

        Mesh-invariant by construction (docs/SERVING.md): under sharded
        serving page *tables* are replicated and page *payloads* split
        over the model axis, so counting LOGICAL free pages is already
        the per-shard headroom — one free page is page_nbytes/M bytes
        free on every shard at once."""
        arb = self.hbm
        ms = self.modelstore
        if arb is None and ms is not None and model:
            # pre-arbiter multi-model gate (one of the two per-tenant
            # estimates the unified headroom replaces below)
            try:
                if not ms.can_admit(model):
                    # multi-model serving: this model's weights cannot be
                    # made resident without evicting a leased/pinned/
                    # decode-active model — a burst on model A queues here
                    # instead of thrashing model B's working set mid-decode
                    return False
            except Exception:  # a torn-down store must not wedge admission
                pass
        eng = self._load
        if eng is None:
            return True
        try:
            # speculative decoding holds a draft page table next to the
            # target's and burns draft+verify compute on rejected
            # proposals — the engine reports how much bigger a request
            # really is (ContinuousBatcher.admission_cost_factor);
            # drafted-but-rejected tokens are not free
            cost = int(cost * float(getattr(eng, "admission_cost_factor",
                                            1.0) or 1.0))
            pool = getattr(eng, "pool", None)
            if pool is not None:
                page_size = int(getattr(eng, "page_size", 0)
                                or getattr(pool, "page_size", 1))
                free = int(pool.free_pages)
                if arb is not None:
                    # unified HBM economy (tpulab.hbm): ONE honest
                    # headroom — free pool pages plus what the ledger has
                    # free or pressure could reclaim from the OTHER
                    # tenants (evictable cold models, measured scratch
                    # never double-counted) — instead of summing the KV
                    # tier's and the modelstore's optimistic estimates
                    pn = max(1, int(getattr(pool, "page_nbytes", 0) or 1))
                    extra = (max(0, int(arb.free_hbm_bytes))
                             + int(arb.reclaimable_bytes(exclude="kv")))
                    if ((free + extra // pn) * max(1, page_size)
                            < cost):
                        return False
                elif free * max(1, page_size) < cost:
                    # tiered KV (tpulab.kvcache): pages the engine can
                    # DEMOTE to the host tier instead of dropping count as
                    # headroom — admission sees the effective (HBM + host)
                    # capacity, not just free HBM pages
                    off = getattr(eng, "kv_offload", None)
                    if off is not None:
                        free += int(off.demotable_pages(
                            getattr(eng, "prefix_cache", None)))
                    if free * max(1, page_size) < cost:
                        return False
            lanes = int(getattr(eng, "lanes", 0) or 0)
            if lanes and (int(getattr(eng, "active_lanes", 0)) >= lanes
                          and int(getattr(eng, "queued_requests", 0))
                          >= lanes):
                return False
        except Exception:  # a torn-down pool must not wedge admission
            return True
        return True

    def headroom_ok(self, cost: int, model: str = "") -> bool:
        """Public view of the cost-aware dispatch gate — the ONE unified
        headroom admission itself consults (free pool pages, demotable
        KV, arbiter free + reclaimable bytes).  The batch lane's
        spare-capacity probe (tpulab.batch.BatchScheduler) reads it here
        instead of re-deriving its own optimistic estimate."""
        with self._lock:
            return self._capacity_ok_locked(max(1, int(cost)), model)

    def _batch_spare_locked(self, cost: int, model: str = "") -> bool:
        """Spare-capacity gate for batch-class dispatch (docs/SERVING.md
        "Offline batch lane"): no online waiter may remain (batch sits
        strictly below any online priority), the engine must have an
        IDLE lane (batch never queues inside the engine where it could
        delay an online admit), the unified headroom must cover the
        cost, and with an arbiter armed ``free_hbm_bytes`` must sit at
        or above the configured floor — spare means actually spare, not
        bytes a pressure round is about to hand to an online tenant."""
        if len(self._queue):
            return False
        if not self._capacity_ok_locked(cost, model):
            return False
        eng = self._load
        if eng is not None:
            try:
                lanes = int(getattr(eng, "lanes", 0) or 0)
                if lanes and (int(getattr(eng, "active_lanes", 0)) >= lanes
                              or int(getattr(eng, "queued_requests", 0))
                              > 0):
                    return False
            except Exception:  # torn-down engine: the capacity gate ruled
                pass
        arb = self.hbm
        floor = int(self.config.batch_min_free_hbm_bytes)
        if arb is not None and floor > 0:
            try:
                if int(arb.free_hbm_bytes) < floor:
                    return False
            except Exception:  # torn-down arbiter must not wedge batch
                pass
        return True

    # -- estimators ----------------------------------------------------------
    def _predicted_wait_locked(self, position: int) -> float:
        """Expected queue wait at ``position`` (0 = head): EWMA service
        time × slots ahead / parallelism.  0 before any observation — a
        guess must not reject real traffic."""
        if self._service_ewma is None:
            return 0.0
        par = max(1, self.config.max_inflight)
        return self._service_ewma * (position + 1) / par

    def _retry_hint_ms_locked(self) -> int:
        cfg = self.config
        est = self._predicted_wait_locked(len(self._queue))
        ms = int(est * 1e3) if est > 0 else cfg.min_retry_after_ms
        return max(cfg.min_retry_after_ms, min(cfg.max_retry_after_ms, ms))

    # -- the decision --------------------------------------------------------
    def admit(self, tenant: str = "", cost: int = 1, priority: int = 0,
              deadline: Optional[Deadline] = None,
              trace_id: Optional[str] = None,
              model: str = "",
              request_class: str = REQUEST_CLASS_ONLINE
              ) -> AdmissionTicket:
        """Admit (possibly after a bounded fair-queue wait) or raise
        :class:`AdmissionRejected`.  ``cost`` is estimated tokens
        (prompt + steps) for generation, batch size for dense inference.
        ``model`` arms the per-model dimension (multi-model serving):
        the configured per-model cost multiplier and priority boost
        apply, the modelstore residency gate is consulted, and the
        request counts in :attr:`model_inflight`.  ``request_class``
        (:data:`REQUEST_CLASSES`; ""/"online" = interactive) marks the
        offline batch lane: batch admissions dispatch strictly below any
        online work, from spare capacity only, ride their own fair
        queue (a batch flood never moves an online tenant's DRR
        deficit) and never feed the queue-wait EWMA the fleet
        autoscaler scales on.  The returned ticket MUST be released when
        the request finishes (context manager)."""
        t0 = time.perf_counter()
        tenant = tenant or DEFAULT_TENANT
        cost = max(1, int(cost))
        request_class = request_class or REQUEST_CLASS_ONLINE
        if request_class not in REQUEST_CLASSES:
            raise ValueError(f"unknown request_class {request_class!r} "
                             f"(want one of {REQUEST_CLASSES})")
        cfg = self.config
        if model:
            if cfg.model_costs:
                cost = max(1, int(cost * float(
                    cfg.model_costs.get(model, 1.0))))
            if cfg.model_priorities:
                priority += int(cfg.model_priorities.get(model, 0))
        try:
            # chaos: force the overload path on demand (error/drop -> a
            # synthetic rejection; delay -> a slow admission decision)
            try:
                if chaos.trip("serving.admission") == "drop":
                    raise chaos.ChaosError("injected admission drop")
            except chaos.ChaosError as e:
                raise AdmissionRejected(
                    "chaos", f"admission chaos: {e}",
                    retry_after_ms=self.config.min_retry_after_ms)
            ticket, waiter = self._admit_or_enqueue(tenant, cost, priority,
                                                    deadline, model,
                                                    request_class)
            if ticket is None:  # queued: wait for dispatch/shed/expiry
                ticket = self._wait(waiter, deadline)
        except AdmissionRejected as e:
            self._note_rejected(e, tenant, t0, trace_id)
            raise
        self._note_admitted(ticket, tenant, t0, trace_id)
        return ticket

    def _admit_or_enqueue(self, tenant: str, cost: int, priority: int,
                          deadline: Optional[Deadline], model: str = "",
                          request_class: str = REQUEST_CLASS_ONLINE):
        cfg = self.config
        batch = request_class == REQUEST_CLASS_BATCH
        with self._lock:
            # 1) rate limits fail fast — a bucket that says "not now" must
            # not convert rate limiting into queueing
            b = self._global_bucket
            if b is not None and not b.try_take():
                raise AdmissionRejected(
                    "global_rate", "global request rate exceeded",
                    retry_after_ms=max(cfg.min_retry_after_ms,
                                       int(b.retry_after_s() * 1e3)))
            if cfg.tenant_rate > 0:
                tb = self._tenant_buckets.get(tenant)
                if tb is None:
                    if len(self._tenant_buckets) >= cfg.tenant_bucket_cap:
                        stale = min(self._tenant_buckets,
                                    key=lambda t: self._tenant_buckets[t]._t)
                        del self._tenant_buckets[stale]
                    tb = self._tenant_buckets[tenant] = TokenBucket(
                        cfg.tenant_rate, cfg.tenant_burst,
                        clock=self._clock)
                if not tb.try_take():
                    raise AdmissionRejected(
                        "tenant_rate",
                        f"tenant {tenant!r} request rate exceeded",
                        retry_after_ms=max(cfg.min_retry_after_ms,
                                           int(tb.retry_after_s() * 1e3)))
            # 2) fast path: capacity now, nobody queued ahead.  Batch
            # arrivals additionally clear the spare-capacity gate (idle
            # lane, unified headroom, arbiter floor) — the offline lane
            # soaks what online traffic is not using, never more
            if batch:
                if (self._inflight < cfg.max_inflight
                        and not len(self._batch_queue)
                        and self._batch_spare_locked(cost, model)):
                    self._inflight += 1
                    self.model_inflight[model] = (
                        self.model_inflight.get(model, 0) + 1)
                    self._note_pressure_locked()
                    return AdmissionTicket(
                        self, tenant, cost, 0.0, model,
                        request_class=REQUEST_CLASS_BATCH), None
            elif (self._inflight < cfg.max_inflight and not len(self._queue)
                    and self._capacity_ok_locked(cost, model)):
                self._inflight += 1
                self.model_inflight[model] = (
                    self.model_inflight.get(model, 0) + 1)
                self._note_pressure_locked()
                return AdmissionTicket(self, tenant, cost, 0.0, model), None
            q = self._batch_queue if batch else self._queue
            # 3) deadline-aware early rejection: don't queue a request
            # that cannot finish in time
            if deadline is not None:
                rem = deadline.remaining()
                predicted = self._predicted_wait_locked(len(q))
                if rem is not None and predicted > 0 and rem < predicted:
                    raise AdmissionRejected(
                        "deadline",
                        f"predicted queue wait {predicted * 1e3:.0f}ms "
                        f"exceeds remaining deadline {rem * 1e3:.0f}ms",
                        retry_after_ms=min(cfg.max_retry_after_ms,
                                           int(predicted * 1e3)))
            # 4) bounded queue with lowest-priority-first shedding.  Each
            # class sheds only within itself: a batch arrival can never
            # displace an online waiter, and an online overflow never
            # needs to — batch waiters occupy no online queue slot
            depth_cap = (cfg.max_batch_queue_depth
                         if batch and cfg.max_batch_queue_depth is not None
                         else cfg.max_queue_depth)
            if len(q) >= depth_cap:
                victim = q.peek_lowest_priority()
                if victim is None or victim.priority >= priority:
                    raise AdmissionRejected(
                        "queue_full",
                        f"admission {'batch ' if batch else ''}queue full "
                        f"(depth {len(q)})",
                        retry_after_ms=self._retry_hint_ms_locked())
                q.remove(victim)
                victim.reject = AdmissionRejected(
                    "shed",
                    f"shed for a priority-{priority} request "
                    f"(own priority {victim.priority})",
                    retry_after_ms=self._retry_hint_ms_locked())
                victim.event.set()
            # 5) deficit-round-robin fair queue (per class)
            self._seq += 1
            w = _Waiter(tenant, cost, priority, deadline, self._seq, model,
                        request_class=request_class, t_enqueue=self._clock())
            q.push(w)
            if not batch:
                self.peak_queue_depth = max(self.peak_queue_depth,
                                            len(self._queue))
            self._note_pressure_locked()
            return None, w

    def _wq(self, w: _Waiter) -> DeficitRoundRobinQueue:
        """The fair queue holding this waiter (per request class)."""
        return (self._batch_queue if w.request_class == REQUEST_CLASS_BATCH
                else self._queue)

    def _wait(self, w: _Waiter, deadline: Optional[Deadline]
              ) -> AdmissionTicket:
        """Block until dispatched, shed, timed out or past deadline.  The
        short poll doubles as a liveness re-dispatch: pages freed by the
        engine (not by a ticket release) still unblock the queue."""
        end = self._clock() + self.config.admit_wait_s
        while True:
            budget = end - self._clock()
            if deadline is not None:
                rem = deadline.remaining()
                if rem is not None:
                    budget = min(budget, rem)
            w.event.wait(timeout=max(0.0, min(0.05, budget)))
            with self._lock:
                if w.ticket is not None:
                    self._note_pressure_locked()
                    return w.ticket
                if w.reject is not None:
                    raise w.reject
                if deadline is not None and deadline.expired():
                    self._wq(w).remove(w)
                    self._note_pressure_locked()
                    raise AdmissionRejected(
                        "deadline", "deadline expired while queued",
                        retry_after_ms=0)
                if self._clock() >= end:
                    self._wq(w).remove(w)
                    self._note_pressure_locked()
                    raise AdmissionRejected(
                        "queue_timeout",
                        f"no capacity within "
                        f"{self.config.admit_wait_s:g}s",
                        retry_after_ms=self._retry_hint_ms_locked())
                self._dispatch_locked()

    def _dispatch_locked(self) -> None:
        """Move queued waiters into inflight while capacity allows, in
        DRR order.  A waiter the pool cannot hold yet goes back to the
        head (pages free continuously; the fairness charge is refunded).
        Batch-class waiters dispatch ONLY once no online waiter remains
        — and only into spare capacity — so the offline lane sits
        strictly below every online priority without sharing a queue."""
        while self._inflight < self.config.max_inflight and len(self._queue):
            w = self._queue.pop()
            if w.deadline is not None and w.deadline.expired():
                w.reject = AdmissionRejected(
                    "deadline", "deadline expired while queued",
                    retry_after_ms=0)
                w.event.set()
                continue
            if not self._capacity_ok_locked(w.cost, w.model):
                self._queue.requeue_front(w, refund=w.cost)
                break
            self._inflight += 1
            self.model_inflight[w.model] = (
                self.model_inflight.get(w.model, 0) + 1)
            w.ticket = AdmissionTicket(
                self, w.tenant, w.cost,
                self._clock() - w.t_enqueue, w.model,
                drr_deficit=self._queue.deficit_of(w.tenant))
            w.event.set()
        while (self._inflight < self.config.max_inflight
               and len(self._batch_queue) and not len(self._queue)):
            w = self._batch_queue.pop()
            if w.deadline is not None and w.deadline.expired():
                w.reject = AdmissionRejected(
                    "deadline", "deadline expired while queued",
                    retry_after_ms=0)
                w.event.set()
                continue
            if not self._batch_spare_locked(w.cost, w.model):
                self._batch_queue.requeue_front(w, refund=w.cost)
                break
            self._inflight += 1
            self.model_inflight[w.model] = (
                self.model_inflight.get(w.model, 0) + 1)
            w.ticket = AdmissionTicket(
                self, w.tenant, w.cost,
                self._clock() - w.t_enqueue, w.model,
                drr_deficit=self._batch_queue.deficit_of(w.tenant),
                request_class=REQUEST_CLASS_BATCH)
            w.event.set()

    def _on_release(self, ticket: AdmissionTicket) -> None:
        hold_s = self._clock() - ticket._t_admit
        with self._lock:
            self._inflight -= 1
            n = self.model_inflight.get(ticket.model, 0) - 1
            if n > 0:
                self.model_inflight[ticket.model] = n
            else:
                self.model_inflight.pop(ticket.model, None)
            # EWMA of observed service time feeds the wait predictor
            self._service_ewma = (hold_s if self._service_ewma is None
                                  else 0.8 * self._service_ewma
                                  + 0.2 * hold_s)
            self._dispatch_locked()
            self._note_pressure_locked()

    # -- telemetry -----------------------------------------------------------
    def _note_pressure_locked(self) -> None:
        if self._metrics is not None:
            self._metrics.set_pressure(len(self._queue), self._inflight)

    def _note_admitted(self, ticket: AdmissionTicket, tenant: str,
                       t0: float, trace_id: Optional[str]) -> None:
        with self._lock:
            self.admitted_total += 1
            if ticket.request_class == REQUEST_CLASS_BATCH:
                # the offline lane NEVER feeds the queue-wait EWMA: the
                # fleet autoscaler scales on it, and preemptible filler
                # waiting for spare capacity must not buy replicas
                # (docs/SERVING.md "Offline batch lane")
                self.batch_admitted_total += 1
            else:
                w = ticket.queue_wait_s
                self._queue_wait_ewma = (w if self._queue_wait_ewma is None
                                         else 0.8 * self._queue_wait_ewma
                                         + 0.2 * w)
        if self._metrics is not None:
            self._metrics.note_admitted(tenant, ticket.queue_wait_s)
        if self.trace is not None:
            args = {"decision": "admit", "tenant": tenant}
            if trace_id:
                args["trace_id"] = trace_id
            self.trace.add_span("admission", t0,
                                time.perf_counter() - t0, **args)

    def _note_rejected(self, e: AdmissionRejected, tenant: str,
                       t0: float, trace_id: Optional[str]) -> None:
        with self._lock:
            self.rejected_total += 1
            self.rejected_by_reason[e.reason] = (
                self.rejected_by_reason.get(e.reason, 0) + 1)
            if e.reason == "shed":
                self.shed_total += 1
        if self._metrics is not None:
            self._metrics.note_rejected(e.reason, tenant)
        if self.trace is not None:
            args = {"decision": "reject", "reason": e.reason,
                    "tenant": tenant,
                    "retry_after_ms": e.retry_after_ms}
            if trace_id:
                args["trace_id"] = trace_id
            self.trace.add_span("admission", t0,
                                time.perf_counter() - t0, **args)
