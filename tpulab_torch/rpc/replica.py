"""Cross-process replica routing: client-side replica sets over remote
inference endpoints (the port of ``tpulab/rpc/replica.py``: routing,
breaker, deadline and failover decisions are tpulab's).

The reference scales out with N single-GPU services behind an L7 balancer
(examples/98_MultiProcessSingleStream launch topology + examples/99's
envoy); this is the in-framework form of the same axis (SURVEY §2.8
axes 5-6): a :class:`ReplicaSet` holds one remote manager per endpoint,
health-checks them, routes each request to the least-loaded live replica
and fails a request over to the next replica when one dies mid-flight
(inference is idempotent — a retry cannot corrupt state).

Circuit breaker (beyond-reference; the resilience-balancing argument of
the adaptive-orchestration line in PAPERS.md): per-replica failure streaks
eject a replica from routing after ``breaker_threshold`` consecutive
faults (state *open*), a lazily-started background prober re-checks it
over the existing ``health`` RPC with exponential backoff (state
*probing*), and a passing probe — or a success from fallback traffic —
restores it (state *closed*).  Steady-state traffic therefore never waits
on a known-dead endpoint: the dead replica is skipped at pick time
instead of being re-discovered (and timed out on) per request.  When
EVERY candidate is open the pick falls back to the open ones — an
all-dead set must still attempt traffic rather than refuse it.

Deadlines: ``infer(deadline_s=...)`` / ``generate(deadline_s=...)`` bound
the request END TO END.  Each unary attempt gets an even split of the
remaining budget (``Deadline.per_attempt``) as its gRPC deadline, so one
black-holed replica cannot eat the whole budget; generation attempts
carry the remaining budget to the server (``GenerateRequest.deadline_ms``)
so the engine cancels before its next token step.  Expiry raises
:class:`~tpulab_torch.core.deadline.DeadlineExceeded` and is NEVER failed over
— the budget is global, no replica can beat it.

:class:`GenerationReplicaSet` extends the same routing to token-streaming
generation (beyond-reference: the trtlab serving surface has no
generation path).  Failover here must respect server-side state: a
generation is deterministic given (prompt, steps, sampling params, seed)
— greedy decoding by construction, sampled decoding because the engines
key their Gumbel streams by (seed, position), independent of batch
composition.  The set therefore injects a client-side seed when sampling
without one, and on a mid-stream replica death REPLAYS the request on
another replica, skipping the tokens already delivered — the consumer
sees one uninterrupted, exactly-once token stream.

Complements, not replaces, a real L7 balancer: envoy owns cross-client
balancing in deployment (examples/99_loadbalancer); these sets give one
process the same behavior with zero infrastructure.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

from tpulab_torch.core.deadline import Deadline, DeadlineExceeded
from tpulab_torch.rpc.infer_service import (GenerateStreamClient,
                                      RemoteInferenceManager)
from tpulab_torch.utils.tracing import mint_trace_id

log = logging.getLogger("tpulab_torch.rpc")


def _status_code_of(exc: Optional[BaseException]) -> str:
    """Attempt-outcome label for the per-attempt counter: the gRPC status
    code name when the transport provides one, the protocol status for
    server-side rejections, the framework's own classes otherwise."""
    if exc is None:
        return "OK"
    if isinstance(exc, DeadlineExceeded):
        return "DEADLINE_EXCEEDED"
    from tpulab_torch.rpc.infer_service import StreamStalled
    if isinstance(exc, StreamStalled):
        # the stall watchdog's distinct evidence class: a replica that
        # stopped emitting is not the same signal as one that refused
        return "STALLED"
    from tpulab_torch.rpc.infer_service import GenerationRejected
    if isinstance(exc, GenerationRejected):
        from tpulab_torch.rpc.protos import inference_pb2 as pb
        try:
            return pb.StatusCode.Name(exc.code)
        except ValueError:
            return f"CODE_{exc.code}"
    import grpc
    if isinstance(exc, grpc.RpcError):
        try:
            return exc.code().name
        except Exception:  # noqa: BLE001 - exotic RpcError shims
            return "RPC_ERROR"
    return type(exc).__name__


class _BaseReplicaSet:
    """Shared routing state: least-loaded pick with round-robin
    tie-breaking, per-replica health + circuit breaker, inflight/served
    accounting."""

    def __init__(self, addresses: Sequence[str], model_name: str,
                 channels: int = 1, max_failover: Optional[int] = None,
                 metrics=None, breaker_threshold: int = 3,
                 probe_backoff_s: float = 0.25,
                 probe_backoff_cap_s: float = 30.0,
                 probe_timeout_s: float = 5.0, trace=None,
                 overload_retries: int = 1):
        if not addresses:
            raise ValueError("need at least one replica address")
        self.addresses = list(addresses)
        self.model_name = model_name
        self._channels = channels
        self._managers = [RemoteInferenceManager(a, channels=channels)
                          for a in self.addresses]
        self._inflight = [0] * len(self._managers)
        #: requests completed per replica (observability / test assertions)
        self.served = [0] * len(self._managers)
        self._lock = threading.Lock()
        self._rr = 0  # tie-break rotation cursor
        # -- overload routing (RESOURCE_EXHAUSTED admission fast-fails) -----
        # an overloaded replica is NOT a dead replica: it never counts
        # toward the breaker streak; instead routing backs off it for the
        # server's jittered retry_after window, and when EVERY replica is
        # overloaded the request itself waits one jittered retry-after
        # round (up to ``overload_retries`` rounds) before re-spreading
        self._backoff_until = [0.0] * len(self._managers)
        self._overload_retries = max(0, overload_retries)
        #: cumulative RESOURCE_EXHAUSTED fast-fails observed (tests)
        self.overloads = 0
        #: last server-reported queued_requests per replica (Status RPC,
        #: refreshed by poll_load()) — the inflight tie-breaker
        self._load_hint = [0] * len(self._managers)
        #: last server-reported disaggregation role per replica
        #: ("prefill"/"decode"/"unified"/"" unknown; Status RPC via
        #: poll_load()) — role-aware routing reads these
        self._role_hint = [""] * len(self._managers)
        #: whether each replica last reported this set's model HBM-
        #: resident (multi-model serving, StatusResponse.resident_models
        #: via poll_load()); None = the replica never reported residency
        #: (no modelstore) and the preference stays neutral
        self._hot_hint: List[Optional[bool]] = [None] * len(self._managers)
        #: last server-reported free_hbm_bytes per replica (Status RPC via
        #: poll_load; None = the replica reports no arbiter) — the fleet
        #: router's spill signal
        self._hbm_hint: List[Optional[int]] = [None] * len(self._managers)
        # -- fleet membership (tpulab_torch.fleet): draining replicas finish
        # what they have and gain NOTHING new; retired replicas are
        # tombstoned — the slot stays (in-flight callbacks index by
        # position; reshuffling indices under live requests would corrupt
        # the accounting) but is excluded from every pick and its channel
        # is closed --------------------------------------------------------
        self._draining = [False] * len(self._managers)
        self._retired: set = set()
        #: max_failover=None tracks ACTIVE membership as the fleet scales
        self._max_failover_auto = max_failover is None
        self._max_failover = (len(self._managers) if max_failover is None
                              else max_failover)
        # -- circuit breaker (0/None disables) ------------------------------
        self._cb_threshold = breaker_threshold or 0
        self._fail_streak = [0] * len(self._managers)
        self._open: set = set()        # ejected replica indices
        self._probing: set = set()     # currently being re-probed
        self._probe_backoff_s = probe_backoff_s
        self._probe_backoff_cap_s = probe_backoff_cap_s
        self._probe_timeout_s = probe_timeout_s
        self._probe_next: Dict[int, float] = {}      # idx -> monotonic due
        self._probe_interval: Dict[int, float] = {}  # idx -> current backoff
        # the probe thread is created LAZILY on first ejection: a healthy
        # set runs zero extra threads (steady state pays nothing)
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_wake = threading.Event()
        self._probe_stop = False
        #: cumulative breaker ejections (observability / test assertions)
        self.ejections = 0
        #: optional :class:`tpulab_torch.utils.metrics.ReplicaSetMetrics`
        self._metrics = metrics
        #: optional :class:`tpulab_torch.utils.tracing.ChromeTraceRecorder` —
        #: per-attempt client spans (trace id + attempt + replica), the
        #: client half of the merged request timeline
        self.trace = trace
        if metrics is not None:
            # label children resolved ONCE: .labels() takes the metric's
            # lock + hashes the tuple, too heavy for inside the routing
            # critical section on every pick/completion
            self._m_inflight = [metrics.inflight.labels(replica=a)
                                for a in self.addresses]
            self._m_requests = [metrics.requests.labels(replica=a)
                                for a in self.addresses]
            # live children are NOT pre-created: a gauge child is born at
            # 0, and "0 = dead" must only ever come from a real probe
            if hasattr(metrics, "set_breaker_state"):
                for a in self.addresses:  # every breaker starts closed
                    metrics.set_breaker_state(a, "closed")

    # -- metrics hooks (no-ops without a metrics object) --------------------
    def _note_inflight(self, idx: int) -> None:
        """CALLER HOLDS self._lock."""
        if self._metrics is not None:
            self._m_inflight[idx].set(self._inflight[idx])

    def _note_served(self, idx: int) -> None:
        if self._metrics is not None:
            self._m_requests[idx].inc()

    def _note_failover(self) -> None:
        if self._metrics is not None:
            self._metrics.failovers.inc()

    def _note_breaker(self, idx: int, to_state: str) -> None:
        """Breaker state change (cold path: ejection/probe/restore)."""
        m = self._metrics
        if m is not None and hasattr(m, "note_breaker_transition"):
            m.note_breaker_transition(self.addresses[idx], to_state)

    def _note_attempt(self, exc: Optional[BaseException]) -> None:
        """Per-attempt terminal status, keyed the way retry policies are
        tuned: gRPC status code name when the transport says, else the
        framework's own classification."""
        m = self._metrics
        if m is not None and hasattr(m, "note_attempt"):
            m.note_attempt(_status_code_of(exc))

    def _note_deadline(self, met: bool, deadline: Deadline) -> None:
        """Outcome of a deadline-BOUNDED request (unbounded ones don't
        report: 'met' would be vacuous)."""
        m = self._metrics
        if (m is not None and hasattr(m, "observe_deadline")
                and deadline.expiry is not None):
            m.observe_deadline(met, deadline.remaining())

    def _attempt_span(self, start_s: float, idx: int, attempt: int,
                      trace_id: Optional[str],
                      exc: Optional[BaseException], **extra) -> None:
        """One client-side attempt span (tagged attempt + replica + code;
        replay/resume attempts add ``resumed_from=`` + ``mode=`` so the
        merged timeline shows where a stream migrated)."""
        tr = self.trace
        if tr is None:
            return
        import time as _t
        args = {"replica": self.addresses[idx], "attempt": attempt,
                "code": _status_code_of(exc), **extra}
        if trace_id:
            args["trace_id"] = trace_id
        tr.add_span("attempt", start_s, _t.perf_counter() - start_s, **args)

    # -- circuit breaker ----------------------------------------------------
    def breaker_states(self) -> Dict[str, str]:
        """Per-replica breaker state: ``closed`` (routing normally),
        ``open`` (ejected), ``probing`` (ejected, re-probe in flight) —
        plus the fleet lifecycle states ``draining`` (finishing, gains
        nothing new) and ``retired`` (tombstoned, channel closed)."""
        with self._lock:
            return {a: ("retired" if i in self._retired
                        else "draining" if self._draining[i]
                        else "probing" if i in self._probing
                        else "open" if i in self._open else "closed")
                    for i, a in enumerate(self.addresses)}

    def _record_success(self, idx: int) -> None:
        """A completed request (or deterministic app-level rejection):
        resets the streak and closes the circuit if fallback traffic
        reached an ejected replica successfully."""
        if not self._cb_threshold:
            return
        with self._lock:
            self._fail_streak[idx] = 0
            if idx in self._open:
                self._restore_locked(idx, "traffic")

    def _record_overload(self, idx: int, retry_after_ms: int) -> None:
        """A RESOURCE_EXHAUSTED admission fast-fail: overload is not a
        dead replica, so the breaker streak is untouched — routing just
        avoids the replica for a jittered retry-after window."""
        from tpulab_torch.rpc.client import jittered_backoff_s
        until = time.monotonic() + jittered_backoff_s(retry_after_ms)
        with self._lock:
            self.overloads += 1
            self._backoff_until[idx] = max(self._backoff_until[idx], until)

    def _overload_wait_s(self, retry_after_ms: int, round_no: int,
                         deadline: Deadline) -> Optional[float]:
        """The jittered whole-request backoff once EVERY replica is
        overloaded; None when the deadline cannot afford the wait."""
        from tpulab_torch.rpc.client import jittered_backoff_s
        delay = jittered_backoff_s(retry_after_ms, attempt=round_no)
        rem = deadline.remaining()
        if rem is not None and rem <= delay:
            return None
        return delay

    def _record_failure(self, idx: int) -> None:
        """A replica fault (transport error, timeout, retryable engine
        failure).  ``breaker_threshold`` consecutive faults eject."""
        if not self._cb_threshold:
            return
        eject = False
        with self._lock:
            self._fail_streak[idx] += 1
            if (self._fail_streak[idx] >= self._cb_threshold
                    and idx not in self._open):
                self._open.add(idx)
                self._probe_interval[idx] = self._probe_backoff_s
                self._probe_next[idx] = (time.monotonic()
                                         + self._probe_backoff_s)
                self.ejections += 1
                eject = True
        if eject:
            log.warning("replica %s ejected after %d consecutive failures; "
                        "background probe armed", self.addresses[idx],
                        self._cb_threshold)
            self._note_breaker(idx, "open")
            self._ensure_probe_thread()
            self._probe_wake.set()

    def _restore_locked(self, idx: int, how: str) -> None:
        """CALLER HOLDS self._lock."""
        self._open.discard(idx)
        self._probing.discard(idx)
        self._fail_streak[idx] = 0
        self._probe_next.pop(idx, None)
        self._probe_interval.pop(idx, None)
        self._note_breaker(idx, "closed")
        log.info("replica %s restored to rotation (%s)",
                 self.addresses[idx], how)

    def _ensure_probe_thread(self) -> None:
        with self._lock:
            if self._probe_thread is not None and self._probe_thread.is_alive():
                return
            if self._probe_stop:
                return
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="replica-probe", daemon=True)
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        """Re-probe ejected replicas over the existing health RPC with
        per-replica exponential backoff; exits only at close()."""
        while True:
            with self._lock:
                if self._probe_stop:
                    return
                targets = sorted(self._open - self._probing)
            if not targets:
                self._probe_wake.wait(timeout=1.0)
                self._probe_wake.clear()
                continue
            now = time.monotonic()
            due = [i for i in targets
                   if self._probe_next.get(i, 0.0) <= now]
            if not due:
                soonest = min(self._probe_next.get(i, now) for i in targets)
                self._probe_wake.wait(timeout=min(1.0, max(0.01,
                                                           soonest - now)))
                self._probe_wake.clear()
                continue
            for idx in due:
                with self._lock:
                    if self._probe_stop:
                        return
                    if idx not in self._open:
                        continue
                    self._probing.add(idx)
                self._note_breaker(idx, "probing")
                ok = False
                try:
                    resp = self._managers[idx].health_async().result(
                        timeout=self._probe_timeout_s)
                    ok = bool(resp.live and resp.ready)
                except Exception:  # noqa: BLE001 - still dead is data
                    ok = False
                with self._lock:
                    self._probing.discard(idx)
                    if idx not in self._open:
                        continue  # restored by traffic while we probed
                    if ok:
                        self._restore_locked(idx, "background probe")
                    else:
                        iv = min(self._probe_interval.get(
                            idx, self._probe_backoff_s) * 2,
                            self._probe_backoff_cap_s)
                        self._probe_interval[idx] = iv
                        self._probe_next[idx] = time.monotonic() + iv
                        self._note_breaker(idx, "open")  # probe failed

    # -- fleet membership (tpulab_torch.fleet.FleetAutoscaler drives these) -------
    def _on_add_replica_locked(self, idx: int, manager) -> None:
        """Subclass hook: extend per-replica parallel state.  CALLER
        HOLDS self._lock."""

    def add_replica(self, address: str) -> int:
        """Scale-up: join ``address`` to the set (routable immediately).
        Returns its index.  Re-joining a retired address adds a fresh
        slot — the tombstoned one stays closed."""
        mgr = RemoteInferenceManager(address, channels=self._channels)
        with self._lock:
            idx = len(self._managers)
            self.addresses.append(address)
            self._managers.append(mgr)
            self._inflight.append(0)
            self.served.append(0)
            self._backoff_until.append(0.0)
            self._load_hint.append(0)
            self._role_hint.append("")
            self._hot_hint.append(None)
            self._hbm_hint.append(None)
            self._draining.append(False)
            self._fail_streak.append(0)
            if self._max_failover_auto:
                self._max_failover = self._active_count_locked()
            if self._metrics is not None:
                self._m_inflight.append(
                    self._metrics.inflight.labels(replica=address))
                self._m_requests.append(
                    self._metrics.requests.labels(replica=address))
                if hasattr(self._metrics, "set_breaker_state"):
                    self._metrics.set_breaker_state(address, "closed")
            self._on_add_replica_locked(idx, mgr)
        log.info("replica %s joined the set (index %d)", address, idx)
        return idx

    def set_draining(self, address: str, draining: bool = True) -> None:
        """Router-local drain flag: a draining replica finishes its
        in-flight work but is excluded from every new pick (and from the
        affinity ring).  ``poll_load`` also sets it from the server-
        reported ``StatusResponse.draining``, so any router polling a
        draining replica learns without being told."""
        with self._lock:
            self._draining[self.addresses.index(address)] = bool(draining)
            if self._max_failover_auto:
                self._max_failover = self._active_count_locked()

    def retire_replica(self, address: str) -> None:
        """Scale-down completion: tombstone the (drained) replica — out
        of every pick and ring forever — and close its channel.  Indices
        of other replicas never move (in-flight callbacks hold them)."""
        with self._lock:
            idx = self.addresses.index(address)
            self._retired.add(idx)
            self._draining[idx] = False
            self._open.discard(idx)
            self._probing.discard(idx)
            self._probe_next.pop(idx, None)
            self._probe_interval.pop(idx, None)
            if self._max_failover_auto:
                self._max_failover = self._active_count_locked()
            mgr = self._managers[idx]
        log.info("replica %s retired from the set", address)
        self._drop_metric_children(address)
        try:
            mgr.close()
        except Exception:  # pragma: no cover - teardown best-effort
            pass

    def _drop_metric_children(self, address: str) -> None:
        """Stop a tombstoned replica's label children from exporting
        forever: a retired slot must disappear from /metrics, not
        freeze at its last-known values (breaker one-hot, prefix
        gauges, liveness, traffic counters).  A re-joined address gets
        fresh children from ``add_replica``.  The cached child handles
        (``_m_inflight``/``_m_requests``) stay valid for in-flight
        callbacks — updates to a removed child simply no longer
        export."""
        m = self._metrics
        if m is None:
            return
        from tpulab_torch.utils.metrics import BREAKER_STATES
        for name in ("requests", "inflight", "live", "prefix_hits",
                     "prefix_lookups"):
            child = getattr(m, name, None)
            if child is None:
                continue
            try:
                child.remove(address)
            except (KeyError, AttributeError):
                pass  # never labeled for this replica
        for name, states in (("breaker_state", BREAKER_STATES),
                             ("breaker_transitions", BREAKER_STATES)):
            fam = getattr(m, name, None)
            if fam is None:
                continue
            for s in states:
                try:
                    fam.remove(address, s)
                except (KeyError, AttributeError):
                    pass

    def _active_locked(self) -> List[int]:
        """Indices eligible for NEW work: not retired, not draining.
        CALLER HOLDS self._lock.  (Breaker-open replicas stay listed —
        they are sick, not leaving; the pick-time fallbacks own them.)"""
        return [i for i in range(len(self._managers))
                if i not in self._retired and not self._draining[i]]

    def _active_count_locked(self) -> int:
        return max(1, len(self._active_locked()))

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active_locked())

    def active_addresses(self) -> List[str]:
        with self._lock:
            return [self.addresses[i] for i in self._active_locked()]

    def load_hints(self) -> Dict[str, int]:
        """Last server-reported queue depth per replica (poll_load)."""
        with self._lock:
            return dict(zip(self.addresses, self._load_hint))

    def draining_addresses(self) -> List[str]:
        with self._lock:
            return [a for i, a in enumerate(self.addresses)
                    if self._draining[i] and i not in self._retired]

    # -- health -------------------------------------------------------------
    def health(self, timeout: float = 10.0) -> Dict[str, dict]:
        """Per-replica liveness/readiness (exceptions become dead
        entries rather than raising — the set is expected to outlive
        individual replicas).  A live+ready result also closes that
        replica's circuit: an explicit health() IS a probe."""
        out: Dict[str, dict] = {}
        futs = []
        with self._lock:
            retired = set(self._retired)
        for i, (a, m) in enumerate(zip(self.addresses, self._managers)):
            if i in retired:
                continue  # tombstoned: channel closed, nothing to probe
            try:
                futs.append((a, m.health_async()))
            except Exception as e:  # noqa: BLE001 - submission itself failed
                out[a] = {"live": False, "ready": False,
                          "error": f"{type(e).__name__}: {e}"}
        for addr, fut in futs:
            try:
                resp = fut.result(timeout=timeout)
                out[addr] = {"live": resp.live, "ready": resp.ready}
            except Exception as e:  # noqa: BLE001 - dead replica is data
                out[addr] = {"live": False, "ready": False,
                             "error": f"{type(e).__name__}: {e}"}
        with self._lock:
            for i, a in enumerate(self.addresses):
                h = out.get(a)
                if (h is not None and h["live"] and h["ready"]
                        and i in self._open):
                    self._restore_locked(i, "health()")
        if self._metrics is not None:
            for addr, h in out.items():  # cold path: .labels() is fine here
                self._metrics.live.labels(replica=addr).set(
                    1 if h["live"] else 0)
        return out

    # -- reported load (Status RPC gauges) ----------------------------------
    def poll_load(self, timeout: float = 5.0) -> Dict[str, dict]:
        """Refresh each replica's server-reported load (StatusResponse
        ``queued_requests`` / ``free_kv_pages``) — the tie-break hint
        ``_pick_locked`` prefers.  Dead replicas keep their last hint
        (they are routed around by health/breaker, not by load)."""
        out: Dict[str, dict] = {}
        futs = []
        with self._lock:
            retired = set(self._retired)
        for i, (a, m) in enumerate(zip(self.addresses, self._managers)):
            if i in retired:
                continue  # tombstoned: channel closed, nothing to poll
            try:
                futs.append((i, a, m.server_status_async()))
            except Exception as e:  # noqa: BLE001 - submission failed
                out[a] = {"error": f"{type(e).__name__}: {e}"}
        for i, addr, fut in futs:
            try:
                resp = fut.result(timeout=timeout)
                role = str(getattr(resp, "role", "") or "")
                resident = [str(m) for m in
                            getattr(resp, "resident_models", ())]
                host = [str(m) for m in getattr(resp, "host_models", ())]
                # per-replica prefix-cache effectiveness (ROADMAP item 1:
                # prefix-affinity routing tunes against these) — lifetime
                # counters, sampled into gauges
                p_hits = int(getattr(resp, "prefix_hits", 0) or 0)
                p_lookups = int(getattr(resp, "prefix_lookups", 0) or 0)
                # rolling-restart / scale-down drain: the replica is
                # finishing its in-flight work and must gain nothing new
                drn = bool(getattr(resp, "draining", False))
                free_hbm = int(getattr(resp, "free_hbm_bytes", 0) or 0)
                out[addr] = {"queued_requests": int(resp.queued_requests),
                             "free_kv_pages": int(resp.free_kv_pages),
                             # unified HBM economy (tpulab_torch.hbm): the one
                             # honest device-headroom gauge (0 = replica
                             # serves without an arbiter)
                             "free_hbm_bytes": int(
                                 getattr(resp, "free_hbm_bytes", 0) or 0),
                             "role": role,
                             "resident_models": resident,
                             "host_models": host,
                             "prefix_hits": p_hits,
                             "prefix_lookups": p_lookups,
                             "draining": drn,
                             # streams currently in service on the
                             # replica (process-boundary drain/probe
                             # evidence, tpulab_torch.fleet.process)
                             "inflight_requests": int(
                                 getattr(resp, "inflight_requests", 0)
                                 or 0)}
                m = self._metrics
                if m is not None and hasattr(m, "prefix_hits"):
                    # cold path (one Status RPC per replica per poll):
                    # .labels() here is fine
                    m.prefix_hits.labels(replica=addr).set(p_hits)
                    m.prefix_lookups.labels(replica=addr).set(p_lookups)
                with self._lock:
                    self._load_hint[i] = int(resp.queued_requests)
                    self._role_hint[i] = role
                    # 0 = "no arbiter served" by proto convention; the
                    # spill signal only trusts a real report
                    self._hbm_hint[i] = free_hbm if free_hbm else None
                    if drn:
                        # OR, don't overwrite: the controlling router may
                        # have flagged the drain locally BEFORE the
                        # server's readiness flip landed — un-draining
                        # goes through set_draining(addr, False)
                        self._draining[i] = True
                        if self._max_failover_auto:
                            self._max_failover = self._active_count_locked()
                    # multi-model residency: only meaningful when the
                    # replica runs a modelstore (it reports SOME list);
                    # single-model replicas stay neutral (None)
                    self._hot_hint[i] = (self.model_name in resident
                                         if (resident or host) else None)
            except Exception as e:  # noqa: BLE001 - dead replica is data
                out[addr] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def roles(self) -> Dict[str, str]:
        """Last known disaggregation role per replica (poll_load
        refreshes; "" = never heard)."""
        with self._lock:
            return dict(zip(self.addresses, self._role_hint))

    # -- dispatch -----------------------------------------------------------
    def _pick_locked(self, exclude: frozenset) -> Optional[int]:
        """Least-loaded with server-reported-load tie-breaking, then
        round-robin (sequential traffic rotates instead of piling onto
        index 0 — envoy's round-robin behavior at the tie).  Breaker-open
        and overload-backoff replicas are skipped, with graceful
        fallbacks: backoff is ignored before open is (a merely-overloaded
        replica beats a dead one), and when every non-excluded replica is
        open the pick still attempts traffic (the attempt doubles as a
        live probe).  Draining and retired replicas (fleet scale-down)
        are out of EVERY tier — they must finish what they have and gain
        nothing new, even as a last resort.  CALLER HOLDS self._lock;
        does NOT bump inflight — the single shared selection algorithm."""
        now = time.monotonic()
        live = self._active_locked()
        candidates = [(self._inflight[i], i) for i in live
                      if i not in exclude and i not in self._open
                      and self._backoff_until[i] <= now]
        if not candidates:  # everyone healthy is backing off: prefer an
            #                 overloaded replica over a breaker-open one
            candidates = [(self._inflight[i], i) for i in live
                          if i not in exclude and i not in self._open]
        if not candidates:
            candidates = [(self._inflight[i], i) for i in live
                          if i not in exclude]
        if not candidates:
            return None
        lo = min(n for n, _ in candidates)
        tied = [i for n, i in candidates if n == lo]
        if len(tied) > 1:
            # inflight tie: prefer a replica that already has this set's
            # model HBM-resident (multi-model serving, poll_load's
            # residency hint) — routing to a cold replica pays a weight
            # swap-in on the request path.  Only narrows when SOME tied
            # replica is known-hot; with none (all cold or never
            # reported) the tie passes through untouched.
            hot = [i for i in tied if self._hot_hint[i] is True]
            if hot and len(hot) < len(tied):
                tied = hot
        if len(tied) > 1:
            # then prefer the replica whose LAST REPORTED load
            # (Status RPC queued_requests, poll_load()) is lowest — local
            # inflight is this client's view only; the hint folds in what
            # every other client is doing.  RR still rotates full ties.
            lo_hint = min(self._load_hint[i] for i in tied)
            tied = [i for i in tied if self._load_hint[i] == lo_hint]
        idx = tied[self._rr % len(tied)]
        self._rr += 1
        return idx

    def _pick(self, exclude: frozenset) -> Optional[int]:
        with self._lock:
            idx = self._pick_locked(exclude)
            if idx is not None:
                self._inflight[idx] += 1
                self._note_inflight(idx)
            return idx

    def _pick_or_any(self, exclude: frozenset) -> Optional[int]:
        idx = self._pick(exclude)
        if idx is None:  # every replica already failed this request
            idx = self._pick(frozenset())
        return idx

    @property
    def inflight(self) -> List[int]:
        with self._lock:
            return list(self._inflight)

    def close(self) -> None:
        with self._lock:
            self._probe_stop = True
            t = self._probe_thread
        self._probe_wake.set()
        if t is not None:
            t.join(timeout=self._probe_timeout_s + 2.0)
        for m in self._managers:
            try:
                m.close()
            except Exception:  # pragma: no cover - teardown best-effort
                pass


class ReplicaSet(_BaseReplicaSet):
    """Least-loaded router with failover over remote unary replicas."""

    def __init__(self, addresses: Sequence[str], model_name: str,
                 channels: int = 1, max_failover: Optional[int] = None,
                 metrics=None, **breaker_kw):
        super().__init__(addresses, model_name, channels, max_failover,
                         metrics=metrics, **breaker_kw)
        # runners are built LAZILY per replica: constructing one performs a
        # blocking Status RPC, and a replica that is down at construction
        # (rolling restart) must count as a failed submission on that
        # replica — not poison the whole set
        self._runners: List[Optional[object]] = [None] * len(self._managers)
        # per-replica creation locks: first contact is a blocking Status
        # RPC, which must neither run twice per replica nor serialize
        # against _pick/_submit bookkeeping on the shared lock
        self._runner_locks = [threading.Lock() for _ in self._managers]

    def _on_add_replica_locked(self, idx: int, manager) -> None:
        self._runners.append(None)  # built lazily on first pick
        self._runner_locks.append(threading.Lock())

    def _runner(self, idx: int, timeout: Optional[float] = None):
        """The replica's runner, built on first use (raises if the replica
        is unreachable — the caller treats that as a failed submission).
        ``timeout`` bounds the first-contact Status RPC so a black-holed
        replica cannot eat more than one attempt's budget."""
        with self._runner_locks[idx]:
            r = self._runners[idx]
            if r is None:
                r = self._managers[idx].infer_runner(self.model_name,
                                                     timeout=timeout)
                self._runners[idx] = r
            return r

    def infer(self, deadline_s: Optional[float] = None, **arrays) -> Future:
        """Future of the outputs dict; rides the least-loaded replica and
        fails over (re-submits) when a replica errors mid-flight.

        ``deadline_s`` bounds the request END TO END: each attempt gets an
        even split of the remaining budget as its gRPC deadline
        (``Deadline.per_attempt``), so a black-holed replica cannot eat
        the whole budget, and expiry fails the future with
        :class:`DeadlineExceeded` instead of retrying.  A model input
        literally named ``deadline_s`` still works: an ndarray value is
        rebound as an input array."""
        import numpy as _np
        if isinstance(deadline_s, _np.ndarray):
            arrays["deadline_s"] = deadline_s
            deadline_s = None
        outer: Future = Future()
        # one trace id per LOGICAL request (attempts share it: failover
        # replays line up under one id in the merged timeline)
        self._submit(outer, arrays, attempts_left=self._max_failover,
                     exclude=frozenset(), deadline=Deadline.after(deadline_s),
                     trace_id=mint_trace_id())
        return outer

    def _deadline_failed(self, outer: Future, deadline: Deadline) -> None:
        self._note_deadline(False, deadline)
        if not outer.done():
            outer.set_exception(
                DeadlineExceeded("inference deadline exceeded"))

    def _submit(self, outer: Future, arrays: dict, attempts_left: int,
                exclude: frozenset, deadline: Deadline,
                trace_id: Optional[str] = None,
                overload_round: int = 0) -> None:
        if deadline.expired():
            self._deadline_failed(outer, deadline)
            return
        idx = self._pick_or_any(exclude)
        if idx is None:  # unreachable: >=1 replica by construction
            outer.set_exception(RuntimeError("no replicas"))
            return
        attempt = self._max_failover - attempts_left
        t_att = time.perf_counter()

        def on_done(fut: Future) -> None:
            with self._lock:
                self._inflight[idx] -= 1
                self._note_inflight(idx)
            exc = fut.exception()
            self._note_attempt(exc)
            self._attempt_span(t_att, idx, attempt, trace_id, exc)
            if exc is None:
                self._record_success(idx)
                with self._lock:
                    self.served[idx] += 1
                self._note_served(idx)
                self._note_deadline(True, deadline)
                if not outer.done():
                    outer.set_result(fut.result())
                return
            from tpulab_torch.rpc.infer_service import ResourceExhausted
            overloaded = isinstance(exc, ResourceExhausted)
            if overloaded:
                # overload is not a dead replica: back off, don't eject
                self._record_overload(idx, exc.retry_after_ms)
            else:
                self._record_failure(idx)
            if deadline.expired():
                self._deadline_failed(outer, deadline)
            elif attempts_left > 1 and not outer.done():
                self._note_failover()
                self._submit(outer, arrays, attempts_left - 1,
                             exclude | {idx}, deadline, trace_id,
                             overload_round)
            elif (overloaded and overload_round < self._overload_retries
                    and not outer.done()):
                # every replica fast-failed overloaded: honor the server's
                # retry-after hint (jittered) once per round, then
                # re-spread across the whole set
                delay = self._overload_wait_s(exc.retry_after_ms,
                                              overload_round, deadline)
                if delay is None:  # deadline cannot afford the wait
                    outer.set_exception(exc)
                    return
                timer = threading.Timer(
                    delay, self._submit,
                    args=(outer, arrays, self._max_failover, frozenset(),
                          deadline, trace_id, overload_round + 1))
                timer.daemon = True
                timer.start()
            elif not outer.done():
                outer.set_exception(exc)

        try:
            budget = deadline.per_attempt(attempts_left)
            self._runner(idx, timeout=budget).infer(
                timeout=budget, trace_id=trace_id,
                **arrays).add_done_callback(on_done)
        except Exception as e:  # submission itself failed (dead channel
            #                     or unreachable at first contact)
            with self._lock:
                self._inflight[idx] -= 1
                self._note_inflight(idx)
            self._note_attempt(e)
            self._attempt_span(t_att, idx, attempt, trace_id, e)
            self._record_failure(idx)
            if attempts_left > 1 and not deadline.expired():
                self._note_failover()
                self._submit(outer, arrays, attempts_left - 1,
                             exclude | {idx}, deadline, trace_id,
                             overload_round)
            else:
                outer.set_exception(e)


class GenerationReplicaSet(_BaseReplicaSet):
    """Least-loaded routing + exactly-once replay failover for
    token-streaming generation (module docstring: determinism contract).

    ``prefix_affinity=True`` adds prefix-cache-aware routing
    (tpulab_torch.fleet.router, docs/SERVING.md "Fleet routing &
    autoscaling"): requests whose prompts share their first
    ``affinity_tokens`` tokens rendezvous-hash (HRW) to the same home
    replica, so a replica's ref-counted prefix cache (engine/paged.py
    PrefixCache) keeps serving the prompts it has already prefilled —
    the cross-replica analog of the in-engine cache, stable under
    membership changes (an autoscaler join/retire re-homes only ~1/N of
    prefixes).  Affinity is a PREFERENCE, not a pin: the winner is
    SPILLED to the next hash rank when its load gauges say it is hot
    (local inflight beyond ``affinity_slack`` over the least-loaded ring
    member, reported queue depth at ``spill_queue_depth``, free HBM
    under ``min_free_hbm_bytes``), and breaker-open/draining/retired
    replicas are excluded from the ring — cache warmth must never become
    a hotspot or a single point of failure.  Hedged first tokens hedge
    onto the affinity SECOND rank and the disagg decode handoff ranks
    within the decode role, so neither interaction defeats affinity.

    ``disaggregate=True`` adds role-aware prefill/decode routing
    (tpulab_torch.disagg, docs/SERVING.md "Replica roles"): greedy and
    device-sampled requests prefill on a prefill-role replica, whose
    finished KV ships over the host tier's wire form to a decode-role
    replica picked by the same load gauges; every hole in the path
    degrades to the unified routing with exactly-once delivery.

    Durable streams (docs/ROBUSTNESS.md "Stream failover semantics"):

    - **Resume-from-delivered failover** (``resume_failover=True``, the
      default): a mid-stream replica death resubmits
      ``prompt + delivered_tokens`` with ``resume_length=len(delivered)``
      — the surviving replica pays ONE chunked prefill instead of
      re-decoding the delivered prefix token by token, and emits from
      index ``resume_length``.  Bit-exact for greedy AND device-sampled
      streams (both key their sampling by (seed, position)); host-sampled
      requests are rejected server-side and the client degrades to
      today's full replay (delivered tokens re-received and skipped).
    - **Stall watchdog** (``ttft_timeout_s`` / ``inter_token_timeout_s``,
      per-call overridable): a replica that stops emitting — as opposed
      to dying — fails over within the inter-token bound instead of the
      coarse per-activity ``timeout``, counted as the distinct
      ``stalled`` evidence class feeding the circuit breaker.
    - **Hedged first token** (``hedge_delay_s``, default off): when the
      primary attempt produces no first token within the hedge delay,
      ONE duplicate attempt launches on another replica; first writer
      wins and the loser is cancelled through the existing cancel path.
      Never for host-sampled requests, and skipped while any replica is
      in overload backoff (a hedge must not amplify an overload)."""

    def __init__(self, addresses: Sequence[str], model_name: str,
                 channels: int = 1, max_failover: Optional[int] = None,
                 prefix_affinity: bool = False, affinity_tokens: int = 32,
                 affinity_slack: int = 2,
                 spill_queue_depth: Optional[int] = None,
                 min_free_hbm_bytes: int = 0, router=None, metrics=None,
                 disaggregate: bool = False,
                 resume_failover: bool = True,
                 ttft_timeout_s: Optional[float] = None,
                 inter_token_timeout_s: Optional[float] = None,
                 hedge_delay_s: Optional[float] = None, **breaker_kw):
        super().__init__(addresses, model_name, channels, max_failover,
                         metrics=metrics, **breaker_kw)
        self._clients = [GenerateStreamClient(m, model_name)
                        for m in self._managers]
        self.prefix_affinity = prefix_affinity
        # affinity_tokens / affinity_slack live on the router (properties
        # below proxy them); constructed at the end of __init__
        #: resubmit failovers as resume-from-delivered when the sampling
        #: stream survives the hop (False = always full replay)
        self.resume_failover = resume_failover
        #: stall watchdog defaults (None = fall back to the per-activity
        #: ``timeout``); per-call kwargs override
        self.ttft_timeout_s = ttft_timeout_s
        self.inter_token_timeout_s = inter_token_timeout_s
        #: hedge delay for the duplicate first-token attempt (None = off)
        self.hedge_delay_s = hedge_delay_s
        #: durable-stream counters (observability / test assertions)
        self.stalls = 0            # watchdog-detected stalled streams
        self.resumes = 0           # failover attempts resubmitted as resume
        self.resume_fallbacks = 0  # server-rejected resumes -> full replay
        self.tokens_replayed = 0   # delivered tokens re-received + skipped
        self.hedges = 0            # duplicate first-token attempts launched
        self.hedge_wins = 0        # hedges whose duplicate won the race
        #: role-aware disaggregated routing (docs/SERVING.md "Replica
        #: roles"): new requests go to a prefill-role replica first, the
        #: finished prefill's KV shipment is handed to a decode-role
        #: replica picked by the existing admission load gauges.  Any
        #: hole in the path (no roles visible, host-sampled request,
        #: logprobs, failure at either hop) falls back to the unified
        #: routing below — exactly-once token delivery either way.
        self.disaggregate = disaggregate
        #: shipped handoffs that streamed from a decode replica (tests)
        self.disagg_handoffs = 0
        #: requests that degraded to unified routing (tests)
        self.disagg_fallbacks = 0
        #: the fleet routing policy (tpulab_torch.fleet.PrefixAffinityRouter):
        #: rendezvous ranking + spill thresholds + hit/spill/ring-move
        #: counters.  Constructed even with prefix_affinity=False so a
        #: later autoscaler attach finds the membership accounting live.
        from tpulab_torch.fleet.router import PrefixAffinityRouter
        self.router = (router if router is not None
                       else PrefixAffinityRouter(
                           affinity_tokens=affinity_tokens,
                           inflight_slack=affinity_slack,
                           spill_queue_depth=spill_queue_depth,
                           min_free_hbm_bytes=min_free_hbm_bytes,
                           metrics=metrics))

    def _on_add_replica_locked(self, idx: int, manager) -> None:
        self._clients.append(GenerateStreamClient(manager, self.model_name))

    @property
    def affinity_tokens(self) -> int:
        return self.router.affinity_tokens

    @affinity_tokens.setter
    def affinity_tokens(self, n: int) -> None:
        self.router.affinity_tokens = int(n)

    @property
    def affinity_slack(self) -> int:
        return self.router.inflight_slack

    @affinity_slack.setter
    def affinity_slack(self, n: int) -> None:
        self.router.inflight_slack = int(n)

    def _ring_locked(self) -> List[int]:
        """Affinity-ring membership: active (not draining, not retired)
        and not breaker-open — a sick or leaving replica must not be a
        prefix home.  CALLER HOLDS self._lock."""
        return [i for i in self._active_locked() if i not in self._open]

    def _preferred(self, prompt) -> int:
        """Stable rendezvous home for a prompt (same first
        ``affinity_tokens`` tokens -> same replica; a membership change
        re-homes only ~1/N of digests — tpulab_torch.fleet.router)."""
        from tpulab_torch.fleet.router import prefix_digest
        digest = prefix_digest(prompt, self.affinity_tokens)
        with self._lock:
            addr_of = {self.addresses[i]: i for i in self._ring_locked()}
        if not addr_of:
            return 0
        return addr_of[self.router.ranked(digest, addr_of)[0]]

    def _pick_affine(self, prompt, exclude: frozenset,
                     allowed: Optional[frozenset] = None) -> Optional[int]:
        """The affinity pick: rendezvous-rank the ring for the prompt's
        prefix digest (tpulab_torch.fleet.PrefixAffinityRouter) and take the
        highest rank that is neither excluded nor spilled for load —
        the winner is skipped when its gauges (local inflight, reported
        queue depth, free HBM) say it is hot, so a hot prefix warms a
        stable second replica instead of hot-spotting its home.  An
        empty/exhausted ring degrades to the shared load-based pick
        (mirroring _pick_or_any's retry-anyone fallback), so affinity
        can delay a request's best placement but never strand it.

        The ``fleet.route`` chaos trip sits at the head: ``error`` fails
        this routing decision, ``drop`` disables affinity for the
        request — both degrade to the load-based pick.

        ``allowed`` restricts candidates to a role subset (disagg
        decode-side affinity); restricted picks return None when the
        subset is unroutable (the caller owns the role fallback) and do
        not touch the global ring-membership accounting."""
        from tpulab_torch import chaos
        from tpulab_torch.fleet.router import prefix_digest

        def load_pick() -> Optional[int]:
            if allowed is None:
                return self._pick_or_any(exclude)
            blocked = frozenset(range(len(self._managers))) - allowed
            return self._pick(exclude | blocked)

        try:
            if chaos.trip("fleet.route") == "drop":
                return load_pick()  # affinity disabled for this request
        except chaos.ChaosError:
            return load_pick()      # routing decision failed: load-based
        digest = prefix_digest(prompt, self.affinity_tokens)
        ranked: List[int] = []
        spilled = False
        with self._lock:
            ring = [i for i in self._ring_locked()
                    if allowed is None or i in allowed]
            if allowed is None:
                # global-ring membership accounting (ring_moves); role
                # subsets are views, not membership changes
                self.router.note_membership(
                    self.addresses[i] for i in ring)
            idx = None
            if ring:
                addr_of = {self.addresses[i]: i for i in ring}
                ranked = [addr_of[a] for a in
                          self.router.ranked(digest, addr_of)]
                eligible = [i for i in ranked if i not in exclude]
                if eligible:
                    lo = min(self._inflight[i] for i in eligible)
                    for i in eligible:
                        if self.router.should_spill(
                                self._inflight[i], lo,
                                self._load_hint[i], self._hbm_hint[i]):
                            if i == ranked[0]:
                                spilled = True
                            continue
                        idx = i
                        break
            if idx is not None:
                self._inflight[idx] += 1
                self._note_inflight(idx)
        if idx is None:
            # ring empty, every member excluded, or everything spilled:
            # the shared load-based policy finishes the job
            return load_pick()
        self.router.note_routed(digest, self.addresses[idx],
                                self.addresses[ranked[0]], spilled)
        return idx

    def _hedge_pick(self, prompt, exclude: frozenset) -> Optional[int]:
        """The hedge's replica: with affinity on, the highest-ranked
        ring member that is not the primary — the affinity SECOND rank,
        never a random spare, so the duplicate lands where the prefix
        would live next (spill rules don't apply: a hedge is rescue
        traffic).  Without affinity, the plain load pick.  Either way
        there is NO retry-anyone fallback — a duplicate that re-lands on
        the primary's replica is not a hedge (see _hedge_eligible)."""
        if self.prefix_affinity:
            from tpulab_torch.fleet.router import prefix_digest
            digest = prefix_digest(prompt, self.affinity_tokens)
            with self._lock:
                ring = [i for i in self._ring_locked()
                        if i not in exclude]
                if not ring:
                    return None
                addr_of = {self.addresses[i]: i for i in ring}
                idx = addr_of[self.router.ranked(digest, addr_of)[0]]
                self._inflight[idx] += 1
                self._note_inflight(idx)
                return idx
        return self._pick(exclude)

    def generate(self, prompt, steps: int, timeout: float = 300.0,
                 deadline_s: Optional[float] = None, **kw):
        """Token iterator with transparent failover.

        Sampling without an explicit seed gets a client-side one so a
        replayed request reproduces the identical token sequence on any
        replica; tokens already delivered are skipped on replay, so the
        consumer sees each position exactly once.

        ``deadline_s`` bounds the stream END TO END: every (re)attempt
        carries the remaining budget to the server (the engine cancels
        before its next token step) and expiry raises
        :class:`DeadlineExceeded` — never failed over, the budget is
        global.  ``timeout`` stays the per-activity stall bound.

        ``trace_id`` (optional) joins this request to an existing trace;
        by default one is minted per request — all failover attempts and
        the server-side spans they produce share it (utils.tracing).

        ``ttft_timeout`` / ``inter_token_timeout`` (optional; default to
        the set-level ``ttft_timeout_s`` / ``inter_token_timeout_s``,
        else ``timeout``) are the stall watchdog's split bounds: a stream
        with no first token / no next token inside its bound fails over
        (with resume) instead of waiting out the activity ``timeout``.
        """
        import numpy as np
        if kw.get("temperature", 0.0) and kw.get("seed") is None:
            import secrets
            kw["seed"] = secrets.randbits(63)
        if deadline_s is not None:
            kw["deadline_s"] = deadline_s
        if self.ttft_timeout_s is not None:
            kw.setdefault("ttft_timeout", self.ttft_timeout_s)
        if self.inter_token_timeout_s is not None:
            kw.setdefault("inter_token_timeout", self.inter_token_timeout_s)
        prompt = list(np.asarray(prompt, np.int32))
        if (self.disaggregate and not kw.get("return_logprobs")
                and (not kw.get("temperature")
                     or kw.get("device_sampling"))):
            # greedy/device-sampled streams are (seed, position)-keyed and
            # survive the replica hop; host-sampled + logprob requests
            # stay on the unified path
            return self._generate_disagg(prompt, steps, timeout, kw)
        if self._hedge_eligible(kw):
            return self._generate_hedged(prompt, steps, timeout, kw)
        return self._generate_iter(prompt, steps, timeout, kw)

    # -- durable-stream bookkeeping (counters + optional metrics) -----------
    def _stream_survives_hop(self, kw: dict) -> bool:
        """Greedy and device-sampled streams are keyed by (seed,
        position) and continue bit-exact on another replica; host-sampled
        streams are keyed by PRNG draw order and do not survive."""
        return not kw.get("temperature", 0.0) or bool(
            kw.get("device_sampling"))

    def _note_stall(self) -> None:
        self.stalls += 1
        m = self._metrics
        if m is not None and hasattr(m, "note_stall"):
            m.note_stall()

    def _note_resume(self) -> None:
        self.resumes += 1
        m = self._metrics
        if m is not None and hasattr(m, "note_resume"):
            m.note_resume()

    def _note_resume_fallback(self) -> None:
        self.resume_fallbacks += 1
        m = self._metrics
        if m is not None and hasattr(m, "note_resume_fallback"):
            m.note_resume_fallback()

    def _note_replayed(self, n: int) -> None:
        self.tokens_replayed += n
        m = self._metrics
        if n > 0 and m is not None and hasattr(m, "note_tokens_replayed"):
            m.note_tokens_replayed(n)

    def _dispose_failure(self, idx: int, exc: BaseException) -> str:
        """Shared attempt-failure bookkeeping for the hedged path:
        records overload/stall/fault evidence and says whether failover
        may follow (``"failover"``) or the error is terminal
        (``"raise"``)."""
        from tpulab_torch.rpc.infer_service import (GenerationRejected,
                                              ResourceExhausted,
                                              StreamStalled)
        if isinstance(exc, DeadlineExceeded):
            return "raise"  # global budget: no replica can beat it
        if isinstance(exc, ResourceExhausted):
            self._record_overload(idx, exc.retry_after_ms)
            return "failover"
        if isinstance(exc, GenerationRejected) and not exc.retryable:
            self._record_success(idx)  # deterministic rejection: the
            return "raise"             # replica itself is fine
        if isinstance(exc, StreamStalled):
            self._note_stall()
        self._record_failure(idx)
        return "failover"

    def _hedge_eligible(self, kw: dict) -> bool:
        """Hedge only when it cannot hurt: never host-sampled (the
        duplicate's PRNG stream would not be the same request), never
        without a DISTINCT routable second replica, and never while ANY
        routable replica is in overload backoff — a hedge under overload
        is the amplification admission control exists to prevent.

        Routing state counts, not raw set size: draining and retired
        members cannot take a duplicate, so a fleet scaled down to one
        active replica must not hedge — the old ``len(managers) < 2``
        check would launch a duplicate that could only re-land on the
        primary's own replica."""
        if self.hedge_delay_s is None:
            return False
        if not self._stream_survives_hop(kw):
            return False
        now = time.monotonic()
        with self._lock:
            active = self._active_locked()
            if len(active) < 2:
                return False
            return not any(self._backoff_until[i] > now for i in active)

    def _generate_iter(self, prompt, steps, timeout, kw,
                       already_delivered: int = 0,
                       delivered_tokens: Optional[list] = None):
        deadline = Deadline.after(kw.pop("deadline_s", None))
        delivered = already_delivered
        pairs = bool(kw.get("return_logprobs"))
        #: delivered token VALUES — what a resume attempt appends to the
        #: prompt.  A caller-provided count without the values (legacy
        #: shape) pins the request to full replay.
        toks: list = [int(t) for t in (delivered_tokens or [])]
        resume_ok = (self.resume_failover and len(toks) == delivered
                     and self._stream_survives_hop(kw))
        attempts_left = self._max_failover
        exclude: set = set()
        # one trace id for the logical request: every replay attempt (and
        # the server spans it produces) shares it in the merged timeline
        trace_id = kw.pop("trace_id", None) or mint_trace_id()
        attempt = 0
        overload_round = 0
        while True:
            if deadline.expired():
                self._note_deadline(False, deadline)
                raise DeadlineExceeded("generation deadline exceeded")
            if self.prefix_affinity:
                idx = self._pick_affine(prompt, frozenset(exclude))
            else:
                idx = self._pick_or_any(frozenset(exclude))
            if idx is None:
                raise RuntimeError("no replicas")
            gen = None
            t_att = time.perf_counter()
            # resume-from-delivered (docs/ROBUSTNESS.md "Stream failover
            # semantics"): resubmit prompt+delivered so the replica pays
            # one chunked prefill instead of re-decoding the delivered
            # prefix; the emitted stream starts at index `delivered`.
            use_resume = resume_ok and 0 < delivered < steps
            span_extra = ({"resumed_from": delivered,
                           "mode": "resume" if use_resume else "replay"}
                          if delivered or attempt else {})
            try:
                akw = dict(kw)
                rem = deadline.remaining()
                if rem is not None:
                    akw["deadline_s"] = rem  # per-attempt = what's left
                a_prompt = prompt
                if use_resume:
                    a_prompt = list(prompt) + toks
                    akw["resume_length"] = delivered
                    self._note_resume()
                gen = self._clients[idx].generate(
                    a_prompt, steps, timeout=deadline.bound(timeout),
                    trace_id=trace_id, **akw)
                i = delivered if use_resume else 0
                for item in gen:
                    if i >= delivered:  # replay skips what the consumer has
                        delivered += 1
                        toks.append(int(item[0]) if pairs else int(item))
                        yield item
                    else:
                        # full-replay waste: a re-decoded, re-shipped token
                        # the consumer already has
                        self._note_replayed(1)
                    i += 1
                with self._lock:
                    self.served[idx] += 1
                self._record_success(idx)
                self._note_served(idx)
                self._note_attempt(None)
                self._attempt_span(t_att, idx, attempt, trace_id, None,
                                   **span_extra)
                self._note_deadline(True, deadline)
                return
            except Exception as e:
                self._note_attempt(e)
                self._attempt_span(t_att, idx, attempt, trace_id, e,
                                   **span_extra)
                from tpulab_torch.rpc.infer_service import (GenerationRejected,
                                                      ResourceExhausted,
                                                      StreamStalled)
                if isinstance(e, ResourceExhausted):
                    # admission fast-fail: overload is not a dead replica
                    # (no breaker streak) — back this replica off and
                    # route away; once EVERY replica is overloaded, honor
                    # the server's retry-after hint (jittered) and
                    # re-spread, up to ``overload_retries`` rounds
                    self._record_overload(idx, e.retry_after_ms)
                    exclude.add(idx)
                    attempt += 1
                    if len(exclude) < len(self._managers):
                        self._note_failover()
                        continue
                    if overload_round >= self._overload_retries:
                        raise
                    delay = self._overload_wait_s(e.retry_after_ms,
                                                  overload_round, deadline)
                    if delay is None:
                        raise  # deadline cannot afford the backoff
                    overload_round += 1
                    time.sleep(delay)
                    exclude.clear()
                    continue
                if isinstance(e, GenerationRejected) and not e.retryable:
                    if use_resume and i == delivered:
                        # the server refused the RESUME FORM before any
                        # token (validation: e.g. a host-sampled request
                        # reaching an eligibility hole, or a pre-resume
                        # server) — the replica is fine; degrade this
                        # request to full replay, exactly-once preserved
                        self._record_success(idx)
                        self._note_resume_fallback()
                        resume_ok = False
                        attempt += 1
                        continue
                    # the server processed and rejected the request —
                    # identical on every replica, don't burn them all
                    # (and don't trip the breaker: the replica is fine)
                    self._record_success(idx)
                    raise
                if isinstance(e, DeadlineExceeded):
                    self._note_deadline(False, deadline)
                    raise  # global budget spent: no replica can beat it
                if isinstance(e, StreamStalled):
                    # the watchdog's distinct evidence class: a stalled —
                    # not dead — replica, caught at the TTFT/inter-token
                    # bound; still breaker evidence and still failed over
                    self._note_stall()
                self._record_failure(idx)
                attempts_left -= 1
                exclude.add(idx)
                attempt += 1
                if attempts_left <= 0:
                    raise
                self._note_failover()
            finally:
                with self._lock:
                    self._inflight[idx] -= 1
                    self._note_inflight(idx)
                if gen is not None:
                    gen.close()  # abandoned inner stream cancels promptly

    # -- hedged first token (docs/ROBUSTNESS.md) -----------------------------
    def _generate_hedged(self, prompt, steps, timeout, kw):
        """First-token hedging: launch the primary attempt; if it shows
        no first token within ``hedge_delay_s``, launch ONE duplicate on
        another replica.  First writer wins, the loser is cancelled
        through the existing cancel path (``_cancel_evt`` -> client
        ``stream.cancel()`` -> the server frees the lane), and a winner
        that later faults falls back to the ordinary failover loop with
        resume — exactly-once token delivery throughout."""
        import queue as _q
        deadline = Deadline.after(kw.pop("deadline_s", None))
        trace_id = kw.pop("trace_id", None) or mint_trace_id()
        pairs = bool(kw.get("return_logprobs"))
        events: "_q.Queue" = _q.Queue()

        class _Attempt:
            __slots__ = ("idx", "no", "cancel", "t0")

            def __init__(self, idx, no):
                self.idx = idx
                self.no = no
                self.cancel = threading.Event()
                self.t0 = time.perf_counter()

        def run(att: "_Attempt") -> None:
            gen = None
            try:
                akw = dict(kw)
                rem = deadline.remaining()
                if rem is not None:
                    akw["deadline_s"] = rem
                gen = self._clients[att.idx].generate(
                    prompt, steps, timeout=deadline.bound(timeout),
                    trace_id=trace_id, _cancel_evt=att.cancel, **akw)
                for item in gen:
                    events.put(("tok", att, item))
                events.put(("cancelled" if att.cancel.is_set() else "end",
                            att, None))
            except Exception as e:  # noqa: BLE001 - classified by consumer
                events.put(("err", att, e))
            finally:
                if gen is not None:
                    gen.close()
                with self._lock:
                    self._inflight[att.idx] -= 1
                    self._note_inflight(att.idx)

        def launch(no: int, exclude: set) -> Optional["_Attempt"]:
            if no == 0:
                # the primary rides the same affinity policy as ordinary
                # streams — a hedged request must not defeat cache warmth
                idx = (self._pick_affine(prompt, frozenset(exclude))
                       if self.prefix_affinity
                       else self._pick_or_any(frozenset(exclude)))
            else:
                # the duplicate: affinity second rank / strict load pick,
                # never the retry-anyone fallback (a hedge that re-lands
                # on the primary's replica is not a hedge) — None skips
                # the hedge and the primary keeps its watchdog/failover
                idx = self._hedge_pick(prompt, frozenset(exclude))
            if idx is None:
                return None
            att = _Attempt(idx, no)
            threading.Thread(target=run, args=(att,), daemon=True,
                             name=f"gen-hedge-{no}").start()
            return att

        def unified_fallback(delivered, toks):
            fkw = dict(kw, trace_id=trace_id)
            rem = deadline.remaining()
            if rem is not None:
                fkw["deadline_s"] = rem
            return self._generate_iter(list(prompt), steps, timeout, fkw,
                                       already_delivered=delivered,
                                       delivered_tokens=toks)

        primary = launch(0, set())
        if primary is None:
            raise RuntimeError("no replicas")
        live = [primary]
        failed: set = set()
        hedged = False
        winner = first = None
        try:
            # -- the race: first token wins; one hedge at hedge_delay_s --
            while winner is None:
                wait = deadline.bound(
                    None if hedged else self.hedge_delay_s)
                try:
                    kind, att, val = events.get(timeout=wait)
                except _q.Empty:
                    if deadline.expired():
                        self._note_deadline(False, deadline)
                        raise DeadlineExceeded(
                            "generation deadline exceeded")
                    if not hedged:
                        hedged = True
                        h = launch(1, {a.idx for a in live} | failed)
                        if h is not None:
                            self.hedges += 1
                            m = self._metrics
                            if m is not None and hasattr(m, "note_hedge"):
                                m.note_hedge()
                            live.append(h)
                    continue
                if kind == "tok":
                    winner, first = att, val
                elif kind == "cancelled":
                    live.remove(att)
                else:  # "err", or "end" with zero tokens (a dead stream)
                    live.remove(att)
                    failed.add(att.idx)
                    exc = (val if kind == "err" else RuntimeError(
                        "stream ended before the first token"))
                    self._note_attempt(exc)
                    self._attempt_span(att.t0, att.idx, att.no, trace_id,
                                       exc, hedge=att.no)
                    if isinstance(exc, DeadlineExceeded):
                        self._note_deadline(False, deadline)
                    if self._dispose_failure(att.idx, exc) == "raise":
                        raise exc
                    if not live:
                        # both arms dead pre-first-token: hand the whole
                        # request to the ordinary failover loop
                        self._note_failover()
                        yield from unified_fallback(0, [])
                        return
            # -- first-writer-wins: cancel the losers ---------------------
            for a in live:
                if a is not winner:
                    a.cancel.set()
            if winner.no > 0:
                self.hedge_wins += 1
                m = self._metrics
                if m is not None and hasattr(m, "note_hedge"):
                    m.note_hedge(won=True)
            delivered = 1
            toks = [int(first[0]) if pairs else int(first)]
            yield first
            # -- drain the winner -----------------------------------------
            while True:
                try:
                    kind, att, val = events.get(
                        timeout=deadline.bound(None))
                except _q.Empty:
                    self._note_deadline(False, deadline)
                    raise DeadlineExceeded("generation deadline exceeded")
                if att is not winner:
                    continue  # late loser events: already cancelled
                if kind == "tok":
                    delivered += 1
                    toks.append(int(val[0]) if pairs else int(val))
                    yield val
                    continue
                if kind == "end":
                    with self._lock:
                        self.served[winner.idx] += 1
                    self._record_success(winner.idx)
                    self._note_served(winner.idx)
                    self._note_attempt(None)
                    self._attempt_span(winner.t0, winner.idx, winner.no,
                                       trace_id, None, hedge=winner.no)
                    self._note_deadline(True, deadline)
                    return
                exc = (val if kind == "err" else RuntimeError(
                    "generation stream cancelled"))
                self._note_attempt(exc)
                self._attempt_span(winner.t0, winner.idx, winner.no,
                                   trace_id, exc, hedge=winner.no)
                if isinstance(exc, DeadlineExceeded):
                    self._note_deadline(False, deadline)
                if self._dispose_failure(winner.idx, exc) == "raise":
                    raise exc
                # the winner died mid-stream: ordinary failover (resume
                # when the stream survives the hop) finishes the request
                self._note_failover()
                yield from unified_fallback(delivered, toks)
                return
        finally:
            for a in live:
                a.cancel.set()  # consumer gone / error: reap every arm

    # -- disaggregated routing (tpulab_torch.disagg) -------------------------------
    def _known_roles(self) -> List[str]:
        """Per-replica role hints, polling the Status RPC once if none
        have been heard yet (the common first-request case)."""
        with self._lock:
            roles = list(self._role_hint)
        if not any(roles):
            try:
                self.poll_load()
            except Exception:  # noqa: BLE001 - routing must not die here
                pass
            with self._lock:
                roles = list(self._role_hint)
        return roles

    def _generate_disagg(self, prompt, steps, timeout, kw):
        """Role-aware two-hop routing: prefill on a prefill-role replica
        (first token + KV shipment back), decode on a decode-role
        replica admitting the shipment — picked least-loaded within its
        role by the same selection algorithm (inflight + the Status-RPC
        load gauges).  Every hole degrades to the unified path with
        exactly-once delivery: tokens already yielded are skipped on the
        fallback replay, and a lost/unusable shipment simply means the
        decode replica prefills locally (server-side degradation)."""
        kw = dict(kw)
        deadline = Deadline.after(kw.pop("deadline_s", None))
        trace_id = kw.pop("trace_id", None) or mint_trace_id()
        stops = {int(t) for t in kw.get("stop_tokens", ())}

        def fallback(delivered, toks=None):
            fkw = dict(kw, trace_id=trace_id)
            rem = deadline.remaining()
            if rem is not None:
                fkw["deadline_s"] = rem
            self.disagg_fallbacks += 1
            # delivered token VALUES ride along so the unified fallback
            # can RESUME (one prefill) instead of full-replaying the hops
            return self._generate_iter(list(prompt), steps, timeout, fkw,
                                       already_delivered=delivered,
                                       delivered_tokens=toks)

        roles = self._known_roles()
        prefills = {i for i, r in enumerate(roles) if r == "prefill"}
        decodes = {i for i, r in enumerate(roles) if r == "decode"}
        if not prefills or not decodes:
            yield from fallback(0)
            return
        # -- hop 1: prefill + export.  With affinity on, the prefill-side
        # pick rendezvous-ranks WITHIN the prefill role — the same
        # treatment decode handoffs already get — so a returning
        # prefix's prompt KV (prefix-cache pages, host-tier demotions)
        # stays warm on ONE prefill replica instead of scattering; a
        # load-only pick would pay a cold prefill per replica before
        # the prefill side of the fleet warms (ROADMAP item 1
        # follow-up (b))
        first = blob = None
        idx = (self._pick_affine(prompt, frozenset(),
                                 allowed=frozenset(prefills))
               if self.prefix_affinity
               else self._pick(frozenset(range(len(self._managers)))
                               - prefills))
        if idx is not None:
            t_att = time.perf_counter()
            try:
                pkw = {k: kw[k] for k in ("temperature", "seed",
                                          "device_sampling", "tenant_id",
                                          "priority") if k in kw}
                rem = deadline.remaining()
                if rem is not None:
                    pkw["deadline_s"] = rem
                first, blob = self._clients[idx].prefill_export(
                    prompt, timeout=deadline.bound(timeout),
                    trace_id=trace_id, **pkw)
                with self._lock:
                    self.served[idx] += 1
                self._record_success(idx)
                self._note_served(idx)
                self._note_attempt(None)
                self._attempt_span(t_att, idx, 0, trace_id, None)
            except Exception as e:  # noqa: BLE001 - any prefill-hop fault
                #                      degrades to unified routing below
                self._note_attempt(e)
                self._attempt_span(t_att, idx, 0, trace_id, e)
                if isinstance(e, DeadlineExceeded):
                    self._note_deadline(False, deadline)
                    raise  # finally below releases the inflight slot
                from tpulab_torch.rpc.infer_service import ResourceExhausted
                if isinstance(e, ResourceExhausted):
                    self._record_overload(idx, e.retry_after_ms)
                else:
                    self._record_failure(idx)
                first, blob = None, None
            finally:
                with self._lock:
                    self._inflight[idx] -= 1
                    self._note_inflight(idx)
        if first is None:
            yield from fallback(0)
            return
        yield first
        delivered = 1
        toks = [int(first)]
        if steps <= 1 or int(first) in stops:
            self.disagg_handoffs += 1  # one-token request: prefill WAS it
            return
        # -- hop 2: shipped-KV decode.  With affinity on, the decode-side
        # pick rendezvous-ranks WITHIN the decode role so this prefix's
        # shipped KV keeps landing on the same decode replica — its host
        # tier already holds the ("ship", digest) entries from earlier
        # requests; a random decode pick would scatter them fleet-wide
        didx = (self._pick_affine(prompt, frozenset(),
                                  allowed=frozenset(decodes))
                if self.prefix_affinity
                else self._pick(frozenset(range(len(self._managers)))
                                - decodes))
        if didx is None:
            yield from fallback(delivered, toks)
            return
        gen = None
        t_att = time.perf_counter()
        try:
            dkw = dict(kw)
            rem = deadline.remaining()
            if rem is not None:
                dkw["deadline_s"] = rem
            gen = self._clients[didx].generate(
                prompt, steps, timeout=deadline.bound(timeout),
                trace_id=trace_id, kv_shipment=blob, **dkw)
            i = 0
            for item in gen:
                if i >= delivered:  # index 0 was delivered from hop 1
                    delivered += 1
                    toks.append(int(item))
                    yield item
                i += 1
            with self._lock:
                self.served[didx] += 1
            self._record_success(didx)
            self._note_served(didx)
            self._note_attempt(None)
            self._attempt_span(t_att, didx, 1, trace_id, None)
            self._note_deadline(True, deadline)
            self.disagg_handoffs += 1
            return
        except Exception as e:  # noqa: BLE001
            self._note_attempt(e)
            self._attempt_span(t_att, didx, 1, trace_id, e)
            from tpulab_torch.rpc.infer_service import (GenerationRejected,
                                                  ResourceExhausted)
            if isinstance(e, DeadlineExceeded):
                self._note_deadline(False, deadline)
                raise
            if isinstance(e, GenerationRejected) and not e.retryable:
                self._record_success(didx)  # deterministic rejection
                raise
            if isinstance(e, ResourceExhausted):
                self._record_overload(didx, e.retry_after_ms)
            else:
                self._record_failure(didx)
            # fall through to the unified replay below (skips delivered)
        finally:
            with self._lock:
                self._inflight[didx] -= 1
                self._note_inflight(didx)
            if gen is not None:
                gen.close()
        yield from fallback(delivered, toks)


def benchmark_failover_recovery(prompt_len: int = 24, steps: int = 24,
                                kill_at: int = 8, device=None) -> dict:
    """bench.py ``failover_recovery`` row (docs/ROBUSTNESS.md "Stream
    failover semantics"): two loopback replicas, a chaos mid-stream kill
    (``rpc.stream=error``) at token ``kill_at``, resume-from-delivered ON
    vs OFF.  Reported per mode: token parity with an uninterrupted run,
    the recovery gap (largest inter-arrival gap at the consumer — the
    dead air between the last pre-kill and first post-kill token), and
    the replayed-token count.  On the CPU the structural counts are the
    signal (replayed tokens collapse to zero with resume ON; the
    survivor pays one prefill); on the card the recovery-gap ratio is —
    a full replay re-pays every delivered token's decode dispatch.
    ``device=None`` serves on the CUDA card."""
    import numpy as np
    import torch

    import tpulab_torch
    from tpulab_torch import chaos
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.mnist import make_mnist
    from tpulab_torch.models.transformer import init_transformer_params

    device = resolve_device(device)
    params = init_transformer_params(vocab=128, d_model=32, n_heads=2,
                                     n_layers=2, d_ff=64, device=device)

    def serve():
        cb = ContinuousBatcher(params, n_heads=2, n_layers=2, lanes=2,
                               max_len=max(64, prompt_len + steps + 8),
                               page_size=8, compute_dtype=torch.float32,
                               device=device)
        mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                            device=device)
        mgr.register_model("mnist", make_mnist(max_batch_size=1,
                                               device=device))
        mgr.update_resources()
        mgr.serve(port=0, generation_engines={"lm": cb})
        return mgr, cb

    (mgr_a, cb_a), (mgr_b, cb_b) = serve(), serve()
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 128, (prompt_len,), np.int32)
    out = {"prompt_len": prompt_len, "steps": steps, "kill_at": kill_at}
    try:
        for cb in (cb_a, cb_b):  # warm-up: the gap must be failover, not
            #                      first-call cost.  A STREAMING consumer
            #                      drops the adaptive block to K<=2, a
            #                      different block than plain submits
            cb.submit(prompt, steps,
                      on_token=lambda *a: None).result(timeout=300)
            # the resume prompt (prompt + kill_at delivered tokens) is a
            # longer prefill: warm it too
            cb.submit(rng.integers(0, 128, (prompt_len + kill_at,),
                                   np.int32), 2,
                      on_token=lambda *a: None).result(timeout=300)
        expected = [int(t) for t in
                    cb_a.submit(prompt, steps).result(timeout=300)]
        addrs = [f"127.0.0.1:{m.server.bound_port}" for m in (mgr_a, mgr_b)]
        for mode, resume in (("resume_on", True), ("resume_off", False)):
            rs = GenerationReplicaSet(addrs, "lm", resume_failover=resume,
                                      inter_token_timeout_s=10.0)
            try:
                prefills0 = cb_a.prefill_dispatches + cb_b.prefill_dispatches
                arrivals, got = [], []
                with chaos.inject(f"rpc.stream=error@{kill_at}+1"):
                    for tok in rs.generate(prompt, steps):
                        arrivals.append(time.perf_counter())
                        got.append(int(tok))
                gaps = np.diff(np.asarray(arrivals))
                out[mode] = {
                    "parity": got == expected,
                    "recovery_gap_ms": (round(float(gaps.max()) * 1e3, 2)
                                        if gaps.size else 0.0),
                    "tokens_replayed": rs.tokens_replayed,
                    "resumes": rs.resumes,
                    "failover_prefills": (cb_a.prefill_dispatches
                                          + cb_b.prefill_dispatches
                                          - prefills0),
                }
            finally:
                rs.close()
    finally:
        for m in (mgr_a, mgr_b):
            m.shutdown()
        for cb in (cb_a, cb_b):
            cb.shutdown()
    return out
