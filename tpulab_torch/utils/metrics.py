"""Prometheus metrics (the port of ``tpulab/utils/metrics.py``).

tpulab builds its metric sets on ``prometheus_client``; the card's machine
has no such package, so this module carries its own small Counter /
Gauge / Histogram / registry that speak the Prometheus text exposition
format 0.0.4 (:func:`generate_latest`), and :func:`start_metrics_server`
serves it from ``http.server``.  Metric names, label names, help strings
and buckets are tpulab's, so dashboards and alerts carry over; the
``_created`` series prometheus_client adds to counters and histograms are
not emitted.

The classes the ported subsystems feed: :class:`InferenceMetrics` (the
service), :class:`GenerationMetrics` (a ``ContinuousBatcher``),
:class:`KVTierMetrics` (``KVOffloadManager``), :class:`ModelStoreMetrics`
(``WeightMultiplexer``), :class:`HBMMetrics` (``HBMArbiter``),
:class:`AdmissionMetrics` (``AdmissionController``),
:class:`ChaosMetrics` (the chaos fire observer), :class:`SLOMetrics`
(``obs.SLOTracker``), :class:`ReplicaSetMetrics` (the replica sets and
the prefix-affinity router), :class:`FleetMetrics` (the autoscaler and
supervisor), :class:`BatchMetrics` (``batch.BatchScheduler``),
:class:`KVFabricMetrics` (``kvfabric.KVFabric``) and
:class:`FederationMetrics` (``fleet.FleetObserver``).
"""

from __future__ import annotations

import math
import threading
from collections import namedtuple
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: reference load-ratio buckets (metrics.cc): request_time / compute_time
LOAD_RATIO_BUCKETS = (1.25, 1.5, 2.0, 10.0, 100.0)

_QUANTILES = (0.5, 0.9, 0.99)

#: latency-distribution buckets (seconds), tpulab's: TTFT / queue cover the
#: serving SLO range (1 ms .. 10 s); ITL is finer; e2e stretches to
#: streaming-request lifetimes
TTFT_BUCKETS = (.001, .0025, .005, .01, .025, .05, .1, .25, .5, 1., 2.5,
                5., 10.)
ITL_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5, 1.)
E2E_BUCKETS = (.01, .025, .05, .1, .25, .5, 1., 2.5, 5., 10., 30., 60.)
#: deadline slack-at-completion buckets
SLACK_BUCKETS = (.001, .005, .01, .025, .05, .1, .25, .5, 1., 2.5, 5.,
                 10., 30.)
#: swap latency buckets (seconds): device <-> host page / weight copies
SWAP_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
                1., 2.5)

#: circuit-breaker states exported per replica (rpc/replica.py)
BREAKER_STATES = ("closed", "open", "probing")

#: the exposition's HTTP content type
CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

#: one collected metric family: ``samples`` are (name, labels, value)
Family = namedtuple("Family", "name documentation type samples")


# -- the registry and its three metric types ----------------------------------
class CollectorRegistry:
    """Metrics (anything with ``collect()`` yielding :data:`Family`) in
    registration order; a family name registers once."""

    def __init__(self):
        self._collectors: List[object] = []
        self._names: set = set()
        self._lock = threading.Lock()

    def register(self, collector) -> None:
        names = set(getattr(collector, "_exposed_names", ()))
        with self._lock:
            dup = names & self._names
            if dup:
                raise ValueError(
                    f"Duplicated timeseries in CollectorRegistry: {dup}")
            self._names |= names
            self._collectors.append(collector)

    def collect(self):
        with self._lock:
            collectors = list(self._collectors)
        for c in collectors:
            yield from c.collect()


class _Value:
    """One float under a lock (a child's count, gauge or bucket)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float) -> None:
        with self._lock:
            self._v += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def get(self) -> float:
        with self._lock:
            return self._v


class _CounterChild:
    def __init__(self, _metric):
        self._value = _Value()

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("Counters can only be incremented by "
                             "non-negative amounts.")
        self._value.inc(amount)

    def _samples(self, name, labels):
        return [(name + "_total", labels, self._value.get())]


class _GaugeChild:
    def __init__(self, _metric):
        self._value = _Value()

    def inc(self, amount: float = 1) -> None:
        self._value.inc(amount)

    def dec(self, amount: float = 1) -> None:
        self._value.inc(-amount)

    def set(self, value: float) -> None:
        self._value.set(value)

    def _samples(self, name, labels):
        return [(name, labels, self._value.get())]


class _HistogramChild:
    def __init__(self, metric):
        self._upper = metric._upper_bounds
        self._buckets = [0.0] * len(self._upper)
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, amount: float) -> None:
        amount = float(amount)
        with self._lock:
            self._sum += amount
            for i, bound in enumerate(self._upper):
                if amount <= bound:
                    self._buckets[i] += 1
                    break

    def _samples(self, name, labels):
        with self._lock:
            counts, total = list(self._buckets), self._sum
        out, acc = [], 0.0
        for bound, n in zip(self._upper, counts):
            acc += n
            out.append((name + "_bucket", dict(labels, le=_go_float(bound)),
                        acc))
        out.append((name + "_count", labels, acc))
        out.append((name + "_sum", labels, total))
        return out


class _Metric:
    """A family with optional labels: ``labels(...)`` returns the child
    for one label-value tuple; an unlabelled family is its own child."""

    _type = ""
    _child = None

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None):
        self._name = name
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        self._exposed_names = self._names_of(name)
        self._self = None if self._labelnames else self._child(self)
        if registry is not None:
            registry.register(self)

    def _names_of(self, name):
        return (name,)

    def labels(self, *values, **kw):
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing "
                             f"{self._name}")
        if values and kw:
            raise ValueError("Can't pass both *args and **kwargs")
        if kw:
            if set(kw) != set(self._labelnames):
                raise ValueError("Incorrect label names")
            values = tuple(str(kw[n]) for n in self._labelnames)
        else:
            if len(values) != len(self._labelnames):
                raise ValueError("Incorrect label count")
            values = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._child(self)
            return child

    def remove(self, *values) -> None:
        """Drop the child of one label-value tuple (absent: no-op)."""
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing "
                             f"{self._name}")
        if len(values) != len(self._labelnames):
            raise ValueError("Incorrect label count")
        with self._lock:
            self._children.pop(tuple(str(v) for v in values), None)

    def collect(self):
        if self._self is not None:
            pairs = [((), self._self)]
        else:
            with self._lock:
                pairs = list(self._children.items())
        samples = []
        for values, child in pairs:
            samples += child._samples(self._name,
                                      dict(zip(self._labelnames, values)))
        yield Family(self._name, self._documentation, self._type, samples)

    def _one(self):
        """The unlabelled family's own child."""
        if self._self is None:
            raise ValueError(f"{self._name} has labels "
                             f"{self._labelnames}: call labels() first")
        return self._self


class Counter(_Metric):
    """Monotonic counter; a trailing ``_total`` leaves the family name
    (prometheus_client's convention) and the sample is ``<family>_total``."""

    _type = "counter"
    _child = _CounterChild

    def __init__(self, name: str, documentation: str, labelnames=(),
                 registry: Optional[CollectorRegistry] = None):
        if name.endswith("_total"):
            name = name[:-len("_total")]
        super().__init__(name, documentation, labelnames, registry)

    def _names_of(self, name):
        return (name, name + "_total", name + "_created")

    def inc(self, amount: float = 1) -> None:
        self._one().inc(amount)


class Gauge(_Metric):
    _type = "gauge"
    _child = _GaugeChild

    def inc(self, amount: float = 1) -> None:
        self._one().inc(amount)

    def dec(self, amount: float = 1) -> None:
        self._one().dec(amount)

    def set(self, value: float) -> None:
        self._one().set(value)


class Histogram(_Metric):
    """Cumulative-bucket histogram; ``+Inf`` is appended to ``buckets``."""

    _type = "histogram"
    _child = _HistogramChild

    def __init__(self, name: str, documentation: str, labelnames=(),
                 registry: Optional[CollectorRegistry] = None,
                 buckets: Sequence[float] = ITL_BUCKETS):
        if "le" in labelnames:
            raise ValueError("Invalid label name: le")
        upper = sorted(float(b) for b in buckets)
        if not upper or upper[-1] != math.inf:
            upper.append(math.inf)
        self._upper_bounds = upper
        super().__init__(name, documentation, labelnames, registry)

    def _names_of(self, name):
        return (name, name + "_bucket", name + "_count", name + "_sum",
                name + "_created")

    def observe(self, amount: float) -> None:
        self._one().observe(amount)


# -- the text exposition format 0.0.4 ------------------------------------------
def _go_float(d: float) -> str:
    """A float as Go's Prometheus server prints it (``+Inf``, ``1.0``,
    exponents from 1e+07 up), the spelling prometheus_client uses."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The registry's families in the Prometheus text format 0.0.4."""
    out: List[str] = []
    for fam in registry.collect():
        name = fam.name + "_total" if fam.type == "counter" else fam.name
        doc = fam.documentation.replace("\\", r"\\").replace("\n", r"\n")
        out.append(f"# HELP {name} {doc}\n")
        out.append(f"# TYPE {name} {fam.type}\n")
        for sname, labels, value in fam.samples:
            lab = ""
            if labels:
                lab = "{" + ",".join(
                    f'{k}="{_escape_label(str(v))}"'
                    for k, v in sorted(labels.items())) + "}"
            out.append(f"{sname}{lab} {_go_float(value)}\n")
    return "".join(out).encode("utf-8")


# -- the metric sets -----------------------------------------------------------
class _Reservoir:
    """Sliding-window quantile reservoir backing a 'summary'."""

    def __init__(self, size: int = 2048):
        self._buf = np.zeros(size, np.float64)
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = value
            self._n += 1

    def quantile(self, q: float) -> float:
        with self._lock:
            n = min(self._n, len(self._buf))
            if n == 0:
                return 0.0
            return float(np.percentile(self._buf[:n], q * 100))


class _Polled:
    """Counters that advance by the delta since the last poll."""

    def _advance(self, counter, key: str, value: int) -> None:
        delta = value - self._last.get(key, 0)
        if delta > 0:
            counter.inc(delta)
        self._last[key] = value


class InferenceMetrics:
    """The service's metric set: request / compute duration summaries
    (sliding-window quantile gauges next to count and sum), the load-ratio
    histogram, the device-memory gauges, queue depth and per-model
    request counts."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self._request = _Reservoir()
        self._compute = _Reservoir()
        self.request_count = Counter(
            f"{ns}_request_total", "Requests completed", registry=self.registry)
        # Gauges (not Counters) so the exported sample keeps the summary
        # convention `..._seconds_sum` — Counter would append `_total`.
        self.request_seconds_sum = Gauge(
            f"{ns}_request_duration_seconds_sum", "Total request seconds",
            registry=self.registry)
        self.compute_seconds_sum = Gauge(
            f"{ns}_compute_duration_seconds_sum", "Total compute seconds",
            registry=self.registry)
        self.request_quantiles = Gauge(
            f"{ns}_request_duration_seconds", "Request duration quantiles",
            ["quantile"], registry=self.registry)
        self.compute_quantiles = Gauge(
            f"{ns}_compute_duration_seconds", "Compute duration quantiles",
            ["quantile"], registry=self.registry)
        self.load_ratio = Histogram(
            f"{ns}_load_ratio", "request/compute duration ratio",
            buckets=LOAD_RATIO_BUCKETS, registry=self.registry)
        # tpulab's HBM gauges, read from the CUDA caching allocator
        self.hbm_bytes_in_use = Gauge(
            f"{ns}_hbm_bytes_in_use", "Device HBM in use (power-gauge analog)",
            registry=self.registry)
        self.framework_hbm_bytes = Gauge(
            f"{ns}_framework_hbm_bytes",
            "HBM owned via the device allocator framework (weights, KV "
            "page stores) — the size_tracker figure",
            registry=self.registry)
        self.queue_depth = Gauge(
            f"{ns}_queue_depth", "In-flight requests (NVRPC_METRICS hook)",
            registry=self.registry)
        self.model_requests = Counter(
            f"{ns}_requests_by_model", "Requests completed, per model",
            ["model"], registry=self.registry)
        self.model_request_seconds = Histogram(
            f"{ns}_request_duration_seconds_by_model",
            "Request latency distribution, per model",
            ["model"], buckets=E2E_BUCKETS, registry=self.registry)
        self._since_refresh = 0
        self._ever_refreshed = False
        self._refresh_lock = threading.Lock()

    _REFRESH_EVERY = 64  # quantile refresh cadence (full reservoir sort)

    def observe_request(self, request_s: float, compute_s: float,
                        model: Optional[str] = None) -> None:
        self.request_count.inc()
        if model:
            self.model_requests.labels(model=model).inc()
            self.model_request_seconds.labels(model=model).observe(
                max(0.0, request_s))
        self.request_seconds_sum.inc(request_s)
        self.compute_seconds_sum.inc(compute_s)
        self._request.observe(request_s)
        self._compute.observe(compute_s)
        if compute_s > 0:
            self.load_ratio.observe(request_s / compute_s)
        # the quantile gauges refresh on the first observation and then
        # every _REFRESH_EVERY (the count-and-decide is atomic: exactly one
        # of several racing observers pays the sort)
        with self._refresh_lock:
            self._since_refresh += 1
            do_refresh = (not self._ever_refreshed
                          or self._since_refresh >= self._REFRESH_EVERY)
        if do_refresh:
            self.refresh_quantiles()

    def refresh_quantiles(self) -> None:
        with self._refresh_lock:
            self._since_refresh = 0
            self._ever_refreshed = True
        for q in _QUANTILES:
            self.request_quantiles.labels(quantile=str(q)).set(
                self._request.quantile(q))
            self.compute_quantiles.labels(quantile=str(q)).set(
                self._compute.quantile(q))

    def inc_queue_depth(self) -> None:
        self.queue_depth.inc()

    def dec_queue_depth(self) -> None:
        self.queue_depth.dec()

    def poll_device(self, device_index: int = 0) -> None:
        """Control-loop hook: the CUDA caching allocator's reserved bytes
        (``torch.cuda.memory_reserved``: what the device has handed the
        process) as ``hbm_bytes_in_use`` and its allocated bytes
        (``memory_allocated``: what live tensors hold) as
        ``framework_hbm_bytes``; then the quantile gauges.  Without a
        CUDA device only the quantiles refresh."""
        import torch
        if torch.cuda.is_available():
            self.hbm_bytes_in_use.set(torch.cuda.memory_reserved(
                device_index))
            self.framework_hbm_bytes.set(torch.cuda.memory_allocated(
                device_index))
        self.refresh_quantiles()


class ReplicaSetMetrics:
    """Observability for client-side replica routing
    (:mod:`tpulab_torch.rpc.replica`): per-replica traffic/inflight/liveness,
    the failover counter, circuit-breaker state/transitions, per-attempt
    status-code counters and end-to-end deadline outcomes — the
    client-side view envoy's upstream stats give in deployment, plus the
    resilience telemetry the adaptive-orchestration line in PAPERS.md
    argues breakers/deadlines need in order to be tunable."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.requests = Counter(
            f"{ns}_replica_requests_total",
            "Requests completed per replica", ["replica"],
            registry=self.registry)
        self.failovers = Counter(
            f"{ns}_replica_failovers_total",
            "Requests re-routed off a failed replica",
            registry=self.registry)
        self.inflight = Gauge(
            f"{ns}_replica_inflight", "In-flight requests per replica",
            ["replica"], registry=self.registry)
        self.live = Gauge(
            f"{ns}_replica_live",
            "Last health-probe liveness per replica (1/0)", ["replica"],
            registry=self.registry)
        # -- circuit breaker (one-hot state + transition counters) ----------
        self.breaker_state = Gauge(
            f"{ns}_replica_breaker_state",
            "Circuit-breaker state per replica (one-hot over "
            "closed/open/probing)", ["replica", "state"],
            registry=self.registry)
        self.breaker_transitions = Counter(
            f"{ns}_replica_breaker_transitions_total",
            "Breaker transitions per replica, keyed by target state",
            ["replica", "to"], registry=self.registry)
        # -- per-attempt outcomes (retry/failover tuning input) -------------
        self.attempts = Counter(
            f"{ns}_replica_attempts_total",
            "Request attempts by terminal status code (OK, UNAVAILABLE, "
            "DEADLINE_EXCEEDED, INVALID_ARGUMENT, ...)", ["code"],
            registry=self.registry)
        # -- end-to-end deadline outcomes -----------------------------------
        self.deadline_outcomes = Counter(
            f"{ns}_deadline_outcomes_total",
            "Deadline-bounded requests by outcome (met/exceeded)",
            ["outcome"], registry=self.registry)
        self.deadline_slack = Histogram(
            f"{ns}_deadline_slack_seconds",
            "Remaining budget at completion of deadline-bounded requests",
            buckets=SLACK_BUCKETS, registry=self.registry)
        # -- durable streams (docs/ROBUSTNESS.md "Stream failover
        # semantics"): how much failover work was wasted vs resumed ------
        self.stalls = Counter(
            f"{ns}_replica_stream_stalls_total",
            "Streams failed over by the stall watchdog (no first token "
            "within the TTFT bound / no progress within the inter-token "
            "bound) — distinct from transport faults", registry=self.registry)
        self.resumes = Counter(
            f"{ns}_replica_stream_resumes_total",
            "Failover attempts resubmitted as resume-from-delivered "
            "(prompt+delivered re-prefilled, zero tokens replayed)",
            registry=self.registry)
        self.resume_fallbacks = Counter(
            f"{ns}_replica_stream_resume_fallbacks_total",
            "Resume attempts the server rejected, degraded to full replay",
            registry=self.registry)
        self.tokens_replayed = Counter(
            f"{ns}_replica_tokens_replayed_total",
            "Already-delivered tokens re-received and discarded on "
            "full-replay failovers (the waste resume removes)",
            registry=self.registry)
        self.hedges = Counter(
            f"{ns}_replica_hedges_total",
            "Duplicate first-token attempts launched after the hedge delay",
            registry=self.registry)
        self.hedge_wins = Counter(
            f"{ns}_replica_hedge_wins_total",
            "Hedged requests whose duplicate attempt delivered the first "
            "token (the primary lost the race)", registry=self.registry)
        # -- per-replica prefix-cache effectiveness (poll_load refreshes
        # from StatusResponse.prefix_hits/prefix_lookups) — the fleet view
        # prefix-affinity routing (ROADMAP item 1) needs: a returning
        # user landing on a random replica shows up here as hit rates
        # collapsing as the fleet widens ------------------------------------
        self.prefix_hits = Gauge(
            f"{ns}_replica_prefix_hits",
            "Server-reported prefix-cache pages served from cache, "
            "per replica (lifetime counter sampled as a gauge)",
            ["replica"], registry=self.registry)
        self.prefix_lookups = Gauge(
            f"{ns}_replica_prefix_lookups",
            "Server-reported prefix-cache pages looked up (hits + "
            "misses), per replica", ["replica"], registry=self.registry)
        # -- prefix-affinity routing (tpulab_torch.fleet.router): did requests
        # land on their rendezvous home, and how much cache warmth do
        # membership changes cost ----------------------------------------
        self.affinity_hits = Counter(
            f"{ns}_replica_affinity_hits_total",
            "Requests routed to their prefix-affinity winner (rank 0 of "
            "the rendezvous ring)", registry=self.registry)
        self.affinity_spills = Counter(
            f"{ns}_replica_affinity_spills_total",
            "Requests whose affinity winner was skipped for load (queue "
            "depth / inflight / free-HBM spill thresholds) — the "
            "hot-prefix-never-a-hot-spot contract, counted",
            registry=self.registry)
        self.ring_moves = Counter(
            f"{ns}_replica_ring_moves_total",
            "Sampled prefix digests re-homed by ring membership changes "
            "(breaker ejections, drains, scale up/down) — rendezvous "
            "hashing keeps this near sampled/N per change",
            registry=self.registry)

    # -- hooks (called by the replica sets; cold paths) ---------------------
    def set_breaker_state(self, replica: str, state: str) -> None:
        """One-hot the per-replica state gauge (PromQL reads
        ``..._breaker_state{state="open"} == 1``)."""
        for s in BREAKER_STATES:
            self.breaker_state.labels(replica=replica, state=s).set(
                1 if s == state else 0)

    def note_breaker_transition(self, replica: str, to_state: str) -> None:
        self.breaker_transitions.labels(replica=replica, to=to_state).inc()
        self.set_breaker_state(replica, to_state)

    def note_attempt(self, code: str) -> None:
        self.attempts.labels(code=code).inc()

    def observe_deadline(self, met: bool,
                         slack_s: Optional[float] = None) -> None:
        self.deadline_outcomes.labels(
            outcome="met" if met else "exceeded").inc()
        if met and slack_s is not None:
            self.deadline_slack.observe(max(0.0, slack_s))

    # -- durable-stream hooks -------------------------------------------
    def note_stall(self) -> None:
        self.stalls.inc()

    def note_resume(self) -> None:
        self.resumes.inc()

    def note_resume_fallback(self) -> None:
        self.resume_fallbacks.inc()

    def note_tokens_replayed(self, n: int = 1) -> None:
        if n > 0:
            self.tokens_replayed.inc(n)

    def note_hedge(self, won: bool = False) -> None:
        if won:
            self.hedge_wins.inc()
        else:
            self.hedges.inc()

    # -- prefix-affinity hooks (tpulab_torch.fleet.router) --------------------
    def note_affinity(self, hit: bool) -> None:
        if hit:
            self.affinity_hits.inc()
        else:
            self.affinity_spills.inc()

    def note_ring_moves(self, n: int = 1) -> None:
        if n > 0:
            self.ring_moves.inc(n)


class FleetMetrics:
    """Observability for the fleet control plane
    (:mod:`tpulab_torch.fleet`): autoscaler membership actions and the
    queue-wait signal it scales on, plus the self-healing telemetry
    (:mod:`tpulab_torch.fleet.supervisor`) — replica deaths and
    respawns, the crash-loop breaker alert — and the leader gauges
    leader election feeds.  The
    elasticity telemetry the adaptive-orchestration line in PAPERS.md
    argues a scale controller needs in order to be tunable (is it
    flapping? is the wait threshold doing work? is a slot burning spawn
    budget?)."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.scale_ups = Counter(
            f"{ns}_fleet_scale_ups_total",
            "Replicas added by the autoscaler", registry=self.registry)
        self.scale_downs = Counter(
            f"{ns}_fleet_scale_downs_total",
            "Replicas retired by the autoscaler (drain completed)",
            registry=self.registry)
        self.drains = Counter(
            f"{ns}_fleet_drains_total",
            "Scale-down drains started (victim flagged draining; retired "
            "only once in-flight work completes)", registry=self.registry)
        self.replicas = Gauge(
            f"{ns}_fleet_replicas",
            "Active (routable, non-draining) replicas in the set",
            registry=self.registry)
        self.queue_wait = Gauge(
            f"{ns}_fleet_queue_wait_ewma_seconds",
            "The admission queue-wait EWMA the controller last evaluated "
            "(AdmissionController.queue_wait_ewma_s)",
            registry=self.registry)
        self.replica_deaths = Counter(
            f"{ns}_fleet_replica_deaths_total",
            "Replicas the supervisor declared dead (process exited or "
            "unreachable past the probe streak) — drains never count",
            registry=self.registry)
        self.respawns = Counter(
            f"{ns}_fleet_respawns_total",
            "Crashed replicas respawned by the supervisor (after "
            "exponential backoff)", registry=self.registry)
        self.crash_loops = Counter(
            f"{ns}_fleet_crash_loops_total",
            "Crash-loop breaker openings: a lineage died N times in the "
            "window and is quarantined (spawn budget stops burning; "
            "THIS is the alert to page on)", registry=self.registry)
        self.leader_transitions = Counter(
            f"{ns}_fleet_leader_transitions_total",
            "Times THIS node gained control-plane leadership (lease "
            "acquisitions; fleet-wide churn = sum over nodes)",
            registry=self.registry)
        self.is_leader = Gauge(
            f"{ns}_fleet_is_leader",
            "1 while this node holds the control-plane lease (runs the "
            "supervisor + autoscaler), else 0", registry=self.registry)
        self._was_leader = False

    # -- hooks (called by the control plane; cold paths) ----------------
    def note_scale(self, up: bool) -> None:
        (self.scale_ups if up else self.scale_downs).inc()

    def note_drain(self) -> None:
        self.drains.inc()

    def set_replicas(self, n: int) -> None:
        self.replicas.set(n)

    def set_queue_wait(self, seconds: float) -> None:
        self.queue_wait.set(max(0.0, float(seconds)))

    def note_death(self) -> None:
        self.replica_deaths.inc()

    def note_respawn(self) -> None:
        self.respawns.inc()

    def note_crash_loop(self) -> None:
        self.crash_loops.inc()

    def set_leader(self, leading: bool) -> None:
        """Gauge + edge-triggered transition counter (gains only)."""
        leading = bool(leading)
        self.is_leader.set(1 if leading else 0)
        if leading and not self._was_leader:
            self.leader_transitions.inc()
        self._was_leader = leading


class BatchMetrics(_Polled):
    """Offline-batch-lane telemetry (`_batch_*`; tpulab_torch.batch,
    docs/SERVING.md "Offline batch lane"): job/item progress, how often
    online traffic evicted the lane, tokens delivered vs re-decode the
    checkpoint resume avoided, and the utilization-soak gauge — is the
    lane actually converting idle capacity into tokens.  Sampled by
    ``poll(scheduler)`` (cheap attribute reads; counters advance by the
    delta since the last poll, so rate() works in PromQL)."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.jobs_running = Gauge(
            f"{ns}_batch_jobs_running",
            "Batch jobs a scheduler is currently running",
            registry=self.registry)
        self.jobs_done = Counter(
            f"{ns}_batch_jobs_done_total",
            "Batch jobs run to completion (every item done)",
            registry=self.registry)
        self.jobs_interrupted = Counter(
            f"{ns}_batch_jobs_interrupted_total",
            "Batch runs killed mid-job (chaos/timeout); the next run "
            "resumes from the JSONL checkpoint", registry=self.registry)
        self.items_done = Counter(
            f"{ns}_batch_items_done_total",
            "Job items (prompts) completed", registry=self.registry)
        self.preemptions = Counter(
            f"{ns}_batch_preemptions_total",
            "Batch-class lanes evicted by online arrivals (the lane is "
            "the FIRST preemption victim by design — a high count with "
            "healthy online latencies is the lane working)",
            registry=self.registry)
        self.tokens_delivered = Counter(
            f"{ns}_batch_tokens_delivered_total",
            "Tokens delivered to batch result sinks",
            registry=self.registry)
        self.tokens_replay_avoided = Counter(
            f"{ns}_batch_tokens_replay_avoided_total",
            "Delivered tokens a checkpoint resume did NOT re-decode "
            "(the prompt+delivered prefix rode one chunked prefill)",
            registry=self.registry)
        self.spare_denials = Counter(
            f"{ns}_batch_spare_denials_total",
            "Feed attempts deferred by the spare-capacity gate (idle "
            "lanes / unified headroom / arbiter floor)",
            registry=self.registry)
        self.soak_utilization = Gauge(
            f"{ns}_batch_soak_utilization",
            "Fraction of engine lanes the batch lane occupies right now "
            "(near 1 on an idle fleet, near 0 under online load — both "
            "are the lane working as designed)", registry=self.registry)
        self._last: Dict[str, int] = {}

    def poll(self, scheduler) -> None:
        """Sample a tpulab_torch.batch.BatchScheduler (control-loop hook)."""
        self.jobs_running.set(getattr(scheduler, "jobs_running", 0))
        self.soak_utilization.set(
            getattr(scheduler, "soak_utilization", 0.0))
        self._advance(self.jobs_done, "jobs_done",
                      getattr(scheduler, "jobs_done", 0))
        self._advance(self.jobs_interrupted, "interrupted",
                      getattr(scheduler, "interrupted_runs", 0))
        self._advance(self.items_done, "items_done",
                      getattr(scheduler, "items_done", 0))
        self._advance(self.tokens_delivered, "tokens",
                      getattr(scheduler, "tokens_delivered", 0))
        self._advance(self.tokens_replay_avoided, "replay_avoided",
                      getattr(scheduler, "tokens_resume_skipped", 0))
        self._advance(self.spare_denials, "spare_denials",
                      getattr(scheduler, "spare_denials", 0))
        eng = getattr(scheduler, "engine", None)
        if eng is not None:
            self._advance(self.preemptions, "preemptions",
                          getattr(eng, "batch_preemptions", 0))


class GenerationMetrics(_Polled):
    """LLM-serving observability for a ``ContinuousBatcher``: lane / queue
    / page gauges plus token / request / preemption / prefix-cache
    counters, sampled by ``poll(batcher)`` (counters advance by the delta
    since the last poll).  The latency distributions (TTFT, inter-token,
    queue wait, end to end) are event-driven: pass this object as the
    batcher's ``metrics=`` and it observes every request at the source."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None,
                 model: str = ""):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        #: model name tagging this engine's per-model samples ("" = none)
        self.model_label = model
        self.active_lanes = Gauge(
            f"{ns}_llm_active_lanes", "Decode lanes in use",
            registry=self.registry)
        self.queued = Gauge(
            f"{ns}_llm_queued_requests", "Requests waiting for a lane",
            registry=self.registry)
        self.free_pages = Gauge(
            f"{ns}_llm_free_pages", "KV pool pages free",
            registry=self.registry)
        self.tokens = Counter(
            f"{ns}_llm_tokens", "Tokens generated",
            registry=self.registry)
        self.completed = Counter(
            f"{ns}_llm_requests_completed", "Generation requests completed",
            registry=self.registry)
        self.preemptions = Counter(
            f"{ns}_llm_preemptions", "Priority preemptions",
            registry=self.registry)
        self.prefix_hits = Counter(
            f"{ns}_llm_prefix_cache_hits", "Prefix-cache page hits",
            registry=self.registry)
        self.prefix_misses = Counter(
            f"{ns}_llm_prefix_cache_misses", "Prefix pages computed fresh",
            registry=self.registry)
        self.ttft = Histogram(
            f"{ns}_llm_ttft_seconds",
            "Time to first token (submit -> first emitted token)",
            buckets=TTFT_BUCKETS, registry=self.registry)
        self.itl = Histogram(
            f"{ns}_llm_inter_token_seconds",
            "Inter-token latency (per decoded token after the first)",
            buckets=ITL_BUCKETS, registry=self.registry)
        self.queue_wait = Histogram(
            f"{ns}_llm_queue_wait_seconds",
            "Submit -> prefill start (lane + page admission wait)",
            buckets=TTFT_BUCKETS, registry=self.registry)
        self.e2e = Histogram(
            f"{ns}_llm_e2e_seconds",
            "Submit -> last token (completed requests)",
            buckets=E2E_BUCKETS, registry=self.registry)
        self.deadline_expired = Counter(
            f"{ns}_llm_deadline_expired_total",
            "Requests the batcher cancelled at deadline expiry",
            registry=self.registry)
        self.decode_dispatches = Counter(
            f"{ns}_llm_decode_dispatches",
            "Fused decode dispatches (K-token blocks and single ticks)",
            registry=self.registry)
        self.decode_host_syncs = Counter(
            f"{ns}_llm_decode_host_syncs",
            "Blocking device->host result fetches in decode",
            registry=self.registry)
        self.ragged_dispatches = Counter(
            f"{ns}_llm_ragged_dispatches",
            "Dispatches through the ragged paged-attention family "
            "(mixed prefill+decode rounds, plus decode/verify dispatches "
            "whose attention ran the pallas ragged kernel)",
            registry=self.registry)
        self.dispatches_by_kind = Counter(
            f"{ns}_llm_dispatches_by_kind",
            "Decode dispatches by ragged-plan dispatch kind "
            "(decode = K-blocks/single ticks, verify = speculative "
            "draft+verify blocks, mixed = ragged prefill+decode rounds)",
            ["kind"], registry=self.registry)
        self.tokens_per_dispatch = Gauge(
            f"{ns}_llm_tokens_per_dispatch",
            "Generated tokens per decode dispatch (lifetime ratio; ~K x "
            "lanes when fused blocks run full)", registry=self.registry)
        self.host_syncs_per_token = Gauge(
            f"{ns}_llm_host_syncs_per_token",
            "Blocking host syncs per generated token (1.0 = per-token "
            "round trips; ~1/(K*lanes) under fused decode)",
            registry=self.registry)
        self.spec_tokens_drafted = Counter(
            f"{ns}_llm_spec_tokens_drafted",
            "Draft-model proposals verified by the target (accepted or "
            "rejected)", registry=self.registry)
        self.spec_tokens_accepted = Counter(
            f"{ns}_llm_spec_tokens_accepted",
            "Draft proposals the target accepted (emitted as output "
            "tokens)", registry=self.registry)
        self.spec_fallbacks = Counter(
            f"{ns}_llm_spec_fallbacks",
            "Lanes degraded from speculative to plain decode blocks "
            "(low acceptance, chaos verify trips)",
            registry=self.registry)
        self.spec_probes = Counter(
            f"{ns}_llm_spec_probes",
            "Probe blocks re-trying speculation on a transiently degraded "
            "lane (acceptance-EWMA degrades only)", registry=self.registry)
        self.spec_probe_recoveries = Counter(
            f"{ns}_llm_spec_probe_recoveries",
            "Probe blocks whose lane recovered to speculative decode "
            "(acceptance back above the floor)", registry=self.registry)
        self.spec_acceptance_rate = Gauge(
            f"{ns}_llm_spec_acceptance_rate",
            "Lifetime draft acceptance rate (accepted / drafted) — the "
            "multiplier on the decode-block dispatch amortization",
            registry=self.registry)
        self.resumed_streams = Counter(
            f"{ns}_llm_resumed_streams",
            "Generate streams admitted as resume-from-delivered "
            "(prompt+delivered through one chunked prefill)",
            registry=self.registry)
        self.tokens_resume_skipped = Counter(
            f"{ns}_llm_tokens_resume_skipped",
            "Already-delivered tokens a resume admission did NOT re-decode "
            "(each rode the prefill instead of a sequential decode step)",
            registry=self.registry)
        self.model_tokens = Counter(
            f"{ns}_llm_tokens_by_model", "Tokens generated, per model",
            ["model"], registry=self.registry)
        self.model_completed = Counter(
            f"{ns}_llm_requests_completed_by_model",
            "Generation requests completed, per model",
            ["model"], registry=self.registry)
        self.model_ttft = Histogram(
            f"{ns}_llm_ttft_seconds_by_model",
            "Time to first token, per model",
            ["model"], buckets=TTFT_BUCKETS, registry=self.registry)
        self.model_itl = Histogram(
            f"{ns}_llm_inter_token_seconds_by_model",
            "Inter-token latency, per model",
            ["model"], buckets=ITL_BUCKETS, registry=self.registry)
        self._ttft_res = _Reservoir()
        self._itl_res = _Reservoir()
        self._last: Dict[str, int] = {}

    # -- event hooks (called by the batcher) --------------------------------
    def observe_queue_wait(self, seconds: float) -> None:
        self.queue_wait.observe(max(0.0, seconds))

    def observe_ttft(self, seconds: float) -> None:
        seconds = max(0.0, seconds)
        self.ttft.observe(seconds)
        if self.model_label:
            self.model_ttft.labels(model=self.model_label).observe(seconds)
        self._ttft_res.observe(seconds)

    def observe_itl(self, seconds: float) -> None:
        seconds = max(0.0, seconds)
        self.itl.observe(seconds)
        if self.model_label:
            self.model_itl.labels(model=self.model_label).observe(seconds)
        self._itl_res.observe(seconds)

    def observe_e2e(self, seconds: float) -> None:
        self.e2e.observe(max(0.0, seconds))

    def note_deadline_expired(self) -> None:
        self.deadline_expired.inc()

    def note_resume(self, tokens_skipped: int) -> None:
        """One resume-from-delivered admission (Generate RPC)."""
        self.resumed_streams.inc()
        if tokens_skipped > 0:
            self.tokens_resume_skipped.inc(tokens_skipped)

    def ttft_quantiles(self) -> Dict[str, float]:
        return {f"p{int(q * 100)}": self._ttft_res.quantile(q)
                for q in _QUANTILES}

    def itl_quantiles(self) -> Dict[str, float]:
        return {f"p{int(q * 100)}": self._itl_res.quantile(q)
                for q in _QUANTILES}

    def poll(self, batcher) -> None:
        """Sample a ContinuousBatcher (control-loop / poller hook)."""
        self.active_lanes.set(batcher.active_lanes)
        self.queued.set(batcher.queued_requests)
        try:
            self.free_pages.set(batcher.pool.free_pages)
        except AttributeError:  # a wrapped engine without .pool
            pass
        self._advance(self.tokens, "tokens", batcher.tokens_generated)
        self._advance(self.completed, "completed",
                      batcher.completed_requests)
        if self.model_label:
            self._advance(self.model_tokens.labels(model=self.model_label),
                          "model_tokens", batcher.tokens_generated)
            self._advance(
                self.model_completed.labels(model=self.model_label),
                "model_completed", batcher.completed_requests)
        self._advance(self.preemptions, "preempt", batcher.preemptions)
        dispatches = getattr(batcher, "decode_dispatches", 0)
        syncs = getattr(batcher, "decode_host_syncs", 0)
        self._advance(self.decode_dispatches, "dispatches", dispatches)
        self._advance(self.decode_host_syncs, "syncs", syncs)
        self._advance(self.ragged_dispatches, "ragged",
                      getattr(batcher, "ragged_dispatches", 0))
        for kind, n in getattr(batcher, "dispatch_kinds", {}).items():
            self._advance(self.dispatches_by_kind.labels(kind=kind),
                          f"kind_{kind}", n)
        drafted = getattr(batcher, "spec_tokens_drafted", 0)
        accepted = getattr(batcher, "spec_tokens_accepted", 0)
        self._advance(self.spec_tokens_drafted, "spec_drafted", drafted)
        self._advance(self.spec_tokens_accepted, "spec_accepted", accepted)
        self._advance(self.spec_fallbacks, "spec_fallbacks",
                      getattr(batcher, "spec_fallbacks", 0))
        self._advance(self.spec_probes, "spec_probes",
                      getattr(batcher, "spec_probes", 0))
        self._advance(self.spec_probe_recoveries, "spec_probe_recoveries",
                      getattr(batcher, "spec_probe_recoveries", 0))
        if drafted:
            self.spec_acceptance_rate.set(accepted / drafted)
        if dispatches:
            self.tokens_per_dispatch.set(
                batcher.tokens_generated / dispatches)
        if batcher.tokens_generated:
            self.host_syncs_per_token.set(
                syncs / batcher.tokens_generated)
        pc = getattr(batcher, "prefix_cache", None)
        if pc is not None:
            self._advance(self.prefix_hits, "hits", pc.hits)
            self._advance(self.prefix_misses, "misses", pc.misses)


class KVTierMetrics(_Polled):
    """Host KV tier telemetry (``_kv_tier_*``; ``tpulab_torch.kvcache``):
    swap bytes and latency distributions, demotion / promotion / drop
    counters, recompute tokens saved and host-tier occupancy.  Latencies
    are event-driven (the manager's ``metrics=``); counters and gauges
    advance through :meth:`poll`."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.swap_out_bytes = Counter(
            f"{ns}_kv_tier_swap_out_bytes",
            "KV bytes copied device->host (lane swaps + demotions)",
            registry=self.registry)
        self.swap_in_bytes = Counter(
            f"{ns}_kv_tier_swap_in_bytes",
            "KV bytes copied host->device (restores + promotions)",
            registry=self.registry)
        self.swap_out_seconds = Histogram(
            f"{ns}_kv_tier_swap_out_seconds",
            "Swap-out latency (gather dispatch -> host-tier resident; "
            "write-behind, so this is BEHIND the decode loop)",
            buckets=SWAP_BUCKETS, registry=self.registry)
        self.swap_in_seconds = Histogram(
            f"{ns}_kv_tier_swap_in_seconds",
            "Swap-in latency (restore entry -> scatter dispatched)",
            buckets=SWAP_BUCKETS, registry=self.registry)
        self.swap_outs = Counter(
            f"{ns}_kv_tier_swap_outs", "Preempted-lane KV snapshots taken",
            registry=self.registry)
        self.swap_ins = Counter(
            f"{ns}_kv_tier_swap_ins",
            "Recompute-free resumes (snapshot restored, no re-prefill)",
            registry=self.registry)
        self.demotions = Counter(
            f"{ns}_kv_tier_demotions",
            "Prefix-cache pages demoted to the host tier",
            registry=self.registry)
        self.promotions = Counter(
            f"{ns}_kv_tier_promotions",
            "Prefix-cache pages promoted back from the host tier",
            registry=self.registry)
        self.swap_failures = Counter(
            f"{ns}_kv_tier_swap_failures",
            "Swaps degraded to the recompute path (chaos, transfer "
            "errors)", registry=self.registry)
        self.swap_drops = Counter(
            f"{ns}_kv_tier_swap_drops",
            "Snapshots the host tier's budget refused (distinct from "
            "transfer failures: a sustained count means the host budget "
            "is undersized)", registry=self.registry)
        self.host_drops = Counter(
            f"{ns}_kv_tier_host_drops",
            "Payloads refused by the host tier (larger than the budget)",
            registry=self.registry)
        self.host_evictions = Counter(
            f"{ns}_kv_tier_host_evictions",
            "Host-tier LRU entries pushed out by budget pressure",
            registry=self.registry)
        self.recompute_tokens_saved = Counter(
            f"{ns}_kv_tier_recompute_tokens_saved",
            "Prefill tokens resumes did NOT recompute (the tier's work "
            "saved, in tokens)", registry=self.registry)
        self.host_bytes = Gauge(
            f"{ns}_kv_tier_host_bytes", "Host-tier payload bytes resident",
            registry=self.registry)
        self.host_entries = Gauge(
            f"{ns}_kv_tier_host_entries", "Host-tier entries resident",
            registry=self.registry)
        self._last: Dict[str, int] = {}

    def observe_swap_out(self, seconds: float, nbytes: int) -> None:
        self.swap_out_seconds.observe(max(0.0, seconds))

    def observe_swap_in(self, seconds: float, nbytes: int) -> None:
        self.swap_in_seconds.observe(max(0.0, seconds))

    def poll(self, manager) -> None:
        """Sample a KVOffloadManager (control-loop / poller hook)."""
        self._advance(self.swap_out_bytes, "ob", manager.swap_out_bytes)
        self._advance(self.swap_in_bytes, "ib", manager.swap_in_bytes)
        self._advance(self.swap_outs, "so", manager.swap_outs)
        self._advance(self.swap_ins, "si", manager.swap_ins)
        self._advance(self.demotions, "dem", manager.demotions)
        self._advance(self.promotions, "pro", manager.promotions)
        self._advance(self.swap_failures, "fail", manager.swap_failures)
        self._advance(self.swap_drops, "sdrop", manager.swap_drops)
        self._advance(self.recompute_tokens_saved, "saved",
                      manager.recompute_tokens_saved)
        store = manager.store
        self._advance(self.host_drops, "drops", store.drops)
        self._advance(self.host_evictions, "evict", store.evictions)
        self.host_bytes.set(store.bytes_used)
        self.host_entries.set(len(store))


class KVFabricMetrics(_Polled):
    """Fleet KV fabric telemetry (``_kvfabric_*``;
    ``tpulab_torch.kvfabric``): pull counts / bytes and the fetch-latency
    distribution, single-flight coalesces, cost-gate skips, degrades and
    recompute tokens saved — whether routed-astray requests adopt the
    fleet's warmth (pulls + tokens saved) or still recompute it
    (degrades).  Latency is event-driven (the fabric's ``metrics=``);
    counters advance through :meth:`poll`."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.pulls = Counter(
            f"{ns}_kvfabric_pulls",
            "Prefix-KV pulls fetched from a home replica and adopted "
            "locally (each replaced a whole local prefill)",
            registry=self.registry)
        self.pull_bytes = Counter(
            f"{ns}_kvfabric_pull_bytes",
            "Wire bytes fetched over FetchKV", registry=self.registry)
        self.pull_seconds = Histogram(
            f"{ns}_kvfabric_pull_seconds",
            "FetchKV fetch latency (RPC start -> snapshot decoded and "
            "geometry-validated)", buckets=SWAP_BUCKETS,
            registry=self.registry)
        self.coalesced = Counter(
            f"{ns}_kvfabric_coalesced",
            "Concurrent same-digest misses served by another thread's "
            "in-flight fetch (single-flight)", registry=self.registry)
        self.cost_gate_skips = Counter(
            f"{ns}_kvfabric_cost_gate_skips",
            "Pulls skipped because the fetch-time estimate exceeded the "
            "local recompute estimate", registry=self.registry)
        self.degrades = Counter(
            f"{ns}_kvfabric_degrades",
            "Pull attempts degraded to a local prefill (NOT_FOUND, "
            "chaos, transport, corrupt wire, budget refusal, admission "
            "rejection)", registry=self.registry)
        self.recompute_tokens_saved = Counter(
            f"{ns}_kvfabric_recompute_tokens_saved",
            "Prefill tokens pulls did NOT recompute (the fabric's work "
            "saved, in tokens)", registry=self.registry)
        self._last: Dict[str, int] = {}

    def observe_pull(self, seconds: float, nbytes: int) -> None:
        self.pull_seconds.observe(max(0.0, seconds))

    def poll(self, fabric) -> None:
        """Sample a KVFabric (control-loop / poller hook)."""
        self._advance(self.pulls, "p", fabric.pulls)
        self._advance(self.pull_bytes, "pb", fabric.pull_bytes)
        self._advance(self.coalesced, "co", fabric.coalesced)
        self._advance(self.cost_gate_skips, "cg", fabric.cost_gate_skips)
        self._advance(self.degrades, "dg", fabric.degrades)
        self._advance(self.recompute_tokens_saved, "sv",
                      fabric.recompute_tokens_saved)


class ModelStoreMetrics(_Polled):
    """Weight-tier telemetry (``_modelstore_*``;
    ``tpulab_torch.modelstore``): resident and host-tier model gauges,
    weight swap counters and latency distributions, evictions and cold
    rebuilds.  Latencies are event-driven (the multiplexer's
    ``metrics=``); counters and gauges advance through :meth:`poll`."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.resident_models = Gauge(
            f"{ns}_modelstore_resident_models",
            "Models currently HBM-resident (hot)", registry=self.registry)
        self.host_tier_models = Gauge(
            f"{ns}_modelstore_host_tier_models",
            "Models parked in the host weight tier (cold)",
            registry=self.registry)
        self.hbm_bytes = Gauge(
            f"{ns}_modelstore_hbm_bytes",
            "Weight bytes accounted against the HBM budget (hot models "
            "plus unsettled swaps)", registry=self.registry)
        self.host_bytes = Gauge(
            f"{ns}_modelstore_host_bytes",
            "Host-tier weight bytes resident", registry=self.registry)
        self.swap_ins = Counter(
            f"{ns}_modelstore_swap_ins",
            "Models promoted host->device (bit-exact weight restores)",
            registry=self.registry)
        self.swap_outs = Counter(
            f"{ns}_modelstore_swap_outs",
            "Model weight snapshots landed device->host (write-behind)",
            registry=self.registry)
        self.swap_in_bytes = Counter(
            f"{ns}_modelstore_swap_in_bytes",
            "Weight bytes copied host->device", registry=self.registry)
        self.swap_out_bytes = Counter(
            f"{ns}_modelstore_swap_out_bytes",
            "Weight bytes copied device->host", registry=self.registry)
        self.swap_in_seconds = Histogram(
            f"{ns}_modelstore_swap_in_seconds",
            "Swap-in latency (host pop -> weights attached)",
            buckets=SWAP_BUCKETS, registry=self.registry)
        self.swap_out_seconds = Histogram(
            f"{ns}_modelstore_swap_out_seconds",
            "Swap-out latency (detach -> host-tier resident; write-"
            "behind, so this is BEHIND the request path)",
            buckets=SWAP_BUCKETS, registry=self.registry)
        self.evictions = Counter(
            f"{ns}_modelstore_evictions",
            "Models pushed out of HBM by budget pressure",
            registry=self.registry)
        self.cold_rebuilds = Counter(
            f"{ns}_modelstore_cold_rebuilds",
            "Acquires served by a fresh build (weights in no tier: "
            "degraded swaps, host-budget refusals)",
            registry=self.registry)
        self.swap_failures = Counter(
            f"{ns}_modelstore_swap_failures",
            "Weight swaps degraded to the cold-rebuild path (chaos, "
            "transfer errors)", registry=self.registry)
        self.swap_drops = Counter(
            f"{ns}_modelstore_swap_drops",
            "Weight snapshots the host tier's budget refused (sustained "
            "count = host budget undersized)", registry=self.registry)
        self.host_evictions = Counter(
            f"{ns}_modelstore_host_evictions",
            "Host-tier LRU models pushed out by budget pressure",
            registry=self.registry)
        self._last: Dict[str, int] = {}

    def observe_swap_in(self, seconds: float, nbytes: int) -> None:
        self.swap_in_seconds.observe(max(0.0, seconds))

    def observe_swap_out(self, seconds: float, nbytes: int) -> None:
        self.swap_out_seconds.observe(max(0.0, seconds))

    def poll(self, mux) -> None:
        """Sample a WeightMultiplexer (control-loop / poller hook)."""
        self._advance(self.swap_ins, "si", mux.swap_ins)
        self._advance(self.swap_outs, "so", mux.swap_outs)
        self._advance(self.swap_in_bytes, "sib", mux.swap_in_bytes)
        self._advance(self.swap_out_bytes, "sob", mux.swap_out_bytes)
        self._advance(self.evictions, "ev", mux.evictions)
        self._advance(self.cold_rebuilds, "cr", mux.cold_rebuilds)
        self._advance(self.swap_failures, "sf", mux.swap_failures)
        self._advance(self.swap_drops, "sd", mux.swap_drops)
        self._advance(self.host_evictions, "he", mux.store.evictions)
        self.resident_models.set(len(mux.resident_models()))
        self.host_tier_models.set(len(mux.host_models()))
        self.hbm_bytes.set(mux.hbm_bytes_in_use)
        self.host_bytes.set(mux.store.bytes_used)


class HBMMetrics(_Polled):
    """Device-memory economy telemetry (``_hbm_*``; ``tpulab_torch.hbm``):
    per-tenant occupancy and claim-count gauges, the headroom gauge and
    the pressure-protocol counters, advanced by :meth:`poll` over an
    ``HBMArbiter``."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.capacity_bytes = Gauge(
            f"{ns}_hbm_capacity_bytes",
            "Device-HBM budget the arbiter trades within",
            registry=self.registry)
        self.headroom_bytes = Gauge(
            f"{ns}_hbm_headroom_bytes",
            "THE headroom number: capacity minus every tenant's ledger "
            "claims (negative = over-committed discovery)",
            registry=self.registry)
        self.tenant_bytes = Gauge(
            f"{ns}_hbm_tenant_bytes",
            "Ledger bytes claimed per tenant (weights / kv / scratch)",
            ["tenant"], registry=self.registry)
        self.tenant_claims = Gauge(
            f"{ns}_hbm_tenant_claims",
            "Live ledger claims per tenant (models resident, pools, "
            "measured jits)", ["tenant"], registry=self.registry)
        self.pressure_events = Counter(
            f"{ns}_hbm_pressure_events",
            "Pressure rounds run (a request found no free headroom)",
            registry=self.registry)
        self.demotions = Counter(
            f"{ns}_hbm_demotions",
            "Pressure rounds where the KV tenant reclaimed (idle KV "
            "demoted to the host tier, pool shrunk)",
            registry=self.registry)
        self.evictions = Counter(
            f"{ns}_hbm_evictions",
            "Pressure rounds where the weights tenant reclaimed (cold "
            "unleased models swapped out)", registry=self.registry)
        self.denials = Counter(
            f"{ns}_hbm_denials",
            "Requests denied (timeout or nothing reclaimable) — the "
            "requester degraded to its static-budget behavior",
            registry=self.registry)
        self.grants = Counter(
            f"{ns}_hbm_grants", "Requests granted ledger bytes",
            registry=self.registry)
        self._last: Dict[str, int] = {}

    def poll(self, arbiter) -> None:
        """Sample an HBMArbiter (control-loop / poller hook)."""
        self.capacity_bytes.set(arbiter.capacity_bytes)
        self.headroom_bytes.set(arbiter.free_hbm_bytes)
        led = arbiter.ledger
        for tenant in led.tenants():
            self.tenant_bytes.labels(tenant=tenant).set(
                led.tenant_bytes(tenant))
            self.tenant_claims.labels(tenant=tenant).set(
                led.tenant_claims(tenant))
        self._advance(self.pressure_events, "pe", arbiter.pressure_events)
        self._advance(self.demotions, "dem", arbiter.demotions_forced)
        self._advance(self.evictions, "ev", arbiter.evictions_forced)
        self._advance(self.denials, "den", arbiter.denials)
        self._advance(self.grants, "gr", arbiter.grants)


class AdmissionMetrics:
    """Admission-control telemetry (``_admission_*``): admitted / rejected
    / shed counters by tenant (and rejection reason), the queue-wait
    distribution of admitted requests, queue and in-flight gauges."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.admitted = Counter(
            f"{ns}_admission_admitted_total", "Requests admitted",
            ["tenant"], registry=self.registry)
        self.rejected = Counter(
            f"{ns}_admission_rejected_total",
            "Requests rejected at admission, by reason (global_rate, "
            "tenant_rate, queue_full, shed, deadline, queue_timeout, "
            "chaos)", ["reason", "tenant"], registry=self.registry)
        self.shed = Counter(
            f"{ns}_admission_shed_total",
            "Queued requests shed for a higher-priority arrival",
            ["tenant"], registry=self.registry)
        self.queue_wait = Histogram(
            f"{ns}_admission_queue_wait_seconds",
            "Fair-queue wait of ADMITTED requests (arrival -> dispatch)",
            buckets=TTFT_BUCKETS, registry=self.registry)
        self.queue_depth = Gauge(
            f"{ns}_admission_queue_depth",
            "Requests waiting in the admission fair queue",
            registry=self.registry)
        self.inflight = Gauge(
            f"{ns}_admission_inflight",
            "Admitted requests currently holding a ticket",
            registry=self.registry)
        self._queue_wait_res = _Reservoir()

    def note_admitted(self, tenant: str, queue_wait_s: float) -> None:
        self.admitted.labels(tenant=tenant).inc()
        self.queue_wait.observe(max(0.0, queue_wait_s))
        self._queue_wait_res.observe(max(0.0, queue_wait_s))

    def note_rejected(self, reason: str, tenant: str) -> None:
        self.rejected.labels(reason=reason, tenant=tenant).inc()
        if reason == "shed":
            self.shed.labels(tenant=tenant).inc()

    def set_pressure(self, queued: int, inflight: int) -> None:
        self.queue_depth.set(queued)
        self.inflight.set(inflight)

    def queue_wait_quantiles(self) -> Dict[str, float]:
        return {f"p{int(q * 100)}": self._queue_wait_res.quantile(q)
                for q in _QUANTILES}


class ChaosMetrics:
    """Fault-injection telemetry: one counter per (trip point, action),
    fed by :func:`tpulab_torch.chaos.set_observer` (:meth:`install`)."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        self.injections = Counter(
            f"{namespace}_chaos_injections_total",
            "Chaos rules fired, keyed by trip point and action",
            ["point", "action"], registry=self.registry)

    def observe(self, point: str, action: str) -> None:
        self.injections.labels(point=point, action=action).inc()

    def install(self) -> "ChaosMetrics":
        """Register as the process-wide chaos fire observer."""
        from tpulab_torch import chaos
        chaos.set_observer(self.observe)
        return self

    def uninstall(self) -> None:
        from tpulab_torch import chaos
        chaos.set_observer(None)


class SLOMetrics:
    """Per-tenant SLO telemetry (``_slo_*``; :class:`tpulab_torch.obs.
    SLOTracker`): request / error / latency-breach counters per (tenant,
    request class) and the multi-window burn-rate gauges."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.requests = Counter(
            f"{ns}_slo_requests_total",
            "SLO-accounted requests per tenant and request class "
            "(client-cancelled requests are excluded — neither good "
            "nor bad)", ["tenant", "request_class"],
            registry=self.registry)
        self.errors = Counter(
            f"{ns}_slo_errors_total",
            "Requests that failed the availability objective (terminal "
            "outcome not SUCCESS), per tenant and request class",
            ["tenant", "request_class"], registry=self.registry)
        self.latency_breaches = Counter(
            f"{ns}_slo_latency_breaches_total",
            "Requests whose end-to-end latency exceeded the objective, "
            "per tenant and request class",
            ["tenant", "request_class"], registry=self.registry)
        self.availability_burn = Gauge(
            f"{ns}_slo_availability_burn_rate",
            "Availability error-budget burn rate per tenant/class/"
            "window (1.0 = budget exhausted exactly over the objective "
            "period; >1 = burning early)",
            ["tenant", "request_class", "window"],
            registry=self.registry)
        self.latency_burn = Gauge(
            f"{ns}_slo_latency_burn_rate",
            "Latency error-budget burn rate per tenant/class/window",
            ["tenant", "request_class", "window"],
            registry=self.registry)

    def note_request(self, tenant: str, request_class: str,
                     error: bool, breach: bool) -> None:
        self.requests.labels(tenant=tenant,
                             request_class=request_class).inc()
        if error:
            self.errors.labels(tenant=tenant,
                               request_class=request_class).inc()
        if breach:
            self.latency_breaches.labels(
                tenant=tenant, request_class=request_class).inc()

    def set_burn(self, tenant: str, request_class: str, window: str,
                 availability: float, latency: float) -> None:
        self.availability_burn.labels(
            tenant=tenant, request_class=request_class,
            window=window).set(float(availability))
        self.latency_burn.labels(
            tenant=tenant, request_class=request_class,
            window=window).set(float(latency))


class FederationMetrics:
    """Federated fleet view (``_fed_*``; :class:`tpulab_torch.fleet.
    FleetObserver`): each fleetz scrape refreshes these replica-labelled
    gauges from the replicas' Status RPCs, so ONE /metrics endpoint on
    the observer node shows every replica's load / headroom / drain
    state side by side.  Children of replicas that leave the snapshot
    are pruned on the next scrape (a retired replica stops exporting)."""

    def __init__(self, namespace: str = "tpulab",
                 registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        ns = namespace
        self.scrapes = Counter(
            f"{ns}_fed_scrapes_total",
            "Federated fleet snapshots assembled by the observer",
            registry=self.registry)
        self.scrape_seconds = Gauge(
            f"{ns}_fed_scrape_seconds",
            "Wall-clock cost of the last federated snapshot (all "
            "replica Status RPCs + assembly)", registry=self.registry)
        self.replicas = Gauge(
            f"{ns}_fed_replicas",
            "Replicas in the last federated snapshot",
            registry=self.registry)
        self.up = Gauge(
            f"{ns}_fed_replica_up",
            "1 when the replica answered its Status RPC in the last "
            "snapshot, else 0", ["replica"], registry=self.registry)
        self.inflight = Gauge(
            f"{ns}_fed_replica_inflight",
            "Server-reported in-flight requests per replica",
            ["replica"], registry=self.registry)
        self.queued = Gauge(
            f"{ns}_fed_replica_queued",
            "Server-reported queued requests per replica",
            ["replica"], registry=self.registry)
        self.free_hbm_bytes = Gauge(
            f"{ns}_fed_replica_free_hbm_bytes",
            "Server-reported free HBM headroom per replica",
            ["replica"], registry=self.registry)
        self.free_kv_pages = Gauge(
            f"{ns}_fed_replica_free_kv_pages",
            "Server-reported free KV-cache pages per replica",
            ["replica"], registry=self.registry)
        self.draining = Gauge(
            f"{ns}_fed_replica_draining",
            "1 while the replica reports itself draining, else 0",
            ["replica"], registry=self.registry)
        self.prefix_hits = Gauge(
            f"{ns}_fed_replica_prefix_hits",
            "Server-reported lifetime prefix-cache hits per replica",
            ["replica"], registry=self.registry)
        self.prefix_lookups = Gauge(
            f"{ns}_fed_replica_prefix_lookups",
            "Server-reported lifetime prefix-cache lookups per replica",
            ["replica"], registry=self.registry)
        self.resident_models = Gauge(
            f"{ns}_fed_replica_resident_models",
            "Models resident in device memory per replica",
            ["replica"], registry=self.registry)
        self._seen: set = set()
        self._per_replica = (self.up, self.inflight, self.queued,
                             self.free_hbm_bytes, self.free_kv_pages,
                             self.draining, self.prefix_hits,
                             self.prefix_lookups, self.resident_models)

    # -- hooks (tpulab_torch.fleet.observer.FleetObserver) ---------------
    def observe_scrape(self, seconds: float, replicas: int) -> None:
        self.scrapes.inc()
        self.scrape_seconds.set(float(seconds))
        self.replicas.set(int(replicas))

    def set_replica(self, replica: str, up: bool, inflight: int = 0,
                    queued: int = 0, free_hbm_bytes: int = 0,
                    free_kv_pages: int = 0, draining: bool = False,
                    prefix_hits: int = 0, prefix_lookups: int = 0,
                    resident_models: int = 0) -> None:
        self._seen.add(replica)
        self.up.labels(replica=replica).set(1 if up else 0)
        self.inflight.labels(replica=replica).set(int(inflight))
        self.queued.labels(replica=replica).set(int(queued))
        self.free_hbm_bytes.labels(replica=replica).set(
            int(free_hbm_bytes))
        self.free_kv_pages.labels(replica=replica).set(
            int(free_kv_pages))
        self.draining.labels(replica=replica).set(1 if draining else 0)
        self.prefix_hits.labels(replica=replica).set(int(prefix_hits))
        self.prefix_lookups.labels(replica=replica).set(
            int(prefix_lookups))
        self.resident_models.labels(replica=replica).set(
            int(resident_models))

    def prune(self, keep) -> None:
        """Drop label children for replicas no longer in the snapshot —
        a retired replica must stop exporting, not freeze at its last
        value."""
        for replica in self._seen - set(keep):
            for g in self._per_replica:
                g.remove(replica)
        self._seen &= set(keep)


class MultiRegistryCollector:
    """Several registries exposed through one (hence one /metrics port);
    their family names are disjoint by construction (``_request_*`` /
    ``_llm_*`` / ``_admission_*`` / ``_kv_tier_*`` / ``_chaos_*`` ...)."""

    def __init__(self, registries: Sequence[CollectorRegistry]):
        self._registries = list(registries)

    def collect(self):
        for reg in self._registries:
            yield from reg.collect()


def start_metrics_server(metrics, port: int = 9090, addr: str = "0.0.0.0"):
    """Serve ``/metrics`` over HTTP on a daemon thread.

    ``metrics`` is a metric set with a ``registry`` attribute, a bare
    :class:`CollectorRegistry`, or a list / tuple of either (aggregated
    behind ONE port).  ``port=0`` binds a free port.  Returns ``(server,
    thread)`` as prometheus_client does: ``server.server_port`` is the
    bound port; ``server.shutdown(); server.server_close()`` stops it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if isinstance(metrics, (list, tuple)):
        registry = CollectorRegistry()
        registry.register(MultiRegistryCollector(
            [getattr(m, "registry", m) for m in metrics]))
    else:
        registry = getattr(metrics, "registry", metrics)

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0] == "/favicon.ico":
                self.send_response(404)
                self.end_headers()
                return
            body = generate_latest(registry)
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE_LATEST)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # no access log on stderr
            pass

    server = ThreadingHTTPServer((addr, int(port)), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="metrics-http", daemon=True)
    thread.start()
    return server, thread
