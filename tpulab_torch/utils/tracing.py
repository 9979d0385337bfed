"""Tracing/profiling hooks (the port of ``tpulab/utils/tracing.py``).

- :func:`trace` / :func:`annotate` — ``torch.profiler`` around a block
  (CPU and, on a CUDA run, the device's kernels through CUPTI; a Chrome
  trace file lands in the directory) and named regions inside it, which
  are also NVTX ranges on a CUDA run (tpulab wraps ``jax.profiler``).
  :func:`profiler_session` / :func:`claim_profiler` keep the process to
  one capture at a time.
- :class:`StageTimer` — the TimedBenchmarkWorkspace pattern as a reusable
  context: named stage durations, synchronizing the device of a CUDA
  tensor at stage boundaries.
- :class:`TraceContext` / :class:`ChromeTraceRecorder` /
  :func:`merge_chrome_traces` — request-scoped distributed tracing: the
  client mints a trace id, carries it over the RPC (request field +
  metadata), both processes tag their spans with it, and the saved traces
  merge into ONE chrome://tracing / perfetto timeline.  These are pure
  Python, as in tpulab.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterable, Optional

#: gRPC metadata key carrying the trace id (request-field carriage is the
#: primary channel; the metadata rides along for middleboxes/interceptors
#: that never parse the payload)
TRACE_METADATA_KEY = "tpulab-trace-id"


def mint_trace_id() -> str:
    """16-hex request-scoped trace id (random; no coordination needed)."""
    import uuid
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One request's trace identity, propagated client -> server.

    The client mints it once per logical request (NOT per attempt — a
    failover replay keeps the id, so all attempts line up under one
    request in the merged timeline); servers recover it from the request
    message's ``trace_id`` field or the ``tpulab-trace-id`` gRPC metadata.
    """

    __slots__ = ("trace_id",)

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or mint_trace_id()

    def metadata(self) -> tuple:
        """gRPC call metadata carrying this context."""
        return ((TRACE_METADATA_KEY, self.trace_id),)

    @classmethod
    def from_metadata(cls, metadata: Optional[Iterable]) -> Optional["TraceContext"]:
        """Parse from an iterable of (key, value) pairs; None when absent."""
        for k, v in metadata or ():
            if k == TRACE_METADATA_KEY and v:
                return cls(str(v))
        return None

    @classmethod
    def of_request(cls, request, grpc_context=None) -> Optional["TraceContext"]:
        """Server-side recovery: the request's ``trace_id`` field first,
        else the invocation metadata; None for untraced requests."""
        rid = getattr(request, "trace_id", "")
        if rid:
            return cls(rid)
        if grpc_context is not None and hasattr(grpc_context,
                                                "invocation_metadata"):
            try:
                return cls.from_metadata(grpc_context.invocation_metadata())
            except Exception:  # pragma: no cover - exotic grpc shims
                return None
        return None

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id})"


def _default_trace_dir() -> str:
    import tempfile
    return os.path.join(tempfile.gettempdir(), "tpulab_torch-trace")


def _cuda_on() -> bool:
    import torch
    return torch.cuda.is_available()


#: torch.profiler runs one session a process (a second one started while
#: the first runs ends both at its stop), so the port's captures take
#: turns through this claim
_PROFILER_LOCK = threading.Lock()
_profiler_owner = None


def profiler_running() -> bool:
    """True while any torch profiler session runs in the process, on any
    thread: torch's process-wide flag (set by every ``torch.profiler`` and
    autograd profiler start) or the calling thread's own state."""
    import torch
    from torch.autograd import profiler as autograd_profiler
    return (bool(getattr(autograd_profiler, "_is_profiler_enabled", False))
            or torch._C._autograd._profiler_enabled())


def claim_profiler(owner) -> bool:
    """Take the process's one profiler session for ``owner``; False when
    a capture of the port holds it or any profiler session already runs,
    whichever thread started it."""
    global _profiler_owner
    with _PROFILER_LOCK:
        if _profiler_owner is not None or profiler_running():
            return False
        _profiler_owner = owner
        return True


def release_profiler(owner) -> None:
    """Give the session back (a no-op unless ``owner`` holds it)."""
    global _profiler_owner
    with _PROFILER_LOCK:
        if _profiler_owner == owner:
            _profiler_owner = None


def device_event_count(prof) -> int:
    """The device-side events (kernels, copies, fills) that a stopped
    ``torch.profiler.profile`` recorded."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda)


def device_busy_ms(prof) -> float:
    """The union of a stopped ``torch.profiler.profile``'s device kernel
    intervals (ms): kernels of several streams may overlap, so their sum
    can exceed the wall time."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def cuda_activity_requested(activities) -> bool:
    """Whether a session of these activities (None: torch's default, every
    supported one) traces the card; raises RuntimeError when it asks for
    CUDA activity that this torch.profiler cannot take."""
    from torch.profiler import ProfilerActivity, supported_activities
    if activities is None:
        return ProfilerActivity.CUDA in supported_activities() and _cuda_on()
    if ProfilerActivity.CUDA not in activities:
        return False
    if ProfilerActivity.CUDA not in supported_activities():
        raise RuntimeError("this torch.profiler cannot trace CUDA activity")
    return True


@contextlib.contextmanager
def profiler_session(**kw):
    """``torch.profiler.profile(**kw)`` under the process's claim: raises
    RuntimeError while another capture (a batcher's armed Debug capture,
    another session on any thread) holds it.

    A session that traces the card launches one 1-element fill as its
    probe and waits for the device before it stops; one that then holds
    no device event lost the card's activity, and raises RuntimeError
    rather than pass for a CPU-only trace."""
    import torch
    from torch.profiler import profile

    cuda = cuda_activity_requested(kw.get("activities"))
    owner = object()
    if not claim_profiler(owner):
        raise RuntimeError("a profiler capture is already armed")
    try:
        with profile(**kw) as prof:
            if cuda:
                torch.zeros(1, device="cuda")
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        release_profiler(owner)
    if cuda and not device_event_count(prof):
        raise RuntimeError("the profiler session traced no CUDA activity "
                           "(not even its probe): the card's trace was "
                           "lost")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace around a block::

        with tracing.trace(out_dir):
            runner.infer(**arrays).result()
        # -> <out_dir>/trace.json (chrome://tracing, ui.perfetto.dev)

    On a machine with a CUDA device the device activity is always traced
    (there is no CPU-only stand-in there); ``log_dir`` defaults to a
    directory under the temp dir."""
    from torch.profiler import ProfilerActivity

    log_dir = log_dir or _default_trace_dir()
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if _cuda_on():
        acts.append(ProfilerActivity.CUDA)
    with profiler_session(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace; an NVTX range too on a CUDA run."""
    import torch
    from torch.profiler import record_function

    nvtx = _cuda_on()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(target) -> None:
    """Wait for the device work producing ``target`` (a tensor or a
    nested list / tuple / dict of them): CUDA tensors synchronize their
    device; CPU tensors are already computed."""
    import torch
    if isinstance(target, torch.Tensor):
        if target.is_cuda:
            torch.cuda.synchronize(target.device)
    elif isinstance(target, dict):
        for v in target.values():
            _sync(v)
    elif isinstance(target, (list, tuple)):
        for v in target:
            _sync(v)


class StageTimer:
    """Named stage timing (the reference's cudaEvent H2D/compute/D2H split,
    generalized).  Each stage that launches device
    work MUST name a ``sync_on`` target (PyTorch's CUDA work is
    asynchronous) — otherwise the stage records only dispatch time and its
    device time bleeds into the next stage::

        t = StageTimer()
        holder = {}
        with t.stage("h2d"):
            holder["dev"] = copy_to_device(host)
        t.sync("h2d", holder["dev"])              # or stage(..., sync_on=...)
        with t.stage("compute", sync_on_fn=lambda: out):
            out = compiled(holder["dev"])
        t.stages_ms  # {"h2d": ..., "compute": ...}
    """

    def __init__(self):
        self.stages_ms: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None, sync_on_fn=None):
        t0 = time.perf_counter()
        yield
        target = sync_on_fn() if sync_on_fn is not None else sync_on
        if target is not None:
            _sync(target)
        self.stages_ms[name] = self.stages_ms.get(name, 0.0) + \
            (time.perf_counter() - t0) * 1e3

    def sync(self, name: str, target) -> None:
        """Fold a late device sync into an already-recorded stage."""
        t0 = time.perf_counter()
        _sync(target)
        self.stages_ms[name] = self.stages_ms.get(name, 0.0) + \
            (time.perf_counter() - t0) * 1e3

    @property
    def total_ms(self) -> float:
        return sum(self.stages_ms.values())


class ChromeTraceRecorder:
    """Host-side request-lifecycle trace in Chrome trace-event format
    (load in chrome://tracing or ui.perfetto.dev) — the chrome-trace
    tooling SURVEY §5 notes the reference lacked.

    The serving path (``build_infer_service(trace=recorder)``) records one
    span per request stage (batch_wait / pipeline / respond) on the
    handling thread's row; ``save()`` writes the JSON trace.  Collection
    is thread-safe and bounded (a ring of ``max_events`` — a long-running
    server keeps the most recent window rather than growing without
    limit)."""

    def __init__(self, max_events: int = 100_000,
                 process_name: Optional[str] = None):
        import collections
        self._events = collections.deque(maxlen=max_events)
        self._lock = threading.Lock()
        #: events the ring has discarded (oldest-first) to stay bounded —
        #: a saved trace that silently lost its head reads as "the server
        #: was idle before this window", so the drop count rides save()'s
        #: otherData and the first drop warns once
        self.dropped_events = 0
        self._warned_drop = False
        # paired clock anchor: _epoch0 is the wall-clock instant at which
        # perf_counter read _t0.  Event ts stay perf_counter-relative (sub-
        # microsecond deltas within the process); the anchor rides the
        # saved file so merge_chrome_traces can re-base traces from
        # DIFFERENT processes onto one wall-clock axis.
        self._t0 = time.perf_counter()
        self._epoch0 = time.time()
        self._pid = os.getpid()
        self.process_name = process_name

    def add_span(self, name: str, start_s: float, dur_s: float,
                 tid: Optional[int] = None, **args) -> None:
        """One complete ('X') event; ``start_s`` is a time.perf_counter
        value from the same process."""
        ev = {"name": name, "ph": "X", "pid": self._pid,
              "tid": tid if tid is not None else threading.get_ident(),
              "ts": round((start_s - self._t0) * 1e6, 3),
              "dur": round(dur_s * 1e6, 3)}
        if args:
            ev["args"] = args
        with self._lock:
            self._append_locked(ev)

    def _append_locked(self, ev: dict) -> None:
        """Ring append that COUNTS what the bounded deque would silently
        discard (deque(maxlen=N) drops the oldest event on overflow)."""
        if len(self._events) == self._events.maxlen:
            self.dropped_events += 1
            if not self._warned_drop:
                self._warned_drop = True
                import logging
                logging.getLogger("tpulab_torch.tracing").warning(
                    "ChromeTraceRecorder ring full (max_events=%d): oldest "
                    "events are being dropped; saved traces carry the count "
                    "in otherData.dropped_events", self._events.maxlen)
        self._events.append(ev)

    def add_counter(self, name: str, ts_s: float, **values) -> None:
        """One counter ('C') sample; ``ts_s`` is a time.perf_counter value
        from the same process.  Perfetto/chrome render each name as a
        stacked counter track — the batcher samples ``decode_block``
        (tokens delivered + block size K per fused dispatch) so the
        tokens-per-dispatch shape is visible on the same timeline as the
        request spans it explains."""
        ev = {"name": name, "ph": "C", "pid": self._pid, "tid": 0,
              "ts": round((ts_s - self._t0) * 1e6, 3),
              "args": {k: float(v) for k, v in values.items()}}
        with self._lock:
            self._append_locked(ev)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def save(self, path: str) -> str:
        """Atomic write (tmp + rename): a concurrent reader — e.g. the
        merge step polling another process's autosaved trace — never
        observes a torn JSON document."""
        import json
        with self._lock:
            events = list(self._events)
            dropped = self.dropped_events
        if self.process_name:
            events.insert(0, {"name": "process_name", "ph": "M",
                              "pid": self._pid, "tid": 0,
                              "args": {"name": self.process_name}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"epoch_origin_s": self._epoch0,
                             "pid": self._pid,
                             "dropped_events": dropped}}
        tmp = f"{path}.tmp.{self._pid}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def merge_chrome_traces(out_path: str, *paths: str) -> str:
    """Merge per-process Chrome trace files into ONE timeline.

    Each input carries its recorder's ``epoch_origin_s`` anchor (wall
    clock at its events' ts=0); events are shifted by the anchor deltas so
    spans from different processes line up on one wall-clock axis (cross-
    machine accuracy = NTP skew — fine for the >=100us spans recorded
    here).  Events keep their pid, so perfetto shows one process track per
    input.  Metadata ('M') events pass through unshifted."""
    import json
    docs = []
    for p in paths:
        with open(p) as f:
            docs.append(json.load(f))
    origins = [float(d.get("otherData", {}).get("epoch_origin_s", 0.0))
               for d in docs]
    base = min((o for o in origins if o), default=0.0)
    merged = []
    for doc, origin in zip(docs, origins):
        shift_us = (origin - base) * 1e6 if origin else 0.0
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") != "M":
                ev = dict(ev, ts=round(ev.get("ts", 0.0) + shift_us, 3))
            merged.append(ev)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms",
                   "otherData": {"epoch_origin_s": base,
                                 "merged_from": len(docs)}}, f)
    return out_path
