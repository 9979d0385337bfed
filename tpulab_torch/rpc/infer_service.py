"""TRTIS-protocol inference service + remote client (the port of
``tpulab/rpc/infer_service.py``; reference pybind BasicInferService
infer.cc:547-678 and PyRemoteInferenceManager/PyInferRemoteRunner
infer.cc:124-404).

Serving path per request (reference InferContext infer.cc:596-642):
proto tensors -> staging bindings -> InferRunner pipeline -> raw-output
response, with the response built on the post stage.  Generation streams
tokens from the port's ``ContinuousBatcher`` (paged) or
:class:`~tpulab_torch.engine.generation.GenerationEngine` (dense).

The server half runs without grpc or protobuf: the messages are the
port's own (``rpc/protos/inference_pb2``) and
:func:`build_infer_service` returns a
:class:`~tpulab_torch.rpc.server.Server` whose behaviors serve in process
(``Server.invoke`` / ``invoke_stream``) or, where grpc is installed, over
the network.  The client half (:class:`RemoteInferenceManager`,
:class:`GenerateStreamClient`, :class:`StreamInferClient`) imports grpc
when it is constructed.

Observability: ``flight=`` (a :class:`~tpulab_torch.obs.FlightRecorder`)
records one wide event per Infer and Generate request, ``watchdog=`` (a
:class:`~tpulab_torch.utils.watchdog.DeviceWatchdog`) gates the Health
RPC's readiness, and the ``Debug`` RPC answers the
:func:`~tpulab_torch.obs.debug_snapshot` document, with an on-demand
``torch.profiler`` capture (``profile_ticks``).

The fleet: ``fleet=`` (a :class:`~tpulab_torch.fleet.FleetController`)
adds the control plane's ``fleet`` section to the Debug snapshot;
``kvfabric=`` (a :class:`~tpulab_torch.kvfabric.KVFabric`) lets a
Generate request whose prompt homes on another replica pull that
replica's finished prefill instead of recomputing it, and the
``FetchKV`` RPC serves this replica's published prefills to the fleet.
A ``request_class='batch'`` Generate request rides the paged batcher's
offline batch lane.
"""

from __future__ import annotations

import concurrent.futures as _f
import logging
import threading
import time as _time
from typing import Any, Dict, Optional

import numpy as np

from tpulab_torch import chaos
from tpulab_torch.core.deadline import Deadline, DeadlineExceeded
from tpulab_torch.core.resources import Resources
from tpulab_torch.rpc.client import (ClientExecutor, ClientStreaming,
                                     ClientUnary)
from tpulab_torch.rpc.context import Context, StreamingContext
from tpulab_torch.rpc.executor import Executor
from tpulab_torch.rpc.protos import inference_pb2 as pb
from tpulab_torch.rpc.server import AsyncService, Server
from tpulab_torch.utils.tracing import TraceContext

log = logging.getLogger("tpulab_torch.rpc")

SERVICE_NAME = "tpulab.inference.GRPCService"
SERVER_VERSION = "tpulab-0.1"

#: decode tokens per trace span — the "each decode chunk" granularity of
#: the request timeline
TRACE_DECODE_CHUNK = 8

# -- tensor <-> proto ---------------------------------------------------------
def tensor_to_proto(name: str, array: np.ndarray) -> pb.TensorProto:
    array = np.ascontiguousarray(array)
    return pb.TensorProto(name=name, dtype=array.dtype.name,
                          dims=list(array.shape), raw_data=array.tobytes())


def proto_to_tensor(t: pb.TensorProto) -> np.ndarray:
    """Zero-copy view over the message's ``raw_data``.

    Contract: the returned array is READ-ONLY (in-place writes raise) and
    aliases the request message — it must not outlive request handling.
    Runners only read it (the staging copy), so the view is safe on the
    serving path; callers needing a writable or long-lived tensor must
    ``.copy()`` it themselves.
    """
    return np.frombuffer(t.raw_data, dtype=np.dtype(t.dtype)).reshape(
        tuple(t.dims))


class InferResources(Resources):
    """Service resources: manager + optional batched runners + metrics
    (reference Resources bundle handed to contexts)."""

    def __init__(self, manager, batching: bool = False,
                 batch_window_s: float = 0.002, metrics=None,
                 generation_engines: Optional[Dict[str, object]] = None,
                 watchdog=None, trace=None, admission=None,
                 role: str = "unified", modelstore=None, hbm=None,
                 flight=None, fleet=None, kvfabric=None):
        self.manager = manager
        #: optional :class:`~tpulab_torch.kvfabric.KVFabric` — fleet-wide
        #: prefix-KV pulls (docs/SERVING.md "Fleet KV fabric"): a local
        #: prefix miss whose digest homes elsewhere fetches the finished
        #: prefill from its home replica instead of recomputing it.
        #: None = fabric off (one is-None branch per paged request).
        self.kvfabric = kvfabric
        #: optional fleet control plane handle (anything with
        #: ``snapshot()``, normally a
        #: :class:`~tpulab_torch.fleet.FleetController`): a
        #: router-colocated replica reports election + supervision +
        #: autoscaling state in its Debug snapshot.  None = not a
        #: control-plane node.
        self.fleet = fleet
        #: optional :class:`~tpulab_torch.utils.metrics.InferenceMetrics`
        #: (or any ``observe_request`` observer)
        self.metrics = metrics
        #: optional :class:`~tpulab_torch.obs.FlightRecorder` — one
        #: tail-sampled wide event per request, assembled here at
        #: completion.  None = disarmed: one is-None branch per request.
        self.flight = flight
        #: optional :class:`~tpulab_torch.utils.watchdog.DeviceWatchdog`:
        #: an unhealthy device turns Health's readiness off
        self.watchdog = watchdog
        #: optional tpulab_torch.hbm.HBMArbiter — the unified device-memory
        #: economy.  Status reports its single headroom number
        #: (free_hbm_bytes) so routers and admission see ONE honest
        #: figure instead of per-tenant estimates.  None = no arbiter.
        self.hbm = hbm
        #: optional tpulab_torch.modelstore.WeightMultiplexer — requests
        #: for a managed model acquire a lease (swap the weights in if
        #: cold, pin them hot for the request's duration); Status reports
        #: resident vs host-tier models.  None = single-model serving.
        self.modelstore = modelstore
        #: disaggregated serving role ("prefill" | "decode" | "unified"),
        #: reported over the Status RPC; advisory, the service serves
        #: whatever arrives
        self.role = role
        #: optional tpulab_torch.utils.tracing.ChromeTraceRecorder
        self.trace = trace
        #: optional tpulab_torch.serving.AdmissionController — the QoS
        #: frontend gate (None = admission off: one is-None branch)
        self.admission = admission
        self.batching = batching
        self.generation_engines = generation_engines or {}
        self._batch_window_s = batch_window_s
        self._batched: Dict[str, object] = {}
        self._generate_workers = None  # dedicated pool, built on first use
        self._shippers: Dict[int, object] = {}  # engine id -> KVShipper
        self._lock = threading.Lock()
        # per-stage serving profile (sums + count): where a request's
        # milliseconds go between proto-in and proto-out
        self._stage_sums: Dict[str, float] = {}
        self._stage_n = 0
        #: rolling-restart drain (k8s preStop pattern): readiness flips
        #: false so balancers rotate the replica out, while in-flight AND
        #: late-arriving requests keep being served until shutdown
        self.draining = False
        self._inflight_req = 0

    def request_started(self) -> None:
        with self._lock:
            self._inflight_req += 1

    def request_finished(self) -> None:
        with self._lock:
            self._inflight_req -= 1

    @property
    def inflight_requests(self) -> int:
        with self._lock:
            return self._inflight_req

    def observe_stages(self, **seconds: float) -> None:
        with self._lock:
            self._stage_n += 1
            for k, v in seconds.items():
                self._stage_sums[k] = self._stage_sums.get(k, 0.0) + v

    def stage_profile(self) -> Dict[str, float]:
        """Mean per-request stage costs in ms (plus the sample count)."""
        with self._lock:
            if not self._stage_n:
                return {}
            out = {f"{k}_ms": round(1e3 * v / self._stage_n, 3)
                   for k, v in self._stage_sums.items()}
            out["n"] = self._stage_n
            return out

    def generate_workers(self):
        """Generation gets its own workers: long decodes + session-pool
        waits must not starve the shared 'pre' pool (StreamInfer/batching)."""
        from tpulab_torch.core.thread_pool import ThreadPool
        with self._lock:
            if self._generate_workers is None:
                self._generate_workers = ThreadPool(4, name="generate")
            return self._generate_workers

    def shipper_for(self, engine):
        """The engine's :class:`~tpulab_torch.disagg.KVShipper` (lazy, one
        per engine so ship counters accumulate), or None when the engine
        has no host tier — the service then treats every shipment field
        as absent and serves the plain path."""
        mgr = getattr(engine, "kv_offload", None)
        if mgr is None:
            return None
        with self._lock:
            sh = self._shippers.get(id(engine))
            if sh is None:
                from tpulab_torch.disagg import KVShipper
                sh = self._shippers[id(engine)] = KVShipper(mgr)
            return sh

    def runner(self, model_name: str):
        """Per-model runner; the batched variant aggregates concurrent
        requests into one device batch (examples/03 capability, in-process)."""
        if not self.batching:
            return self.manager.infer_runner(model_name)
        with self._lock:
            if model_name not in self._batched:
                from tpulab_torch.engine.batched_runner import \
                    BatchedInferRunner
                self._batched[model_name] = BatchedInferRunner(
                    self.manager, model_name, window_s=self._batch_window_s)
            return self._batched[model_name]

    def shutdown(self) -> None:
        with self._lock:
            for r in self._batched.values():
                r.shutdown()
            self._batched.clear()
            if self._generate_workers is not None:
                self._generate_workers.shutdown(wait=False)
                self._generate_workers = None


class StatusContext(Context):
    """Model-listing RPC (reference StatusContext infer.cc:547-594), plus
    live load gauges: requests waiting for capacity (admission queue +
    batcher queues) and free KV pages — replica routers break inflight
    ties on them (least-loaded preference)."""

    def execute_rpc(self, request: pb.StatusRequest) -> pb.StatusResponse:
        res = self.get_resources(InferResources)
        mgr = res.manager
        resp = pb.StatusResponse(server_version=SERVER_VERSION)
        queued = 0
        if res.admission is not None:
            queued += res.admission.queue_depth
        free_pages = 0
        prefix_hits = prefix_lookups = 0
        for eng in res.generation_engines.values():
            queued += int(getattr(eng, "queued_requests", 0) or 0)
            pool = getattr(eng, "pool", None)
            if pool is not None:
                try:
                    free_pages += int(pool.free_pages)
                except Exception:  # torn-down pool: report what we can
                    pass
            pc = getattr(eng, "prefix_cache", None)
            if pc is not None:
                # prefix-cache effectiveness (lifetime counters):
                # lookups = hits + misses
                try:
                    prefix_hits += int(pc.hits)
                    prefix_lookups += int(pc.hits) + int(pc.misses)
                except Exception:  # torn-down cache: report what we can
                    pass
        resp.queued_requests = queued
        resp.free_kv_pages = free_pages
        resp.prefix_hits = prefix_hits
        resp.prefix_lookups = prefix_lookups
        resp.role = res.role
        # rolling-restart drain: tell every polling router this replica
        # must gain nothing new
        resp.draining = res.draining
        # streams currently in service: drained means draining AND
        # inflight == 0 AND queued == 0
        resp.inflight_requests = res.inflight_requests
        if res.hbm is not None:
            # unified HBM economy: ONE honest headroom gauge next to the
            # per-pool page count
            try:
                resp.free_hbm_bytes = int(res.hbm.free_hbm_bytes)
            except Exception:  # torn-down arbiter: report what we can
                pass
        if res.modelstore is not None:
            # multi-model residency report: routers prefer a replica that
            # already has the requested model hot (no swap-in on path)
            try:
                resp.resident_models.extend(res.modelstore.resident_models())
                resp.host_models.extend(res.modelstore.host_models())
            except Exception:  # torn-down store: report what we can
                pass
        names = ([request.model_name] if request.model_name
                 else mgr.model_names)
        for name in names:
            if name not in mgr.model_names:
                resp.status.code = pb.UNKNOWN_MODEL
                resp.status.message = f"unknown model {name!r}"
                return resp
            m = mgr.model(name)
            ms = pb.ModelStatus(name=name, max_batch_size=m.max_batch_size,
                                batch_buckets=list(m.batch_buckets),
                                weights_bytes=m.weights_size_in_bytes())
            for s in m.inputs:
                ms.inputs.append(pb.ModelIOSpec(
                    name=s.name, dtype=s.np_dtype.name, dims=list(s.shape)))
            for s in m.outputs:
                ms.outputs.append(pb.ModelIOSpec(
                    name=s.name, dtype=s.np_dtype.name, dims=list(s.shape)))
            resp.models.append(ms)
        resp.status.code = pb.SUCCESS
        return resp


class InferContext(Context):
    """Unary inference RPC (reference InferContext infer.cc:596-642)."""

    def execute_rpc(self, request: pb.InferRequest) -> pb.InferResponse:
        res0 = self.get_resources(InferResources)
        res0.request_started()
        try:
            resp = self._execute(request)
        finally:
            res0.request_finished()
        if res0.flight is not None:
            # unary wide event (lighter than generation's: no phases —
            # the stage profile already covers the dense pipeline)
            from tpulab_torch.serving.admission import tenant_of_request
            tc = TraceContext.of_request(request, self.grpc_context)
            try:
                outcome = pb.StatusCode.Name(resp.status.code)
            except ValueError:  # an unknown code
                outcome = str(resp.status.code)
            res0.flight.observe({
                "kind": "infer", "model": request.model_name,
                "tenant": tenant_of_request(request, self.grpc_context),
                "trace_id": tc.trace_id if tc is not None else None,
                "batch": max(1, int(request.batch_size)),
                "outcome": outcome, "e2e_s": self.walltime()})
        return resp

    def _execute(self, request: pb.InferRequest) -> pb.InferResponse:
        mgr = self.get_resources(InferResources).manager
        resp = pb.InferResponse(model_name=request.model_name,
                                correlation_id=request.correlation_id)
        if request.model_name not in mgr.model_names:
            resp.status.code = pb.UNKNOWN_MODEL
            resp.status.message = f"unknown model {request.model_name!r}"
            return resp
        model = mgr.model(request.model_name)
        try:
            arrays = {t.name: proto_to_tensor(t) for t in request.inputs}
            # validate against the model spec BEFORE touching pooled
            # resources: bad remote input must not consume a buffer slot
            input_names = {s.name for s in model.inputs}
            if set(arrays) != input_names:
                raise ValueError(f"inputs {sorted(arrays)} != model bindings "
                                 f"{sorted(input_names)}")
            for s in model.inputs:
                arr = arrays[s.name]
                if arr.dtype != s.np_dtype:
                    raise TypeError(f"input {s.name} dtype {arr.dtype} != "
                                    f"{s.np_dtype}")
                if tuple(arr.shape[1:]) != s.shape:
                    raise ValueError(f"input {s.name} shape {arr.shape[1:]} "
                                     f"!= {s.shape}")
                if not 1 <= arr.shape[0] <= model.max_batch_size:
                    # <1 catches the dims=[-1,...]+empty-payload lie that
                    # reshapes to batch 0 and would "succeed" vacuously
                    raise ValueError(
                        f"batch {arr.shape[0]} outside [1, "
                        f"{model.max_batch_size}]")
            output_names = {s.name for s in model.outputs}
            unknown = set(request.requested_outputs) - output_names
            if unknown:
                # a client typo must not yield an empty SUCCESS response —
                # and must not consume a device inference either
                raise ValueError(
                    f"unknown requested_outputs {sorted(unknown)}; "
                    f"model outputs are {sorted(output_names)}")
        except Exception as e:
            resp.status.code = pb.INVALID_ARGUMENT
            resp.status.message = str(e)
            return resp
        res = self.get_resources(InferResources)
        ticket = None
        if res.admission is not None:
            # QoS gate AFTER request validation (a malformed request is
            # INVALID_ARGUMENT, never a retry-after) and BEFORE any pooled
            # resource: a rejected request consumes nothing downstream
            from tpulab_torch.serving.admission import (AdmissionRejected,
                                                        tenant_of_request)
            deadline = None
            g = self.grpc_context
            if g is not None and hasattr(g, "time_remaining"):
                rem = g.time_remaining()
                if rem is not None:
                    deadline = Deadline.after(rem)
            tc0 = TraceContext.of_request(request, self.grpc_context)
            try:
                ticket = res.admission.admit(
                    tenant=tenant_of_request(request, self.grpc_context),
                    cost=max(1, request.batch_size), deadline=deadline,
                    trace_id=tc0.trace_id if tc0 is not None else None,
                    model=request.model_name)
            except AdmissionRejected as e:
                resp.status.code = pb.RESOURCE_EXHAUSTED
                resp.status.message = str(e)
                resp.status.retry_after_ms = e.retry_after_ms
                return resp
        lease = None
        if (res.modelstore is not None
                and request.model_name in res.modelstore):
            # multi-model serving: pin the weights hot for the request's
            # duration (swapping them in from the host tier / a cold
            # rebuild first if needed).  Unacquirable = the hot set is
            # fully leased elsewhere: that is overload, not a fault.
            try:
                lease = res.modelstore.acquire(request.model_name)
            except TimeoutError as e:
                if ticket is not None:
                    ticket.release()
                resp.status.code = pb.RESOURCE_EXHAUSTED
                resp.status.message = (
                    f"model weights not acquirable: {e}")
                return resp
        try:
            runner = res.runner(request.model_name)
            t0 = _time.perf_counter()
            fut = runner.infer(**arrays)
            outputs = fut.result()
            t1 = _time.perf_counter()
            # prefer the per-request compute-site measurement (set on the
            # future before resolution); the wait-time fallback includes
            # queueing/window
            compute_s = (getattr(fut, "_tpulab_compute_s", None)
                         or (t1 - t0))
            wanted = set(request.requested_outputs) or set(outputs)
            for name, arr in outputs.items():
                if name in wanted:
                    resp.outputs.append(tensor_to_proto(name, arr))
            t2 = _time.perf_counter()
            resp.status.code = pb.SUCCESS
            if res.metrics is not None:
                res.metrics.observe_request(self.walltime(), compute_s,
                                            model=request.model_name)
            # stage accounting: window+queue from the batched runner when
            # present; pipeline = everything between enqueue-return and
            # result minus the aggregation wait
            queue_s = getattr(fut, "_tpulab_queue_s", 0.0)
            res.observe_stages(
                handler_total=self.walltime(),
                batch_wait=queue_s,
                pipeline=(t1 - t0) - queue_s,
                compute=compute_s or 0.0,
                respond=t2 - t1)
            if res.trace is not None:
                # per-request lifecycle spans on this worker thread's row,
                # tagged with the client's trace id when one rode in
                targs = {"model": request.model_name}
                tc = TraceContext.of_request(request, self.grpc_context)
                if tc is not None:
                    targs["trace_id"] = tc.trace_id
                res.trace.add_span("batch_wait", t0, queue_s, **targs)
                res.trace.add_span("pipeline", t0 + queue_s,
                                   (t1 - t0) - queue_s,
                                   compute_ms=round(1e3 * (compute_s or 0),
                                                    3), **targs)
                res.trace.add_span("respond", t1, t2 - t1, **targs)
        except Exception as e:  # noqa: BLE001
            log.exception("inference failed")
            resp.status.code = pb.INTERNAL
            resp.status.message = str(e)
        finally:
            if lease is not None:
                lease.release()
            if ticket is not None:
                ticket.release()
        return resp


class HealthContext(Context):
    def execute_rpc(self, request: pb.HealthRequest) -> pb.HealthResponse:
        res = self.get_resources(InferResources)
        ready = res.manager is not None and not res.draining
        if res.watchdog is not None:
            # wedged-device detection: balancers rotate the replica out
            ready = ready and res.watchdog.healthy
        return pb.HealthResponse(live=True, ready=ready)


class DebugContext(Context):
    """The Debugz RPC: the live "what is the engine holding RIGHT NOW"
    snapshot — lanes, the pool's size ladder, HBM ledger claims and
    verify, modelstore leases, per-tenant admission queue depths, chaos
    armament, flight-recorder exemplar pointers — as one JSON document
    (``snapshot_json``; layout: :mod:`tpulab_torch.obs.debugz`).
    ``profile_ticks=N`` also arms ``torch.profiler`` around the next N
    scheduler passes of the selected engine and returns the trace
    directory."""

    def execute_rpc(self, request: pb.DebugRequest) -> pb.DebugResponse:
        import json as _json
        res = self.get_resources(InferResources)
        resp = pb.DebugResponse()
        name = request.model_name
        if name and name not in res.generation_engines:
            resp.status.code = pb.UNKNOWN_MODEL
            resp.status.message = f"no generation engine for {name!r}"
            return resp
        if request.profile_ticks:
            from tpulab_torch.obs.debugz import arm_profile
            try:
                resp.profile_dir = arm_profile(
                    res.generation_engines, name,
                    int(request.profile_ticks),
                    request.profile_dir or "")
            except KeyError:
                resp.status.code = pb.INVALID_ARGUMENT
                resp.status.message = ("profile_ticks needs a profile-"
                                       "capable (paged) generation engine")
                return resp
            except (RuntimeError, ValueError) as e:
                # a capture already armed / bad tick count: report it,
                # still return the snapshot (the operator asked to LOOK)
                resp.status.message = f"profiler not armed: {e}"
        from tpulab_torch.obs.debugz import debug_snapshot
        try:
            snap = debug_snapshot(res, model_name=name)
            snap["server_version"] = SERVER_VERSION
            snap["role"] = res.role
            snap["draining"] = res.draining
            snap["inflight_requests"] = res.inflight_requests
            snap["stage_profile"] = res.stage_profile()
            resp.snapshot_json = _json.dumps(snap, default=str)
            resp.status.code = pb.SUCCESS
        except Exception as e:  # noqa: BLE001 - debugz must not crash
            log.exception("debug snapshot failed")
            resp.status.code = pb.INTERNAL
            resp.status.message = str(e)
        return resp


class FetchKVContext(Context):
    """Fleet KV fabric owner side (:mod:`tpulab_torch.kvfabric`,
    docs/SERVING.md "Fleet KV fabric"): serve one published prefill's
    wire-form KV snapshot by content digest — WITHOUT consuming the local
    copy (the export reads through the host tier's non-evicting
    ``peek``; this replica's own prefix warmth is untouched by the
    fleet's fetch traffic).  Misses — never published, publish still in
    write-behind flight, evicted since — answer NOT_FOUND honestly
    rather than wait out the owner's internal fences: bounded staleness
    is the contract, and the fetcher's degrade path (a local prefill) is
    always correct."""

    def execute_rpc(self, request: pb.FetchKVRequest) -> pb.FetchKVResponse:
        res = self.get_resources(InferResources)
        resp = pb.FetchKVResponse()
        engines = res.generation_engines
        name = request.model_name
        if name:
            engine = engines.get(name)
            if engine is None:
                resp.status.code = pb.UNKNOWN_MODEL
                resp.status.message = f"no generation engine for {name!r}"
                return resp
        else:
            engine = next(iter(engines.values()), None)
        if engine is None or not getattr(engine, "kv_publish", False):
            resp.status.code = pb.NOT_FOUND
            resp.status.message = "fabric publish not armed"
            return resp
        from tpulab_torch.kvfabric import fabric_export
        blob = fabric_export(engine, bytes(request.digest))
        if blob is None:
            resp.status.code = pb.NOT_FOUND
            resp.status.message = "digest not resident"
        else:
            resp.status.code = pb.SUCCESS
            resp.kv_shipment = blob
        return resp


class StreamInferContext(StreamingContext):
    """Bidirectional pipelined inference (reference TRTIS StreamInfer /
    nvrpc streaming contexts): each incoming InferRequest dispatches
    immediately; responses stream back as they complete, correlated by
    ``correlation_id`` (responses may arrive out of order — that is the
    point: the stream stays full while the device pipeline works).

    Each worker writes its response *before* its future resolves, so the
    end-of-stream drain cannot close the stream ahead of a tail response;
    completed entries prune themselves (long-lived streams stay O(inflight)).
    """

    DRAIN_TIMEOUT_S = 300.0

    def __init__(self, resources=None):
        super().__init__(resources)
        self._lock = threading.Lock()
        self._inflight: Dict[int, object] = {}  # seq -> worker future
        self._seq = 0

    def on_request(self, request: pb.InferRequest) -> None:
        res = self.get_resources(InferResources)
        with self._lock:
            seq = self._seq
            self._seq += 1
            # registered BEFORE the worker starts: run()'s prune always
            # finds the entry, so nothing can leak (drain polls emptiness)
            self._inflight[seq] = True
        # counted from registration through write+prune: the manager-level
        # drain() must cover the queued-not-yet-started and computed-but-
        # not-yet-written windows too (the inner InferContext counts again
        # while computing — nested +1/-1 is harmless for a drain that
        # waits for zero)
        res.request_started()

        def run():
            try:
                try:
                    ictx = InferContext(res)
                    # stream's transport context rides along so admission
                    # sees the tenant metadata and transport deadline
                    ictx.grpc_context = self.grpc_context
                    resp = ictx.execute_rpc(request)
                except BaseException as e:  # noqa: BLE001 - always respond
                    resp = pb.InferResponse(
                        model_name=request.model_name,
                        correlation_id=request.correlation_id,
                        status=pb.RequestStatus(code=pb.INTERNAL,
                                                message=str(e)))
                # response enqueued BEFORE this entry prunes: the drain can
                # never close the stream ahead of it
                self.write(resp)
            finally:
                with self._lock:
                    self._inflight.pop(seq, None)
                res.request_finished()

        try:
            res.manager.workers("pre").enqueue(run)
        except BaseException:  # enqueue failed: prune or the drain spins
            with self._lock:
                self._inflight.pop(seq, None)
            res.request_finished()
            raise

    def _busy(self) -> bool:
        with self._lock:
            return bool(self._inflight)

    def on_requests_finished(self):
        """Drain in-flight work; blocking on thread executors, awaitable on
        the event-loop (Fiber) executor so the loop never stalls."""
        try:
            import asyncio
            asyncio.get_running_loop()
        except RuntimeError:
            self._drain_sync()
            return None
        return self._drain_async()

    def _drain_sync(self) -> None:
        deadline = _time.monotonic() + self.DRAIN_TIMEOUT_S
        while self._busy() and _time.monotonic() < deadline:
            _time.sleep(0.005)
        if self._busy():
            log.warning("stream drain: in-flight requests did not complete "
                        "before the drain deadline")

    async def _drain_async(self) -> None:
        import asyncio
        deadline = _time.monotonic() + self.DRAIN_TIMEOUT_S
        while self._busy() and _time.monotonic() < deadline:
            await asyncio.sleep(0.005)


def build_infer_service(manager, address: str = "0.0.0.0:0",
                        executor: Optional[Executor] = None,
                        batching: bool = False,
                        batch_window_s: float = 0.002,
                        metrics=None,
                        generation_engines: Optional[Dict[str, object]] = None,
                        watchdog=None, trace=None, admission=None,
                        role: str = "unified", modelstore=None,
                        hbm=None, flight=None, fleet=None,
                        kvfabric=None) -> Server:
    """Wire the inference service onto a Server
    (reference BasicInferService ctor infer.cc:644-678).

    ``batching=True`` turns on server-side dynamic batching: concurrent unary
    Infer calls aggregate into one device batch per model.  ``admission``
    is an optional :class:`tpulab_torch.serving.AdmissionController`: the
    QoS frontend gate enforced on Infer / StreamInfer / Generate before
    any pooled resource is touched; rejected requests get
    ``RESOURCE_EXHAUSTED`` + ``retry_after_ms``.  ``role`` declares the
    replica's disaggregated-serving role (``"prefill"`` / ``"decode"`` /
    ``"unified"``), reported over the Status RPC.  ``modelstore`` is an
    optional :class:`tpulab_torch.modelstore.WeightMultiplexer`: requests
    for a managed model lease its weights and Status reports resident vs
    host-tier models.  ``hbm`` is an optional
    :class:`tpulab_torch.hbm.HBMArbiter`: Status reports its single
    ``free_hbm_bytes`` headroom and an attached admission controller
    adopts it for capacity decisions.  ``flight`` is an optional
    :class:`tpulab_torch.obs.FlightRecorder`: every Infer and Generate
    request assembles one tail-sampled wide event at completion (a paged
    engine without a recorder adopts it), and the ``Debug`` RPC points
    at its exemplars.  ``watchdog`` is an optional
    :class:`tpulab_torch.utils.watchdog.DeviceWatchdog`: Health reports
    not-ready while it is unhealthy.  ``fleet`` is an optional
    control-plane handle (a :class:`tpulab_torch.fleet.FleetController`
    or anything with ``snapshot()``): the Debug snapshot then carries a
    ``fleet`` section.  ``kvfabric`` is an optional
    :class:`tpulab_torch.kvfabric.KVFabric`: fleet-wide prefix-KV pulls —
    a Generate request whose prompt homes on another replica fetches
    that replica's finished prefill over the ``FetchKV`` RPC instead of
    recomputing it, and engines built with ``kv_publish`` answer the
    fleet's fetches here.

    The returned server serves in process at once
    (``server.invoke`` / ``invoke_stream``); ``server.async_start()``
    serves over grpc where grpc is installed."""
    if admission is not None and trace is not None \
            and getattr(admission, "trace", None) is None:
        # adopt the service's recorder: admission-decision spans land on
        # the same timeline as the request lifecycle spans
        admission.trace = trace
    if admission is not None and modelstore is not None \
            and getattr(admission, "modelstore", None) is None:
        # adopt the store: admission's per-model capacity gate queues a
        # burst on model A instead of letting it thrash model B's hot set
        admission.modelstore = modelstore
    if admission is not None and hbm is not None \
            and getattr(admission, "hbm", None) is None:
        # adopt the arbiter: _capacity_ok_locked consults ONE honest
        # headroom number instead of summing per-tenant estimates
        admission.hbm = hbm
    resources = InferResources(manager, batching=batching,
                               batch_window_s=batch_window_s, metrics=metrics,
                               trace=trace,
                               generation_engines=generation_engines,
                               watchdog=watchdog, admission=admission,
                               role=role, modelstore=modelstore, hbm=hbm,
                               flight=flight, fleet=fleet,
                               kvfabric=kvfabric)
    server = Server(address, executor or Executor(n_threads=4))
    server._infer_resources = resources  # for shutdown
    service = AsyncService(SERVICE_NAME, resources)
    service.register_rpc("Status", StatusContext,
                         pb.StatusRequest.FromString,
                         pb.StatusResponse.SerializeToString)
    service.register_rpc("Infer", InferContext,
                         pb.InferRequest.FromString,
                         pb.InferResponse.SerializeToString)
    service.register_rpc("Health", HealthContext,
                         pb.HealthRequest.FromString,
                         pb.HealthResponse.SerializeToString)
    service.register_rpc("Debug", DebugContext,
                         pb.DebugRequest.FromString,
                         pb.DebugResponse.SerializeToString)
    service.register_rpc("FetchKV", FetchKVContext,
                         pb.FetchKVRequest.FromString,
                         pb.FetchKVResponse.SerializeToString)
    service.register_rpc("StreamInfer", StreamInferContext,
                         pb.InferRequest.FromString,
                         pb.InferResponse.SerializeToString)
    service.register_rpc("Generate", GenerateContext,
                         pb.GenerateRequest.FromString,
                         pb.GenerateResponse.SerializeToString)
    server.register_async_service(service)
    return server


def _final(code: int, message: str = "", **kw) -> pb.GenerateResponse:
    return pb.GenerateResponse(final=True, status=pb.RequestStatus(
        code=code, message=message, **kw))


class GenerateContext(StreamingContext):
    """Token-streaming generation (bidi: one GenerateRequest in, one
    GenerateResponse per generated token out).  Leases a pooled KV-cache
    session per request — blocking lease = natural generation backpressure."""

    #: how often a paged stream's wait checks its deadline and whether the
    #: client is still there (tpulab polls each second; a client that
    #: drops between tokens is also caught at its next token)
    POLL_S = 0.05

    def on_request(self, request: pb.GenerateRequest):
        """Generation is long-running: it always runs on the dedicated
        'generate' worker pool (never the shared 'pre' pool); under the
        aio (Fiber) executor an awaitable is returned so the event loop
        never stalls."""
        try:
            import asyncio
            asyncio.get_running_loop()
        except RuntimeError:
            self._run(request)      # thread executor: blocking is fine
            return None
        res = self.get_resources(InferResources)
        fut = res.generate_workers().enqueue(self._run, request)
        import asyncio
        return asyncio.wrap_future(fut)

    SESSION_LEASE_TIMEOUT_S = 300.0

    def _run(self, request: pb.GenerateRequest) -> None:
        res = self.get_resources(InferResources)
        res.request_started()  # generation streams count toward drain
        self._flight_begin(request, res)
        try:
            self._run_counted(request)
        finally:
            res.request_finished()
            self._flight_finish(res)

    # -- flight recorder: the wide-event assembly ---------------------------
    def _flight_begin(self, request: pb.GenerateRequest,
                      res: InferResources) -> None:
        """Arm this stream's wide event: capture identity and the
        start-of-window counters NOW, and intercept writes so the final
        status (and delivered-token count) land in the record without
        touching any engine path.  Disarmed cost: one is-None branch."""
        if res.flight is None:
            self._fl_ev = None
            return
        from tpulab_torch.serving.admission import tenant_of_request
        tc = TraceContext.of_request(request, self.grpc_context)
        ev: Dict[str, Any] = {
            "kind": "generate", "model": request.model_name,
            "tenant": tenant_of_request(request, self.grpc_context),
            "priority": int(request.priority),
            "trace_id": tc.trace_id if tc is not None else None,
            "prompt_tokens": len(request.prompt),
            "steps": int(request.steps),
            "deadline_ms": int(request.deadline_ms) or None,
            "t_submit": _time.perf_counter(),
            "_chaos0": chaos.fired_snapshot(),
            "_final": [], "_delivered": [0],
        }
        if request.resume_length:
            ev["resume_length"] = int(request.resume_length)
        if request.prefill_only:
            ev["prefill_only"] = True
        if request.request_class == "batch":
            ev["request_class"] = "batch"
        if res.hbm is not None:
            ev["_hbm0"] = int(res.hbm.pressure_events)
        final, delivered = ev["_final"], ev["_delivered"]
        orig_write = self.write

        def counting_write(resp, _orig=orig_write):
            if getattr(resp, "final", False):
                final.append(int(resp.status.code))
            else:
                delivered[0] += 1
            _orig(resp)

        # streaming contexts are per stream (never pooled), so the wrapper
        # lives and dies with this request
        self.write = counting_write
        self._fl_ev = ev

    def _fl_note(self, **kw) -> None:
        """Annotate the pending wide event (no-op disarmed)."""
        ev = getattr(self, "_fl_ev", None)
        if ev is not None:
            ev.update(kw)

    def _flight_finish(self, res: InferResources) -> None:
        """Assemble and record the wide event at stream completion: merge
        the engine's summary (``_tpulab_flight``), resolve the outcome
        from the intercepted final status, and diff the chaos / HBM
        window counters."""
        ev = getattr(self, "_fl_ev", None)
        if ev is None or res.flight is None:
            return
        self._fl_ev = None
        final = ev.pop("_final")
        delivered = ev.pop("_delivered")[0]
        chaos0 = ev.pop("_chaos0")
        hbm0 = ev.pop("_hbm0", None)
        eng = ev.pop("_engine_ev", None)
        if eng:
            # engine summary first (lane / pages / blocks / ITL / spec /
            # swaps); the RPC layer's identity and window fields override
            merged = dict(eng)
            merged.update({k: v for k, v in ev.items() if v is not None})
            ev = merged
        ev["tokens_delivered"] = delivered
        ev["e2e_s"] = _time.perf_counter() - ev["t_submit"]
        if final:
            try:
                ev["outcome"] = pb.StatusCode.Name(final[-1])
            except ValueError:  # an unknown code
                ev["outcome"] = str(final[-1])
        elif ev.get("stalled"):
            ev["outcome"] = "STALLED"
        elif eng and eng.get("outcome") not in (None, "SUCCESS"):
            ev["outcome"] = eng["outcome"]  # e.g. engine-side CANCELLED
        else:
            # no final went out and nothing stalled: the client abandoned
            # the stream mid-flight
            ev["outcome"] = "CANCELLED"
        trips = {}
        for point, n in chaos.fired_snapshot().items():
            d = n - chaos0.get(point, 0)
            if d > 0:
                trips[point] = d
        if trips:
            # rules that fired while this request was in flight (window
            # diff: concurrent streams share attribution by design)
            ev["chaos_trips"] = trips
        if hbm0 is not None and res.hbm is not None:
            d = int(res.hbm.pressure_events) - hbm0
            if d:
                ev["hbm_pressure_rounds"] = d
        res.flight.observe(ev)

    def _client_gone(self) -> bool:
        g = self.grpc_context
        return (g is not None and hasattr(g, "is_active")
                and not g.is_active())

    def _deadline_of(self, request: pb.GenerateRequest) -> Optional[Deadline]:
        """The request's end-to-end budget: explicit ``deadline_ms``
        first, else the transport deadline when one rode in.  None =
        unbounded."""
        if request.deadline_ms:
            return Deadline.after(request.deadline_ms / 1e3)
        g = self.grpc_context
        if g is not None and hasattr(g, "time_remaining"):
            rem = g.time_remaining()
            if rem is not None:
                return Deadline.after(rem)
        return None

    def _run_counted(self, request: pb.GenerateRequest) -> None:
        res = self.get_resources(InferResources)
        engine = res.generation_engines.get(request.model_name)
        if engine is None:
            self.write(_final(
                pb.UNKNOWN_MODEL,
                f"no generation engine for {request.model_name!r}"))
            return
        if request.device_sampling and (request.top_k > 0
                                        or 0.0 < request.top_p < 1.0):
            self.write(_final(pb.INVALID_ARGUMENT,
                              "device_sampling does not support top_k/top_p "
                              "(host-side features)"))
            return
        if not 0.0 <= request.top_p <= 1.0:
            self.write(_final(pb.INVALID_ARGUMENT,
                              "top_p must be in [0, 1]"))
            return
        if not (request.temperature >= 0.0):  # rejects negatives AND NaN
            self.write(_final(pb.INVALID_ARGUMENT,
                              "temperature must be >= 0"))
            return
        # shared host-boundary id validation: every engine kind exposes
        # its vocab bound, so the check covers dense/paged/speculative
        vocab = getattr(engine, "vocab", None)
        ids = np.asarray(request.prompt, np.int64)
        if vocab and ids.size and (ids.min() < 0 or ids.max() >= vocab):
            self.write(_final(pb.INVALID_ARGUMENT,
                              f"prompt token ids outside [0, {vocab})"))
            return
        if request.request_class not in ("", "online", "batch"):
            self.write(_final(
                pb.INVALID_ARGUMENT,
                f"unknown request_class {request.request_class!r} (want "
                "'online' or 'batch')"))
            return
        if (request.request_class == "batch"
                and (request.prefill_only or request.kv_shipment)):
            # the offline lane is a whole-request class: a disaggregated
            # hop is online serving machinery and carries no class
            self.write(_final(pb.INVALID_ARGUMENT,
                              "request_class='batch' cannot combine with "
                              "prefill_only/kv_shipment"))
            return
        msg = self._validate_resume(request)
        if msg is not None:
            self.write(_final(pb.INVALID_ARGUMENT, msg))
            return
        deadline = self._deadline_of(request)
        ticket = None
        if res.admission is not None:
            ok, ticket = self._admit(request, res, deadline)
            if not ok:
                return
        lease = None
        if (res.modelstore is not None
                and request.model_name in res.modelstore):
            # multi-model serving: the lease pins this model's weights
            # hot for the WHOLE stream — a decode-in-flight model can
            # never be evicted by a burst on another model
            try:
                lease = res.modelstore.acquire(request.model_name)
            except TimeoutError as e:
                self.write(_final(pb.RESOURCE_EXHAUSTED,
                                  f"model weights not acquirable: {e}"))
                if ticket is not None:
                    ticket.release()
                return
        try:
            self._run_engine(engine, request, deadline)
        finally:
            if lease is not None:
                lease.release()
            if ticket is not None:
                ticket.release()

    @staticmethod
    def _validate_resume(request: pb.GenerateRequest) -> Optional[str]:
        """Deterministic validation of a resume-from-delivered failover
        request.  The prompt must already contain original_prompt + the
        delivered tokens, and the sampling stream must be (seed,
        position)-keyed — greedy or device sampling — so the continuation
        is bit-exact.  Host-sampled requests are REJECTED here (their PRNG
        is keyed by draw order, which does not survive the replica hop).
        Returns an error message, or None when the request is fine."""
        resume = int(request.resume_length)
        if resume == 0:
            return None
        if resume < 0:
            return "resume_length must be >= 0"
        if resume >= request.steps:
            return (f"resume_length {resume} must be < steps "
                    f"{request.steps} (nothing left to generate)")
        if len(request.prompt) <= resume:
            return ("resume prompt must contain the original prompt plus "
                    f"the {resume} delivered tokens")
        if request.temperature > 0.0 and not request.device_sampling:
            return ("resume requires greedy or device sampling (host-side "
                    "PRNG draw order does not survive the replica hop)")
        if request.prefill_only or request.kv_shipment:
            return ("resume_length cannot combine with prefill_only/"
                    "kv_shipment (disaggregation fields)")
        return None

    def _note_resume(self, engine, request: pb.GenerateRequest) -> None:
        """Server-side resume observability: the delivered prefix rides
        one chunked prefill instead of per-token re-decode dispatches."""
        m = getattr(engine, "metrics", None)
        if m is not None and hasattr(m, "note_resume"):
            m.note_resume(int(request.resume_length))

    def _hold_stalled_stream(self, until_monotonic: float) -> None:
        """A chaos ``rpc.stream=drop`` latched this stream STALLED: keep
        the RPC open without emitting (what a wedged emit path looks like
        to the client) until the client gives up or the lease cap passes."""
        while _time.monotonic() < until_monotonic:
            if self._client_gone():
                return
            _time.sleep(0.02)

    def _admit(self, request: pb.GenerateRequest, res: InferResources,
               deadline):
        """QoS gate for both generation paths, AFTER request validation
        (a malformed request is INVALID_ARGUMENT, never a retry-after)
        and BEFORE any lane/page/session lease.  Returns ``(ok, ticket)``;
        on rejection the final RESOURCE_EXHAUSTED response (with the
        ``retry_after_ms`` backoff hint) has already been written."""
        from tpulab_torch.serving.admission import (AdmissionRejected,
                                                    tenant_of_request)
        tc = TraceContext.of_request(request, self.grpc_context)
        if request.kv_shipment:
            # shipped-KV arrival (disaggregated decode): the prompt's KV
            # arrives precomputed, so admission charges the PROMOTE cost
            # (a page upload, ~prompt/16) plus the decode steps
            cost = request.steps + max(1, len(request.prompt) // 16)
        elif request.prefill_only:
            # prefill-role request: prompt forward only, one token out
            cost = len(request.prompt) + 1
        elif request.resume_length:
            # resume-from-delivered failover: the prompt (which already
            # contains the delivered tokens) is one chunked prefill, and
            # only the REMAINING tokens decode sequentially
            cost = (len(request.prompt)
                    + max(1, request.steps - request.resume_length))
        elif (res.kvfabric is not None
              and not request.return_logprobs
              and res.kvfabric.would_pull(
                  np.asarray(request.prompt, np.int32),
                  self._sampling_of(request),
                  res.generation_engines.get(request.model_name),
                  logprobs=request.return_logprobs) is not None):
            # fabric-pullable arrival (tpulab_torch.kvfabric): the
            # prompt's KV will be fetched, not recomputed — charge the
            # shipped-KV PROMOTE cost.  Undercharges when the pull later
            # degrades to a local prefill, exactly like a shipped arrival
            # whose import fails: admission costs are estimates, and the
            # degrade path pays with latency, not with a second ticket.
            cost = request.steps + max(1, len(request.prompt) // 16)
        else:
            cost = len(request.prompt) + request.steps
        try:
            ticket = res.admission.admit(
                tenant=tenant_of_request(request, self.grpc_context),
                cost=cost,
                priority=request.priority, deadline=deadline,
                trace_id=tc.trace_id if tc is not None else None,
                model=request.model_name,
                request_class=request.request_class or "online")
            # wide event: the admission verdict, queue wait and the
            # tenant's DRR deficit at dispatch
            self._fl_note(admission={
                "verdict": "admit", "cost": ticket.cost,
                "queue_wait_s": round(ticket.queue_wait_s, 6),
                "drr_deficit": round(float(ticket.drr_deficit), 3)})
            return True, ticket
        except AdmissionRejected as e:
            self._fl_note(admission={
                "verdict": "reject", "reason": e.reason,
                "retry_after_ms": e.retry_after_ms})
            self.write(_final(pb.RESOURCE_EXHAUSTED, str(e),
                              retry_after_ms=e.retry_after_ms))
            return False, None

    def _run_engine(self, engine, request: pb.GenerateRequest,
                    deadline) -> None:
        res = self.get_resources(InferResources)
        if ((request.prefill_only or request.kv_shipment)
                and not getattr(engine, "continuous_batching", False)):
            self.write(_final(
                pb.INVALID_ARGUMENT,
                "disaggregated serving (prefill_only/kv_shipment) requires "
                "a continuous-batching engine"))
            return
        if getattr(engine, "continuous_batching", False):  # explicit marker
            self._run_paged(engine, request, deadline)
            return
        if (request.temperature > 0.0 or request.priority != 0
                or request.return_logprobs):
            # the dense session engine is greedy/FIFO only — reject rather
            # than silently returning greedy tokens for a sampled request
            self.write(_final(
                pb.INVALID_ARGUMENT,
                f"model {request.model_name!r} is served by a dense "
                "session engine: sampling (temperature/top_k/seed), "
                "priority and logprobs require a continuous-batching "
                "backend"))
            return
        # trace: queue(lease wait)/prefill/decode-chunk spans on this
        # worker's row, tagged with the client's trace id; all span
        # bookkeeping is gated on the recorder
        trace = res.trace
        targs = {"model": request.model_name}
        tc = TraceContext.of_request(request, self.grpc_context)
        if tc is not None:
            targs["trace_id"] = tc.trace_id

        def span(name, t0, dur, **extra):
            if trace is not None:
                trace.add_span(name, t0, dur, **targs, **extra)
        try:
            stops = set(request.stop_tokens)
            # resume-from-delivered failover (greedy-only engine, so every
            # dense request is eligible): prefill the prompt whole, then
            # emit the REMAINING steps from index resume_length
            resume_ofs = int(request.resume_length)
            steps_eff = request.steps - resume_ofs
            if resume_ofs:
                self._note_resume(engine, request)
            stalled = False
            t_lease0 = _time.perf_counter()
            with engine.start_session(
                    timeout=self.SESSION_LEASE_TIMEOUT_S) as session:
                t_lease1 = _time.perf_counter()
                span("queue_wait", t_lease0, t_lease1 - t_lease0)
                try:
                    # PRE-STREAM validation only: a ValueError HERE is a
                    # deterministic request error — INVALID_ARGUMENT.  A
                    # ValueError raised LATER, mid-iteration, is an
                    # internal fault and falls through to INTERNAL below.
                    t0 = _time.perf_counter()
                    session.prefill(np.asarray(request.prompt, np.int32))
                    stream = session.stream(steps_eff)
                    span("prefill", t0, _time.perf_counter() - t0,
                         prompt_tokens=len(request.prompt))
                except ValueError as e:
                    self.write(_final(pb.INVALID_ARGUMENT, str(e)))
                    return
                chunk_t0 = _time.perf_counter()
                chunk_start = 0

                def flush_chunk(end):  # span per TRACE_DECODE_CHUNK tokens
                    nonlocal chunk_t0, chunk_start
                    if end > chunk_start:
                        span("decode", chunk_t0,
                             _time.perf_counter() - chunk_t0,
                             first=chunk_start, tokens=end - chunk_start)
                    chunk_t0 = _time.perf_counter()
                    chunk_start = end
                for i, tok in enumerate(stream):
                    if deadline is not None and deadline.expired():
                        # cancelled before the next token step; leaving the
                        # with-block frees the session slot NOW
                        log.info("generation deadline exceeded at step %d", i)
                        flush_chunk(i)
                        self.write(_final(pb.DEADLINE_EXCEEDED,
                                          "deadline exceeded mid-stream"))
                        return
                    if self._client_gone():
                        log.info("generation cancelled by client at step %d",
                                 i)
                        flush_chunk(i)
                        return  # free the session slot immediately
                    # chaos: per-token server fault site (error = transient
                    # stream failure; kill = replica process death)
                    chaos.trip("rpc.server.generate_token")
                    # chaos: the token-EMIT site (error = mid-stream fault
                    # the client fails over from; drop = the emit path
                    # wedges and the stream STALLS open without progress)
                    if chaos.trip("rpc.stream") == "drop":
                        stalled = True
                        flush_chunk(i)
                        break
                    self.write(pb.GenerateResponse(token=tok,
                                                   index=resume_ofs + i))
                    if (i + 1) % TRACE_DECODE_CHUNK == 0:
                        flush_chunk(i + 1)
                    if tok in stops:
                        flush_chunk(i + 1)
                        break  # stop token emitted; end like the paged path
                else:
                    flush_chunk(steps_eff)
            if stalled:
                self._fl_note(stalled=True)  # wide event: a latched stall
                self._hold_stalled_stream(
                    _time.monotonic() + self.SESSION_LEASE_TIMEOUT_S)
                return  # no final: the stream died stalled, never resolved
            t0 = _time.perf_counter()
            self.write(_final(pb.SUCCESS))
            span("respond", t0, _time.perf_counter() - t0)
        except DeadlineExceeded as e:
            self.write(_final(pb.DEADLINE_EXCEEDED, str(e)))
        except Exception as e:  # noqa: BLE001
            log.exception("generation failed")
            self.write(_final(pb.INTERNAL, str(e)))

    @staticmethod
    def _sampling_of(request: pb.GenerateRequest):
        """The request's SamplingParams (None = greedy) — shared by the
        paged, prefill-export and shipped-admit paths so one request is
        one sampling stream on every replica role."""
        if request.temperature <= 0.0:
            return None
        from tpulab_torch.engine.paged import SamplingParams
        return SamplingParams(
            temperature=request.temperature, top_k=request.top_k,
            top_p=request.top_p,
            seed=request.seed if request.HasField("seed") else None,
            device=request.device_sampling)

    def _run_prefill_export(self, engine, request: pb.GenerateRequest,
                            deadline=None) -> None:
        """Prefill-role serving: run the prompt prefill ONLY, demote the
        finished KV to the host tier and ship it in wire form on the final
        response, with the first token streamed as index 0.  A degraded
        export still returns the token — the router then lets the decode
        replica prefill locally, so the request is never stuck."""
        res = self.get_resources(InferResources)
        shipper = res.shipper_for(engine)
        if shipper is None:
            self.write(_final(pb.INVALID_ARGUMENT,
                              "prefill_only requires kv_offload on the "
                              "serving engine"))
            return
        from tpulab_torch.disagg import prompt_digest
        try:
            kw = {}
            if deadline is not None:
                kw["deadline"] = deadline
            digest = prompt_digest(request.prompt)
            fut = engine.submit(np.asarray(request.prompt, np.int32), 1,
                                sampling=self._sampling_of(request),
                                priority=request.priority,
                                export_digest=digest, **kw)
            toks = fut.result(timeout=self.SESSION_LEASE_TIMEOUT_S)
            first = int(toks[0])
            blob = shipper.export(getattr(fut, "_tpulab_kv_export", None),
                                  digest=digest, first_token=first)
            self.write(pb.GenerateResponse(token=first, index=0))
            final = _final(pb.SUCCESS)
            if blob:
                final.kv_shipment = blob
            self.write(final)
        except DeadlineExceeded as e:
            self.write(_final(pb.DEADLINE_EXCEEDED, str(e)))
        except ValueError as e:  # submit()'s deterministic validation
            self.write(_final(pb.INVALID_ARGUMENT, str(e)))
        except Exception as e:  # noqa: BLE001
            log.exception("prefill export failed")
            self.write(_final(pb.INTERNAL, str(e)))

    def _pull_and_submit(self, engine, request: pb.GenerateRequest,
                         res: InferResources, on_token, sampling, kw):
        """Fleet KV fabric (:mod:`tpulab_torch.kvfabric`, docs/SERVING.md
        "Fleet KV fabric"): a routed-astray request whose digest homes on
        another replica PULLS the finished prefill from there and admits
        it through the shipped-KV path — zero local prefill dispatches,
        the local prefill's tokens.  Returns the batcher future, or None
        (not eligible, cost-gated, single-flight timeout, chaos,
        NOT_FOUND, corrupt wire, budget refusal, admission rejected):
        the caller's plain submit then prefills locally — the fabric only
        ever SAVES work."""
        shipper = res.shipper_for(engine)
        if shipper is None:
            return None
        prompt = np.asarray(request.prompt, np.int32)
        t_pull0 = _time.perf_counter()
        pulled = res.kvfabric.pull(prompt, sampling, engine, shipper,
                                   model_name=request.model_name)
        if pulled is None:
            return None
        try:
            fut = engine.submit_shipped(
                prompt, request.steps, pulled.first_token, pulled.handle,
                on_token=on_token, sampling=sampling,
                priority=request.priority,
                stop_tokens=list(request.stop_tokens), **kw)
        except ValueError as e:
            shipper.manager.discard(pulled.handle)
            res.kvfabric.note_degrade(pulled)
            log.warning("fabric-pull admit rejected, degrading to local "
                        "prefill: %s", e)
            return None
        self._fl_note(kv_pull={
            "bytes": pulled.nbytes, "tokens_saved": pulled.length,
            "coalesced": pulled.coalesced,
            "wait_s": round(_time.perf_counter() - t_pull0, 6)})
        return fut

    def _run_paged(self, engine, request: pb.GenerateRequest,
                   deadline=None) -> None:
        """Continuous-batching path: tokens stream from the batcher's
        on_token hook; many RPCs share the fused decode ticks.  A client
        that disconnects cancels its batcher request (lane and pages free
        at the next tick), and nothing is written after the final
        response.

        Disaggregation: ``prefill_only`` requests divert to
        :meth:`_run_prefill_export`; a ``kv_shipment`` arrival is imported
        and admitted through ``submit_shipped`` (zero prefill dispatches)
        — any import/admit failure degrades to the plain local-prefill
        submit below, which recomputes identical tokens."""
        if request.prefill_only:
            self._run_prefill_export(engine, request, deadline)
            return
        finished = [False]
        # resume-from-delivered failover: the prompt already contains the
        # delivered tokens, so the engine admits it through the ordinary
        # (chunked) prefill path and only the remaining steps decode;
        # emitted indices shift by resume_length.  Absolute positions are
        # preserved — the (seed, position)-keyed sampling streams are
        # bit-exact.
        resume_ofs = int(request.resume_length)
        steps_eff = request.steps - resume_ofs
        if resume_ofs:
            self._note_resume(engine, request)
        stalled = [False]     # chaos rpc.stream drop: emit path wedged
        stream_fault = []     # chaos rpc.stream error: mid-stream fault
        held = []             # the batcher future, once submitted

        def on_token(tok, i, logprob=None):
            if finished[0] or stalled[0] or stream_fault:
                return
            if self._client_gone():
                # the client dropped between tokens: stop writing and
                # free the lane at the batcher's next tick boundary
                finished[0] = True
                if held:
                    engine.cancel(held[0])
                return
            # chaos: the token-EMIT site (see the dense loop's twin trip)
            try:
                if chaos.trip("rpc.stream") == "drop":
                    stalled[0] = True
                    return
            except chaos.ChaosError as e:
                stream_fault.append(e)
                return
            self.write(pb.GenerateResponse(
                token=tok, index=resume_ofs + i,
                logprob=0.0 if logprob is None else float(logprob)))

        fut = None
        res = self.get_resources(InferResources)
        if (res.trace is not None and getattr(engine, "trace", None) is None
                and hasattr(engine, "trace")):
            # adopt the service's recorder once: the batcher then records
            # its own queue / prefill / decode-chunk spans at the source
            # (the scheduler thread), where the RPC layer cannot see them
            engine.trace = res.trace
        flight_kw = {}
        if res.flight is not None and hasattr(engine, "flight"):
            from tpulab_torch.serving.admission import tenant_of_request
            if getattr(engine, "flight", None) is None:
                # adopt the recorder once: direct engine completions then
                # record too, and the engine attaches its per-request
                # summary to every future
                engine.flight = res.flight
            # this stream's wide event is assembled HERE — the engine
            # summarizes (``_tpulab_flight``) but does not record it
            flight_kw = {"flight_owner": "rpc",
                         "tenant": tenant_of_request(request,
                                                     self.grpc_context)}
        tc = TraceContext.of_request(request, self.grpc_context)
        try:
            sampling = self._sampling_of(request)
            kw = dict(flight_kw)
            if deadline is not None:
                # the batcher's tick sweep enforces it (lane/pages free
                # before the next step); only passed when present so
                # wrapped/test engines without the kwarg keep working
                kw["deadline"] = deadline
            if tc is not None:
                # same gating: only traced requests carry the kwarg
                kw["trace_id"] = tc.trace_id
            if request.request_class == "batch":
                # offline batch lane: the engine ranks this lane below
                # every online request and preempts it first.  Gated so
                # engines without the kwarg keep working.
                kw["request_class"] = "batch"
            if request.kv_shipment and not request.return_logprobs:
                # shipped-KV admit: import into the local host tier and
                # promote through the restore path — zero prefill
                # dispatches.  ANY failure (corrupt wire, geometry
                # mismatch, budget refusal, host-sampled lane) leaves
                # fut None and the plain submit below prefills locally:
                # same tokens, never a stuck request.
                shipper = res.shipper_for(engine)
                ship = (shipper.import_shipment(bytes(request.kv_shipment))
                        if shipper is not None else None)
                if ship is not None:
                    try:
                        fut = engine.submit_shipped(
                            np.asarray(request.prompt, np.int32),
                            request.steps, ship.first_token, ship.handle,
                            on_token=on_token, sampling=sampling,
                            priority=request.priority,
                            stop_tokens=list(request.stop_tokens), **kw)
                    except ValueError as e:
                        shipper.discard(ship)
                        log.warning("shipped-KV admit rejected, degrading "
                                    "to local prefill: %s", e)
            if (fut is None and res.kvfabric is not None
                    and not request.kv_shipment
                    and not request.return_logprobs and not resume_ofs
                    and request.request_class != "batch"):
                # the offline batch lane never pulls: submit_shipped
                # admits online requests only (tpulab passes the batch
                # class on and fails the request with a TypeError)
                fut = self._pull_and_submit(engine, request, res, on_token,
                                            sampling, kw)
            if fut is None:
                fut = engine.submit(np.asarray(request.prompt, np.int32),
                                    steps_eff, on_token=on_token,
                                    sampling=sampling,
                                    priority=request.priority,
                                    stop_tokens=list(request.stop_tokens),
                                    logprobs=request.return_logprobs, **kw)
            held.append(fut)
            if finished[0]:          # dropped before submit returned
                engine.cancel(fut)
                return
            lease_deadline = _time.monotonic() + self.SESSION_LEASE_TIMEOUT_S
            while True:
                try:
                    fut.result(timeout=self.POLL_S)
                    break
                except DeadlineExceeded:
                    raise  # NOT a poll timeout (TimeoutError subclass!)
                except _f.CancelledError:
                    if finished[0]:
                        return       # the client dropped: nothing to write
                    raise
                except _f.TimeoutError:
                    if stream_fault:
                        raise stream_fault[0]  # injected mid-stream fault
                    if _time.monotonic() > lease_deadline:
                        raise
                    if finished[0] or self._client_gone():
                        engine.cancel(fut)  # client gone: free the lane
                        finished[0] = True
                        return
            if stream_fault:
                raise stream_fault[0]
            if stalled[0]:
                # emit path wedged (chaos rpc.stream drop): hold the RPC
                # open WITHOUT a final so the client sees a stalled — not
                # dead — replica and its inter-token watchdog must act
                finished[0] = True
                self._fl_note(stalled=True)  # wide event: a latched stall
                self._hold_stalled_stream(lease_deadline)
                return
            if finished[0]:
                return               # the client dropped at the last token
            finished[0] = True
            self.write(_final(pb.SUCCESS))
        except DeadlineExceeded as e:
            finished[0] = True
            self.write(_final(pb.DEADLINE_EXCEEDED, str(e)))
        except ValueError as e:
            # submit()'s deterministic request validation (empty prompt,
            # steps, max_len, id bounds): INVALID_ARGUMENT, not INTERNAL —
            # GenerationRejected.retryable must not fail these over
            finished[0] = True
            self.write(_final(pb.INVALID_ARGUMENT, str(e)))
        except Exception as e:  # noqa: BLE001
            dropped = finished[0]
            finished[0] = True
            if fut is not None:
                try:
                    engine.cancel(fut)
                except Exception:  # pragma: no cover
                    pass
            if dropped and self._client_gone():
                return               # the cancel's own error: no one reads
            log.exception("paged generation failed")
            self.write(_final(pb.INTERNAL, str(e)))
        finally:
            if fut is not None:
                # the engine's completion summary (lane, peak pages, block
                # sizes, ITL, spec, swaps), attached to the future before
                # it resolved, merged into the wide event
                self._fl_note(
                    _engine_ev=getattr(fut, "_tpulab_flight", None))


class GenerationRejected(RuntimeError):
    """The server PROCESSED the request and rejected it with a final
    status (UNKNOWN_MODEL / INVALID_ARGUMENT / INTERNAL) — as opposed to
    transport errors (grpc.RpcError), which mean the replica itself is
    unreachable.  Routers use the distinction: a rejection is the same on
    every replica and must not fail over."""

    def __init__(self, code: int, message: str):
        super().__init__(f"generation failed: {message}")
        self.code = code

    @property
    def retryable(self) -> bool:
        """INTERNAL may be a transient engine fault and
        RESOURCE_EXHAUSTED is one replica's overload (another may have
        room); deterministic request errors are not worth a second
        replica's time, and an expired deadline is a GLOBAL budget — no
        replica can beat it."""
        return self.code not in (pb.UNKNOWN_MODEL, pb.INVALID_ARGUMENT,
                                 pb.DEADLINE_EXCEEDED)


class ResourceExhausted(GenerationRejected):
    """Admission-control fast-fail: the replica is OVERLOADED, not broken.
    Routers treat it as neither a success nor a replica fault — route
    away with backoff instead of tripping the circuit breaker — and
    ``retry_after_ms`` carries the server's backoff hint (clients add
    jitter: :func:`tpulab_torch.rpc.client.jittered_backoff_s`)."""

    def __init__(self, message: str, retry_after_ms: int = 0):
        RuntimeError.__init__(
            self, f"admission rejected: {message}"
            + (f" (retry after {retry_after_ms}ms)" if retry_after_ms
               else ""))
        self.code = pb.RESOURCE_EXHAUSTED
        self.retry_after_ms = int(retry_after_ms)


class StreamStalled(TimeoutError):
    """The generation stream stopped making progress within its stall
    bound: no FIRST token within ``ttft_timeout``, or no next token
    within ``inter_token_timeout``.  A ``TimeoutError`` subclass so
    generic timeout handling survives, but a distinct evidence class for
    routers (a stall fails the stream over in seconds instead of waiting
    out the coarse per-activity ``timeout``)."""

    def __init__(self, message: str, phase: str = "inter_token"):
        super().__init__(message)
        #: ``"ttft"`` (no first token) or ``"inter_token"`` (mid-stream)
        self.phase = phase


class GenerateStreamClient:
    """Client: ``generate(prompt, steps)`` yields tokens as they stream."""

    def __init__(self, manager: "RemoteInferenceManager", model_name: str):
        self._manager = manager
        self.model_name = model_name

    def generate(self, prompt, steps: int, timeout: float = 300.0,
                 priority: int = 0, temperature: float = 0.0,
                 top_k: int = 0, seed: Optional[int] = None,
                 stop_tokens=(), device_sampling: bool = False,
                 return_logprobs: bool = False, top_p: float = 0.0,
                 deadline_s: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 tenant_id: Optional[str] = None,
                 kv_shipment: Optional[bytes] = None,
                 prefill_only: bool = False,
                 resume_length: int = 0,
                 request_class: str = "",
                 ttft_timeout: Optional[float] = None,
                 inter_token_timeout: Optional[float] = None,
                 _cancel_evt=None,
                 _final: Optional[list] = None):
        """Yields token ids; with ``return_logprobs=True`` yields
        ``(token, logprob)`` pairs instead.

        ``deadline_s`` is the request's END-TO-END budget: the remaining
        budget rides the request (``deadline_ms``) so the server cancels
        the decode before its next token step, the stream carries it as
        the transport deadline (backstop), and expiry here raises
        :class:`~tpulab_torch.core.deadline.DeadlineExceeded`.
        ``timeout`` remains the per-activity stall bound.  ``trace_id``
        rides the request AND the metadata so server spans join the
        client's trace timeline.  ``tenant_id`` is the admission-control
        identity: it rides the request and the ``tpulab-tenant``
        metadata; an overloaded server fast-fails with
        :class:`ResourceExhausted` carrying its ``retry_after_ms`` hint.

        ``kv_shipment`` hands the server a prefill replica's wire-form KV
        snapshot to admit from; ``prefill_only=True`` asks for the prompt
        prefill + first token only (use :meth:`prefill_export`).
        ``resume_length=N`` marks a failover RESUME (the prompt already
        contains original_prompt + the N delivered tokens; the server
        emits from index N).  ``ttft_timeout`` / ``inter_token_timeout``
        split the stall bound (default: ``timeout``) and raise
        :class:`StreamStalled`.  ``_cancel_evt`` (private, a
        ``threading.Event``) ends the stream promptly when set;
        ``_final`` (private) receives the final GenerateResponse."""
        import queue as _q
        deadline = Deadline.after(deadline_s)
        out: "_q.Queue" = _q.Queue()
        # transport deadline trails the APP deadline slightly so the
        # server's clean DEADLINE_EXCEEDED status normally wins the race
        rem0 = deadline.remaining()
        metadata = list(TraceContext(trace_id).metadata()) if trace_id else []
        if tenant_id:
            from tpulab_torch.serving.admission import TENANT_METADATA_KEY
            metadata.append((TENANT_METADATA_KEY, tenant_id))
        stream = ClientStreaming(
            self._manager._executor, f"/{SERVICE_NAME}/Generate", out.put,
            pb.GenerateRequest.SerializeToString,
            pb.GenerateResponse.FromString,
            timeout=None if rem0 is None else rem0 + 2.0,
            metadata=metadata or None)
        # a dead stream must wake the consumer promptly, not via timeout
        _STREAM_DEAD = object()
        stream.done().add_done_callback(lambda _f: out.put(_STREAM_DEAD))
        req = pb.GenerateRequest(
            model_name=self.model_name,
            prompt=list(np.asarray(prompt, np.int32)), steps=steps,
            priority=priority, temperature=temperature, top_k=top_k,
            top_p=top_p,
            stop_tokens=[int(t) for t in stop_tokens],
            device_sampling=device_sampling,
            return_logprobs=return_logprobs)
        if trace_id:
            req.trace_id = trace_id
        if tenant_id:
            req.tenant_id = tenant_id
        if seed is not None:
            req.seed = seed
        if kv_shipment:
            req.kv_shipment = kv_shipment
        if prefill_only:
            req.prefill_only = True
        if resume_length:
            req.resume_length = int(resume_length)
        if request_class:
            req.request_class = request_class
        rem = deadline.remaining()
        if rem is not None:
            # RELATIVE budget, never wall clock: replica clocks differ
            req.deadline_ms = max(1, int(rem * 1e3))
        stream.write(req)
        stream.writes_done()
        finished = False
        got_first = False

        def _next_response():
            """One queue read under the phase's stall bound (TTFT before
            the first response, inter-token after), sliced into short
            polls when a hedge cancel event is watching."""
            bound = (ttft_timeout if not got_first
                     else inter_token_timeout)
            if bound is None:
                bound = timeout
            eff = deadline.bound(bound)
            if _cancel_evt is None:
                try:
                    return out.get(timeout=eff)
                except _q.Empty:
                    deadline.check("generation")
                    raise StreamStalled(
                        f"no generation stream activity within {bound}s "
                        f"({'TTFT' if not got_first else 'inter-token'} "
                        "stall bound)",
                        phase="ttft" if not got_first else "inter_token")
            t_end = None if eff is None else _time.monotonic() + eff
            while True:
                if _cancel_evt.is_set():
                    return None  # lost the hedge race: end quietly
                slice_s = 0.05
                if t_end is not None:
                    slice_s = min(slice_s, max(0.001, t_end - _time.monotonic()))
                try:
                    return out.get(timeout=slice_s)
                except _q.Empty:
                    if t_end is not None and _time.monotonic() >= t_end:
                        deadline.check("generation")
                        raise StreamStalled(
                            f"no generation stream activity within "
                            f"{bound}s", phase=("ttft" if not got_first
                                                else "inter_token"))
        try:
            while True:
                deadline.check("generation")
                # finished stays False on a stall: the finally-cancel
                # tears the stalled stream down and frees the server slot
                resp = _next_response()
                if resp is None:  # _cancel_evt set: cancelled, not failed
                    return
                got_first = True
                if resp is _STREAM_DEAD:
                    finished = True
                    exc = stream.done().exception()
                    raise (exc if exc is not None else RuntimeError(
                        "generation stream closed before completion"))
                if resp.final:
                    finished = True
                    if _final is not None:
                        _final.append(resp)
                    if resp.status.code == pb.DEADLINE_EXCEEDED:
                        raise DeadlineExceeded(resp.status.message
                                               or "deadline exceeded")
                    if resp.status.code == pb.RESOURCE_EXHAUSTED:
                        raise ResourceExhausted(resp.status.message,
                                                resp.status.retry_after_ms)
                    if resp.status.code not in (pb.SUCCESS, 0):
                        raise GenerationRejected(resp.status.code,
                                                 resp.status.message)
                    return
                yield ((resp.token, resp.logprob) if return_logprobs
                       else resp.token)
        finally:
            if not finished:
                # consumer abandoned the generator mid-stream: cancel so
                # the server stops decoding and frees the session slot
                stream.cancel()

    def prefill_export(self, prompt, timeout: float = 300.0,
                       **kw) -> tuple:
        """Run the prompt prefill on a PREFILL-role replica and return
        ``(first_token, shipment_bytes)`` — the handoff half of
        disaggregated serving.  ``shipment_bytes`` is None when the export
        degraded server-side; the caller then routes the request to a
        decode replica WITHOUT a shipment (local prefill there).  Keyword
        args are :meth:`generate`'s."""
        final: list = []
        toks = list(self.generate(prompt, 1, timeout=timeout,
                                  prefill_only=True, _final=final, **kw))
        blob = None
        if final and final[0].kv_shipment:
            blob = bytes(final[0].kv_shipment)
        return (toks[0] if toks else None), blob


# -- remote client ------------------------------------------------------------
class RemoteInferenceManager:
    """Client-side manager (reference PyRemoteInferenceManager); grpc is
    imported when it is constructed."""

    def __init__(self, hostname: str = "localhost:50051", channels: int = 1):
        self._executor = ClientExecutor(hostname, channels)
        self._status = ClientUnary(
            self._executor, f"/{SERVICE_NAME}/Status",
            pb.StatusRequest.SerializeToString, pb.StatusResponse.FromString)
        self._infer = ClientUnary(
            self._executor, f"/{SERVICE_NAME}/Infer",
            pb.InferRequest.SerializeToString, pb.InferResponse.FromString)
        self._health = ClientUnary(
            self._executor, f"/{SERVICE_NAME}/Health",
            pb.HealthRequest.SerializeToString, pb.HealthResponse.FromString)
        self._debug = ClientUnary(
            self._executor, f"/{SERVICE_NAME}/Debug",
            pb.DebugRequest.SerializeToString, pb.DebugResponse.FromString)
        self._fetch_kv = ClientUnary(
            self._executor, f"/{SERVICE_NAME}/FetchKV",
            pb.FetchKVRequest.SerializeToString,
            pb.FetchKVResponse.FromString)

    def health(self, timeout: float = 10.0) -> pb.HealthResponse:
        """Liveness/readiness probe (reference TRTIS Health)."""
        return self._health.start(pb.HealthRequest()).result(timeout=timeout)

    def health_async(self):
        return self._health.start(pb.HealthRequest())

    def debugz(self, model_name: str = "", profile_ticks: int = 0,
               profile_dir: str = "",
               timeout: Optional[float] = 30.0) -> dict:
        """Live engine introspection: the parsed snapshot document (lanes,
        the pool's size ladder, HBM claims and verify, modelstore leases,
        admission depths, chaos armament, flight exemplar ids).
        ``profile_ticks=N`` arms ``torch.profiler`` around the replica's
        next N batcher passes; the returned dict then carries
        ``profile_dir`` (the trace directory on the SERVER's
        filesystem).  Raises RuntimeError on UNKNOWN_MODEL /
        INVALID_ARGUMENT / INTERNAL."""
        import json as _json
        req = pb.DebugRequest(model_name=model_name,
                              profile_ticks=int(profile_ticks),
                              profile_dir=profile_dir)
        resp = self._debug.start(req).result(timeout=timeout)
        if resp.status.code not in (pb.SUCCESS, 0):
            raise RuntimeError(
                f"Debug failed ({pb.StatusCode.Name(resp.status.code)}): "
                f"{resp.status.message}")
        snap = _json.loads(resp.snapshot_json) if resp.snapshot_json else {}
        if resp.profile_dir:
            snap["profile_dir"] = resp.profile_dir
        if resp.status.message:
            snap["debug_message"] = resp.status.message
        return snap

    def debugz_raw(self, model_name: str = "", profile_ticks: int = 0,
                   timeout: Optional[float] = 30.0) -> pb.DebugResponse:
        """The raw DebugResponse (tests / tooling)."""
        return self._debug.start(pb.DebugRequest(
            model_name=model_name,
            profile_ticks=int(profile_ticks))).result(timeout=timeout)

    def fetch_kv(self, model_name: str, digest: bytes,
                 timeout: Optional[float] = 30.0) -> Optional[bytes]:
        """Fleet KV fabric fetch (:mod:`tpulab_torch.kvfabric`,
        docs/SERVING.md "Fleet KV fabric"): the wire-form snapshot
        published for ``digest`` on this replica, or None on an honest
        NOT_FOUND — exactly the ``connect``-client surface
        :class:`~tpulab_torch.kvfabric.KVFabric` pulls through.
        UNKNOWN_MODEL and INTERNAL raise (a misconfigured fleet should be
        loud); transport errors propagate for the fabric's degrade path
        to absorb."""
        resp = self._fetch_kv.start(pb.FetchKVRequest(
            model_name=model_name,
            digest=bytes(digest))).result(timeout=timeout)
        if resp.status.code == pb.NOT_FOUND:
            return None
        if resp.status.code not in (pb.SUCCESS, 0):
            raise RuntimeError(
                f"FetchKV failed ({pb.StatusCode.Name(resp.status.code)}): "
                f"{resp.status.message}")
        return bytes(resp.kv_shipment) if resp.kv_shipment else None

    def get_models(self,
                   timeout: Optional[float] = None) -> Dict[str, pb.ModelStatus]:
        resp = self._status.call(pb.StatusRequest(), timeout=timeout)
        if resp.status.code != pb.SUCCESS:
            raise RuntimeError(f"Status failed: {resp.status.message}")
        return {m.name: m for m in resp.models}

    def server_status(self,
                      timeout: Optional[float] = None) -> pb.StatusResponse:
        """The raw StatusResponse, including the live load gauges
        (``queued_requests`` / ``free_kv_pages``) replica routers use to
        break inflight ties."""
        return self._status.call(pb.StatusRequest(), timeout=timeout)

    def server_status_async(self):
        return self._status.start(pb.StatusRequest())

    def infer_runner(self, model_name: str,
                     timeout: Optional[float] = None) -> "InferRemoteRunner":
        """``timeout`` bounds the first-contact Status RPC — an
        UNRESPONSIVE endpoint must not hang construction past the
        caller's budget."""
        models = self.get_models(timeout=timeout)
        if model_name not in models:
            raise KeyError(f"unknown remote model {model_name!r}")
        return InferRemoteRunner(self, model_name, models[model_name])

    def close(self) -> None:
        self._executor.close()


class StreamInferClient:
    """Pipelined streaming client (reference client_streaming v3 usage):
    ``submit(**arrays) -> Future`` over one bidi stream; responses correlate
    by id."""

    def __init__(self, manager: "RemoteInferenceManager", model_name: str):
        self.model_name = model_name
        self._lock = threading.Lock()
        self._pending: Dict[int, object] = {}
        self._next_id = 1
        self._stream = ClientStreaming(
            manager._executor, f"/{SERVICE_NAME}/StreamInfer",
            self._on_response,
            pb.InferRequest.SerializeToString, pb.InferResponse.FromString)
        # a dead stream must fail every outstanding future, not strand them
        self._stream.done().add_done_callback(self._on_stream_done)

    def _on_stream_done(self, done_fut) -> None:
        exc = done_fut.exception()
        with self._lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc or RuntimeError(
                    "stream closed with responses outstanding"))

    def _on_response(self, resp: pb.InferResponse) -> None:
        with self._lock:
            fut = self._pending.pop(resp.correlation_id, None)
        if fut is None:
            return
        try:
            if resp.status.code != pb.SUCCESS:
                raise RuntimeError(
                    f"stream inference failed: {resp.status.message}")
            result = {t.name: proto_to_tensor(t) for t in resp.outputs}
        except Exception as e:  # malformed tensors must fail THIS future,
            fut.set_exception(e)  # not strand it
            return
        fut.set_result(result)

    def submit(self, **arrays: np.ndarray):
        from concurrent.futures import Future
        if not arrays:
            raise ValueError("no input arrays")
        fut: Future = Future()
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            self._pending[cid] = fut
        if self._stream.done().done():
            # stream already died: _on_stream_done may have run before this
            # registration — fail now rather than stranding the caller
            with self._lock:
                self._pending.pop(cid, None)
            exc = self._stream.done().exception()
            fut.set_exception(exc or RuntimeError("stream is closed"))
            return fut
        req = pb.InferRequest(model_name=self.model_name,
                              batch_size=next(iter(arrays.values())).shape[0],
                              correlation_id=cid)
        for name, arr in arrays.items():
            req.inputs.append(tensor_to_proto(name, arr))
        self._stream.write(req)
        return fut

    def close(self) -> None:
        """Half-close and wait for the server's drain; stream errors
        propagate (pending futures were already failed by the callback)."""
        self._stream.writes_done()
        self._stream.done().result(timeout=330)


class InferRemoteRunner:
    """numpy-in / numpy-out remote runner (reference PyInferRemoteRunner)."""

    def __init__(self, manager: RemoteInferenceManager, model_name: str,
                 status: pb.ModelStatus):
        self._mgr = manager
        self.model_name = model_name
        self.status = status

    def input_bindings(self) -> Dict[str, tuple]:
        return {s.name: (tuple(s.dims), np.dtype(s.dtype))
                for s in self.status.inputs}

    def output_bindings(self) -> Dict[str, tuple]:
        return {s.name: (tuple(s.dims), np.dtype(s.dtype))
                for s in self.status.outputs}

    def infer(self, requested_outputs=None, timeout=None, trace_id=None,
              tenant_id=None, **arrays: np.ndarray):
        """Future of dict-of-numpy outputs.

        ``requested_outputs`` optionally names a subset of the model's
        outputs; unknown names fail the request with INVALID_ARGUMENT.
        ``timeout`` (seconds) becomes the call's deadline.  ``trace_id``
        rides the request and the metadata.  ``tenant_id`` is the
        admission-control identity; an overloaded server fails the future
        with :class:`ResourceExhausted`.  Model inputs literally named
        ``requested_outputs``, ``timeout``, ``trace_id`` or ``tenant_id``
        still work: ndarray values are rebound as inputs.
        """
        if isinstance(requested_outputs, np.ndarray):
            arrays["requested_outputs"] = requested_outputs
            requested_outputs = None
        if isinstance(timeout, np.ndarray):
            arrays["timeout"] = timeout
            timeout = None
        if isinstance(trace_id, np.ndarray):
            arrays["trace_id"] = trace_id
            trace_id = None
        if isinstance(tenant_id, np.ndarray):
            arrays["tenant_id"] = tenant_id
            tenant_id = None
        if not arrays:
            raise ValueError("no input arrays")
        batch = next(iter(arrays.values())).shape[0]
        req = pb.InferRequest(model_name=self.model_name, batch_size=batch)
        if trace_id:
            req.trace_id = trace_id
        if tenant_id:
            req.tenant_id = tenant_id
        if requested_outputs:
            req.requested_outputs.extend(requested_outputs)
        for name, arr in arrays.items():
            req.inputs.append(tensor_to_proto(name, arr))

        def on_complete(resp: pb.InferResponse) -> Dict[str, np.ndarray]:
            if resp.status.code == pb.RESOURCE_EXHAUSTED:
                raise ResourceExhausted(resp.status.message,
                                        resp.status.retry_after_ms)
            if resp.status.code != pb.SUCCESS:
                raise RuntimeError(
                    f"remote inference failed ({pb.StatusCode.Name(resp.status.code)}): "
                    f"{resp.status.message}")
            return {t.name: proto_to_tensor(t) for t in resp.outputs}

        metadata = list(TraceContext(trace_id).metadata()) if trace_id else []
        if tenant_id:
            from tpulab_torch.serving.admission import TENANT_METADATA_KEY
            metadata.append((TENANT_METADATA_KEY, tenant_id))
        return self._mgr._infer.start(
            req, on_complete, timeout=timeout, metadata=metadata or None)
