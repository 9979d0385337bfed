"""Top-level serving API (the port of ``tpulab/_api.py``; reference
trtlab/pybind/trtlab/infer.cc:683-735: InferenceManager, InferRunner,
RemoteInferenceManager, InferFuture).

The engine's InferenceManager already speaks numpy, so this layer only adds
the module-level ergonomics: ``serve()`` (reference manager.serve()),
``drain()`` and the remote manager re-export.  ``runner.infer(**arrays)``
returns a concurrent.futures.Future — ``.result()`` plays
InferFuture.get().

Nothing here imports grpc: ``serve`` builds the service and starts it
over grpc, and on a machine without grpc the start raises the
``ImportError`` that names it (the built server stays reachable as
``manager.server`` for in-process calls, ``Server.invoke``).
"""

from __future__ import annotations

from typing import Optional

from tpulab_torch.engine.inference_manager import \
    InferenceManager as _EngineManager
from tpulab_torch.rpc.infer_service import (InferRemoteRunner,  # noqa: F401
                                            RemoteInferenceManager,
                                            build_infer_service)


class InferenceManager(_EngineManager):
    """Engine manager + serve() (reference PyInferenceManager)."""

    def __init__(self, max_exec_concurrency: int = 2, max_buffers: int = 0,
                 device=None, coalesce_h2d: bool = False):
        # reference kwarg name: max_exec_concurrency (infer.cc:86-96)
        super().__init__(max_executions=max_exec_concurrency,
                         max_buffers=max_buffers, device=device,
                         coalesce_h2d=coalesce_h2d)
        self._server = None
        self._modelstore = None

    def serve(self, port: int = 50051, wait: bool = False,
              executor=None, batching: bool = False,
              batch_window_s: float = 0.002,
              metrics=None, generation_engines=None,
              watchdog=None, trace=None,
              admission=None, role: str = "unified",
              models=None, modelstore=None,
              model_hbm_budget: Optional[int] = None,
              model_host_budget: Optional[int] = None,
              pinned_models=(), hbm=None,
              flight=None, fleet=None, kvfabric=None) -> "InferenceManager":
        """Expose registered models over the TRTIS-style service
        (reference manager.serve() -> BasicInferService).
        ``batching=True`` enables server-side dynamic batching across
        concurrent callers; ``generation_engines={name: engine}`` (a
        ``ContinuousBatcher`` or a ``GenerationEngine``) serves token
        streaming over the Generate RPC; ``trace=ChromeTraceRecorder()``
        records per-request lifecycle spans (utils.tracing);
        ``admission=AdmissionController(...)`` (tpulab_torch.serving) arms
        the QoS frontend gate; ``role="prefill"|"decode"|"unified"``
        declares the replica's disaggregated-serving role, reported over
        the Status RPC.

        Multi-model serving: ``models=["resnet50", "vit_b16", ...]``
        builds and registers those :mod:`tpulab_torch.models.registry`
        names on the manager's device, and with ``model_hbm_budget``
        (bytes) arms a :class:`tpulab_torch.modelstore.WeightMultiplexer`
        over them — cold weights park in the budgeted host tier
        (``model_host_budget``) and requests swap their model hot on
        demand; ``pinned_models`` stay permanently resident.  Pass an
        existing ``modelstore`` to share one multiplexer with generation
        engines registered via ``BatcherAdapter``.

        ``hbm=HBMArbiter(...)`` (tpulab_torch.hbm) arms the unified
        device-memory economy: pass the same arbiter to the engines and
        the modelstore that rent from it — the Status RPC then reports
        the single ``free_hbm_bytes`` headroom and an attached admission
        controller adopts it.

        ``flight=FlightRecorder(...)`` (tpulab_torch.obs) records one
        wide event per Infer and Generate request and backs the Debug
        RPC's exemplar pointers; ``watchdog=DeviceWatchdog(...).start()``
        (tpulab_torch.utils.watchdog) turns Health not-ready while the
        device misses its canary deadline; ``metrics=InferenceMetrics()``
        (tpulab_torch.utils.metrics) observes every Infer request — scrape
        it with ``start_metrics_server``.

        ``fleet=FleetController(...)`` (tpulab_torch.fleet) adds the
        control plane's election / supervision / autoscaling document to
        the Debug snapshot; ``kvfabric=KVFabric(...)``
        (tpulab_torch.kvfabric) pulls a routed-astray prompt's finished
        prefill from its home replica instead of recomputing it, and the
        ``FetchKV`` RPC serves this replica's published prefills (engines
        built with ``kv_publish=True``).  Without grpc the start raises
        ``ImportError`` (module docstring)."""
        builders = {}
        if models:
            from tpulab_torch.models.registry import build_model
            for name in models:
                builders[name] = (lambda n=name: build_model(
                    n, device=self.device))
                if name not in self._models:
                    self.register_model(name, builders[name]())
        if not self._allocated:
            # generation-only serving needs no dense models
            self.update_resources(allow_empty=bool(generation_engines))
        if modelstore is None and models and model_hbm_budget:
            from tpulab_torch.modelstore import WeightMultiplexer
            kw = {}
            if model_host_budget:
                kw["host_budget_bytes"] = int(model_host_budget)
            # share the manager's write-behind TransferEngine: weight
            # swap-outs ride the same collector the KV tier uses
            modelstore = WeightMultiplexer(int(model_hbm_budget),
                                           transfer=self._transfer_engine,
                                           **kw)
        if modelstore is not None and models:
            from tpulab_torch.modelstore import CompiledModelAdapter
            for name in models:
                if name not in modelstore:
                    modelstore.register(
                        name,
                        CompiledModelAdapter(self.compiled(name),
                                             builders.get(name)),
                        pinned=name in (pinned_models or ()))
        self._modelstore = modelstore
        self._server = build_infer_service(
            self, f"0.0.0.0:{port}", executor=executor, batching=batching,
            batch_window_s=batch_window_s, metrics=metrics, trace=trace,
            generation_engines=generation_engines, watchdog=watchdog,
            admission=admission, role=role, modelstore=modelstore,
            hbm=hbm, flight=flight, fleet=fleet, kvfabric=kvfabric)
        if wait:
            self._server.run()
        else:
            self._server.async_start()
            self._server.wait_until_running()
        return self

    @property
    def server(self):
        return self._server

    @property
    def modelstore(self):
        """The armed :class:`tpulab_torch.modelstore.WeightMultiplexer`
        (None = single-model serving)."""
        return self._modelstore

    def drain(self, timeout: float = 30.0, poll_s: float = 0.05,
              settle_s: float = 10.0) -> bool:
        """Graceful rolling-restart drain (the k8s preStop pattern):
        readiness flips false immediately — health-checking balancers
        rotate this replica out — while in-flight and late-arriving
        requests keep being served.

        Holds for at least ``settle_s`` even when idle, so the balancer
        OBSERVES the readiness flip before shutdown; then waits for
        in-flight (unary AND generation streams) to reach zero.  Returns
        drained status; call :meth:`shutdown` after."""
        import time as _time
        if self._server is None:
            return True
        res = self._server._infer_resources
        res.draining = True
        t0 = _time.monotonic()
        deadline = t0 + max(timeout, settle_s)
        while _time.monotonic() < deadline:
            settled = _time.monotonic() - t0 >= settle_s
            if settled and res.inflight_requests == 0:
                return True
            _time.sleep(poll_s)
        return res.inflight_requests == 0

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()  # owns the attached service resources
            self._server = None
        if self._modelstore is not None:
            # before super(): swap-out drains need the (shared) transfer
            # engine alive
            self._modelstore.close()
            self._modelstore = None
        super().shutdown()


def serve(manager: InferenceManager, port: int = 50051, **kw):
    return manager.serve(port=port, **kw)
