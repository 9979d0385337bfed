"""Server + service registration (the port of ``tpulab/rpc/server.py``;
reference server.h:40-89, service.h:35-61, rpc.h:35-73).

The reference's surface — ``Server``, ``AsyncService.register_rpc``,
executors, per-request contexts — with the request *behaviors* (what a
unary, streaming or batching RPC does with its context, tpulab's
``_make_sync_handler`` / ``_make_aio_handler`` bodies) built without
grpc.  grpc is only the transport: ``async_start`` imports it and wraps
each behavior in a generic method handler, and starting without grpc
raises the ``ImportError`` that names it (no fallback).

The same behaviors serve in process, serialized bytes in and serialized
bytes out, through :meth:`Server.invoke` (unary and batching RPCs) and
:meth:`Server.invoke_stream` (streaming RPCs), with a
:class:`LocalServicerContext` in the place of grpc's servicer context
(invocation metadata, a transport deadline, cancellation).  That is how
the service runs on a machine without grpc.

Lifecycle mapping:
- ``Executor`` (threads) -> ``grpc.server`` with a worker pool and
  ``maximum_concurrent_rpcs`` as the pre-armed-context bound
- ``FiberExecutor`` -> ``grpc.aio`` server on a dedicated event-loop thread;
  context bodies may be coroutines (handlers await without costing threads)
- ``Server.run(control_fn, control_period_s)`` runs a periodic control lambda
  exactly like the reference's NVML power-gauge loop (server.cc:322-331)
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import queue as _queue
import threading
import time
from concurrent import futures as _futures
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Type

from tpulab_torch.core.dispatcher import AsyncDispatcher, Dispatcher
from tpulab_torch.core.resources import Resources
from tpulab_torch.rpc._transport import require_grpc
from tpulab_torch.rpc.context import BatchingContext, StreamingContext
from tpulab_torch.rpc.executor import Executor, FiberExecutor

log = logging.getLogger("tpulab_torch.rpc")

_STREAM_END = object()


class StreamHandlerError(RuntimeError):
    """A streaming context's handler raised: the stream ends in error
    (``INTERNAL`` over grpc, this exception to an in-process caller)."""


class LocalServicerContext:
    """The servicer context of an in-process call: what the service reads
    of grpc's (``invocation_metadata``, ``time_remaining``,
    ``is_active``) plus ``cancel`` for the caller's side, which is what a
    client dropping its stream looks like to the server."""

    def __init__(self, metadata: Iterable = (),
                 timeout: Optional[float] = None):
        self._metadata = tuple((str(k), str(v)) for k, v in metadata)
        self._deadline = (None if timeout is None
                          else time.monotonic() + float(timeout))
        self._cancelled = threading.Event()

    def invocation_metadata(self):
        return self._metadata

    def time_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def is_active(self) -> bool:
        return not self._cancelled.is_set() and (
            self._deadline is None or time.monotonic() < self._deadline)

    def cancel(self) -> None:
        """End the call from the client's side (the client dropped)."""
        self._cancelled.set()


class _RPCDef:
    def __init__(self, name, context_cls, req_des, resp_ser, resources):
        self.name = name
        self.context_cls = context_cls
        self.req_des = req_des
        self.resp_ser = resp_ser
        self.resources = resources
        self.dispatcher = None  # built for BatchingContext at server start
        # pre-armed context free-list (reference pre-allocated contexts,
        # executor.cc:48-67): unary contexts recycle through here instead
        # of re-instantiating per call.  Streaming/batching contexts carry
        # per-stream state and are never pooled.
        self.ctx_pool: List[Any] = []
        self.ctx_pool_lock = threading.Lock()
        self.ctx_pool_cap = 0  # set at server start from the executor

    @property
    def streaming(self) -> bool:
        return issubclass(self.context_cls, StreamingContext)

    def acquire_context(self):
        with self.ctx_pool_lock:
            if self.ctx_pool:
                return self.ctx_pool.pop()
        ctx = self.context_cls(self.resources)
        # reuse contract: anything set during execute_rpc is per-request
        # state and is stripped on release; only construction-time
        # attributes survive recycling (so a pooled context looks freshly
        # constructed to the next — possibly different — client).
        ctx._pool_baseline = frozenset(ctx.__dict__) | {"_pool_baseline"}
        return ctx

    def release_context(self, ctx) -> None:
        ctx.grpc_context = None
        baseline = getattr(ctx, "_pool_baseline", None)
        if baseline is not None:
            for attr in [k for k in ctx.__dict__ if k not in baseline]:
                del ctx.__dict__[attr]
        with self.ctx_pool_lock:
            if len(self.ctx_pool) < self.ctx_pool_cap:
                self.ctx_pool.append(ctx)


class AsyncService:
    """Named service: a method table of RPC name -> Context class
    (reference AsyncService::RegisterRPC)."""

    def __init__(self, name: str, resources: Optional[Resources] = None):
        self.name = name
        self.resources = resources
        self._rpcs: Dict[str, _RPCDef] = {}

    def register_rpc(self, method: str, context_cls: Type,
                     request_deserializer: Callable[[bytes], Any] = None,
                     response_serializer: Callable[[Any], bytes] = None,
                     resources: Optional[Resources] = None) -> None:
        """Bind an RPC method to its per-request Context class."""
        self._rpcs[method] = _RPCDef(
            method, context_cls,
            request_deserializer or (lambda b: b),
            response_serializer or (lambda m: m if isinstance(m, bytes) else bytes(m)),
            resources or self.resources)

    @property
    def rpcs(self) -> Dict[str, _RPCDef]:
        return self._rpcs


class Server:
    """RPC server owning services + executors (reference Server)."""

    def __init__(self, address: str = "0.0.0.0:50051",
                 executor: Optional[Executor | FiberExecutor] = None):
        self.address = address
        self.executor = executor or Executor()
        self._services: List[AsyncService] = []
        self._server = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._stop = threading.Event()
        self._worker_pool: Optional[_futures.ThreadPoolExecutor] = None
        self.bound_port: Optional[int] = None
        #: in-process behaviors ("/service/method" -> (rpc, behavior)),
        #: built on the first invoke
        self._local: Optional[Dict[str, tuple]] = None
        self._local_lock = threading.Lock()

    # -- registration --------------------------------------------------------
    def register_async_service(self, service: AsyncService) -> AsyncService:
        self._services.append(service)
        return service

    def register_executor(self, executor) -> None:
        """Reference parity: swap the execution domain before start."""
        self.executor = executor

    # -- lifecycle ------------------------------------------------------------
    def async_start(self) -> None:
        """Start serving over grpc without blocking (reference
        AsyncStart); raises ``ImportError`` without grpc."""
        if self.executor.is_fiber:
            self._start_aio()
        else:
            self._start_sync()
        self._running.set()

    def run(self, control_fn: Optional[Callable[[], None]] = None,
            control_period_s: float = 2.0) -> None:
        """Serve until shutdown; runs control_fn every period
        (reference Server::Run(timeout, control_fn))."""
        if not self._running.is_set():  # idempotent after async_start()
            self.async_start()
        try:
            while not self._stop.wait(timeout=control_period_s):
                if control_fn is not None:
                    try:
                        control_fn()
                    except Exception:
                        log.exception("control lambda failed")
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self, grace_s: float = 2.0) -> None:
        self._stop.set()
        if self._server is None and self._local is None:
            return
        if self._server is not None:
            if self.executor.is_fiber:
                async def _stop_server():
                    await self._server.stop(grace_s)
                fut = asyncio.run_coroutine_threadsafe(_stop_server(),
                                                       self._loop)
                fut.result(timeout=grace_s + 5)
                self._loop.call_soon_threadsafe(self._loop.stop)
                self._loop_thread.join(timeout=5)
            else:
                self._server.stop(grace_s).wait(timeout=grace_s + 5)
        # release execution resources the server created (reference
        # Executor/ThreadPool teardown on Shutdown)
        for service in self._services:
            for rpc in service.rpcs.values():
                if rpc.dispatcher is not None:
                    if hasattr(rpc.dispatcher, "shutdown"):
                        rpc.dispatcher.shutdown()
                    rpc.dispatcher = None
        if self._worker_pool is not None:
            self._worker_pool.shutdown(wait=False)
            self._worker_pool = None
        # attached service resources (e.g. infer_service's batched runners /
        # generate workers) are owned by the server lifecycle
        res = getattr(self, "_infer_resources", None)
        if res is not None and hasattr(res, "shutdown"):
            try:
                res.shutdown()
            except Exception:  # pragma: no cover
                log.exception("service resources shutdown failed")
        self._server = None
        self._local = None
        self._running.clear()

    def wait_until_running(self, timeout: float = 10.0) -> None:
        if not self._running.wait(timeout):
            raise TimeoutError("server did not start")

    # -- in process (no grpc) -------------------------------------------------
    def _local_behaviors(self) -> Dict[str, tuple]:
        with self._local_lock:
            if self._local is None:
                if self._server is not None and self.executor.is_fiber:
                    raise RuntimeError(
                        "in-process calls run the thread executor's "
                        "behaviors; this server serves a FiberExecutor "
                        "over grpc.aio")
                table = {}
                cap = min(self.executor.max_concurrency, 256)
                for service in self._services:
                    for rpc in service.rpcs.values():
                        if self._server is not None:
                            # the grpc server's behaviors already own the
                            # dispatcher: share it
                            behavior = self._sync_behavior(rpc, build=False)
                        else:
                            rpc.ctx_pool_cap = cap
                            behavior = self._sync_behavior(rpc)
                        table[f"/{service.name}/{rpc.name}"] = (rpc,
                                                                behavior)
                self._local = table
            return self._local

    def _lookup(self, method: str, streaming: bool):
        try:
            rpc, behavior = self._local_behaviors()[method]
        except KeyError:
            raise KeyError(f"no RPC {method!r} registered") from None
        if rpc.streaming != streaming:
            raise TypeError(f"{method} is a "
                            f"{'streaming' if rpc.streaming else 'unary'} "
                            "RPC")
        return rpc, behavior

    def invoke(self, method: str, request: bytes,
               context: Optional[LocalServicerContext] = None) -> bytes:
        """Serve one unary (or batching) call in process: ``method`` is
        the full path (``/<service>/<rpc>``), ``request`` the serialized
        request; returns the serialized response.  The context bodies are
        the ones the grpc server runs."""
        rpc, behavior = self._lookup(method, streaming=False)
        resp = behavior(rpc.req_des(request),
                        context or LocalServicerContext())
        return rpc.resp_ser(resp)

    def invoke_stream(self, method: str, requests: Iterable[bytes],
                      context: Optional[LocalServicerContext] = None
                      ) -> Iterator[bytes]:
        """Serve one streaming call in process: serialized requests in,
        an iterator of serialized responses out.  A handler failure
        raises :class:`StreamHandlerError` after the responses written
        before it; ``context.cancel()`` is the client dropping."""
        rpc, behavior = self._lookup(method, streaming=True)
        reqs = (rpc.req_des(b) for b in requests)
        for resp in behavior(reqs, context or LocalServicerContext()):
            yield rpc.resp_ser(resp)

    # -- the behaviors (thread executor) --------------------------------------
    def _sync_behavior(self, rpc: _RPCDef, build: bool = True):
        """The grpc-free body of an RPC on the thread executor: a
        ``(request, ctx) -> response`` function, or for streaming RPCs a
        ``(request_iterator, ctx) -> iterator of responses`` generator.
        ``build`` creates the batching dispatcher (once per server)."""
        if rpc.streaming:
            def stream_behavior(request_iterator, grpc_ctx):
                ctx = rpc.context_cls(rpc.resources)
                ctx.grpc_context = grpc_ctx
                out: _queue.Queue = _queue.Queue()
                ctx.write = out.put
                ctx.on_stream_initialized()

                errors: List[BaseException] = []

                def reader():
                    try:
                        for req in request_iterator:
                            ctx.on_request(req)
                        ctx.on_requests_finished()
                    except BaseException as e:  # noqa: BLE001
                        errors.append(e)
                    finally:
                        out.put(_STREAM_END)

                t = threading.Thread(target=reader, daemon=True)
                t.start()
                while True:
                    item = out.get()
                    if item is _STREAM_END:
                        break
                    yield item
                t.join()
                if errors:
                    # the handler failure ends the stream in error instead
                    # of a clean OK completion
                    raise StreamHandlerError(str(errors[0])) from errors[0]
            return stream_behavior

        if issubclass(rpc.context_cls, BatchingContext):
            cls = rpc.context_cls
            if build:
                def execute(items, complete):
                    ctx = cls(rpc.resources)
                    responses = ctx.execute_batch(
                        [it["request"] for it in items])
                    for it, resp in zip(items, responses):
                        it["response"] = resp
                    complete(None)

                rpc.dispatcher = Dispatcher(
                    max_batch_size=cls.max_batch_size,
                    window_s=cls.batch_window_s,
                    execute_fn=execute, n_workers=2)

            def batch_behavior(request, grpc_ctx):
                item = {"request": request}
                rpc.dispatcher.enqueue(item).result()
                return item["response"]
            return batch_behavior

        def unary_behavior(request, grpc_ctx):
            ctx = rpc.acquire_context()   # pre-armed context free-list
            ctx.grpc_context = grpc_ctx
            ctx.on_lifecycle_start()
            try:
                return ctx.execute_rpc(request)
            finally:
                ctx.on_lifecycle_reset()
                rpc.release_context(ctx)
        return unary_behavior

    # -- sync (thread Executor) ----------------------------------------------
    def _start_sync(self) -> None:
        grpc = require_grpc()
        ex = self.executor
        # the executor OWNS the worker pool: sizing to the pre-armed-context
        # bound (reference contexts_per_thread) and pinning each worker to
        # the executor's cpu plan (reference CQ-thread affinity)
        pool = ex.build_worker_pool()
        self._worker_pool = pool
        self._server = grpc.server(
            pool, maximum_concurrent_rpcs=ex.max_concurrency)
        with self._local_lock:
            self._local = None      # rebuilt over the server's dispatchers
        for service in self._services:
            for rpc in service.rpcs.values():
                if rpc.dispatcher is not None:  # built by an in-process call
                    rpc.dispatcher.shutdown()
                    rpc.dispatcher = None
        for service in self._services:
            handlers = {}
            for rpc in service.rpcs.values():
                rpc.ctx_pool_cap = min(ex.max_concurrency, 256)
                handlers[rpc.name] = self._make_sync_handler(grpc, rpc)
            self._server.add_generic_rpc_handlers(
                (grpc.method_handlers_generic_handler(service.name, handlers),))
        self.bound_port = self._server.add_insecure_port(self.address)
        self._server.start()

    def _make_sync_handler(self, grpc, rpc: _RPCDef):
        behavior = self._sync_behavior(rpc)
        if rpc.streaming:
            def stream_handler(request_iterator, grpc_ctx):
                try:
                    yield from behavior(request_iterator, grpc_ctx)
                except StreamHandlerError as e:
                    grpc_ctx.abort(grpc.StatusCode.INTERNAL, str(e))
            return grpc.stream_stream_rpc_method_handler(
                stream_handler, rpc.req_des, rpc.resp_ser)
        return grpc.unary_unary_rpc_method_handler(
            behavior, rpc.req_des, rpc.resp_ser)

    # -- aio (FiberExecutor) ---------------------------------------------------
    def _start_aio(self) -> None:
        grpc = require_grpc()
        started = threading.Event()
        startup_error: List[BaseException] = []

        def loop_main():
            if hasattr(self.executor, "pin_loop_thread"):
                self.executor.pin_loop_thread()  # reference thread affinity
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop

            async def boot():
                server = grpc.aio.server(
                    maximum_concurrent_rpcs=self.executor.max_concurrency)
                for service in self._services:
                    handlers = {}
                    for rpc in service.rpcs.values():
                        rpc.ctx_pool_cap = min(
                            self.executor.max_concurrency, 256)
                        handlers[rpc.name] = self._make_aio_handler(grpc, rpc)
                    server.add_generic_rpc_handlers(
                        (grpc.method_handlers_generic_handler(
                            service.name, handlers),))
                self.bound_port = server.add_insecure_port(self.address)
                await server.start()
                self._server = server

            try:
                loop.run_until_complete(boot())
            except BaseException as e:  # noqa: BLE001
                startup_error.append(e)
                started.set()
                return
            started.set()
            loop.run_forever()

        self._loop_thread = threading.Thread(target=loop_main, name="rpc-aio",
                                             daemon=True)
        self._loop_thread.start()
        started.wait(timeout=10)
        if startup_error:
            raise startup_error[0]

    def _aio_behavior(self, rpc: _RPCDef):
        """The grpc-free body of an RPC on the event-loop executor
        (coroutines; streaming RPCs are async generators)."""
        async def maybe_await(x):
            return await x if inspect.isawaitable(x) else x

        if rpc.streaming:
            async def stream_behavior(request_iterator, grpc_ctx):
                ctx = rpc.context_cls(rpc.resources)
                ctx.grpc_context = grpc_ctx
                out: asyncio.Queue = asyncio.Queue()
                loop = asyncio.get_running_loop()

                def write(resp):  # thread-safe writer (reference ServerStream)
                    loop.call_soon_threadsafe(out.put_nowait, resp)
                ctx.write = write
                await maybe_await(ctx.on_stream_initialized())

                async def reader():
                    try:
                        async for req in request_iterator:
                            await maybe_await(ctx.on_request(req))
                        await maybe_await(ctx.on_requests_finished())
                    finally:
                        # always posted, and through the same scheduling path
                        # as write() so it cannot overtake earlier responses
                        loop.call_soon_threadsafe(out.put_nowait, _STREAM_END)

                task = asyncio.ensure_future(reader())
                while True:
                    item = await out.get()
                    if item is _STREAM_END:
                        break
                    yield item
                await task  # re-raises handler failures as a stream error
            return stream_behavior

        if issubclass(rpc.context_cls, BatchingContext):
            cls = rpc.context_cls

            async def execute(items, complete):
                ctx = cls(rpc.resources)
                result = ctx.execute_batch([it["request"] for it in items])
                responses = await maybe_await(result)
                for it, resp in zip(items, responses):
                    it["response"] = resp
                complete(None)

            def get_dispatcher():
                if rpc.dispatcher is None:
                    rpc.dispatcher = AsyncDispatcher(
                        max_batch_size=cls.max_batch_size,
                        window_s=cls.batch_window_s, execute_fn=execute)
                return rpc.dispatcher

            async def batch_behavior(request, grpc_ctx):
                item = {"request": request}
                await get_dispatcher().enqueue(item)
                return item["response"]
            return batch_behavior

        async def unary_behavior(request, grpc_ctx):
            ctx = rpc.acquire_context()   # pre-armed context free-list
            ctx.grpc_context = grpc_ctx
            ctx.on_lifecycle_start()
            try:
                return await maybe_await(ctx.execute_rpc(request))
            finally:
                ctx.on_lifecycle_reset()
                rpc.release_context(ctx)
        return unary_behavior

    def _make_aio_handler(self, grpc, rpc: _RPCDef):
        behavior = self._aio_behavior(rpc)
        if rpc.streaming:
            return grpc.stream_stream_rpc_method_handler(
                behavior, rpc.req_des, rpc.resp_ser)
        return grpc.unary_unary_rpc_method_handler(
            behavior, rpc.req_des, rpc.resp_ser)
