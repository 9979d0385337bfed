"""Request-lifecycle contexts (the port of ``tpulab/rpc/context.py``;
reference context.h:41-158 + life_cycle_*.h).

A Context class is instantiated per in-flight request, and — like the
reference's pre-armed CQ contexts — unary contexts are POOLED and recycled
across requests (server._RPCDef free-lists).  The reuse contract: instance
attributes set during ``execute_rpc`` are per-request state and are stripped
when the context returns to the pool; only construction-time attributes
survive recycling.  Streaming/batching contexts carry per-stream state and
are never pooled.  Contexts
see their service-wide :class:`~tpulab_torch.core.resources.Resources` and timing
hooks.

- ``Context`` (unary): implement ``execute_rpc(request) -> response``
- ``StreamingContext`` (bidi): implement ``on_request(request)``; call
  ``self.write(response)`` any number of times; ``on_requests_finished()``
  fires after the client's last request (reference ServerStream semantics)
- ``BatchingContext``: unary front over the core Dispatcher — requests from
  many callers aggregate into batches; implement
  ``execute_batch(requests) -> responses`` (reference life_cycle_batching.h
  + examples/03's batching middleman, folded into one component)

Under a :class:`~tpulab_torch.rpc.executor.FiberExecutor`, ``execute_rpc`` /
``on_request`` may be coroutines (``async def``) and may await pool pops and
device readiness — the boost.fiber property of the reference.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

from tpulab_torch.core.resources import Resources


class BaseContext:
    """Shared context surface (reference BaseContext)."""

    def __init__(self, resources: Optional[Resources] = None):
        self._resources = resources
        self._start = time.monotonic()
        self.grpc_context = None  # populated by the server shim

    def get_resources(self, cls=None):
        if cls is not None and self._resources is not None:
            return self._resources.cast(cls)
        return self._resources

    def walltime(self) -> float:
        """Seconds since the request started (reference Walltime())."""
        return time.monotonic() - self._start

    # lifecycle/metrics hooks (reference OnLifeCycleStart/Reset + NVRPC
    # metrics hooks context.h:104-122)
    def on_lifecycle_start(self) -> None:
        self._start = time.monotonic()

    def on_lifecycle_reset(self) -> None:
        pass

    def cancel(self) -> None:
        if self.grpc_context is not None:
            self.grpc_context.cancel()


class Context(BaseContext):
    """Unary lifecycle (reference LifeCycleUnary + Context<Req,Resp,Res>)."""

    def execute_rpc(self, request):  # -> response
        raise NotImplementedError


class StreamingContext(BaseContext):
    """Bidirectional streaming lifecycle (reference LifeCycleStreaming).

    The server shim sets ``self.write`` to a thread-safe response writer
    before the first ``on_request`` (reference ServerStream write-from-any-
    thread semantics).
    """

    def __init__(self, resources: Optional[Resources] = None):
        super().__init__(resources)
        self.write: Callable[[Any], None] = lambda resp: None

    def on_stream_initialized(self) -> None:
        pass

    def on_request(self, request) -> None:
        raise NotImplementedError

    def on_requests_finished(self) -> None:
        pass


class BatchingContext(BaseContext):
    """Batch-collecting lifecycle (reference LifeCycleBatching):
    N unary calls -> one ``execute_batch`` -> N responses.

    Class attributes configure the window (mirroring the reference batcher
    knobs): ``max_batch_size``, ``batch_window_s``.
    """

    max_batch_size: int = 8
    batch_window_s: float = 0.005

    def execute_batch(self, requests: List[Any]) -> List[Any]:
        raise NotImplementedError
