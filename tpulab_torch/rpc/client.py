"""RPC clients (the port of ``tpulab/rpc/client.py``; reference
client/executor.h, client_unary.h:41-140, client_streaming*.h).

grpc is imported when a :class:`ClientExecutor` is constructed, never
when this module loads (where grpc is not installed the service is
served in process, ``tpulab_torch.rpc.server.Server.invoke``).

- ``ClientExecutor``: channel pool with round-robin handout (reference
  client Executor GetNextCQ)
- ``ClientUnary``: async unary client — ``start(request)`` returns a future
  whose completion runs the wrapped on_complete callback (reference
  PrepareFn/StartCall + async_compute)
- ``ClientStreaming``: bidirectional stream with a background writer queue,
  read callback, and ``done()`` future (reference client_streaming v3 +
  client_single_up_multiple_down)
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from tpulab_torch import chaos
from tpulab_torch.core.async_compute import SharedPackagedTask
from tpulab_torch.rpc._transport import require_grpc

_WRITES_DONE = object()


def jittered_backoff_s(retry_after_ms: int, attempt: int = 0,
                       floor_s: float = 0.05, cap_s: float = 30.0,
                       jitter: float = 0.5, rng=None) -> float:
    """Client backoff honoring a server ``retry_after_ms`` hint.

    The hint (floored at ``floor_s`` when the server sent none) doubles
    per ``attempt`` and is capped; the result is then jittered uniformly
    over ``[1 - jitter, 1] × delay`` so a fleet of rejected clients
    decorrelates instead of re-arriving as the same thundering herd that
    caused the rejection (RESOURCE_EXHAUSTED contract, docs/SERVING.md).
    """
    import random
    base = max(floor_s, retry_after_ms / 1e3)
    delay = min(cap_s, base * (2.0 ** max(0, attempt)))
    r = (rng or random).random()
    return delay * (1.0 - jitter + jitter * r)


class ClientExecutor:
    """Round-robin channel pool (reference client Executor)."""

    def __init__(self, target: str, channels: int = 1,
                 options: Optional[list] = None):
        grpc = require_grpc()
        self.target = target
        self._channels: List["grpc.Channel"] = [
            grpc.insecure_channel(target, options=options)
            for _ in range(max(1, channels))]
        self._rr = itertools.cycle(range(len(self._channels)))

    def channel(self) -> "grpc.Channel":
        return self._channels[next(self._rr)]

    def close(self) -> None:
        for ch in self._channels:
            ch.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ClientUnary:
    """Future-returning unary client (reference ClientUnary)."""

    def __init__(self, executor: ClientExecutor, method: str,
                 request_serializer: Callable[[Any], bytes] = None,
                 response_deserializer: Callable[[bytes], Any] = None):
        self._executor = executor
        self._method = method
        self._ser = request_serializer
        self._des = response_deserializer

    def _stub(self):
        return self._executor.channel().unary_unary(
            self._method, request_serializer=self._ser,
            response_deserializer=self._des)

    def start(self, request, on_complete: Optional[Callable] = None,
              timeout: Optional[float] = None,
              metadata: Optional[list] = None) -> Future:
        """Async call; returns a future of on_complete(response) (identity
        by default).  Mirrors async_compute-wrapped completions.
        ``metadata`` rides the call as gRPC invocation metadata (e.g. the
        trace context, utils.tracing.TRACE_METADATA_KEY)."""
        task = SharedPackagedTask(on_complete or (lambda resp: resp))
        # chaos: delay/error the send, or black-hole it entirely — the
        # future then resolves only via its own timeout, exactly what a
        # dropped packet looks like to deadline/failover machinery (the
        # timer exists only on this armed test path)
        if chaos.trip("rpc.client.unary") == "drop":
            fut = task.get_future()
            if timeout is not None:
                def _expire():
                    if not fut.done():
                        fut.set_exception(TimeoutError(
                            f"chaos-dropped call timed out after {timeout}s"))
                t = threading.Timer(timeout, _expire)
                t.daemon = True
                t.start()
            return fut
        call = self._stub().future(request, timeout=timeout,
                                   metadata=metadata)

        def _done(c):
            try:
                task(c.result())
            except BaseException as e:  # noqa: BLE001
                fut = task.get_future()
                if not fut.done():
                    fut.set_exception(e)
        call.add_done_callback(_done)
        return task.get_future()

    def call(self, request, timeout: Optional[float] = None):
        """Blocking convenience."""
        return self.start(request, timeout=timeout).result(timeout)


class ClientStreaming:
    """Bidirectional streaming client (reference client_streaming v3)."""

    def __init__(self, executor: ClientExecutor, method: str,
                 on_response: Callable[[Any], None],
                 request_serializer: Callable[[Any], bytes] = None,
                 response_deserializer: Callable[[bytes], Any] = None,
                 timeout: Optional[float] = None,
                 metadata: Optional[list] = None):
        """``timeout`` sets the gRPC deadline for the WHOLE stream: the
        transport-level backstop of the application deadline (the server
        sees it via ``grpc-timeout`` metadata / ``time_remaining()``);
        ``metadata`` rides as invocation metadata (trace context)."""
        self._on_response = on_response
        self._writes: "_queue.Queue" = _queue.Queue()
        self._done: Future = Future()
        stub = executor.channel().stream_stream(
            method, request_serializer=request_serializer,
            response_deserializer=response_deserializer)

        def request_iter():
            while True:
                item = self._writes.get()
                if item is _WRITES_DONE:
                    return
                yield item

        self._call = stub(request_iter(), timeout=timeout,
                          metadata=metadata)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            for resp in self._call:
                # chaos: a mid-stream transport fault — the error tears the
                # stream down exactly like a dead replica would
                chaos.trip("rpc.client.stream_recv")
                self._on_response(resp)
            self._done.set_result(None)
        except BaseException as e:  # noqa: BLE001
            if not self._done.done():
                self._done.set_exception(e)

    def write(self, request) -> None:
        """Queue a request (reference Write; thread-safe)."""
        self._writes.put(request)

    def writes_done(self) -> None:
        """Half-close (reference WritesDone)."""
        self._writes.put(_WRITES_DONE)

    def done(self) -> Future:
        """Future resolving when the server finishes the stream."""
        return self._done

    def cancel(self) -> None:
        self._call.cancel()
        # unblock grpc's request-consumer thread: it sits in Queue.get()
        # inside request_iter and cancel alone cannot interrupt it
        self._writes.put(_WRITES_DONE)
