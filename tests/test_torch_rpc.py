"""tpulab's RPC framework scenarios (tests/test_rpc.py) on the port's
framework, ``tpulab_torch.rpc``, over the real gRPC loopback: unary,
streaming, batching, the fiber executor, the context free-list, load
shedding, thread placement and ``run(control_fn)``; then the same
behaviors called in process (``Server.invoke`` / ``invoke_stream``,
no socket) give the bytes the loopback call gives."""

import threading
import time

import pytest

from tpulab_torch.core.resources import Resources
from tpulab_torch.rpc import (AsyncService, BatchingContext, ClientExecutor,
                        ClientStreaming, ClientUnary, Context, Executor,
                        FiberExecutor, Server, StreamingContext)

ECHO = "tpulab.testing.Echo"


class EchoResources(Resources):
    """Reference test_resources.h: shared bookkeeping bundle."""

    def __init__(self):
        self.counter = 0
        self.lock = threading.Lock()
        self.slow_inflight = self.slow_peak = 0

    def bump(self):
        with self.lock:
            self.counter += 1
            return self.counter

    def slow_enter(self):
        with self.lock:
            self.slow_inflight += 1
            self.slow_peak = max(self.slow_peak, self.slow_inflight)

    def slow_exit(self):
        with self.lock:
            self.slow_inflight -= 1


class EchoContext(Context):
    def execute_rpc(self, request: bytes) -> bytes:
        self.get_resources(EchoResources).bump()
        return b"pong:" + request


class SlowContext(Context):
    """Blocking wait — legal on thread executors (workers absorb it)."""

    def execute_rpc(self, request: bytes) -> bytes:
        res = self.get_resources(EchoResources)
        res.slow_enter()
        try:
            time.sleep(0.05)
        finally:
            res.slow_exit()
        return b"slow:" + request


class AsyncSlowContext(Context):
    """Fiber-aware wait — the FiberExecutor overlap path.  A *blocking*
    sleep would stall the loop thread, exactly as it stalls a fiber
    scheduler thread in the reference."""

    async def execute_rpc(self, request: bytes) -> bytes:
        import asyncio
        res = self.get_resources(EchoResources)
        res.slow_enter()
        try:
            await asyncio.sleep(0.05)
        finally:
            res.slow_exit()
        return b"slow:" + request


class StreamEchoContext(StreamingContext):
    """Reference test_pingpong.h streaming context: echo each request."""

    def on_request(self, request: bytes) -> None:
        self.write(b"pong:" + request)

    def on_requests_finished(self) -> None:
        self.write(b"done")


class SumBatchContext(BatchingContext):
    max_batch_size = 4
    batch_window_s = 0.05

    def execute_batch(self, requests):
        # each caller gets the batch size it rode in
        n = str(len(requests)).encode()
        return [n for _ in requests]


def build_server(executor):
    """Reference BuildServer fixture (localhost, pre-armed contexts)."""
    res = EchoResources()
    server = Server("127.0.0.1:0", executor)
    svc = AsyncService(ECHO, res)
    svc.register_rpc("Unary", EchoContext)
    svc.register_rpc("Slow",
                     SlowContext if not executor.is_fiber else AsyncSlowContext)
    svc.register_rpc("Stream", StreamEchoContext)
    svc.register_rpc("Batch", SumBatchContext)
    server.register_async_service(svc)
    server.async_start()
    server.wait_until_running()
    return server, res


@pytest.fixture(params=["threads", "fiber"])
def server(request):
    executor = Executor(n_threads=4) if request.param == "threads" \
        else FiberExecutor()
    server, res = build_server(executor)
    yield server, res
    server.shutdown()


def _client(server) -> ClientExecutor:
    return ClientExecutor(f"127.0.0.1:{server.bound_port}")


def test_unary_pingpong(server):
    srv, res = server
    with _client(srv) as cx:
        unary = ClientUnary(cx, f"/{ECHO}/Unary")
        assert unary.call(b"hello", timeout=10) == b"pong:hello"
        futs = [unary.start(str(i).encode()) for i in range(20)]
        outs = {f.result(timeout=10) for f in futs}
        assert outs == {b"pong:" + str(i).encode() for i in range(20)}
    assert res.counter == 21  # resources shared across contexts


def test_unary_on_complete_callback(server):
    srv, _ = server
    with _client(srv) as cx:
        unary = ClientUnary(cx, f"/{ECHO}/Unary")
        fut = unary.start(b"x", on_complete=lambda resp: resp.decode().upper())
        assert fut.result(timeout=10) == "PONG:X"


def test_unary_concurrent_slow_requests(server):
    """Handlers may block; concurrency must not collapse to serial: the
    server holds several of the 8 slow handlers at once (counted inside
    the handlers, so a loaded machine's slower clock cannot fake or hide
    the overlap)."""
    srv, res = server
    with _client(srv) as cx:
        slow = ClientUnary(cx, f"/{ECHO}/Slow")
        futs = [slow.start(b"r") for _ in range(8)]
        assert [f.result(timeout=10) for f in futs] == [b"slow:r"] * 8
    assert res.slow_peak >= 2 and res.slow_inflight == 0


def test_streaming_pingpong(server):
    srv, _ = server
    responses = []
    with _client(srv) as cx:
        stream = ClientStreaming(cx, f"/{ECHO}/Stream", responses.append)
        for i in range(5):
            stream.write(str(i).encode())
        stream.writes_done()
        stream.done().result(timeout=10)
    assert responses == [b"pong:" + str(i).encode() for i in range(5)] + [b"done"]


def test_streaming_early_cancel(server):
    """Reference early-cancel context variant."""
    srv, _ = server
    responses = []
    with _client(srv) as cx:
        stream = ClientStreaming(cx, f"/{ECHO}/Stream", responses.append)
        stream.write(b"one")
        stream.cancel()
        with pytest.raises(Exception):
            stream.done().result(timeout=10)


def test_batching_context_aggregates(server):
    srv, _ = server
    with _client(srv) as cx:
        batch = ClientUnary(cx, f"/{ECHO}/Batch")
        futs = [batch.start(b"x") for _ in range(4)]
        sizes = [int(f.result(timeout=10)) for f in futs]
    assert max(sizes) >= 2  # concurrent callers actually shared a batch


def test_batching_window_timeout(server):
    srv, _ = server
    with _client(srv) as cx:
        batch = ClientUnary(cx, f"/{ECHO}/Batch")
        assert int(batch.call(b"x", timeout=10)) == 1  # window closed alone


def test_server_shutdown_is_clean():
    server, _ = build_server(Executor(n_threads=2))
    port = server.bound_port
    server.shutdown()
    with ClientExecutor(f"127.0.0.1:{port}") as cx:
        unary = ClientUnary(cx, f"/{ECHO}/Unary")
        with pytest.raises(Exception):
            unary.call(b"x", timeout=2)


def test_fiber_async_contexts():
    """Coroutine handlers awaiting pool resources (the fiber property)."""
    import asyncio
    from tpulab_torch.core.pool import Pool

    class PoolResources(Resources):
        def __init__(self):
            self.pool = Pool(["tok"])

    class AsyncCtx(Context):
        async def execute_rpc(self, request: bytes) -> bytes:
            item = await self.get_resources(PoolResources).pool.pop_async()
            try:
                await asyncio.sleep(0.01)
                return b"async:" + request
            finally:
                item.release()

    res = PoolResources()
    server = Server("127.0.0.1:0", FiberExecutor())
    svc = AsyncService(ECHO, res)
    svc.register_rpc("AUnary", AsyncCtx)
    server.register_async_service(svc)
    server.async_start()
    server.wait_until_running()
    try:
        with ClientExecutor(f"127.0.0.1:{server.bound_port}") as cx:
            unary = ClientUnary(cx, f"/{ECHO}/AUnary")
            futs = [unary.start(str(i).encode()) for i in range(8)]
            outs = [f.result(timeout=10) for f in futs]
            assert all(o.startswith(b"async:") for o in outs)
    finally:
        server.shutdown()


# -------------------------------------------- regression: review findings ---
class FailingStreamContext(StreamingContext):
    def on_request(self, request: bytes) -> None:
        if request == b"boom":
            raise RuntimeError("handler failure")
        self.write(b"ok:" + request)


def test_streaming_handler_error_surfaces(server):
    """A failing stream handler must error the stream, not complete OK."""
    srv, _ = server
    # register on a fresh server to keep the shared fixture clean
    executor = srv.executor
    fresh = Server("127.0.0.1:0", type(executor)())
    svc = AsyncService(ECHO)
    svc.register_rpc("FailStream", FailingStreamContext)
    fresh.register_async_service(svc)
    fresh.async_start()
    fresh.wait_until_running()
    try:
        responses = []
        with ClientExecutor(f"127.0.0.1:{fresh.bound_port}") as cx:
            stream = ClientStreaming(cx, f"/{ECHO}/FailStream",
                                     responses.append)
            stream.write(b"fine")
            stream.write(b"boom")
            stream.writes_done()
            with pytest.raises(Exception):
                stream.done().result(timeout=10)
    finally:
        fresh.shutdown()


def _mnist_manager(max_batch_size, max_buffers):
    import tpulab_torch
    from tpulab_torch.models import build_model
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        max_buffers=max_buffers,
                                        device="cpu")
    mgr.register_model("mnist", build_model(
        "mnist", max_batch_size=max_batch_size, device="cpu"))
    mgr.update_resources()
    return mgr


def test_invalid_remote_input_does_not_exhaust_buffers():
    """DoS regression: bad requests must not leak buffer-pool slots."""
    import numpy as np
    from tpulab_torch.rpc.infer_service import RemoteInferenceManager

    mgr = _mnist_manager(2, 2)
    mgr.serve(port=0)
    remote = RemoteInferenceManager(f"localhost:{mgr.server.bound_port}")
    try:
        runner = remote.infer_runner("mnist")
        bad = np.zeros((1, 28, 28, 1), np.float64)  # wrong dtype
        for _ in range(6):  # 3x the pool size
            with pytest.raises(RuntimeError, match="INVALID_ARGUMENT"):
                runner.infer(Input3=bad).result(timeout=30)
        # pool must still be healthy
        good = np.zeros((1, 28, 28, 1), np.float32)
        out = runner.infer(Input3=good).result(timeout=30)
        assert out["Plus214_Output_0"].shape == (1, 10)
    finally:
        remote.close()
        mgr.shutdown()


def test_local_bad_input_does_not_leak_buffers():
    """Same leak via the local API (InferRunner.infer error path)."""
    import numpy as np

    mgr = _mnist_manager(1, 1)
    try:
        runner = mgr.infer_runner("mnist")
        for _ in range(3):
            with pytest.raises(TypeError):
                runner.infer(Input3=np.zeros((1, 28, 28, 1), np.float64))
        out = runner.infer(
            Input3=np.zeros((1, 28, 28, 1), np.float32)).result(timeout=30)
        assert out["Plus214_Output_0"].shape == (1, 10)
    finally:
        mgr.shutdown()


class VerySlowContext(Context):
    def execute_rpc(self, request: bytes) -> bytes:
        time.sleep(0.3)
        return b"vs:" + request


class AsyncVerySlowContext(Context):
    async def execute_rpc(self, request: bytes) -> bytes:
        import asyncio
        await asyncio.sleep(0.3)
        return b"vs:" + request


@pytest.mark.parametrize("kind", ["threads", "fiber"])
def test_executor_saturation_sheds_load_and_recovers(kind):
    """Drive 8x max_concurrency concurrent RPCs (reference executor.h
    pre-arms a bounded context set; beyond it the server must shed load,
    not deadlock or queue unboundedly) and assert: the bound is enforced
    via clean RESOURCE_EXHAUSTED rejections, successes complete, and the
    server serves normally after the storm."""
    import grpc

    bound = 4
    executor = (Executor(n_threads=2, contexts_per_thread=2)
                if kind == "threads" else FiberExecutor(contexts=bound))
    assert executor.max_concurrency == bound
    res = EchoResources()
    server = Server("127.0.0.1:0", executor)
    svc = AsyncService(ECHO, res)
    svc.register_rpc("VerySlow", VerySlowContext if kind == "threads"
                     else AsyncVerySlowContext)
    server.register_async_service(svc)
    server.async_start()
    server.wait_until_running()
    try:
        with ClientExecutor(f"127.0.0.1:{server.bound_port}",
                            channels=4) as cx:
            slow = ClientUnary(cx, f"/{ECHO}/VerySlow")
            n = bound * 8
            t0 = time.perf_counter()
            futs = [slow.start(b"x", timeout=30) for _ in range(n)]
            ok, rejected, lat = 0, 0, []
            for f in futs:
                t1 = time.perf_counter()
                try:
                    assert f.result(timeout=60) == b"vs:x"
                    ok += 1
                    lat.append(time.perf_counter() - t1)
                except grpc.RpcError as e:
                    assert e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED, \
                        f"unexpected rejection code {e.code()}"
                    rejected += 1
            wall = time.perf_counter() - t0
            assert ok + rejected == n
            assert ok >= bound  # the bound's worth must have been served
            # bounded queueing: the storm must not serialize all n requests
            assert wall < n * 0.3, f"saturation serialized: {wall:.1f}s"
            if lat:
                import numpy as _np
                print(f"[saturation {kind}] ok={ok} rejected={rejected} "
                      f"wall={wall:.2f}s p50={_np.percentile(lat, 50):.3f}s "
                      f"p99={_np.percentile(lat, 99):.3f}s")
            # recovery: a fresh request after the storm is served (the aio
            # server may briefly count finishing RPCs against the limit —
            # shedding must be transient, so retry with backoff)
            for _ in range(50):
                try:
                    assert (slow.start(b"y", timeout=30).result(timeout=60)
                            == b"vs:y")
                    break
                except grpc.RpcError as e:
                    assert e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                    time.sleep(0.1)
            else:
                raise AssertionError("server did not recover after storm")
    finally:
        server.shutdown()


def test_executor_owns_thread_placement_and_context_pool():
    """Round-3 executor parity (reference executor.h:39-113): worker
    threads pin to the executor's cpu plan, and unary contexts recycle
    through the pre-armed free-list instead of per-call instantiation."""
    import os
    cpu0 = sorted(os.sched_getaffinity(0))[0]
    executor = Executor(n_threads=2, contexts_per_thread=4, cpus=[cpu0])
    server, res = build_server(executor)
    try:
        with _client(server) as cx:
            unary = ClientUnary(cx, f"/{ECHO}/Unary")
            for i in range(8):
                assert unary.call(b"x", timeout=10) == b"pong:x"
        # workers pinned (cpus < n_threads -> each shares the whole set)
        assert executor.pinned, "no worker thread reported a pin"
        assert all(p == (cpu0,) for p in executor.pinned), executor.pinned
        rpc = server._services[0].rpcs["Unary"]
        assert rpc.ctx_pool_cap == executor.max_concurrency
        assert len(rpc.ctx_pool) >= 1  # contexts parked between calls
        # sequential calls reuse the SAME context object
        parked = {id(c) for c in rpc.ctx_pool}
        with _client(server) as cx:
            unary = ClientUnary(cx, f"/{ECHO}/Unary")
            assert unary.call(b"y", timeout=10) == b"pong:y"
        assert {id(c) for c in rpc.ctx_pool} <= parked
    finally:
        server.shutdown()


# -------------------------------------------- the port's own surface ---
def test_run_with_control_fn_until_shutdown():
    """``run(control_fn)`` serves and calls the control lambda each
    period until shutdown (reference Server::Run), and a failing lambda
    does not stop the server."""
    server, _ = build_server(Executor(n_threads=2))
    calls = []

    def control():
        calls.append(time.monotonic())
        if len(calls) == 2:
            raise RuntimeError("a control-lambda fault is logged")
        if len(calls) >= 4:
            server.shutdown()

    t = threading.Thread(target=server.run, args=(control, 0.02))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(calls) >= 4
    assert server.bound_port is not None


@pytest.mark.parametrize("method,payloads", [
    ("Unary", [b"abc"]), ("Batch", [b"x"]),
    ("Stream", [b"1", b"22", b"333"])])
def test_in_process_call_equals_loopback(method, payloads):
    """The behaviors the gRPC server wraps, called in process: the same
    response bytes (and, for the stream, the same sequence)."""
    server, _ = build_server(Executor(n_threads=2))
    path = f"/{ECHO}/{method}"
    try:
        with _client(server) as cx:
            if method == "Stream":
                wire = []
                stream = ClientStreaming(cx, path, wire.append)
                for p in payloads:
                    stream.write(p)
                stream.writes_done()
                stream.done().result(timeout=10)
                local = list(server.invoke_stream(path, payloads))
            else:
                wire = [ClientUnary(cx, path).call(payloads[0], timeout=10)]
                local = [server.invoke(path, payloads[0])]
        assert local == wire and wire
        with pytest.raises(TypeError, match="is a (streaming|unary) RPC"):
            (server.invoke(path, b"") if method == "Stream"
             else list(server.invoke_stream(path, [b""])))
        with pytest.raises(KeyError):
            server.invoke(f"/{ECHO}/Nope", b"")
    finally:
        server.shutdown()


def test_in_process_stream_failure_and_cancel():
    """In process, a failing stream handler raises after the responses
    written before it (grpc ends such a stream with INTERNAL), and the
    local servicer context carries metadata, a deadline and cancel."""
    from tpulab_torch.rpc.server import LocalServicerContext, StreamHandlerError

    server = Server("127.0.0.1:0", Executor(n_threads=2))
    svc = AsyncService(ECHO)
    svc.register_rpc("FailStream", FailingStreamContext)
    server.register_async_service(svc)
    try:
        got = []
        with pytest.raises(StreamHandlerError, match="handler failure"):
            for r in server.invoke_stream(f"/{ECHO}/FailStream",
                                          [b"fine", b"boom", b"never"]):
                got.append(r)
        assert got == [b"ok:fine"]
    finally:
        server.shutdown()
    ctx = LocalServicerContext([("tpulab-tenant", "t1")], timeout=30)
    assert ctx.is_active() and 0 < ctx.time_remaining() <= 30
    assert ctx.invocation_metadata() == (("tpulab-tenant", "t1"),)
    ctx.cancel()
    assert not ctx.is_active()
    assert LocalServicerContext().time_remaining() is None
    assert not LocalServicerContext(timeout=0).is_active()
