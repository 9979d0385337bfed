"""Standalone dynamic-batching middleman (reference examples/03_Batching
inference-batcher.cc:72-206: a unary front service that aggregates requests
in front of any backend, trading `window + batchN - batch1` latency for
throughput — formula discussion in the reference README:15-31).

Aggregation reuses BatchedInferRunner.over_runner on the *remote* backend
runner — the same core that powers in-process `serve(batching=True)`.
(The port of tpulab's ``examples/03_batching_middleman.py``.)

    python -m tpulab_torch.examples.ex03_batching_middleman \
        --backend localhost:50051 --port 50052 --max-batch 32 --window-ms 5
"""

import argparse
import threading

from tpulab_torch.engine.batched_runner import BatchedInferRunner
from tpulab_torch.rpc import AsyncService, Context, Executor, Server
from tpulab_torch.rpc.infer_service import (SERVICE_NAME, RemoteInferenceManager,
                                      proto_to_tensor, tensor_to_proto)
from tpulab_torch.rpc.protos import inference_pb2 as pb


class BatchingForwarder:
    """Per-model aggregators over the backend's remote runners."""

    def __init__(self, backend: str, max_batch: int, window_s: float):
        self._remote = RemoteInferenceManager(backend, channels=2)
        self._lock = threading.Lock()
        self._batchers = {}
        self.max_batch = max_batch
        self.window_s = window_s

    def _batcher(self, model: str) -> BatchedInferRunner:
        with self._lock:
            if model not in self._batchers:
                runner = self._remote.infer_runner(model)
                input_names = list(runner.input_bindings())
                self._batchers[model] = BatchedInferRunner.over_runner(
                    runner, input_names, max_batch_size=self.max_batch,
                    window_s=self.window_s)
            return self._batchers[model]

    def infer(self, request: pb.InferRequest) -> pb.InferResponse:
        arrays = {t.name: proto_to_tensor(t) for t in request.inputs}
        outputs = self._batcher(request.model_name).infer(**arrays).result(
            timeout=300)
        resp = pb.InferResponse(model_name=request.model_name,
                                correlation_id=request.correlation_id)
        for name, arr in outputs.items():
            resp.outputs.append(tensor_to_proto(name, arr))
        resp.status.code = pb.SUCCESS
        return resp

    def status(self, request: pb.StatusRequest) -> pb.StatusResponse:
        resp = pb.StatusResponse(server_version="tpulab-middleman")
        for name, ms in self._remote.get_models().items():
            if not request.model_name or request.model_name == name:
                resp.models.append(ms)
        resp.status.code = pb.SUCCESS
        return resp

    def shutdown(self) -> None:
        with self._lock:
            for b in self._batchers.values():
                b.shutdown()
        self._remote.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="localhost:50051")
    ap.add_argument("--port", type=int, default=50052)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--window-ms", type=float, default=5.0)
    args = ap.parse_args(argv)

    forwarder = BatchingForwarder(args.backend, args.max_batch,
                                  args.window_ms / 1000.0)

    class ForwardContext(Context):
        def execute_rpc(self, request: pb.InferRequest) -> pb.InferResponse:
            return forwarder.infer(request)

    class StatusForward(Context):
        def execute_rpc(self, request: pb.StatusRequest) -> pb.StatusResponse:
            return forwarder.status(request)

    server = Server(f"0.0.0.0:{args.port}", Executor(n_threads=8))
    svc = AsyncService(SERVICE_NAME)
    svc.register_rpc("Infer", ForwardContext, pb.InferRequest.FromString,
                     pb.InferResponse.SerializeToString)
    svc.register_rpc("Status", StatusForward, pb.StatusRequest.FromString,
                     pb.StatusResponse.SerializeToString)
    server.register_async_service(svc)
    print(f"batching middleman :{args.port} -> {args.backend} "
          f"(max_batch={args.max_batch}, window={args.window_ms}ms)")
    try:
        server.run()
    finally:
        forwarder.shutdown()


if __name__ == "__main__":
    main()
