"""tpulab_torch.rpc — the RPC microservice framework and the inference
service (the port of ``tpulab/rpc``; reference trtlab/nvrpc).

The surface is tpulab's:

- :class:`Server` — owns registered services and executors; the request
  behaviors are built without grpc, which is imported only when the
  server starts (``Server.invoke`` / ``invoke_stream`` serve the same
  behaviors in process, where grpc is missing)
- :class:`AsyncService` / ``register_rpc`` — method table binding RPC
  names to Context classes
- :class:`Context` / :class:`StreamingContext` / :class:`BatchingContext`
  — per-request lifecycles
- :class:`Executor` / :class:`FiberExecutor` — thread-pool vs event-loop
  execution domains
- client: :class:`ClientExecutor`, :class:`ClientUnary`,
  :class:`ClientStreaming` (grpc imported when constructed)
- :mod:`~tpulab_torch.rpc.infer_service` — the inference service
  (Status / Infer / StreamInfer / Health / Generate) and its clients

- :mod:`~tpulab_torch.rpc.replica` — client-side replica sets
  (:class:`ReplicaSet` unary, :class:`GenerationReplicaSet` token
  streams): least-loaded routing, circuit breaker, deadlines,
  resume-from-delivered failover, prefix affinity, hedging

The names load lazily, so ``import tpulab_torch.rpc`` needs no grpc.
"""

_EXPORTS = {
    "Context": "tpulab_torch.rpc.context",
    "StreamingContext": "tpulab_torch.rpc.context",
    "BatchingContext": "tpulab_torch.rpc.context",
    "Executor": "tpulab_torch.rpc.executor",
    "FiberExecutor": "tpulab_torch.rpc.executor",
    "Server": "tpulab_torch.rpc.server",
    "AsyncService": "tpulab_torch.rpc.server",
    "ClientExecutor": "tpulab_torch.rpc.client",
    "ClientUnary": "tpulab_torch.rpc.client",
    "ClientStreaming": "tpulab_torch.rpc.client",
    "ReplicaSet": "tpulab_torch.rpc.replica",
    "GenerationReplicaSet": "tpulab_torch.rpc.replica",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'tpulab_torch.rpc' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
