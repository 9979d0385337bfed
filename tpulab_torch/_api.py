"""Top-level serving API (the port of ``tpulab/_api.py``):
``tpulab_torch.InferenceManager(max_exec_concurrency=...)``.

tpulab's ``serve()``, ``RemoteInferenceManager`` and the manager's
``serve`` / ``drain`` ride its gRPC service, which is not ported yet
(ROADMAP queue 1, item 3: the Generate RPC and the serving layer); they
raise.  Nothing here imports grpc.
"""

from __future__ import annotations

from tpulab_torch.engine.inference_manager import \
    InferenceManager as _EngineManager

_RPC = ("the gRPC service is not ported (ROADMAP queue 1, item 3: the "
        "Generate RPC and the serving layer)")


class InferenceManager(_EngineManager):
    """Engine manager under tpulab's top-level keyword
    ``max_exec_concurrency``."""

    def __init__(self, max_exec_concurrency: int = 2, max_buffers: int = 0,
                 device=None, coalesce_h2d: bool = False):
        super().__init__(max_executions=max_exec_concurrency,
                         max_buffers=max_buffers, device=device,
                         coalesce_h2d=coalesce_h2d)

    def serve(self, *args, **kwargs):
        raise NotImplementedError(f"InferenceManager.serve: {_RPC}")

    def drain(self, *args, **kwargs):
        raise NotImplementedError(f"InferenceManager.drain: {_RPC}")


class RemoteInferenceManager:
    """tpulab's gRPC client manager: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"RemoteInferenceManager: {_RPC}")


def serve(manager, port: int = 50051, **kw):
    raise NotImplementedError(f"serve: {_RPC}")
