"""The one place the RPC layer reaches for grpc: imported when a server
starts or a client is constructed, never when a module loads."""

from __future__ import annotations


def require_grpc():
    """The ``grpc`` module, or an ``ImportError`` that names it (where
    grpc is not installed the service is driven in process through
    :meth:`~tpulab_torch.rpc.server.Server.invoke` /
    :meth:`~tpulab_torch.rpc.server.Server.invoke_stream`)."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "tpulab_torch.rpc: serving or calling over the network needs "
            "the grpc package (grpcio), which cannot be imported here; "
            "drive the service in process through Server.invoke / "
            "Server.invoke_stream instead") from e
    return grpc
