"""Custom zero-copy binary payloads through the RPC framework
(reference examples/12_FlatBuffers: gRPC with non-protobuf FlatBuffers
payloads, example.fbs + server.cc + client.cc).

The point the reference example makes is that the RPC framework is
codec-agnostic: gRPC moves opaque byte buffers, and the serializer hooks on
``AsyncService.register_rpc`` / the client classes decide the wire format.
Here the payload is a packed little-endian header + raw tensor bytes —
like FlatBuffers, the server reads the tensor as a ZERO-COPY view over the
wire buffer (no protobuf parse, no tensor copy before staging).

Wire format (little-endian):
    magic   u32  = 0x7eb51ab5
    nlen    u16  | name bytes        (model name)
    dlen    u8   | dtype bytes       (numpy dtype str)
    ndim    u8   | dims i32 * ndim
    payload      (C-contiguous tensor bytes)

Run self-contained (serves MNIST on an ephemeral port, drives it, checks
against the local pipeline; the port of tpulab's
``examples/12_binary_codec.py``):

    python -m tpulab_torch.examples.ex12_binary_codec [--device cpu]
"""

from __future__ import annotations

import argparse
import struct

import numpy as np

MAGIC = 0x7EB51AB5


# -- codec (the .fbs analog) --------------------------------------------------
def encode_tensor(name: str, array: np.ndarray) -> bytes:
    array = np.ascontiguousarray(array)
    nb = name.encode()
    db = str(array.dtype.name).encode()
    head = struct.pack("<IH", MAGIC, len(nb)) + nb
    head += struct.pack("<B", len(db)) + db
    head += struct.pack("<B", array.ndim)
    head += struct.pack(f"<{array.ndim}i", *array.shape)
    return head + array.tobytes()


def decode_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    """Zero-copy decode: the returned array aliases ``buf`` (read-only)."""
    view = memoryview(buf)
    magic, nlen = struct.unpack_from("<IH", view, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:x}")
    off = 6
    name = bytes(view[off:off + nlen]).decode()
    off += nlen
    (dlen,) = struct.unpack_from("<B", view, off)
    off += 1
    dtype = np.dtype(bytes(view[off:off + dlen]).decode())
    off += dlen
    (ndim,) = struct.unpack_from("<B", view, off)
    off += 1
    dims = struct.unpack_from(f"<{ndim}i", view, off)
    off += 4 * ndim
    arr = np.frombuffer(view, dtype=dtype, offset=off).reshape(dims)
    return name, arr


# -- service ------------------------------------------------------------------
SERVICE = "tpulab.example.BinaryInfer"


def build_service(manager):
    from tpulab_torch.core.resources import Resources
    from tpulab_torch.rpc import AsyncService, Context, Server

    class BinRes(Resources):
        def __init__(self, mgr):
            self.manager = mgr

    class BinaryInferContext(Context):
        """Unary inference over the binary codec: the deserializer hook has
        already produced a zero-copy (name, tensor) pair."""

        def execute_rpc(self, request):
            binding, arr = request
            mgr = self.get_resources(BinRes).manager
            model_name = mgr.model_names[0]
            out = mgr.infer_runner(model_name).infer(
                **{binding: arr}).result(timeout=120)
            name, tensor = next(iter(out.items()))
            return encode_tensor(name, tensor)

    server = Server("127.0.0.1:0")
    svc = AsyncService(SERVICE, BinRes(manager))
    svc.register_rpc("Infer", BinaryInferContext,
                     request_deserializer=decode_tensor,
                     response_serializer=lambda b: b)
    server.register_async_service(svc)
    return server


def main(argv=None) -> None:
    from tpulab_torch.examples._device import add_device_arg

    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import tpulab_torch
    from tpulab_torch.models import build_model
    from tpulab_torch.rpc import ClientExecutor, ClientUnary

    manager = tpulab_torch.InferenceManager(max_exec_concurrency=2,
                                            device=args.device)
    manager.register_model("mnist", build_model("mnist", max_batch_size=4,
                                                device=args.device))
    manager.update_resources()
    server = build_service(manager)
    server.async_start()
    server.wait_until_running()
    try:
        x = np.random.default_rng(5).standard_normal(
            (2, 28, 28, 1)).astype(np.float32)
        with ClientExecutor(f"127.0.0.1:{server.bound_port}") as cx:
            infer = ClientUnary(
                cx, f"/{SERVICE}/Infer",
                request_serializer=lambda t: encode_tensor(*t),
                response_deserializer=decode_tensor)
            name, logits = infer.call(("Input3", x), timeout=120)
        local = manager.infer_runner("mnist").infer(Input3=x).result(120)
        np.testing.assert_allclose(logits, local[name], rtol=1e-5)
        print(f"binary-codec serving OK: output {name}{logits.shape} "
              f"matches the local pipeline")
    finally:
        server.shutdown()
        manager.shutdown()


if __name__ == "__main__":
    main()
