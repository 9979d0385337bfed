"""Schema'd zero-copy FlatBuffers payloads through the RPC framework
(reference examples/12_FlatBuffers: example.fbs + server.cc + client.cc —
gRPC moving FlatBuffers instead of protobuf).

Where ``ex12_binary_codec`` shows the codec-agnostic RPC hooks with an
ad-hoc packed header, this example uses a real schema'd format: the wire
bytes follow ``ex12_flatbuffers.fbs`` (a copy of tpulab's
``12_flatbuffers.fbs``) exactly (vtables, forward-compatible
field evolution, validation-free random access), and the server reads
each tensor's payload as a ZERO-COPY numpy view over the received gRPC
buffer — no protobuf parse, no tensor copy before pipeline staging.

The accessor classes below are what ``flatc --python`` would emit for the
schema (flatc is not in the image); they call the same flatbuffers runtime
builder/table primitives generated code calls, with the vtable slot
numbers fixed by the schema's field order (field i lives at vtable offset
``4 + 2*i``).

Run self-contained (serves MNIST on an ephemeral port, drives it, checks
against the local pipeline; the port of tpulab's
``examples/12_flatbuffers.py``):

    python -m tpulab_torch.examples.ex12_flatbuffers [--device cpu]
"""

from __future__ import annotations

import argparse

import flatbuffers
import numpy as np
from flatbuffers import number_types as NT

# -- generated-code analog: writers ------------------------------------------


def _build_tensor(b: flatbuffers.Builder, name: str, arr: np.ndarray) -> int:
    arr = np.ascontiguousarray(arr)
    noff = b.CreateString(name)
    doff = b.CreateString(arr.dtype.name)
    data = b.CreateByteVector(arr.tobytes())
    b.StartVector(4, arr.ndim, 4)
    for s in reversed(arr.shape):
        b.PrependInt32(s)
    shape = b.EndVector()
    b.StartObject(4)
    b.PrependUOffsetTRelativeSlot(0, noff, 0)   # name
    b.PrependUOffsetTRelativeSlot(1, shape, 0)  # shape
    b.PrependUOffsetTRelativeSlot(2, doff, 0)   # dtype
    b.PrependUOffsetTRelativeSlot(3, data, 0)   # data
    return b.EndObject()


def _build_message(model: str | None, tensors: dict[str, np.ndarray],
                   msg_id: int, response: bool) -> bytes:
    """InferRequest (model, inputs, id) or InferResponse (outputs, id)."""
    b = flatbuffers.Builder(1024)
    moff = b.CreateString(model) if model is not None else None
    toffs = [_build_tensor(b, n, a) for n, a in tensors.items()]
    b.StartVector(4, len(toffs), 4)
    for t in reversed(toffs):
        b.PrependUOffsetTRelative(t)
    vec = b.EndVector()
    if response:
        b.StartObject(2)
        b.PrependUOffsetTRelativeSlot(0, vec, 0)  # outputs
        b.PrependUint64Slot(1, msg_id, 0)         # id
    else:
        b.StartObject(3)
        b.PrependUOffsetTRelativeSlot(0, moff, 0)  # model
        b.PrependUOffsetTRelativeSlot(1, vec, 0)   # inputs
        b.PrependUint64Slot(2, msg_id, 0)          # id
    b.Finish(b.EndObject())
    return bytes(b.Output())


def encode_request(model: str, msg_id: int = 0,
                   **tensors: np.ndarray) -> bytes:
    return _build_message(model, tensors, msg_id, response=False)


def encode_response(tensors: dict[str, np.ndarray], msg_id: int = 0) -> bytes:
    return _build_message(None, tensors, msg_id, response=True)


# -- generated-code analog: readers (zero-copy) -------------------------------


class _TableReader:
    def __init__(self, buf, pos):
        self._tab = flatbuffers.table.Table(buf, pos)

    def _string(self, slot_off) -> str | None:
        o = NT.UOffsetTFlags.py_type(self._tab.Offset(slot_off))
        return (self._tab.String(o + self._tab.Pos).decode()
                if o else None)

    def _u64(self, slot_off) -> int:
        o = NT.UOffsetTFlags.py_type(self._tab.Offset(slot_off))
        return (self._tab.Get(NT.Uint64Flags, o + self._tab.Pos)
                if o else 0)

    def _veclen(self, slot_off) -> int:
        o = NT.UOffsetTFlags.py_type(self._tab.Offset(slot_off))
        return self._tab.VectorLen(o) if o else 0


class TensorReader(_TableReader):
    def name(self):
        return self._string(4)

    def shape(self) -> tuple[int, ...]:
        o = NT.UOffsetTFlags.py_type(self._tab.Offset(6))
        if not o:
            return ()
        a = self._tab.Vector(o)
        return tuple(self._tab.Get(NT.Int32Flags, a + 4 * j)
                     for j in range(self._tab.VectorLen(o)))

    def dtype(self):
        return np.dtype(self._string(8))

    def array(self) -> np.ndarray:
        """ZERO-COPY: a numpy view over the wire buffer's data vector,
        reshaped per the schema'd shape/dtype (read-only)."""
        o = NT.UOffsetTFlags.py_type(self._tab.Offset(10))
        raw = self._tab.GetVectorAsNumpy(NT.Uint8Flags, o)
        return raw.view(self.dtype()).reshape(self.shape())


class _MessageReader(_TableReader):
    _vec_slot: int
    _id_slot: int

    def __init__(self, buf: bytes):
        root = flatbuffers.encode.Get(flatbuffers.packer.uoffset, buf, 0)
        super().__init__(buf, root)

    def id(self) -> int:
        return self._u64(self._id_slot)

    def tensors(self) -> dict[str, np.ndarray]:
        o = NT.UOffsetTFlags.py_type(self._tab.Offset(self._vec_slot))
        out: dict[str, np.ndarray] = {}
        if not o:
            return out
        a = self._tab.Vector(o)
        for j in range(self._tab.VectorLen(o)):
            t = TensorReader(self._tab.Bytes, self._tab.Indirect(a + 4 * j))
            out[t.name()] = t.array()
        return out


class InferRequestReader(_MessageReader):
    _vec_slot, _id_slot = 6, 8

    def model(self):
        return self._string(4)


class InferResponseReader(_MessageReader):
    _vec_slot, _id_slot = 4, 6


# -- service ------------------------------------------------------------------
SERVICE = "tpulab.example.FlatbufInfer"


def build_service(manager):
    from tpulab_torch.core.resources import Resources
    from tpulab_torch.rpc import AsyncService, Context, Server

    class FbRes(Resources):
        def __init__(self, mgr):
            self.manager = mgr

    class FlatbufInferContext(Context):
        """Unary inference over the FlatBuffers codec: the deserializer
        hook already produced a reader whose tensors alias the wire
        buffer (zero copies up to pipeline staging)."""

        def execute_rpc(self, request: InferRequestReader):
            mgr = self.get_resources(FbRes).manager
            out = mgr.infer_runner(request.model()).infer(
                **request.tensors()).result(timeout=120)
            return encode_response({k: np.asarray(v) for k, v in out.items()},
                                   msg_id=request.id())

    server = Server("127.0.0.1:0")
    svc = AsyncService(SERVICE, FbRes(manager))
    svc.register_rpc("Infer", FlatbufInferContext,
                     request_deserializer=InferRequestReader,
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
                request_serializer=lambda r: r,
                response_deserializer=InferResponseReader)
            resp = infer.call(
                encode_request("mnist", msg_id=7, Input3=x), timeout=120)
        assert resp.id() == 7, resp.id()
        logits = resp.tensors()["Plus214_Output_0"]
        local = manager.infer_runner("mnist").infer(Input3=x).result(120)
        np.testing.assert_allclose(logits, local["Plus214_Output_0"],
                                   rtol=1e-5)
        print(f"flatbuffers serving OK: schema'd zero-copy round trip, "
              f"output {logits.shape} matches the local pipeline")
    finally:
        server.shutdown()
        manager.shutdown()


if __name__ == "__main__":
    main()
