"""The port's protobuf-free ``inference_pb2`` against tpulab's generated
classes: for every message type, seeded values built in both serialize to
the same bytes, and each side parses the other's bytes into equal fields.
Then the proto3 details the service relies on, one by one: defaults not
written, the presence of ``seed`` and of lazily created sub-messages,
negative int32 as 10-byte varints, float32 rounding at assignment,
packed repeated numbers (unpacked accepted), unknown fields skipped, the
type and range checks, and ``StatusCode``'s names."""

import math

import numpy as np
import pytest

from tpulab.rpc.protos import inference_pb2 as ref
from tpulab_torch.rpc.protos import inference_pb2 as pb

MESSAGES = ("TensorProto", "InferRequest", "InferResponse", "RequestStatus",
            "ModelIOSpec", "ModelStatus", "StatusRequest", "StatusResponse",
            "HealthRequest", "HealthResponse", "DebugRequest",
            "DebugResponse", "GenerateRequest", "GenerateResponse",
            "FetchKVRequest", "FetchKVResponse")


def _pick(rng, values):
    return values[int(rng.integers(len(values)))]


def _scalar(rng, kind):
    if kind == "string":
        return "".join(_pick(rng, list("abcxyz_é7"))
                       for _ in range(int(rng.integers(0, 9))))
    if kind == "bytes":
        return rng.integers(0, 256, rng.integers(0, 12)).astype(
            np.uint8).tobytes()
    if kind == "int32":
        return _pick(rng, [0, 1, -1, 300, -(1 << 31), (1 << 31) - 1,
                           int(rng.integers(-(1 << 31), 1 << 31))])
    if kind == "int64":
        return _pick(rng, [0, -5, 1 << 40, -(1 << 63), (1 << 63) - 1])
    if kind == "uint64":
        return _pick(rng, [0, 1, 127, 128, (1 << 64) - 1, 1 << 35])
    if kind == "enum":
        return int(rng.integers(0, 8))
    if kind == "bool":
        return bool(rng.integers(0, 2))
    return _pick(rng, [0.0, 0.7, -1.5, 1e-3, 3.4e38,
                       float(rng.standard_normal())])


def _values(rng, name, depth=0):
    """Keyword values for message ``name`` (a random subset of its
    fields, some at their defaults), as plain Python: nested messages as
    (name, kwargs) pairs, built separately for each package."""
    cls = getattr(pb, name)
    kw = {}
    for f in cls._FIELDS:
        if rng.random() < 0.25:
            continue
        if f.kind == "message":
            if depth > 2:
                continue
            n = int(rng.integers(0, 3)) if f.repeated else 1
            vals = [(f.msg_name, _values(rng, f.msg_name, depth + 1))
                    for _ in range(n)]
            kw[f.name] = vals if f.repeated else vals[0]
        elif f.repeated:
            kw[f.name] = [_scalar(rng, f.kind)
                          for _ in range(int(rng.integers(0, 5)))]
        else:
            kw[f.name] = _scalar(rng, f.kind)
    return kw


def _build(mod, name, kw):
    def conv(v):
        if isinstance(v, tuple):
            return _build(mod, v[0], v[1])
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v
    return getattr(mod, name)(**{k: conv(v) for k, v in kw.items()})


def _fields(msg):
    """Every field's value, nested messages recursively (presence of
    messages and of ``seed`` included)."""
    out = {}
    for f in getattr(pb, type(msg).__name__)._FIELDS:
        v = getattr(msg, f.name)
        if f.kind == "message":
            if f.repeated:
                out[f.name] = [_fields(x) for x in v]
            else:
                out[f.name] = (_fields(v) if msg.HasField(f.name)
                               else None)
        elif f.repeated:
            out[f.name] = list(v)
        elif f.optional:
            out[f.name] = v if msg.HasField(f.name) else None
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("name", MESSAGES)
def test_seeded_values_byte_equal_both_ways(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(40):
        kw = _values(rng, name)
        a, b = _build(ref, name, kw), _build(pb, name, kw)
        wire = a.SerializeToString()
        assert b.SerializeToString() == wire, kw
        # each side parses the other's bytes into equal fields
        assert _fields(getattr(pb, name).FromString(wire)) == _fields(b)
        back = getattr(ref, name).FromString(b.SerializeToString())
        assert back == a
        assert _fields(b) == _fields(a)


def test_every_message_and_the_enum_are_there():
    for name in MESSAGES:
        assert getattr(pb, name)().SerializeToString() == b""
    assert len(MESSAGES) == 16
    for name, num in ref.StatusCode.items():
        assert getattr(pb, name) == num == getattr(ref, name)
        assert pb.StatusCode.Name(num) == name
        assert pb.StatusCode.Value(name) == num
    with pytest.raises(ValueError):
        pb.StatusCode.Name(99)


def test_defaults_are_not_written_and_presence_is():
    for mod in (ref, pb):
        r = mod.GenerateRequest(model_name="", steps=0, temperature=0.0,
                                prompt=[], device_sampling=False)
        assert r.SerializeToString() == b""
        assert not r.HasField("seed")
        r.seed = 0
        assert r.HasField("seed")
        assert r.SerializeToString() == b"8\x00"
        with pytest.raises(ValueError):
            r.HasField("steps")                # proto3 scalars: no presence
    # a sub-message read but never written stays absent; any write makes
    # it (and its ancestors) present, even at its default value
    for mod in (ref, pb):
        r = mod.InferResponse()
        assert r.status.code == 0 and not r.HasField("status")
        assert r.SerializeToString() == b""
        r.status.code = mod.INVALID
        assert r.HasField("status") and r.SerializeToString() == b"\x1a\x00"
    a, b = ref.StatusResponse(), pb.StatusResponse()
    for m, mod in ((a, ref), (b, pb)):
        m.models.add(name="m", batch_buckets=[1, 2, 4])
        m.models[0].inputs.append(mod.ModelIOSpec(name="x", dims=[3, -1]))
        m.resident_models.extend(["a", "b"])
        m.status.message = "ok"
    assert a.SerializeToString() == b.SerializeToString()


def test_negative_int32_and_float32_rounding():
    for mod in (ref, pb):
        r = mod.GenerateRequest(priority=-1, temperature=0.7, top_p=1e300)
        assert r.SerializeToString()[:11] == b" " + b"\xff" * 9 + b"\x01"
        assert r.temperature == 0.699999988079071
        assert r.top_p == math.inf
        assert mod.GenerateResponse(logprob=-0.0).SerializeToString() \
            == b"-\x00\x00\x00\x80"
        nan = mod.GenerateRequest(temperature=float("nan"))
        assert not (nan.temperature >= 0.0)
    assert (pb.GenerateRequest(temperature=0.7).SerializeToString()
            == ref.GenerateRequest(temperature=0.7).SerializeToString())
    # numpy scalars are accepted where protobuf accepts them
    kw = dict(prompt=list(np.arange(4, dtype=np.int32)),
              temperature=np.float32(0.25), steps=np.int64(3))
    assert (pb.GenerateRequest(**kw).SerializeToString()
            == ref.GenerateRequest(**kw).SerializeToString())


def test_type_and_range_checks_match():
    for bad in (dict(steps=1.0), dict(steps=1 << 31), dict(seed=-1),
                dict(model_name=3), dict(kv_shipment="s"),
                dict(temperature="x")):
        with pytest.raises((TypeError, ValueError)) as e_ref:
            ref.GenerateRequest(**bad)
        with pytest.raises((TypeError, ValueError)) as e_pb:
            pb.GenerateRequest(**bad)
        assert type(e_pb.value) is type(e_ref.value) or bad == dict(
            temperature="x"), bad
    with pytest.raises(ValueError):
        pb.GenerateRequest(nope=1)


def test_unknown_fields_and_unpacked_repeated_are_read():
    wire = ref.GenerateRequest(model_name="m", steps=3, prompt=[1, 2],
                               request_class="batch", seed=9,
                               kv_shipment=b"k").SerializeToString()
    # a message that knows none of these fields skips them all
    assert pb.HealthRequest.FromString(wire) == pb.HealthRequest()
    assert pb.StatusRequest.FromString(wire).model_name == "m"
    # unpacked repeated int32 (field 2, varint) and a fixed64 / a fixed32
    # unknown field (numbers 90 and 91) in between
    raw = (b"\x10\x05\x10\x80\x01" + b"\xd1\x05" + b"\0" * 8
           + b"\xdd\x05" + b"\0" * 4 + b"\x10\x7f")
    for mod in (ref, pb):
        assert list(mod.GenerateRequest.FromString(raw).prompt) == [
            5, 128, 127]
    with pytest.raises(ValueError):
        pb.GenerateRequest.FromString(b"\x12\x05\x01")   # truncated
