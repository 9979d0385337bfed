"""The inference service's message classes without ``google.protobuf``
(the port's counterpart of tpulab's generated ``inference_pb2``).

So that the service runs where protobuf is not installed, the 16
messages and the ``StatusCode`` enum of ``inference.proto`` (beside this
file) are plain Python classes here, with the names, the module-level enum values
(``SUCCESS``, ``RESOURCE_EXHAUSTED``, ...) and the part of the generated
API the service and its clients use: keyword construction, nested and
repeated fields (``append`` / ``extend`` / ``add``), ``HasField``,
``SerializeToString()``, ``FromString()`` and ``StatusCode.Name`` /
``Value``.  They keep protobuf's proto3 semantics
where the service depends on them:

- a field at its default is not written; a message field is written once
  it is present (assigned, passed to the constructor, or any of its
  fields set through the parent: ``resp.status.code = ...``);
  ``GenerateRequest.seed`` (the schema's one ``optional``) is written
  whenever it is present, 0 included;
- fields are written in field-number order, repeated numeric fields
  packed; an int32 or enum below zero is a 10-byte varint;
- ``float`` fields hold the float32-rounded value from the moment they
  are set (0.7 reads back as 0.699999988079071), so checks such as the
  Generate RPC's ``top_p`` range see what the wire carries;
- integer fields refuse floats (``TypeError``) and out-of-range values
  (``ValueError``); numpy integers are accepted;
- parsing skips unknown fields and accepts packed and unpacked repeated
  numbers.

Byte equality with tpulab's generated classes, both ways, is held by
``tests/test_torch_rpc_messages.py``.
"""

from __future__ import annotations

import math
import operator
import struct
from typing import Any, Callable, Dict, List, Tuple

__all__ = [
    "StatusCode", "INVALID", "SUCCESS", "UNKNOWN_MODEL", "INVALID_ARGUMENT",
    "INTERNAL", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED", "NOT_FOUND",
    "TensorProto", "InferRequest", "InferResponse", "RequestStatus",
    "ModelIOSpec", "ModelStatus", "StatusRequest", "StatusResponse",
    "HealthRequest", "HealthResponse", "DebugRequest", "DebugResponse",
    "GenerateRequest", "GenerateResponse", "FetchKVRequest",
    "FetchKVResponse",
]


class DecodeError(ValueError):
    """Malformed wire bytes (protobuf's ``DecodeError`` counterpart)."""


# -- the enum ------------------------------------------------------------------
class _EnumType:
    """``StatusCode`` with protobuf's enum-wrapper surface."""

    def __init__(self, name: str, values: List[Tuple[str, int]]):
        self._name = name
        self._by_name = dict(values)
        self._by_number: Dict[int, str] = {}
        for k, v in values:
            self._by_number.setdefault(v, k)

    def Name(self, number: int) -> str:
        try:
            return self._by_number[int(number)]
        except KeyError:
            raise ValueError(f"enum {self._name} has no name defined for "
                             f"value {number!r}") from None

    def Value(self, name: str) -> int:
        try:
            return self._by_name[name]
        except KeyError:
            raise ValueError(f"enum {self._name} has no value defined for "
                             f"name {name!r}") from None


_STATUS_CODES = [("INVALID", 0), ("SUCCESS", 1), ("UNKNOWN_MODEL", 2),
                 ("INVALID_ARGUMENT", 3), ("INTERNAL", 4),
                 ("DEADLINE_EXCEEDED", 5), ("RESOURCE_EXHAUSTED", 6),
                 ("NOT_FOUND", 7)]
StatusCode = _EnumType("StatusCode", _STATUS_CODES)
INVALID = 0
SUCCESS = 1
UNKNOWN_MODEL = 2
INVALID_ARGUMENT = 3
INTERNAL = 4
DEADLINE_EXCEEDED = 5
RESOURCE_EXHAUSTED = 6
NOT_FOUND = 7


# -- scalar kinds ----------------------------------------------------------------
_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5
_INT_RANGE = {"int32": (-(1 << 31), (1 << 31) - 1),
              "int64": (-(1 << 63), (1 << 63) - 1),
              "uint64": (0, (1 << 64) - 1),
              "enum": (-(1 << 31), (1 << 31) - 1)}


def _to_int(kind: str) -> Callable[[Any], int]:
    lo, hi = _INT_RANGE[kind]

    def conv(v):
        if isinstance(v, float):
            raise TypeError(f"{v!r} has type float, but expected one of: "
                            "int")
        v = operator.index(v)
        if not lo <= v <= hi:
            raise ValueError(f"Value out of range: {v}")
        return v
    return conv


def _to_float(v) -> float:
    if isinstance(v, (str, bytes)):
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected "
                        "one of: int, float")
    v = float(v)
    try:
        return struct.unpack("<f", struct.pack("<f", v))[0]
    except OverflowError:           # past float32's range: +-inf, as upb
        return math.copysign(math.inf, v)


def _to_bool(v) -> bool:
    if isinstance(v, float):
        raise TypeError(f"{v!r} has type float, but expected one of: "
                        "int, bool")
    return bool(operator.index(v))


def _to_str(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if not isinstance(v, str):
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected "
                        "one of: bytes, str")
    return v


def _to_bytes(v) -> bytes:
    if isinstance(v, str):
        raise TypeError(f"{v!r} has type str, but expected one of: bytes")
    return bytes(v)


_CONVERT = {"int32": _to_int("int32"), "int64": _to_int("int64"),
            "uint64": _to_int("uint64"), "enum": _to_int("enum"),
            "bool": _to_bool, "float": _to_float, "string": _to_str,
            "bytes": _to_bytes}
_DEFAULT = {"int32": 0, "int64": 0, "uint64": 0, "enum": 0, "bool": False,
            "float": 0.0, "string": "", "bytes": b""}
_PACKABLE = ("int32", "int64", "uint64", "enum", "bool", "float")


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64                # two's complement: a 10-byte varint
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _scalar_value(kind: str, raw: int) -> Any:
    if kind in ("int32", "enum"):
        return _signed(raw, 32)
    if kind == "int64":
        return _signed(raw, 64)
    if kind == "uint64":
        return raw & ((1 << 64) - 1)
    return bool(raw)


def _encode_scalar(kind: str, v) -> bytes:
    if kind == "float":
        return struct.pack("<f", v)
    return _varint(int(v))


def _wire_type(kind: str) -> int:
    if kind == "float":
        return _WT_I32
    if kind in ("string", "bytes", "message"):
        return _WT_LEN
    return _WT_VARINT


# -- fields ----------------------------------------------------------------------
class _Field:
    __slots__ = ("name", "number", "kind", "repeated", "optional",
                 "msg_name", "tag")

    def __init__(self, name, number, kind, repeated=False, optional=False,
                 msg_name=None):
        self.name = name
        self.number = number
        self.kind = kind
        self.repeated = repeated
        self.optional = optional
        self.msg_name = msg_name
        wt = _WT_LEN if repeated and kind in _PACKABLE else _wire_type(kind)
        self.tag = _varint((number << 3) | wt)

    @property
    def msg_cls(self):
        return _MESSAGES[self.msg_name]


class _Repeated(list):
    """A repeated field: a list that converts what it is given (protobuf's
    type checks) and marks its owner present when it changes."""

    __slots__ = ("_conv", "_owner")

    def __init__(self, conv, owner, items=()):
        super().__init__(conv(v) for v in items)
        self._conv = conv
        self._owner = owner

    def append(self, v) -> None:
        super().append(self._conv(v))
        self._owner._mark()

    def extend(self, vs) -> None:
        super().extend(self._conv(v) for v in vs)
        self._owner._mark()

    def add(self, **kw):
        """Append a new message built from ``kw`` and return it (repeated
        message fields)."""
        msg = self._conv(None)(**kw)
        super().append(msg)
        self._owner._mark()
        return msg


class _Message:
    """Base of the generated-style message classes (module docstring)."""

    _FIELDS: Tuple[_Field, ...] = ()
    _BY_NAME: Dict[str, _Field] = {}
    _BY_NUMBER: Dict[int, _Field] = {}
    __slots__ = ("_values", "_present", "_parent")

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_present", set())
        object.__setattr__(self, "_parent", None)
        for k, v in kwargs.items():
            f = self._BY_NAME.get(k)
            if f is None:
                raise ValueError(f"Protocol message {type(self).__name__} "
                                 f"has no \"{k}\" field.")
            if v is None:
                continue
            if f.repeated:
                getattr(self, k).extend(v)
            else:
                setattr(self, k, v)

    # -- presence ------------------------------------------------------------
    def _mark(self) -> None:
        """This message changed: every lazily created ancestor becomes
        present in its parent."""
        link = self._parent
        while link is not None:
            parent, name = link
            parent._present.add(name)
            link = parent._parent

    def _converter(self, f: _Field):
        if f.kind != "message":
            return _CONVERT[f.kind]
        cls = f.msg_cls

        def conv(v, cls=cls):
            if v is None:
                return cls
            if not isinstance(v, cls):
                raise TypeError(f"expected {cls.__name__}, got "
                                f"{type(v).__name__}")
            return v
        return conv

    def __getattr__(self, name):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        vals = self._values
        if name in vals:
            return vals[name]
        if f.repeated:
            v = vals[name] = _Repeated(self._converter(f), self)
            return v
        if f.kind == "message":
            # the default sub-message: present only once it is written to
            v = f.msg_cls()
            object.__setattr__(v, "_parent", (self, name))
            vals[name] = v
            return v
        return _DEFAULT[f.kind]

    def __setattr__(self, name, value):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field "
                                 f"{name!r}")
        if f.repeated:
            raise AttributeError(
                f"Assignment not allowed to repeated field \"{name}\" in "
                "protocol message object.")
        if f.kind == "message":
            if not isinstance(value, f.msg_cls):
                raise TypeError(f"expected {f.msg_cls.__name__}, got "
                                f"{type(value).__name__}")
            value = f.msg_cls.FromString(value.SerializeToString())
            object.__setattr__(value, "_parent", (self, name))
        else:
            value = _CONVERT[f.kind](value)
        self._values[name] = value
        if f.kind == "message" or f.optional:
            self._present.add(name)
        self._mark()

    def HasField(self, name: str) -> bool:
        f = self._BY_NAME.get(name)
        if f is None:
            raise ValueError(f"Protocol message {type(self).__name__} has "
                             f"no field {name}.")
        if f.repeated or not (f.kind == "message" or f.optional):
            raise ValueError(f"Field tpulab.inference.{type(self).__name__}"
                             f".{name} does not have presence.")
        return name in self._present

    # -- the wire ------------------------------------------------------------
    def _written(self, f: _Field):
        """The field's value when it goes on the wire, else None."""
        v = self._values.get(f.name)
        if v is None:
            return None
        if f.repeated:
            return v if len(v) else None
        if f.kind == "message" or f.optional:
            return v if f.name in self._present else None
        if f.kind == "float":
            # proto3 writes a float whose bits are not all zero (-0.0 is)
            return v if struct.pack("<f", v) != b"\0\0\0\0" else None
        return v if v else None

    def SerializeToString(self, **_kw) -> bytes:
        out: List[bytes] = []
        for f in self._FIELDS:
            v = self._written(f)
            if v is None:
                continue
            if f.repeated and f.kind in _PACKABLE:
                if f.kind == "float":
                    body = struct.pack(f"<{len(v)}f", *v)
                else:
                    body = b"".join(_varint(int(x)) for x in v)
                out += [f.tag, _varint(len(body)), body]
            elif f.repeated:
                for x in v:
                    out += [f.tag, *_len_delimited(f.kind, x)]
            elif f.kind in ("string", "bytes", "message"):
                out += [f.tag, *_len_delimited(f.kind, v)]
            else:
                out += [f.tag, _encode_scalar(f.kind, v)]
        return b"".join(out)

    @classmethod
    def FromString(cls, data) -> "_Message":
        msg = cls()
        msg.MergeFromString(data)
        return msg

    def MergeFromString(self, data) -> int:
        buf = memoryview(bytes(data))
        pos, end = 0, len(buf)
        while pos < end:
            key, pos = _read_varint(buf, pos)
            number, wt = key >> 3, key & 7
            f = self._BY_NUMBER.get(number)
            if f is None:
                pos = _skip(buf, pos, wt)
                continue
            if wt == _WT_LEN:
                n, pos = _read_varint(buf, pos)
                if pos + n > end:
                    raise DecodeError("truncated length-delimited field")
                chunk, pos = buf[pos:pos + n], pos + n
                if f.kind in _PACKABLE:
                    if not f.repeated:
                        raise DecodeError(f"field {f.name}: packed bytes "
                                          "for a singular field")
                    self._merge_packed(f, chunk)
                    continue
                if f.kind == "message":
                    sub = f.msg_cls.FromString(chunk)
                    v = sub
                elif f.kind == "string":
                    try:
                        v = bytes(chunk).decode("utf-8")
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"field {f.name}: invalid "
                                          "UTF-8") from e
                else:
                    v = bytes(chunk)
            elif wt == _WT_VARINT and f.kind in _PACKABLE and f.kind != "float":
                raw, pos = _read_varint(buf, pos)
                v = _scalar_value(f.kind, raw)
            elif wt == _WT_I32 and f.kind == "float":
                if pos + 4 > end:
                    raise DecodeError("truncated fixed32")
                v = struct.unpack_from("<f", buf, pos)[0]
                pos += 4
            else:
                raise DecodeError(f"field {f.name}: wire type {wt} does not "
                                  f"match its kind {f.kind}")
            self._store(f, v)
        return end

    def _merge_packed(self, f: _Field, chunk: memoryview) -> None:
        lst = getattr(self, f.name)
        if f.kind == "float":
            if len(chunk) % 4:
                raise DecodeError(f"field {f.name}: packed floats of "
                                  f"{len(chunk)} bytes")
            list.extend(lst, struct.unpack(f"<{len(chunk) // 4}f", chunk))
            return
        pos, vals = 0, []
        while pos < len(chunk):
            raw, pos = _read_varint(chunk, pos)
            vals.append(_scalar_value(f.kind, raw))
        list.extend(lst, vals)

    def _store(self, f: _Field, v) -> None:
        if f.repeated:
            list.append(getattr(self, f.name), v)
            return
        if f.kind == "message" and f.name in self._present:
            # a repeated occurrence of a singular message merges into it
            old = self._values[f.name]
            old.MergeFromString(v.SerializeToString())
            return
        if f.kind == "message":
            object.__setattr__(v, "_parent", (self, f.name))
        self._values[f.name] = v
        if f.kind == "message" or f.optional:
            self._present.add(f.name)

    # -- value semantics -----------------------------------------------------
    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(self._cmp_value(f) == other._cmp_value(f)
                   for f in self._FIELDS)

    def _cmp_value(self, f: _Field):
        if f.repeated:
            return list(self._values.get(f.name, ()))
        if f.kind == "message" or f.optional:
            return (self._values[f.name] if f.name in self._present
                    else None)
        return self._values.get(f.name, _DEFAULT[f.kind])

    __hash__ = None

    def __repr__(self) -> str:
        parts = []
        for f in self._FIELDS:
            v = self._written(f)
            if v is not None:
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    __str__ = __repr__


def _len_delimited(kind: str, v) -> Tuple[bytes, bytes]:
    if kind == "string":
        body = v.encode("utf-8")
    elif kind == "message":
        body = v.SerializeToString()
    else:
        body = v
    return _varint(len(body)), body


def _skip(buf: memoryview, pos: int, wt: int, depth: int = 0) -> int:
    """Skip one unknown field's payload of wire type ``wt``."""
    if wt == _WT_VARINT:
        return _read_varint(buf, pos)[1]
    if wt == _WT_I64:
        pos += 8
    elif wt == _WT_I32:
        pos += 4
    elif wt == _WT_LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wt == 3 and depth < 64:          # a group: skip to its end tag
        while True:
            key, pos = _read_varint(buf, pos)
            if key & 7 == 4:
                break
            pos = _skip(buf, pos, key & 7, depth + 1)
    else:
        raise DecodeError(f"unknown wire type {wt}")
    if pos > len(buf):
        raise DecodeError("truncated field")
    return pos


_MESSAGES: Dict[str, type] = {}


def _message(name: str, *fields: _Field) -> type:
    fields = tuple(sorted(fields, key=lambda f: f.number))
    cls = type(name, (_Message,), {
        "__slots__": (), "_FIELDS": fields,
        "_BY_NAME": {f.name: f for f in fields},
        "_BY_NUMBER": {f.number: f for f in fields},
        "__module__": __name__, "__qualname__": name})
    _MESSAGES[name] = cls
    return cls


def _f(name, number, kind, msg_name=None, optional=False):
    return _Field(name, number, kind, optional=optional, msg_name=msg_name)


def _r(name, number, kind, msg_name=None):
    return _Field(name, number, kind, repeated=True, msg_name=msg_name)


# -- the schema (inference.proto, field for field) -------------------------------
TensorProto = _message(
    "TensorProto", _f("name", 1, "string"), _f("dtype", 2, "string"),
    _r("dims", 3, "int64"), _f("raw_data", 4, "bytes"))
InferRequest = _message(
    "InferRequest", _f("model_name", 1, "string"),
    _f("batch_size", 2, "int32"), _r("inputs", 3, "message", "TensorProto"),
    _r("requested_outputs", 4, "string"), _f("correlation_id", 5, "uint64"),
    _f("trace_id", 6, "string"), _f("tenant_id", 7, "string"))
RequestStatus = _message(
    "RequestStatus", _f("code", 1, "enum"), _f("message", 2, "string"),
    _f("retry_after_ms", 3, "uint64"))
InferResponse = _message(
    "InferResponse", _f("model_name", 1, "string"),
    _r("outputs", 2, "message", "TensorProto"),
    _f("status", 3, "message", "RequestStatus"),
    _f("correlation_id", 4, "uint64"))
ModelIOSpec = _message(
    "ModelIOSpec", _f("name", 1, "string"), _f("dtype", 2, "string"),
    _r("dims", 3, "int64"))
ModelStatus = _message(
    "ModelStatus", _f("name", 1, "string"), _f("max_batch_size", 2, "int32"),
    _r("batch_buckets", 3, "int32"),
    _r("inputs", 4, "message", "ModelIOSpec"),
    _r("outputs", 5, "message", "ModelIOSpec"),
    _f("weights_bytes", 6, "uint64"))
StatusRequest = _message("StatusRequest", _f("model_name", 1, "string"))
StatusResponse = _message(
    "StatusResponse", _r("models", 1, "message", "ModelStatus"),
    _f("status", 2, "message", "RequestStatus"),
    _f("server_version", 3, "string"), _f("queued_requests", 4, "int64"),
    _f("free_kv_pages", 5, "int64"), _f("role", 6, "string"),
    _r("resident_models", 7, "string"), _r("host_models", 8, "string"),
    _f("free_hbm_bytes", 9, "int64"), _f("prefix_hits", 10, "int64"),
    _f("prefix_lookups", 11, "int64"), _f("draining", 12, "bool"),
    _f("inflight_requests", 13, "int64"))
HealthRequest = _message("HealthRequest")
HealthResponse = _message("HealthResponse", _f("live", 1, "bool"),
                          _f("ready", 2, "bool"))
DebugRequest = _message(
    "DebugRequest", _f("model_name", 1, "string"),
    _f("profile_ticks", 2, "int32"), _f("profile_dir", 3, "string"))
DebugResponse = _message(
    "DebugResponse", _f("status", 1, "message", "RequestStatus"),
    _f("snapshot_json", 2, "string"), _f("profile_dir", 3, "string"))
GenerateRequest = _message(
    "GenerateRequest", _f("model_name", 1, "string"),
    _r("prompt", 2, "int32"), _f("steps", 3, "int32"),
    _f("priority", 4, "int32"), _f("temperature", 5, "float"),
    _f("top_k", 6, "int32"), _f("seed", 7, "uint64", optional=True),
    _r("stop_tokens", 8, "int32"), _f("device_sampling", 9, "bool"),
    _f("return_logprobs", 10, "bool"), _f("top_p", 11, "float"),
    _f("deadline_ms", 12, "uint64"), _f("trace_id", 13, "string"),
    _f("tenant_id", 14, "string"), _f("prefill_only", 15, "bool"),
    _f("kv_shipment", 16, "bytes"), _f("resume_length", 17, "int32"),
    _f("request_class", 18, "string"))
FetchKVRequest = _message("FetchKVRequest", _f("model_name", 1, "string"),
                          _f("digest", 2, "bytes"))
FetchKVResponse = _message(
    "FetchKVResponse", _f("status", 1, "message", "RequestStatus"),
    _f("kv_shipment", 2, "bytes"))
GenerateResponse = _message(
    "GenerateResponse", _f("token", 1, "int32"), _f("index", 2, "int32"),
    _f("final", 3, "bool"), _f("status", 4, "message", "RequestStatus"),
    _f("logprob", 5, "float"), _f("kv_shipment", 6, "bytes"))
