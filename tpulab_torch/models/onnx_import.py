"""ONNX model import: ``model.onnx`` -> servable
:class:`tpulab_torch.engine.model.Model` (the port of
``tpulab/models/onnx_import.py``).

Self-contained, as tpulab's: the ``onnx`` package is not a dependency.
The protobuf wire-format reader and the ONNX field numbers below are a
copy of tpulab's (the same bytes give the same numpy arrays and the same
errors); the evaluator runs the graph as eager PyTorch on NCHW tensors.

How the port computes tpulab's function:
- initializers and ``Constant`` values are the params tree (float64
  leaves as float32, as JAX holds them); the graph inputs are tensors;
- Shape- and Constant-derived subgraphs (the exporters' dynamic-reshape
  idiom, Shape -> Gather -> Concat -> Reshape) fold on the host: a node
  whose every input is such a value runs on CPU tensors made from numpy
  and its outputs return to numpy, never to the device, so a Reshape
  never waits on the card (tpulab folds them with
  ``jax.ensure_compile_time_eval``).  The pool of folded values is per
  call: buckets served concurrently never share it;
- ``auto_pad="SAME_UPPER"`` is JAX's ``"SAME"`` and, like asymmetric
  ``pads``, runs as an explicit ``F.pad`` then ``padding=0``; pools pad
  with -inf (max) or 0 and divide by the unpadded count
  (``count_include_pad=0``); ``Resize`` is ``jax.image.resize``'s
  half-pixel weight matrices, ``ConvTranspose`` the transposed
  convolution cropped by ``pads`` and extended by ``output_padding``;
- ``weight_quant="int8"`` stores eligible Conv / MatMul / Gemm weights as
  ``{w_int8, scale}`` and the consuming op dequantizes in f32
  (:func:`_wval`).

Output specs come from one batch-1 forward on the CPU (tpulab:
``jax.eval_shape``), which also surfaces an unsupported op at import.
"""

from __future__ import annotations

import contextlib
import math
import os
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# protobuf wire-format reader (varint / 64-bit / length-delimited / 32-bit)
# --------------------------------------------------------------------------


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> List[Tuple[int, int, Any]]:
    """Decode one message's fields -> [(field_no, wire_type, raw_value)].
    Length-delimited values stay ``bytes`` (sub-message, string, or packed
    repeated — the schema layer decides)."""
    out = []
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.append((fno, wt, v))
    return out


def _group(buf: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    g: Dict[int, List[Tuple[int, Any]]] = {}
    for fno, wt, v in _fields(buf):
        g.setdefault(fno, []).append((wt, v))
    return g


def _packed_varints(entries: List[Tuple[int, Any]]) -> List[int]:
    """Repeated int field: packed (length-delimited) and/or unpacked."""
    out: List[int] = []
    for wt, v in entries:
        if wt == 2:
            i = 0
            while i < len(v):
                x, i = _varint(v, i)
                out.append(x)
        else:
            out.append(v)
    return out


def _zigzag_signed(x: int, bits: int = 64) -> int:
    """Plain (non-zigzag) two's-complement signed varint, as int64/32
    protobuf fields use."""
    if x >= 1 << (bits - 1):
        x -= 1 << bits
    return x


# --------------------------------------------------------------------------
# ONNX schema (field numbers from onnx/onnx.proto — stable since IR v3)
# --------------------------------------------------------------------------

# TensorProto.DataType -> numpy
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
           6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
           11: np.float64, 12: np.uint32, 13: np.uint64}

# unsupported-but-known codes, named so the error diagnoses itself
_DTYPE_NAMES = {0: "UNDEFINED", 8: "STRING", 14: "COMPLEX64",
                15: "COMPLEX128", 16: "BFLOAT16", 17: "FLOAT8E4M3FN",
                18: "FLOAT8E4M3FNUZ", 19: "FLOAT8E5M2",
                20: "FLOAT8E5M2FNUZ", 21: "UINT4", 22: "INT4", 23: "FLOAT4E2M1"}


def _np_dtype(code: int, tensor: str = "") -> np.dtype:
    """numpy dtype for an ONNX TensorProto.DataType code; unsupported
    codes raise an error naming the code and the tensor."""
    try:
        return np.dtype(_DTYPES[code])
    except KeyError:
        known = _DTYPE_NAMES.get(code, "unknown")
        where = f" (tensor {tensor!r})" if tensor else ""
        raise NotImplementedError(
            f"ONNX TensorProto dtype code {code} [{known}]{where} has no "
            f"numpy equivalent in this importer; supported codes: "
            f"{sorted(_DTYPES)}") from None


def _decode_tensor(buf: bytes, base_dir: Optional[str] = None,
                   collect_external: Optional[list] = None
                   ) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray).  Fields: dims=1 data_type=2
    float_data=4 int32_data=5 string_data=6 int64_data=7 name=8 raw_data=9
    double_data=10 uint64_data=11 external_data=13 data_location=14.

    ``data_location=EXTERNAL`` tensors (how >2 GB zoo models ship their
    weights) load from the sidecar file named in external_data
    (StringStringEntryProto key=1 value=2: location/offset/length),
    resolved against ``base_dir`` — the model.onnx's directory.  With
    ``collect_external`` (a list) the sidecar is NOT read: metadata is
    appended and a zeros placeholder of the right shape/dtype returned —
    the preflight mode."""
    g = _group(buf)
    dims = _packed_varints(g.get(1, []))
    dt = _packed_varints(g.get(2, []))
    name = g[8][0][1].decode() if 8 in g else ""
    dtype = _np_dtype(dt[0] if dt else 1, name)
    loc = _packed_varints(g.get(14, []))
    if loc and loc[0] == 1:  # EXTERNAL
        info = {}
        for _, entry in g.get(13, []):
            eg = _group(entry)
            k = eg[1][0][1].decode() if 1 in eg else ""
            v = eg[2][0][1].decode() if 2 in eg else ""
            info[k] = v
        if "location" not in info:
            raise ValueError(f"external tensor {name!r} without location")
        if collect_external is not None:
            collect_external.append(dict(info, tensor=name))
            return name, np.zeros(dims or [0], dtype)
        if base_dir is None:
            raise ValueError(
                f"tensor {name!r} stores its data externally "
                f"({info['location']}); parse from a file path so the "
                "sidecar can be resolved")
        rel = os.path.normpath(info["location"])
        if rel == ".." or rel.startswith("../") or os.path.isabs(rel):
            # stay inside the model dir ("..weights.bin" is a legal name)
            raise ValueError(f"external data path escapes model dir: "
                             f"{info['location']!r}")
        path = os.path.join(base_dir, rel)
        offset = int(info.get("offset", 0))
        length = int(info.get("length",
                              int(np.prod(dims or [1])) * dtype.itemsize))
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(length)
        if len(raw) != length:
            raise ValueError(f"external tensor {name!r}: wanted {length} "
                             f"bytes at {offset}, got {len(raw)}")
        arr = np.frombuffer(raw, dtype=dtype)
        return name, arr.reshape(dims) if dims else arr
    if 9 in g:  # raw_data: little-endian, C order (the common zoo encoding)
        raw = b"".join(v for _, v in g[9])
        arr = np.frombuffer(raw, dtype=dtype)
    elif 4 in g:  # float_data (packed fixed32 or unpacked)
        vals: List[float] = []
        for wt, v in g[4]:
            if wt == 2:
                vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                vals.append(struct.unpack("<f", struct.pack("<I", v))[0])
        arr = np.asarray(vals, np.float32).astype(dtype)
    elif 7 in g:  # int64_data
        arr = np.asarray([_zigzag_signed(x) for x in _packed_varints(g[7])],
                         np.int64).astype(dtype)
    elif 5 in g:  # int32_data (also carries f16/i8/u8/i16/u16/bool payloads)
        # negative int32 still serializes as 64-bit two's complement
        ints = [_zigzag_signed(x) for x in _packed_varints(g[5])]
        if dtype == np.float16:
            arr = np.asarray(ints, np.uint16).view(np.float16)
        else:
            arr = np.asarray(ints, np.int32).astype(dtype)
    elif 10 in g:  # double_data
        vals = []
        for wt, v in g[10]:
            if wt == 2:
                vals.extend(struct.unpack(f"<{len(v) // 8}d", v))
            else:
                vals.append(struct.unpack("<d", struct.pack("<Q", v))[0])
        arr = np.asarray(vals, np.float64).astype(dtype)
    elif 11 in g:  # uint64_data
        arr = np.asarray(_packed_varints(g[11]), np.uint64).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def _decode_attr(buf: bytes, base_dir: Optional[str] = None,
                 collect_external: Optional[list] = None) -> Tuple[str, Any]:
    """AttributeProto: name=1 f=2 i=3 s=4 t=5 g=6 floats=7 ints=8
    strings=9 (type=20 is redundant with which field is set)."""
    g = _group(buf)
    name = g[1][0][1].decode()
    if 2 in g:
        return name, struct.unpack("<f", struct.pack("<I", g[2][0][1]))[0]
    if 3 in g:
        return name, _zigzag_signed(g[3][0][1])
    if 4 in g:
        return name, g[4][0][1]  # bytes
    if 5 in g:
        return name, _decode_tensor(g[5][0][1], base_dir,
                                    collect_external)[1]
    if 7 in g:
        vals = []
        for wt, v in g[7]:
            if wt == 2:
                vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                vals.append(struct.unpack("<f", struct.pack("<I", v))[0])
        return name, vals
    if 8 in g:
        return name, [_zigzag_signed(x) for x in _packed_varints(g[8])]
    if 9 in g:
        return name, [v for _, v in g[9]]
    if 6 in g:
        raise NotImplementedError("graph-valued attributes (If/Loop/Scan) "
                                  "are outside the importer's static scope")
    return name, None


class OnnxNode:
    __slots__ = ("op", "name", "inputs", "outputs", "attrs")

    def __init__(self, buf: bytes, base_dir: Optional[str] = None,
                 collect_external: Optional[list] = None):
        g = _group(buf)  # input=1 output=2 name=3 op_type=4 attribute=5
        self.inputs = [v.decode() for _, v in g.get(1, [])]
        self.outputs = [v.decode() for _, v in g.get(2, [])]
        self.name = g[3][0][1].decode() if 3 in g else ""
        self.op = g[4][0][1].decode() if 4 in g else ""
        self.attrs = dict(_decode_attr(v, base_dir, collect_external)
                          for _, v in g.get(5, []))


def _decode_value_info(buf: bytes) -> Tuple[str, Optional[np.dtype],
                                            List[Optional[int]]]:
    """ValueInfoProto -> (name, dtype, dims) with None for symbolic dims.
    name=1 type=2; TypeProto.tensor_type=1; Tensor.elem_type=1 shape=2;
    TensorShapeProto.dim=1; Dimension.dim_value=1 dim_param=2."""
    g = _group(buf)
    name = g[1][0][1].decode()
    dtype, dims = None, []
    if 2 in g:
        tp = _group(g[2][0][1])
        if 1 in tp:
            tt = _group(tp[1][0][1])
            if 1 in tt:
                dtype = np.dtype(_DTYPES.get(tt[1][0][1], np.float32))
            if 2 in tt:
                for _, dim_buf in _group(tt[2][0][1]).get(1, []):
                    d = _group(dim_buf)
                    dims.append(d[1][0][1] if 1 in d else None)
    return name, dtype, dims


class OnnxGraph:
    """Parsed GraphProto: node=1 name=2 initializer=5 input=11 output=12."""

    def __init__(self, buf: bytes, base_dir: Optional[str] = None,
                 collect_external: Optional[list] = None):
        g = _group(buf)
        self.name = g[2][0][1].decode() if 2 in g else "onnx"
        self.nodes = [OnnxNode(v, base_dir, collect_external)
                      for _, v in g.get(1, [])]
        self.initializers: Dict[str, np.ndarray] = dict(
            _decode_tensor(v, base_dir, collect_external)
            for _, v in g.get(5, []))
        self.inputs = [_decode_value_info(v) for _, v in g.get(11, [])]
        self.outputs = [_decode_value_info(v) for _, v in g.get(12, [])]


class OnnxModel:
    """Parsed ModelProto: ir_version=1 producer_name=2 graph=7
    opset_import=8 (OperatorSetIdProto: domain=1 version=2)."""

    def __init__(self, data: bytes, base_dir: Optional[str] = None,
                 collect_external: Optional[list] = None):
        g = _group(data)
        self.ir_version = g[1][0][1] if 1 in g else 0
        self.producer = g[2][0][1].decode() if 2 in g else ""
        self.opset = 1
        for _, v in g.get(8, []):
            os_g = _group(v)
            domain = os_g[1][0][1].decode() if 1 in os_g else ""
            if domain in ("", "ai.onnx") and 2 in os_g:
                self.opset = max(self.opset, os_g[2][0][1])
        if 7 not in g:
            raise ValueError("ModelProto has no graph")
        self.graph = OnnxGraph(g[7][0][1], base_dir, collect_external)


def load_tensor_pb(path: str) -> np.ndarray:
    """A bare serialized TensorProto (the zoo's test_data_set vectors)."""
    with open(path, "rb") as f:
        return _decode_tensor(f.read(), os.path.dirname(
            os.path.abspath(path)))[1]


# --------------------------------------------------------------------------
# ONNX graph -> PyTorch function
# --------------------------------------------------------------------------


def _pair_pads(pads: Sequence[int], nd: int) -> List[Tuple[int, int]]:
    """ONNX pads [x1_b, x2_b, ..., x1_e, x2_e, ...] -> [(b, e), ...]."""
    return [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]


def _canon_np(arr: np.ndarray) -> np.ndarray:
    """A weight leaf as JAX holds it without x64: float64 -> float32."""
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def _to_torch(arr: np.ndarray, device=None) -> torch.Tensor:
    """A numpy value as a tensor (zero-copy on the CPU when it can be)."""
    arr = np.asarray(arr)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True, order="C")
    t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


@contextlib.contextmanager
def _host():
    """Run PyTorch eagerly on real CPU tensors even while the forward is
    being traced (``torch.export`` of a bucket's program): the host fold's
    values are shape material, constants of the traced program."""
    from torch.utils._python_dispatch import _disable_current_modes

    with torch._C.DisableTorchFunction(), _disable_current_modes():
        yield


class _Eval:
    """One forward's evaluation state: the host pool of folded values is
    per call, so buckets served at once never see each other's."""

    def __init__(self, conv: "_Converter"):
        self.opset = conv.opset
        self.static = conv.static
        self._const_names = conv._const_names
        self._shape_pool: Dict[str, np.ndarray] = {}

    def _static_val(self, name: str) -> np.ndarray:
        if name in self._shape_pool:
            return self._shape_pool[name]
        if name not in self.static:
            raise NotImplementedError(
                f"input {name!r} must be a static initializer/Constant "
                "(data-dependent shapes cannot serve as static shapes)")
        return self.static[name]

    def _pool_val(self, name: str) -> Optional[np.ndarray]:
        if name in self._shape_pool:
            return self._shape_pool[name]
        if name in self._const_names:
            return self.static[name]
        # small integer initializers are shape material (gather indices,
        # axes, reshape targets), never swappable weights — poolable.
        # Float initializers stay in params so weights are read, not baked.
        v = self.static.get(name)
        if (v is not None and v.dtype.kind in "iu" and v.size <= 64
                and v.ndim <= 1):
            return v
        return None


class _Converter:
    """Evaluates the (topologically sorted, per ONNX spec) node list as
    eager PyTorch.  Initializers live in the params tree; shape-carrying
    inputs (Reshape targets, Pad amounts, ...) read the static numpy copy."""

    def __init__(self, model: OnnxModel):
        self.model = model
        self.g = model.graph
        self.opset = model.opset
        self.static: Dict[str, np.ndarray] = dict(self.g.initializers)
        self._const_names: set = set()

    def prefold_constants(self) -> None:
        """Constant nodes join the static pool (and params) up front."""
        for node in self.g.nodes:
            if node.op == "Constant":
                val = node.attrs.get("value")
                if val is None:
                    raise NotImplementedError("Constant without 'value'")
                self.static[node.outputs[0]] = np.asarray(val)
                self._const_names.add(node.outputs[0])

    def build(self) -> Tuple[Callable, Dict[str, np.ndarray],
                             List[str], List[str]]:
        self.prefold_constants()
        graph_inputs = [n for n, _, _ in self.g.inputs
                        if n not in self.static]
        out_names = [n for n, _, _ in self.g.outputs]
        params = {k: _canon_np(v) for k, v in self.static.items()}
        nodes = self.g.nodes

        def apply_fn(p: Dict[str, Any], inputs: Dict[str, Any]
                     ) -> Dict[str, Any]:
            ev = _Eval(self)
            env: Dict[str, Any] = dict(p)
            env.update(inputs)
            device = _device_of(inputs, p)
            for node in nodes:
                if node.op == "Constant":
                    continue                  # its value is in the params
                real_ins = [i for i in node.inputs if i]
                if node.op == "Shape":
                    # always host-static; seeds the shape pool
                    val = np.asarray(env[real_ins[0]].shape, np.int64)
                    ev._shape_pool[node.outputs[0]] = val
                    env[node.outputs[0]] = val
                    continue
                fn = _OPS.get(node.op)
                if fn is None:
                    raise NotImplementedError(
                        f"ONNX op {node.op!r} (node {node.name!r}) is not "
                        "supported by the importer")
                pooled = [ev._pool_val(i) for i in real_ins]
                if real_ins and all(v is not None for v in pooled):
                    # whole-subgraph fold on Constant/Shape-derived values:
                    # CPU tensors from numpy, the results back to numpy
                    it = iter(pooled)
                    with _host():
                        args = [_to_torch(next(it)) if i else None
                                for i in node.inputs]
                        res = fn(ev, node, args)
                        res = res if isinstance(res, tuple) else (res,)
                        res = [np.asarray(v.numpy() if isinstance(
                            v, torch.Tensor) else v) for v in res]
                    for out_name, val in zip(node.outputs, res):
                        if out_name:
                            ev._shape_pool[out_name] = val
                            env[out_name] = val
                    continue
                static_tail = node.op in _STATIC_TAIL
                args = []
                for j, i in enumerate(node.inputs):
                    v = env[i] if i else None
                    if isinstance(v, np.ndarray) and not (static_tail
                                                          and j > 0):
                        v = _to_torch(v, device)
                    args.append(v)
                res = fn(ev, node, args)
                if not isinstance(res, tuple):
                    res = (res,)
                for out_name, val in zip(node.outputs, res):
                    if out_name:
                        env[out_name] = val
            return {n: _canon_out(env[n], device) for n in out_names}

        return apply_fn, params, graph_inputs, out_names


def _device_of(inputs: Dict[str, Any], params: Dict[str, Any]):
    for tree in (inputs, params):
        for v in tree.values():
            if isinstance(v, dict):
                v = next(iter(v.values()))
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cpu")


_CANON_OUT = {torch.int64: torch.int32, torch.float64: torch.float32}


def _canon_out(v, device) -> torch.Tensor:
    """A graph output as JAX returns it without x64 (int64 -> int32,
    float64 -> float32); a host-folded output as a tensor on ``device``."""
    if isinstance(v, np.ndarray):
        v = _to_torch(v, device)
    return v.to(_CANON_OUT[v.dtype]) if v.dtype in _CANON_OUT else v


def _weight_names(graph: OnnxGraph) -> set:
    """Initializer names whose EVERY use is the weight slot (input 1) of
    Conv/MatMul/Gemm — the only params safe to store quantized (any other
    consumer, e.g. a Reshape, would receive the {w_int8, scale} dict)."""
    eligible: Dict[str, bool] = {}
    for node in graph.nodes:
        for i, name in enumerate(node.inputs):
            if name in graph.initializers:
                ok = (i == 1 and node.op in ("Conv", "MatMul", "Gemm"))
                eligible[name] = eligible.get(name, True) and ok
    return {n for n, ok in eligible.items() if ok}


def quantize_onnx_weights(params: Dict[str, np.ndarray], names: set,
                          min_size: int = 1024) -> Dict[str, Any]:
    """Weight-only INT8 for imported graphs (tpulab's numpy code): eligible
    float32 weights >= min_size become {w_int8, scale} — per-output-channel
    scales for 4-D OIHW conv kernels, per-tensor for 2-D.  The consuming
    op dequantizes (:func:`_wval`)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if (k in names and isinstance(v, np.ndarray)
                and v.dtype == np.float32 and v.ndim in (2, 4)
                and v.size >= min_size):
            amax = (np.abs(v).max(axis=(1, 2, 3), keepdims=True)
                    if v.ndim == 4 else np.abs(v).max())
            scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            out[k] = {"w_int8": np.clip(np.round(v / scale), -127, 127
                                        ).astype(np.int8),
                      "scale": scale}
        else:
            out[k] = v
    return out


def _wval(w):
    """Weight slot: dequantize a {w_int8, scale} entry in f32."""
    if isinstance(w, dict) and "w_int8" in w:
        return w["w_int8"].to(torch.float32) * w["scale"]
    return w


# op implementations -- each: (conv: _Eval, node, args) -> tensor | tuple
_OPS: Dict[str, Callable] = {}

#: evaluator-special-cased ops (not in _OPS): Shape seeds the shape pool,
#: Constant prefolds.  supported_ops() is the public "can I import this"
#: answer.
_EVALUATOR_SPECIAL = frozenset({"Shape", "Constant"})

#: ops that read every input after the first as a static (host) value
_STATIC_TAIL = frozenset({
    "Reshape", "Pad", "Slice", "Expand", "Tile", "Resize", "Upsample",
    "Clip", "ReduceMean", "ReduceSum", "ReduceMax", "Squeeze",
    "Unsqueeze", "Split"})


def supported_ops() -> frozenset:
    return frozenset(_OPS) | _EVALUATOR_SPECIAL


def _op(name: str):
    def deco(fn):
        _OPS[name] = fn
        return fn
    return deco


def _auto_pad(node: OnnxNode) -> str:
    auto = node.attrs.get("auto_pad")
    auto = auto.decode() if isinstance(auto, bytes) else auto
    return auto or "NOTSET"


def _same_pairs(sizes, ks, strides, dils) -> List[Tuple[int, int]]:
    """JAX's ``padding="SAME"`` per spatial dim (the effective kernel of a
    dilated window): low = total // 2, the odd pixel high."""
    out = []
    for n, k, s, d in zip(sizes, ks, strides, dils):
        eff = (k - 1) * d + 1
        total = max((-(-n // s) - 1) * s + eff - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _conv_padding(node: OnnxNode, nd: int):
    auto = _auto_pad(node)
    if auto in ("NOTSET", ""):
        return _pair_pads(node.attrs.get("pads", [0] * 2 * nd), nd)
    if auto == "VALID":
        return [(0, 0)] * nd
    if auto == "SAME_UPPER":
        return "SAME"
    raise NotImplementedError(f"auto_pad={auto}")


def _flat_pads(pairs: Sequence[Tuple[int, int]]) -> List[int]:
    """[(b, e)] per leading-to-trailing dim -> ``F.pad``'s last-dim-first
    flat list."""
    out: List[int] = []
    for b, e in reversed(pairs):
        out += [b, e]
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@_op("Conv")
def _conv(conv, node, args):
    x, w = args[0], _wval(args[1])
    nd = x.ndim - 2
    strides = [int(s) for s in node.attrs.get("strides", [1] * nd)]
    dils = [int(d) for d in node.attrs.get("dilations", [1] * nd)]
    pads = _conv_padding(node, nd)
    if pads == "SAME":
        pads = _same_pairs(x.shape[2:], w.shape[2:], strides, dils)
    if any(b != e for b, e in pads):
        x = F.pad(x, _flat_pads(pads))
        pads = [(0, 0)] * nd
    out = _CONV[nd](x, w, stride=strides, padding=[b for b, _ in pads],
                    dilation=dils, groups=int(node.attrs.get("group", 1)))
    if len(args) > 2 and args[2] is not None:
        out = out + args[2].reshape((1, -1) + (1,) * nd)
    return out


@_op("Relu")
def _relu(conv, node, args):
    return torch.relu(args[0])


@_op("Sigmoid")
def _sigmoid(conv, node, args):
    return torch.sigmoid(args[0])


@_op("Tanh")
def _tanh(conv, node, args):
    return torch.tanh(args[0])


@_op("LeakyRelu")
def _leaky(conv, node, args):
    return F.leaky_relu(args[0], node.attrs.get("alpha", 0.01))


@_op("Clip")
def _clip(conv, node, args):
    lo = node.attrs.get("min")
    hi = node.attrs.get("max")
    if len(args) > 1 and args[1] is not None:   # opset 11+: min/max inputs
        lo = conv._static_val(conv_input_name(node, 1))
    if len(args) > 2 and args[2] is not None:
        hi = conv._static_val(conv_input_name(node, 2))
    if lo is None and hi is None:
        return args[0]

    def bound(v):
        if v is None:
            return None
        v = np.asarray(v, np.float32)
        return (float(v.reshape(())) if v.size == 1
                else _to_torch(v, args[0].device))
    return torch.clamp(args[0], bound(lo), bound(hi))


def conv_input_name(node: OnnxNode, i: int) -> str:
    return node.inputs[i]


def _window_sum(x, ks, strides):
    """Sum over each (unpadded) window: ``avg_pool`` with divisor 1."""
    nd = len(ks)
    if nd == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1, ks[0]), (1, strides[0]),
                            divisor_override=1).squeeze(-2)
    return (F.avg_pool2d if nd == 2 else F.avg_pool3d)(
        x, ks, strides, divisor_override=1)


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _pool(conv, node, args, is_avg: bool):
    x = args[0]
    nd = x.ndim - 2
    if int(node.attrs.get("ceil_mode", 0)):
        raise NotImplementedError("ceil_mode pooling")
    ks = [int(k) for k in node.attrs["kernel_shape"]]
    strides = [int(s) for s in node.attrs.get("strides", [1] * nd)]
    pads = _conv_padding(node, nd)
    if pads == "SAME":
        pads = _same_pairs(x.shape[2:], ks, strides, [1] * nd)
    flat = _flat_pads(pads)
    if not is_avg:
        return _MAXPOOL[nd](F.pad(x, flat, value=-math.inf), ks, strides)
    s = _window_sum(F.pad(x.to(torch.float32), flat), ks, strides)
    if int(node.attrs.get("count_include_pad", 0)):
        return (s / float(math.prod(ks))).to(x.dtype)
    # count_include_pad=0 (the default): edge windows divide by the
    # number of UNPADDED elements — counted with a ones window sum
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=torch.float32,
                      device=x.device)
    counts = _window_sum(F.pad(ones, flat), ks, strides)
    return (s / counts).to(x.dtype)


@_op("MaxPool")
def _maxpool(conv, node, args):
    return _pool(conv, node, args, False)


@_op("AveragePool")
def _avgpool(conv, node, args):
    return _pool(conv, node, args, True)


@_op("GlobalAveragePool")
def _gap(conv, node, args):
    x = args[0]
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


@_op("GlobalMaxPool")
def _gmp(conv, node, args):
    x = args[0]
    return torch.amax(x, dim=tuple(range(2, x.ndim)), keepdim=True)


@_op("BatchNormalization")
def _bn(conv, node, args):
    x, scale, bias, mean, var = args[:5]
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = scale / torch.sqrt(var + eps)
    return x * inv.reshape(shape) + (bias - mean * inv).reshape(shape)


def _true_divide(a, b):
    """``jnp.divide``: true division, whatever the operands' dtypes."""
    return torch.true_divide(a, b)


for _name, _fn in (("Add", torch.add), ("Sub", torch.sub),
                   ("Mul", torch.mul), ("Div", _true_divide),
                   ("Pow", torch.pow)):
    def _binop(conv, node, args, _fn=_fn):
        return _fn(args[0], args[1])
    _OPS[_name] = _binop


@_op("Sum")
def _sum(conv, node, args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@_op("MatMul")
def _matmul(conv, node, args):
    return torch.matmul(args[0], _wval(args[1]))


@_op("Gemm")
def _gemm(conv, node, args):
    a, b = args[0], _wval(args[1])
    if int(node.attrs.get("transA", 0)):
        a = a.T
    if int(node.attrs.get("transB", 0)):
        b = b.T
    out = node.attrs.get("alpha", 1.0) * (a @ b)
    if len(args) > 2 and args[2] is not None:
        out = out + node.attrs.get("beta", 1.0) * args[2]
    return out


@_op("Reshape")
def _reshape(conv, node, args):
    x = args[0]
    if len(node.inputs) > 1:                      # opset 5+: shape input
        target = [int(d) for d in conv._static_val(node.inputs[1])]
    else:
        target = [int(d) for d in node.attrs["shape"]]
    # ONNX 0 = copy input dim (allowzero=0 default)
    target = [int(x.shape[i]) if d == 0 else d for i, d in enumerate(target)]
    # batch-bucket serving: a fixed leading dim baked at export batch (the
    # zoo exports at N=1) re-binds to the runtime batch.  Without -1 the
    # rebind happens when that is the only way the element counts
    # reconcile; with -1 any leading dim "reconciles" (the -1 absorbs
    # the difference, silently merging batch rows), so rebind exactly
    # the baked-N=1 idiom ([1, ...] at runtime batch > 1) and leave
    # genuine flatten targets ([-1, F]) untouched
    if -1 in target:
        if target[0] == 1 and x.shape[0] != 1:
            target = [int(x.shape[0])] + target[1:]
    elif math.prod(target) != math.prod(x.shape):
        rebind = [int(x.shape[0])] + target[1:]
        if math.prod(rebind) == math.prod(x.shape):
            target = rebind
        else:
            raise ValueError(f"Reshape {node.name!r}: {tuple(x.shape)} -> "
                             f"{target}")
    return x.reshape(target)


@_op("Flatten")
def _flatten(conv, node, args):
    x = args[0]
    ax = int(node.attrs.get("axis", 1))
    return x.reshape((int(math.prod(x.shape[:ax])), -1))


def _softmax_like(conv, node, args, fn):
    x = args[0]
    if conv.opset >= 13:
        return fn(x, int(node.attrs.get("axis", -1)))
    # opset <13: coerce to 2D at `axis`, normalize the trailing block
    ax = int(node.attrs.get("axis", 1))
    two_d = x.reshape((int(math.prod(x.shape[:ax])), -1))
    return fn(two_d, 1).reshape(x.shape)


@_op("Softmax")
def _softmax(conv, node, args):
    return _softmax_like(conv, node, args, torch.softmax)


@_op("Concat")
def _concat(conv, node, args):
    return torch.cat(args, dim=int(node.attrs["axis"]))


@_op("Transpose")
def _transpose(conv, node, args):
    x = args[0]
    perm = node.attrs.get("perm")
    return x.permute(*(perm if perm is not None
                       else range(x.ndim - 1, -1, -1)))


@_op("Identity")
def _identity(conv, node, args):
    return args[0]


@_op("Dropout")
def _dropout(conv, node, args):
    x = args[0]
    if len(node.outputs) > 1:  # inference mask output: all-true
        return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return x


def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    """A numpy dtype's torch dtype, float64 held as float32 (JAX without
    x64)."""
    np_dtype = np.float32 if np_dtype == np.float64 else np_dtype
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


@_op("Cast")
def _cast(conv, node, args):
    return args[0].to(_torch_dtype(_np_dtype(int(node.attrs["to"]),
                                             node.name)))


def _index_pad(x, pairs, mode: str):
    """``jnp.pad`` in ``reflect`` / ``edge`` mode, one gather a padded dim."""
    for d, (b, e) in enumerate(pairs):
        if not b and not e:
            continue
        n = x.shape[d]
        pos = np.arange(-b, n + e)
        if mode == "edge":
            pos = np.clip(pos, 0, n - 1)
        else:                                   # reflect: edge not repeated
            period = 2 * (n - 1)
            pos = np.abs(pos) % period if period else np.zeros_like(pos)
            pos = np.where(pos >= n, period - pos, pos)
        x = torch.index_select(x, d, _to_torch(pos.astype(np.int64),
                                               x.device))
    return x


@_op("Pad")
def _pad(conv, node, args):
    x = args[0]
    mode = node.attrs.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if len(node.inputs) > 1:                      # opset 11+: pads input
        pads = [int(p) for p in conv._static_val(node.inputs[1])]
        cval = (float(conv._static_val(node.inputs[2]).reshape(-1)[0])
                if len(node.inputs) > 2 and node.inputs[2] else 0.0)
    else:
        pads = [int(p) for p in node.attrs["pads"]]
        cval = node.attrs.get("value", 0.0)
    pairs = _pair_pads(pads, x.ndim)
    if mode == "constant":
        return F.pad(x, _flat_pads(pairs), value=cval)
    return _index_pad(x, pairs, {"reflect": "reflect", "edge": "edge"}[mode])


def _axes(conv, node, need_input: bool = True):
    """A reduction's axes: the attribute, else the static second input."""
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > 1 and (
            not need_input or node.inputs[1]):
        axes = [int(a) for a in conv._static_val(node.inputs[1])]
    return axes


def _reduce(x, fn, axes, keepdims: bool):
    dims = tuple(axes) if axes else tuple(range(x.ndim))
    return fn(x, dim=dims, keepdim=keepdims)


@_op("ReduceMean")
def _reduce_mean(conv, node, args):
    return _reduce(args[0], torch.mean, _axes(conv, node, False),
                   bool(node.attrs.get("keepdims", 1)))


@_op("Squeeze")
def _squeeze(conv, node, args):
    x = args[0]
    axes = _axes(conv, node, False)
    if not axes:
        return x.squeeze()
    return x.squeeze(tuple(a % x.ndim for a in axes))


@_op("Unsqueeze")
def _unsqueeze(conv, node, args):
    x = args[0]
    axes = _axes(conv, node, False)
    out_nd = x.ndim + len(axes)
    for a in sorted(int(a) % out_nd for a in axes):
        x = x.unsqueeze(a)
    return x


# ---- transformer-class ops (attention/MLP graphs: ViT, BERT-family) ----

for _name, _fn in (("Sqrt", torch.sqrt), ("Erf", torch.erf),
                   ("Exp", torch.exp), ("Log", torch.log),
                   ("Neg", torch.neg), ("Abs", torch.abs),
                   ("Floor", torch.floor), ("Ceil", torch.ceil)):
    def _unary(conv, node, args, _fn=_fn):
        return _fn(args[0])
    _OPS[_name] = _unary


@_op("Gelu")
def _gelu(conv, node, args):
    approx = node.attrs.get("approximate", b"none")
    approx = approx.decode() if isinstance(approx, bytes) else approx
    return F.gelu(args[0], approximate="tanh" if approx == "tanh" else "none")


@_op("LayerNormalization")
def _layernorm(conv, node, args):
    x, scale = args[0], args[1]
    eps = node.attrs.get("epsilon", 1e-5)
    axis = int(node.attrs.get("axis", -1))
    axes = tuple(range(axis if axis >= 0 else x.ndim + axis, x.ndim))
    mean = torch.mean(x, axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps) * scale
    if len(args) > 2 and args[2] is not None:
        y = y + args[2]
    return y


@_op("ReduceSum")
def _reduce_sum(conv, node, args):
    return _reduce(args[0], torch.sum, _axes(conv, node),
                   bool(node.attrs.get("keepdims", 1)))


def _slice_dim(x, d: int, sl: slice):
    """``x[..., sl, ...]`` on dim ``d``, negative steps included (a
    tensor slice takes positive steps only)."""
    if sl.step is None or sl.step > 0:
        idx = [slice(None)] * x.ndim
        idx[d] = sl
        return x[tuple(idx)]
    pos = np.arange(x.shape[d])[sl]
    return torch.index_select(x, d, _to_torch(pos.astype(np.int64),
                                              x.device))


@_op("Slice")
def _slice(conv, node, args):
    x = args[0]
    if len(node.inputs) > 1:  # opset 10+: starts/ends/axes/steps inputs
        starts = [int(v) for v in conv._static_val(node.inputs[1])]
        ends = [int(v) for v in conv._static_val(node.inputs[2])]
        axes = ([int(v) for v in conv._static_val(node.inputs[3])]
                if len(node.inputs) > 3 and node.inputs[3]
                else list(range(len(starts))))
        steps = ([int(v) for v in conv._static_val(node.inputs[4])]
                 if len(node.inputs) > 4 and node.inputs[4]
                 else [1] * len(starts))
    else:                      # opset 1: attributes
        starts = [int(v) for v in node.attrs["starts"]]
        ends = [int(v) for v in node.attrs["ends"]]
        axes = [int(v) for v in node.attrs.get(
            "axes", range(len(starts)))]
        steps = [1] * len(starts)
    for a, s, e, st in zip(axes, starts, ends, steps):
        # ONNX clamps INT_MAX/INT_MIN sentinels like python slices do
        x = _slice_dim(x, a if a >= 0 else x.ndim + a, slice(
            None if s == 0 and st > 0 else s,
            None if abs(e) >= (1 << 31) else e, st))
    return x


@_op("Gather")
def _gather(conv, node, args):
    x, idx = args[0], args[1].to(torch.int64)
    axis = int(node.attrs.get("axis", 0)) % x.ndim
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


@_op("Split")
def _split(conv, node, args):
    x = args[0]
    axis = int(node.attrs.get("axis", 0))
    sizes = node.attrs.get("split")
    if sizes is None and len(node.inputs) > 1 and node.inputs[1]:
        sizes = [int(v) for v in conv._static_val(node.inputs[1])]
    if sizes is None:
        n = len(node.outputs)
        sizes = [x.shape[axis] // n] * n
    return tuple(torch.split(x, [int(s) for s in sizes], dim=axis))


@_op("Where")
def _where(conv, node, args):
    return torch.where(args[0].to(torch.bool), args[1], args[2])


@_op("Equal")
def _equal(conv, node, args):
    return torch.eq(args[0], args[1])


# NOTE: "Shape" is special-cased in the evaluator (seeds the host-side
# shape pool), not registered here.


@_op("Expand")
def _expand(conv, node, args):
    target = [int(d) for d in conv._static_val(node.inputs[1])]
    return torch.broadcast_to(args[0], np.broadcast_shapes(
        tuple(args[0].shape), tuple(target)))


# ---- detection/segmentation-class ops (U-Net/deconv/resize idioms) ----

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@_op("ConvTranspose")
def _conv_transpose(conv, node, args):
    x, w = args[0], _wval(args[1])          # w: (Cin, Cout/groups, kH, kW)
    nd = x.ndim - 2
    if int(node.attrs.get("group", 1)) != 1:
        raise NotImplementedError("grouped ConvTranspose")
    strides = [int(s) for s in node.attrs.get("strides", [1] * nd)]
    dil = [int(d) for d in node.attrs.get("dilations", [1] * nd)]
    if "output_shape" in node.attrs:
        raise NotImplementedError("ConvTranspose output_shape")
    pads = node.attrs.get("pads")
    opad = [int(p) for p in node.attrs.get("output_padding", [0] * nd)]
    if pads is None:
        auto = _auto_pad(node)
        if auto in ("NOTSET", "", "VALID"):
            pads = [0] * (2 * nd)
        else:
            raise NotImplementedError(f"ConvTranspose auto_pad={auto}")
    pairs = _pair_pads([int(p) for p in pads], nd)
    # ONNX deconv == the gradient-style transposed conv (tpulab: a conv
    # of the stride-dilated input with the flipped kernel, padded
    # k-1-pad): the unpadded transposed conv, cropped by each edge's pad
    # and extended by output_padding at the end (zeros past the data)
    out = _CONV_T[nd](x, w, stride=strides, dilation=dil)
    out = F.pad(out, _flat_pads([(-b, opad[i] - e)
                                 for i, (b, e) in enumerate(pairs)]))
    if len(args) > 2 and args[2] is not None:
        out = out + args[2].reshape((1, -1) + (1,) * nd)
    return out


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1 - torch.abs(x), 0)


def _weight_mat(n_in: int, n_out: int, kernel) -> torch.Tensor:
    """``jax.image``'s (n_in, n_out) resampling weights at scale
    n_out / n_in, no translation (half-pixel centres; upscales only, so
    no antialias widening), in f32."""
    f32 = torch.float32
    inv_scale = 1. / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=f32)[:, None])
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resample(x: torch.Tensor, sizes: Sequence[int], method: str):
    """``jax.image.resize(x, sizes, method)`` for upscales."""
    dims = [d for d in range(x.ndim) if x.shape[d] != sizes[d]]
    if method == "nearest":
        for d in dims:
            m, n = x.shape[d], sizes[d]
            with _host():
                pos = torch.floor((torch.arange(n, dtype=torch.float32)
                                   + 0.5) * m / n).to(torch.int64).numpy()
            x = torch.index_select(x, d, _to_torch(pos, x.device))
        return x
    if not x.is_floating_point():
        x = x.to(torch.float32)
    kernel = _triangle if method == "bilinear" else _keys_cubic
    for d in dims:
        with _host():
            w = _weight_mat(x.shape[d], sizes[d], kernel).numpy()
        w = _to_torch(w, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


@_op("Resize")
@_op("Upsample")          # opset-7/9 Upsample: same semantics, scales only
def _resize(conv, node, args):
    x = args[0]
    mode = node.attrs.get("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    # jax.image.resize's half-pixel convention (tpulab's); other coordinate
    # transforms (align_corners, asymmetric) would be silently wrong, so
    # they raise like every other unsupported path here
    ct = node.attrs.get("coordinate_transformation_mode", b"half_pixel")
    ct = ct.decode() if isinstance(ct, bytes) else ct
    if ct not in ("half_pixel", "pytorch_half_pixel"):
        raise NotImplementedError(
            f"Resize coordinate_transformation_mode={ct}")
    nm = node.attrs.get("nearest_mode", b"round_prefer_floor")
    nm = nm.decode() if isinstance(nm, bytes) else nm
    if mode == "nearest" and nm not in ("round_prefer_floor", "floor"):
        raise NotImplementedError(f"Resize nearest_mode={nm}")
    sizes = scales = None
    legacy = False       # Upsample-7/9 & Resize-10: asymmetric transform
    if len(node.inputs) >= 4 and node.inputs[3]:
        # opset 11+: X, roi, scales, sizes (scales/sizes must be static)
        sizes = [int(s) for s in conv._static_val(node.inputs[3])]
    elif len(node.inputs) >= 3 and node.inputs[2]:
        sc = conv._static_val(node.inputs[2])
        if sc.size:
            scales = [float(s) for s in sc]
    elif len(node.inputs) == 2 and node.inputs[1]:
        # opset 9/10 (Upsample-9, Resize-10): X, scales
        scales = [float(s) for s in conv._static_val(node.inputs[1])]
        legacy = True
    elif "scales" in node.attrs:                  # Upsample-7 attribute
        scales = [float(s) for s in node.attrs["scales"]]
        legacy = True
    shape = [int(d) for d in x.shape]
    if sizes is None:
        if scales is None:
            raise NotImplementedError("Resize without scales/sizes")
        # spec: output dim = floor(input dim * scale)
        sizes = [int(math.floor(d * s)) for d, s in zip(shape, scales)]
    elif (sizes[0] == 1 and shape[0] != 1
          and tuple(sizes[1:2]) == tuple(shape[1:2])):
        # sizes-form exports bake the N=1 batch like Reshape targets do:
        # rebind to the bucket so one import serves every bucket
        sizes = [shape[0]] + sizes[1:]
    if tuple(sizes[:2]) != tuple(shape[:2]):
        raise NotImplementedError("Resize over batch/channel dims")
    if any(o < i for o, i in zip(sizes[2:], shape[2:])):
        raise NotImplementedError("Resize downscale (antialias semantics "
                                  "differ from the ONNX default)")
    integer_up = all(o % i == 0 for o, i in zip(sizes[2:], shape[2:]))
    if legacy:
        # asymmetric coordinate transform: equals the half-pixel result
        # only for nearest at integer scale factors
        if mode != "nearest" or not integer_up:
            raise NotImplementedError(
                "legacy Upsample/Resize-10 (asymmetric transform) is "
                "supported only for nearest at integer scale factors")
    elif mode == "nearest" and not integer_up:
        raise NotImplementedError(
            "nearest Resize at non-integer scale factors")
    method = {"nearest": "nearest", "linear": "bilinear",
              "cubic": "bicubic"}.get(mode)
    if method is None:
        raise NotImplementedError(f"Resize mode={mode}")
    return _resample(x, sizes, method)


@_op("InstanceNormalization")
def _instance_norm(conv, node, args):
    x, scale, bias = args[0], args[1], args[2]
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mean = torch.mean(x, axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean) / torch.sqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape))


@_op("PRelu")
def _prelu(conv, node, args):
    x, slope = args[0], args[1]
    if slope.ndim == 1 and x.ndim > 2:   # per-channel: broadcast on C
        slope = slope.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x > 0, x, x * slope)


@_op("HardSigmoid")
def _hard_sigmoid(conv, node, args):
    a = node.attrs.get("alpha", 0.2)
    b = node.attrs.get("beta", 0.5)
    return torch.clamp(a * args[0] + b, 0.0, 1.0)


@_op("LogSoftmax")
def _log_softmax(conv, node, args):
    return _softmax_like(conv, node, args, torch.log_softmax)


@_op("ReduceMax")
def _reduce_max(conv, node, args):
    return _reduce(args[0], torch.amax, _axes(conv, node),
                   bool(node.attrs.get("keepdims", 1)))


@_op("ArgMax")
def _argmax(conv, node, args):
    if int(node.attrs.get("select_last_index", 0)):
        raise NotImplementedError("ArgMax select_last_index")
    axis = int(node.attrs.get("axis", 0))
    out = torch.argmax(args[0], dim=axis)
    if int(node.attrs.get("keepdims", 1)):
        out = out.unsqueeze(axis)
    return out


@_op("Tile")
def _tile(conv, node, args):
    reps = [int(r) for r in conv._static_val(node.inputs[1])]
    return torch.tile(args[0], reps)


@_op("Min")
def _min(conv, node, args):
    out = args[0]
    for a in args[1:]:
        out = torch.minimum(out, a)
    return out


@_op("Max")
def _max(conv, node, args):
    out = args[0]
    for a in args[1:]:
        out = torch.maximum(out, a)
    return out


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------


def parse_onnx(path: str,
               collect_external: Optional[list] = None) -> OnnxModel:
    """Parse a model file.  ``collect_external`` switches to preflight
    mode: external sidecars are inventoried, not read (see
    :func:`_decode_tensor`)."""
    with open(path, "rb") as f:
        return OnnxModel(f.read(), os.path.dirname(os.path.abspath(path)),
                         collect_external)


def _tree_to_torch(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    return {k: (_tree_to_torch(v, device) if isinstance(v, dict)
                else _to_torch(v, device)) for k, v in tree.items()}


def load_onnx_model(path: str, name: Optional[str] = None,
                    max_batch_size: int = 8,
                    batch_buckets: Optional[Sequence[int]] = None,
                    weight_quant: Optional[str] = None, device=None):
    """``model.onnx`` -> servable :class:`~tpulab_torch.engine.model.Model`
    with its params on ``device`` (``None`` = the CUDA card).

    The ONNX graph's leading input dim is the batch axis (symbolic or the
    zoo's exported N=1); IOSpecs strip it and the engine serves each
    bucket with it.  ``weight_quant="int8"`` stores eligible conv/matmul
    weights as {w_int8, scale}, dequantized in the consuming op.
    """
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.model import IOSpec, Model

    dev = resolve_device(device)
    om = parse_onnx(path)
    apply_fn, params, in_names, out_names = _Converter(om).build()
    if weight_quant is not None:
        if weight_quant != "int8":
            raise ValueError(f"unknown weight_quant {weight_quant!r}")
        params = quantize_onnx_weights(params, _weight_names(om.graph))

    in_specs = []
    info = {n: (dt, dims) for n, dt, dims in om.graph.inputs}
    for n in in_names:
        dt, dims = info[n]
        if len(dims) < 1:
            raise ValueError(f"input {n!r} has no shape")
        if any(d is None for d in dims[1:]):
            raise NotImplementedError(
                f"input {n!r} has symbolic non-batch dims {dims}: the "
                "engine serves static shapes (pick a size and re-export)")
        in_specs.append(IOSpec(n, tuple(int(d) for d in dims[1:]),
                               dt or np.float32))

    # one batch-1 forward on the CPU discovers the output shapes
    host = _tree_to_torch(params)
    sample = {s.name: torch.zeros((1, *s.shape),
                                  dtype=_torch_dtype(s.np_dtype))
              for s in in_specs}
    with torch.inference_mode():
        outs = apply_fn(host, sample)
    out_specs = [IOSpec(n, tuple(int(d) for d in outs[n].shape[1:]),
                        outs[n].numpy().dtype) for n in out_names]

    return Model(name or om.graph.name or "onnx", apply_fn,
                 _tree_to_torch(params, dev), in_specs, out_specs,
                 max_batch_size=max_batch_size, batch_buckets=batch_buckets)
