"""A protobuf wire-format encoder for ONNX graphs, and the ResNet-50 graph
built with it: the bytes that ``tests/test_torch_onnx_import.py`` hands
to both packages' importers and that ``chip_smoke.py`` imports on the
card.  It imports numpy and nothing else (no ``onnx`` package), and
encodes independently of either decoder, so a field-number mistake on
either side fails loudly.
"""

import struct

import numpy as np

# TensorProto.DataType codes of the dtypes the encoder writes
DTYPE_CODES = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
               np.dtype(np.int8): 3, np.dtype(np.int32): 6,
               np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
               np.dtype(np.float16): 10, np.dtype(np.float64): 11}

STAGE_SIZES_50 = (3, 4, 6, 3)


def vi(x: int) -> bytes:
    """A varint (negatives as 64-bit two's complement, the proto rule)."""
    x &= (1 << 64) - 1
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def ld(fno: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return vi((fno << 3) | 2) + vi(len(payload)) + payload


def vint(fno: int, v: int) -> bytes:
    """A varint field."""
    return vi(fno << 3) + vi(v)


def tensor(name: str, arr: np.ndarray) -> bytes:
    """A TensorProto with ``raw_data``."""
    arr = np.ascontiguousarray(arr)
    out = b"".join(vint(1, d) for d in arr.shape)
    out += vint(2, DTYPE_CODES[arr.dtype]) + ld(8, name.encode())
    return out + ld(9, arr.tobytes())


def attr(name: str, val) -> bytes:
    """An AttributeProto: float, int, bytes, a tensor (numpy array), a
    list of ints or a tuple of floats."""
    out = ld(1, name.encode())
    if isinstance(val, np.ndarray):
        out += ld(5, tensor("", val))
    elif isinstance(val, tuple):
        out += ld(7, struct.pack(f"<{len(val)}f", *val))
    elif isinstance(val, float):
        out += vi((2 << 3) | 5) + struct.pack("<f", val)
    elif isinstance(val, int):
        out += vint(3, val)
    elif isinstance(val, bytes):
        out += ld(4, val)
    elif isinstance(val, list):
        out += b"".join(vint(8, v) for v in val)
    else:
        raise TypeError(val)
    return out


def node(op: str, ins, outs, **attrs) -> bytes:
    """A NodeProto."""
    out = b"".join(ld(1, i.encode()) for i in ins)
    out += b"".join(ld(2, o.encode()) for o in outs)
    out += ld(4, op.encode())
    return out + b"".join(ld(5, attr(k, v)) for k, v in attrs.items())


def value_info(name: str, dims, elem_type: int = 1) -> bytes:
    """A ValueInfoProto of a tensor (f32 unless ``elem_type``)."""
    shape = b"".join(ld(1, vint(1, d)) for d in dims)
    tensor_type = vint(1, elem_type) + ld(2, shape)
    return ld(1, name.encode()) + ld(2, ld(1, tensor_type))


def model_bytes(nodes, inits, inputs, outputs, opset: int = 13) -> bytes:
    """A ModelProto (IR 7) of one graph; ``inputs`` / ``outputs`` are
    ``(name, dims)`` or ``(name, dims, elem_type)``."""
    g = b"".join(ld(1, n) for n in nodes)
    g += ld(2, b"testgraph")
    g += b"".join(ld(5, tensor(n, a)) for n, a in inits.items())
    g += b"".join(ld(11, value_info(*i)) for i in inputs)
    g += b"".join(ld(12, value_info(*o)) for o in outputs)
    return vint(1, 7) + ld(7, g) + ld(8, ld(1, b"") + vint(2, opset))


def resnet50_graph(seed: int, classes: int, img: int):
    """ResNet-50 v1.5 as an exporter writes it (53 Conv + BatchNormalization
    units, every conv ``auto_pad=SAME_UPPER``, the 3x3/2 max pool padded
    (1, 1), residual Adds, GlobalAveragePool -> Flatten -> Gemm) over
    seeded f32 weights.  Returns ``(bytes, folded)``: ``folded`` is the
    native tree of the same weights with each BatchNormalization folded
    in f32 numpy (HWIO kernels, ``scale = gamma / sqrt(var + 1e-5)``,
    ``bias = beta - mean * scale``), as numpy arrays."""
    rng = np.random.default_rng(seed)
    nodes, inits = [], {}

    def conv_bn(x_name, name, cin, cout, k, stride, relu):
        w = (rng.standard_normal((cout, cin, k, k), np.float32)
             * np.float32(np.sqrt(2.0 / (cin * k * k))))
        gamma = (0.5 + rng.random(cout, np.float32)).astype(np.float32)
        beta = rng.standard_normal(cout, np.float32)
        mean = rng.standard_normal(cout, np.float32)
        var = (0.5 + rng.random(cout, np.float32)).astype(np.float32)
        inits.update({f"{name}_w": w, f"{name}_g": gamma, f"{name}_b": beta,
                      f"{name}_m": mean, f"{name}_v": var})
        nodes.append(node("Conv", [x_name, f"{name}_w"], [f"{name}_c"],
                          kernel_shape=[k, k], strides=[stride, stride],
                          auto_pad=b"SAME_UPPER"))
        nodes.append(node("BatchNormalization",
                          [f"{name}_c", f"{name}_g", f"{name}_b",
                           f"{name}_m", f"{name}_v"],
                          [f"{name}_bn"], epsilon=1e-5))
        out = f"{name}_bn"
        if relu:
            nodes.append(node("Relu", [out], [f"{name}_r"]))
            out = f"{name}_r"
        inv = gamma / np.sqrt(var + np.float32(1e-5))
        return out, {"kernel": np.transpose(w, (2, 3, 1, 0)).copy(),
                     "scale": inv, "bias": beta - mean * inv}

    params = {}
    x, params["stem"] = conv_bn("input", "stem", 3, 64, 7, 2, True)
    nodes.append(node("MaxPool", [x], ["pool0"], kernel_shape=[3, 3],
                      strides=[2, 2], pads=[1, 1, 1, 1]))
    x, cin = "pool0", 64
    for stage, blocks in enumerate(STAGE_SIZES_50):
        cmid = 64 * (2 ** stage)
        cout = cmid * 4
        for block in range(blocks):
            stride = 2 if (block == 0 and stage > 0) else 1
            nm = f"s{stage}b{block}"
            y, p1 = conv_bn(x, f"{nm}c1", cin, cmid, 1, 1, True)
            y, p2 = conv_bn(y, f"{nm}c2", cmid, cmid, 3, stride, True)
            y, p3 = conv_bn(y, f"{nm}c3", cmid, cout, 1, 1, False)
            p = {"conv1": p1, "conv2": p2, "conv3": p3}
            res = x
            if stride != 1 or cin != cout:
                res, p["proj"] = conv_bn(x, f"{nm}pj", cin, cout, 1,
                                         stride, False)
            nodes.append(node("Add", [y, res], [f"{nm}_sum"]))
            nodes.append(node("Relu", [f"{nm}_sum"], [f"{nm}_out"]))
            x = f"{nm}_out"
            params[nm] = p
            cin = cout
    nodes.append(node("GlobalAveragePool", [x], ["gap"]))
    nodes.append(node("Flatten", ["gap"], ["flat"], axis=1))
    wfc = rng.standard_normal((classes, cin), np.float32) * np.float32(0.01)
    bfc = rng.standard_normal(classes, np.float32)
    inits.update({"wfc": wfc, "bfc": bfc})
    nodes.append(node("Gemm", ["flat", "wfc", "bfc"], ["logits"], transB=1))
    params["fc"] = {"kernel": wfc.T.copy(), "bias": bfc}
    data = model_bytes(nodes, inits, [("input", [1, 3, img, img])],
                       [("logits", [1, classes])])
    return data, params
