"""The port's ONNX import held against tpulab's on the CPU (the port of
``tests/test_onnx_import.py``, every case that needs no model-zoo file).

The same bytes (``tests/torch_onnx_util.py``'s encoder) go through both
packages' importers:

- the reader: the same graphs, initializers and attributes, the same
  arrays from external data, the same errors for malformed bytes and
  unsupported dtypes;
- the evaluator: every op of ``supported_ops()`` on seeded inputs
  against tpulab's output, within 1e-4 (f32 single ops and blocks: the
  two backends sum in different orders), exactly where the op is exact
  (integer and index outputs, shape ops, pure data movement); the
  synthesized ResNet block, U-Net block and transformer encoder block;
  the full ResNet-50 topology at 64x64 against tpulab's import and the
  port's native ``make_resnet`` on the folded weights within 2e-3;
- ``weight_quant="int8"``: the same eligible names and int8 / scale
  values bit for bit;
- a graph exported at N=1 served through the port's ``InferenceManager``
  at a batch the export never saw, equal to tpulab's manager.
"""

import struct

import numpy as np
import pytest
import torch

import torch_onnx_util as ou
from tpulab.models import onnx_import as jx
from tpulab.models import build_model as jax_build
from tpulab_torch.models import build_model
from tpulab_torch.models import onnx_import as tx

torch.set_num_threads(2)

TOL = 1e-4          # f32 single ops and blocks
RESNET_TOL = 2e-3   # ResNet-50 depth at 64x64 (tpulab's own tolerance)


def _write(tmp_path, name, nodes, inits, inputs, outputs, opset=13):
    p = tmp_path / f"{name}.onnx"
    p.write_bytes(ou.model_bytes(nodes, inits, inputs, outputs, opset))
    return str(p)


def _pair(path, **kw):
    """(the port's model on the CPU, tpulab's model) of one file."""
    return (tx.load_onnx_model(path, device="cpu", **kw),
            jx.load_onnx_model(path, **kw))


def _run(pair, feeds):
    """Both models' outputs on the same numpy feeds, as numpy."""
    pm, jm = pair
    got = pm.apply_fn(pm.params, {k: torch.from_numpy(np.array(v))
                                  for k, v in feeds.items()})
    want = jm.apply_fn(jm.params, feeds)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _close(got, want, tol=TOL, exact=False):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, (k, got[k].shape,
                                               want[k].shape)
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype,
                                               want[k].dtype)
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=k)


def _specs(specs):
    return [(s.name, tuple(s.shape), np.dtype(s.dtype)) for s in specs]


def _same_specs(pair):
    for kind in ("inputs", "outputs"):
        assert _specs(getattr(pair[0], kind)) == _specs(getattr(pair[1],
                                                                 kind))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------- the reader
def test_supported_ops_are_tpulabs():
    assert tx.supported_ops() == jx.supported_ops()
    assert len(tx.supported_ops()) == 62


def _same_model(a, b):
    assert (a.ir_version, a.producer, a.opset) == (b.ir_version, b.producer,
                                                   b.opset)
    ga, gb = a.graph, b.graph
    assert ga.name == gb.name
    assert ga.inputs == gb.inputs and ga.outputs == gb.outputs
    assert ([(n.op, n.name, n.inputs, n.outputs) for n in ga.nodes]
            == [(n.op, n.name, n.inputs, n.outputs) for n in gb.nodes])
    for na, nb in zip(ga.nodes, gb.nodes):
        assert set(na.attrs) == set(nb.attrs)
        for k in na.attrs:
            va, vb = na.attrs[k], nb.attrs[k]
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb
    assert set(ga.initializers) == set(gb.initializers)
    for k, v in ga.initializers.items():
        assert v.dtype == gb.initializers[k].dtype
        np.testing.assert_array_equal(v, gb.initializers[k])


def test_reader_gives_tpulabs_structures(resnet_block_onnx):
    path, _ = resnet_block_onnx
    a, b = tx.parse_onnx(path), jx.parse_onnx(path)
    _same_model(a, b)
    assert a.opset == 13
    assert [n.op for n in a.graph.nodes][:2] == ["Conv",
                                                 "BatchNormalization"]


def _outcome(cls, data):
    try:
        return "ok", cls(data)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e), str(e)


def test_parser_rejects_malformed_bytes_as_tpulab():
    """Every truncation of a valid model, random garbage and an
    unterminated varint: the port raises what tpulab raises (type and
    message) or parses to the same structures."""
    rng = np.random.default_rng(0)
    data = ou.model_bytes([ou.node("Relu", ["x"], ["y"])], {},
                          [("x", [1, 4])], [("y", [1, 4])])
    blobs = [data[:cut] for cut in range(0, len(data), 3)] + [data]
    blobs += [rng.integers(0, 256, rng.integers(1, 200)).astype(
        np.uint8).tobytes() for _ in range(50)]
    blobs.append(b"\x08" + b"\xff" * 100)
    for blob in blobs:
        got = _outcome(tx.OnnxModel, blob)
        want = _outcome(jx.OnnxModel, blob)
        if want[0] == "ok":
            assert got[0] == "ok", got
            _same_model(got[1], want[1])
        else:
            assert got == want


def test_unsupported_dtype_reports_code_and_tensor():
    buf = (ou.vint(1, 2) + ou.vint(2, 16)            # dims=[2], BFLOAT16
           + ou.ld(8, b"w_bf16") + ou.ld(9, b"\x00" * 4))
    for mod in (tx, jx):
        with pytest.raises(NotImplementedError,
                           match=r"code 16 \[BFLOAT16\] \(tensor 'w_bf16'\)"):
            mod._decode_tensor(buf)


@pytest.mark.parametrize("dtype", ["float32", "float16", "float64", "int8",
                                   "uint8", "int32", "int64", "bool"])
def test_decode_tensor_raw_data_as_tpulab(dtype):
    arr = np.random.default_rng(1).standard_normal((3, 4)) * 50
    arr = arr.astype(dtype)
    buf = ou.tensor("t", arr)
    (na, a), (nb, b) = tx._decode_tensor(buf), jx._decode_tensor(buf)
    assert na == nb == "t" and a.dtype == b.dtype == arr.dtype
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, arr)


@pytest.mark.parametrize("field", ["float_data", "int64_data", "int32_data",
                                   "double_data", "uint64_data"])
def test_decode_tensor_typed_fields_as_tpulab(field):
    """The typed repeated fields (packed), negatives included."""
    vals = [3, -7, 0, 12]
    code, fno, payload = {
        "float_data": (1, 4, struct.pack("<4f", *vals)),
        "int64_data": (7, 7, b"".join(ou.vi(v) for v in vals)),
        "int32_data": (6, 5, b"".join(ou.vi(v) for v in vals)),
        "double_data": (11, 10, struct.pack("<4d", *vals)),
        "uint64_data": (13, 11, b"".join(ou.vi(abs(v)) for v in vals)),
    }[field]
    buf = (ou.vint(1, 4) + ou.vint(2, code) + ou.ld(8, b"t")
           + ou.ld(fno, payload))
    a, b = tx._decode_tensor(buf)[1], jx._decode_tensor(buf)[1]
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_external_data_tensors(tmp_path):
    """data_location=EXTERNAL initializers load from the sidecar at
    offset/length in both packages; escaping locations are refused with
    the same error; the preflight mode inventories without reading."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    pad, payload = b"\x7f" * 16, w.tobytes()
    (tmp_path / "weights.bin").write_bytes(pad + payload)
    (tmp_path / "..weights.bin").write_bytes(pad + payload)

    def ext_tensor(name, location):
        def entry(k, v):
            return ou.ld(1, k.encode()) + ou.ld(2, v.encode())
        out = b"".join(ou.vint(1, d) for d in w.shape)
        out += ou.vint(2, 1) + ou.ld(8, name.encode())
        out += ou.ld(13, entry("location", location))
        out += ou.ld(13, entry("offset", str(len(pad))))
        out += ou.ld(13, entry("length", str(len(payload))))
        return out + ou.vint(14, 1)

    def model_with(location):
        g = ou.ld(1, ou.node("Identity", ["w"], ["y"]))
        g += ou.ld(5, ext_tensor("w", location))
        g += ou.ld(12, ou.value_info("y", [3, 4]))
        return (ou.vint(1, 7) + ou.ld(7, g)
                + ou.ld(8, ou.ld(1, b"") + ou.vint(2, 13)))

    for loc in ("weights.bin", "..weights.bin"):
        p = tmp_path / "ext.onnx"
        p.write_bytes(model_with(loc))
        pm, jm = _pair(str(p), max_batch_size=1)
        np.testing.assert_array_equal(pm.params["w"].numpy(), w)
        got, want = _run((pm, jm), {})
        _close(got, want, exact=True)
    p2 = tmp_path / "evil.onnx"
    p2.write_bytes(model_with("../weights.bin"))
    for mod in (tx, jx):
        with pytest.raises(ValueError, match="escapes"):
            mod.parse_onnx(str(p2))
        with pytest.raises(ValueError, match="externally"):
            mod.OnnxModel(model_with("weights.bin"))
    sidecars = []
    om = tx.parse_onnx(str(tmp_path / "ext.onnx"),
                       collect_external=sidecars)
    assert [e["location"] for e in sidecars] == ["..weights.bin"]
    assert om.graph.initializers["w"].shape == w.shape
    assert not om.graph.initializers["w"].any()


# ------------------------------------------------------- synthetic graphs
@pytest.fixture(scope="module")
def resnet_block_onnx(tmp_path_factory):
    """Conv(+bias,pads) -> BN -> Relu -> MaxPool -> 1x1 Conv -> residual
    Add -> GlobalAveragePool -> Flatten -> Gemm(transB) -> Softmax."""
    rng = np.random.default_rng(7)
    inits = {
        "w1": _f32(rng, 4, 3, 3, 3), "b1": _f32(rng, 4),
        "bn_s": np.abs(_f32(rng, 4)) + 0.5, "bn_b": _f32(rng, 4),
        "bn_m": _f32(rng, 4), "bn_v": np.abs(_f32(rng, 4)) + 0.5,
        "w2": _f32(rng, 4, 4, 1, 1),
        "wfc": _f32(rng, 5, 4), "bfc": _f32(rng, 5),
    }
    nodes = [
        ou.node("Conv", ["x", "w1", "b1"], ["c1"], kernel_shape=[3, 3],
                strides=[1, 1], pads=[1, 1, 1, 1]),
        ou.node("BatchNormalization", ["c1", "bn_s", "bn_b", "bn_m", "bn_v"],
                ["n1"], epsilon=1e-5),
        ou.node("Relu", ["n1"], ["r1"]),
        ou.node("MaxPool", ["r1"], ["p1"], kernel_shape=[2, 2],
                strides=[2, 2]),
        ou.node("Conv", ["p1", "w2"], ["c2"], kernel_shape=[1, 1]),
        ou.node("Add", ["c2", "p1"], ["res"]),
        ou.node("GlobalAveragePool", ["res"], ["gap"]),
        ou.node("Flatten", ["gap"], ["flat"], axis=1),
        ou.node("Gemm", ["flat", "wfc", "bfc"], ["fc"], transB=1),
        ou.node("Softmax", ["fc"], ["probs"], axis=-1),
    ]
    path = tmp_path_factory.mktemp("onnx") / "block.onnx"
    path.write_bytes(ou.model_bytes(nodes, inits, [("x", [1, 3, 8, 8])],
                                    [("probs", [1, 5])]))
    return str(path), inits


@pytest.mark.parametrize("batch", [1, 3])
def test_synthetic_resnet_block(resnet_block_onnx, batch):
    path, _ = resnet_block_onnx
    pair = _pair(path, max_batch_size=4)
    _same_specs(pair)
    x = np.random.default_rng(3 + batch).standard_normal(
        (batch, 3, 8, 8)).astype(np.float32)
    got, want = _run(pair, {"x": x})
    _close(got, want)
    np.testing.assert_allclose(got["probs"].sum(-1), 1.0, rtol=1e-5)


def test_registry_onnx_entry(resnet_block_onnx):
    path, _ = resnet_block_onnx
    for build in (build_model, jax_build):
        with pytest.raises(ValueError, match="requires path="):
            build("onnx")
    pm = build_model("onnx", path=path, max_batch_size=2, device="cpu")
    jm = jax_build("onnx", path=path, max_batch_size=2)
    assert (pm.name, pm.batch_buckets) == (jm.name, jm.batch_buckets)
    x = np.random.default_rng(2).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    _close(*_run((pm, jm), {"x": x}))


def test_reshape_batch_rebind_variants(tmp_path):
    """Baked export-batch leading dims rebind to the runtime batch in both
    reshape idioms ([1, F] and [1, -1]) while a genuine flatten target
    [-1, F] stays untouched — in both packages, bit for bit."""
    for tag, target, want_shape in (
            ("fixed", [1, 12], (3, 12)),
            ("minus1", [1, -1], (3, 12)),
            ("flatten", [-1, 4], (9, 4))):
        inits = {"shape": np.asarray(target, np.int64)}
        path = _write(tmp_path, f"reshape_{tag}",
                      [ou.node("Reshape", ["x", "shape"], ["y"])], inits,
                      [("x", [1, 3, 4])], [("y", list(want_shape))])
        x = np.arange(3 * 3 * 4, dtype=np.float32).reshape(3, 3, 4)
        got, want = _run(_pair(path, max_batch_size=4), {"x": x})
        _close(got, want, exact=True)
        assert got["y"].shape == want_shape


def test_unsupported_op_reports_name(tmp_path):
    path = _write(tmp_path, "nonsense", [ou.node("NonsenseOp", ["x"],
                                                 ["y"])], {},
                  [("x", [1, 4])], [("y", [1, 4])])
    with pytest.raises(NotImplementedError, match="NonsenseOp"):
        tx.load_onnx_model(path, max_batch_size=1, device="cpu")


def test_resnet50_topology_vs_native(tmp_path):
    """ResNet-50 (53 conv + BN units, SAME_UPPER convs) imported by both
    packages and held against the port's native NHWC ResNet on the same
    folded weights."""
    from tpulab_torch.models.convert import tree_from_numpy
    from tpulab_torch.models.resnet import make_resnet

    data, folded = ou.resnet50_graph(11, 10, 64)
    path = tmp_path / "rn50.onnx"
    path.write_bytes(data)
    pair = _pair(str(path), max_batch_size=2)
    xin = np.random.default_rng(11).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    got, want = _run(pair, {"input": xin})
    _close(got, want, tol=RESNET_TOL)
    native = make_resnet(depth=50, num_classes=10, image_size=64,
                         compute_dtype=torch.float32, max_batch_size=2,
                         params=tree_from_numpy(folded, "cpu"))
    nat = native.apply_fn(native.params, {"input": torch.from_numpy(
        np.ascontiguousarray(xin.transpose(0, 2, 3, 1)))})["logits"]
    np.testing.assert_allclose(got["logits"], nat.numpy(),
                               rtol=RESNET_TOL, atol=RESNET_TOL)


def test_onnx_weight_only_int8(tmp_path):
    """The same eligible weights become {w_int8, scale} bit for bit;
    Reshape-consumed and small initializers stay float; the int8 graph's
    output is tpulab's within 1e-4 and the float graph's within the
    quantization tolerance."""
    rng = np.random.default_rng(3)
    inits = {
        "w": (rng.standard_normal((8, 4, 3, 3)) / 6).astype(np.float32),
        "w_big": (rng.standard_normal((16, 8, 3, 3)) / 6).astype(
            np.float32),
        "wfc": (rng.standard_normal((16 * 16, 8)) / 16).astype(np.float32),
        "tbl": (rng.standard_normal((64, 33)) / 8).astype(np.float32),
        "tbl_shape": np.asarray([1, 2112], np.int64),
    }
    nodes = [
        ou.node("Conv", ["x", "w"], ["c"], kernel_shape=[3, 3],
                auto_pad=b"SAME_UPPER"),
        ou.node("Conv", ["c", "w_big"], ["c2"], kernel_shape=[3, 3],
                auto_pad=b"SAME_UPPER"),
        ou.node("Relu", ["c2"], ["r"]),
        ou.node("Flatten", ["r"], ["f"], axis=1),
        ou.node("MatMul", ["f", "wfc"], ["g"]),
        ou.node("Reshape", ["tbl", "tbl_shape"], ["tbl2"]),
        ou.node("Slice", ["tbl2"], ["tslice"], starts=[0, 0], ends=[1, 8]),
        ou.node("Add", ["g", "tslice"], ["y"]),
    ]
    path = _write(tmp_path, "q", nodes, inits, [("x", [1, 4, 4, 4])],
                  [("y", [1, 8])])
    graph = tx.parse_onnx(path).graph
    assert tx._weight_names(graph) == jx._weight_names(
        jx.parse_onnx(path).graph) == {"w", "w_big", "wfc"}
    qpair = _pair(path, max_batch_size=2, weight_quant="int8")
    pq, jq = qpair
    for k in ("w_big", "wfc"):
        assert pq.params[k]["w_int8"].dtype == torch.int8
        np.testing.assert_array_equal(pq.params[k]["w_int8"].numpy(),
                                      np.asarray(jq.params[k]["w_int8"]))
        np.testing.assert_array_equal(pq.params[k]["scale"].numpy(),
                                      np.asarray(jq.params[k]["scale"]))
    assert isinstance(pq.params["tbl"], torch.Tensor)   # reshape-consumed
    assert isinstance(pq.params["w"], torch.Tensor)     # 288 < min_size
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    got, want = _run(qpair, {"x": x})
    _close(got, want)
    fpair = _pair(path, max_batch_size=2)
    yf = _run(fpair, {"x": x})[0]["y"]
    np.testing.assert_allclose(got["y"], yf, rtol=0.05, atol=0.05)
    assert not np.allclose(got["y"], yf, rtol=1e-7, atol=1e-7)
    with pytest.raises(ValueError, match="unknown weight_quant"):
        tx.load_onnx_model(path, weight_quant="int4", device="cpu")


def test_conv_transpose_matches_manual_scatter(tmp_path):
    """ConvTranspose (stride 2, pad 1) against a direct scatter of the
    ONNX deconv spec, and against tpulab."""
    rng = np.random.default_rng(9)
    x = _f32(rng, 1, 3, 5, 5)
    w = _f32(rng, 3, 4, 3, 3)
    b = _f32(rng, 4)
    stride, pad, k = 2, 1, 3
    H = (5 - 1) * stride + k - 2 * pad
    full = np.zeros((1, 4, H + 2 * pad, H + 2 * pad), np.float32)
    for i in range(5):
        for j in range(5):
            full[0, :, i * stride:i * stride + k,
                 j * stride:j * stride + k] += np.einsum(
                     "c,cokl->okl", x[0, :, i, j], w)
    manual = full[:, :, pad:pad + H, pad:pad + H] + b.reshape(1, -1, 1, 1)
    path = _write(tmp_path, "deconv", [ou.node(
        "ConvTranspose", ["x", "w", "b"], ["y"], kernel_shape=[k, k],
        strides=[stride, stride], pads=[pad, pad, pad, pad])],
        {"w": w, "b": b}, [("x", [1, 3, 5, 5])], [("y", [1, 4, 9, 9])])
    got, want = _run(_pair(path, max_batch_size=2), {"x": x})
    _close(got, want)
    np.testing.assert_allclose(got["y"], manual, rtol=TOL, atol=TOL)


def test_unet_style_block(tmp_path):
    """Conv -> InstanceNormalization -> PRelu -> Resize(nearest, x2) ->
    skip Concat -> 1x1 Conv -> ArgMax: the segmentation-decoder idiom."""
    rng = np.random.default_rng(12)
    inits = {
        "w1": (rng.standard_normal((4, 3, 3, 3)) / 5).astype(np.float32),
        "in_s": (0.5 + rng.random(4)).astype(np.float32),
        "in_b": _f32(rng, 4),
        "slope": (0.1 * rng.random(4)).astype(np.float32),
        "scales": np.asarray([1.0, 1.0, 2.0, 2.0], np.float32),
        "w2": (rng.standard_normal((2, 7, 1, 1)) / 3).astype(np.float32),
    }
    nodes = [
        ou.node("Conv", ["x", "w1"], ["c1"], kernel_shape=[3, 3],
                strides=[2, 2], auto_pad=b"SAME_UPPER"),
        ou.node("InstanceNormalization", ["c1", "in_s", "in_b"], ["n1"],
                epsilon=1e-5),
        ou.node("PRelu", ["n1", "slope"], ["p1"]),
        ou.node("Resize", ["p1", "", "scales"], ["up"]),
        ou.node("Concat", ["up", "x"], ["cat"], axis=1),
        ou.node("Conv", ["cat", "w2"], ["seg"], kernel_shape=[1, 1]),
        ou.node("ArgMax", ["seg"], ["mask"], axis=1, keepdims=0),
    ]
    path = _write(tmp_path, "unet", nodes, inits, [("x", [1, 3, 8, 8])],
                  [("mask", [1, 8, 8])])
    x = _f32(rng, 2, 3, 8, 8)
    got, want = _run(_pair(path, max_batch_size=2), {"x": x})
    _close(got, want, exact=True)
    assert got["mask"].dtype == np.int32 and set(np.unique(got["mask"])) \
        <= {0, 1}


def test_misc_elementwise_and_reduce_ops(tmp_path):
    """HardSigmoid, LogSoftmax, ReduceMax, Tile and the two-input
    Upsample-9 form; an align_corners Resize raises in both."""
    rng = np.random.default_rng(21)
    inits = {"reps": np.asarray([1, 2, 1], np.int64),
             "up_scales": np.asarray([1.0, 1.0, 2.0, 2.0], np.float32),
             "img_shape": np.asarray([0, 1, 2, 3], np.int64)}
    nodes = [
        ou.node("HardSigmoid", ["x"], ["hs"], alpha=0.25, beta=0.4),
        ou.node("LogSoftmax", ["x"], ["ls"], axis=-1),
        ou.node("ReduceMax", ["x"], ["rm"], axes=[1], keepdims=1),
        ou.node("Tile", ["x", "reps"], ["tl"]),
        ou.node("Reshape", ["x", "img_shape"], ["ximg"]),
        ou.node("Upsample", ["ximg", "up_scales"], ["up"], mode=b"nearest"),
    ]
    path = _write(tmp_path, "misc", nodes, inits, [("x", [1, 2, 3])],
                  [(n, [1]) for n in ("hs", "ls", "rm", "tl", "up")])
    x = _f32(rng, 2, 2, 3)
    got, want = _run(_pair(path, max_batch_size=2), {"x": x})
    _close(got, want)
    np.testing.assert_array_equal(
        got["up"], x.reshape(2, 1, 2, 3).repeat(2, 2).repeat(2, 3))
    bad = _write(tmp_path, "bad", [ou.node(
        "Resize", ["x", "", "s"], ["y"], mode=b"linear",
        coordinate_transformation_mode=b"align_corners")],
        {"s": np.asarray([1., 1., 2.], np.float32)},
        [("x", [1, 2, 3])], [("y", [1, 2, 6])])
    with pytest.raises(NotImplementedError, match="align_corners"):
        tx.load_onnx_model(bad, max_batch_size=1, device="cpu")


def test_transformer_block_import(tmp_path):
    """A BERT/ViT-style encoder block as exporters emit it: the
    Shape -> Gather -> Concat -> Reshape idiom folded on the host per
    batch, Split / Squeeze / Transpose, scaled-dot-product Softmax,
    erf-form Gelu, residuals."""
    D, H, T, FF = 32, 4, 6, 64
    hd = D // H
    rng = np.random.default_rng(5)

    def w(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    inits = {
        "ln1_g": np.abs(w(D)) + 0.5, "ln1_b": w(D),
        "wqkv": w(D, 3 * D), "bqkv": w(3 * D),
        "wo": w(D, D), "bo": w(D),
        "ln2_g": np.abs(w(D)) + 0.5, "ln2_b": w(D),
        "w1": w(D, FF), "b1": w(FF), "w2": w(FF, D), "b2": w(D),
        "g0": np.asarray([0], np.int64), "g1": np.asarray([1], np.int64),
        "heads": np.asarray([H], np.int64),
        "hd": np.asarray([hd], np.int64),
        "negone": np.asarray([-1], np.int64),
        "sqrt_hd": np.asarray(np.sqrt(hd), np.float32),
        "half": np.asarray(0.5, np.float32),
        "one": np.asarray(1.0, np.float32),
        "sqrt2": np.asarray(np.sqrt(2.0), np.float32),
    }
    n = [ou.node("LayerNormalization", ["x", "ln1_g", "ln1_b"], ["ln1"],
                 epsilon=1e-5, axis=-1),
         ou.node("MatMul", ["ln1", "wqkv"], ["qkv0"]),
         ou.node("Add", ["qkv0", "bqkv"], ["qkv"]),
         ou.node("Shape", ["x"], ["xshape"]),
         ou.node("Gather", ["xshape", "g0"], ["bdim"], axis=0),
         ou.node("Gather", ["xshape", "g1"], ["tdim"], axis=0),
         ou.node("Concat", ["bdim", "tdim", "negone", "heads", "hd"],
                 ["qkv_shape"], axis=0),
         ou.node("Reshape", ["qkv", "qkv_shape"], ["qkv5"]),
         ou.node("Transpose", ["qkv5"], ["qkv_t"], perm=[2, 0, 3, 1, 4]),
         ou.node("Split", ["qkv_t"], ["q_", "k_", "v_"], axis=0)]
    n += [ou.node("Squeeze", [f"{nm}_"], [nm], axes=[0]) for nm in "qkv"]
    n += [ou.node("Transpose", ["k"], ["kT"], perm=[0, 1, 3, 2]),
          ou.node("MatMul", ["q", "kT"], ["scores0"]),
          ou.node("Div", ["scores0", "sqrt_hd"], ["scores"]),
          ou.node("Softmax", ["scores"], ["probs"], axis=-1),
          ou.node("MatMul", ["probs", "v"], ["ctx"]),
          ou.node("Transpose", ["ctx"], ["ctx_t"], perm=[0, 2, 1, 3]),
          ou.node("Concat", ["bdim", "tdim", "negone"], ["merge_shape"],
                  axis=0),
          ou.node("Reshape", ["ctx_t", "merge_shape"], ["merged"]),
          ou.node("MatMul", ["merged", "wo"], ["attn0"]),
          ou.node("Add", ["attn0", "bo"], ["attn"]),
          ou.node("Add", ["x", "attn"], ["res1"]),
          ou.node("LayerNormalization", ["res1", "ln2_g", "ln2_b"], ["ln2"],
                  epsilon=1e-5, axis=-1),
          ou.node("MatMul", ["ln2", "w1"], ["h0"]),
          ou.node("Add", ["h0", "b1"], ["h1"]),
          ou.node("Div", ["h1", "sqrt2"], ["h2"]),
          ou.node("Erf", ["h2"], ["h3"]),
          ou.node("Add", ["h3", "one"], ["h4"]),
          ou.node("Mul", ["h1", "h4"], ["h5"]),
          ou.node("Mul", ["h5", "half"], ["gelu"]),
          ou.node("MatMul", ["gelu", "w2"], ["m0"]),
          ou.node("Add", ["m0", "b2"], ["m1"]),
          ou.node("Add", ["res1", "m1"], ["y"])]
    path = _write(tmp_path, "encoder", n, inits, [("x", [1, T, D])],
                  [("y", [1, T, D])])
    pair = _pair(path, max_batch_size=2)
    for b in (1, 2):            # the Shape idiom rebinds per batch
        got, want = _run(pair, {"x": _f32(rng, b, T, D)})
        _close(got, want, tol=2e-4)


def test_constant_nodes_fold_on_the_host(tmp_path):
    """Constant nodes (tensor-valued attributes) join the params and the
    host pool: a Constant-only subgraph folds to numpy (no device value
    for the Reshape target), and an output that is a Constant comes back
    as tensors of tpulab's dtype (int32: JAX without x64)."""
    nodes = [ou.node("Constant", [], ["c"],
                     value=np.asarray([2, 3], np.int64)),
             ou.node("Constant", [], ["one"],
                     value=np.asarray([1], np.int64)),
             ou.node("Mul", ["c", "one"], ["c2"]),
             ou.node("Concat", ["one", "c2"], ["shape"], axis=0),
             ou.node("Reshape", ["x", "shape"], ["y"]),
             ou.node("Add", ["c2", "one"], ["c3"])]
    path = _write(tmp_path, "const", nodes, {}, [("x", [1, 6])],
                  [("y", [1, 2, 3]), ("c3", [2])])
    pair = _pair(path, max_batch_size=4)
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    got, want = _run(pair, {"x": x})
    _close(got, want, exact=True)
    assert got["y"].shape == (4, 2, 3)


def test_folded_values_are_per_call(tmp_path):
    """Two buckets served at once each see their own Shape values (the
    host pool lives in the call)."""
    import threading

    nodes = [ou.node("Shape", ["x"], ["s"]),
             ou.node("Reshape", ["x", "s"], ["y"])]
    path = _write(tmp_path, "shape", nodes, {}, [("x", [1, 5])],
                  [("y", [1, 5])])
    m = tx.load_onnx_model(path, max_batch_size=8, device="cpu")
    errors = []

    def serve(b):
        try:
            for _ in range(200):
                x = torch.full((b, 5), float(b))
                assert m.apply_fn(m.params, {"x": x})["y"].shape == (b, 5)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=serve, args=(b,)) for b in (1, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_imported_graph_served_through_the_manager(tmp_path):
    """Imported model -> InferenceManager -> InferRunner at a batch the
    N=1 export never saw (Reshape [1, F] rebinds per bucket), equal to
    tpulab's manager on the same graph."""
    from tpulab.engine import InferenceManager as JaxManager
    from tpulab_torch.engine import InferenceManager

    rng = np.random.default_rng(4)
    inits = {"w": _f32(rng, 4, 1, 3, 3), "flat": np.asarray([1, 64],
                                                            np.int64),
             "wfc": _f32(rng, 64, 10), "b": _f32(rng, 10)}
    nodes = [ou.node("Conv", ["x", "w"], ["c"], kernel_shape=[3, 3],
                     strides=[2, 2], auto_pad=b"SAME_UPPER"),
             ou.node("Relu", ["c"], ["r"]),
             ou.node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2],
                     strides=[2, 2]),
             ou.node("Reshape", ["p", "flat"], ["f"]),
             ou.node("MatMul", ["f", "wfc"], ["g"]),
             ou.node("Add", ["g", "b"], ["out"])]
    path = _write(tmp_path, "mnistish", nodes, inits, [("x", [1, 1, 16, 16])],
                  [("out", [1, 10])])
    x = _f32(rng, 3, 1, 16, 16)
    outs = []
    for mgr, model in (
            (InferenceManager(max_executions=2, device="cpu"),
             tx.load_onnx_model(path, name="m", max_batch_size=4,
                                device="cpu")),
            (JaxManager(max_executions=2),
             jx.load_onnx_model(path, name="m", max_batch_size=4))):
        mgr.register_model("m", model)
        mgr.update_resources()
        try:
            outs.append(np.array(mgr.infer_runner("m").infer(x=x).result(
                timeout=120)["out"]))
        finally:
            mgr.shutdown()
    assert outs[0].shape == (3, 10)
    np.testing.assert_allclose(outs[0], outs[1], rtol=TOL, atol=TOL)


# ------------------------------------------------- every op, one at a time
def _cases():
    """(id, nodes, inits, feeds, opset, exact) — one graph per op and per
    attribute form that changes its semantics."""
    rng = np.random.default_rng(17)
    x4 = _f32(rng, 2, 3, 7, 7)
    x3 = _f32(rng, 2, 4, 6)
    pos = np.abs(x3) + 0.1
    c = []

    def add(cid, nodes, inits, feeds, opset=13, exact=False):
        c.append((cid, nodes, inits, feeds, opset, exact))

    w = _f32(rng, 5, 3, 3, 3, scale=0.3)
    b = _f32(rng, 5)
    add("Conv-pads", [ou.node("Conv", ["x", "w", "b"], ["y"],
                              kernel_shape=[3, 3], pads=[1, 0, 2, 1])],
        {"w": w, "b": b}, {"x": x4})
    add("Conv-same_upper-s2", [ou.node("Conv", ["x", "w"], ["y"],
                                       kernel_shape=[3, 3], strides=[2, 2],
                                       auto_pad=b"SAME_UPPER")],
        {"w": w}, {"x": x4})
    add("Conv-valid-dilated", [ou.node("Conv", ["x", "w"], ["y"],
                                       kernel_shape=[3, 3],
                                       dilations=[2, 2], auto_pad=b"VALID")],
        {"w": w}, {"x": x4})
    add("Conv-same-dilated", [ou.node("Conv", ["x", "w"], ["y"],
                                      kernel_shape=[3, 3], strides=[2, 2],
                                      dilations=[2, 1],
                                      auto_pad=b"SAME_UPPER")],
        {"w": w}, {"x": x4})
    add("Conv-group", [ou.node("Conv", ["x", "wg"], ["y"],
                               kernel_shape=[3, 3], group=3,
                               pads=[1, 1, 1, 1])],
        {"wg": _f32(rng, 6, 1, 3, 3)}, {"x": x4})
    add("Conv-1d", [ou.node("Conv", ["x", "w1"], ["y"], kernel_shape=[3],
                            strides=[2], pads=[1, 2])],
        {"w1": _f32(rng, 2, 4, 3)}, {"x": x3})
    for op in ("Relu", "Sigmoid", "Tanh", "Sqrt", "Erf", "Exp", "Log", "Neg",
               "Abs", "Floor", "Ceil", "Identity"):
        add(op, [ou.node(op, ["x"], ["y"])], {},
            {"x": pos if op in ("Sqrt", "Log") else x3},
            exact=op in ("Relu", "Neg", "Abs", "Floor", "Ceil", "Identity"))
    add("LeakyRelu", [ou.node("LeakyRelu", ["x"], ["y"], alpha=0.2)], {},
        {"x": x3})
    add("Clip-attrs", [ou.node("Clip", ["x"], ["y"], min=-0.5, max=0.7)], {},
        {"x": x3}, opset=6, exact=True)
    add("Clip-inputs", [ou.node("Clip", ["x", "lo", "hi"], ["y"])],
        {"lo": np.asarray(-0.25, np.float32),
         "hi": np.asarray(0.5, np.float32)}, {"x": x3}, exact=True)
    add("MaxPool-pads", [ou.node("MaxPool", ["x"], ["y"],
                                 kernel_shape=[3, 3], strides=[2, 2],
                                 pads=[1, 1, 1, 1])], {}, {"x": x4},
        exact=True)
    add("MaxPool-same", [ou.node("MaxPool", ["x"], ["y"],
                                 kernel_shape=[2, 3], strides=[2, 2],
                                 auto_pad=b"SAME_UPPER")], {}, {"x": x4},
        exact=True)
    for inc in (0, 1):
        add(f"AveragePool-pads-cip{inc}",
            [ou.node("AveragePool", ["x"], ["y"], kernel_shape=[3, 3],
                     strides=[2, 2], pads=[1, 0, 1, 2],
                     count_include_pad=inc)], {}, {"x": x4})
    add("AveragePool-same", [ou.node("AveragePool", ["x"], ["y"],
                                     kernel_shape=[3, 3], strides=[2, 2],
                                     auto_pad=b"SAME_UPPER")], {}, {"x": x4})
    add("AveragePool-1d", [ou.node("AveragePool", ["x"], ["y"],
                                   kernel_shape=[3], strides=[1],
                                   pads=[1, 1])], {}, {"x": x3})
    add("GlobalAveragePool", [ou.node("GlobalAveragePool", ["x"], ["y"])],
        {}, {"x": x4})
    add("GlobalMaxPool", [ou.node("GlobalMaxPool", ["x"], ["y"])], {},
        {"x": x4}, exact=True)
    add("BatchNormalization", [ou.node(
        "BatchNormalization", ["x", "s", "b", "m", "v"], ["y"],
        epsilon=1e-3)],
        {"s": _f32(rng, 3), "b": _f32(rng, 3), "m": _f32(rng, 3),
         "v": np.abs(_f32(rng, 3)) + 0.5}, {"x": x4})
    for op in ("Add", "Sub", "Mul", "Div"):
        add(f"{op}-broadcast", [ou.node(op, ["x", "k"], ["y"])],
            {"k": _f32(rng, 4, 1) + 3.0}, {"x": x3})
    add("Pow", [ou.node("Pow", ["x", "k"], ["y"])],
        {"k": np.asarray([2.0, 0.5, 1.5, 3.0, 1.0, 2.5], np.float32)},
        {"x": pos})
    add("Sum", [ou.node("Sum", ["x", "k", "x"], ["y"])],
        {"k": _f32(rng, 6)}, {"x": x3})
    add("Min", [ou.node("Min", ["x", "k"], ["y"])], {"k": _f32(rng, 6)},
        {"x": x3}, exact=True)
    add("Max", [ou.node("Max", ["x", "k", "k2"], ["y"])],
        {"k": _f32(rng, 6), "k2": _f32(rng, 4, 1)}, {"x": x3}, exact=True)
    add("MatMul", [ou.node("MatMul", ["x", "m"], ["y"])],
        {"m": _f32(rng, 6, 5)}, {"x": x3})
    x2 = _f32(rng, 2, 6)
    for ta in (0, 1):
        for tb in (0, 1):
            a_in = "xt" if ta else "x"
            nodes = ([ou.node("Transpose", ["x"], ["xt"], perm=[1, 0])]
                     if ta else [])
            nodes.append(ou.node("Gemm", [a_in, "m", "cc"], ["y"],
                                 transA=ta, transB=tb, alpha=0.75,
                                 beta=1.5))
            add(f"Gemm-tA{ta}-tB{tb}", nodes,
                {"m": _f32(rng, *((5, 6) if tb else (6, 5))),
                 "cc": _f32(rng, 5)}, {"x": x2})
    add("Flatten-axis2", [ou.node("Flatten", ["x"], ["y"], axis=2)], {},
        {"x": x4}, exact=True)
    for opset in (11, 13):
        for op in ("Softmax", "LogSoftmax"):
            add(f"{op}-opset{opset}",
                [ou.node(op, ["x"], ["y"], axis=1)], {}, {"x": x3},
                opset=opset)
    add("Concat", [ou.node("Neg", ["x"], ["nx"]),
                   ou.node("Concat", ["x", "nx", "x"], ["y"], axis=1)],
        {}, {"x": x3}, exact=True)
    add("Transpose-default", [ou.node("Transpose", ["x"], ["y"])], {},
        {"x": x3}, exact=True)
    add("Dropout-mask", [ou.node("Dropout", ["x"], ["y", "mask"])], {},
        {"x": x3}, exact=True)
    add("Cast-int32", [ou.node("Cast", ["x"], ["y"], to=6)], {},
        {"x": x3 * 10}, exact=True)
    add("Cast-f16", [ou.node("Cast", ["x"], ["y"], to=10)], {},
        {"x": x3}, exact=True)
    for mode in (b"constant", b"reflect", b"edge"):
        add(f"Pad-{mode.decode()}", [ou.node(
            "Pad", ["x", "pads", "cv"], ["y"], mode=mode)],
            {"pads": np.asarray([0, 0, 1, 2, 0, 0, 2, 1], np.int64),
             "cv": np.asarray(0.5, np.float32)}, {"x": x4}, exact=True)
    add("Pad-attrs", [ou.node("Pad", ["x"], ["y"], pads=[0, 1, 0, 0, 2, 1],
                              value=-1.0)], {}, {"x": x3}, opset=2,
        exact=True)
    for op in ("ReduceMean", "ReduceSum", "ReduceMax"):
        add(f"{op}-attr", [ou.node(op, ["x"], ["y"], axes=[1, 2],
                                   keepdims=0)], {}, {"x": x3},
            opset=11, exact=op == "ReduceMax")
        add(f"{op}-all", [ou.node(op, ["x"], ["y"])], {}, {"x": x3},
            opset=11, exact=op == "ReduceMax")
    add("ReduceSum-input", [ou.node("ReduceSum", ["x", "ax"], ["y"],
                                    keepdims=1)],
        {"ax": np.asarray([-1], np.int64)}, {"x": x3})
    add("Squeeze-input", [ou.node("Squeeze", ["x", "ax"], ["y"])],
        {"ax": np.asarray([1], np.int64)}, {"x": x3[:, :1]}, exact=True)
    add("Unsqueeze-attr", [ou.node("Unsqueeze", ["x"], ["y"],
                                   axes=[0, 3])], {}, {"x": x3},
        opset=11, exact=True)
    add("Unsqueeze-input", [ou.node("Unsqueeze", ["x", "ax"], ["y"])],
        {"ax": np.asarray([-1, 1], np.int64)}, {"x": x3}, exact=True)
    for approx in (b"none", b"tanh"):
        add(f"Gelu-{approx.decode()}", [ou.node(
            "Gelu", ["x"], ["y"], approximate=approx)], {}, {"x": x3})
    add("LayerNormalization-axis1", [ou.node(
        "LayerNormalization", ["x", "g"], ["y"], axis=1, epsilon=1e-4)],
        {"g": _f32(rng, 4, 6)}, {"x": x3})
    add("Slice-steps", [ou.node("Slice", ["x", "st", "en", "ax", "sp"],
                                ["y"])],
        {"st": np.asarray([-1, 0], np.int64),
         "en": np.asarray([-(1 << 62), 6], np.int64),
         "ax": np.asarray([2, 1], np.int64),
         "sp": np.asarray([-2, 3], np.int64)}, {"x": x3}, exact=True)
    add("Slice-attrs", [ou.node("Slice", ["x"], ["y"], starts=[1, -4],
                                ends=[3, 1000], axes=[1, 2])], {},
        {"x": x3}, opset=9, exact=True)
    add("Gather-negative", [ou.node("Gather", ["x", "i"], ["y"], axis=1)],
        {"i": np.asarray([[0, -1], [2, 1]], np.int64)}, {"x": x3},
        exact=True)
    add("Split-input", [ou.node("Split", ["x", "sz"], ["a", "b2"], axis=2)],
        {"sz": np.asarray([2, 4], np.int64)}, {"x": x3}, exact=True)
    add("Split-even", [ou.node("Split", ["x"], ["a", "b2", "c2"], axis=2)],
        {}, {"x": x3}, exact=True)
    add("Where-Equal", [ou.node("Equal", ["x", "x2"], ["e"]),
                        ou.node("Where", ["e", "x", "k"], ["y"])],
        {"x2": np.where(rng.random((2, 4, 6)) > 0.5, x3, 0.0).astype(
            np.float32), "k": _f32(rng, 6)}, {"x": x3}, exact=True)
    add("Expand", [ou.node("Expand", ["x", "shp"], ["y"])],
        {"shp": np.asarray([3, 1, 1, 1], np.int64)}, {"x": x3}, exact=True)
    add("Tile", [ou.node("Tile", ["x", "r"], ["y"])],
        {"r": np.asarray([1, 2, 3], np.int64)}, {"x": x3}, exact=True)
    add("ConvTranspose-opad", [ou.node(
        "ConvTranspose", ["x", "wt"], ["y"], kernel_shape=[3, 3],
        strides=[2, 2], pads=[1, 0, 0, 1], output_padding=[1, 1])],
        {"wt": _f32(rng, 3, 2, 3, 3)}, {"x": x4})
    add("ConvTranspose-dilated", [ou.node(
        "ConvTranspose", ["x", "wt"], ["y"], kernel_shape=[2, 2],
        strides=[1, 2], dilations=[2, 1])],
        {"wt": _f32(rng, 3, 2, 2, 2)}, {"x": x4})
    xs = _f32(rng, 2, 2, 3, 4)
    for mode in (b"nearest", b"linear", b"cubic"):
        add(f"Resize-{mode.decode()}", [ou.node(
            "Resize", ["x", "", "s"], ["y"], mode=mode)],
            {"s": np.asarray([1.0, 1.0, 2.0, 3.0], np.float32)},
            {"x": xs}, exact=mode == b"nearest")
    add("Resize-linear-frac-sizes", [ou.node(
        "Resize", ["x", "", "", "sz"], ["y"], mode=b"linear")],
        {"sz": np.asarray([1, 2, 5, 7], np.int64)}, {"x": xs})
    add("Upsample-7", [ou.node("Upsample", ["x"], ["y"],
                               scales=(1.0, 1.0, 2.0, 2.0))], {}, {"x": xs},
        opset=7, exact=True)
    add("InstanceNormalization", [ou.node(
        "InstanceNormalization", ["x", "s", "b"], ["y"], epsilon=1e-3)],
        {"s": _f32(rng, 3), "b": _f32(rng, 3)}, {"x": x4})
    add("PRelu-scalar", [ou.node("PRelu", ["x", "sl"], ["y"])],
        {"sl": np.asarray([0.1], np.float32)}, {"x": x4})
    add("HardSigmoid-default", [ou.node("HardSigmoid", ["x"], ["y"])], {},
        {"x": x3 * 4})
    add("ArgMax-keepdims", [ou.node("ArgMax", ["x"], ["y"], axis=2)], {},
        {"x": x3}, exact=True)
    add("Shape-Constant", [
        ou.node("Shape", ["x"], ["s"]),
        ou.node("Constant", [], ["two"], value=np.asarray([2], np.int64)),
        ou.node("Div", ["s", "two"], ["h"]),
        ou.node("Cast", ["h"], ["hi"], to=7),
        ou.node("Slice", ["x", "z", "hi", "ax"], ["y"])],
        {"z": np.asarray([0], np.int64), "ax": np.asarray([2], np.int64)},
        {"x": x3}, exact=True)
    return c


CASES = _cases()


@pytest.mark.parametrize("cid,nodes,inits,feeds,opset,exact", CASES,
                         ids=[c[0] for c in CASES])
def test_op_matches_tpulab(tmp_path, cid, nodes, inits, feeds, opset, exact):
    inputs = [(k, [1, *v.shape[1:]]) for k, v in feeds.items()]
    outs = [n for blob in nodes[-1:] for n in tx.OnnxNode(blob).outputs]
    path = _write(tmp_path, "op", nodes, inits, inputs,
                  [(o, [1]) for o in outs], opset)
    pair = _pair(path, max_batch_size=2)
    got, want = _run(pair, feeds)
    _close(got, want, exact=exact)
    _same_specs(pair)


def test_every_supported_op_has_a_case():
    seen = {tx.OnnxNode(n).op for c in CASES for n in c[1]}
    seen |= {"Reshape", "Flatten"}          # the block tests' ops
    assert tx.supported_ops() <= seen, tx.supported_ops() - seen


@pytest.mark.parametrize("cid,node", [
    ("auto_pad SAME_LOWER", ou.node("Conv", ["x", "w"], ["y"],
                                    kernel_shape=[3, 3],
                                    auto_pad=b"SAME_LOWER")),
    ("ceil_mode", ou.node("MaxPool", ["x"], ["y"], kernel_shape=[2, 2],
                          ceil_mode=1)),
    ("grouped ConvTranspose", ou.node("ConvTranspose", ["x", "w"], ["y"],
                                      kernel_shape=[3, 3], group=3)),
    ("Resize downscale", ou.node("Resize", ["x", "", "s2"], ["y"])),
    ("select_last_index", ou.node("ArgMax", ["x"], ["y"],
                                  select_last_index=1)),
])
def test_unsupported_forms_raise_as_tpulab(tmp_path, cid, node):
    inits = {"w": np.zeros((3, 3, 3, 3), np.float32),
             "s2": np.asarray([1.0, 1.0, 0.5, 0.5], np.float32)}
    path = _write(tmp_path, "bad", [node], inits, [("x", [1, 3, 8, 8])],
                  [("y", [1])])
    with pytest.raises(NotImplementedError) as jerr:
        jx.load_onnx_model(path)
    with pytest.raises(NotImplementedError) as terr:
        tx.load_onnx_model(path, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_entry_point_defaults_to_the_card(tmp_path):
    path = _write(tmp_path, "relu", [ou.node("Relu", ["x"], ["y"])], {},
                  [("x", [1, 4])], [("y", [1, 4])])
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.load_onnx_model(path)
