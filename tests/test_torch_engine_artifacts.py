"""The port's engine artifacts, memory analysis and ``register_engine``
held against tpulab's on the CPU (the port of ``tests/test_engine.py``'s
runtime and artifact cases).

- ``compile_model`` builds one program per bucket; ``memory_analysis``
  reports tpulab's argument and output bytes exactly (temp bytes: None
  on the CPU, which keeps no allocator statistics).
- ``save_engine`` writes ``spec.json`` (tpulab's keys), ``params.npz``
  (tpulab's ``leaf_{i}`` keys), ``tree.json`` and one ``bucket_{b}.pt2``
  ``torch.export`` program per bucket; ``load_engine`` with ``apply_fn``
  and without it (the programs alone) serves the in-memory model's
  outputs bit for bit, at every bucket, for MNIST, an imported ONNX
  graph (f32 and int8 weights) and ResNet-50 W8A8; bf16, e4m3 and int8
  leaves keep their bits in the weights file.
- A missing program raises tpulab's error; tpulab's artifacts and the
  port's do not load across.
- ``InferenceManager.register_engine`` serves an artifact as tpulab's
  manager serves its own (tolerance ``TOL``: f32, two backends).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_onnx_util as ou
from tpulab.engine import InferenceManager as JaxManager
from tpulab.engine import Runtime as JaxRuntime
from tpulab.models.mnist import make_mnist as jax_make_mnist
from tpulab_torch.engine import InferenceManager, Runtime
from tpulab_torch.models.convert import tree_from_numpy
from tpulab_torch.models.mnist import make_mnist, mnist_apply

torch.set_num_threads(2)

TOL = 1e-5
OUT = "Plus214_Output_0"


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 28, 28, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def mnist():
    """tpulab's seeded MNIST and the port's on the same weights."""
    jm = jax_make_mnist(max_batch_size=2, seed=3)
    tree = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                           "cpu")
    return jm, make_mnist(max_batch_size=2, params=tree)


def test_runtime_compiles_buckets(mnist):
    jm, pm = mnist
    compiled = Runtime("cpu").compile_model(pm)
    assert sorted(compiled.executables) == [1, 2]
    out = compiled(2, {"Input3": torch.from_numpy(_images(2, 0))})
    assert out[OUT].shape == (2, 10)
    want = JaxRuntime().compile_model(jm)(2, {"Input3": _images(2, 0)})
    np.testing.assert_allclose(out[OUT].numpy(), np.asarray(want[OUT]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bucket", [1, 2])
def test_memory_analysis_matches_tpulab(mnist, bucket):
    jm, pm = mnist
    want = JaxRuntime().compile_model(jm).memory_analysis(bucket)
    got = Runtime("cpu").compile_model(pm).memory_analysis(bucket)
    assert got.argument_size_in_bytes == want.argument_size_in_bytes
    assert got.output_size_in_bytes == want.output_size_in_bytes
    assert got.temp_size_in_bytes is None          # the CPU: no statistics
    with pytest.raises(KeyError, match="not compiled"):
        Runtime("cpu").compile_model(pm, buckets=[1]).memory_analysis(2)


def test_engine_artifact_roundtrip(tmp_path, mnist):
    """With ``apply_fn``: the saved weights serve the in-memory outputs
    bit for bit; the spec and weights files carry tpulab's keys."""
    _, pm = mnist
    rt = Runtime("cpu")
    compiled = rt.compile_model(pm)
    x = torch.from_numpy(_images(1, 0))
    want = compiled(1, {"Input3": x})[OUT]
    path = str(tmp_path / "mnist_engine")
    rt.save_engine(compiled, path)
    with open(os.path.join(path, "spec.json")) as f:
        spec = json.load(f)
    assert spec == {"name": "mnist", "max_batch_size": 2,
                    "batch_buckets": [1, 2],
                    "inputs": [["Input3", [28, 28, 1], "float32"]],
                    "outputs": [[OUT, [10], "float32"]],
                    "format": "tpulab_torch"}
    data = np.load(os.path.join(path, "params.npz"))
    assert sorted(data.files) == sorted(f"leaf_{i}"
                                        for i in range(len(data.files)))
    loaded = rt.load_engine(path, apply_fn=mnist_apply)
    assert torch.equal(loaded(1, {"Input3": x})[OUT], want)
    assert loaded.model.batch_buckets == [1, 2]
    assert loaded.model.name == "mnist"


def test_engine_artifact_loads_without_apply_fn(tmp_path, mnist):
    """The exported programs are the model: loaded with NO apply_fn,
    every bucket serves through its own program, bit for bit."""
    _, pm = mnist
    rt = Runtime("cpu")
    compiled = rt.compile_model(pm)
    path = str(tmp_path / "portable_engine")
    rt.save_engine(compiled, path)
    assert os.path.exists(f"{path}/bucket_1.pt2")
    assert os.path.exists(f"{path}/bucket_2.pt2")
    loaded = Runtime("cpu").load_engine(path, model_name="mn")
    assert loaded.model.name == "mn"
    x = torch.from_numpy(_images(2, 3))
    for b in (1, 2):
        want = compiled(b, {"Input3": x[:b]})[OUT]
        assert torch.equal(loaded(b, {"Input3": x[:b]})[OUT], want)


def test_missing_program_raises_tpulabs_error(tmp_path, mnist):
    _, pm = mnist
    rt = Runtime("cpu")
    path = str(tmp_path / "eng")
    rt.save_engine(rt.compile_model(pm), path)
    os.remove(f"{path}/bucket_2.pt2")
    loaded = rt.load_engine(path)
    x = torch.from_numpy(_images(2, 1))
    with pytest.raises(ValueError, match="needs its portable program to "
                       "run bucket 2.*pass apply_fn"):
        loaded(2, {"Input3": x})
    assert loaded(1, {"Input3": x[:1]})[OUT].shape == (1, 10)
    # with apply_fn the artifact still serves every bucket
    again = rt.load_engine(path, apply_fn=mnist_apply)
    assert again(2, {"Input3": x})[OUT].shape == (2, 10)


def test_artifacts_do_not_load_across_packages(tmp_path, mnist):
    jm, pm = mnist
    jpath = str(tmp_path / "jax_engine")
    jrt = JaxRuntime()
    jrt.save_engine(jrt.compile_model(jm), jpath)
    with pytest.raises(ValueError, match="not a tpulab_torch engine"):
        Runtime("cpu").load_engine(jpath)
    ppath = str(tmp_path / "port_engine")
    rt = Runtime("cpu")
    rt.save_engine(rt.compile_model(pm), ppath)
    with pytest.raises(FileNotFoundError):
        jrt.load_engine(ppath)


def _onnx_path(tmp_path):
    data, _ = ou.resnet50_graph(4, 10, 32)
    path = tmp_path / "rn50.onnx"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("weight_quant", [None, "int8"],
                         ids=["f32", "int8"])
def test_onnx_artifact_roundtrip_is_bit_identical(tmp_path, weight_quant):
    """An imported ONNX ResNet-50 saved and loaded with no apply_fn and no
    .onnx source serves the in-memory model's logits bit for bit, at
    every bucket (the chip check's rule); tpulab's artifact of the same
    f32 file serves the same logits within the ResNet-50 tolerance."""
    from tpulab.models.onnx_import import load_onnx_model as jax_load
    from tpulab_torch.models.onnx_import import load_onnx_model

    path = _onnx_path(tmp_path)
    rt = Runtime("cpu")
    m = load_onnx_model(path, name="rn50_onnx", max_batch_size=2,
                        weight_quant=weight_quant, device="cpu")
    compiled = rt.compile_model(m)
    rt.save_engine(compiled, str(tmp_path / "eng"))
    loaded = Runtime("cpu").load_engine(str(tmp_path / "eng"))
    x = np.random.default_rng(5).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    for b in (1, 2):
        xb = torch.from_numpy(x[:b])
        want = compiled(b, {"input": xb})["logits"]
        assert torch.equal(loaded(b, {"input": xb})["logits"], want)
    if weight_quant is not None:
        return
    jrt = JaxRuntime()
    jrt.save_engine(jrt.compile_model(jax_load(
        path, name="rn50_onnx", max_batch_size=2)), str(tmp_path / "jeng"))
    jl = JaxRuntime().load_engine(str(tmp_path / "jeng"))
    np.testing.assert_allclose(
        loaded(2, {"input": torch.from_numpy(x)})["logits"].numpy(),
        np.asarray(jl(2, {"input": x})["logits"]), rtol=2e-3, atol=2e-3)


def test_tree_file_keeps_dtypes_and_bits(tmp_path):
    """bf16, e4m3, int8 and f32 leaves (0-d included) and python scalars
    through ``params.npz`` + ``tree.json``: the same tree back, bit for
    bit, each leaf its dtype."""
    from tpulab_torch.engine import runtime as rt

    g = torch.Generator().manual_seed(0)
    tree = {"a": {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                  "q": torch.randint(-127, 128, (5,), generator=g,
                                     dtype=torch.int8),
                  "s": torch.tensor(0.25)},
            "kv": torch.randn(2, 8, generator=g).to(torch.float8_e4m3fn),
            "eps": 1e-6, "n": 3}
    leaves = []
    structure = rt._tree_structure(tree, leaves)
    np.savez(tmp_path / "p.npz", **{f"leaf_{i}": rt._leaf_array(t)
                                    for i, t in enumerate(leaves)})
    (tmp_path / "t.json").write_text(json.dumps(structure))
    back = rt._tree_unflatten(json.loads((tmp_path / "t.json").read_text()),
                              np.load(tmp_path / "p.npz"))

    def same(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8))
        else:
            assert a == b
    same(tree, back)


def test_w8a8_resnet_artifact_roundtrip(tmp_path):
    """A W8A8 ResNet-50 (int8 kernels, 0-d act scales, a place_fn): the
    loaded leaves keep their dtypes and bits, and the program serves the
    in-memory logits bit for bit."""
    from tpulab_torch.models.quantization import (calibrate_resnet,
                                                  quantize_resnet_params_w8a8)
    from tpulab_torch.models.resnet import init_resnet_params, make_resnet

    f32 = init_resnet_params(50, num_classes=10, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(
        np.float32))
    params = quantize_resnet_params_w8a8(f32, calibrate_resnet(f32, [x]))
    m = make_resnet(50, num_classes=10, image_size=32, max_batch_size=1,
                    compute_dtype=torch.float32, params=params)
    rt = Runtime("cpu")
    compiled = rt.compile_model(m)
    rt.save_engine(compiled, str(tmp_path / "w8a8"))
    loaded = Runtime("cpu").load_engine(str(tmp_path / "w8a8"))
    stem = loaded.model.params["stem"]
    assert stem["kernel"].dtype == torch.int8
    assert torch.equal(stem["kernel"], params["stem"]["kernel"])
    assert stem["act_scale"].shape == ()
    want = compiled(1, {"input": x})["logits"]
    assert torch.equal(loaded(1, {"input": x})["logits"], want)


def test_register_engine_serves_like_tpulab(tmp_path, mnist):
    """``register_engine`` (no apply_fn) in the port's manager and
    tpulab's manager over its own artifact of the same weights: the same
    outputs within TOL; registration after ``update_resources`` raises."""
    jm, pm = mnist
    rt, jrt = Runtime("cpu"), JaxRuntime()
    rt.save_engine(rt.compile_model(pm), str(tmp_path / "p"))
    jrt.save_engine(jrt.compile_model(jm), str(tmp_path / "j"))
    x = _images(2, 9)
    outs = []
    for mgr, path in ((InferenceManager(max_executions=2, device="cpu"),
                       tmp_path / "p"),
                      (JaxManager(max_executions=2), tmp_path / "j")):
        mgr.register_engine("mn", str(path), max_concurrency=1)
        mgr.update_resources()
        try:
            outs.append(np.array(mgr.infer_runner("mn").infer(
                Input3=x).result(timeout=120)[OUT]))
            with pytest.raises(RuntimeError, match="before update_resources"):
                mgr.register_engine("again", str(path))
        finally:
            mgr.shutdown()
    np.testing.assert_allclose(outs[0], outs[1], rtol=TOL, atol=TOL)
