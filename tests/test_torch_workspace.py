"""The port's workspaces (``tpulab_torch/engine/workspace.py``) held
against tpulab's on the CPU, and their CUDA-graph form on the card.

On the CPU (tpulab's ``tests/test_engine.py`` workspace cases):
``StaticSingleModelGraphWorkspace.enqueue`` and
``TimedBenchmarkWorkspace.timed_run`` on MNIST serve tpulab's outputs
within ``TOL`` (f32, two backends), ``timed_run`` returns tpulab's keys,
and the bound device inputs are written in place (the buffers a CUDA
graph reads).

On the card (``cuda`` marker; skipped without one; the card's machine
has no JAX, so the reference imports are optional and only these run:
``python -m pytest --noconftest -m cuda tests/test_torch_workspace.py``):
the captured graph's replay is bit-identical to the eager bucket program
for a ResNet-50 W8 / W8A8 and an imported ONNX graph, new inputs copied
into the bound buffers replay correctly, the host mirrors are
page-locked, and a forward that cannot be captured raises.
"""

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax

    from tpulab.engine import StaticSingleModelGraphWorkspace as JaxStatic
    from tpulab.engine import TimedBenchmarkWorkspace as JaxTimed
    from tpulab.models.mnist import make_mnist as jax_make_mnist
except ImportError:
    jax = None
from tpulab_torch.engine import (BenchmarkWorkspace, Runtime,
                                 StaticSingleModelGraphWorkspace,
                                 TimedBenchmarkWorkspace)
from tpulab_torch.engine.model import IOSpec, Model
from tpulab_torch.models.mnist import make_mnist

torch.set_num_threads(2)

TOL = 1e-5
OUT = "Plus214_Output_0"
KEYS = {"h2d_ms", "compute_ms", "d2h_ms", "total_ms"}


@pytest.fixture(scope="module")
def pair():
    from tpulab_torch.models.convert import tree_from_numpy

    jm = jax_make_mnist(max_batch_size=2, seed=5)
    tree = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                           "cpu")
    return jm, make_mnist(max_batch_size=2, params=tree)


def test_static_workspace_enqueue(pair):
    jm, pm = pair
    ws = StaticSingleModelGraphWorkspace(pm, batch_size=2, device="cpu")
    jws = JaxStatic(jm, batch_size=2)
    assert ws.bucket == jws.bucket == 2 and ws.graph is None
    out = ws.enqueue()
    ws.synchronize()
    want = np.asarray(jws.enqueue()[OUT])
    assert out[OUT].shape == (2, 10)
    np.testing.assert_allclose(out[OUT].numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_timed_workspace_stages(pair, batch):
    jm, pm = pair
    ws = TimedBenchmarkWorkspace(pm, batch_size=batch, device="cpu")
    jws = JaxTimed(jm, batch_size=batch)
    x = np.random.default_rng(batch).standard_normal(
        ws.host_inputs["Input3"].shape).astype(np.float32)
    ws.host_inputs["Input3"][:] = x
    jws.host_inputs["Input3"][:] = x
    bound = ws.device_inputs["Input3"]
    t = ws.timed_run()
    jt = jws.timed_run()
    assert set(t) == set(jt) == KEYS
    assert t["total_ms"] > 0
    assert ws.device_inputs["Input3"] is bound          # written in place
    assert torch.equal(bound, torch.from_numpy(x))
    np.testing.assert_allclose(ws.host_outputs[OUT], jws.host_outputs[OUT],
                               rtol=TOL, atol=TOL)


def test_benchmark_workspace_run_is_the_bucket_program(pair):
    """``run`` (copy in, enqueue, copy out) leaves the bucket program's
    outputs in the host mirrors, bit for bit, and reuses its buffers."""
    _, pm = pair
    compiled = Runtime("cpu").compile_model(pm, buckets=[2])
    ws = BenchmarkWorkspace(pm, batch_size=2, compiled=compiled)
    for seed in (0, 1):
        x = np.random.default_rng(seed).standard_normal(
            (2, 28, 28, 1)).astype(np.float32)
        ws.host_inputs["Input3"][:] = x
        ws.run()
        want = compiled(2, {"Input3": torch.from_numpy(x)})[OUT]
        assert np.array_equal(ws.host_outputs[OUT], want.numpy())


def test_batch_beyond_the_largest_bucket_raises(pair):
    _, pm = pair
    with pytest.raises(ValueError, match="exceeds max_batch_size"):
        StaticSingleModelGraphWorkspace(pm, batch_size=3, device="cpu")


# ------------------------------------------------------------------ card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _resnet_int8(mode):
    from tpulab_torch.models import build_model
    from tpulab_torch.models.quantization import (calibrate_resnet,
                                                  quantize_resnet_params_w8a8)
    m = build_model("resnet50_int8", image_size=64, max_batch_size=8)
    if mode == "w8a8":
        from tpulab_torch.models.resnet import init_resnet_params
        f32 = init_resnet_params(50, seed=0)
        x = torch.randn(2, 64, 64, 3, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        m.params = quantize_resnet_params_w8a8(f32, calibrate_resnet(f32,
                                                                     [x]))
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_cuda_graph_replay_is_bit_identical_to_eager(mode):
    _needs_card()
    m = _resnet_int8(mode)
    compiled = Runtime().compile_model(m, buckets=[8])
    ws = TimedBenchmarkWorkspace(m, batch_size=8, compiled=compiled)
    assert ws.graph is not None
    assert all(t.is_pinned() for t in ws.host_input_tensors.values())
    g = torch.Generator().manual_seed(1)
    for _ in range(2):                   # new inputs into the bound buffers
        x = torch.randn(8, 64, 64, 3, generator=g)
        ws.host_input_tensors["input"].copy_(x)
        t = ws.timed_run()
        assert set(t) == KEYS and t["compute_ms"] > 0
        with torch.inference_mode():
            want = compiled(8, {"input": x.cuda()})["logits"].cpu()
        assert torch.equal(torch.from_numpy(ws.host_outputs["logits"]),
                           want)


@pytest.mark.cuda
def test_cuda_graph_replays_an_imported_onnx_graph(tmp_path):
    _needs_card()
    import torch_onnx_util as ou

    from tpulab_torch.models.onnx_import import load_onnx_model

    data, _ = ou.resnet50_graph(3, 10, 32)
    path = tmp_path / "rn50.onnx"
    path.write_bytes(data)
    m = load_onnx_model(str(path), max_batch_size=4)
    ws = StaticSingleModelGraphWorkspace(m, batch_size=4)
    x = torch.randn(4, 3, 32, 32, device="cuda")
    ws.device_inputs["input"].copy_(x)
    out = ws.enqueue()["logits"].clone()
    ws.synchronize()
    with torch.inference_mode():
        want = ws._compiled(4, {"input": x})["logits"]
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_capture_failure_raises_without_fallback():
    _needs_card()

    def apply_fn(params, inputs):           # a host read: not capturable
        x = inputs["x"]
        return {"y": x * float(x.sum())}

    m = Model("syncs", apply_fn, {}, [IOSpec("x", (4,))],
              [IOSpec("y", (4,))], max_batch_size=2)
    with pytest.raises(RuntimeError):
        StaticSingleModelGraphWorkspace(m, batch_size=2)
