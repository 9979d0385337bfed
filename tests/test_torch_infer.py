"""The port's compiled-model Infer path on the CPU, held against tpulab's.

MNIST serves through both packages on the same weights (tpulab's seeded
tree bridged with ``tree_from_numpy``) and the same inputs: the port's
``InferenceManager`` / ``InferRunner`` / ``BatchedInferRunner`` /
``InferBench`` against tpulab's.  Tolerance: outputs within ``TOL``
(f32; the two backends sum in different orders).  Within the port,
bucket padding leaves a request's rows bit-identical to the bucket's
direct forward.

Also: the staging ``Bindings`` contract, the two-level acquisition and
its backpressure, every pool slot and token back after concurrent
saturation and after failed dispatches (tpulab's
``test_failed_dispatch_does_not_strand_token``), a failed forward
reaching the future, the registry, the top-level API without grpc, the
host pieces (pools, thread pools, the deferred task pool, the event
poller, tree transfers), and no CPU fallback for ``device=None``.

One ``cuda`` test serves MNIST on the card under concurrency against the
CPU manager; it skips without a card.  The card's machine has no JAX, so
the reference imports are optional there and only that test runs:
``python -m pytest --noconftest -m cuda tests/test_torch_infer.py``.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tpulab_torch

try:            # the reference; absent on the card's machine
    import jax

    from tpulab.engine import InferBench as JaxBench
    from tpulab.engine import InferenceManager as JaxManager
    from tpulab.engine.batched_runner import BatchedInferRunner as JaxBatched
    from tpulab.models import registry as jregistry
    from tpulab.models.mnist import make_mnist as jax_make_mnist
except ImportError:
    jax = jregistry = None
from tpulab_torch import chaos
from tpulab_torch.core.async_compute import async_compute
from tpulab_torch.core.pool import Pool
from tpulab_torch.core.task_pool import DeferredShortTaskPool
from tpulab_torch.core.thread_pool import ThreadPool
from tpulab_torch.cuda.sync import EventPoller
from tpulab_torch.cuda.transfer import TransferEngine
from tpulab_torch.engine import execution_context as ec
from tpulab_torch.engine.batched_runner import BatchedInferRunner
from tpulab_torch.engine.buffers import Buffers
from tpulab_torch.engine.infer_bench import InferBench
from tpulab_torch.engine.inference_manager import InferenceManager
from tpulab_torch.engine.model import Model, default_batch_buckets
from tpulab_torch.models import available_models, build_model
from tpulab_torch.models.convert import tree_from_numpy
from tpulab_torch.models.mnist import make_mnist

torch.set_num_threads(2)

TOL = 1e-5
OUT = "Plus214_Output_0"
ROOT = Path(__file__).resolve().parents[1]


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 28, 28, 1)).astype(np.float32)


def _wait_home(mgr, name, timeout=10.0):
    """Every buffers slot, token and context back in its pool (the post
    stage returns them just after it settles the future)."""
    pools = (mgr.buffers_pool, mgr.exec_tokens, mgr.context_pool(name))
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(p.available == p.size for p in pools):
            return
        time.sleep(0.01)
    raise AssertionError([(p.available, p.size) for p in pools])


@pytest.fixture(scope="module")
def pair():
    """tpulab's manager and the port's, on one MNIST weight set."""
    jmodel = jax_make_mnist(max_batch_size=8, seed=3)
    jmgr = JaxManager(max_executions=2)
    jmgr.register_model("mnist", jmodel)
    jmgr.update_resources()
    tree = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jmodel.params),
                           "cpu")
    mgr = InferenceManager(max_executions=2, device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=8, params=tree))
    mgr.update_resources()
    yield jmgr, mgr
    mgr.shutdown()
    jmgr.shutdown()


# ------------------------------------------------------------ pipeline
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_infer_runner_matches_tpulab(pair, batch):
    jmgr, mgr = pair
    x = _images(batch, batch)
    want = jmgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
    got = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
    assert got.shape == want.shape == (batch, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the padded bucket's own forward gives the same rows, bit for bit
    bucket = mgr.model("mnist").pick_bucket(batch)
    padded = np.zeros((bucket, 28, 28, 1), np.float32)
    padded[:batch] = x
    direct = mgr.compiled("mnist")(bucket, {"Input3": torch.from_numpy(
        padded)})[OUT][:batch].numpy()
    np.testing.assert_array_equal(got, direct)


def test_model_introspection_matches_tpulab(pair):
    jmgr, mgr = pair
    jm, m = jmgr.model("mnist"), mgr.model("mnist")
    assert default_batch_buckets(6) == [1, 2, 4, 6]
    assert m.batch_buckets == jm.batch_buckets == [1, 2, 4, 8]
    assert m.binding_names == jm.binding_names
    for b in (1, 3, 8):
        assert m.pick_bucket(b) == jm.pick_bucket(b)
        assert m.bindings_size_in_bytes(b) == jm.bindings_size_in_bytes(b)
    assert m.weights_size_in_bytes() == jm.weights_size_in_bytes()
    with pytest.raises(ValueError):
        m.pick_bucket(9)


def test_compiled_model_flops_and_artifacts(pair):
    _, mgr = pair
    c = mgr.compiled("mnist")
    conv = 2 * 28 * 28 * 25 * 8 + 2 * 14 * 14 * 25 * 8 * 16
    fc = 2 * 784 * 10
    assert c.flops(1) == conv + fc
    assert c.flops(8) == 8 * (conv + fc)
    assert c.activation_size_in_bytes() == 0        # the CPU: no statistics
    with pytest.raises(NotImplementedError, match="engine artifacts"):
        c.memory_analysis()
    with pytest.raises(NotImplementedError, match="item 6"):
        mgr.register_engine("x", "/nonexistent")


def test_two_level_acquisition(pair):
    _, mgr = pair
    with mgr.get_execution_context("mnist") as ctx:
        assert ctx.model.name == "mnist" and ctx.stream is None
    held = [mgr.get_execution_context("mnist") for _ in range(2)]
    assert mgr.exec_tokens.available == 0
    with pytest.raises(TimeoutError):                # backpressure
        mgr.get_execution_context("mnist", timeout=0.05)
    assert mgr.exec_tokens.available == 0            # no token leaked
    for h in held:
        h.release()
        h.release()                                  # idempotent
    _wait_home(mgr, "mnist")


def test_concurrent_saturation_returns_every_slot(pair):
    jmgr, mgr = pair
    runner = mgr.infer_runner("mnist")
    xs = [_images(1 + i % 3, 100 + i) for i in range(8)]
    futs = []
    lock = threading.Lock()

    def client(i):
        for j in range(4):
            f = runner.infer(Input3=xs[(i + j) % 8])
            with lock:
                futs.append(((i + j) % 8, f))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    want = [jmgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
            for x in xs]
    assert len(futs) == 32
    for k, f in futs:
        np.testing.assert_allclose(f.result(60)[OUT], want[k], rtol=TOL,
                                   atol=TOL)
    _wait_home(mgr, "mnist")


def test_post_fn(pair):
    _, mgr = pair
    x = _images(2, 7)
    fut = mgr.infer_runner("mnist").infer(
        post_fn=lambda b: b.outputs()[OUT].argmax(-1).tolist(), Input3=x)
    direct = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
    assert fut.result(60) == direct.argmax(-1).tolist()


def test_unknown_model_raises(pair):
    _, mgr = pair
    with pytest.raises(KeyError):
        mgr.infer_runner("nope")


def test_manager_requires_allocation():
    mgr = InferenceManager(device="cpu")
    mgr.register_model("m", make_mnist(max_batch_size=1, device="cpu"))
    with pytest.raises(RuntimeError):
        mgr.get_buffers()
    with pytest.raises(RuntimeError):
        mgr.infer_runner("m").infer(Input3=np.zeros((1, 28, 28, 1),
                                                    np.float32))
    with pytest.raises(RuntimeError):
        InferenceManager(device="cpu").update_resources()    # no models
    with pytest.raises(NotImplementedError, match="coalescing"):
        InferenceManager(device="cpu", coalesce_h2d=True)
    mgr.shutdown()


@pytest.fixture()
def one_slot():
    mgr = InferenceManager(max_executions=1, device="cpu")
    mgr.register_model("m", make_mnist(max_batch_size=1, device="cpu"))
    mgr.update_resources()
    yield mgr
    mgr.shutdown()


def test_failed_dispatch_does_not_strand_token(one_slot, monkeypatch):
    """tpulab's test: a dispatch-stage error returns the execution token
    (and the buffers slot); a healthy request then succeeds."""
    runner = one_slot.infer_runner("m")
    x = np.zeros((1, 28, 28, 1), np.float32)

    def boom(self, di, b, after=None):
        raise RuntimeError("injected")

    with monkeypatch.context() as mp:
        mp.setattr(ec.ExecutionContext, "infer", boom)
        for _ in range(3):                   # more than the one token
            with pytest.raises(RuntimeError, match="injected"):
                runner.infer(Input3=x).result(30)
    _wait_home(one_slot, "m")
    assert runner.infer(Input3=x).result(30)[OUT].shape == (1, 10)


def test_transfer_fault_returns_the_buffers(one_slot):
    runner = one_slot.infer_runner("m")
    x = np.zeros((1, 28, 28, 1), np.float32)
    with chaos.inject("device.transfer=error+2") as sched:
        for _ in range(2):
            with pytest.raises(chaos.ChaosError):
                runner.infer(Input3=x).result(30)
        assert sched.fired("device.transfer") == 2
        assert runner.infer(Input3=x).result(30)[OUT].shape == (1, 10)
    _wait_home(one_slot, "m")


def test_failed_forward_reaches_the_future():
    """An apply_fn that fails at compute time: the caller's future gets
    the exception, every slot and token comes home."""
    def apply_fn(params, inputs):
        x = inputs["x"]
        if float(x.sum()) < 0:
            raise FloatingPointError("negative input")
        return {"y": x * params["w"]}

    from tpulab_torch.engine.model import IOSpec
    model = Model("neg", apply_fn, {"w": torch.tensor(2.0)},
                  [IOSpec("x", (3,))], [IOSpec("y", (3,))], max_batch_size=2)
    mgr = InferenceManager(max_executions=1, device="cpu")
    mgr.register_model("neg", model)
    mgr.update_resources()
    try:
        runner = mgr.infer_runner("neg")
        bad = runner.infer(x=-np.ones((2, 3), np.float32))
        with pytest.raises(FloatingPointError):
            bad.result(30)
        ok = runner.infer(x=np.ones((1, 3), np.float32)).result(30)
        np.testing.assert_array_equal(ok["y"], np.full((1, 3), 2.0))
        _wait_home(mgr, "neg")
    finally:
        mgr.shutdown()


def test_bindings_carve_fill_roundtrip():
    m = make_mnist(max_batch_size=4, device="cpu")
    buffers = Buffers(m.bindings_size_in_bytes() + 128 * 1024, device="cpu")
    b = buffers.create_bindings(m, batch_size=3)
    assert b.bucket == 4
    data = _images(3, 1)
    b.set_input("Input3", data)
    np.testing.assert_array_equal(b.host_inputs["Input3"][:3], data)
    assert (b.host_inputs["Input3"][3:] == 0).all()     # deterministic pad
    for t in (*b.host_input_tensors.values(), *b.host_output_tensors.values()):
        assert t.data_ptr() % 64 == 0
    with pytest.raises(ValueError):
        b.set_input("Input3", data[:2])                  # batch mismatch
    with pytest.raises(TypeError):
        b.set_input("Input3", data.astype(np.float64))   # no implicit cast
    with pytest.raises(KeyError):
        b.set_input(OUT, data)                           # not an input
    b.copy_to_device()
    assert b.device_inputs["Input3"].data_ptr() == \
        b.host_input_tensors["Input3"].data_ptr()        # the CPU: no copy
    buffers.reset()
    with pytest.raises(MemoryError):
        Buffers(1024, device="cpu").create_bindings(m, batch_size=4)


def test_batched_runner_coalesces_like_tpulab(pair):
    jmgr, mgr = pair
    xs = [_images(1, 200 + i) for i in range(16)]
    ours = BatchedInferRunner(mgr, "mnist", window_s=0.05)
    theirs = JaxBatched(jmgr, "mnist", window_s=0.05)
    try:
        got = [ours.infer(Input3=x) for x in xs]
        want = [theirs.infer(Input3=x) for x in xs]
        got = [f.result(60)[OUT] for f in got]
        want = [f.result(60)[OUT] for f in want]
    finally:
        ours.shutdown()
        theirs.shutdown()
    assert 1 <= ours.batches_launched < len(xs)
    for g, w, x in zip(got, want, xs):
        assert g.shape == (1, 10)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        alone = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
        np.testing.assert_allclose(g, alone, rtol=TOL, atol=TOL)
    _wait_home(mgr, "mnist")


def test_infer_bench_has_tpulab_keys(pair):
    jmgr, mgr = pair
    res = InferBench(mgr).run("mnist", batch_size=2, seconds=0.2, warmup=2)
    jres = JaxBench(jmgr).run("mnist", batch_size=2, seconds=0.2, warmup=2)
    assert set(res) == set(jres)
    assert res["inferences_per_second"] > 0 and res["batches_computed"] >= 1
    lat = InferBench(mgr).latency("mnist", batch_size=1, iterations=10)
    jlat = JaxBench(jmgr).latency("mnist", batch_size=1, iterations=10)
    assert set(lat) == set(jlat)
    assert lat["p99_ms"] >= lat["p50_ms"] > 0
    _wait_home(mgr, "mnist")


# -------------------------------------------------------------- registry
def test_registry_covers_tpulab_names():
    assert available_models() == jregistry.available_models()


@pytest.mark.parametrize("name", [] if jregistry is None else [
    n for n in jregistry.available_models()
    if n not in ("resnet50_int8", "onnx")])
def test_registry_builds(name):
    """Every name builds its Model (the image models over a stand-in tree:
    drawing ViT-L's weights here would cost seconds and a gigabyte)."""
    if name.startswith(("resnet", "vit")):
        m = build_model(name, params={"stand": "in"}, max_batch_size=2,
                        input_dtype=np.uint8)
        assert m.inputs[0].shape == (224, 224, 3)
        assert m.inputs[0].np_dtype == np.uint8
        assert m.outputs[0].shape == (1000,) and m.place_fn is not None
    elif name.startswith("transformer"):
        m = build_model(name, vocab=64, d_model=32, n_heads=4, n_layers=1,
                        d_ff=64, seq_len=8, device="cpu")
        assert m.outputs[0].shape == (8, 64)
        out = m.apply_fn(m.params, {"tokens": torch.zeros((1, 8),
                                                          dtype=torch.int32)})
        assert out["logits"].shape == (1, 8, 64)
        if name == "transformer_int8":
            assert m.params["layer0"]["wqkv"]["w_int8"].dtype == torch.int8
    else:
        m = build_model(name, max_batch_size=2, device="cpu")
        assert m.max_batch_size == 2
    assert m.name == name
    with pytest.raises(KeyError):
        build_model("nope")


@pytest.mark.parametrize("name,item", [
    ("resnet50_int8", "models/quantization.py"),
    ("onnx", "models/onnx_import.py")])
def test_unported_registry_entries_raise(name, item):
    with pytest.raises(NotImplementedError, match=f"item 6: .*{item}"):
        build_model(name)


def test_top_level_api_without_grpc():
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=3,
                                        device="cpu")
    assert mgr.max_executions == 3 and mgr.max_buffers == 6
    for call in (mgr.serve, mgr.drain, tpulab_torch.RemoteInferenceManager,
                 lambda: tpulab_torch.serve(mgr)):
        with pytest.raises(NotImplementedError, match="item 3"):
            call()
    code = ("import json, sys, tpulab_torch\n"
            "from tpulab_torch.models import build_model\n"
            "import tpulab_torch.engine.infer_runner, "
            "tpulab_torch.engine.batched_runner, "
            "tpulab_torch.engine.infer_bench, tpulab_torch.models.vit\n"
            "tpulab_torch.InferenceManager\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m == "grpc" or m.startswith("grpc.")
                or m.startswith("google.protobuf")]


def test_no_cpu_fallback_for_the_card():
    """``device=None`` is the card: without one the manager and the
    runtime raise instead of serving from the CPU."""
    if torch.cuda.is_available():
        assert InferenceManager().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceManager()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpulab_torch.InferenceManager(max_exec_concurrency=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("mnist")


# ----------------------------------------------------------- host pieces
def test_pool_backpressure_and_return_hook():
    returned = []
    pool = Pool(range(2), on_return=returned.append)
    a, b = pool.pop(), pool.pop()
    with pytest.raises(TimeoutError):
        pool.pop(timeout=0.02)
    a.release()
    a.release()                                       # idempotent
    assert returned == [0]
    with pytest.raises(RuntimeError):
        a.get()
    c = pool.pop(timeout=1)
    assert pool.available == 0 and pool.size == 2
    b.release()
    c.release()
    assert pool.available == 2 and len(returned) == 3


def test_pool_pop_async():
    import asyncio

    pool = Pool([7])

    async def main():
        first = await pool.pop_async()
        waiter = asyncio.ensure_future(pool.pop_async())
        await asyncio.sleep(0.01)
        assert not waiter.done()
        first.release()
        second = await asyncio.wait_for(waiter, 5)
        return second.get()

    assert asyncio.run(main()) == 7


def test_thread_pool_and_packaged_task():
    with ThreadPool(2, name="t") as tp:
        assert tp.enqueue(lambda a, b: a + b, 2, 3).result(5) == 5
        with pytest.raises(ZeroDivisionError):
            tp.enqueue(lambda: 1 / 0).result(5)
    with pytest.raises(RuntimeError):
        tp.enqueue(print)
    task = async_compute(lambda x: x * 2)
    task(21)
    assert task.get_future().result(0) == 42
    with pytest.raises(RuntimeError):
        task(1)


def test_thread_pool_pins_one_worker_per_cpu():
    import os

    from tpulab_torch.core.affinity import CpuSet

    cpu = sorted(os.sched_getaffinity(0))[0]
    with ThreadPool.one_per_cpu(CpuSet([cpu]), name="pinned") as tp:
        assert tp.size == 1
        assert tp.enqueue(os.sched_getaffinity, 0).result(5) == {cpu}
    with pytest.raises(ValueError):
        ThreadPool.one_per_cpu(CpuSet())


def test_deferred_task_pool_runs_by_deadline():
    order = []
    done = threading.Event()
    with DeferredShortTaskPool() as pool:
        pool.enqueue_deferred(0.06, lambda: (order.append("late"),
                                             done.set()))
        pool.enqueue_deferred(0.0, lambda: order.append("now"))
        assert done.wait(5)
    assert order == ["now", "late"]


def test_event_poller_fires_and_drains():
    fired = threading.Event()
    poller = EventPoller()
    poller.watch(None, fired.set)                     # CPU work: done
    assert fired.wait(5)
    poller.shutdown()
    with pytest.raises(RuntimeError):
        poller.watch(None, fired.set)


def test_transfer_engine_moves_trees():
    eng = TransferEngine(name="t")
    try:
        tree = {"a": torch.arange(6.0).reshape(2, 3),
                "b": {"c": torch.ones(2, dtype=torch.int32),
                      "d": torch.zeros(1)}}
        got = eng.fetch_sync(tree, timeout=10)
        assert set(got) == {"a", "b"} and set(got["b"]) == {"c", "d"}
        assert torch.equal(got["a"], tree["a"])
        assert got["a"].data_ptr() != tree["a"].data_ptr()
        out = {"a": torch.empty(2, 3),
               "b": {"c": torch.empty(2, dtype=torch.int32),
                     "d": torch.empty(1)}}
        landed = eng.fetch(tree, out=out).result(10)
        assert landed["a"] is out["a"] and torch.equal(out["a"], tree["a"])
        assert torch.equal(out["b"]["c"], tree["b"]["c"])
        put = eng.put(tree, "cpu").result(10)
        assert torch.equal(put["b"]["c"], tree["b"]["c"])
        with pytest.raises(TypeError):
            eng.fetch([tree["a"]])
        assert torch.equal(eng.fetch(tree["a"]).result(10), tree["a"])
    finally:
        eng.shutdown()


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_cuda_manager_matches_cpu_and_returns_every_slot():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tree = make_mnist(max_batch_size=8, device="cpu").params
    cpu = InferenceManager(max_executions=2, device="cpu")
    gpu = InferenceManager(max_executions=4)
    for m in (cpu, gpu):
        m.register_model("mnist", make_mnist(max_batch_size=8, params=tree))
        m.update_resources()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    # an f32 check: full f32 convolutions and products on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xs = [_images(1 + i % 8, 300 + i) for i in range(64)]
        futs = [gpu.infer_runner("mnist").infer(Input3=x) for x in xs]
        for x, f in zip(xs, futs):
            want = cpu.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
            np.testing.assert_allclose(f.result(60)[OUT], want, rtol=1e-4,
                                       atol=1e-4)
        _wait_home(gpu, "mnist")
        assert gpu.compiled("mnist").activation_size_in_bytes() > 0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        gpu.shutdown()
        cpu.shutdown()
