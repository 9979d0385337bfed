"""tpulab's example ladder on the port, on the CPU: one twin for each case
of ``tests/test_examples.py`` that ``tpulab_torch.examples`` reaches, plus
the checkpoint parity of the LLM server and the examples tpulab's file
leaves untested.

Every port module runs as ``python -m tpulab_torch.examples.<name>
--device cpu`` (or in process where tpulab's case does so).  Where the
outputs can be compared, tpulab's script runs beside it:

- ``ex07_llm_server`` and tpulab's ``07_llm_server.py`` serve one
  ``--checkpoint`` that the test writes (an HF-named state dict of seeded
  f32 weights) at ex07's defaults (bf16 compute), and one greedy request
  through each server's own client mode gives the same tokens;
- ``ex13_onnx_serving`` and ``13_onnx_serving.py`` read one ONNX file and
  one ``test_data_set_0`` the test writes, and both pass their golden
  check over the wire;
- elsewhere the printed checks, keys and counters are held equal.

Each subprocess has its own time limit, as tpulab's cases have.
"""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tests.conftest import free_port

REPO = __file__.rsplit("/tests/", 1)[0]
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_onnx_util import model_bytes, node, tensor  # noqa: E402

#: the port's subprocesses: the repo on the path, two threads each (the
#: suite runs in several workers at once)
ENV = {"PYTHONPATH": REPO, "PATH": "/usr/bin:/bin", "HOME": "/tmp",
       "OMP_NUM_THREADS": "2"}
#: tpulab's, as tests/test_examples.py sets them
JAX_ENV = {"PYTHONPATH": REPO, "PATH": "/usr/bin:/bin", "HOME": "/tmp",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
           "TPULAB_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu"}


def _port(module, *args, timeout=300):
    out = subprocess.run(
        [sys.executable, "-m", f"tpulab_torch.examples.{module}", *args],
        capture_output=True, text=True, timeout=timeout, env=ENV, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _jax_script(path, *args, timeout=300):
    out = subprocess.run([sys.executable, f"{REPO}/{path}", *args],
                         capture_output=True, text=True, timeout=timeout,
                         env=JAX_ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _jax_runpy(path, timeout=300):
    out = subprocess.run(
        [sys.executable, "-c",
         "from tpulab.tpu.platform import force_cpu; force_cpu(1);"
         f"import runpy; runpy.run_path('{REPO}/{path}', "
         "run_name='__main__')"],
        capture_output=True, text=True, timeout=timeout, env=JAX_ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_30_python_api_quickstart():
    got = _port("ex30_python_api", "--device", "cpu")
    assert "remote == local: OK" in got
    assert got.splitlines() == _jax_runpy(
        "examples/30_python_api.py").splitlines()


# -- ONNX: one file and one test vector set for both packages ------------------
@pytest.fixture
def zoo(tmp_path):
    """``model.onnx`` (Input3 (1, 784) -> MatMul -> Add -> Relu -> MatMul
    -> Plus214_Output_0 (1, 10), seeded f32 weights) and
    ``test_data_set_0`` with its input and numpy's output, in the zoo's
    layout."""
    rng = np.random.default_rng(13)
    w1 = (rng.standard_normal((784, 32)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((32, 10)) * 0.2).astype(np.float32)
    nodes = [node("MatMul", ["Input3", "w1"], ["h"]),
             node("Add", ["h", "b1"], ["hb"]),
             node("Relu", ["hb"], ["r"]),
             node("MatMul", ["r", "w2"], ["Plus214_Output_0"])]
    d = tmp_path / "zoo"
    (d / "test_data_set_0").mkdir(parents=True)
    (d / "model.onnx").write_bytes(model_bytes(
        nodes, {"w1": w1, "b1": b1, "w2": w2}, [("Input3", [1, 784])],
        [("Plus214_Output_0", [1, 10])]))
    x = rng.random((1, 784)).astype(np.float32)
    y = np.maximum(x @ w1 + b1, 0) @ w2
    (d / "test_data_set_0" / "input_0.pb").write_bytes(tensor("Input3", x))
    (d / "test_data_set_0" / "output_0.pb").write_bytes(
        tensor("Plus214_Output_0", y.astype(np.float32)))
    return d


def test_13_onnx_serving_example(zoo, tmp_path):
    """ONNX import -> engine artifact -> serve -> golden check over the
    wire, on the file both packages read."""
    args = ["--onnx", str(zoo / "model.onnx"), "--data",
            str(zoo / "test_data_set_0")]
    got = _port("ex13_onnx_serving", "--device", "cpu", *args,
                "--engine-dir", str(tmp_path / "eng"))
    want = _jax_script("examples/13_onnx_serving.py", "--cpu", *args,
                       "--engine-dir", str(tmp_path / "jeng"))
    for out in (got, want):
        assert "golden check vs 1 output vector(s): OK" in out
        assert "engine artifact reloaded (portable path)" in out
    assert os.listdir(tmp_path / "eng")


def test_notebook_onnx_import(zoo):
    """The ONNX-import walkthrough over the written zoo directory (golden
    check, int8, portable artifact reload inside)."""
    out = _port("notebooks.onnx_import", "--device", "cpu", "--zoo",
                str(zoo))
    assert "golden check vs bundled vectors: OK" in out
    assert "served rows match the golden vector: OK" in out
    assert "portable artifact reload: OK" in out
    assert "notebook complete" in out


# -- the RPC framework in process -------------------------------------------------
def test_01_echo_service_loopback():
    from tpulab_torch.examples import ex01_basic_grpc as mod
    from tpulab_torch.rpc import ClientExecutor, ClientUnary, Executor, Server
    from tpulab_torch.rpc.server import AsyncService
    server = Server("127.0.0.1:0", Executor(n_threads=2))
    svc = AsyncService(mod.SERVICE)
    svc.register_rpc("Echo", mod.EchoContext)
    server.register_async_service(svc)
    server.async_start()
    server.wait_until_running()
    try:
        with ClientExecutor(f"127.0.0.1:{server.bound_port}") as cx:
            unary = ClientUnary(cx, f"/{mod.SERVICE}/Echo")
            assert unary.call(b"ping", timeout=10) == b"ping"
    finally:
        server.shutdown()


def test_01_echo_server_and_clients_as_processes():
    port = free_port()
    srv = subprocess.Popen(
        [sys.executable, "-m", "tpulab_torch.examples.ex01_basic_grpc",
         "server", "--port", str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=ENV, cwd=REPO)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            out = subprocess.run(
                [sys.executable, "-m", "tpulab_torch.examples.ex01_basic_grpc",
                 "client", "--port", str(port), "-n", "10"],
                capture_output=True, text=True, timeout=60, env=ENV,
                cwd=REPO)
            if out.returncode == 0:
                break
            time.sleep(1)
        assert "10/10 echoes verified" in out.stdout, out.stderr[-2000:]
        assert "20/20 echoes verified" in _port(
            "ex01_basic_grpc", "async-client", "--port", str(port), "-n",
            "20", timeout=60)
    finally:
        srv.kill()
        srv.wait(timeout=30)


def test_03_middleman_batches_to_backend():
    """client -> middleman (aggregating) -> backend service."""
    import tpulab_torch
    from tpulab_torch.examples import ex03_batching_middleman as mod
    from tpulab_torch.models.mnist import make_mnist
    from tpulab_torch.rpc import AsyncService, Executor, Server
    from tpulab_torch.rpc.infer_service import SERVICE_NAME
    from tpulab_torch.rpc.protos import inference_pb2 as pb

    backend = tpulab_torch.InferenceManager(max_exec_concurrency=2,
                                            device="cpu")
    backend.register_model("mnist", make_mnist(max_batch_size=8,
                                               device="cpu"))
    backend.update_resources()
    backend.serve(port=0)

    forwarder = mod.BatchingForwarder(
        f"localhost:{backend.server.bound_port}", max_batch=8, window_s=0.02)

    class ForwardContext(mod.Context):
        def execute_rpc(self, request):
            return forwarder.infer(request)

    mm = Server("127.0.0.1:0", Executor(n_threads=8))
    svc = AsyncService(SERVICE_NAME)
    svc.register_rpc("Infer", ForwardContext, pb.InferRequest.FromString,
                     pb.InferResponse.SerializeToString)
    mm.register_async_service(svc)
    mm.async_start()
    mm.wait_until_running()
    try:
        from tpulab_torch.rpc.client import ClientExecutor, ClientUnary
        from tpulab_torch.rpc.infer_service import (proto_to_tensor,
                                                    tensor_to_proto)
        with ClientExecutor(f"127.0.0.1:{mm.bound_port}") as cx:
            infer = ClientUnary(cx, f"/{SERVICE_NAME}/Infer",
                                pb.InferRequest.SerializeToString,
                                pb.InferResponse.FromString)
            x = np.zeros((1, 28, 28, 1), np.float32)
            req = pb.InferRequest(model_name="mnist", batch_size=1)
            req.inputs.append(tensor_to_proto("Input3", x))
            futs = [infer.start(req) for _ in range(8)]
            resps = [f.result(timeout=60) for f in futs]
            assert all(r.status.code == pb.SUCCESS for r in resps)
            out = proto_to_tensor(resps[0].outputs[0])
            assert out.shape == (1, 10)
            want = backend.infer_runner("mnist").infer(Input3=x).result(60)
            np.testing.assert_allclose(out, want["Plus214_Output_0"],
                                       rtol=1e-6)
    finally:
        forwarder.shutdown()
        mm.shutdown()
        backend.shutdown()


# -- notebooks ----------------------------------------------------------------------
def test_notebook_multiple_models():
    out = _port("notebooks.multiple_models", "--device", "cpu")
    assert "models: ['big', 'small']" in out
    assert "16 inferences in" in out
    assert "remote == local for both models" in out


def test_notebook_quickstart():
    out = _port("notebooks.quickstart", "--device", "cpu")
    assert "remote == local" in out and "inferences_per_second" in out


def test_notebook_llm_serving():
    """The LLM-serving tour runs end to end (continuous batching, prefix
    cache, streaming, speculative decoding)."""
    out = _port("notebooks.llm_serving", "--device", "cpu")
    assert "streamed as decoded" in out
    m = re.search(r"prefix cache: (\d+) page hits, (\d+) misses", out)
    assert m and int(m.group(1)) > 0
    assert re.search(r"speculative: 16 tokens in \d+ verify rounds", out)
    assert out.strip().endswith("done")


def test_notebook_scale_out_serving():
    out = _port("notebooks.scale_out_serving", "--device", "cpu",
                timeout=420)
    assert "split per replica" in out and "3 repeats served" in out
    assert "scale-out serving tour complete" in out


# -- metrics --------------------------------------------------------------------------
def test_grafana_dashboard_matches_exported_metrics():
    """Every series the deploy dashboard queries is exported by the
    port's metric sets (the dashboard is shared with tpulab)."""
    from tpulab_torch.utils.metrics import (GenerationMetrics,
                                            InferenceMetrics,
                                            ReplicaSetMetrics)
    with open(f"{REPO}/examples/deploy/grafana-dashboard.json") as f:
        dash = json.load(f)
    exprs = [t["expr"] for p in dash["panels"] for t in p.get("targets", [])]
    wanted = set()
    for e in exprs:
        wanted.update(re.findall(r"(tpulab_[a-z0-9_]+)", e))
    m = InferenceMetrics()
    m.observe_request(0.01, 0.005)
    rm = ReplicaSetMetrics()
    rm.requests.labels(replica="x").inc()
    rm.inflight.labels(replica="x").set(0)
    rm.live.labels(replica="x").set(1)
    rm.failovers.inc()
    gm = GenerationMetrics()
    exported = set()
    for reg in (m.registry, rm.registry, gm.registry):
        for metric in reg.collect():
            for s in metric.samples:
                exported.add(s[0])
    missing = {w for w in wanted
               if w not in exported and w.removesuffix("_bucket") + "_bucket"
               not in exported}
    assert wanted and not missing, missing


# -- codecs ----------------------------------------------------------------------------
@pytest.mark.parametrize("name,line", [
    ("12_binary_codec", "binary-codec serving OK"),
    ("12_flatbuffers", "flatbuffers serving OK")])
def test_12_codec_services(name, line):
    got = _port(f"ex{name}", "--device", "cpu")
    want = _jax_script(f"examples/{name}.py", "--cpu")
    assert line in got
    assert got.splitlines() == want.splitlines()


def test_12_flatbuffers_rejects_malformed_payloads():
    """Malformed wire bytes surface as clean RPC errors and the server
    serves a good request afterwards."""
    import grpc

    import tpulab_torch
    from tpulab_torch.examples import ex12_flatbuffers as mod
    from tpulab_torch.models.mnist import make_mnist
    from tpulab_torch.rpc import ClientExecutor, ClientUnary

    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        max_buffers=2, device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=2, device="cpu"))
    mgr.update_resources()
    server = mod.build_service(mgr)
    server.async_start()
    server.wait_until_running()
    try:
        x = np.zeros((1, 28, 28, 1), np.float32)
        good = mod.encode_request("mnist", msg_id=1, Input3=x)
        with ClientExecutor(f"127.0.0.1:{server.bound_port}") as cx:
            infer = ClientUnary(cx, f"/{mod.SERVICE}/Infer",
                                request_serializer=lambda b: b,
                                response_deserializer=lambda b: b)
            for bad in (b"", b"\x00" * 4, b"garbage-not-a-flatbuffer",
                        good[: len(good) // 3]):
                with pytest.raises(grpc.RpcError) as exc_info:
                    infer.call(bad, timeout=30)
                assert (exc_info.value.code()
                        is not grpc.StatusCode.DEADLINE_EXCEEDED)
            resp = mod.InferResponseReader(infer.call(good, timeout=60))
            assert resp.tensors()["Plus214_Output_0"].shape == (1, 10)
            assert resp.id() == 1
    finally:
        server.shutdown()
        mgr.shutdown()


# -- serving CLIs -------------------------------------------------------------------
def test_99_run_lb_driver():
    out = _port("ex99_run_lb", "--replicas", "2", "-n", "40", "--device",
                "cpu", "--json", timeout=420)
    rec = json.loads(out.strip().splitlines()[-1])["lb"]
    assert rec["direct"]["inf_s"] > 0
    assert rec["replicaset"]["inf_s"] > 0
    assert sum(rec["replicaset"]["split"]) >= 40
    assert all(s > 0 for s in rec["replicaset"]["split"])
    assert "overhead_us_vs_direct" in rec["replicaset"]
    assert "skipped" in rec["envoy"] or rec["envoy"]["inf_s"] > 0


def test_06_stream_client_pipelines():
    out = _port("ex06_stream_client", "--device", "cpu", "--requests", "16")
    assert "model=mnist n=16" in out and "streamed:" in out


def test_02_inference_service_cli():
    """The serving CLI boots, serves, exports metrics, and drains on
    SIGTERM; ex02_client drives it in sync mode."""
    from tpulab_torch.rpc.infer_service import RemoteInferenceManager
    port, mport = free_port(), free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpulab_torch.examples.ex02_inference_service",
         "--device", "cpu", "--model", "mnist", "--max-batch-size", "2",
         "--port", str(port), "--metrics-port", str(mport), "--batching"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=REPO)
    try:
        deadline = time.time() + 240
        remote = None
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(
                    f"server died: {proc.communicate()[1][-2000:]}")
            candidate = RemoteInferenceManager(f"localhost:{port}")
            try:
                candidate.get_models()
                remote = candidate
                break
            except Exception:
                candidate.close()
                time.sleep(1)
        assert remote is not None, "server never came up"
        out = remote.infer_runner("mnist").infer(
            Input3=np.zeros((1, 28, 28, 1), np.float32)).result(timeout=120)
        assert out["Plus214_Output_0"].shape == (1, 10)
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{mport}/metrics", timeout=10).read().decode()
        assert "tpulab_request_total" in metrics
        remote.close()
        client = _port("ex02_client", "--target", f"localhost:{port}",
                       "--model", "mnist", "--mode", "sync", "-n", "8",
                       timeout=120)
        assert re.search(r"sync: 8 inferences in", client)
        assert "p50=" in client
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0, (rc, proc.stderr.read()[-1000:])
    assert "SIGTERM: draining" in proc.stdout.read()


# -- the LLM server ---------------------------------------------------------------------
def _spawn_llm_server(*extra_args, oneshot=True):
    return subprocess.Popen(
        [sys.executable, "-m", "tpulab_torch.examples.ex07_llm_server",
         "--device", "cpu", "--port", "0", "--max-len", "128", "--lanes",
         "2", *(["--oneshot"] if oneshot else []), *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=ENV, cwd=REPO)


def _wait_llm_port(srv, deadline_s=120.0):
    """The port from the server banner within the deadline; a pump thread
    keeps draining the merged pipe after the banner."""
    q = queue.Queue()

    def pump():
        for line in srv.stdout:
            q.put(line)

    threading.Thread(target=pump, daemon=True).start()
    seen, deadline = [], time.time() + deadline_s
    while time.time() < deadline:
        try:
            line = q.get(timeout=max(0.0, min(1.0, deadline - time.time())))
        except queue.Empty:
            if srv.poll() is not None:
                raise AssertionError("server died at startup:\n"
                                     + "".join(seen))
            continue
        seen.append(line)
        if "LLM server on :" in line:
            return line.split("LLM server on :")[1].split()[0]
    raise AssertionError("server never came up:\n" + "".join(seen))


def _client(target, *args, env=ENV, jax=False, timeout=120):
    cmd = ([sys.executable, f"{REPO}/examples/07_llm_server.py", "--cpu"]
           if jax else [sys.executable, "-m",
                        "tpulab_torch.examples.ex07_llm_server"])
    out = subprocess.run([*cmd, "--connect", target, *args],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_07_llm_server_end_to_end():
    """int8 weights + fp8 KV + prefix cache behind the Generate RPC,
    driven by its own client mode across processes."""
    srv = _spawn_llm_server("--int8", "--kv-fp8")
    try:
        port = _wait_llm_port(srv)
        out = _client(f"localhost:{port}", "--prompt", "5,6,7", "--steps",
                      "6", "--temperature", "0.7", "--seed", "3")
        toks = out.split("\n")[0].split()
        assert len(toks) == 6 and out.strip().endswith("done")
        assert srv.wait(timeout=60) == 0  # oneshot exit
    finally:
        srv.kill()


def test_07_llm_server_metrics_export():
    """--metrics-port: tpulab_llm_* series reflect real serving after a
    generation completes."""
    mport = free_port()
    srv = _spawn_llm_server("--metrics-port", str(mport), oneshot=False)
    try:
        port = _wait_llm_port(srv)
        _client(f"localhost:{port}", "--prompt", "5,6,7", "--steps", "6")
        deadline = time.time() + 30  # the poller samples every 2 s
        body = ""
        while time.time() < deadline:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/metrics", timeout=10
            ).read().decode()
            if ("tpulab_llm_tokens_total 6.0" in body
                    and "tpulab_llm_requests_completed_total 1.0" in body):
                break
            time.sleep(1)
        assert "tpulab_llm_tokens_total 6.0" in body, body[-1200:]
        assert "tpulab_llm_requests_completed_total 1.0" in body
        free = float(re.search(r"^tpulab_llm_free_pages (\S+)$", body,
                               re.M).group(1))
        assert free > 0, "all pages released after completion"
    finally:
        srv.kill()


def test_07_llm_server_replicated_client():
    srvs = []
    try:
        for _ in range(2):
            srvs.append(_spawn_llm_server())
        ports = [_wait_llm_port(srv) for srv in srvs]
        out = _client(f"localhost:{ports[0]}, localhost:{ports[1]}",
                      "--prompt", "5,6,7", "--steps", "6", timeout=180)
        toks = out.split("\n")[0].split()
        assert len(toks) == 6, out
        assert "requests per replica" in out
    finally:
        for srv in srvs:
            srv.kill()


def _llama_checkpoint(path, vocab=64, d=32, heads=4, kv_heads=2, layers=2,
                      d_ff=64, seed=7):
    """An HF ``LlamaForCausalLM`` state dict of seeded f32 weights, saved
    with ``torch.save``."""
    rng = np.random.default_rng(seed)
    hd = d // heads

    def lin(o, i, s=0.1):
        return torch.from_numpy((rng.standard_normal((o, i)) * s)
                                .astype(np.float32))

    def ones():
        return torch.from_numpy((1 + rng.standard_normal(d) * 0.1)
                                .astype(np.float32))

    sd = {"model.embed_tokens.weight": lin(vocab, d, 1.0),
          "model.norm.weight": ones(), "lm_head.weight": lin(vocab, d, 1.0)}
    for i in range(layers):
        pre = f"model.layers.{i}"
        sd.update({
            f"{pre}.input_layernorm.weight": ones(),
            f"{pre}.post_attention_layernorm.weight": ones(),
            f"{pre}.self_attn.q_proj.weight": lin(heads * hd, d),
            f"{pre}.self_attn.k_proj.weight": lin(kv_heads * hd, d),
            f"{pre}.self_attn.v_proj.weight": lin(kv_heads * hd, d),
            f"{pre}.self_attn.o_proj.weight": lin(d, d),
            f"{pre}.mlp.gate_proj.weight": lin(d_ff, d),
            f"{pre}.mlp.up_proj.weight": lin(d_ff, d),
            f"{pre}.mlp.down_proj.weight": lin(d, d_ff),
        })
    torch.save(sd, path)


def test_07_llm_server_checkpoint_matches_tpulab(tmp_path):
    """One --checkpoint served by ex07 and by tpulab's 07: a greedy
    request through each server's own client gives the same tokens."""
    ckpt = tmp_path / "llama.pt"
    _llama_checkpoint(ckpt)
    geo = ["--checkpoint", str(ckpt), "--heads", "4", "--kv-heads", "2",
           "--port", "0", "--max-len", "64", "--lanes", "2", "--oneshot"]
    req = ["--prompt", "5,9,2,41,17", "--steps", "8"]
    streams = []
    for jax in (False, True):
        cmd = ([sys.executable, f"{REPO}/examples/07_llm_server.py", "--cpu"]
               if jax else [sys.executable, "-m",
                            "tpulab_torch.examples.ex07_llm_server",
                            "--device", "cpu"])
        env = JAX_ENV if jax else ENV
        srv = subprocess.Popen([*cmd, *geo], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True, env=env,
                               cwd=REPO)
        try:
            port = _wait_llm_port(srv, 180.0)
            out = _client(f"localhost:{port}", *req, env=env, jax=jax)
            streams.append(out.split("\n")[0].split())
            assert srv.wait(timeout=60) == 0
        finally:
            srv.kill()
    assert len(streams[0]) == 8 and streams[0] == streams[1], streams


# -- examples tpulab's file does not drive ------------------------------------------
def test_04_long_context_stream_matches_tpulab_counts():
    """Windows scored, tokens streamed and the bounded buffer agree with
    tpulab's run (the weights differ: each package draws its own)."""
    args = ["--chunks", "6"]
    got = _port("ex04_long_context_stream", "--device", "cpu", *args)
    want = _jax_script("examples/04_long_context_stream.py", "--cpu", *args)

    def shape(out):
        return (sorted(re.sub(r"nll=\S+", "", line)
                       for line in out.splitlines()
                       if line.startswith("window")),
                re.search(r"scored .*", out).group(0),
                len(re.search(r"continuation: \[([^\]]*)\]", out)
                    .group(1).split()))
    assert shape(got) == shape(want)


def test_00_basic_infer_and_97_multistream():
    out = _port("ex00_basic_infer", "--device", "cpu", "--model", "mnist",
                "--batch-size", "2", "--seconds", "1", "--latency")
    assert "inferences_per_second" in out
    assert json.loads(out.strip().splitlines()[-1])["inf/sec"] > 0
    out = _port("ex97_multistream", "--device", "cpu", "--model", "mnist",
                "--contexts", "1", "2", "--seconds", "0.5")
    rows = [line.split() for line in out.splitlines()[1:]]
    assert [r[0] for r in rows] == ["1", "2"]
    assert all(float(r[1]) > 0 for r in rows)


def test_05_shm_ingress_and_10_internals():
    out = _port("ex05_shm_ingress", "--device", "cpu")
    assert "producer: wrote 28x28 image into shared memory" in out
    assert "served from shm: logits (1, 10)" in out
    out = _port("ex10_internals")
    assert "requests filled node-locally: [0.0, 1.0, 2.0, 3.0]" in out


def test_98_multiprocess_round_robin():
    base = free_port()
    out = subprocess.run(
        [sys.executable, "-m", "tpulab_torch.examples.ex98_multiprocess",
         "2", "mnist"], capture_output=True, text=True, timeout=300,
        env={**ENV, "BASE_PORT": str(base), "EXTRA_ARGS": "--device cpu"},
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert re.search(r"200 requests over 2 replicas \(synchronized start\)",
                     out.stdout)


def test_examples_import_no_tpulab():
    """Every example module and walkthrough names only tpulab_torch."""
    pat = re.compile(r"^\s*(import tpulab|from tpulab)(\s|\.|$)", re.M)
    root = os.path.join(REPO, "tpulab_torch", "examples")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 24
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


# -- the RPC tools (tpulab's tools/ beside build_engine and onnx_summary) ---------
def test_image_client_preprocessing(tmp_path):
    """The image client's preprocessing equals tpulab's on one JPEG, uint8
    bit for bit and f32 within one f32 ulp."""
    from PIL import Image

    from tools.image_client import load_image as jax_load
    from tpulab_torch.tools.image_client import load_image
    img = Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (300, 400, 3),
                                          np.uint8).astype(np.uint8))
    p = tmp_path / "t.jpg"
    img.save(p)
    u8 = load_image(str(p), size=224, dtype=np.uint8)
    assert u8.shape == (224, 224, 3) and u8.dtype == np.uint8
    assert np.array_equal(u8, jax_load(str(p), size=224, dtype=np.uint8))
    f32 = load_image(str(p), size=224, dtype=np.float32)
    assert f32.dtype == np.float32 and abs(float(f32.mean())) < 3.0
    np.testing.assert_array_equal(f32, jax_load(str(p), size=224,
                                                dtype=np.float32))


def test_config_generator_matches_tpulab(tmp_path):
    """The same ModelConfig keys, IO contract and buckets as tpulab's for
    a registry model; an engine artifact's spec gives the same config."""
    got = json.loads(subprocess.run(
        [sys.executable, "-m", "tpulab_torch.tools.config_generator",
         "--model", "mnist", "--max-batch", "4"], capture_output=True,
        text=True, timeout=120, env=ENV, cwd=REPO, check=True).stdout)
    want = json.loads(_jax_script("tools/config_generator.py", "--model",
                                  "mnist", "--max-batch", "4"))
    assert got.keys() == want.keys()
    for k in ("name", "max_batch_size", "batch_buckets", "input", "output",
              "dynamic_batching", "weights_bytes"):
        assert got[k] == want[k], k
    assert got["platform"] == "tpulab_torch_cuda"
    assert got["instance_group"] == [{"count": 1, "kind": "KIND_GPU"}]
    from tpulab_torch.engine.runtime import Runtime
    from tpulab_torch.models.mnist import make_mnist
    rt = Runtime("cpu")
    rt.save_engine(rt.compile_model(make_mnist(max_batch_size=4,
                                               device="cpu")),
                   str(tmp_path / "eng"))
    eng = json.loads(subprocess.run(
        [sys.executable, "-m", "tpulab_torch.tools.config_generator",
         "--engine", str(tmp_path / "eng")], capture_output=True, text=True,
        timeout=120, env=ENV, cwd=REPO, check=True).stdout)
    for k in ("max_batch_size", "batch_buckets", "input", "output"):
        assert eng[k] == got[k], k


def test_grpc_siege_and_gap_probe():
    """The siege client against a port server (unary, stream, health rows;
    an absent model skipped) and the gap probe's rows, each its own
    process."""
    import tpulab_torch
    from tpulab_torch.models.mnist import make_mnist
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=2,
                                        device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=4, device="cpu"))
    mgr.update_resources()
    mgr.serve(port=0)
    try:
        out = subprocess.run(
            [sys.executable, "-m", "tpulab_torch.tools.grpc_siege",
             "--port", str(mgr.server.bound_port), "--models",
             "mnist,absent", "--n", "40", "--depth", "8",
             "--stream-model", "mnist", "--health", "--health-n", "100"],
            capture_output=True, text=True, timeout=120, env=ENV, cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        assert rec["mnist_inf_s"] > 0 and rec["stream_inf_s"] > 0
        assert rec["health_rpc_us"] > 0
        assert rec["absent_skipped"] == "not served"
    finally:
        mgr.shutdown()
    out = subprocess.run(
        [sys.executable, "-m", "tpulab_torch.tools.grpc_gap_probe",
         "--device", "cpu", "--n", "40", "--depth", "8"],
        capture_output=True, text=True, timeout=300, env=ENV, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout[out.stdout.index("{"):])
    for k in ("direct_inf_s", "grpc_batch_inf_s", "grpc_nobatch_inf_s",
              "grpc_stream_inf_s", "grpc_xproc_inf_s",
              "grpc_xproc_stream_inf_s"):
        assert rec[k] > 0, k
    assert rec["payload_kb"] == 147.0 and rec["stage_profile"]["n"] > 0
