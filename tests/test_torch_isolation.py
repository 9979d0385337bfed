"""The port stands alone: tpulab_torch and chip_smoke.py import no JAX, no
ml_dtypes, no prometheus_client and nothing of the tpulab package (the
machine with the card has none of them), and no module imports
google.protobuf; grpc is imported only where a server starts or a client
is built.  In a process where grpc, google.protobuf and prometheus_client
cannot be imported, the port imports, builds the inference service with
its observability plane (flight recorder, watchdog, metrics, the Debug
RPC) and answers requests through its behaviors, and starting a server
raises the ImportError that names grpc.

Module names are matched exactly: ``tpulab_torch`` starts with the
letters ``tpulab`` but is not ``tpulab`` or ``tpulab.*``.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import tpulab_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tpulab_torch"


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "tpulab"
            or name.startswith("tpulab.") or name == "ml_dtypes"
            or name.startswith("ml_dtypes.") or name == "google.protobuf"
            or name.startswith("google.protobuf.")
            or name == "prometheus_client"
            or name.startswith("prometheus_client."))


def _transport(name: str) -> bool:
    return name == "grpc" or name.startswith("grpc.")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tpulab_torch.__path__, prefix="tpulab_torch."))


def test_forbidden_matches_exact_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("tpulab") and _forbidden("tpulab.engine.paged")
    assert _forbidden("ml_dtypes") and _forbidden("tpulab.disagg.wire")
    assert not _forbidden("tpulab_torch") and not _forbidden(
        "tpulab_torch.engine.paged") and not _forbidden("jaxtyping")
    assert _forbidden("google.protobuf.internal") and _forbidden(
        "tpulab.rpc.protos.inference_pb2")
    assert _transport("grpc.aio") and not _transport("grpcio_tools")
    assert _forbidden("prometheus_client") and _forbidden(
        "prometheus_client.parser") and not _forbidden("prometheus")


def test_importing_every_module_loads_no_jax_or_tpulab():
    mods = _modules()
    assert {"tpulab_torch.engine.paged", "tpulab_torch.engine.speculative",
            "tpulab_torch.chaos", "tpulab_torch.cuda.transfer",
            "tpulab_torch.kvcache.host_store", "tpulab_torch.kvcache.offload",
            "tpulab_torch.disagg.wire",
            "tpulab_torch.disagg.shipper", "tpulab_torch.rpc.server",
            "tpulab_torch.rpc.infer_service",
            "tpulab_torch.rpc.protos.inference_pb2",
            "tpulab_torch.serving.admission",
            "tpulab_torch.engine.generation", "tpulab_torch.obs",
            "tpulab_torch.obs.flight", "tpulab_torch.obs.debugz",
            "tpulab_torch.obs.slo", "tpulab_torch.obs.bench",
            "tpulab_torch.utils.metrics",
            "tpulab_torch.utils.watchdog", "tpulab_torch.batch",
            "tpulab_torch.batch.job", "tpulab_torch.batch.scheduler",
            "tpulab_torch.batch.bench", "tpulab_torch.obs.journal",
            "tpulab_torch.rpc.replica", "tpulab_torch.fleet",
            "tpulab_torch.fleet.router", "tpulab_torch.fleet.autoscaler",
            "tpulab_torch.fleet.supervisor", "tpulab_torch.fleet.process",
            "tpulab_torch.fleet.replica_main",
            "tpulab_torch.fleet.bench", "tpulab_torch.fleet.election",
            "tpulab_torch.fleet.control", "tpulab_torch.fleet.observer",
            "tpulab_torch.kvfabric", "tpulab_torch.kvfabric.fabric",
            "tpulab_torch.kvfabric.bench", "tpulab_torch.memory",
            "tpulab_torch.memory.literals", "tpulab_torch.memory.memory_type",
            "tpulab_torch.memory.debugging", "tpulab_torch.memory.descriptor",
            "tpulab_torch.memory.raw_allocators", "tpulab_torch.memory.block",
            "tpulab_torch.memory.arena", "tpulab_torch.memory.allocator",
            "tpulab_torch.memory.memory_pool",
            "tpulab_torch.memory.transactional", "tpulab_torch.memory.bfit",
            "tpulab_torch.memory.trackers", "tpulab_torch.memory.raii",
            "tpulab_torch.memory.shm", "tpulab_torch.cuda.memory_types",
            "tpulab_torch.cuda.copy", "tpulab_torch.cuda.device_info",
            "tpulab_torch.cuda.cyclic_buffer",
            "tpulab_torch.core.cyclic_buffer", "tpulab_torch.core.dtypes",
            "tpulab_torch.core.threads", "tpulab_torch.tools.onnx_summary",
            "tpulab_torch.tools.build_engine"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m) or _transport(m)]
    assert not bad, bad


def test_sources_import_no_jax_or_tpulab():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert len(files) > 10 and not bad, bad


def test_grpc_imported_only_inside_functions():
    """grpc is the transport: no module of the port imports it at module
    level (a server's start and a client's construction do)."""
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _transport(n)]
    assert not bad, bad


_BLOCKED = r"""
import json, sys
for name in ("grpc", "google.protobuf", "prometheus_client"):
    sys.modules[name] = None      # importing them now raises ImportError
import numpy as np
import torch
import tpulab_torch, tpulab_torch.rpc, tpulab_torch.rpc.infer_service
import tpulab_torch.serving
from tpulab_torch.engine.paged import ContinuousBatcher
from tpulab_torch.models import build_model
from tpulab_torch.models.transformer import init_transformer_params
from tpulab_torch.rpc.infer_service import (SERVICE_NAME, build_infer_service,
                                            tensor_to_proto, proto_to_tensor)
from tpulab_torch.rpc.protos import inference_pb2 as pb
from tpulab_torch.serving import AdmissionConfig, AdmissionController
from tpulab_torch.obs import FlightRecorder
from tpulab_torch.utils.metrics import InferenceMetrics, generate_latest
from tpulab_torch.utils.watchdog import DeviceWatchdog

out = {}
mgr = tpulab_torch.InferenceManager(device="cpu")
mgr.register_model("mnist", build_model("mnist", max_batch_size=2,
                                        device="cpu"))
mgr.update_resources()
params = init_transformer_params(64, 32, 4, 1, 64, seed=0, device="cpu")
cb = ContinuousBatcher(params, n_heads=4, n_layers=1, lanes=2, max_len=32,
                       page_size=8, compute_dtype=torch.float32,
                       device="cpu")
adm = AdmissionController(AdmissionConfig(max_inflight=4))
fr = FlightRecorder(sample_every=1)
im = InferenceMetrics()
wd = DeviceWatchdog(device="cpu", period_s=0.05).start()
server = build_infer_service(mgr, generation_engines={"lm": cb},
                             batching=True, admission=adm, flight=fr,
                             metrics=im, watchdog=wd)
path = "/" + SERVICE_NAME + "/"
st = pb.StatusResponse.FromString(server.invoke(path + "Status", b""))
out["status"] = [st.status.code, st.models[0].name, st.free_kv_pages]
x = np.zeros((1, 28, 28, 1), np.float32)
req = pb.InferRequest(model_name="mnist", batch_size=1,
                      inputs=[tensor_to_proto("Input3", x)])
r = pb.InferResponse.FromString(server.invoke(path + "Infer",
                                              req.SerializeToString()))
out["infer"] = [r.status.code, list(proto_to_tensor(r.outputs[0]).shape)]
g = pb.GenerateRequest(model_name="lm", prompt=[1, 2, 3], steps=4)
resps = [pb.GenerateResponse.FromString(b) for b in server.invoke_stream(
    path + "Generate", [g.SerializeToString()])]
out["generate"] = [len(resps), resps[-1].final, resps[-1].status.code]
h = pb.HealthResponse.FromString(server.invoke(path + "Health", b""))
out["health"] = [h.live, h.ready]
d = pb.DebugResponse.FromString(server.invoke(path + "Debug", b""))
snap = json.loads(d.snapshot_json)
out["debug"] = [d.status.code, sorted(snap["engines"]),
                snap["flight"]["observed_total"]]
out["metrics"] = "tpulab_request_total 1.0" in generate_latest(
    im.registry).decode()
wd.stop()
for what, fn in (("start", server.async_start),
                 ("remote", lambda: tpulab_torch.RemoteInferenceManager(
                     "localhost:1")),
                 ("serve", lambda: mgr.serve(port=0))):
    try:
        fn()
        out[what] = "started"
    except ImportError as e:
        out[what] = str(e)
server.shutdown()
cb.shutdown()
mgr.shutdown()
out["loaded"] = sorted(m for m in sys.modules
                       if m.startswith(("grpc", "google.protobuf",
                                        "prometheus_client"))
                       and sys.modules[m] is not None)
print(json.dumps(out))
"""


def test_service_without_grpc_or_protobuf():
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["status"] == [1, "mnist", got["status"][2]]
    assert got["status"][2] > 0
    assert got["infer"] == [1, [1, 10]]
    assert got["generate"] == [5, True, 1]
    assert got["health"] == [True, True]
    assert got["debug"] == [1, ["lm"], 2] and got["metrics"] is True
    for what in ("start", "remote", "serve"):
        assert "grpc" in got[what] and "invoke" in got[what], got[what]
    assert got["loaded"] == []


def test_replica_main_help_runs_with_jax_blocked():
    """``python -m tpulab_torch.fleet.replica_main --help`` in a process
    where jax and tpulab cannot be imported: it prints the port's
    options (the card by default, ``--device cpu`` for the CPU) and
    loads neither."""
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'tpulab'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['tpulab_torch.fleet.replica_main', '--help']\n"
        "try:\n"
        "    runpy.run_module('tpulab_torch.fleet.replica_main',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'tpulab') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    for flag in ("--device", "--dtype", "--n-kv-heads", "--ffn", "--untied",
                 "--rope-theta", "--decode-block", "--prefill-chunk",
                 "--seed", "--model-name"):
        assert flag in out.stdout, flag
