"""L7 load-balancer measurement script (the port of tpulab's
``examples/99_loadbalancer/run_lb.py``; reference
examples/99_LoadBalancer run_loadbalancer.py: N replicas behind envoy,
measured ~150 us/request of proxy overhead — direct 371.7 vs proxied
352.0 inf/s).

Measures the same three configurations here:

  direct      one replica, straight gRPC
  replicaset  client-side least-loaded routing across all replicas
              (tpulab_torch.rpc.replica.ReplicaSet — the zero-infrastructure
              LB)
  envoy       round-robin through an envoy proxy (skipped with a note when
              the envoy binary is not installed; config generated from
              ex99_lb_envoy.yaml, a copy of tpulab's lb-envoy.yaml, with
              live backend ports)

and prints per-config throughput + p50 latency and the per-request
overhead vs direct.  Every replica serves on the CUDA card unless
``--device cpu`` is given.  Run:

    python -m tpulab_torch.examples.ex99_run_lb --replicas 2 -n 200
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from tpulab_torch.examples._device import add_device_arg

#: the directory that holds the ``tpulab_torch`` package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_REPLICA_WORKER = """
import sys
import tpulab_torch
from tpulab_torch.models import build_model

device = sys.argv[1] if len(sys.argv) > 1 else None
mgr = tpulab_torch.InferenceManager(max_exec_concurrency=2, max_buffers=8,
                                    device=device)
mgr.register_model("mnist", build_model("mnist", max_batch_size=8,
                                        device=device))
mgr.update_resources()
mgr.serve(port=0, batching=True, batch_window_s=0.002)
print(f"READY port={mgr.server.bound_port}", flush=True)
sys.stdin.readline()
mgr.shutdown()
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_replicas(n: int, device) -> list:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    args = [sys.executable, "-c", _REPLICA_WORKER] + ([device] if device
                                                       else [])
    procs = []
    for _ in range(n):
        procs.append(subprocess.Popen(
            args, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    ports = []
    for p in procs:
        line = p.stdout.readline()
        if not line.startswith("READY"):
            raise RuntimeError(f"replica failed: {p.stderr.read()[-2000:]}")
        ports.append(int(line.strip().rsplit("port=", 1)[1]))
    return list(zip(procs, ports))


def siege(infer, n: int, depth: int) -> dict:
    """Pipelined siege + sequential latency probe over ``infer(x)->Future``."""
    import numpy as np
    x = np.zeros((1, 28, 28, 1), np.float32)
    infer(x).result(timeout=120)  # warm
    futs = []
    t0 = time.perf_counter()
    for _ in range(n):
        while len(futs) >= depth:
            futs.pop(0).result(timeout=120)
        futs.append(infer(x))
    for f in futs:
        f.result(timeout=120)
    wall = time.perf_counter() - t0
    lats = []
    for _ in range(min(50, n)):
        t1 = time.perf_counter()
        infer(x).result(timeout=120)
        lats.append((time.perf_counter() - t1) * 1e6)
    return {"inf_s": round(n / wall, 1),
            "p50_us": round(float(np.median(lats)), 1)}


def start_envoy(ports: list[int], admin_port: int, listen_port: int):
    """Render lb-envoy.yaml's topology with live ports; None if no envoy."""
    if shutil.which("envoy") is None:
        return None, None
    backends = "\n".join(
        f"              - endpoint:\n"
        f"                  address:\n"
        f"                    socket_address: "
        f"{{ address: 127.0.0.1, port_value: {p} }}" for p in ports)
    tpl_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "ex99_lb_envoy.yaml")
    with open(tpl_path) as f:
        cfg = f.read()
    cfg = cfg.replace("port_value: 50050", f"port_value: {listen_port}")
    head, _, _ = cfg.partition("          - lb_endpoints:")
    cfg = head + "          - lb_endpoints:\n" + backends + "\n"
    cfg += (f"admin:\n  address:\n    socket_address: "
            f"{{ address: 127.0.0.1, port_value: {admin_port} }}\n")
    tmp = tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False)
    tmp.write(cfg)
    tmp.close()
    proc = subprocess.Popen(["envoy", "-c", tmp.name, "--base-id",
                             str(os.getpid() % 32000)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.time() + 15
    import socket
    while time.time() < deadline:
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", listen_port)) == 0:
                return proc, tmp.name
        time.sleep(0.25)
    proc.kill()
    return None, tmp.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("-n", type=int, default=200)
    ap.add_argument("--depth", type=int, default=8)
    add_device_arg(ap)
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line instead of the table")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="expose the ReplicaSet's routing metrics "
                         "(tpulab_replica_*) on this /metrics port — the "
                         "client-side series the deploy dashboard's "
                         "replica panels read")
    args = ap.parse_args(argv)

    from tpulab_torch.rpc.infer_service import RemoteInferenceManager
    from tpulab_torch.rpc.replica import ReplicaSet

    replicas = start_replicas(args.replicas, args.device)
    ports = [pt for _, pt in replicas]
    results: dict[str, dict] = {}
    envoy_proc = None
    try:
        remote = RemoteInferenceManager(f"127.0.0.1:{ports[0]}")
        runner = remote.infer_runner("mnist")
        results["direct"] = siege(lambda x: runner.infer(Input3=x),
                                  args.n, args.depth)
        remote.close()

        rs_metrics = None
        if args.metrics_port:
            from tpulab_torch.utils.metrics import (ReplicaSetMetrics,
                                                    start_metrics_server)
            rs_metrics = ReplicaSetMetrics()
            start_metrics_server(rs_metrics, port=args.metrics_port)
        rs = ReplicaSet([f"127.0.0.1:{p}" for p in ports], "mnist",
                        metrics=rs_metrics)
        rs.health()  # seeds the per-replica liveness series
        results["replicaset"] = siege(lambda x: rs.infer(Input3=x),
                                      args.n, args.depth)
        rs.health()  # refresh liveness after the siege
        results["replicaset"]["split"] = list(rs.served)
        rs.close()

        lb_port = _free_port()
        envoy_proc, _cfg = start_envoy(ports, _free_port(), lb_port)
        if envoy_proc is not None:
            remote = RemoteInferenceManager(f"127.0.0.1:{lb_port}")
            runner = remote.infer_runner("mnist")
            results["envoy"] = siege(lambda x: runner.infer(Input3=x),
                                     args.n, args.depth)
            remote.close()
        else:
            results["envoy"] = {"skipped": "envoy binary not installed"}
    finally:
        if envoy_proc is not None:
            envoy_proc.kill()
        for p, _ in replicas:
            try:
                p.stdin.close()
                p.wait(timeout=15)
            except Exception:
                p.kill()

    d_p50 = results["direct"]["p50_us"]
    for k in ("replicaset", "envoy"):
        if "p50_us" in results[k]:
            results[k]["overhead_us_vs_direct"] = round(
                results[k]["p50_us"] - d_p50, 1)
    if args.json:
        print(json.dumps({"lb": results}))
    else:
        print(f"{'config':<12} {'inf/s':>8} {'p50 us':>9} {'overhead us':>12}")
        for k, r in results.items():
            if "skipped" in r:
                print(f"{k:<12} {'—':>8} {'—':>9} {'—':>12}   "
                      f"({r['skipped']})")
            else:
                print(f"{k:<12} {r['inf_s']:>8} {r['p50_us']:>9} "
                      f"{r.get('overhead_us_vs_direct', 0.0):>12}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
