"""Attribute the gRPC-vs-direct serving gap (the port of tpulab's
``tools/grpc_gap_probe.py``).

Serves an identity model with the rn50 image payload (150 KB uint8) — the
full serving path minus compute — and measures pipelined throughput over:
  direct        in-process InferRunner (the bench's b1 direct path)
  grpc+batch    the bench's flagship config (dynamic batching server)
  grpc-nobatch  same server, batching off (isolates the batcher's cost)
  grpc-stream   bidi StreamInfer ingestion (no per-call unary machinery)
  health        empty-payload RPC floor (machinery only, no tensors)

Run with ``--device cpu`` for structure, on the card for truth:
``python -m tpulab_torch.tools.grpc_gap_probe``.
"""

from __future__ import annotations

import json
import os
import sys

from tpulab_torch.tools.grpc_siege import pipelined  # one rate loop


def client_main(port: int, n: int, depth: int) -> None:
    """Siege an already-running server from THIS (separate) process —
    the deployment-shaped measurement: client GIL != server GIL."""
    import numpy as np
    from tpulab_torch.rpc.infer_service import (RemoteInferenceManager,
                                          StreamInferClient)
    img = np.random.default_rng(0).integers(0, 255, (1, 224, 224, 3)
                                            ).astype(np.uint8)
    remote = RemoteInferenceManager(f"localhost:{port}", channels=8)
    rr = remote.infer_runner("echo")
    rr.infer(img=img).result(timeout=60)
    out = {"grpc_xproc_inf_s": round(pipelined(
        lambda: rr.infer(img=img), n, depth), 1)}
    sc = StreamInferClient(remote, "echo")
    sc.submit(img=img).result(timeout=60)
    out["grpc_xproc_stream_inf_s"] = round(pipelined(
        lambda: sc.submit(img=img), n, depth), 1)
    sc.close()
    remote.close()
    print(json.dumps(out))


def main(argv=None) -> None:
    import argparse

    from tpulab_torch.examples._device import add_device_arg
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--depth", type=int, default=64)
    ap.add_argument("--client-port", type=int, default=None,
                    help="internal: run as siege client against PORT")
    args = ap.parse_args(argv)
    if args.client_port is not None:
        client_main(args.client_port, args.n, args.depth)
        return

    import numpy as np
    from tpulab_torch.engine import InferenceManager
    from tpulab_torch.engine.model import IOSpec, Model
    from tpulab_torch.rpc.infer_service import (RemoteInferenceManager,
                                          StreamInferClient,
                                          build_infer_service)

    echo = Model("echo", lambda p, x: {"out": x["img"]}, {},
                 [IOSpec("img", (224, 224, 3), np.uint8)],
                 [IOSpec("out", (224, 224, 3), np.uint8)],
                 max_batch_size=8, batch_buckets=[1, 8])
    mgr = InferenceManager(max_executions=8, max_buffers=64,
                           device=args.device)
    mgr.register_model("echo", echo)
    mgr.update_resources()
    img = np.random.default_rng(0).integers(0, 255, (1, 224, 224, 3)
                                            ).astype(np.uint8)
    out = {}

    runner = mgr.infer_runner("echo")
    runner.infer(img=img).result(timeout=60)
    out["direct_inf_s"] = round(pipelined(
        lambda: runner.infer(img=img), args.n, args.depth), 1)

    for key, batching in (("grpc_batch", True), ("grpc_nobatch", False)):
        server = remote = None
        try:
            server = build_infer_service(mgr, "0.0.0.0:0", batching=batching,
                                         batch_window_s=0.002)
            server.async_start()
            server.wait_until_running()
            remote = RemoteInferenceManager(
                f"localhost:{server.bound_port}", channels=8)
            rr = remote.infer_runner("echo")
            rr.infer(img=img).result(timeout=60)
            out[f"{key}_inf_s"] = round(pipelined(
                lambda: rr.infer(img=img), args.n, args.depth), 1)
            if batching:
                sc = StreamInferClient(remote, "echo")
                sc.submit(img=img).result(timeout=60)
                out["grpc_stream_inf_s"] = round(pipelined(
                    lambda: sc.submit(img=img), args.n, args.depth), 1)
                sc.close()
                remote.health()
                out["health_rpc_us"] = round(1e6 / pipelined(
                    remote.health_async, 2000, 64), 1)
                prof = server._infer_resources.stage_profile()
                out["stage_profile"] = prof
        finally:
            if remote is not None:
                remote.close()
            if server is not None:
                server.shutdown()

    # cross-process: the deployment-shaped config (reference 98-series
    # measures a separate client process over localhost)
    import subprocess
    server = None
    try:
        server = build_infer_service(mgr, "0.0.0.0:0", batching=True,
                                     batch_window_s=0.002)
        server.async_start()
        server.wait_until_running()
        cmd = [sys.executable, "-m", "tpulab_torch.tools.grpc_gap_probe",
               "--client-port", str(server.bound_port),
               "--n", str(args.n), "--depth", str(args.depth)]
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p)}
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, env=env)
        if proc.returncode == 0:
            out.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        else:
            out["xproc_error"] = proc.stderr[-500:]
    finally:
        if server is not None:
            server.shutdown()

    out["payload_kb"] = round(img.nbytes / 1024, 1)
    print(json.dumps(out, indent=2), flush=True)   # os._exit skips the flush
    mgr.shutdown()
    os._exit(0)


if __name__ == "__main__":
    main()
