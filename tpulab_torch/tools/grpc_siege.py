"""Siege client for the bench's gRPC serving rows — a SEPARATE process.

The reference's serving measurements (98-series, examples/99 script) run the
load generator as its own process over localhost; a colocated client shares
the server's GIL and understates the server (``grpc_gap_probe`` measures
by how much).  The port of tpulab's ``tools/grpc_siege.py``: a benchmark
spawns it against its in-process server and records the printed JSON
line.  It never touches the device.

    python -m tpulab_torch.tools.grpc_siege --port P \
        [--models rn50,rn50i8,echo] [--n 400] [--depth 64] \
        [--stream-model rn50] [--health]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def pipelined(submit, n: int, depth: int, timeout: float = 300.0) -> float:
    futs: list = []
    t0 = time.perf_counter()
    for _ in range(n):
        while len(futs) >= depth:
            futs.pop(0).result(timeout=timeout)
        futs.append(submit())
    for f in futs:
        f.result(timeout=timeout)
    return n / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--models", default="rn50",
                    help="comma-separated unary-siege model names; names "
                         "absent on the server are skipped with a note")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--depth", type=int, default=64)
    ap.add_argument("--stream-model", default=None)
    ap.add_argument("--health", action="store_true")
    ap.add_argument("--health-n", type=int, default=2000)
    args = ap.parse_args(argv)

    # the client never touches the device (the server owns the card)
    import numpy as np
    from tpulab_torch.rpc.infer_service import (RemoteInferenceManager,
                                          StreamInferClient)

    out = {}
    remote = RemoteInferenceManager(f"localhost:{args.port}", channels=8)

    def feed_for(status) -> dict:
        """One realistic b=1 request payload from the served IO spec."""
        rng = np.random.default_rng(0)
        feeds = {}
        for s in status.inputs:
            shape = (1, *s.dims)
            dt = np.dtype(s.dtype)
            if dt == np.uint8:
                feeds[s.name] = rng.integers(0, 255, shape).astype(dt)
            else:
                feeds[s.name] = rng.standard_normal(shape).astype(dt)
        return feeds

    try:
        # each row stands alone: a late failure (e.g. the bidi stream
        # dying on a flaky link) must not discard rows already measured
        served = remote.get_models()
        for name in args.models.split(","):
            if not name:
                continue
            if name not in served:
                out[f"{name}_skipped"] = "not served"
                continue
            try:
                feed = feed_for(served[name])
                rr = remote.infer_runner(name)
                rr.infer(**feed).result(timeout=300)  # warm
                out[f"{name}_inf_s"] = round(pipelined(
                    lambda: rr.infer(**feed), args.n, args.depth), 1)
            except Exception as e:  # noqa: BLE001
                out[f"{name}_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        if args.stream_model and args.stream_model in served:
            try:
                feed = feed_for(served[args.stream_model])
                sc = StreamInferClient(remote, args.stream_model)
                sc.submit(**feed).result(timeout=300)
                out["stream_inf_s"] = round(pipelined(
                    lambda: sc.submit(**feed), args.n, args.depth), 1)
                sc.close()
            except Exception as e:  # noqa: BLE001
                out["stream_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        if args.health:
            try:
                remote.health()
                rate = pipelined(remote.health_async, args.health_n, 64,
                                 timeout=60)
                out["health_rpc_us"] = round(1e6 / rate, 1)
            except Exception as e:  # noqa: BLE001
                out["health_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    finally:
        remote.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
