"""Standalone pipelined streaming client
(the port of tpulab's ``examples/06_stream_client.py``; reference
examples/04_Middleman/middleman-client.cc — the streaming client driven on
its own against a serving endpoint).

Sends N inference requests down ONE bidirectional StreamInfer stream
without waiting for responses (pipelining), correlates responses by id,
and reports throughput vs the unary path.  Point it at any tpulab or
tpulab_torch inference service (ex02), or run self-contained:

    python -m tpulab_torch.examples.ex06_stream_client       # spawns a server
    python -m tpulab_torch.examples.ex06_stream_client --host host:port
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tpulab_torch.examples._device import add_device_arg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default=None,
                    help="serving endpoint; default: spawn a local server")
    ap.add_argument("--requests", type=int, default=64)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from tpulab_torch.rpc.infer_service import (RemoteInferenceManager,
                                          StreamInferClient)

    manager = None
    host = args.host
    if host is None:
        import tpulab_torch
        from tpulab_torch.models import build_model
        manager = tpulab_torch.InferenceManager(max_exec_concurrency=4,
                                                device=args.device)
        manager.register_model("mnist", build_model("mnist", max_batch_size=4,
                                                    device=args.device))
        manager.update_resources()
        manager.serve(port=0)
        host = f"localhost:{manager.server.bound_port}"

    remote = RemoteInferenceManager(host)
    try:
        model_name = sorted(remote.get_models())[0]
        runner = remote.infer_runner(model_name)
        spec = runner.input_bindings()
        binding, (shape, dtype) = next(iter(spec.items()))
        x = np.random.default_rng(0).standard_normal(
            (1, *shape)).astype(dtype)

        # unary baseline: one request per round trip
        runner.infer(**{binding: x}).result(timeout=300)  # warm
        t0 = time.perf_counter()
        for _ in range(args.requests):
            runner.infer(**{binding: x}).result(timeout=300)
        unary_s = time.perf_counter() - t0

        # pipelined stream: fire everything, then drain (reference
        # middleman-client's WritesDone-after-N pattern)
        stream = StreamInferClient(remote, model_name)
        stream.submit(**{binding: x}).result(timeout=300)  # warm
        t0 = time.perf_counter()
        futs = [stream.submit(**{binding: x}) for _ in range(args.requests)]
        outs = [f.result(timeout=300) for f in futs]
        stream_s = time.perf_counter() - t0
        stream.close()

        assert len(outs) == args.requests
        print(f"model={model_name} n={args.requests}")
        print(f"unary   : {args.requests / unary_s:8.1f} req/s")
        print(f"streamed: {args.requests / stream_s:8.1f} req/s "
              f"({unary_s / stream_s:.1f}x)")
    finally:
        remote.close()
        if manager is not None:
            manager.shutdown()


if __name__ == "__main__":
    main()
