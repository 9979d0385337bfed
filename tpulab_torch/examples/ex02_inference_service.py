"""Flagship gRPC inference service (the port of tpulab's
``examples/02_inference_service.py``; reference examples/02_TensorRT_GRPC
server.cc:82-331): model serving + Prometheus metrics (request/compute
duration quantiles, load-ratio histogram, device-memory gauge polled from
the server control lambda) + optional dynamic batching.

    python -m tpulab_torch.examples.ex02_inference_service --model resnet50 \
        --uint8 --port 50051 --metrics-port 9090 --batching
"""

import argparse

from tpulab_torch.examples._device import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--port", type=int, default=50051)
    ap.add_argument("--metrics-port", type=int, default=9090)
    ap.add_argument("--contexts", type=int, default=4)
    ap.add_argument("--max-batch-size", type=int, default=128)
    ap.add_argument("--batching", action="store_true")
    ap.add_argument("--batch-window-ms", type=float, default=5.0)
    ap.add_argument("--uint8", action="store_true")
    add_device_arg(ap)
    ap.add_argument("--no-coalesce-h2d", dest="coalesce_h2d",
                    action="store_false", default=True,
                    help="accepted for tpulab's command lines: the port "
                         "copies each input on its own either way")
    args = ap.parse_args(argv)

    import numpy as np
    import tpulab_torch
    from tpulab_torch.models import build_model
    from tpulab_torch.utils.metrics import (InferenceMetrics,
                                            start_metrics_server)

    kwargs = dict(max_batch_size=args.max_batch_size)
    if args.uint8 and args.model.startswith("resnet"):
        kwargs["input_dtype"] = np.uint8
    model = build_model(args.model, device=args.device, **kwargs)

    metrics = InferenceMetrics()
    start_metrics_server(metrics, args.metrics_port)

    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=args.contexts,
                                        device=args.device)
    mgr.register_model(args.model, model)
    mgr.update_resources()
    mgr.serve(port=args.port, batching=args.batching,
              batch_window_s=args.batch_window_ms / 1000.0, metrics=metrics)
    print(f"serving {args.model} on :{args.port}, metrics on "
          f":{args.metrics_port}/metrics", flush=True)

    # k8s-native termination: on SIGTERM (pod delete), drain first —
    # readiness flips so the balancer rotates this replica out, in-flight
    # requests finish — then shut down inside terminationGracePeriod
    import signal

    def _term(_sig, _frm):
        print("SIGTERM: draining", flush=True)
        mgr.drain(timeout=25.0)
        mgr.shutdown()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _term)
    # control lambda: device-memory gauge every 2s (reference NVML power
    # gauge, server.cc:322-331)
    mgr.server.run(control_fn=metrics.poll_device, control_period_s=2.0)


if __name__ == "__main__":
    main()
