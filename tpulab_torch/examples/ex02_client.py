"""Clients for the inference service (the port of tpulab's
``examples/02_client.py``; reference 02's sync/async/siege clients).

    python -m tpulab_torch.examples.ex02_client --model resnet50 \
        --mode siege -n 500 --depth 64
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default="localhost:50051")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--mode", choices=["sync", "async", "siege"],
                    default="sync")
    ap.add_argument("-n", type=int, default=100)
    ap.add_argument("--depth", type=int, default=32,
                    help="in-flight depth for siege mode")
    ap.add_argument("--batch-size", type=int, default=1)
    args = ap.parse_args(argv)

    from tpulab_torch.rpc.infer_service import RemoteInferenceManager

    remote = RemoteInferenceManager(args.target, channels=4)
    models = remote.get_models()
    status = models[args.model]
    spec = status.inputs[0]
    shape = (args.batch_size, *spec.dims)
    x = (np.random.default_rng(0).integers(0, 255, shape).astype(spec.dtype)
         if np.dtype(spec.dtype) == np.uint8
         else np.random.default_rng(0).standard_normal(shape).astype(spec.dtype))
    runner = remote.infer_runner(args.model)
    runner.infer(**{spec.name: x}).result(timeout=300)  # warm

    t0 = time.perf_counter()
    if args.mode == "sync":
        lat = []
        for _ in range(args.n):
            t1 = time.perf_counter()
            runner.infer(**{spec.name: x}).result(timeout=300)
            lat.append((time.perf_counter() - t1) * 1e3)
        print(f"p50={np.percentile(lat, 50):.1f}ms "
              f"p90={np.percentile(lat, 90):.1f}ms "
              f"p99={np.percentile(lat, 99):.1f}ms")
    elif args.mode == "async":
        futs = [runner.infer(**{spec.name: x}) for _ in range(args.n)]
        [f.result(timeout=300) for f in futs]
    else:  # siege: bounded in-flight depth
        futs = []
        for _ in range(args.n):
            while len(futs) >= args.depth:
                futs.pop(0).result(timeout=300)
            futs.append(runner.infer(**{spec.name: x}))
        [f.result(timeout=300) for f in futs]
    dt = time.perf_counter() - t0
    total = args.n * args.batch_size
    print(f"{args.mode}: {total} inferences in {dt:.2f}s "
          f"-> {total / dt:.1f} inf/s")
    remote.close()


if __name__ == "__main__":
    main()
