"""In-process execution-concurrency sweep (the port of tpulab's
``examples/97_multistream.py``; reference examples/97: one process, N
execution contexts; throughput vs --contexts).

    python -m tpulab_torch.examples.ex97_multistream --model resnet50 \
        --uint8 --contexts 1 2 4 8 --seconds 3
"""

import argparse

from tpulab_torch.examples._device import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--contexts", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--uint8", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import numpy as np
    from tpulab_torch.engine import InferBench, InferenceManager
    from tpulab_torch.models import build_model

    print(f"{'contexts':>9} {'inf/sec':>10} {'ms/batch':>10}")
    for n in args.contexts:
        kwargs = dict(max_batch_size=max(args.batch_size, 1))
        if args.uint8 and args.model.startswith("resnet"):
            kwargs["input_dtype"] = np.uint8
        mgr = InferenceManager(max_executions=n, device=args.device)
        mgr.register_model(args.model, build_model(args.model,
                                                   device=args.device,
                                                   **kwargs))
        mgr.update_resources()
        r = InferBench(mgr).run(args.model, batch_size=args.batch_size,
                                seconds=args.seconds)
        print(f"{n:>9d} {r['inferences_per_second']:>10.1f} "
              f"{r['execution_time_per_batch_ms']:>10.2f}")
        mgr.shutdown()


if __name__ == "__main__":
    main()
