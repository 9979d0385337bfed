"""CLI inference benchmark (the port of tpulab's
``examples/00_basic_infer.py``; reference examples/00_TensorRT
infer.cc:79-147: flags engine/contexts/buffers/seconds/batch_size;
pipelined sync loop).

    python -m tpulab_torch.examples.ex00_basic_infer --model resnet50 \
        --batch-size 8 --contexts 4 --buffers 16 --seconds 5 --uint8
"""

import argparse
import json

from tpulab_torch.examples._device import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--engine", default=None,
                    help="load a serialized engine artifact instead")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--contexts", type=int, default=2,
                    help="max in-flight executions (reference --contexts)")
    ap.add_argument("--buffers", type=int, default=0,
                    help="staging bundles (default 2x contexts)")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--uint8", action="store_true",
                    help="uint8 ingest path (INT8-engine parity)")
    ap.add_argument("--latency", action="store_true",
                    help="also report p50/p90/p99")
    add_device_arg(ap)
    ap.add_argument("--no-coalesce-h2d", dest="coalesce_h2d",
                    action="store_false", default=True,
                    help="accepted for tpulab's command lines: the port "
                         "copies each input on its own either way (a CUDA "
                         "copy has no per-transfer round trip to amortize)")
    args = ap.parse_args(argv)

    import numpy as np
    from tpulab_torch.engine import InferBench, InferenceManager
    from tpulab_torch.models import build_model

    kwargs = dict(max_batch_size=max(args.batch_size, 1))
    if args.uint8 and args.model.startswith("resnet"):
        kwargs["input_dtype"] = np.uint8
    model = build_model(args.model, device=args.device, **kwargs)

    mgr = InferenceManager(max_executions=args.contexts,
                           max_buffers=args.buffers, device=args.device)
    mgr.register_model(args.model, model)
    mgr.update_resources()

    bench = InferBench(mgr)
    result = bench.run(args.model, batch_size=args.batch_size,
                       seconds=args.seconds)
    # reference-style metric table (infer_bench.cc:90-98 keys)
    for k, v in result.items():
        print(f"{k:32s} {v:.3f}")
    if args.latency:
        for k, v in bench.latency(args.model,
                                  batch_size=args.batch_size).items():
            print(f"{k:32s} {v:.3f}")
    print(json.dumps({"inf/sec": result["inferences_per_second"]}))
    mgr.shutdown()


if __name__ == "__main__":
    main()
