"""Generate a serving ModelConfig from a model or engine artifact
(the port of tpulab's ``tools/config_generator.py``; reference
examples/12_ConfigGenerator generator.cc:28-60: TRTIS ModelConfig from a
TRT engine).  Like tpulab's, it builds the model on the host: a config
needs no device.

    python -m tpulab_torch.tools.config_generator --model resnet50 \
        --max-batch 128
    python -m tpulab_torch.tools.config_generator --engine path/to/engine_dir
"""

import argparse
import json
import sys


def model_config(model, instances: int = 1) -> dict:
    """TRTIS-style model_config dict from a tpulab_torch Model."""
    return {
        "name": model.name,
        "platform": "tpulab_torch_cuda",
        "max_batch_size": model.max_batch_size,
        "batch_buckets": list(model.batch_buckets),
        "input": [
            {"name": s.name, "data_type": s.np_dtype.name,
             "dims": list(s.shape)} for s in model.inputs
        ],
        "output": [
            {"name": s.name, "data_type": s.np_dtype.name,
             "dims": list(s.shape)} for s in model.outputs
        ],
        "instance_group": [{"count": instances, "kind": "KIND_GPU"}],
        "dynamic_batching": {
            "preferred_batch_size": list(model.batch_buckets),
            "max_queue_delay_microseconds": 2000,
        },
        "weights_bytes": model.weights_size_in_bytes(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="registry model name")
    ap.add_argument("--engine", help="engine artifact directory")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--instances", type=int, default=1)
    args = ap.parse_args(argv)

    if args.engine:
        import os
        spec = json.load(open(os.path.join(args.engine, "spec.json")))
        import numpy as np
        from tpulab_torch.engine.model import IOSpec, Model
        model = Model(spec["name"], lambda p, x: x, None,
                      [IOSpec(n, tuple(s), np.dtype(d))
                       for n, s, d in spec["inputs"]],
                      [IOSpec(n, tuple(s), np.dtype(d))
                       for n, s, d in spec["outputs"]],
                      spec["max_batch_size"], spec["batch_buckets"])
        model.weights_size_in_bytes = lambda: 0
    elif args.model:
        from tpulab_torch.models import build_model
        model = build_model(args.model, max_batch_size=args.max_batch,
                            device="cpu")
    else:
        ap.error("--model or --engine required")
    json.dump(model_config(model, args.instances), sys.stdout, indent=2)
    print()


if __name__ == "__main__":
    main()
