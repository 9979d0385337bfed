"""Bring-your-own-model via ONNX: build -> verify -> serve -> golden check.

The reference's model-entry workflow (examples/ONNX/resnet50/build.py +
models/onnx/common.py run_onnx_tests: parse an ONNX graph, build an engine,
verify against the zoo's bundled test vectors, then serve; the port of
tpulab's ``examples/13_onnx_serving.py``).  No `onnx` package is needed —
`tpulab_torch.models.onnx_import` carries its own protobuf wire-format
parser and evaluates the graph with PyTorch ops.

    python -m tpulab_torch.examples.ex13_onnx_serving \
        [--onnx mnist-v1.3/model.onnx] \
        [--data mnist-v1.3/test_data_set_0] \
        [--engine-dir /tmp/onnx_engine]

With --engine-dir the model additionally round-trips through an engine
artifact (save_engine -> portable load_engine with no Python source) before
serving — the offline-build / online-serve split.
"""

import argparse
import glob
import os
import re
import sys

import numpy as np

#: the ONNX model zoo's mnist-v1.3 directory, unpacked where it runs
DEFAULT_ONNX = "mnist-v1.3/model.onnx"
DEFAULT_DATA = "mnist-v1.3/test_data_set_0"


def main(argv=None) -> int:
    from tpulab_torch.examples._device import add_device_arg

    ap = argparse.ArgumentParser()
    ap.add_argument("--onnx", default=DEFAULT_ONNX)
    ap.add_argument("--data", default=DEFAULT_DATA,
                    help="ONNX zoo test_data_set dir (input/output .pb)")
    ap.add_argument("--engine-dir", default=None,
                    help="also round-trip via a saved engine artifact")
    ap.add_argument("--max-batch", type=int, default=4)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if not os.path.exists(args.onnx):
        print(f"model {args.onnx} not found — pass --onnx", file=sys.stderr)
        return 0  # graceful skip: the default points at the reference tree

    import tpulab_torch
    from tpulab_torch.models.onnx_import import load_onnx_model, load_tensor_pb

    # 1. import (the reference's parser->network step)
    model = load_onnx_model(args.onnx, name="onnx_model",
                            max_batch_size=args.max_batch,
                            device=args.device)
    print(f"imported: {model}")

    # 2. optional offline-build/online-serve split via an engine artifact:
    # what gets SERVED below is the artifact reloaded with no Python
    # source (the portable plan-file property), not the in-memory model
    if args.engine_dir:
        from tpulab_torch.engine import Runtime
        rt = Runtime(args.device)
        rt.save_engine(rt.compile_model(model), args.engine_dir)
        print(f"engine artifact saved -> {args.engine_dir}")
        loaded = Runtime(args.device).load_engine(args.engine_dir)
        model = loaded.model
        print("engine artifact reloaded (portable path) -> serving it")

    # 3. serve
    manager = tpulab_torch.InferenceManager(max_exec_concurrency=2,
                                            device=args.device)
    manager.register_model("onnx_model", model)
    manager.update_resources()
    manager.serve(port=0)
    remote = tpulab_torch.RemoteInferenceManager(
        f"localhost:{manager.server.bound_port}")

    # 4. golden check over the wire (reference run_onnx_tests pattern)
    def by_index(p):
        return int(re.search(r"_(\d+)\.pb$", p).group(1))
    ins = sorted(glob.glob(os.path.join(args.data, "input_*.pb")),
                 key=by_index)
    outs = sorted(glob.glob(os.path.join(args.data, "output_*.pb")),
                  key=by_index)
    feeds = {s.name: load_tensor_pb(p) for s, p in zip(model.inputs, ins)}
    result = remote.infer_runner("onnx_model").infer(**feeds).result(
        timeout=300)
    for spec, p in zip(model.outputs, outs):
        np.testing.assert_allclose(result[spec.name], load_tensor_pb(p),
                                   rtol=1e-3, atol=1e-3)
    print(f"golden check vs {len(outs)} output vector(s): OK")
    remote.close()
    manager.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
