"""Offline engine builder (reference examples/ONNX/resnet50/build.py +
models/onnx_builder.py: build serialized engines ahead of serving).

    python -m tpulab_torch.tools.build_engine --model resnet50 --uint8 \\
        --max-batch 128 --out engines/rn50 [--int8] [--torch-checkpoint p.pt]
    python -m tpulab_torch.tools.build_engine --onnx model.onnx \\
        --out engines/my_model [--verify-dir test_data_set_0]

The model is built and its artifact written on the CUDA card; ``--device
cpu`` builds on the host instead.  Prints one JSON object (engine, model,
buckets, weights_bytes, build_s).  Eager PyTorch has no compilation
cache to enable.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional


def _verify_onnx(model, data_dir: str, device) -> None:
    """Golden-check against ONNX zoo test vectors (reference
    examples/ONNX mnist flow: run bundled inputs, compare outputs)."""
    import glob
    import os
    import re

    import numpy as np
    import torch

    from tpulab_torch.models.onnx_import import load_tensor_pb

    def by_index(p):  # input_10.pb must sort after input_2.pb
        return int(re.search(r"_(\d+)\.pb$", p).group(1))

    ins = sorted(glob.glob(os.path.join(data_dir, "input_*.pb")),
                 key=by_index)
    outs = sorted(glob.glob(os.path.join(data_dir, "output_*.pb")),
                  key=by_index)
    if len(ins) != len(model.inputs) or len(outs) != len(model.outputs):
        raise SystemExit(
            f"--verify-dir {data_dir}: found {len(ins)} input / "
            f"{len(outs)} output .pb files but the model has "
            f"{len(model.inputs)} inputs / {len(model.outputs)} outputs — "
            "refusing to claim a verification that would compare nothing")
    feeds = {s.name: torch.from_numpy(np.array(load_tensor_pb(p))).to(device)
             for s, p in zip(model.inputs, ins)}
    with torch.inference_mode():
        got = model.apply_fn(model.params, feeds)
    for spec, path in zip(model.outputs, outs):
        want = load_tensor_pb(path)
        np.testing.assert_allclose(got[spec.name].cpu().numpy(), want,
                                   rtol=1e-3, atol=1e-4)
    print(f"# verified {len(outs)} output tensor(s) against golden "
          f"vectors in {data_dir}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--uint8", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only INT8 quantization")
    ap.add_argument("--torch-checkpoint", default=None,
                    help="import pretrained torch weights (resnet only)")
    ap.add_argument("--onnx", default=None,
                    help="import an ONNX model file (conv/bn/gemm/pool/"
                         "softmax-class graphs; the reference's model-entry "
                         "path, examples/ONNX/resnet50/build.py)")
    ap.add_argument("--verify-dir", default=None,
                    help="ONNX zoo test_data_set dir: run input_*.pb "
                         "through the imported model and check output_*.pb")
    ap.add_argument("--device", default=None,
                    help="where to build (default: the CUDA card; 'cpu' "
                         "for the host)")
    args = ap.parse_args(argv)

    import numpy as np

    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.runtime import Runtime
    from tpulab_torch.models import build_model

    device = resolve_device(args.device)
    kwargs = dict(max_batch_size=args.max_batch, device=device)
    if args.uint8 and args.model.startswith("resnet"):
        kwargs["input_dtype"] = np.uint8
    if args.onnx:
        from tpulab_torch.models.onnx_import import load_onnx_model
        model = load_onnx_model(args.onnx, max_batch_size=args.max_batch,
                                device=device)
        if args.verify_dir:
            # golden vectors are float references: verify the float
            # import (int8 error ~% can never meet float tolerances),
            # then quantize the verified model
            _verify_onnx(model, args.verify_dir, device)
        if args.int8:
            model = load_onnx_model(args.onnx,
                                    max_batch_size=args.max_batch,
                                    weight_quant="int8", device=device)
    elif args.torch_checkpoint:
        if not args.model.startswith("resnet"):
            ap.error("--torch-checkpoint supports resnet models only")
        from tpulab_torch.models.torch_import import make_resnet_from_torch
        depth = int(args.model.replace("resnet", "") or 50)
        model = make_resnet_from_torch(args.torch_checkpoint, depth=depth,
                                       **kwargs)
    else:
        model = build_model(args.model, **kwargs)
    if args.int8 and not args.onnx:  # --onnx quantizes at import above
        if not args.model.startswith("resnet"):
            ap.error("--int8 quantization supports resnet and onnx models")
        from tpulab_torch.models.quantization import quantize_resnet_params
        model.params = quantize_resnet_params(model.params)

    t0 = time.time()
    runtime = Runtime(device)
    compiled = runtime.compile_model(model)
    runtime.save_engine(compiled, args.out)
    print(json.dumps({
        "engine": args.out,
        "model": model.name,
        "buckets": model.batch_buckets,
        "weights_bytes": model.weights_size_in_bytes(),
        "build_s": round(time.time() - t0, 1),
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
