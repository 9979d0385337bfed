"""ImageClient: classify image files against a serving endpoint
(reference examples/Deployment/ImageClient — the deployment companion that
feeds real JPEGs to the inference service and renders top-k labels).

Decodes + resizes images host-side (PIL), ships uint8 HWC tensors (the
INT8-parity ingress: normalization runs on the device), prints top-k
classes.  The port of tpulab's ``tools/image_client.py``.

    python -m tpulab_torch.tools.image_client --host localhost:50051 \
        --model resnet50 img1.jpg img2.jpg [--topk 5] \
        [--labels imagenet_labels.txt]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def load_image(path: str, size: int = 224, dtype=np.uint8) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    # center-crop the short side then resize (standard eval preprocessing)
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2,
                    (w + s) // 2, (h + s) // 2)).resize((size, size))
    arr = np.asarray(img, np.uint8)
    if np.dtype(dtype) != np.uint8:  # float ingress: normalize host-side
        # per-channel ImageNet constants — must match the on-device uint8
        # path (tpulab_torch/models/resnet.py IMAGENET_MEAN/STD)
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        arr = ((arr.astype(np.float32) / 255.0 - mean) / std).astype(dtype)
    return arr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("images", nargs="+")
    ap.add_argument("--host", default="localhost:50051")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--labels", default=None,
                    help="text file, one class label per line")
    args = ap.parse_args(argv)

    labels = None
    if args.labels:
        with open(args.labels) as f:
            labels = [ln.strip() for ln in f]

    from tpulab_torch.rpc.infer_service import RemoteInferenceManager
    remote = RemoteInferenceManager(args.host)
    try:
        runner = remote.infer_runner(args.model)
        binding, (shape, dtype) = next(iter(runner.input_bindings().items()))
        size = shape[0] if shape else 224

        batch = np.stack([load_image(p, size, dtype) for p in args.images])
        t0 = time.perf_counter()
        out = runner.infer(**{binding: batch}).result(timeout=300)
        dt = time.perf_counter() - t0
        name, logits = next(iter(out.items()))
        for i, path in enumerate(args.images):
            row = np.asarray(logits[i], np.float32)
            top = np.argsort(row)[::-1][:args.topk]
            pretty = ", ".join(
                (labels[j] if labels and j < len(labels) else f"class {j}")
                + f" ({row[j]:.2f})" for j in top)
            print(f"{path}: {pretty}")
        print(f"{len(args.images)} images in {dt * 1000:.1f} ms "
              f"({len(args.images) / dt:.1f} img/s)", file=sys.stderr)
    finally:
        remote.close()


if __name__ == "__main__":
    main()
