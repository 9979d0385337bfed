"""MNIST convnet — the port of ``tpulab/models/mnist.py`` (the model the
CPU tests serve; binding names mirror the onnx model: ``Input3`` ->
``Plus214_Output_0``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from tpulab_torch.models.resnet import conv_same, oihw

Tree = Dict[str, Any]


def init_mnist_params(seed: int = 0, device=None) -> Tree:
    """Random weights with tpulab's shapes (HWIO kernels), drawn from one
    seeded ``torch.Generator`` on ``device`` (``None`` = the CUDA card)."""
    from tpulab_torch.cuda.platform import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, std):
        return torch.empty(shape, device=dev).normal_(0.0, std, generator=gen)

    return {
        "conv1": {"kernel": normal((5, 5, 1, 8), 0.1),
                  "bias": torch.zeros((8,), device=dev)},
        "conv2": {"kernel": normal((5, 5, 8, 16), 0.1),
                  "bias": torch.zeros((16,), device=dev)},
        "fc": {"kernel": normal((7 * 7 * 16, 10), 0.05),
               "bias": torch.zeros((10,), device=dev)},
    }


def mnist_apply(params: Tree, inputs: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """NHWC 28x28x1 image -> 10 logits, f32.  The head flattens in NHWC
    order, as tpulab's does."""
    x = inputs["Input3"].permute(0, 3, 1, 2)
    for layer in ("conv1", "conv2"):
        p = params[layer]
        w = p["w"] if "w" in p else oihw(p["kernel"], torch.float32)
        x = F.relu(conv_same(x, w) + p["bias"][:, None, None])
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    logits = x @ params["fc"]["kernel"] + params["fc"]["bias"]
    return {"Plus214_Output_0": logits}


def place_mnist_params(params: Tree, device) -> Tree:
    """The placed tree: OIHW kernels (``"w"``) and the head on ``device``."""
    dev = torch.device(device)
    out = {layer: {"w": oihw(params[layer]["kernel"].to(dev), torch.float32),
                   "bias": params[layer]["bias"].to(dev)}
           for layer in ("conv1", "conv2")}
    out["fc"] = {k: v.to(dev) for k, v in params["fc"].items()}
    return out


def make_mnist(max_batch_size: int = 8, seed: int = 0, device=None,
               params=None):
    """A servable MNIST :class:`~tpulab_torch.engine.model.Model`."""
    from tpulab_torch.engine.model import IOSpec, Model

    return Model(
        name="mnist",
        apply_fn=mnist_apply,
        params=params if params is not None
        else init_mnist_params(seed, device),
        inputs=[IOSpec("Input3", (28, 28, 1), np.float32)],
        outputs=[IOSpec("Plus214_Output_0", (10,), np.float32)],
        max_batch_size=max_batch_size,
        place_fn=place_mnist_params,
    )
