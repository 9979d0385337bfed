"""Weight-only INT8 (W8A16) for the transformer family — the port of the
transformer half of ``tpulab/models/quantization.py``.

Every per-layer projection (``wqkv``, ``wo``, ``w1``, ``w2``, ``w3``)
and, by default, the untied ``lm_head`` becomes ``{"w_int8": (I, O)
int8, "scale": (O,) f32}``: per-output-column symmetric absmax, computed
in f32 as tpulab computes it in numpy (``scale = absmax / 127``, 1 where
a column is all zeros; round half to even; clip to +-127), so the int8
values and scales are bit-identical to tpulab's for the same f32 or bf16
input.  Embeddings and norms stay float.  The forwards dequantize through
:func:`tpulab_torch.models.transformer.qmat`.

The int8 values and scales are bit-identical to tpulab's for the same
f32 tree (f32 arithmetic, divisions by tensors).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch


def _absmax_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``where(absmax > 0, absmax / 127, 1)`` in f32 (a tensor divisor:
    CUDA divides by a Python scalar as a product with its reciprocal,
    which is not numpy's correctly rounded division)."""
    return torch.where(absmax > 0,
                       absmax / torch.full_like(absmax, 127.0),
                       torch.ones_like(absmax))


def _quantize_kernel(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of an HWIO kernel,
    on its device."""
    k = kernel.detach().to(torch.float32)
    absmax = k.abs().reshape(-1, k.shape[-1]).amax(dim=0)  # per O channel
    scale = _absmax_scale(absmax)
    q = torch.round(k / scale).clamp_(-127, 127).to(torch.int8)
    return {"kernel": q, "kernel_scale": scale}


def quantize_resnet_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Every conv kernel (stem and blocks) as weight-only INT8; the
    folded-BN scale / bias and the FC head stay float (the W8A8 walker
    with no activation ranges)."""
    return quantize_resnet_params_w8a8(params, {})


def calibrate_resnet(params: Dict[str, Any], batches: Iterable,
                     depth: int = 50) -> Dict[str, float]:
    """Per-conv-unit activation absmax over calibration batches (NHWC
    images, numpy or tensors on any device, taken as f32), each forward
    at f32 on the params' device; one host read of all the unit maxima a
    batch."""
    from tpulab_torch.models.resnet import resnet_collect_amax

    dev = _device_of(params)
    ranges: Dict[str, float] = {}
    for x in batches:
        x = _to_device(x, dev, torch.float32)
        amax = resnet_collect_amax(params, x, depth=depth)
        values = torch.stack(list(amax.values())).tolist()
        for name, v in zip(amax, values):
            ranges[name] = max(ranges.get(name, 0.0), float(v))
    return ranges


def quantize_resnet_params_w8a8(params: Dict[str, Any],
                                act_ranges: Dict[str, float]
                                ) -> Dict[str, Any]:
    """Full INT8 (W8A8): int8 kernels per channel + calibrated per-unit
    activation scales; the convolutions run int8 x int8 -> int32."""

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            if "kernel" in tree and "scale" in tree:  # a conv+bn unit
                out = dict(tree)
                out.update(_quantize_kernel(tree["kernel"]))
                amax = act_ranges.get(prefix.lstrip("/"))
                if amax is not None and amax > 0:
                    out["act_scale"] = torch.tensor(
                        amax / 127.0, dtype=torch.float32,
                        device=tree["kernel"].device)
                return out
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        return tree

    return walk(params)


def quantized_bytes(params: Dict[str, Any]) -> int:
    """Bytes of every tensor leaf, quantized entries at their stored
    width."""
    from tpulab_torch.cuda.allocators import _nbytes
    return _nbytes(params)


def _to_device(x, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor (on any device) as a tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device, dtype) if dtype is not None else t.to(device)


def _device_of(tree) -> torch.device:
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _device_of(v)
            if dev is not None:
                return dev
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


class Calibrator:
    """Activation-range calibrator: streams batches (dicts of numpy
    arrays) through ``apply_fn`` on the params' device and accumulates
    per-point absmax.  The recorded ranges are the calibration cache."""

    def __init__(self, apply_fn, params):
        self._apply = apply_fn
        self._params = params
        self._device = _device_of(params) or torch.device("cpu")
        self.ranges: Dict[str, float] = {}

    def observe(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            amax = float(value.detach().to(torch.float32).abs().max())
        else:
            amax = float(np.abs(np.asarray(value, np.float32)).max())
        self.ranges[name] = max(self.ranges.get(name, 0.0), amax)

    def run(self, batches: Iterable[Dict[str, np.ndarray]],
            output_names: Optional[Iterable[str]] = None) -> Dict[str, float]:
        """Default instrumentation: records input bindings and outputs.
        Models wanting per-layer ranges call ``observe`` from their apply."""
        for batch in batches:
            for name, arr in batch.items():
                self.observe(f"input:{name}", arr)
            inputs = {k: _to_device(v, self._device)
                      for k, v in batch.items()}
            with torch.inference_mode():
                out = self._apply(self._params, inputs)
            for name, arr in out.items():
                if output_names is None or name in output_names:
                    self.observe(f"output:{name}", arr)
        return dict(self.ranges)

    # -- calibration cache ---------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.ranges, f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> Dict[str, float]:
        with open(path) as f:
            return json.load(f)

#: transformer weight matrices eligible for weight-only quantization
TRANSFORMER_QUANT_KEYS = ("wqkv", "wo", "w1", "w2", "w3")


def quantize_matrix(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-column symmetric int8 quantization of a 2D (I, O)
    weight matrix, on ``w``'s device (tpulab's ``_quantize_matrix``)."""
    w = w.detach().to(torch.float32)
    absmax = w.abs().amax(dim=0)                       # per O column
    scale = _absmax_scale(absmax)
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return {"w_int8": q, "scale": scale}


def quantize_transformer_params(params, quantize_lm_head: bool = True
                                ) -> Dict[str, Any]:
    """Weight-only INT8 of a transformer tree (or
    :class:`~tpulab_torch.models.transformer.Transformer`): a new tree
    whose projections (and, unless ``quantize_lm_head=False``, the untied
    ``lm_head``) are ``{"w_int8", "scale"}`` entries; every other leaf is
    the input's own tensor (no copy)."""
    from tpulab_torch.models.transformer import _tree

    out: Dict[str, Any] = {}
    for name, sub in _tree(params).items():
        if name.startswith("layer"):
            out[name] = {k: (quantize_matrix(v)
                             if k in TRANSFORMER_QUANT_KEYS else v)
                         for k, v in sub.items()}
        elif name == "lm_head" and quantize_lm_head:
            out[name] = quantize_matrix(sub)
        else:
            out[name] = sub
    return out


def transformer_param_bytes(params) -> int:
    """Total parameter bytes of a tree or module, quantized entries at
    their stored width."""
    from tpulab_torch.models.transformer import _tree

    def walk(node) -> int:
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return node.numel() * node.element_size()

    return walk(_tree(params))
