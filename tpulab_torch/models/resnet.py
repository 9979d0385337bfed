"""ResNet v1.5 (50 / 101 / 152) — the port of ``tpulab/models/resnet.py``.

The parameter tree has tpulab's keys, shapes and layouts: conv units
``{"kernel": (kh, kw, cin, cout) HWIO, "scale": (cout,), "bias": (cout,)}``
(inference BatchNorm folded into ``scale`` and ``bias``), ``stem``,
``s{stage}b{block}.{conv1,conv2,conv3,proj}`` and ``fc.{kernel (cin,
classes), bias}``.  Inputs are NHWC images (binding ``input``, output
``logits``).

How the port computes tpulab's function:
- activations run as NCHW views in ``channels_last`` memory (an NHWC
  input permuted is exactly that, so no copy is made), kernels as OIHW;
- ``padding="SAME"`` is JAX's, which is asymmetric at stride 2 (the 7x7
  stem pads (2, 3), a 3x3/2 conv on 56 pads (0, 1)): an explicit
  ``F.pad`` where the two sides differ, then ``padding=0``;
- the max pool is a 3x3/2 window padded (1, 1) with -inf, which is
  ``F.max_pool2d(3, 2, padding=1)``;
- uint8 inputs are normalized in the compute dtype step by step as
  tpulab rounds them: ``mean = c(MEAN) * 255``, ``std = c(STD) * 255``,
  ``(c(x) - mean) / std``;
- the folded-BN epilogue and the residual add run in the compute dtype;
  the global average pool sums in f32 and divides in f32 (``jnp.mean``
  over bf16), then rounds to the compute dtype; the head is f32.

The int8 units of ``models/quantization.py`` (``kernel`` int8 HWIO with a
per-output-channel ``kernel_scale``):
- W8 (no ``act_scale``): the int8 kernel stays resident and each forward
  dequantizes it as tpulab does, ``kernel.to(c) * kernel_scale.to(c)``
  in the compute dtype ``c``, then convolves as above;
- W8A8 (``act_scale``): the activation is quantized in f32 (round half to
  even, clip to +-127), the convolution runs int8 x int8 with exact int32
  accumulation (:func:`int8_conv`: the SAME-padded windows gathered into
  rows, then one integer matrix product, ``torch._int_mm`` on the card),
  and the f32 epilogue ``y * (act_scale * kernel_scale)`` rounds to ``c``.
  Exact integers on both sides: the int32 accumulators equal JAX's
  ``preferred_element_type=int32`` convolution bit for bit.

:func:`place_resnet_params` is the model's placement: every float kernel
becomes an OIHW ``channels_last`` copy in the compute dtype once (the same
bits as tpulab's per-call ``kernel.astype(compute_dtype)``), so a forward
casts no float weight; an int8 kernel stays as it is, int8 HWIO.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, Any]

STAGE_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

def _stride(stage: int, block: int) -> int:
    return 2 if (block == 0 and stage > 0) else 1


def init_resnet_params(depth: int = 50, num_classes: int = 1000,
                       seed: int = 0, device=None,
                       dtype=torch.float32) -> Tree:
    """Random He-init kernels and an N(0, 0.01) head, BN folded to the
    identity, with tpulab's shapes, drawn from one seeded
    ``torch.Generator`` on ``device`` (``None`` = the CUDA card).  The
    draws differ from ``jax.random``'s: to compare with tpulab, bring its
    weights over with :func:`tpulab_torch.models.convert.tree_from_numpy`."""
    from tpulab_torch.cuda.platform import resolve_device

    if depth not in (50, 101, 152):
        raise ValueError(f"unsupported ResNet depth {depth}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, std):
        w = torch.empty(shape, dtype=dtype, device=dev)
        return w.normal_(0.0, std, generator=gen)

    def conv_bn(kh, kw, cin, cout):
        return {"kernel": normal((kh, kw, cin, cout),
                                 math.sqrt(2.0 / (kh * kw * cin))),
                "scale": torch.ones((cout,), dtype=dtype, device=dev),
                "bias": torch.zeros((cout,), dtype=dtype, device=dev)}

    params: Tree = {"stem": conv_bn(7, 7, 3, 64)}
    cin = 64
    for stage, blocks in enumerate(STAGE_SIZES[depth]):
        cmid = 64 * (2 ** stage)
        cout = cmid * 4
        for block in range(blocks):
            p = {"conv1": conv_bn(1, 1, cin, cmid),
                 "conv2": conv_bn(3, 3, cmid, cmid),
                 "conv3": conv_bn(1, 1, cmid, cout)}
            if _stride(stage, block) != 1 or cin != cout:
                p["proj"] = conv_bn(1, 1, cin, cout)
            params[f"s{stage}b{block}"] = p
            cin = cout
    params["fc"] = {"kernel": normal((cin, num_classes), 0.01),
                    "bias": torch.zeros((num_classes,), dtype=dtype,
                                        device=dev)}
    return params


# ---------------------------------------------------------------- conv math
def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """JAX's ``padding="SAME"`` for one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """``conv_general_dilated(x, w, stride, "SAME")`` on NCHW ``x`` and
    OIHW ``w``."""
    ph = same_pads(x.shape[2], w.shape[2], stride)
    pw = same_pads(x.shape[3], w.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w,
                    stride=stride)


def oihw(kernel: torch.Tensor, dtype) -> torch.Tensor:
    """An HWIO kernel as an OIHW ``channels_last`` tensor of ``dtype``
    (the cast first: the same bits as JAX's ``kernel.astype(dtype)``)."""
    return kernel.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def _conv_weight(p: Tree, compute_dtype) -> torch.Tensor:
    """A unit's float kernel: placed (``"w"``), W8 dequantized now
    (tpulab's rounding: cast, then the per-channel scale, in the compute
    dtype) or converted now."""
    if "w" in p:
        return p["w"]
    kernel = p["kernel"]
    if kernel.dtype == torch.int8:
        kernel = kernel.to(compute_dtype) * p["kernel_scale"].to(
            compute_dtype)
    return oihw(kernel, compute_dtype)


def int8_matmul(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b_nk.T`` -> (M, N) int32, exact.  On the card one
    ``torch._int_mm`` (cuBLASLt int8 GEMM, int32 accumulation; it takes
    K and N in multiples of 8 and M > 16: zero rows and columns pad them,
    which adds nothing); on the CPU the product in int64.  There is no
    float route."""
    if a.device.type != "cuda":
        return (a.to(torch.int64) @ b_nk.to(torch.int64).T).to(torch.int32)
    m, k = a.shape
    n = b_nk.shape[0]
    pk, pn, pm = -k % 8, -n % 8, max(17 - m, 0)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b_nk = F.pad(b_nk, (0, pk, 0, pn))
    y = torch._int_mm(a.contiguous(), b_nk.contiguous().T)
    return y[:m, :n]


def int8_conv(xq: torch.Tensor, rows: torch.Tensor, stride: int
              ) -> torch.Tensor:
    """JAX's ``conv_general_dilated(xq, kernel, stride, "SAME",
    preferred_element_type=int32)`` of an int8 NCHW ``xq`` and an int8
    ``(cout, kh, kw, cin)`` kernel: the zero-padded windows gathered into
    ``(N*Ho*Wo, kh*kw*cin)`` rows (a view for 1x1 / stride 1), one exact
    integer product, the int32 result as NCHW (``channels_last``)."""
    cout, kh, kw, cin = rows.shape
    ph = same_pads(xq.shape[2], kh, stride)
    pw = same_pads(xq.shape[3], kw, stride)
    x = F.pad(xq, (pw[0], pw[1], ph[0], ph[1])) if ph[1] or pw[1] else xq
    nhwc = x.permute(0, 2, 3, 1)
    if kh == kw == 1:
        win = nhwc[:, ::stride, ::stride]
        ho, wo = win.shape[1], win.shape[2]
        cols = win.reshape(-1, cin)
    else:
        win = nhwc.unfold(1, kh, stride).unfold(2, kw, stride)
        ho, wo = win.shape[1], win.shape[2]
        # (N, Ho, Wo, C, kh, kw) -> rows in the kernel's (kh, kw, C) order
        cols = win.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * cin)
    y = int8_matmul(cols, rows.reshape(cout, -1))
    return y.reshape(xq.shape[0], ho, wo, cout).permute(0, 3, 1, 2)


def quantize_activation(x: torch.Tensor, act_scale: torch.Tensor
                        ) -> torch.Tensor:
    """``clip(round(x / act_scale), -127, 127)`` in f32 as int8 (round half
    to even; ``act_scale`` a tensor on ``x``'s device, so the card divides
    instead of multiplying by a reciprocal)."""
    q = torch.round(x.to(torch.float32) / act_scale.to(torch.float32))
    return q.clamp_(-127, 127).to(torch.int8)


def _conv_bn(p: Tree, x, stride: int, relu: bool, compute_dtype,
             name: str = "", observe=None):
    if observe is not None:
        # calibration: this unit's input activation absmax
        observe[name] = x.to(torch.float32).abs().amax()
    if "act_scale" in p:                               # W8A8
        act_scale = p["act_scale"].to(torch.float32)
        acc = int8_conv(quantize_activation(x, act_scale),
                        p["kernel"].permute(3, 0, 1, 2), stride)
        y = (acc.to(torch.float32)
             * (act_scale * p["kernel_scale"].to(torch.float32))[
                 :, None, None]).to(compute_dtype)
    else:
        y = conv_same(x.to(compute_dtype), _conv_weight(p, compute_dtype),
                      stride)
    y = y * p["scale"].to(compute_dtype)[:, None, None]
    y = y + p["bias"].to(compute_dtype)[:, None, None]
    return F.relu(y) if relu else y


def _bottleneck(p: Tree, x, stride: int, compute_dtype, name: str = "",
                observe=None):
    """v1.5 bottleneck: the stride on the 3x3 conv."""
    y = _conv_bn(p["conv1"], x, 1, True, compute_dtype, f"{name}/conv1",
                 observe)
    y = _conv_bn(p["conv2"], y, stride, True, compute_dtype,
                 f"{name}/conv2", observe)
    y = _conv_bn(p["conv3"], y, 1, False, compute_dtype, f"{name}/conv3",
                 observe)
    residual = (_conv_bn(p["proj"], x, stride, False, compute_dtype,
                         f"{name}/proj", observe)
                if "proj" in p else x)
    return F.relu(y + residual.to(y.dtype))


def norm_stats(device, compute_dtype, mean=None, std=None):
    """The uint8 normalization's ``(c(mean) * 255, c(std) * 255)``, each
    product rounded in the compute dtype ``c``; ``mean`` / ``std`` (a
    checkpoint's own statistics) default to ImageNet's."""
    def stat(v, default):
        t = (torch.tensor(default, dtype=compute_dtype, device=device)
             if v is None else v.to(compute_dtype))
        return t * 255.0

    return stat(mean, IMAGENET_MEAN), stat(std, IMAGENET_STD)


def normalize_uint8(x: torch.Tensor, compute_dtype, stats) -> torch.Tensor:
    """``(c(x) - mean) / std`` in the compute dtype (``stats`` from
    :func:`norm_stats`)."""
    return (x.to(compute_dtype) - stats[0]) / stats[1]


def mean_hw(y: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(y, axis=(1, 2))`` of an NHWC ``y`` given as NCHW: the sum
    in f32, divided in f32 (by a tensor: CUDA divides by a Python scalar
    through its reciprocal), rounded to ``y``'s dtype."""
    s = y.sum(dim=(2, 3), dtype=torch.float32)
    return (s / torch.full_like(s, y.shape[2] * y.shape[3])).to(y.dtype)


def resnet_apply(params: Tree, inputs: Dict[str, torch.Tensor],
                 depth: int = 50, compute_dtype=torch.bfloat16,
                 observe: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Forward: NHWC image -> logits (B, classes) f32.  ``params`` is
    tpulab's tree or its placed form (:func:`place_resnet_params`);
    ``observe`` (a dict) records each conv unit's input absmax (a 0-d f32
    tensor) under tpulab's names (``stem``, ``s0b0/conv1``, ...)."""
    x = inputs["input"]
    if x.dtype == torch.uint8:
        stats = params.get("input_norm") or norm_stats(x.device,
                                                       compute_dtype)
        x = normalize_uint8(x, compute_dtype, stats)
    x = x.permute(0, 3, 1, 2)                    # NCHW view, channels_last
    y = _conv_bn(params["stem"], x, 2, True, compute_dtype, "stem", observe)
    y = F.max_pool2d(y, 3, 2, padding=1)
    for stage, blocks in enumerate(STAGE_SIZES[depth]):
        for block in range(blocks):
            y = _bottleneck(params[f"s{stage}b{block}"], y,
                            _stride(stage, block), compute_dtype,
                            f"s{stage}b{block}", observe)
    y = mean_hw(y)
    fc = params["fc"]
    return {"logits": y.to(torch.float32) @ fc["kernel"].to(torch.float32)
            + fc["bias"].to(torch.float32)}


def resnet_collect_amax(params: Tree, x: torch.Tensor, depth: int = 50,
                        compute_dtype=torch.float32) -> Dict[str, Any]:
    """Calibration forward: each conv unit's input-activation absmax (a
    0-d f32 tensor on ``x``'s device) by tpulab's unit names."""
    observe: Dict[str, Any] = {}
    with torch.inference_mode():
        resnet_apply(params, {"input": x}, depth, compute_dtype,
                     observe=observe)
    return observe


def place_resnet_params(params: Tree, device,
                        compute_dtype=torch.bfloat16) -> Tree:
    """The placed tree: each float conv unit as ``{"w": OIHW channels_last
    in the compute dtype, "scale", "bias"}`` (the vectors in the compute
    dtype), an int8 unit's kernel and f32 scales as they are, the f32
    head, and the uint8 normalization's two rounded vectors under
    ``input_norm``; all on ``device``."""
    dev = torch.device(device)

    def unit(p):
        out = {k: v.to(dev) for k, v in p.items()}
        out["scale"] = p["scale"].to(dev, compute_dtype)
        out["bias"] = p["bias"].to(dev, compute_dtype)
        if out["kernel"].dtype != torch.int8:
            out["w"] = oihw(out.pop("kernel"), compute_dtype)
        return out

    out: Tree = {"input_norm": norm_stats(dev, compute_dtype)}
    for name, node in params.items():
        if name == "fc":
            out[name] = {k: v.to(dev) for k, v in node.items()}
        elif "kernel" in node:                       # the stem
            out[name] = unit(node)
        else:                                        # a bottleneck
            out[name] = {k: unit(p) for k, p in node.items()}
    return out


def make_resnet(depth: int = 50, num_classes: int = 1000,
                image_size: int = 224, max_batch_size: int = 8,
                compute_dtype=torch.bfloat16, seed: int = 0,
                input_dtype=np.float32, batch_buckets=None,
                params: Optional[Tree] = None, device=None):
    """A servable ResNet :class:`~tpulab_torch.engine.model.Model`.

    ``input_dtype=np.uint8`` takes raw pixel bytes and normalizes on the
    device; ``params`` reuses a tree (else one is drawn on ``device``)."""
    from tpulab_torch.engine.model import IOSpec, Model

    if params is None:
        params = init_resnet_params(depth, num_classes, seed, device)
    return Model(
        name=f"resnet{depth}",
        apply_fn=partial(resnet_apply, depth=depth,
                         compute_dtype=compute_dtype),
        params=params,
        inputs=[IOSpec("input", (image_size, image_size, 3), input_dtype)],
        outputs=[IOSpec("logits", (num_classes,), np.float32)],
        max_batch_size=max_batch_size,
        batch_buckets=batch_buckets,
        place_fn=partial(place_resnet_params, compute_dtype=compute_dtype),
    )
