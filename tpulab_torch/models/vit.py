"""Vision Transformer family (ViT-S/B/L at /16 or /32) — the port of
``tpulab/models/vit.py``.

The tree has tpulab's keys: ``patch_embed`` (p*p*C, d), ``cls`` (d,),
``pos_embed`` (N+1, d), ``final_norm``, ``head.{kernel, bias}`` and
``layer{i}.{ln1, ln2, wqkv, wo, w1, w2}``.  The patch embedding is one
reshape and one matmul; the blocks reuse the transformer's ``_rmsnorm``,
``dense_attention`` (non-causal) and ``qmat``.

Two weight dialects share :func:`vit_apply`, keyed as tpulab keys them
on ``"bias" in params["final_norm"]``: the in-house one (RMSNorm, no
biases, tanh-gelu) and classic imported checkpoints (LayerNorm with bias,
statistics in f32; biased projections ``patch_bias``, ``bqkv``, ``bo``,
``b1``, ``b2``; exact erf-gelu; the processor's ``norm_mean`` /
``norm_std``).

:func:`place_vit_params` casts every leaf the forward only ever reads in
the compute dtype to that dtype once (the same bits as tpulab's per-call
``astype``); the f32 head and a LayerNorm's ``eps`` stay as they are.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpulab_torch.models.resnet import norm_stats, normalize_uint8
from tpulab_torch.models.transformer import (_mm, _rmsnorm, dense_attention,
                                             qmat)

Tree = Dict[str, Any]

_GEOMETRIES = {  # name -> (d_model, n_heads, n_layers, d_ff)
    "s": (384, 6, 12, 1536),
    "b": (768, 12, 12, 3072),
    "l": (1024, 16, 24, 4096),
}


def init_vit_params(variant: str = "s", image_size: int = 224,
                    patch_size: int = 16, num_classes: int = 1000,
                    seed: int = 0, device=None,
                    dtype=torch.float32) -> Tree:
    """Random in-house weights (N(0, 0.02), unit norms) with tpulab's
    shapes, drawn from one seeded ``torch.Generator`` on ``device``
    (``None`` = the CUDA card); the draws differ from ``jax.random``'s."""
    from tpulab_torch.cuda.platform import resolve_device

    d_model, _n_heads, n_layers, d_ff = _GEOMETRIES[variant]
    if image_size % patch_size:
        raise ValueError(f"image {image_size} not divisible by patch "
                         f"{patch_size}")
    n_patches = (image_size // patch_size) ** 2
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(*shape):
        w = torch.empty(shape, dtype=dtype, device=dev)
        return w.normal_(0.0, 0.02, generator=gen)

    def ones():
        return {"scale": torch.ones((d_model,), dtype=dtype, device=dev)}

    params: Tree = {
        "patch_embed": normal(patch_size * patch_size * 3, d_model),
        "cls": normal(d_model),
        "pos_embed": normal(n_patches + 1, d_model),
        "final_norm": ones(),
        "head": {"kernel": normal(d_model, num_classes),
                 "bias": torch.zeros((num_classes,), dtype=dtype,
                                     device=dev)},
    }
    for i in range(n_layers):
        params[f"layer{i}"] = {
            "ln1": ones(), "ln2": ones(),
            "wqkv": normal(d_model, 3 * d_model),
            "wo": normal(d_model, d_model),
            "w1": normal(d_model, d_ff),
            "w2": normal(d_ff, d_model),
        }
    return params


def _norm(x, np_: Tree, compute_dtype):
    """RMSNorm (``{scale}``), or LayerNorm when the tree carries a bias
    (``{scale, bias[, eps]}``): statistics in f32, the output in the
    compute dtype."""
    if "bias" in np_:
        eps = np_.get("eps", 1e-6)
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        xn = ((xf - mu) * torch.rsqrt(var + eps)).to(compute_dtype)
        return (xn * np_["scale"].to(compute_dtype)
                + np_["bias"].to(compute_dtype)).to(compute_dtype)
    return _rmsnorm(x, np_["scale"].to(compute_dtype))


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, p*p*C): patches in row-major order, each
    flattened (row, column, channel) — the rows of ``patch_embed``."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hh // p) * (ww // p), p * p * c)


def _badd(h, lp: Tree, key: str, compute_dtype):
    b = lp.get(key)
    return h if b is None else h + b.to(compute_dtype)


def vit_apply(params: Tree, inputs: Dict[str, torch.Tensor],
              n_heads: int, n_layers: int, patch_size: int = 16,
              compute_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Forward: NHWC image -> logits (B, classes) f32 (binding names
    ``input`` / ``logits``); uint8 inputs are normalized on the device."""
    x = inputs["input"]
    if x.dtype == torch.uint8:
        stats = params.get("input_norm") or norm_stats(
            x.device, compute_dtype, params.get("norm_mean"),
            params.get("norm_std"))
        x = normalize_uint8(x, compute_dtype, stats)
    else:
        x = x.to(compute_dtype)
    classic = "bias" in params["final_norm"]
    b = x.shape[0]
    x = _mm(patchify(x, patch_size), qmat(params["patch_embed"],
                                          compute_dtype))
    if "patch_bias" in params:
        x = x + params["patch_bias"].to(compute_dtype)
    cls = params["cls"].to(compute_dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(compute_dtype)[None]
    t, d_model = x.shape[1], x.shape[2]
    head_dim = d_model // n_heads
    for i in range(n_layers):
        lp = params[f"layer{i}"]
        h = _norm(x, lp["ln1"], compute_dtype)
        qkv = _badd(_mm(h, qmat(lp["wqkv"], compute_dtype)), lp, "bqkv",
                    compute_dtype)
        q, k, v = (qkv[..., j * d_model:(j + 1) * d_model]
                   .reshape(b, t, n_heads, head_dim) for j in range(3))
        attn = dense_attention(q, k, v, causal=False).reshape(b, t, d_model)
        x = x + _badd(_mm(attn, qmat(lp["wo"], compute_dtype)), lp, "bo",
                      compute_dtype)
        h = _norm(x, lp["ln2"], compute_dtype)
        h = _badd(_mm(h, qmat(lp["w1"], compute_dtype)), lp, "b1",
                  compute_dtype)
        h = F.gelu(h, approximate="none" if classic else "tanh")
        x = x + _badd(_mm(h, qmat(lp["w2"], compute_dtype)), lp, "b2",
                      compute_dtype).to(x.dtype)
    x = _norm(x, params["final_norm"], compute_dtype)
    head = params["head"]
    return {"logits": _mm(x[:, 0].to(torch.float32), head["kernel"])
            + head["bias"]}


def place_vit_params(params: Tree, device,
                     compute_dtype=torch.bfloat16) -> Tree:
    """The placed tree on ``device``: every floating leaf but the head's
    and a LayerNorm's ``eps`` cast to the compute dtype (int8 payloads
    untouched), plus the uint8 normalization's vectors (``input_norm``)."""
    dev = torch.device(device)

    def cast(node, key=""):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return node
        node = node.to(dev)
        return (node.to(compute_dtype)
                if node.is_floating_point() and key != "eps" else node)

    out = {k: (v if k == "head" else cast(v, k)) for k, v in params.items()}
    out["head"] = {k: v.to(dev) for k, v in params["head"].items()}
    out["input_norm"] = norm_stats(dev, compute_dtype, out.get("norm_mean"),
                                   out.get("norm_std"))
    return out


def make_vit(variant: str = "s", image_size: int = 224,
             patch_size: int = 16, num_classes: int = 1000,
             max_batch_size: int = 8, compute_dtype=torch.bfloat16,
             seed: int = 0, input_dtype=np.float32, batch_buckets=None,
             params: Optional[Tree] = None, device=None):
    """A servable ViT :class:`~tpulab_torch.engine.model.Model` (the same
    surface as :func:`~tpulab_torch.models.resnet.make_resnet`)."""
    from tpulab_torch.engine.model import IOSpec, Model

    _, n_heads, n_layers, _ = _GEOMETRIES[variant]
    if params is None:
        params = init_vit_params(variant, image_size, patch_size,
                                 num_classes, seed, device)
    return Model(
        name=f"vit_{variant}{patch_size}",
        apply_fn=partial(vit_apply, n_heads=n_heads, n_layers=n_layers,
                         patch_size=patch_size, compute_dtype=compute_dtype),
        params=params,
        inputs=[IOSpec("input", (image_size, image_size, 3), input_dtype)],
        outputs=[IOSpec("logits", (num_classes,), np.float32)],
        max_batch_size=max_batch_size,
        batch_buckets=batch_buckets,
        place_fn=partial(place_vit_params, compute_dtype=compute_dtype),
    )
