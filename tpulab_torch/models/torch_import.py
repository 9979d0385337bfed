"""Import pretrained PyTorch / Hugging Face weights into the port's models
(the port of ``tpulab/models/torch_import.py``).

- :func:`resnet_params_from_torch` maps a torchvision ResNet
  ``state_dict`` onto the ResNet tree, folding each BatchNorm into the
  conv's scale and bias in f32 numpy, as tpulab folds it
  (``scale = gamma / sqrt(var + eps)``, ``bias = beta - mean * scale``),
  kernels OIHW -> HWIO;
- :func:`llama_params_from_torch` maps an HF ``LlamaForCausalLM``
  ``state_dict`` onto the transformer tree (q / k / v fused into
  ``wqkv``, gate / up / down as ``w1`` / ``w3`` / ``w2``, Linear weights
  transposed to (in, out), an untied ``lm_head`` when present), every
  leaf f32 as tpulab's;
- :func:`vit_params_from_hf` maps an HF ``ViTForImageClassification``
  ``state_dict`` onto the classic ViT dialect (LayerNorm with bias and
  the config's eps, biased projections, erf-gelu, the processor's
  normalization statistics).

Each returns the port's tree on ``device`` (``None`` = the CUDA card),
equal bit for bit to :func:`tpulab_torch.models.convert.tree_from_numpy`
of tpulab's result.  A path loads with ``torch.load(...,
weights_only=True)``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Mapping

import numpy as np
import torch

from tpulab_torch.models.convert import tree_from_numpy

STAGE_BLOCKS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
BN_EPS = 1e-5


def _np(t) -> np.ndarray:
    """A leaf as f32 numpy (bf16 tensors through ``.float()``: numpy has
    no bfloat16)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _load(state_dict_or_path):
    if isinstance(state_dict_or_path, (str, bytes)):
        return torch.load(state_dict_or_path, map_location="cpu",
                          weights_only=True)
    return state_dict_or_path


def _fold_bn(sd: Mapping[str, Any], conv_key: str, bn_key: str
             ) -> Dict[str, np.ndarray]:
    w = _np(sd[f"{conv_key}.weight"])                         # OIHW
    gamma = _np(sd[f"{bn_key}.weight"])
    beta = _np(sd[f"{bn_key}.bias"])
    mean = _np(sd[f"{bn_key}.running_mean"])
    var = _np(sd[f"{bn_key}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    bias = beta - mean * scale
    return {
        "kernel": np.transpose(w, (2, 3, 1, 0)),              # -> HWIO
        "scale": scale,
        "bias": bias,
    }


def resnet_params_from_torch(state_dict: Mapping[str, Any],
                             depth: int = 50, device=None
                             ) -> Dict[str, Any]:
    """torchvision ResNet state_dict -> the ResNet tree on ``device``."""
    from tpulab_torch.cuda.platform import resolve_device

    if depth not in STAGE_BLOCKS:
        raise ValueError(f"unsupported depth {depth}")
    dev = resolve_device(device)
    sd = state_dict
    params: Dict[str, Any] = {"stem": _fold_bn(sd, "conv1", "bn1")}
    for stage, blocks in enumerate(STAGE_BLOCKS[depth]):
        for block in range(blocks):
            prefix = f"layer{stage + 1}.{block}"
            p = {
                "conv1": _fold_bn(sd, f"{prefix}.conv1", f"{prefix}.bn1"),
                "conv2": _fold_bn(sd, f"{prefix}.conv2", f"{prefix}.bn2"),
                "conv3": _fold_bn(sd, f"{prefix}.conv3", f"{prefix}.bn3"),
            }
            if f"{prefix}.downsample.0.weight" in sd:
                p["proj"] = _fold_bn(sd, f"{prefix}.downsample.0",
                                     f"{prefix}.downsample.1")
            params[f"s{stage}b{block}"] = p
    params["fc"] = {
        "kernel": _np(sd["fc.weight"]).T,
        "bias": _np(sd["fc.bias"]),
    }
    return tree_from_numpy(params, dev)


def make_resnet_from_torch(state_dict_or_path, depth: int = 50,
                           **make_kwargs):
    """A servable ResNet Model from a torch checkpoint (path or
    state_dict); ``make_kwargs`` go to
    :func:`~tpulab_torch.models.resnet.make_resnet` (``device`` is where
    the imported tree lives)."""
    from tpulab_torch.models.resnet import make_resnet

    params = resnet_params_from_torch(_load(state_dict_or_path), depth,
                                      make_kwargs.pop("device", None))
    return make_resnet(depth=depth, params=params, **make_kwargs)


# --------------------------------------------------------------------------
# Llama-family import (HF LlamaForCausalLM state_dict -> transformer tree)
# --------------------------------------------------------------------------

def llama_params_from_torch(state_dict: Mapping[str, Any],
                            n_layers: int = 0, device=None
                            ) -> Dict[str, Any]:
    """HF ``LlamaForCausalLM`` state_dict -> the transformer tree on
    ``device``, every leaf f32 (tpulab's ``.float()``; bf16 -> f32 is
    exact, so a bf16 compute dtype sees the checkpoint's own values).
    The conversion runs on ``device``: upcasts, transposes and the q / k
    / v concatenation are exact, so the leaves equal tpulab's numpy ones
    bit for bit.

    Serve the result with ``n_kv_heads`` and ``rope_theta`` from the HF
    config (``ContinuousBatcher(params, n_heads=cfg.num_attention_heads,
    n_kv_heads=cfg.num_key_value_heads, rope_theta=cfg.rope_theta,
    ...)``)."""
    from tpulab_torch.cuda.platform import resolve_device

    dev = resolve_device(device)
    sd = state_dict
    ckpt_layers = len({k.split(".")[2] for k in sd
                       if k.startswith("model.layers.")})
    if n_layers == 0:
        n_layers = ckpt_layers
    elif n_layers != ckpt_layers:
        raise ValueError(f"n_layers={n_layers} but the checkpoint has "
                         f"{ckpt_layers} decoder layers")

    def f32(key: str) -> torch.Tensor:
        t = sd[key]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.asarray(t, np.float32))
        return t.detach().to(dev, torch.float32)

    def lin(key: str) -> torch.Tensor:                 # (out, in) -> (in, out)
        return f32(key).T.contiguous()

    params: Dict[str, Any] = {
        "embed": f32("model.embed_tokens.weight").contiguous(),
        "final_norm": {"scale": f32("model.norm.weight").contiguous()},
    }
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        att = f"{pre}.self_attn"
        params[f"layer{i}"] = {
            "ln1": {"scale": f32(f"{pre}.input_layernorm.weight")
                    .contiguous()},
            "ln2": {"scale": f32(f"{pre}.post_attention_layernorm.weight")
                    .contiguous()},
            "wqkv": torch.cat([f32(f"{att}.{n}_proj.weight").T
                               for n in ("q", "k", "v")], dim=1),
            "wo": lin(f"{att}.o_proj.weight"),
            "w1": lin(f"{pre}.mlp.gate_proj.weight"),
            "w3": lin(f"{pre}.mlp.up_proj.weight"),
            "w2": lin(f"{pre}.mlp.down_proj.weight"),
        }
    if "lm_head.weight" in sd:
        params["lm_head"] = lin("lm_head.weight")
    return params


# --------------------------------------------------------------------------
# ViT import (HF ViTForImageClassification state_dict -> classic ViT tree)
# --------------------------------------------------------------------------

def vit_params_from_hf(state_dict: Mapping[str, Any],
                       layer_norm_eps: float = 1e-12,
                       image_mean=(0.5, 0.5, 0.5),
                       image_std=(0.5, 0.5, 0.5), device=None
                       ) -> Dict[str, Any]:
    """HF ``ViTForImageClassification`` state_dict -> the classic-dialect
    ViT tree on ``device``.  The patch embedding Conv2d(C, D, p, stride=p)
    becomes the patchify matmul's (p*p*C, D) weight (rows in
    ``vit_apply``'s (p_h, p_w, c) patch order); the uint8 normalization
    uses the checkpoint processor's statistics (HF ViT: 0.5 / 0.5)."""
    from tpulab_torch.cuda.platform import resolve_device

    dev = resolve_device(device)
    sd = state_dict
    n_layers = len({k.split(".")[3] for k in sd
                    if k.startswith("vit.encoder.layer.")})
    proj = _np(sd["vit.embeddings.patch_embeddings.projection.weight"])
    eps = np.float32(layer_norm_eps)
    params: Dict[str, Any] = {
        "cls": _np(sd["vit.embeddings.cls_token"]).reshape(-1),
        "pos_embed": _np(sd["vit.embeddings.position_embeddings"])[0],
        # (D, C, p, p) -> (p, p, C, D) -> (p*p*C, D)
        "patch_embed": np.transpose(proj, (2, 3, 1, 0)).reshape(
            -1, proj.shape[0]),
        "patch_bias": _np(
            sd["vit.embeddings.patch_embeddings.projection.bias"]),
        "final_norm": {"scale": _np(sd["vit.layernorm.weight"]),
                       "bias": _np(sd["vit.layernorm.bias"]),
                       "eps": eps},
        "head": {"kernel": _np(sd["classifier.weight"]).T,
                 "bias": _np(sd["classifier.bias"])},
        "norm_mean": np.asarray(image_mean, np.float32),
        "norm_std": np.asarray(image_std, np.float32),
    }
    for i in range(n_layers):
        pre = f"vit.encoder.layer.{i}"
        att = f"{pre}.attention.attention"
        params[f"layer{i}"] = {
            "ln1": {"scale": _np(sd[f"{pre}.layernorm_before.weight"]),
                    "bias": _np(sd[f"{pre}.layernorm_before.bias"]),
                    "eps": eps},
            "ln2": {"scale": _np(sd[f"{pre}.layernorm_after.weight"]),
                    "bias": _np(sd[f"{pre}.layernorm_after.bias"]),
                    "eps": eps},
            "wqkv": np.concatenate(
                [_np(sd[f"{att}.{n}.weight"]).T
                 for n in ("query", "key", "value")], axis=1),
            "bqkv": np.concatenate(
                [_np(sd[f"{att}.{n}.bias"])
                 for n in ("query", "key", "value")]),
            "wo": _np(sd[f"{pre}.attention.output.dense.weight"]).T,
            "bo": _np(sd[f"{pre}.attention.output.dense.bias"]),
            "w1": _np(sd[f"{pre}.intermediate.dense.weight"]).T,
            "b1": _np(sd[f"{pre}.intermediate.dense.bias"]),
            "w2": _np(sd[f"{pre}.output.dense.weight"]).T,
            "b2": _np(sd[f"{pre}.output.dense.bias"]),
        }
    return tree_from_numpy(params, dev)


def make_vit_from_hf(state_dict_or_path, *, image_size: int,
                     patch_size: int, n_heads: int,
                     layer_norm_eps: float = 1e-12, **make_kwargs):
    """A servable ViT from an HF checkpoint (path or state_dict).  The
    geometry (image, patch, heads) comes from the HF config, passed
    explicitly; ``make_kwargs``: ``compute_dtype`` (default bf16),
    ``name``, ``input_dtype``, ``device`` and the Model's own
    (``max_batch_size``, ``batch_buckets``)."""
    from tpulab_torch.engine.model import IOSpec, Model
    from tpulab_torch.models.vit import place_vit_params, vit_apply

    params = vit_params_from_hf(_load(state_dict_or_path), layer_norm_eps,
                                device=make_kwargs.pop("device", None))
    n_layers = len([k for k in params if k.startswith("layer")])
    d_model = params["patch_embed"].shape[1]
    num_classes = params["head"]["bias"].shape[0]
    compute_dtype = make_kwargs.pop("compute_dtype", torch.bfloat16)
    expect = (image_size // patch_size) ** 2 + 1
    if params["pos_embed"].shape[0] != expect:
        raise ValueError(
            f"image_size {image_size}/patch {patch_size} implies "
            f"{expect} positions but the checkpoint has "
            f"{params['pos_embed'].shape[0]}")
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by "
                         f"n_heads {n_heads}")
    return Model(
        name=make_kwargs.pop("name", f"vit_hf_{patch_size}"),
        apply_fn=partial(vit_apply, n_heads=n_heads, n_layers=n_layers,
                         patch_size=patch_size, compute_dtype=compute_dtype),
        params=params,
        inputs=[IOSpec("input", (image_size, image_size, 3),
                       make_kwargs.pop("input_dtype", np.float32))],
        outputs=[IOSpec("logits", (num_classes,), np.float32)],
        place_fn=partial(place_vit_params, compute_dtype=compute_dtype),
        **make_kwargs)
