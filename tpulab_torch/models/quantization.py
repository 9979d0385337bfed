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

tpulab's ResNet half (W8 / W8A8 convolutions) and its ``Calibrator``
are not ported with the compiled-model path (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

#: transformer weight matrices eligible for weight-only quantization
TRANSFORMER_QUANT_KEYS = ("wqkv", "wo", "w1", "w2", "w3")


def quantize_matrix(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-column symmetric int8 quantization of a 2D (I, O)
    weight matrix, on ``w``'s device (tpulab's ``_quantize_matrix``)."""
    w = w.detach().to(torch.float32)
    absmax = w.abs().amax(dim=0)                       # per O column
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which is not numpy's correctly rounded division
    scale = torch.where(absmax > 0,
                        absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
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
