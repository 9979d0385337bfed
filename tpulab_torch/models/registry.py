"""Model registry: name -> build function (the port of
``tpulab/models/registry.py``).  Every build function takes the model's
own keyword arguments plus ``device`` (where its weights are drawn;
``None`` = the CUDA card)."""

from __future__ import annotations

from typing import Callable, Dict, List


def _resnet(depth: int):
    def build(**kw):
        from tpulab_torch.models.resnet import make_resnet
        return make_resnet(depth=depth, **kw)
    return build


def _mnist(**kw):
    from tpulab_torch.models.mnist import make_mnist
    return make_mnist(**kw)


def _transformer(**kw):
    from tpulab_torch.models.transformer import make_transformer
    return make_transformer(**kw)


def _vit(variant: str, patch: int):
    def build(**kw):
        from tpulab_torch.models.vit import make_vit
        return make_vit(variant=variant, patch_size=patch, **kw)
    return build


def _transformer_int8(**kw):
    """The seeded transformer with every projection stored weight-only
    int8 (``{w_int8, scale}``); ``qmat`` dequantizes in the forward."""
    from tpulab_torch.models.quantization import quantize_transformer_params
    from tpulab_torch.models.transformer import make_transformer
    m = make_transformer(**kw)
    m.params = quantize_transformer_params(m.params)
    return m.renamed("transformer_int8")


def _unported(name: str, what: str):
    def build(**kw):
        raise NotImplementedError(f"registry entry {name!r} is not ported "
                                  f"(ROADMAP queue 1, item 6: {what})")
    return build


_REGISTRY: Dict[str, Callable] = {
    "resnet50": _resnet(50),
    "resnet101": _resnet(101),
    "resnet152": _resnet(152),
    "resnet50_int8": _unported("resnet50_int8", "the ResNet half of "
                               "models/quantization.py"),
    "mnist": _mnist,
    "transformer": _transformer,
    "transformer_int8": _transformer_int8,
    "onnx": _unported("onnx", "models/onnx_import.py"),
    "vit_s16": _vit("s", 16),
    "vit_b16": _vit("b", 16),
    "vit_l16": _vit("l", 16),
    "vit_s32": _vit("s", 32),
    "vit_b32": _vit("b", 32),
    "vit_l32": _vit("l", 32),
}


def available_models() -> List[str]:
    return sorted(_REGISTRY)


def build_model(name: str, **kwargs):
    """Build a servable Model by registry name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{available_models()}")
    return _REGISTRY[name](**kwargs)
