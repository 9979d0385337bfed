"""Models of the port: the transformer, ResNet, ViT and MNIST, the
registry (:func:`build_model`), the weight bridge, ONNX import
(``onnx_import``), PyTorch / Hugging Face weight import (``torch_import``)
and post-training int8 (``quantization``)."""

from tpulab_torch.models.registry import available_models, build_model

__all__ = ["available_models", "build_model", "early_exit_draft"]


def __getattr__(name):
    # tpulab's lazy export: the draft-param plumbing for speculative
    # decoding, without importing the transformer at package import
    if name == "early_exit_draft":
        from tpulab_torch.models.transformer import early_exit_draft
        return early_exit_draft
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
