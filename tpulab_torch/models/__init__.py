"""Models of the port: the transformer, ResNet, ViT and MNIST, the
registry (:func:`build_model`) and the weight bridge."""

from tpulab_torch.models.registry import available_models, build_model

__all__ = ["available_models", "build_model"]
