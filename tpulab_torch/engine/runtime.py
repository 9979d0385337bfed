"""Runtime: places a model's weights on the device once and builds one
callable per batch bucket (the port of ``tpulab/engine/runtime.py``).

tpulab jit-compiles one XLA executable per bucket.  Eager PyTorch has no
compile step whose output changes the numbers, so a bucket's "program"
here is ``apply_fn`` over the placed weights, checked to receive exactly
the bucket's batch; the bucket contract (``pick_bucket``, zero padding of
dead rows, outputs cut to the batch) is kept by the staging
:class:`~tpulab_torch.engine.buffers.Bindings`.  On a CUDA device every
bucket runs once at compile time (cuDNN and cuBLAS pick their kernels
then, not on a request), and the largest bucket's run measures the
activation memory.

tpulab's engine artifacts (``save_engine`` / ``load_engine`` and the
``memory_analysis`` of an executable) are XLA formats and are not carried
(ROADMAP queue 1, item 6: engine artifacts).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from tpulab_torch.cuda.allocators import DeviceRawAllocator
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.engine.model import Model

log = logging.getLogger("tpulab_torch.engine")

_ARTIFACTS = ("engine artifacts are XLA formats and are not ported "
              "(ROADMAP queue 1, item 6: engine artifacts)")


def tree_to(tree: Any, device) -> Any:
    """Every tensor leaf of a nested dict moved to ``device``; other
    leaves (python scalars) pass through."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np.dtype(np_dtype))).dtype


def zero_inputs(model: Model, bucket: int, device) -> Dict[str, torch.Tensor]:
    """Zero inputs of one bucket on ``device``."""
    return {s.name: torch.zeros(s.batched_shape(bucket),
                                dtype=torch_dtype(s.np_dtype), device=device)
            for s in model.inputs}


class _BucketProgram:
    """One bucket's callable: ``apply_fn`` over the weights it is given
    (tpulab's executables take the params as an argument, so a weight
    swap never rebuilds a program)."""

    def __init__(self, apply_fn: Callable, bucket: int):
        self.apply_fn = apply_fn
        self.bucket = bucket

    def __call__(self, params: Any, inputs: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        for name, t in inputs.items():
            if t.shape[0] != self.bucket:
                raise ValueError(f"input {name} has batch {t.shape[0]}; "
                                 f"this program serves bucket {self.bucket}")
        with torch.inference_mode():
            return self.apply_fn(params, inputs)


class CompiledModel:
    """A model's weights on one device and its per-bucket callables."""

    def __init__(self, model: Model, device: torch.device,
                 executables: Dict[int, _BucketProgram], device_params: Any,
                 activation_bytes: int = 0, allocator=None,
                 weights_addr: Optional[int] = None):
        self.model = model
        self.device = device
        self.executables = executables
        #: the placed weights: the device form ``place_fn`` made (layout
        #: changes and bf16 copies), what a weight swap moves as it is
        self.device_params = device_params
        #: the tracked device allocator that placed the weights, and their
        #: block's address (tpulab: the Model owns its weight pointers
        #: through the allocator that placed them)
        self.allocator = allocator
        self.weights_addr = weights_addr
        self._activation_bytes = activation_bytes
        self._flops: Dict[int, float] = {}

    def release_weights(self) -> None:
        """Drop the weights' block from the owning allocator's gauge and
        the model's reference to them; the memory returns to PyTorch's
        caching allocator once no other reference holds it."""
        if self.allocator is not None and self.weights_addr is not None:
            self.allocator.deallocate_node(self.weights_addr)
            self.weights_addr = None
            self.device_params = None

    def memory_analysis(self, bucket: Optional[int] = None):
        raise NotImplementedError(f"memory_analysis: {_ARTIFACTS}")

    def activation_size_in_bytes(self) -> int:
        """Peak bytes the CUDA caching allocator gave one forward of the
        largest bucket beyond what was allocated before it (measured at
        compile time); 0 on the CPU, which has no allocator statistics."""
        return self._activation_bytes

    def flops(self, bucket: Optional[int] = None) -> float:
        """Floating-point operations of one forward of ``bucket`` (the
        whole batch; default the largest), counted by
        ``torch.utils.flop_counter.FlopCounterMode`` over one forward on
        zero inputs (convolutions and matrix products; 2 per
        multiply-add)."""
        from torch.utils.flop_counter import FlopCounterMode

        b = bucket or self.model.batch_buckets[-1]
        if b not in self._flops:
            counter = FlopCounterMode(display=False)
            with counter:
                self(b, zero_inputs(self.model, b, self.device))
            self._flops[b] = float(counter.get_total_flops())
        return self._flops[b]

    def __call__(self, bucket: int, inputs: Dict[str, Any]
                 ) -> Dict[str, torch.Tensor]:
        return self.executables[bucket](self.device_params, inputs)


class Runtime:
    """Places models on one device (``None`` = the CUDA card; raises
    without one)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        #: the tracked device allocator every model's weights are placed
        #: through (tpulab's installed allocator: its gauge counts them)
        self.allocator = DeviceRawAllocator(self.device)

    def compile_model(self, model: Model,
                      buckets: Optional[Sequence[int]] = None
                      ) -> CompiledModel:
        """Place the weights once (``model.place_fn``, else a plain move)
        through the runtime's tracked allocator (``allocate_tree``: one
        block) and build one callable per bucket; on CUDA, run each bucket
        once."""
        buckets = sorted(buckets or model.batch_buckets)
        params = (model.place_fn(model.params, self.device)
                  if model.place_fn is not None
                  else tree_to(model.params, self.device))
        weights_addr, params = self.allocator.allocate_tree(params)
        executables = {b: _BucketProgram(model.apply_fn, b)
                       for b in buckets}
        activation = 0
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                for b in buckets:
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    executables[b](params,
                                   zero_inputs(model, b, self.device))
                    torch.cuda.synchronize()
                    activation = torch.cuda.max_memory_allocated() - base
                    log.info("warmed %s bucket=%d", model.name, b)
        return CompiledModel(model, self.device, executables, params,
                             activation, allocator=self.allocator,
                             weights_addr=weights_addr)

    def save_engine(self, compiled: CompiledModel, path: str) -> None:
        raise NotImplementedError(f"save_engine: {_ARTIFACTS}")

    def load_engine(self, path: str, apply_fn=None,
                    model_name: Optional[str] = None) -> CompiledModel:
        raise NotImplementedError(f"load_engine: {_ARTIFACTS}")
