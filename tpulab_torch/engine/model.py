"""Model: a named program + weights + IO contract (the port of
``tpulab/engine/model.py``).

A ``Model`` owns:
- ``apply_fn(params, inputs) -> outputs`` — a function over torch tensors
  (dict in, dict out);
- ``params`` — the weight tree (nested dicts of tensors, tpulab's keys);
- input / output :class:`IOSpec` s — named bindings with per-sample
  shapes and numpy dtypes;
- ``batch_buckets`` — the batch sizes served.  A request is padded up to
  the nearest bucket (tpulab compiles one program per bucket; the port
  keeps the contract: the same padding, the outputs cut to the batch);
- ``place_fn(params, device) -> device params`` — how the
  :class:`~tpulab_torch.engine.runtime.Runtime` places the weights, once:
  any layout change or compute-dtype copy happens there, never per call.
  ``None`` moves every tensor to the device as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def default_batch_buckets(max_batch_size: int) -> List[int]:
    """Powers of two up to max (plus max itself): 1, 2, 4, ..., max."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    buckets = []
    b = 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return buckets


@dataclasses.dataclass(frozen=True)
class IOSpec:
    """One named binding: name, per-sample shape, numpy dtype."""

    name: str
    shape: Tuple[int, ...]       # per-sample shape (no batch dim)
    dtype: Any = np.float32

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    def elements_per_sample(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1

    def bytes_per_sample(self) -> int:
        return self.elements_per_sample() * self.np_dtype.itemsize

    def batched_shape(self, batch_size: int) -> Tuple[int, ...]:
        return (batch_size, *self.shape)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of nested dicts (``jax.tree_util``'s walk,
    for the trees the port's models use)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


class Model:
    """A servable model."""

    def __init__(self, name: str,
                 apply_fn: Callable[[Any, Dict[str, Any]], Dict[str, Any]],
                 params: Any,
                 inputs: Sequence[IOSpec],
                 outputs: Sequence[IOSpec],
                 max_batch_size: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None,
                 place_fn: Optional[Callable[[Any, Any], Any]] = None):
        self.name = name
        self.apply_fn = apply_fn
        self.params = params
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.max_batch_size = max_batch_size
        self.batch_buckets = sorted(batch_buckets
                                    or default_batch_buckets(max_batch_size))
        if self.batch_buckets[-1] != max_batch_size:
            raise ValueError("largest bucket must equal max_batch_size")
        self.place_fn = place_fn
        self._bindings = {s.name: s for s in [*self.inputs, *self.outputs]}

    # -- introspection -------------------------------------------------------
    def binding(self, name: str) -> IOSpec:
        return self._bindings[name]

    @property
    def binding_names(self) -> List[str]:
        return list(self._bindings)

    def is_input(self, name: str) -> bool:
        return any(s.name == name for s in self.inputs)

    def binding_size_in_bytes(self, name: str, batch_size: int) -> int:
        return self.binding(name).bytes_per_sample() * batch_size

    def element_count(self, name: str, batch_size: int) -> int:
        return self.binding(name).elements_per_sample() * batch_size

    def bindings_size_in_bytes(self, batch_size: Optional[int] = None) -> int:
        """Total bytes of all bindings at a batch size (sizes the staging
        blocks)."""
        b = batch_size or self.max_batch_size
        return sum(self.binding_size_in_bytes(n, b) for n in self._bindings)

    def weights_size_in_bytes(self) -> int:
        """Bytes of every tensor leaf of ``params``."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in tree_leaves(self.params)
                   if hasattr(leaf, "element_size"))

    def pick_bucket(self, batch_size: int) -> int:
        """Smallest bucket >= batch_size."""
        if batch_size > self.max_batch_size:
            raise ValueError(f"batch {batch_size} exceeds max_batch_size "
                             f"{self.max_batch_size}")
        for b in self.batch_buckets:
            if b >= batch_size:
                return b
        raise AssertionError  # unreachable: the last bucket is the max

    def renamed(self, name: str) -> "Model":
        """The same model (shared weights) under another name."""
        return Model(name, self.apply_fn, self.params, self.inputs,
                     self.outputs, self.max_batch_size, self.batch_buckets,
                     self.place_fn)

    def __repr__(self) -> str:  # pragma: no cover
        ins = ",".join(s.name for s in self.inputs)
        outs = ",".join(s.name for s in self.outputs)
        return (f"Model({self.name}, in=[{ins}], out=[{outs}], "
                f"buckets={self.batch_buckets})")
