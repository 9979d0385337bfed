"""Runtime: places a model's weights on the device once and builds one
callable per batch bucket (the port of ``tpulab/engine/runtime.py``).

tpulab jit-compiles one XLA executable per bucket.  Eager PyTorch has no
compile step whose output changes the numbers, so a bucket's "program"
here is ``apply_fn`` over the placed weights, checked to receive exactly
the bucket's batch; the bucket contract (``pick_bucket``, zero padding of
dead rows, outputs cut to the batch) is kept by the staging
:class:`~tpulab_torch.engine.buffers.Bindings`.  On a CUDA device every
bucket runs once at compile time (cuDNN and cuBLAS pick their kernels
then, not on a request); the caching allocator's statistics around each
run give :meth:`CompiledModel.memory_analysis`, and the largest bucket's
the activation memory.

The engine artifact (the plan-file analog) is a directory:

    <path>/spec.json       IO contract, buckets, model name (tpulab's keys)
                           and ``"format": "tpulab_torch"``
    <path>/params.npz      weight leaves ``leaf_{i}`` (tpulab's keys; a
                           bf16 leaf as its 16-bit pattern)
    <path>/tree.json       the tree's structure: nested dicts whose leaves
                           are ``["leaf", i, dtype]`` (``leaf_{i}``) or
                           ``["scalar", value]``
    <path>/bucket_<N>.pt2  the bucket's forward as a ``torch.export``
                           ExportedProgram over (params, inputs): loads
                           WITHOUT the Python ``apply_fn``

There is no counterpart of tpulab's ``bucket_<N>.xla`` executables (eager
PyTorch compiles nothing), and the two packages' artifacts do not load
in each other's runtime.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpulab_torch.cuda.allocators import DeviceRawAllocator, _nbytes
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.engine.model import IOSpec, Model

log = logging.getLogger("tpulab_torch.engine")

#: ``spec.json``'s mark of the port's artifact format
ARTIFACT_FORMAT = "tpulab_torch"


@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """One bucket's device memory, under the names of XLA's
    ``CompiledMemoryStats`` (tpulab's ``memory_analysis``): the bytes of
    the arguments (the placed weights and the bucket's inputs) and of the
    outputs, and ``temp_size_in_bytes``, the caching allocator's peak
    during the compile-time forward beyond what it held after it (None
    on the CPU, which keeps no statistics)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: Optional[int]


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
                 weights_addr: Optional[int] = None,
                 temp_bytes: Optional[Dict[int, int]] = None):
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
        self._temp_bytes = temp_bytes or {}
        self._flops: Dict[int, float] = {}

    def release_weights(self) -> None:
        """Drop the weights' block from the owning allocator's gauge and
        the model's reference to them; the memory returns to PyTorch's
        caching allocator once no other reference holds it."""
        if self.allocator is not None and self.weights_addr is not None:
            self.allocator.deallocate_node(self.weights_addr)
            self.weights_addr = None
            self.device_params = None

    def memory_analysis(self, bucket: Optional[int] = None
                        ) -> MemoryAnalysis:
        """Device memory of one bucket's forward (default the largest):
        argument and output bytes from the tensors' sizes, temp bytes as
        the allocator measured them at compile time."""
        b = bucket or self.model.batch_buckets[-1]
        if b not in self.executables:
            raise KeyError(f"bucket {b} is not compiled "
                           f"(have {sorted(self.executables)})")
        params = _nbytes(self.device_params)
        inputs = sum(s.bytes_per_sample() * b for s in self.model.inputs)
        outputs = sum(s.bytes_per_sample() * b for s in self.model.outputs)
        return MemoryAnalysis(params + inputs, outputs,
                              self._temp_bytes.get(b))

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
        activation, temp = 0, {}
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                for b in buckets:
                    inputs = zero_inputs(model, b, self.device)
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    out = executables[b](params, inputs)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated()
                    activation = peak - base
                    temp[b] = peak - torch.cuda.memory_allocated()
                    del out
                    log.info("warmed %s bucket=%d", model.name, b)
        return CompiledModel(model, self.device, executables, params,
                             activation, allocator=self.allocator,
                             weights_addr=weights_addr, temp_bytes=temp)

    # -- engine artifacts ----------------------------------------------------
    def save_engine(self, compiled: CompiledModel, path: str) -> None:
        """Write an engine artifact: the spec, the weights of
        ``model.params`` and one ``torch.export`` program per bucket (over
        the weights as ``params.npz`` holds them, on this device).  An
        export that fails is logged and its program left out: such an
        artifact needs ``apply_fn`` to load (tpulab's rule)."""
        os.makedirs(path, exist_ok=True)
        model = compiled.model
        spec = {
            "name": model.name,
            "max_batch_size": model.max_batch_size,
            "batch_buckets": model.batch_buckets,
            "inputs": [[s.name, list(s.shape), np.dtype(s.dtype).name]
                       for s in model.inputs],
            "outputs": [[s.name, list(s.shape), np.dtype(s.dtype).name]
                        for s in model.outputs],
            "format": ARTIFACT_FORMAT,
        }
        with open(os.path.join(path, "spec.json"), "w") as f:
            json.dump(spec, f, indent=2)
        leaves: List[torch.Tensor] = []
        structure = _tree_structure(model.params, leaves)
        np.savez(os.path.join(path, "params.npz"),
                 **{f"leaf_{i}": _leaf_array(t)
                    for i, t in enumerate(leaves)})
        with open(os.path.join(path, "tree.json"), "w") as f:
            json.dump(structure, f)
        try:
            self._save_exported(compiled, path)
        except Exception as e:  # noqa: BLE001 - tpulab's rule, logged
            log.warning("portable torch.export program unavailable (%s); "
                        "artifact will need apply_fn to load", e)

    @staticmethod
    def _save_exported(compiled: CompiledModel, path: str) -> None:
        model = compiled.model
        params = tree_to(model.params, compiled.device)
        program = _Forward(model.apply_fn)
        for b in model.batch_buckets:
            exported = torch.export.export(
                program, (params, zero_inputs(model, b, compiled.device)))
            # the traced example (the weights among it) is not part of the
            # program: params.npz holds the weights once
            exported.example_inputs = None
            torch.export.save(exported, os.path.join(path,
                                                     f"bucket_{b}.pt2"))

    def load_engine(self, path: str, apply_fn=None,
                    model_name: Optional[str] = None) -> CompiledModel:
        """Load an artifact of :meth:`save_engine` onto this runtime's
        device: with ``apply_fn`` the buckets run it over the saved
        weights; without, each bucket runs its saved program (raising
        tpulab's error where one is missing)."""
        spec_path = os.path.join(path, "spec.json")
        with open(spec_path) as f:
            spec = json.load(f)
        if spec.get("format") != ARTIFACT_FORMAT:
            raise ValueError(
                f"{path} is not a tpulab_torch engine artifact (tpulab's "
                "artifacts hold XLA programs and a pickled JAX treedef; "
                "the two packages' artifacts do not load across)")
        data = np.load(os.path.join(path, "params.npz"))
        with open(os.path.join(path, "tree.json")) as f:
            params = _tree_unflatten(json.load(f), data)
        inputs = [IOSpec(n, tuple(s), np.dtype(d))
                  for n, s, d in spec["inputs"]]
        outputs = [IOSpec(n, tuple(s), np.dtype(d))
                   for n, s, d in spec["outputs"]]
        if apply_fn is None:
            apply_fn = self._portable_apply_fn(path, spec)
        model = Model(model_name or spec["name"], apply_fn, params, inputs,
                      outputs, spec["max_batch_size"], spec["batch_buckets"])
        return self.compile_model(model)

    @staticmethod
    def _portable_apply_fn(path: str, spec: dict):
        """apply_fn over the artifact's exported programs: dispatches on
        the batch dimension to the matching bucket's program (each is
        shape-exact), loading it on first use."""
        programs: dict = {}

        def _program(b: int):
            if b not in programs:
                pt2 = os.path.join(path, f"bucket_{b}.pt2")
                if not os.path.exists(pt2):
                    raise ValueError(
                        f"this artifact was loaded without apply_fn and "
                        f"needs its portable program to run bucket {b}, "
                        f"but {pt2} is missing (export was unavailable "
                        f"when it was saved) — pass apply_fn to run from "
                        f"source")
                programs[b] = torch.export.load(pt2).module()
            return programs[b]

        def apply_fn(params, inputs):
            batch = next(iter(inputs.values())).shape[0]
            if batch not in spec["batch_buckets"]:
                raise ValueError(f"no portable program for bucket {batch} "
                                 f"(have {sorted(spec['batch_buckets'])})")
            return _program(batch)(params, inputs)

        return apply_fn


class _Forward(torch.nn.Module):
    """``apply_fn`` as the module ``torch.export`` traces."""

    def __init__(self, apply_fn: Callable):
        super().__init__()
        self.apply_fn = apply_fn

    def forward(self, params, inputs):
        return self.apply_fn(params, inputs)


#: leaves numpy cannot hold, saved as the integer view of their bits
_BIT_VIEWS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
              torch.float8_e5m2: torch.uint8}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return (t.view(_BIT_VIEWS[t.dtype]) if t.dtype in _BIT_VIEWS
            else t).numpy()


def _tree_structure(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """The tree with each tensor leaf replaced by ``["leaf", i, dtype]``
    (``leaves[i]`` is the tensor) and each python scalar by ``["scalar",
    value]``: JSON objects are always sub-trees."""
    if isinstance(tree, dict):
        return {k: _tree_structure(v, leaves) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ["leaf", len(leaves) - 1, _dtype_name(tree.dtype)]
    if isinstance(tree, (bool, int, float)):
        return ["scalar", tree]
    raise TypeError(f"cannot save a {type(tree).__name__} leaf in an "
                    "engine artifact")


def _tree_unflatten(structure: Any, data) -> Any:
    if isinstance(structure, dict):
        return {k: _tree_unflatten(v, data) for k, v in structure.items()}
    if structure[0] == "scalar":
        return structure[1]
    _, i, dtype = structure
    dtype = getattr(torch, dtype)
    t = torch.from_numpy(np.array(data[f"leaf_{i}"]))
    return t.view(dtype) if dtype in _BIT_VIEWS else t
