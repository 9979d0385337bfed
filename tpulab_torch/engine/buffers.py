"""Buffers / Bindings: per-request host staging and device tensors (the
port of ``tpulab/engine/buffers.py``).

- :class:`Buffers` is one pool slot: a host staging stack, as tpulab's
  (a ``BlockStack`` over a cached ``BlockArena`` of ``block_size`` blocks
  from the staging allocator: page-locked in front of a CUDA device, so
  host-to-device and device-to-host copies run asynchronously; plain
  first-touched memory on the CPU) and, on CUDA, the stream its input
  copies run on.  It carves 64-byte-aligned views off the top block and
  pushes a new block when the top is full; :meth:`Buffers.reset` gives
  every block back to the arena and runs as the pool's ``on_return``
  hook; :meth:`Buffers.release` also returns the cached blocks
  (``shrink_to_fit``).  tpulab's native staging stack is not carried
  (ROADMAP decisions: Python pools only), nor its ``coalesce_h2d``
  (decisions: no H2D coalescing), which raises.
- :class:`Bindings` carves one view per input and output binding at the
  request's bucket: numpy views for the caller's fill, torch views of the
  same bytes for the copies.  ``copy_to_device`` enqueues the inputs'
  copies on the buffers' stream and records an event the execution
  context waits on; the outputs come back into the staging views through
  the manager's :class:`~tpulab_torch.cuda.transfer.TransferEngine`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tpulab_torch import chaos
from tpulab_torch.cuda.allocators import make_staging_allocator
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.cuda.sync import cuda_sync_standard
from tpulab_torch.engine.model import Model
from tpulab_torch.engine.runtime import torch_dtype
from tpulab_torch.memory.arena import BlockArena, BlockStack
from tpulab_torch.memory.block import FixedSizeBlockAllocator
from tpulab_torch.memory.descriptor import host_view

#: alignment of every carved view
ALIGN = 64


class Buffers:
    """One pool slot of staging memory (reference FixedBuffers)."""

    def __init__(self, host_stack_bytes: int, device=None, block_size: int = 0,
                 transfer_engine=None, coalesce_h2d: bool = False):
        if coalesce_h2d:
            raise NotImplementedError(
                "coalesce_h2d: CUDA copies have no per-transfer round trip "
                "to amortize (ROADMAP decisions: no H2D coalescing)")
        self.device = resolve_device(device)
        self._arena = BlockArena(FixedSizeBlockAllocator(
            make_staging_allocator(self.device),
            block_size or host_stack_bytes), cached=True)
        self._stack = BlockStack(self._arena)
        self.transfer_engine = transfer_engine
        self.coalesce_h2d = coalesce_h2d
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)

    def create_bindings(self, model: Model, batch_size: int) -> "Bindings":
        """Carve per-binding staging views for one request."""
        return Bindings(self, model, batch_size)

    def _carve(self, nbytes: int) -> torch.Tensor:
        addr = self._stack.allocate(nbytes, alignment=ALIGN)
        return torch.frombuffer(host_view(addr, nbytes), dtype=torch.uint8)

    def reset(self) -> None:
        """Return all carved memory (the pool's ``on_return`` hook)."""
        self._stack.reset()

    def release(self) -> None:
        """Return every block, cached ones included, to the staging
        allocator."""
        self._stack.reset()
        self._arena.shrink_to_fit()


class Bindings:
    """Per-inference tensor state.

    Lifecycle: fill ``host_inputs`` (or :meth:`set_input`) ->
    :meth:`copy_to_device` -> execute -> :meth:`copy_from_device` ->
    the outputs' copy into ``host_outputs`` (:meth:`synchronize`, or the
    pipeline's transfer engine) -> :meth:`outputs`.
    """

    def __init__(self, buffers: Buffers, model: Model, batch_size: int):
        self.model = model
        self.batch_size = batch_size
        self.bucket = model.pick_bucket(batch_size)
        self.device = buffers.device
        self._buffers = buffers
        #: torch views of the staging bytes (the copies' ends)
        self.host_input_tensors: Dict[str, torch.Tensor] = {}
        self.host_output_tensors: Dict[str, torch.Tensor] = {}
        for specs, views in ((model.inputs, self.host_input_tensors),
                             (model.outputs, self.host_output_tensors)):
            for spec in specs:
                raw = buffers._carve(spec.bytes_per_sample() * self.bucket)
                views[spec.name] = raw.view(torch_dtype(spec.np_dtype)).view(
                    spec.batched_shape(self.bucket))
        #: numpy views of the same bytes (the caller's side)
        self.host_inputs: Dict[str, np.ndarray] = {
            n: t.numpy() for n, t in self.host_input_tensors.items()}
        self.host_outputs: Dict[str, np.ndarray] = {
            n: t.numpy() for n, t in self.host_output_tensors.items()}
        self.device_inputs: Dict[str, torch.Tensor] = {}
        self.device_outputs: Dict[str, torch.Tensor] = {}
        #: recorded after the inputs' copies (None on the CPU)
        self.h2d_event: Optional["torch.cuda.Event"] = None

    # -- fill ---------------------------------------------------------------
    def set_input(self, name: str, array: np.ndarray) -> None:
        """Copy caller data into the staging view (pads to the bucket)."""
        spec = self.model.binding(name)
        if not self.model.is_input(name):
            raise KeyError(f"{name} is not an input binding")
        view = self.host_inputs[name]
        if array.dtype != spec.np_dtype:
            raise TypeError(f"input {name} dtype {array.dtype} != binding "
                            f"dtype {spec.np_dtype} (no implicit casts on "
                            f"the serving path)")
        n = array.shape[0]
        if n != self.batch_size:
            raise ValueError(f"input {name} batch {n} != bindings batch "
                             f"{self.batch_size}")
        view[:n] = array
        if n < self.bucket:
            view[n:] = 0  # deterministic padding

    # -- transfers ----------------------------------------------------------
    def copy_to_device(self) -> None:
        """Host -> device of every input binding: asynchronous on the
        buffers' stream (CUDA), the staging views themselves on the CPU."""
        chaos.trip("device.transfer")
        stream = self._buffers.stream
        if stream is None:
            self.device_inputs = dict(self.host_input_tensors)
            return
        with torch.cuda.stream(stream):
            self.device_inputs = {
                n: t.to(self.device, non_blocking=True)
                for n, t in self.host_input_tensors.items()}
            self.h2d_event = stream.record_event()

    def copy_from_device(self, outputs: Dict[str, torch.Tensor]) -> None:
        """Record the device outputs (their copy into staging follows)."""
        self.device_outputs = dict(outputs)

    def synchronize(self) -> Dict[str, np.ndarray]:
        """Blocking device -> host of the outputs into staging (the
        pipeline uses its transfer engine instead); returns
        :meth:`outputs`."""
        cuda_sync_standard(self.device_outputs)
        for name, dev in self.device_outputs.items():
            self.host_output_tensors[name].copy_(dev)
        return self.outputs()

    def outputs(self) -> Dict[str, np.ndarray]:
        """Host outputs cut to the batch (views of the staging block:
        valid until the buffers return to their pool)."""
        return {n: self.host_outputs[n][:self.batch_size]
                for n in self.host_outputs}

    def release(self) -> None:
        self.host_inputs.clear()
        self.host_outputs.clear()
        self.host_input_tensors.clear()
        self.host_output_tensors.clear()
        self.device_inputs.clear()
        self.device_outputs.clear()
