"""Buffers / Bindings: per-request host staging and device tensors (the
port of ``tpulab/engine/buffers.py``).

- :class:`Buffers` is one pool slot: one host staging block (page-locked
  in front of a CUDA device, so host-to-device and device-to-host copies
  run asynchronously; plain memory on the CPU, where PyTorch refuses
  ``pin_memory``) and, on CUDA, the stream its input copies run on.  It
  carves 64-byte-aligned views off the block with a bump offset;
  :meth:`Buffers.reset` rewinds the offset and runs as the pool's
  ``on_return`` hook.  A bump offset over one block is all this needs, so
  tpulab's ``memory/arena.py`` and ``memory/block.py`` (its block stack)
  are not ported.
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
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.cuda.sync import cuda_sync_standard
from tpulab_torch.engine.model import Model
from tpulab_torch.engine.runtime import torch_dtype

#: alignment of every carved view
ALIGN = 64


class Buffers:
    """One pool slot of staging memory."""

    def __init__(self, host_stack_bytes: int, device=None):
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self._block = torch.empty(host_stack_bytes, dtype=torch.uint8,
                                  pin_memory=cuda)
        self._offset = 0
        self.stream = torch.cuda.Stream(device=self.device) if cuda else None

    @property
    def capacity(self) -> int:
        return self._block.numel()

    def create_bindings(self, model: Model, batch_size: int) -> "Bindings":
        """Carve per-binding staging views for one request."""
        return Bindings(self, model, batch_size)

    def _carve(self, nbytes: int) -> torch.Tensor:
        start = -(-self._offset // ALIGN) * ALIGN
        if start + nbytes > self.capacity:
            raise MemoryError(f"staging block of {self.capacity} bytes "
                              f"cannot carve {nbytes} more at {start}")
        self._offset = start + nbytes
        return self._block[start:start + nbytes]

    def reset(self) -> None:
        """Return all carved memory (the pool's ``on_return`` hook)."""
        self._offset = 0


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
