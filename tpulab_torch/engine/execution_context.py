"""ExecutionContext: a pooled execution slot over one compiled model (the
port of ``tpulab/engine/execution_context.py``).

Holding one is the right to have a dispatch in flight.  On a CUDA device
each context owns a CUDA stream: ``infer`` makes it wait for the
bindings' host-to-device copies, enqueues the bucket's forward on it and
records a done event, which the pipeline's
:class:`~tpulab_torch.cuda.sync.EventPoller` watches to return the
execution token.  On the CPU the forward runs synchronously and there is
no event.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from tpulab_torch.cuda.sync import cuda_sync_standard
from tpulab_torch.engine.runtime import CompiledModel


class ExecutionContext:
    """Execution slot over one compiled model."""

    def __init__(self, compiled: CompiledModel, slot_id: int = 0):
        self.compiled = compiled
        self.slot_id = slot_id
        self.stream = (torch.cuda.Stream(device=compiled.device)
                       if compiled.device.type == "cuda" else None)
        #: the event recorded after the last dispatch (None on the CPU)
        self.done_event: Optional["torch.cuda.Event"] = None

    @property
    def model(self):
        return self.compiled.model

    def stream_context(self):
        """``torch.cuda.stream(self.stream)``, or nothing on the CPU."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def infer(self, device_inputs: Dict[str, torch.Tensor], bucket: int,
              after: Optional["torch.cuda.Event"] = None
              ) -> Dict[str, torch.Tensor]:
        """Enqueue ``bucket``'s forward on this context's stream after
        ``after`` (the inputs' copy event); returns the device outputs."""
        if self.stream is None:
            self.done_event = None
            return self.compiled(bucket, device_inputs)
        if after is not None:
            self.stream.wait_event(after)
        with torch.cuda.stream(self.stream):
            # the inputs were allocated on another stream: their memory
            # must not be reused before this stream has read them
            for t in device_inputs.values():
                t.record_stream(self.stream)
            outputs = self.compiled(bucket, device_inputs)
            self.done_event = self.stream.record_event()
        return outputs

    def synchronize(self) -> None:
        """Block until the last dispatch has completed."""
        if self.done_event is not None:
            cuda_sync_standard(self.done_event)

    def binding_size_in_bytes(self, name: str, batch_size: int) -> int:
        return self.model.binding_size_in_bytes(name, batch_size)
