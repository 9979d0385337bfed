"""Device specialization of the cyclic windowed stack
(reference cuda/cyclic_windowed_buffer.h:27-44: device stack whose window
copies run as cudaMemcpyAsync + stream sync; the port's counterpart of
``tpulab/tpu/cyclic_buffer.py``).

``CudaCyclicWindowedStack`` keeps the cyclic geometry and backpressure of
the host version, but each filled window's bytes are copied to the device
on a side stream (a torch view of the window, ``non_blocking`` from the
pinned staging buffer) and ``compute_fn(window_id, device_tensor)`` runs on
that stream.  The window's future completes only once a CUDA event
recorded after the compute has been synchronized: until then the slot's
asynchronous copy may still read it, and the host stack waits on that
future before it writes the slot again.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Callable, Optional

import torch

from tpulab_torch.core.cyclic_buffer import CyclicWindowedStack
from tpulab_torch.core.thread_pool import ThreadPool
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.memory.descriptor import Descriptor


class CudaCyclicWindowedStack(CyclicWindowedStack):
    """Windowed streaming into device memory (reference cuda
    cyclic_windowed_stack)."""

    def __init__(self, buffer: Descriptor, window_count: int, window_size: int,
                 overlap: int = 0, device=None,
                 compute_fn: Optional[Callable[[int, torch.Tensor], object]] = None,
                 dtype: torch.dtype = torch.uint8,
                 executor: Optional[ThreadPool] = None):
        """``compute_fn(window_id, device_tensor)`` runs per filled window on
        the stack's stream; its return is the window's result once the
        stream has passed it.  ``device`` ``None`` = the CUDA card."""
        super().__init__(buffer, window_count, window_size, overlap,
                         on_window=self._ship_window)
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        self._compute_fn = compute_fn
        self._dtype = dtype
        self._executor = executor

    def _ship_window(self, win_id: int, view: memoryview) -> Optional[Future]:
        host = torch.frombuffer(view, dtype=self._dtype)
        if self._executor is not None:
            return self._executor.enqueue(self._window_task, win_id, host)
        fut: Future = Future()
        try:
            fut.set_result(self._window_task(win_id, host))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)
        return fut

    def _window_task(self, win_id: int, host: torch.Tensor):
        if self.stream is None:     # the host: the window's own copy
            dev = host.clone()
            return (self._compute_fn(win_id, dev)
                    if self._compute_fn is not None else dev)
        with torch.cuda.stream(self.stream):
            dev = host.to(self.device, non_blocking=True)    # async H2D
            out = (self._compute_fn(win_id, dev)
                   if self._compute_fn is not None else dev)
            done = self.stream.record_event()
        done.synchronize()      # the copy has read the slot; compute done
        return out
