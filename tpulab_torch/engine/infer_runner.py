"""InferRunner: the three-stage asynchronous pipeline (the port of
``tpulab/engine/infer_runner.py``).

- caller ("pre"): ``get_buffers`` [MAY BLOCK] -> create bindings -> fill
  the staging views;
- "dispatch" worker: the inputs' copies on the buffers' stream, the
  two-level context acquisition [MAY BLOCK], the forward enqueued on the
  context's stream, the outputs' copies into staging enqueued on the
  transfer engine's side stream.  The event poller returns the execution
  token (and the context slot) as soon as the forward completes — not
  when the outputs have landed;
- "post" worker, once the outputs have landed: the caller's ``post_fn``,
  then the buffers back to their pool, then the future.

No path strands a token or a buffers slot: a dispatch that fails returns
both and hands its exception to the future; a failure on the device
reaches the future through the output copy.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Any, Callable, Optional

import numpy as np

from tpulab_torch.core.async_compute import SharedPackagedTask
from tpulab_torch.engine.buffers import Bindings


def _copy_outputs(bindings: Bindings):
    return {k: v.copy() for k, v in bindings.outputs().items()}


class InferRunner:
    """Future-returning inference pipeline bound to one model."""

    def __init__(self, manager, model_name: str):
        self._mgr = manager
        self.model = manager.model(model_name)
        self.model_name = model_name

    # -- public API ---------------------------------------------------------
    def infer(self, post_fn: Optional[Callable[[Bindings], Any]] = None,
              **arrays: np.ndarray) -> Future:
        """Run inference on named input arrays; returns a future of
        ``post_fn(bindings)`` (default: a dict of output arrays)."""
        if not arrays:
            raise ValueError("no input arrays given")
        batch = next(iter(arrays.values())).shape[0]
        buffers_item = self._mgr.get_buffers()           # MAY BLOCK
        try:
            bindings = buffers_item.get().create_bindings(self.model, batch)
            for name, arr in arrays.items():
                bindings.set_input(name, np.ascontiguousarray(arr))
        except BaseException:
            buffers_item.release()                       # never leak the slot
            raise
        return self.infer_bindings(bindings, buffers_item, post_fn)

    def infer_bindings(self, bindings: Bindings, buffers_item,
                       post_fn: Optional[Callable[[Bindings], Any]] = None
                       ) -> Future:
        """Pipeline entry for pre-filled bindings."""
        task: SharedPackagedTask = SharedPackagedTask(post_fn
                                                      or _copy_outputs)
        self._mgr.workers("dispatch").enqueue(
            self._dispatch_stage, bindings, buffers_item, task)
        return task.get_future()

    # -- stages -------------------------------------------------------------
    def _dispatch_stage(self, bindings: Bindings, buffers_item,
                        task: SharedPackagedTask) -> None:
        managed = None
        try:
            bindings.copy_to_device()                    # async H2D
            managed = self._mgr.get_execution_context(   # MAY BLOCK
                self.model_name)
            ctx = managed.get()
            outputs = ctx.infer(bindings.device_inputs, bindings.bucket,
                                after=bindings.h2d_event)
            bindings.copy_from_device(outputs)
            t_dispatch = time.monotonic()

            def _compute_done(b=bindings, m=managed, t0=t_dispatch):
                b.compute_seconds = time.monotonic() - t0
                m.release()                              # token back

            with ctx.stream_context():                   # copies follow it
                fetch = self._mgr.transfer_engine.fetch(
                    outputs, out={n: bindings.host_output_tensors[n]
                                  for n in outputs})
            self._mgr.event_poller.watch(ctx.done_event, _compute_done)
            managed = None                               # the poller owns it
            fetch.add_done_callback(
                lambda f: self._mgr.workers("post").enqueue(
                    self._post_stage, bindings, buffers_item, task, f))
        except BaseException as e:  # noqa: BLE001 - settle the future
            if managed is not None:
                managed.release()                        # token must not strand
            bindings.release()
            buffers_item.release()
            if not task.get_future().done():
                task.get_future().set_exception(e)

    def _post_stage(self, bindings: Bindings, buffers_item,
                    task: SharedPackagedTask, fetch: Future) -> None:
        try:
            fetch.result()                               # outputs in staging
            task.get_future()._tpulab_compute_s = getattr(
                bindings, "compute_seconds", None)
            task(bindings)                               # post_fn -> future
        except BaseException as e:  # noqa: BLE001 - settle the future
            if not task.get_future().done():
                task.get_future().set_exception(e)
        finally:
            bindings.release()
            buffers_item.release()
