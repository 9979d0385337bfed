"""InferenceManager: the central resource manager (the port of
``tpulab/engine/inference_manager.py``).

Owns, as tpulab's does:
- registered models -> :class:`~tpulab_torch.engine.runtime.CompiledModel`
  (weights placed once on the device, one callable per bucket);
- a global ``Pool[Buffers]`` of staging bundles sized to the largest
  registered model's bindings plus 128 KiB, with
  ``max_buffers = 2 * max_executions`` by default, so one input copy, N
  forwards and one output copy overlap;
- a global execution-token ``Pool`` bounding the dispatches in flight,
  plus a per-model ``Pool[ExecutionContext]``:
  :meth:`get_execution_context` pops the global token, then the model's
  slot, and both block when exhausted (backpressure);
- named thread pools "pre", "dispatch" and "post";
- the :class:`~tpulab_torch.cuda.sync.EventPoller` that returns tokens
  when a forward completes, and the
  :class:`~tpulab_torch.cuda.transfer.TransferEngine` that copies the
  outputs back.

``device=None`` is the CUDA card (raises without one); CPU runs pass
``device="cpu"``.  tpulab's ``coalesce_h2d`` (one ``device_put`` per
collector cycle for concurrent requests' inputs) answers a per-transfer
PjRt cost CUDA copies lack: each request's inputs copy on its buffers'
stream (ROADMAP decisions: no H2D coalescing), so the dispatch pool
keeps tpulab's size without coalescing, 2 threads.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from tpulab_torch.core.pool import Pool, PoolItem, make_serving_pool
from tpulab_torch.core.thread_pool import ThreadPool
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.cuda.sync import EventPoller
from tpulab_torch.cuda.transfer import TransferEngine
from tpulab_torch.engine.buffers import Buffers
from tpulab_torch.engine.execution_context import ExecutionContext
from tpulab_torch.engine.model import Model
from tpulab_torch.engine.runtime import CompiledModel, Runtime

log = logging.getLogger("tpulab_torch.engine")

#: staging headroom per bundle for the views' alignment
STAGING_HEADROOM = 128 * 1024


class InferenceManager:
    """Pools + models + thread pools."""

    def __init__(self, max_executions: int = 2, max_buffers: int = 0,
                 device=None, coalesce_h2d: bool = False):
        if max_executions < 1:
            raise ValueError("max_executions must be >= 1")
        if coalesce_h2d:
            raise NotImplementedError(
                "coalesce_h2d: CUDA copies have no per-transfer round trip "
                "to amortize (ROADMAP decisions: no H2D coalescing)")
        self.max_executions = max_executions
        self.max_buffers = max_buffers or 2 * max_executions
        self.device = resolve_device(device)
        self._runtime = Runtime(self.device)
        self._models: Dict[str, Model] = {}
        self._compiled: Dict[str, CompiledModel] = {}
        self._ctx_pools: Dict[str, Pool[ExecutionContext]] = {}
        self._buffers_pool: Optional[Pool[Buffers]] = None
        self._exec_tokens: Optional[Pool[int]] = None
        self._transfer_engine: Optional[TransferEngine] = None
        self._event_poller: Optional[EventPoller] = None
        self._thread_pools: Dict[str, ThreadPool] = {}
        self._lock = threading.Lock()
        self._allocated = False

    # -- registration -----------------------------------------------------------
    def register_model(self, name: str, model: Model,
                       max_concurrency: Optional[int] = None) -> None:
        """Place + register; per-model context slots = ``max_concurrency``
        (default: the manager's ``max_executions``)."""
        if self._allocated:
            raise RuntimeError("register models before update_resources()")
        model = model if model.name == name else model.renamed(name)
        compiled = self._runtime.compile_model(model)
        slots = max_concurrency or self.max_executions
        with self._lock:
            self._models[name] = model
            self._compiled[name] = compiled
            self._ctx_pools[name] = make_serving_pool(
                ExecutionContext(compiled, slot_id=i) for i in range(slots))
        log.info("registered %s: weights=%dB activations~%dB buckets=%s",
                 name, model.weights_size_in_bytes(),
                 compiled.activation_size_in_bytes(), model.batch_buckets)

    def register_engine(self, name: str, path: str, apply_fn=None,
                        max_concurrency: Optional[int] = None) -> None:
        """Load an engine artifact (:meth:`Runtime.save_engine`'s) and
        register it; ``apply_fn`` is optional: the artifact's exported
        programs serve without source."""
        if self._allocated:
            raise RuntimeError("register engines before update_resources()")
        compiled = self._runtime.load_engine(path, apply_fn=apply_fn,
                                             model_name=name)
        slots = max_concurrency or self.max_executions
        with self._lock:
            self._models[name] = compiled.model
            self._compiled[name] = compiled
            self._ctx_pools[name] = make_serving_pool(
                ExecutionContext(compiled, slot_id=i) for i in range(slots))

    # -- resource allocation ----------------------------------------------------
    def update_resources(self, allow_empty: bool = False) -> None:
        """Allocate the staging pool, the token pool, the poller, the
        transfer engine and the thread pools.  ``allow_empty`` permits a
        manager with no models."""
        if not self._models and not allow_empty:
            raise RuntimeError("no models registered")
        stack_bytes = max((m.bindings_size_in_bytes()
                           for m in self._models.values()), default=0)
        stack_bytes += STAGING_HEADROOM
        self._transfer_engine = TransferEngine()
        self._event_poller = EventPoller()
        self._buffers_pool = make_serving_pool(
            (Buffers(stack_bytes, self.device,
                     transfer_engine=self._transfer_engine)
             for _ in range(self.max_buffers)),
            on_return=Buffers.reset)
        self._exec_tokens = make_serving_pool(range(self.max_executions))
        for name, n in (("pre", 2), ("dispatch", 2), ("post", 2)):
            if name not in self._thread_pools:
                self._thread_pools[name] = ThreadPool(n, name=name)
        self._allocated = True
        log.info("resources: %d buffer bundles x %dB, %d exec tokens",
                 self.max_buffers, stack_bytes, self.max_executions)

    def register_thread_pool(self, name: str, pool: ThreadPool) -> None:
        """Named pool registry."""
        self._thread_pools[name] = pool

    def workers(self, name: str) -> ThreadPool:
        return self._thread_pools[name]

    # -- acquisition (blocking) -------------------------------------------------
    def get_buffers(self, timeout: Optional[float] = None) -> PoolItem[Buffers]:
        self._check_allocated()
        return self._buffers_pool.pop(timeout)

    def get_execution_context(self, model_name: str,
                              timeout: Optional[float] = None
                              ) -> "ManagedContext":
        """Two-level pop: the global token, then the model's slot."""
        self._check_allocated()
        token = self._exec_tokens.pop(timeout)
        try:
            ctx = self._ctx_pools[model_name].pop(timeout)
        except BaseException:
            token.release()
            raise
        return ManagedContext(ctx, token)

    # -- introspection ------------------------------------------------------------
    @property
    def transfer_engine(self) -> Optional[TransferEngine]:
        return self._transfer_engine

    @property
    def event_poller(self) -> Optional[EventPoller]:
        return self._event_poller

    @property
    def buffers_pool(self) -> Optional[Pool[Buffers]]:
        return self._buffers_pool

    @property
    def exec_tokens(self) -> Optional[Pool[int]]:
        return self._exec_tokens

    def context_pool(self, name: str) -> Pool[ExecutionContext]:
        return self._ctx_pools[name]

    def model(self, name: str) -> Model:
        return self._models[name]

    def compiled(self, name: str) -> CompiledModel:
        return self._compiled[name]

    @property
    def model_names(self):
        return list(self._models)

    def infer_runner(self, name: str):
        from tpulab_torch.engine.infer_runner import InferRunner
        if name not in self._models:
            raise KeyError(f"model {name!r} is not registered")
        return InferRunner(self, name)

    def _check_allocated(self) -> None:
        if not self._allocated:
            raise RuntimeError("call update_resources() first")

    def shutdown(self) -> None:
        for tp in self._thread_pools.values():
            tp.shutdown()
        if self._transfer_engine is not None:
            self._transfer_engine.shutdown()
        if self._event_poller is not None:
            self._event_poller.shutdown()


class ManagedContext:
    """The two-level (context + token) acquisition handle; ``release``
    is idempotent."""

    def __init__(self, ctx_item: PoolItem[ExecutionContext],
                 token_item: PoolItem[int]):
        self._ctx_item = ctx_item
        self._token_item = token_item

    def get(self) -> ExecutionContext:
        return self._ctx_item.get()

    def release(self) -> None:
        """Return the context first, then the global token."""
        self._ctx_item.release()
        self._token_item.release()

    def __enter__(self) -> ExecutionContext:
        return self.get()

    def __exit__(self, *exc) -> None:
        self.release()
