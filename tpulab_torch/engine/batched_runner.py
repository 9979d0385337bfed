"""BatchedInferRunner: server-side dynamic batching (the port of
``tpulab/engine/batched_runner.py``).

N concurrent ``infer`` calls aggregate into one device batch — one
staging fill, one input copy, one forward, one output copy for the whole
group — then split back per caller.  A group closes when its rows reach
``max_batch_size`` or when ``window_s`` has passed since its first
request.  Works over any inner runner exposing ``infer(**arrays) ->
Future`` (:meth:`BatchedInferRunner.over_runner`).

It counts rows, not items: requests carry batch dims, an overflow
flushes the open group before opening the next, and every caller gets
its own sliced future.
"""

from __future__ import annotations

import inspect
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np

from tpulab_torch.core.task_pool import DeferredShortTaskPool
from tpulab_torch.core.thread_pool import ThreadPool


class BatchedInferRunner:
    """Aggregating runner over an inner ``infer(**arrays)`` runner."""

    def __init__(self, manager, model_name: str,
                 window_s: float = 0.002,
                 max_batch_size: Optional[int] = None):
        model = manager.model(model_name)
        # window launches get a DEDICATED pool: sharing the manager's "pre"
        # pool deadlocks when callers block on batch futures from those
        # same workers
        self._init(inner=manager.infer_runner(model_name),
                   input_names=[s.name for s in model.inputs],
                   window_s=window_s,
                   max_batch_size=max_batch_size or model.max_batch_size,
                   launch_workers=None)
        self.model = model
        self.model_name = model_name

    @classmethod
    def over_runner(cls, inner, input_names: Sequence[str],
                    max_batch_size: int, window_s: float = 0.002,
                    launch_workers: Optional[ThreadPool] = None
                    ) -> "BatchedInferRunner":
        """Aggregate over any runner exposing ``infer(**arrays)``."""
        self = cls.__new__(cls)
        self._init(inner, list(input_names), window_s, max_batch_size,
                   launch_workers)
        self.model = None
        self.model_name = None
        return self

    def _init(self, inner, input_names: List[str], window_s: float,
              max_batch_size: int, launch_workers: Optional[ThreadPool]):
        self._inner = inner
        self._input_names = input_names
        self.window_s = window_s
        self.max_batch_size = max_batch_size
        self._lock = threading.Lock()
        self._open: List[dict] = []       # items: {arrays, n, future}
        self._open_rows = 0
        self._batch_seq = 0
        self._timers = DeferredShortTaskPool(name="batch-window")
        # launches may block (buffer-pool backpressure) — they must never run
        # on the timer thread (its tasks must stay short)
        self._own_workers = launch_workers is None
        self._workers = launch_workers or ThreadPool(2, name="batch-launch")
        try:
            self._has_post_fn = "post_fn" in inspect.signature(
                inner.infer).parameters
        except (TypeError, ValueError):  # pragma: no cover
            self._has_post_fn = False
        #: compute seconds of the most recent device batch (metrics hook)
        self.last_compute_s: Optional[float] = None
        #: groups handed to the inner runner (one device batch each)
        self.batches_launched = 0

    # -- public -------------------------------------------------------------
    def infer(self, **arrays: np.ndarray) -> Future:
        """Enqueue one request; resolves to its own dict of outputs."""
        if not arrays:
            raise ValueError("no input arrays")
        n = next(iter(arrays.values())).shape[0]
        if n > self.max_batch_size:
            # oversized requests bypass aggregation
            return self._inner.infer(**arrays)
        item = {"arrays": arrays, "n": n, "future": Future(),
                "t0": time.perf_counter()}
        groups: List[List[dict]] = []
        with self._lock:
            if self._open_rows + n > self.max_batch_size:
                groups.append(self._close_locked())   # flush what's open
            self._open.append(item)
            self._open_rows += n
            seq = self._batch_seq
            if self._open_rows >= self.max_batch_size:
                groups.append(self._close_locked())   # closed by size
            # arm the window timer iff this item opened a fresh batch that
            # is still waiting for more rows
            needs_timer = bool(self._open) and self._open[0] is item
        for group in groups:
            self._launch(group)
        if needs_timer:
            self._timers.enqueue_deferred(
                self.window_s, lambda: self._window_fired(seq))
        return item["future"]

    def flush(self) -> None:
        with self._lock:
            group = self._close_locked()
        if group:
            self._launch(group)

    def shutdown(self) -> None:
        self.flush()
        self._timers.shutdown()
        if self._own_workers:
            self._workers.shutdown()

    # -- internals ----------------------------------------------------------
    def _close_locked(self) -> List[dict]:
        group, self._open = self._open, []
        self._open_rows = 0
        self._batch_seq += 1
        return group

    def _window_fired(self, seq: int) -> None:
        with self._lock:
            if self._batch_seq != seq:   # closed by size already
                return
            group = self._close_locked()
        if group:
            # hand off: _launch may block on pool backpressure
            self._workers.enqueue(self._launch, group)

    def _launch(self, group: List[dict]) -> None:
        if not group:
            return
        t_launch = time.perf_counter()
        for it in group:
            # aggregation wait (enqueue -> launch): the window + any
            # size-close delay, exported per request for stage profiling
            it["future"]._tpulab_queue_s = t_launch - it["t0"]
        try:
            combined = {
                name: np.concatenate([it["arrays"][name] for it in group],
                                     axis=0)
                for name in self._input_names
            }
            offsets = np.cumsum([0] + [it["n"] for it in group])
            self.batches_launched += 1
            if self._has_post_fn:
                fut = self._inner.infer(
                    post_fn=self._make_split(group, offsets), **combined)
            else:
                fut = self._inner.infer(**combined)
        except BaseException as e:  # noqa: BLE001 - fail the WHOLE group
            for it in group:
                if not it["future"].done():
                    it["future"].set_exception(e)
            return

        def _settle(f):
            exc = f.exception()
            if exc is not None:
                for it in group:
                    if not it["future"].done():
                        it["future"].set_exception(exc)
            elif not self._has_post_fn:
                # remote runners resolve to an outputs dict directly
                outs = f.result()
                for i, it in enumerate(group):
                    lo, hi = offsets[i], offsets[i + 1]
                    if not it["future"].done():
                        it["future"].set_result(
                            {k: v[lo:hi] for k, v in outs.items()})
        fut.add_done_callback(_settle)

    def _make_split(self, group: List[dict], offsets):
        def split(bindings):
            cs = getattr(bindings, "compute_seconds", None)
            self.last_compute_s = cs
            outs = bindings.outputs()
            for i, it in enumerate(group):
                lo, hi = offsets[i], offsets[i + 1]
                if not it["future"].done():
                    it["future"]._tpulab_compute_s = cs  # per-request timing
                    it["future"].set_result(
                        {k: v[lo:hi].copy() for k, v in outs.items()})
        return lambda b: (split(b), None)[1]
