"""Dispatcher: batching + concurrency + timeout control (the port's own
copy of ``tpulab/core/dispatcher.py``; reference dispatcher.h:29-333).

Wraps a :class:`~tpulab_torch.core.batcher.StandardBatcher` with execution policy:

- :class:`Dispatcher` — the std-threads specialization (reference
  dispatcher.h:29-180): closed batches run on a worker :class:`ThreadPool`;
  window timeouts fire from a :class:`DeferredShortTaskPool` progress task
  keyed on a dispatch id so stale timers are ignored.
- :class:`AsyncDispatcher` — the fiber specialization (reference
  dispatcher.h:184-333): lives inside an event loop; each closed batch is a
  detached task (QueueBatch:271-282) and the window timeout is a sleeping
  task (QueueProgressTask:284-294) — the asyncio mapping of detached fibers.

``execute_fn(items, completer)`` computes a batch and calls
``completer(result)`` (or ``completer.fail(exc)``) to wake all waiters.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import Future
from typing import Awaitable, Callable, Generic, List, Optional, TypeVar

from tpulab_torch.core.batcher import Batch, StandardBatcher
from tpulab_torch.core.task_pool import DeferredShortTaskPool
from tpulab_torch.core.thread_pool import ThreadPool

T = TypeVar("T")


class Completer:
    """Completion handle passed to execute_fn (reference completer callable)."""

    __slots__ = ("_batch",)

    def __init__(self, batch: Batch):
        self._batch = batch

    def __call__(self, result=None) -> None:
        self._batch.complete(result)

    def fail(self, exc: BaseException) -> None:
        self._batch.fail(exc)


class Dispatcher(Generic[T]):
    """std-threads dispatcher (reference dispatcher.h:29-180)."""

    def __init__(self, max_batch_size: int, window_s: float,
                 execute_fn: Callable[[List[T], Completer], None],
                 workers: Optional[ThreadPool] = None, n_workers: int = 1):
        self._batcher: StandardBatcher[T] = StandardBatcher(max_batch_size)
        self._window = window_s
        self._execute = execute_fn
        self._own_workers = workers is None
        self._workers = workers or ThreadPool(n_workers, name="dispatch")
        self._timers = DeferredShortTaskPool(name="dispatch-timer")
        self._lock = threading.Lock()

    def enqueue(self, item: T) -> Future:
        """Thread-safe enqueue (reference dispatcher.h:79-104, under mutex)."""
        with self._lock:
            first_in_batch = self._batcher.empty()
            fut = self._batcher.enqueue(item)
            batch_id = self._batcher.current_batch_id
            batch = self._batcher.update()
        if batch is not None:
            self._queue_batch(batch)
        elif first_in_batch:
            # arm the window timer for this dispatch id (ProgressTask keying,
            # reference dispatcher.h:140-170)
            self._timers.enqueue_deferred(
                self._window, lambda: self._progress_task(batch_id))
        return fut

    def _progress_task(self, batch_id: int) -> None:
        with self._lock:
            if self._batcher.current_batch_id != batch_id:
                return  # stale timer — batch already closed by size
            batch = self._batcher.close_batch()
        if batch is not None:
            self._queue_batch(batch)

    def _queue_batch(self, batch: Batch) -> None:
        self._workers.enqueue(self._run_batch, batch)

    def _run_batch(self, batch: Batch) -> None:
        completer = Completer(batch)
        try:
            self._execute(batch.items, completer)
        except BaseException as e:  # noqa: BLE001
            if not batch.future.done():
                completer.fail(e)

    def flush(self) -> None:
        """Close any open batch immediately (drain path)."""
        with self._lock:
            batch = self._batcher.close_batch()
        if batch is not None:
            self._queue_batch(batch)

    def shutdown(self) -> None:
        self.flush()
        self._timers.shutdown()
        if self._own_workers:
            self._workers.shutdown()

    def __enter__(self) -> "Dispatcher[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class AsyncDispatcher(Generic[T]):
    """Event-loop (fiber-analog) dispatcher (reference dispatcher.h:184-333).

    Use from a single event loop.  ``execute_fn`` may be sync or async; each
    closed batch runs as a detached task.
    """

    def __init__(self, max_batch_size: int, window_s: float,
                 execute_fn: Callable[[List[T], Completer], Optional[Awaitable]]):
        self._batcher: StandardBatcher[T] = StandardBatcher(max_batch_size)
        self._window = window_s
        self._execute = execute_fn
        self._tasks: set = set()
        self._timer: Optional[asyncio.Task] = None

    def enqueue(self, item: T) -> asyncio.Future:
        """Must be called from the owning event loop."""
        loop = asyncio.get_running_loop()
        first_in_batch = self._batcher.empty()
        cf = self._batcher.enqueue(item)
        batch_id = self._batcher.current_batch_id
        batch = self._batcher.update()
        if batch is not None:
            self._cancel_timer()
            self._queue_batch(batch)
        elif first_in_batch:
            self._timer = asyncio.get_running_loop().create_task(
                self._progress_task(batch_id))
        return asyncio.wrap_future(cf, loop=loop)

    async def _progress_task(self, batch_id: int) -> None:
        """Sleeping progress fiber (reference dispatcher.h:285-294)."""
        try:
            await asyncio.sleep(self._window)
        except asyncio.CancelledError:
            return  # batch closed by size — stale timer
        if self._batcher.current_batch_id != batch_id:
            return
        batch = self._batcher.close_batch()
        if batch is not None:
            self._queue_batch(batch)

    def _cancel_timer(self) -> None:
        if self._timer is not None and not self._timer.done():
            self._timer.cancel()
        self._timer = None

    def _queue_batch(self, batch: Batch) -> None:
        self._detach(self._run_batch(batch))

    async def _run_batch(self, batch: Batch) -> None:
        completer = Completer(batch)
        try:
            result = self._execute(batch.items, completer)
            if asyncio.iscoroutine(result):
                await result
        except BaseException as e:  # noqa: BLE001
            if not batch.future.done():
                completer.fail(e)

    def _detach(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def flush(self) -> None:
        self._cancel_timer()
        batch = self._batcher.close_batch()
        if batch is not None:
            self._queue_batch(batch)
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
