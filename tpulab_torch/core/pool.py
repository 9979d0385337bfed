"""Blocking resource pools with return-to-pool handles (the port's own
copy of ``tpulab/core/pool.py``; the semantics are identical).

Popping returns a :class:`PoolItem` whose close or garbage collection
returns the resource to the pool, keeping the pool alive through a
strong reference.  ``Pool.pop()`` blocks when the pool is empty: the
backpressure the :class:`~tpulab_torch.engine.inference_manager.InferenceManager`
builds on.  ``pop_async()`` awaits without blocking the OS thread.

tpulab's ``NativeBackedPool`` rides its C++ futex core (``cpp/``), which
the port does not load: :func:`make_serving_pool` always returns the
Python :class:`Pool` (ROADMAP decisions: "Python pools only").
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Callable, Generic, Iterable, Optional, TypeVar

T = TypeVar("T")


class Queue(Generic[T]):
    """Mutex + condition-variable blocking FIFO."""

    def __init__(self):
        self._items: collections.deque[T] = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def push(self, item: T) -> None:
        with self._cv:
            self._items.append(item)
            self._cv.notify()

    def pop(self, timeout: Optional[float] = None) -> T:
        with self._cv:
            if not self._cv.wait_for(lambda: len(self._items) > 0, timeout):
                raise TimeoutError("Queue.pop timed out")
            return self._items.popleft()

    def try_pop(self) -> Optional[T]:
        with self._cv:
            return self._items.popleft() if self._items else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def empty(self) -> bool:
        return len(self) == 0


class PoolItem(Generic[T]):
    """RAII handle: returns the resource on ``release`` / close / GC."""

    __slots__ = ("_value", "_returned", "_finalizer", "__weakref__")

    def __init__(self, value: T, return_fn: Callable[[T], None]):
        self._value = value
        self._returned = False
        self._finalizer = weakref.finalize(self, return_fn, value)

    def get(self) -> T:
        if self._returned:
            raise RuntimeError("pool item already returned")
        return self._value

    @property
    def value(self) -> T:
        return self.get()

    def release(self) -> None:
        """Return the resource to the pool now (idempotent)."""
        if not self._returned:
            self._returned = True
            self._finalizer()

    close = release

    def detach(self) -> T:
        """Take the resource out of pool management permanently."""
        if self._returned:
            raise RuntimeError("pool item already returned")
        self._returned = True
        self._finalizer.detach()
        return self._value

    def __enter__(self) -> T:
        return self.get()

    def __exit__(self, *exc) -> None:
        self.release()


class Pool(Generic[T]):
    """Shared resource pool.

    - ``push(item)`` adds a resource
    - ``pop()`` blocks until one is available and returns a :class:`PoolItem`
    - ``pop_async()`` is the awaitable variant for event-loop handlers
    - ``on_return`` runs as an item re-enters the pool (reset semantics)
    """

    def __init__(self, items: Iterable[T] = (),
                 on_return: Optional[Callable[[T], None]] = None):
        self._queue: Queue[T] = Queue()
        self._on_return = on_return
        self._waiters: collections.deque = collections.deque()
        self._waiter_lock = threading.Lock()
        self._size = 0
        for it in items:
            self.push(it)

    @property
    def size(self) -> int:
        """Total resources owned (in the pool + checked out)."""
        return self._size

    @property
    def available(self) -> int:
        return len(self._queue)

    def push(self, item: T) -> None:
        with self._waiter_lock:
            self._size += 1
        self._return(item, run_hook=False)

    def _return(self, item: T, run_hook: bool = True) -> None:
        if run_hook and self._on_return is not None:
            self._on_return(item)
        # hand straight to an async waiter if any, else queue; under the
        # waiter lock, because pop_async registers waiters under it after
        # re-checking the queue (no lost wake-up)
        with self._waiter_lock:
            while self._waiters:
                fut, loop = self._waiters.popleft()
                if not fut.done():
                    loop.call_soon_threadsafe(self._deliver, fut, item)
                    return
            self._queue.push(item)

    def _deliver(self, fut, item: T) -> None:
        # on the waiter's loop: a waiter cancelled meanwhile must not lose
        # the resource
        if fut.done():
            self._return(item, run_hook=False)
        else:
            fut.set_result(item)

    def pop(self, timeout: Optional[float] = None,
            on_return: Optional[Callable[[T], None]] = None) -> PoolItem[T]:
        """Blocking pop.  MAY BLOCK: the backpressure point."""
        value = self._queue.pop(timeout)

        def return_fn(v: T) -> None:
            if on_return is not None:
                on_return(v)
            self._return(v)

        return PoolItem(value, return_fn)

    async def pop_async(self) -> PoolItem[T]:
        """Event-loop pop."""
        import asyncio
        value = self._queue.try_pop()
        if value is None:
            loop = asyncio.get_running_loop()
            fut: asyncio.Future = loop.create_future()
            with self._waiter_lock:
                value = self._queue.try_pop()
                if value is None:
                    self._waiters.append((fut, loop))
            if value is None:
                value = await fut
        return PoolItem(value, self._return)

    def try_pop(self) -> Optional[PoolItem[T]]:
        value = self._queue.try_pop()
        if value is None:
            return None
        return PoolItem(value, self._return)


def make_serving_pool(items: Iterable[T] = (),
                      on_return: Optional[Callable[[T], None]] = None
                      ) -> Pool[T]:
    """The serving pools' constructor: the Python :class:`Pool` (tpulab
    picks its native futex pool here when the C++ core is built)."""
    return Pool(items, on_return)
