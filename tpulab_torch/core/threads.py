"""Thread-type policies + the userspace execution domain.

The reference selects sync primitives at compile time between ``std::`` and
``boost::fibers::`` (reference standard_threads.h:1-40,
userspace_threads.h:1-42) so one Pool/Batcher implementation serves both OS
threads and fibers.  The Python-native mapping:

- ``standard_threads``: ``threading`` primitives + ``concurrent.futures.Future``.
- ``userspace_threads``: asyncio primitives + ``asyncio`` futures.  Fibers in
  the reference exist so request handlers can *block* on pool pops and device
  sync without stalling OS threads; in Python the same property comes from
  awaiting inside an event loop.  Components with fiber specializations in the
  reference (Pool, Dispatcher, sync) therefore expose ``*_async`` variants
  usable under this policy.

``EventLoopGroup`` is the ``FiberGroup`` analog (reference fiber_group.h:9-51):
N OS threads each running an asyncio loop, forming a userspace execution
domain with work-sharing submission.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import threading
from typing import Awaitable, Callable, Optional, Sequence


class standard_threads:
    """OS-thread policy (reference standard_threads.h)."""

    Mutex = threading.Lock
    RecursiveMutex = threading.RLock
    Condition = threading.Condition
    Future = concurrent.futures.Future

    @staticmethod
    def make_future() -> concurrent.futures.Future:
        return concurrent.futures.Future()

    @staticmethod
    def async_(fn: Callable, *args) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 - promise semantics
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    @staticmethod
    def sleep(seconds: float) -> None:
        import time
        time.sleep(seconds)


class userspace_threads:
    """Event-loop (fiber-analog) policy (reference userspace_threads.h)."""

    Mutex = asyncio.Lock
    Condition = asyncio.Condition

    @staticmethod
    def make_future() -> asyncio.Future:
        return asyncio.get_event_loop().create_future()

    @staticmethod
    def async_(coro: Awaitable) -> "asyncio.Task":
        return asyncio.get_event_loop().create_task(coro)

    @staticmethod
    async def sleep(seconds: float) -> None:
        await asyncio.sleep(seconds)


class EventLoopGroup:
    """N OS threads running asyncio loops — the FiberGroup analog
    (reference fiber_group.h:9-51, algo::shared_work scheduler).

    ``submit(coro)`` schedules onto the least-recently-used loop (round-robin
    work sharing); ``submit_fn`` wraps a plain callable.  All loops drain and
    join on ``shutdown()``/context exit.
    """

    def __init__(self, n_threads: int, name: str = "elg"):
        if n_threads < 1:
            raise ValueError("need at least one thread")
        self._loops: list[asyncio.AbstractEventLoop] = []
        self._threads: list[threading.Thread] = []
        self._rr = itertools.cycle(range(n_threads))
        self._started = threading.Barrier(n_threads + 1)
        for i in range(n_threads):
            t = threading.Thread(target=self._run_loop, name=f"{name}-{i}", daemon=True)
            self._threads.append(t)
            t.start()
        self._started.wait()

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loops.append(loop)
        self._started.wait()
        loop.run_forever()
        # drain pending callbacks then close
        loop.run_until_complete(loop.shutdown_asyncgens())
        loop.close()

    @property
    def size(self) -> int:
        return len(self._threads)

    def submit(self, coro: Awaitable) -> concurrent.futures.Future:
        """Schedule a coroutine on the next loop; thread-safe."""
        loop = self._loops[next(self._rr)]
        return asyncio.run_coroutine_threadsafe(coro, loop)

    def submit_fn(self, fn: Callable, *args) -> concurrent.futures.Future:
        async def runner():
            return fn(*args)
        return self.submit(runner())

    def shutdown(self) -> None:
        for loop in self._loops:
            loop.call_soon_threadsafe(loop.stop)
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self) -> "EventLoopGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
