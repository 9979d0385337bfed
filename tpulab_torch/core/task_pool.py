"""Single-thread deadline scheduler (the port's own copy of
``tpulab/core/task_pool.py``): a heap of deadline -> task serviced by one
thread waiting on the earliest deadline.  The batched runner's window
timers ride it."""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from typing import Callable

log = logging.getLogger("tpulab_torch.core")


class DeferredShortTaskPool:
    """Deadline-ordered task runner.  Tasks must be short: they run on
    the scheduler thread."""

    def __init__(self, name: str = "deferred"):
        self._heap: list = []  # (deadline, seq, fn)
        self._seq = itertools.count()
        self._cv = threading.Condition(threading.Lock())
        self._shutdown = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def enqueue_deferred(self, delay_s: float, fn: Callable[[], None]) -> None:
        """Run ``fn`` after ``delay_s`` seconds."""
        self.enqueue_at(time.monotonic() + max(0.0, delay_s), fn)

    def enqueue_at(self, deadline: float, fn: Callable[[], None]) -> None:
        with self._cv:
            if self._shutdown:
                raise RuntimeError("enqueue on stopped DeferredShortTaskPool")
            heapq.heappush(self._heap, (deadline, next(self._seq), fn))
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._shutdown and not self._heap:
                    self._cv.wait()
                if self._shutdown and not self._heap:
                    return
                deadline, _seq, fn = self._heap[0]
                now = time.monotonic()
                if deadline > now:
                    self._cv.wait(timeout=deadline - now)
                    continue
                heapq.heappop(self._heap)
            try:
                fn()
            except Exception:  # the scheduler must live
                log.exception("deferred task failed")

    def shutdown(self, drain: bool = False) -> None:
        with self._cv:
            self._shutdown = True
            if not drain:
                self._heap.clear()
            self._cv.notify()
        self._thread.join(timeout=10)

    def __enter__(self) -> "DeferredShortTaskPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
