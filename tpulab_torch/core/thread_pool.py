"""Work-queue thread pool with CPU-affinity constructors (the port's own
copy of ``tpulab/core/thread_pool.py``).

- ``ThreadPool(n)`` — N workers, no pinning
- ``ThreadPool(n, cpus=CpuSet)`` — N workers sharing one affinity mask
- ``ThreadPool.one_per_cpu(cpus)`` — one worker pinned to each CPU
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, List, Optional

from tpulab_torch.core.affinity import Affinity, CpuSet


class ThreadPool:
    """Classic work-queue pool; ``enqueue`` returns a future."""

    def __init__(self, n_threads: int, cpus: Optional[CpuSet] = None,
                 name: str = "pool"):
        if n_threads < 1:
            raise ValueError("need at least one thread")
        self._init(name)
        for i in range(n_threads):
            self._spawn(f"{name}-{i}", cpus)

    @classmethod
    def one_per_cpu(cls, cpus: CpuSet, name: str = "pool") -> "ThreadPool":
        """One thread pinned to each CPU of ``cpus``."""
        if not cpus:
            raise ValueError("one_per_cpu requires a non-empty CpuSet")
        self = cls.__new__(cls)
        self._init(name)
        for cpu in cpus:
            self._spawn(f"{name}-cpu{cpu}", CpuSet([cpu]))
        return self

    def _init(self, name: str) -> None:
        self._tasks: "queue.Queue" = queue.Queue()
        self._shutdown = False
        self._state_lock = threading.Lock()
        self._name = name
        self._threads: List[threading.Thread] = []

    def _spawn(self, name: str, cpus: Optional[CpuSet]) -> None:
        t = threading.Thread(target=self._worker, args=(cpus,), name=name,
                             daemon=True)
        self._threads.append(t)
        t.start()

    def _worker(self, cpus: Optional[CpuSet]) -> None:
        if cpus:
            try:
                Affinity.set_affinity(cpus)
            except OSError:  # a CPU outside this cgroup: run unpinned
                pass
        while True:
            task = self._tasks.get()
            if task is None:
                return
            fn, args, kwargs, fut = task
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn(*args, **kwargs))
                except BaseException as e:  # noqa: BLE001 - promise semantics
                    fut.set_exception(e)

    @property
    def size(self) -> int:
        return len(self._threads)

    def enqueue(self, fn: Callable, *args, **kwargs) -> Future:
        """Submit work; returns a future of its result."""
        fut: Future = Future()
        # the flag check and the put are one step: a task queued behind
        # the shutdown sentinels would never run and never resolve
        with self._state_lock:
            if self._shutdown:
                raise RuntimeError("enqueue on stopped ThreadPool")
            self._tasks.put((fn, args, kwargs, fut))
        return fut

    submit = enqueue

    def shutdown(self, wait: bool = True) -> None:
        with self._state_lock:
            if self._shutdown:
                return
            self._shutdown = True
            for _ in self._threads:
                self._tasks.put(None)
        if wait:
            for t in self._threads:
                t.join(timeout=10)

    def __enter__(self) -> "ThreadPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
