"""Execution domains for RPC handlers (the port of
``tpulab/rpc/executor.py``; reference executor.h:39-113,
fiber/executor.h:37-64).

Round 3: the Executor OWNS its execution resources instead of being a
config record.  grpc-python still runs the completion queues internally,
but everything the reference's executor controls above the CQ is
controlled here:

- ``Executor(n_threads, contexts_per_thread, cpus=...)`` builds the
  server's worker pool itself and PINS each worker thread to the given
  cpu set (one cpu per thread round-robin when enough are given, else the
  whole set) — the reference's CQ-thread affinity
  (executor.h:84-99 thread affinity on progress engines).
- ``contexts_per_thread`` bounds in-flight requests
  (``maximum_concurrent_rpcs`` = the pre-armed-context bound) and sizes
  the server's pre-armed context free-lists (reference pre-allocated
  contexts, executor.cc:48-67): unary contexts are recycled, not
  re-instantiated per call.
- ``FiberExecutor(contexts, cpu=...)`` pins the grpc.aio event-loop
  thread; handlers are coroutines, so a blocked handler costs no OS
  thread (the reference's detached-fiber-per-event property).

Nothing here imports grpc: the server builds its grpc objects from
these records only when it starts.
"""

from __future__ import annotations

import threading
from concurrent import futures as _futures
from typing import List, Optional, Sequence


class Executor:
    """Thread-pool execution domain owning real threads and their
    placement (reference Executor)."""

    is_fiber = False

    def __init__(self, n_threads: int = 2, contexts_per_thread: int = 100,
                 cpus: Optional[Sequence[int]] = None):
        self.n_threads = n_threads
        self.contexts_per_thread = contexts_per_thread
        self.cpus: Optional[List[int]] = list(cpus) if cpus else None
        self._pin_lock = threading.Lock()
        self._pin_next = 0
        #: cpu each started worker pinned to (or the set), for inspection
        self.pinned: List[object] = []

    @property
    def max_concurrency(self) -> int:
        return self.n_threads * self.contexts_per_thread

    # -- thread placement ---------------------------------------------------
    def _pin_current_thread(self) -> None:
        """Worker-pool initializer: pin THIS thread per the cpu plan.
        One cpu per thread (round-robin) when the set is at least as large
        as the worker count; otherwise every worker shares the whole set
        (still isolates the RPC engine from e.g. dispatch threads)."""
        if not self.cpus:
            return
        from tpulab_torch.core.affinity import Affinity
        with self._pin_lock:
            idx = self._pin_next
            self._pin_next += 1
        try:
            if len(self.cpus) >= self.n_threads:
                cpu = self.cpus[idx % len(self.cpus)]
                Affinity.set_affinity([cpu])
                self.pinned.append(cpu)
            else:
                Affinity.set_affinity(self.cpus)
                self.pinned.append(tuple(self.cpus))
        except (OSError, AttributeError, NotImplementedError):
            pass  # restricted environments (no cpuset rights) or
            #       platforms without sched_setaffinity (macOS/Windows)

    def build_worker_pool(self, max_workers: Optional[int] = None
                          ) -> _futures.ThreadPoolExecutor:
        """The server's handler pool: sized to the pre-armed-context bound
        (capped — blocking handlers need a thread each while in flight),
        every worker pinned on first use."""
        workers = max_workers or max(self.n_threads,
                                     min(self.max_concurrency, 128))
        return _futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="rpc",
            initializer=self._pin_current_thread)


class FiberExecutor:
    """Event-loop execution domain (reference FiberExecutor)."""

    is_fiber = True

    def __init__(self, contexts: int = 1000, cpu: Optional[int] = None):
        self.contexts = contexts
        self.cpu = cpu

    @property
    def max_concurrency(self) -> int:
        return self.contexts

    def pin_loop_thread(self) -> None:
        """Pin the grpc.aio event-loop thread (called from that thread)."""
        if self.cpu is None:
            return
        try:
            from tpulab_torch.core.affinity import Affinity
            Affinity.set_affinity([self.cpu])
        except (OSError, AttributeError,  # pragma: no cover - restricted
                NotImplementedError):     # envs / non-Linux platforms
            pass
