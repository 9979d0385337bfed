"""tpulab_torch.core — host-side concurrency runtime (the port of
``tpulab/core``; reference trtlab/core, ~10k LoC).

Components and their reference analogs:

- :mod:`threads` — thread-type policies (reference standard_threads.h /
  userspace_threads.h) and ``EventLoopGroup``, the Python-native analog of the
  boost.fiber ``FiberGroup`` (fiber_group.h:9-51).
- :mod:`pool` — blocking resource pools with RAII return-to-pool handles
  (reference pool.h v1-v4; v4 ``pop_shared``/``pop_unique`` semantics).
- :mod:`thread_pool` — work-queue pool with CPU-affinity constructors
  (reference thread_pool.h:73-298).
- :mod:`task_pool` — single-thread deadline scheduler for batching windows
  (reference task_pool.h:36-113).
- :mod:`batcher` / :mod:`dispatcher` — the dynamic batching state machine and
  its threaded/async execution wrappers (reference batcher.h, dispatcher.h).
- :mod:`affinity` — cpu_set algebra + NUMA topology (reference affinity.h/cc).
- :mod:`async_compute` — promise-fulfilling callable wrapper
  (reference async_compute.h:38-118).
- :mod:`cyclic_buffer` — sliding-window streaming compute over descriptors
  (reference cyclic_windowed_buffer.h:59-440).
- :mod:`dtypes` — DLPack-based dtype descriptors (reference types.h:40-139).
- :mod:`resources` — service-wide resource bundle base (reference resources.h).
- :mod:`deadline` — request deadlines (the port's copy of tpulab's).
"""

from tpulab_torch.core.pool import Pool, UniquePool, Queue
from tpulab_torch.core.thread_pool import ThreadPool
from tpulab_torch.core.task_pool import DeferredShortTaskPool
from tpulab_torch.core.batcher import StandardBatcher, Batch
from tpulab_torch.core.dispatcher import Dispatcher, AsyncDispatcher
from tpulab_torch.core.affinity import CpuSet, Affinity
from tpulab_torch.core.async_compute import async_compute, SharedPackagedTask
from tpulab_torch.core.threads import standard_threads, userspace_threads, EventLoopGroup
from tpulab_torch.core.resources import Resources
from tpulab_torch.core.dtypes import DType, dtype_from_numpy
from tpulab_torch.core.cyclic_buffer import (
    CyclicWindowedStack,
    CyclicWindowedTaskExecutor,
    CyclicWindowedReservedStack,
)

__all__ = [
    "Pool", "UniquePool", "Queue",
    "ThreadPool", "DeferredShortTaskPool",
    "StandardBatcher", "Batch", "Dispatcher", "AsyncDispatcher",
    "CpuSet", "Affinity",
    "async_compute", "SharedPackagedTask",
    "standard_threads", "userspace_threads", "EventLoopGroup",
    "Resources", "DType", "dtype_from_numpy",
    "CyclicWindowedStack", "CyclicWindowedTaskExecutor",
    "CyclicWindowedReservedStack",
]
