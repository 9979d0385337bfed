"""CPU sets and per-thread affinity: the part of ``tpulab/core/affinity.py``
that :class:`~tpulab_torch.core.thread_pool.ThreadPool` calls (NUMA
enumeration, set algebra and the round-robin allocator are not carried)."""

from __future__ import annotations

import os
from typing import Iterable, Iterator


class CpuSet:
    """A set of logical CPUs."""

    def __init__(self, cpus: Iterable[int] = ()):
        self._cpus = frozenset(int(c) for c in cpus)

    def __iter__(self) -> Iterator[int]:
        return iter(sorted(self._cpus))

    def __len__(self) -> int:
        return len(self._cpus)


class Affinity:
    """The calling thread's CPU affinity."""

    @staticmethod
    def set_affinity(cpus: Iterable[int]) -> None:
        os.sched_setaffinity(0, set(cpus))
