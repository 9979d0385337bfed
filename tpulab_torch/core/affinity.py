"""CPU affinity + NUMA topology (reference affinity.h:36-109, affinity.cc).

``CpuSet`` is the set-algebra type (intersection/union/difference,
``from_string``); ``Affinity`` exposes per-thread get/set
(``os.sched_getaffinity``/``sched_setaffinity``), topology enumeration from
/sys, and a round-robin allocator.  ``AffinityGuard`` is the RAII scope.

The port's own copy of ``tpulab/core/affinity.py``.  It pins
pre/post-processing threads and staging-buffer first-touch to the CPUs local
to the card's PCI bus (the reference's GPU<->CPU affinity from NVML,
device_info.cc; :meth:`tpulab_torch.cuda.device_info.DeviceInfo.cpu_affinity`).
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Iterable, Iterator, List, Optional, Sequence


def _parse_cpulist(text: str) -> List[int]:
    """Parse kernel cpulist format: '0-3,8,10-11'."""
    cpus: List[int] = []
    text = text.strip()
    if not text:
        return cpus
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            cpus.extend(range(int(lo), int(hi) + 1))
        else:
            cpus.append(int(part))
    return cpus


class CpuSet:
    """Set of logical CPUs with set algebra (reference cpu_set)."""

    def __init__(self, cpus: Iterable[int] = ()):
        self._cpus = frozenset(int(c) for c in cpus)

    @classmethod
    def from_string(cls, s: str) -> "CpuSet":
        return cls(_parse_cpulist(s))

    def union(self, other: "CpuSet") -> "CpuSet":
        return CpuSet(self._cpus | other._cpus)

    def intersection(self, other: "CpuSet") -> "CpuSet":
        return CpuSet(self._cpus & other._cpus)

    def difference(self, other: "CpuSet") -> "CpuSet":
        return CpuSet(self._cpus - other._cpus)

    __or__ = union
    __and__ = intersection
    __sub__ = difference

    def __iter__(self) -> Iterator[int]:
        return iter(sorted(self._cpus))

    def __len__(self) -> int:
        return len(self._cpus)

    def __contains__(self, cpu: int) -> bool:
        return cpu in self._cpus

    def __eq__(self, other) -> bool:
        return isinstance(other, CpuSet) and self._cpus == other._cpus

    def __hash__(self) -> int:
        return hash(self._cpus)

    def __bool__(self) -> bool:
        return bool(self._cpus)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"CpuSet([{','.join(map(str, sorted(self._cpus)))}])"

    def get_nth(self, n: int) -> int:
        return sorted(self._cpus)[n]


class NumaNode:
    """One NUMA node: id + its CPUs (reference numa_node)."""

    def __init__(self, node_id: int, cpus: CpuSet):
        self.id = node_id
        self.cpus = cpus

    def __repr__(self) -> str:  # pragma: no cover
        return f"NumaNode({self.id}, {self.cpus!r})"


class Affinity:
    """Static topology + per-thread affinity API (reference affinity::*)."""

    _rr_lock = threading.Lock()
    _rr_next = 0

    # -- this_thread --------------------------------------------------------
    @staticmethod
    def get_affinity() -> CpuSet:
        return CpuSet(os.sched_getaffinity(0))

    @staticmethod
    def set_affinity(cpus: CpuSet | Sequence[int]) -> None:
        os.sched_setaffinity(0, set(cpus))

    # -- system topology ----------------------------------------------------
    @staticmethod
    def all_cpus() -> CpuSet:
        return CpuSet(range(os.cpu_count() or 1))

    @staticmethod
    def numa_nodes() -> List[NumaNode]:
        nodes = []
        for path in sorted(glob.glob("/sys/devices/system/node/node[0-9]*")):
            node_id = int(os.path.basename(path)[4:])
            try:
                with open(os.path.join(path, "cpulist")) as f:
                    cpus = CpuSet(_parse_cpulist(f.read()))
            except OSError:
                cpus = CpuSet()
            nodes.append(NumaNode(node_id, cpus))
        if not nodes:  # non-NUMA fallback: one node with everything
            nodes = [NumaNode(0, Affinity.all_cpus())]
        return nodes

    @classmethod
    def round_robin(cls, count: int, pool: Optional[CpuSet] = None) -> List[int]:
        """Allocate `count` CPUs round-robin from `pool` (reference allocator)."""
        cpus = sorted(pool or cls.all_cpus())
        out = []
        with cls._rr_lock:
            for _ in range(count):
                out.append(cpus[cls._rr_next % len(cpus)])
                cls._rr_next += 1
        return out


class AffinityGuard:
    """RAII affinity scope (reference affinity_guard)."""

    def __init__(self, cpus: CpuSet | Sequence[int]):
        self._saved = Affinity.get_affinity()
        Affinity.set_affinity(cpus)

    def __enter__(self) -> "AffinityGuard":
        return self

    def __exit__(self, *exc) -> None:
        Affinity.set_affinity(self._saved)
