"""RAII allocator: records live descriptors, frees leftovers on close
(reference raii_allocator.h:41-155)."""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from tpulab_torch.memory.debugging import report_leak
from tpulab_torch.memory.descriptor import Descriptor, IAllocator
from tpulab_torch.memory.memory_type import MemoryType


class RaiiAllocator(IAllocator):
    """Tracks outstanding allocations and reclaims them on close()."""

    def __init__(self, inner: IAllocator, name: str = "raii"):
        self._inner = inner
        self.name = name
        self.memory_type: MemoryType = inner.memory_type
        self._lock = threading.Lock()
        self._live: Dict[int, Tuple[int, int]] = {}  # addr -> (size, alignment)
        self._closed = False

    def allocate(self, size: int, alignment: int = 0) -> int:
        addr = self._inner.allocate(size, alignment)
        with self._lock:
            self._live[addr] = (size, alignment)
        return addr

    def deallocate(self, addr: int, size: int, alignment: int = 0) -> None:
        with self._lock:
            self._live.pop(addr, None)
        self._inner.deallocate(addr, size, alignment)

    def view(self, addr: int, size: int):
        return self._inner.view(addr, size)

    @property
    def live_allocations(self) -> int:
        with self._lock:
            return len(self._live)

    def close(self) -> None:
        """Free anything still outstanding (reference raii_storage dtor)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            leftovers = list(self._live.items())
            self._live.clear()
        if leftovers:
            report_leak(self.name, sum(s for _, (s, _a) in leftovers))
            for addr, (size, alignment) in leftovers:
                self._inner.deallocate(addr, size, alignment)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
