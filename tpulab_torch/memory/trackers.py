"""Allocation trackers (reference trackers.h:10-31, tracking.h:23-170).

Instrumentation layered onto any allocator: ``SizeTracker`` counts live/total
bytes; ``TrackedBlockAllocator`` observes block traffic; both export their
gauges to :mod:`tpulab_torch.utils.metrics` when attached.
"""

from __future__ import annotations

import threading
from typing import Optional


class SizeTracker:
    """Byte counter wrapper over a RawAllocator (reference size_tracker)."""

    def __init__(self, inner, name: str = "size_tracker"):
        self._inner = inner
        self.name = name
        self._lock = threading.Lock()
        self.bytes_in_use = 0
        self.peak_bytes = 0
        self.total_allocations = 0
        self.total_bytes = 0

    @property
    def memory_type(self):
        return self._inner.memory_type

    @property
    def is_stateful(self):
        return True

    def allocate_node(self, size: int, alignment: int = 8) -> int:
        addr = self._inner.allocate_node(size, alignment)
        with self._lock:
            self.bytes_in_use += size
            self.total_bytes += size
            self.total_allocations += 1
            self.peak_bytes = max(self.peak_bytes, self.bytes_in_use)
        return addr

    def deallocate_node(self, addr: int, size: int, alignment: int = 8) -> None:
        self._inner.deallocate_node(addr, size, alignment)
        with self._lock:
            self.bytes_in_use -= size

    def view(self, addr: int, size: int):
        return self._inner.view(addr, size)

    def max_node_size(self) -> int:
        fn = getattr(self._inner, "max_node_size", None)
        return fn() if callable(fn) else (1 << 48)


class TrackedBlockAllocator:
    """Block-traffic observer (reference tracked_block_allocator /
    deeply_tracked_block_allocator)."""

    def __init__(self, inner, on_allocate=None, on_deallocate=None):
        self._inner = inner
        self._on_alloc = on_allocate
        self._on_dealloc = on_deallocate
        self.blocks_allocated = 0
        self.blocks_deallocated = 0
        self.bytes_in_use = 0

    @property
    def memory_type(self):
        return self._inner.memory_type

    @property
    def next_block_size(self):
        return self._inner.next_block_size

    def allocate_block(self):
        block = self._inner.allocate_block()
        self.blocks_allocated += 1
        self.bytes_in_use += block.size
        if self._on_alloc:
            self._on_alloc(block)
        return block

    def deallocate_block(self, block) -> None:
        self._inner.deallocate_block(block)
        self.blocks_deallocated += 1
        self.bytes_in_use -= block.size
        if self._on_dealloc:
            self._on_dealloc(block)
