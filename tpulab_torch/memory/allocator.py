"""The allocator facade: ``make_allocator`` (reference allocator.h:41-290).

Wraps any RawAllocator (allocate_node/deallocate_node + memory_type) in a
thread-safe shared object implementing the type-erased :class:`IAllocator`
interface, so descriptors can hold it and release from any thread.  Mirrors
``allocator_detail::smart_storage`` + ``allocator_impl`` + ``make_allocator``.

Threading policy (reference threading.h:27-112): stateless raw allocators get
the ``no_mutex`` policy; stateful ones are serialized with a real lock.  Pass
``thread_safe=False`` to force the no-mutex policy when the caller provides
external synchronization.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
from typing import Optional

from tpulab_torch.memory.descriptor import Descriptor, IAllocator
from tpulab_torch.memory.memory_type import MemoryType


def _is_stateful(raw) -> bool:
    return bool(getattr(raw, "is_stateful", True))


class AllocatorImpl(IAllocator):
    """IAllocator over a RawAllocator with a threading policy
    (reference allocator_impl / smart_storage)."""

    def __init__(self, raw, thread_safe: Optional[bool] = None):
        if not callable(getattr(raw, "allocate_node", None)):
            raise TypeError(f"{raw!r} does not satisfy the RawAllocator concept")
        self._raw = raw
        self.memory_type: MemoryType = raw.memory_type
        if thread_safe is None:
            thread_safe = _is_stateful(raw)
        self._lock = threading.Lock() if thread_safe else nullcontext()

    @property
    def raw(self):
        return self._raw

    def allocate(self, size: int, alignment: int = 0) -> int:
        alignment = alignment or self.memory_type.min_allocation_alignment
        with self._lock:
            return self._raw.allocate_node(size, alignment)

    def deallocate(self, addr: int, size: int, alignment: int = 0) -> None:
        alignment = alignment or self.memory_type.min_allocation_alignment
        with self._lock:
            self._raw.deallocate_node(addr, size, alignment)

    def max_alignment(self) -> int:
        fn = getattr(self._raw, "max_alignment", None)
        return fn() if callable(fn) else self.memory_type.access_alignment

    def device_buffer(self, addr: int):
        """The raw allocator's tensor for a device block (its ``buffer``)."""
        if self.memory_type.host_accessible:
            return None
        return self._raw.buffer(addr)

    def view(self, addr: int, size: int):
        fn = getattr(self._raw, "view", None)
        if callable(fn):
            return fn(addr, size)
        return super().view(addr, size)


def make_allocator(raw, thread_safe: Optional[bool] = None) -> AllocatorImpl:
    """The universal entry point (reference make_allocator, allocator.h:138+)."""
    if isinstance(raw, AllocatorImpl):
        return raw
    return AllocatorImpl(raw, thread_safe=thread_safe)
