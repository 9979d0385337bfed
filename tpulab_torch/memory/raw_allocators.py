"""Raw host allocators (reference malloc_allocator.h:39,
posix_aligned_allocator.h:13-19, huge_page_allocator.h:9-10).

Raw allocators are the leaves of the composition chain: they produce real
memory.  In this build host memory comes from ``mmap`` (page-aligned, so any
alignment <= 4096 is free) with an over-allocate-and-offset path for larger
alignments.  ``HugePageAllocator`` requests transparent huge pages via
``madvise(MADV_HUGEPAGE)`` — the honest Linux equivalent of the reference's
2MiB THP allocator.

A raw allocator is *stateful* (it owns its mappings) but cheap; the
``make_allocator`` facade adds thread-safety and ``IAllocator`` erasure
(reference allocator.h / allocator_traits.h RawAllocator concept:
allocate_node/deallocate_node, memory_type, is_stateful).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import mmap
from typing import Dict, Tuple

from tpulab_torch.memory.debugging import InvalidPointer, OutOfMemory
from tpulab_torch.memory.literals import align_up
from tpulab_torch.memory.memory_type import HostMemory, MemoryType

_libc = ctypes.CDLL(None, use_errno=True)

MADV_HUGEPAGE = 14


def _addr_of(buf: mmap.mmap) -> int:
    return ctypes.addressof(ctypes.c_char.from_buffer(buf))


class MallocAllocator:
    """General-purpose host allocator over mmap (reference malloc_allocator.h:39).

    RawAllocator concept: allocate_node/deallocate_node; stateful (owns maps).
    """

    memory_type: MemoryType = HostMemory
    is_stateful = True

    def __init__(self):
        # addr -> (mmap object, base address)
        self._maps: Dict[int, Tuple[mmap.mmap, int]] = {}

    # RawAllocator concept --------------------------------------------------
    def allocate_node(self, size: int, alignment: int = 8) -> int:
        if size <= 0:
            raise OutOfMemory(type(self).__name__, size, "(non-positive size)")
        alignment = max(alignment, self.memory_type.min_allocation_alignment)
        span = size if alignment <= mmap.PAGESIZE else size + alignment
        try:
            m = mmap.mmap(-1, span)
        except OSError as e:
            raise OutOfMemory(type(self).__name__, span, str(e)) from e
        base = _addr_of(m)
        addr = align_up(base, alignment)
        self._post_map(addr, span - (addr - base))
        self._maps[addr] = (m, base)
        return addr

    def deallocate_node(self, addr: int, size: int, alignment: int = 8) -> None:
        try:
            m, _base = self._maps.pop(addr)
        except KeyError:
            raise InvalidPointer(f"0x{addr:x} not allocated by {type(self).__name__}")
        m.close()

    def _post_map(self, addr: int, span: int) -> None:
        """Hook for subclasses (huge pages, first-touch)."""

    def view(self, addr: int, size: int) -> memoryview:
        from tpulab_torch.memory.descriptor import host_view
        return host_view(addr, size)

    def owns(self, addr: int) -> bool:
        return addr in self._maps

    @property
    def live_allocations(self) -> int:
        return len(self._maps)

    def max_node_size(self) -> int:
        return 1 << 48


class AlignedAllocator(MallocAllocator):
    """Fixed-alignment host allocator (reference posix_aligned_allocator<Align>)."""

    def __init__(self, alignment: int = 64):
        super().__init__()
        if alignment & (alignment - 1):
            raise ValueError("alignment must be a power of two")
        self.alignment = alignment

    def allocate_node(self, size: int, alignment: int = 0) -> int:
        return super().allocate_node(size, max(alignment, self.alignment))


class HugePageAllocator(MallocAllocator):
    """Transparent-huge-page host allocator (reference huge_page_allocator<2MiB>).

    Aligns every mapping to 2 MiB and advises the kernel to back it with THP.
    Falls back silently to normal pages where THP is unavailable.
    """

    HUGE_PAGE_SIZE = 2 * 1024 * 1024

    def allocate_node(self, size: int, alignment: int = 0) -> int:
        size = align_up(size, self.HUGE_PAGE_SIZE)
        return super().allocate_node(size, max(alignment, self.HUGE_PAGE_SIZE))

    def _post_map(self, addr: int, span: int) -> None:
        try:
            _libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(span), MADV_HUGEPAGE)
        except Exception:  # pragma: no cover - advisory only
            pass


class FirstTouchAllocator(MallocAllocator):
    """NUMA first-touch adaptor (reference core first_touch_allocator.h:34-60).

    Touches (zero-fills) every page at allocation time from the calling thread
    so pages land on that thread's NUMA node.  Combine with
    :mod:`tpulab_torch.core.affinity` to bind the touching thread to the card's
    local node before allocating staging buffers.
    """

    def __init__(self, fill: int = 0):
        super().__init__()
        self._fill = fill

    def _post_map(self, addr: int, span: int) -> None:
        ctypes.memset(ctypes.c_void_p(addr), self._fill, span)
