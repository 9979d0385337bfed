"""Best-fit allocator for long-lived variable-size allocations
(reference bfit_allocator.h:20-123).

Maintains free nodes ordered by size (for best-fit search) and by address (for
coalescing on free) — the Python analog of the reference's twin
``memory_node_compare_size`` / ``memory_node_compare_addr`` ordered sets.
Intended for weights/executable artifacts: allocations live long, sizes vary,
fragmentation matters more than per-op cost.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from tpulab_torch.memory.arena import BlockArena
from tpulab_torch.memory.debugging import InvalidPointer, OutOfMemory
from tpulab_torch.memory.literals import align_up
from tpulab_torch.memory.memory_type import MemoryType


class BFitAllocator:
    """Best-fit free-block allocator (reference bfit_allocator)."""

    is_stateful = True

    def __init__(self, block_allocator, grow_on_demand: bool = True):
        self._arena = (block_allocator if isinstance(block_allocator, BlockArena)
                       else BlockArena(block_allocator, cached=False))
        self._grow = grow_on_demand
        # free list: sorted by (size, addr) for best-fit; plus addr-sorted
        self._free_by_size: List[Tuple[int, int]] = []   # (size, addr)
        self._free_by_addr: List[int] = []               # addrs
        self._free_sizes: Dict[int, int] = {}            # addr -> size
        self._live: Dict[int, int] = {}                  # addr -> size
        self._blocks = []

    @property
    def memory_type(self) -> MemoryType:
        return self._arena.memory_type

    @property
    def free_bytes(self) -> int:
        return sum(self._free_sizes.values())

    @property
    def live_allocations(self) -> int:
        return len(self._live)

    # -- free-list maintenance ---------------------------------------------
    def _insert_free(self, addr: int, size: int) -> None:
        # coalesce with predecessor / successor (address-ordered)
        i = bisect.bisect_left(self._free_by_addr, addr)
        if i > 0:
            prev = self._free_by_addr[i - 1]
            if prev + self._free_sizes[prev] == addr:
                addr, size = prev, self._free_sizes[prev] + size
                self._remove_free(prev)
                i = bisect.bisect_left(self._free_by_addr, addr)
        if i < len(self._free_by_addr):
            nxt = self._free_by_addr[i]
            if addr + size == nxt:
                size += self._free_sizes[nxt]
                self._remove_free(nxt)
        bisect.insort(self._free_by_addr, addr)
        bisect.insort(self._free_by_size, (size, addr))
        self._free_sizes[addr] = size

    def _remove_free(self, addr: int) -> None:
        size = self._free_sizes.pop(addr)
        self._free_by_addr.remove(addr)
        self._free_by_size.remove((size, addr))

    # -- RawAllocator concept ----------------------------------------------
    def allocate_node(self, size: int, alignment: int = 8) -> int:
        if size <= 0:
            raise OutOfMemory("BFitAllocator", size, "(non-positive)")
        addr = self._best_fit(size, alignment)
        if addr is None and self._grow:
            block = self._arena.allocate_block()
            self._blocks.append(block)
            self._insert_free(block.addr, block.size)
            addr = self._best_fit(size, alignment)
        if addr is None:
            raise OutOfMemory("BFitAllocator", size,
                              f"(free={self.free_bytes} fragmented or exhausted)")
        return addr

    def _best_fit(self, size: int, alignment: int) -> Optional[int]:
        i = bisect.bisect_left(self._free_by_size, (size, 0))
        while i < len(self._free_by_size):
            fsize, faddr = self._free_by_size[i]
            start = align_up(faddr, alignment)
            pad = start - faddr
            if fsize >= pad + size:
                self._remove_free(faddr)
                if pad:
                    self._insert_free(faddr, pad)
                rem = fsize - pad - size
                if rem:
                    self._insert_free(start + size, rem)
                self._live[start] = size
                return start
            i += 1
        return None

    def deallocate_node(self, addr: int, size: int = 0, alignment: int = 0) -> None:
        live = self._live.pop(addr, None)
        if live is None:
            raise InvalidPointer(f"0x{addr:x} is not live in BFitAllocator")
        self._insert_free(addr, live)

    def view(self, addr: int, size: int):
        from tpulab_torch.memory.descriptor import host_view
        return host_view(addr, size)
