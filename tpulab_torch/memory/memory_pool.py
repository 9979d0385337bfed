"""Fixed-node memory pool over a free list (reference memory_pool.h:37-295,
detail/free_list.h).

Carves blocks from a block arena into fixed-size nodes kept on a LIFO free
list; ``allocate_node`` pops, ``deallocate_node`` pushes.  Array variant
allocates N contiguous nodes.  Leak checking on destruction mirrors the
reference's leak-checker policy (memory_pool.h:27-33).
"""

from __future__ import annotations

from typing import List, Set

from tpulab_torch.memory.arena import BlockArena
from tpulab_torch.memory.block import MemoryBlock
from tpulab_torch.memory.debugging import (InvalidPointer, OutOfMemory, report_leak)
from tpulab_torch.memory.literals import align_up
from tpulab_torch.memory.memory_type import MemoryType


class MemoryPool:
    """Fixed-node-size pool (reference node_pool / array_pool)."""

    def __init__(self, node_size: int, block_allocator, alignment: int = 8,
                 leak_check: bool = True):
        if node_size <= 0:
            raise ValueError("node_size must be positive")
        self._node_size = align_up(node_size, alignment)
        self._alignment = alignment
        self._arena = (block_allocator if isinstance(block_allocator, BlockArena)
                       else BlockArena(block_allocator, cached=True))
        self._free: List[int] = []
        self._blocks: List[MemoryBlock] = []
        self._live: Set[int] = set()
        self._leak_check = leak_check

    @property
    def memory_type(self) -> MemoryType:
        return self._arena.memory_type

    @property
    def node_size(self) -> int:
        return self._node_size

    @property
    def free_nodes(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        return len(self._free) + len(self._live)

    def _grow(self) -> None:
        block = self._arena.allocate_block()
        self._blocks.append(block)
        addr = align_up(block.addr, self._alignment)
        end = block.addr + block.size
        while addr + self._node_size <= end:
            self._free.append(addr)
            addr += self._node_size

    # RawAllocator concept --------------------------------------------------
    def allocate_node(self, size: int = 0, alignment: int = 0) -> int:
        size = size or self._node_size
        if size > self._node_size:
            raise OutOfMemory("MemoryPool", size,
                              f"(node size is {self._node_size})")
        if not self._free:
            self._grow()
            if not self._free:
                raise OutOfMemory("MemoryPool", size, "(block too small for one node)")
        addr = self._free.pop()
        self._live.add(addr)
        return addr

    def deallocate_node(self, addr: int, size: int = 0, alignment: int = 0) -> None:
        if addr not in self._live:
            raise InvalidPointer(f"0x{addr:x} is not a live node of this pool")
        self._live.remove(addr)
        self._free.append(addr)

    def allocate_array(self, count: int) -> int:
        """N contiguous nodes (reference array_pool).  Scans the free list."""
        if count <= 0:
            raise ValueError("count must be positive")
        if count == 1:
            return self.allocate_node()
        runs = self._find_run(count)
        if runs is None:
            self._grow()
            runs = self._find_run(count)
        if runs is None:
            raise OutOfMemory("MemoryPool", count * self._node_size,
                              f"(no contiguous run of {count} nodes)")
        for a in runs:
            self._free.remove(a)
            self._live.add(a)
        return runs[0]

    def deallocate_array(self, addr: int, count: int) -> None:
        for i in range(count):
            self.deallocate_node(addr + i * self._node_size)

    def _find_run(self, count: int):
        free_sorted = sorted(self._free)
        run = [free_sorted[0]] if free_sorted else []
        for a in free_sorted[1:]:
            if run and a == run[-1] + self._node_size:
                run.append(a)
            else:
                run = [a]
            if len(run) == count:
                return run
        return None

    def close(self) -> None:
        if self._leak_check and self._live:
            report_leak("MemoryPool", len(self._live) * self._node_size)
        self._live.clear()
        self._free.clear()
        for block in self._blocks:
            self._arena.deallocate_block(block)
        self._blocks.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
