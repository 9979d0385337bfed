"""Memory blocks + composable block allocators.

Mirrors reference block_allocators.h:25-120+ and memory_block.h:19-104: a
*block allocator* produces fixed or growing ``MemoryBlock``s from a raw
allocator, and compositions bound the count or total size.  Block allocators
feed arenas (:mod:`tpulab_torch.memory.arena`), pools, and the transactional
allocator.

The block layer is fully device-agnostic: a block allocator over the CUDA raw
allocator (:mod:`tpulab_torch.cuda.allocators`) yields device blocks the same
way a malloc-based one yields host blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from tpulab_torch.memory.debugging import OutOfMemory
from tpulab_torch.memory.memory_type import MemoryType


@dataclass
class MemoryBlock:
    """{addr, size} span produced by a block allocator (reference memory_block.h)."""

    addr: int
    size: int
    #: opaque backing object for device blocks (e.g. a torch.Tensor)
    handle: Any = None

    def contains(self, addr: int) -> bool:
        return self.addr <= addr < self.addr + self.size

    @property
    def end(self) -> int:
        return self.addr + self.size


def is_block_allocator(obj: object) -> bool:
    """Reference ``is_block_allocator`` trait: allocate_block/deallocate_block."""
    return callable(getattr(obj, "allocate_block", None)) and callable(
        getattr(obj, "deallocate_block", None))


class _BlockAllocatorBase:
    def __init__(self, raw_allocator, block_size: int, alignment: int = 0):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self._raw = raw_allocator
        self._block_size = block_size
        self._alignment = alignment or raw_allocator.memory_type.access_alignment

    @property
    def memory_type(self) -> MemoryType:
        return self._raw.memory_type

    @property
    def next_block_size(self) -> int:
        return self._block_size

    @property
    def raw_allocator(self):
        return self._raw

    def _make_block(self, size: int) -> MemoryBlock:
        addr = self._raw.allocate_node(size, self._alignment)
        return MemoryBlock(addr, size)

    def deallocate_block(self, block: MemoryBlock) -> None:
        self._raw.deallocate_node(block.addr, block.size, self._alignment)


class SingleBlockAllocator(_BlockAllocatorBase):
    """Hands out exactly one block, ever (reference single_block_allocator)."""

    def __init__(self, raw_allocator, block_size: int, alignment: int = 0):
        super().__init__(raw_allocator, block_size, alignment)
        self._used = False

    def allocate_block(self) -> MemoryBlock:
        if self._used:
            raise OutOfMemory(type(self).__name__, self._block_size,
                              "(single block already allocated)")
        self._used = True
        return self._make_block(self._block_size)

    def deallocate_block(self, block: MemoryBlock) -> None:
        super().deallocate_block(block)
        self._used = False


class FixedSizeBlockAllocator(_BlockAllocatorBase):
    """Unbounded supply of same-size blocks (reference fixed_size_block_allocator)."""

    def allocate_block(self) -> MemoryBlock:
        return self._make_block(self._block_size)


class GrowingBlockAllocator(_BlockAllocatorBase):
    """Each block is ``growth_factor``x the previous (reference growing_block_allocator)."""

    def __init__(self, raw_allocator, block_size: int, growth_factor: float = 2.0,
                 alignment: int = 0):
        super().__init__(raw_allocator, block_size, alignment)
        if growth_factor < 1.0:
            raise ValueError("growth_factor must be >= 1")
        self._growth = growth_factor

    def allocate_block(self) -> MemoryBlock:
        block = self._make_block(self._block_size)
        self._block_size = int(self._block_size * self._growth)
        return block


class CountLimitedBlockAllocator:
    """Caps the number of live blocks (reference count-limited composition)."""

    def __init__(self, inner, max_blocks: int):
        self._inner = inner
        self._max = max_blocks
        self._live = 0

    @property
    def memory_type(self) -> MemoryType:
        return self._inner.memory_type

    @property
    def next_block_size(self) -> int:
        return self._inner.next_block_size

    @property
    def block_count(self) -> int:
        return self._live

    def allocate_block(self) -> MemoryBlock:
        if self._live >= self._max:
            raise OutOfMemory(type(self).__name__, self._inner.next_block_size,
                              f"(block count limit {self._max} reached)")
        block = self._inner.allocate_block()
        self._live += 1
        return block

    def deallocate_block(self, block: MemoryBlock) -> None:
        self._inner.deallocate_block(block)
        self._live -= 1


class SizeLimitedBlockAllocator:
    """Caps the total bytes of live blocks (reference size-limited composition)."""

    def __init__(self, inner, max_bytes: int):
        self._inner = inner
        self._max = max_bytes
        self._bytes = 0

    @property
    def memory_type(self) -> MemoryType:
        return self._inner.memory_type

    @property
    def next_block_size(self) -> int:
        return self._inner.next_block_size

    @property
    def allocated_bytes(self) -> int:
        return self._bytes

    def allocate_block(self) -> MemoryBlock:
        size = self._inner.next_block_size
        if self._bytes + size > self._max:
            raise OutOfMemory(type(self).__name__, size,
                              f"(size limit {self._max} bytes reached, {self._bytes} in use)")
        block = self._inner.allocate_block()
        self._bytes += block.size
        return block

    def deallocate_block(self, block: MemoryBlock) -> None:
        self._inner.deallocate_block(block)
        self._bytes -= block.size
