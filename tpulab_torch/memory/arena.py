"""Block arena / stack / manager (reference block_arena.h:47-170,
block_stack.h:25-146, block_manager.h:41-47).

- ``BlockArena``: sits on a block allocator and *caches* freed blocks (cached
  policy) or passes frees straight through (uncached), so hot paths recycle
  device/host blocks without touching the raw allocator.
- ``BlockStack``: LIFO of live blocks with a bump cursor in the top block —
  the building element of per-request buffer stacks.
- ``BlockManager``: address -> block lookup over all registered blocks, used by
  allocators that must answer "which block owns this pointer".
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from tpulab_torch.memory.block import MemoryBlock, is_block_allocator
from tpulab_torch.memory.debugging import InvalidPointer, OutOfMemory
from tpulab_torch.memory.literals import align_up
from tpulab_torch.memory.memory_type import MemoryType


class BlockArena:
    """Caching arena over a block allocator (reference block_arena / block_cache).

    ``cached=True`` keeps deallocated blocks on a free list and serves future
    ``allocate_block`` calls from it (reference cached_arena);
    ``cached=False`` is the pass-through policy (uncached_arena).
    """

    def __init__(self, block_allocator, cached: bool = True):
        if not is_block_allocator(block_allocator):
            raise TypeError(f"{block_allocator!r} is not a block allocator")
        self._inner = block_allocator
        self._cached = cached
        self._cache: List[MemoryBlock] = []
        self._live = 0

    @property
    def memory_type(self) -> MemoryType:
        return self._inner.memory_type

    @property
    def next_block_size(self) -> int:
        return self._inner.next_block_size

    @property
    def cached_blocks(self) -> int:
        return len(self._cache)

    @property
    def live_blocks(self) -> int:
        return self._live

    def allocate_block(self) -> MemoryBlock:
        """Serve from cache if a cached block is big enough for the inner
        allocator's current block size (matters under growing allocators)."""
        self._live += 1
        want = self._inner.next_block_size
        for i in range(len(self._cache) - 1, -1, -1):
            if self._cache[i].size >= want:
                return self._cache.pop(i)
        try:
            return self._inner.allocate_block()
        except Exception:
            self._live -= 1
            raise

    def deallocate_block(self, block: MemoryBlock) -> None:
        self._live -= 1
        if self._cached:
            self._cache.append(block)
        else:
            self._inner.deallocate_block(block)

    def shrink_to_fit(self) -> int:
        """Drop the cache back to the underlying allocator; returns bytes freed."""
        freed = 0
        while self._cache:
            block = self._cache.pop()
            freed += block.size
            self._inner.deallocate_block(block)
        return freed


class BlockStack:
    """LIFO stack of blocks with bump allocation in the top block
    (reference memory_block_stack:25-146).

    ``allocate(size, alignment)`` bumps within the top block, pushing a new
    block from the arena when the top is exhausted.  ``pop()`` releases the top
    block; ``reset()`` releases everything.  This is the carving mechanism for
    per-request binding stacks (reference v1 FixedBuffers).
    """

    def __init__(self, arena):
        self._arena = arena
        self._blocks: List[MemoryBlock] = []
        self._cursors: List[int] = []  # bump offset per block, parallel to _blocks

    @property
    def depth(self) -> int:
        return len(self._blocks)

    @property
    def top(self) -> Optional[MemoryBlock]:
        return self._blocks[-1] if self._blocks else None

    def push(self) -> MemoryBlock:
        block = self._arena.allocate_block()
        self._blocks.append(block)
        self._cursors.append(0)
        return block

    def pop(self) -> None:
        if not self._blocks:
            raise InvalidPointer("pop from empty block stack")
        self._arena.deallocate_block(self._blocks.pop())
        self._cursors.pop()

    def allocate(self, size: int, alignment: int = 8) -> int:
        if size <= 0:
            raise OutOfMemory("BlockStack", size, "(non-positive size)")
        if not self._blocks:
            self.push()
        top = self._blocks[-1]
        start = align_up(top.addr + self._cursors[-1], alignment) - top.addr
        if start + size > top.size:
            if size > self._arena.next_block_size:
                raise OutOfMemory("BlockStack", size,
                                  f"(exceeds block size {self._arena.next_block_size})")
            self.push()
            top = self._blocks[-1]
            start = align_up(top.addr, alignment) - top.addr
            if start + size > top.size:
                raise OutOfMemory("BlockStack", size, "(alignment overflow)")
        self._cursors[-1] = start + size
        return top.addr + start

    def reset(self) -> None:
        while self._blocks:
            self.pop()

    @property
    def available_in_top(self) -> int:
        if not self._blocks:
            return 0
        return self._blocks[-1].size - self._cursors[-1]


class BlockManager:
    """Address -> owning block lookup (reference block_manager.h:41-47)."""

    def __init__(self):
        self._starts: List[int] = []          # sorted block start addrs
        self._blocks: Dict[int, MemoryBlock] = {}

    def add_block(self, block: MemoryBlock) -> None:
        if block.addr in self._blocks:
            raise InvalidPointer(f"block at 0x{block.addr:x} already registered")
        bisect.insort(self._starts, block.addr)
        self._blocks[block.addr] = block

    def drop_block(self, addr: int) -> MemoryBlock:
        block = self._blocks.pop(addr, None)
        if block is None:
            raise InvalidPointer(f"no block registered at 0x{addr:x}")
        self._starts.remove(addr)
        return block

    def find_block(self, addr: int) -> Optional[MemoryBlock]:
        """The block containing ``addr``, if any."""
        i = bisect.bisect_right(self._starts, addr) - 1
        if i < 0:
            return None
        block = self._blocks[self._starts[i]]
        return block if block.contains(addr) else None

    def owns(self, addr: int) -> bool:
        return self.find_block(addr) is not None

    @property
    def size(self) -> int:
        return len(self._blocks)

    def blocks(self) -> List[MemoryBlock]:
        return [self._blocks[a] for a in self._starts]
