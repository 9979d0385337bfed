"""Transactional allocator — rotating ref-counted bump stacks.

The serving-critical allocator (reference transactional_allocator.h:155-367):
per-request tensor scratch is bump-allocated in O(1) from the current stack
(reference allocate_node:207-234); when a stack can't satisfy a request the
allocator *rotates* to a fresh stack from the arena (rotate:222-227); each
allocation holds a reference on its stack and the whole stack is returned to
the arena when its last allocation drops (release_stack:305-316).  Allocation
is O(1), deallocation is O(1), and freed memory returns in whole blocks —
ideal for the per-request descriptor churn of an inference service.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from tpulab_torch.memory.arena import BlockArena
from tpulab_torch.memory.block import MemoryBlock
from tpulab_torch.memory.debugging import BadAllocationSize, InvalidPointer, OutOfMemory
from tpulab_torch.memory.descriptor import Descriptor, host_view
from tpulab_torch.memory.literals import align_up
from tpulab_torch.memory.memory_type import MemoryType


class _RefCountedStack:
    """One bump stack over one arena block (reference ref_counted_stack)."""

    __slots__ = ("block", "cursor", "refs", "retired")

    def __init__(self, block: MemoryBlock):
        self.block = block
        self.cursor = 0
        self.refs = 0
        self.retired = False

    def try_allocate(self, size: int, alignment: int) -> Optional[int]:
        start = align_up(self.block.addr + self.cursor, alignment) - self.block.addr
        if start + size > self.block.size:
            return None
        self.cursor = start + size
        self.refs += 1
        return self.block.addr + start

    @property
    def available(self) -> int:
        return self.block.size - self.cursor


class TransactionalAllocator:
    """Rotating ref-counted stack allocator
    (reference transactional_allocator.h:155-367).

    RawAllocator concept over any block arena; also usable directly as an
    IAllocator-style descriptor factory via :meth:`allocate_descriptor`.
    """

    is_stateful = True

    def __init__(self, block_allocator, max_stacks: int = 0):
        self._arena = (block_allocator if isinstance(block_allocator, BlockArena)
                       else BlockArena(block_allocator, cached=True))
        self._lock = threading.Lock()
        self._current: Optional[_RefCountedStack] = None
        #: addr -> owning stack, for deallocate lookups
        self._by_addr: Dict[int, _RefCountedStack] = {}
        self._stacks: List[_RefCountedStack] = []
        self._max_stacks = max_stacks  # 0 = unbounded (arena may still bound)

    @property
    def memory_type(self) -> MemoryType:
        return self._arena.memory_type

    @property
    def live_stacks(self) -> int:
        return len(self._stacks)

    def max_node_size(self) -> int:
        return self._arena.next_block_size

    # -- internals ----------------------------------------------------------
    def _rotate(self) -> _RefCountedStack:
        """Retire the current stack and pull a fresh block (reference rotate:222-227)."""
        if self._current is not None:
            self._current.retired = True
            if self._current.refs == 0:
                self._release_stack(self._current)
        if self._max_stacks and len(self._stacks) >= self._max_stacks:
            raise OutOfMemory("TransactionalAllocator", self._arena.next_block_size,
                              f"(stack limit {self._max_stacks} reached; "
                              f"{len(self._stacks)} stacks still referenced)")
        block = self._arena.allocate_block()
        stack = _RefCountedStack(block)
        self._stacks.append(stack)
        self._current = stack
        return stack

    def _release_stack(self, stack: _RefCountedStack) -> None:
        """Return a drained stack's block to the arena (reference drop:305-316)."""
        self._stacks.remove(stack)
        self._arena.deallocate_block(stack.block)
        if self._current is stack:
            self._current = None

    # -- RawAllocator concept ----------------------------------------------
    def allocate_node(self, size: int, alignment: int = 8) -> int:
        if size <= 0:
            raise BadAllocationSize("TransactionalAllocator", size, self._arena.next_block_size)
        if size > self._arena.next_block_size:
            raise BadAllocationSize("TransactionalAllocator", size,
                                    self._arena.next_block_size)
        with self._lock:
            stack = self._current
            addr = stack.try_allocate(size, alignment) if stack and not stack.retired else None
            if addr is None:
                stack = self._rotate()
                addr = stack.try_allocate(size, alignment)
                if addr is None:
                    raise BadAllocationSize("TransactionalAllocator", size,
                                            stack.block.size)
            self._by_addr[addr] = stack
            return addr

    def deallocate_node(self, addr: int, size: int = 0, alignment: int = 0) -> None:
        with self._lock:
            stack = self._by_addr.pop(addr, None)
            if stack is None:
                raise InvalidPointer(f"0x{addr:x} was not allocated here")
            stack.refs -= 1
            # A stack frees only once retired (rotation happened) and drained.
            if stack.refs == 0 and (stack.retired or stack is not self._current):
                if stack is self._current:
                    self._current = None
                self._release_stack(stack)

    # -- descriptor convenience --------------------------------------------
    def allocate_descriptor(self, size: int, alignment: int = 8) -> Descriptor:
        addr = self.allocate_node(size, alignment)
        return Descriptor(addr, size, None, alignment=alignment,
                          on_release=lambda a, s: self.deallocate_node(a, s))

    def view(self, addr: int, size: int):
        return host_view(addr, size)

    def shrink_to_fit(self) -> int:
        with self._lock:
            return self._arena.shrink_to_fit()


def make_transactional_allocator(block_allocator) -> TransactionalAllocator:
    """Reference ``make_transactional_allocator``."""
    return TransactionalAllocator(block_allocator)
