"""tpulab_torch.memory — the allocator framework (the port of
``tpulab/memory``).

A device-typed, descriptor-based memory framework with the capability set of
``trtlab/memory`` (reference include/trtlab/memory/*.h, ~12.6k LoC C++):

- compile-time-style memory *kinds* carrying a DLPack device type and alignment
  policy (reference memory_type.h:93-129)
- move-only owning ``Descriptor`` handles that release to their allocator on
  destruction (reference descriptor.h:40-99)
- a type-erased ``IAllocator`` interface + ``make_allocator`` facade adding
  thread safety and tracking (reference allocator.h:41-290)
- raw allocators (mmap/malloc, aligned, transparent huge pages), composable
  block allocators, caching block arenas, a block manager for address->block
  lookup (reference block_allocators.h, block_arena.h, block_manager.h)
- a fixed-node ``MemoryPool`` free-list (reference memory_pool.h:37-295)
- the serving-critical ``TransactionalAllocator`` — rotating ref-counted bump
  stacks for per-request tensor scratch (reference transactional_allocator.h:155-367)
- a best-fit ``BFitAllocator`` for long-lived variable-size allocations such as
  weights (reference bfit_allocator.h:20-123)
- allocation trackers and leak-checking/raii wrappers
  (reference trackers.h, tracking.h, raii_allocator.h)

The framework is device-agnostic over ``MemoryType``: the CUDA layer adds
``CudaMemory`` (device memory held by torch tensors) and ``HostPinnedMemory``
(page-locked staging) in :mod:`tpulab_torch.cuda` without changing any
allocator logic — exactly how the reference layers ``trtlab/cuda`` memory
types onto ``trtlab/memory``.  Every allocator here is Python; tpulab's C++
allocators are not carried (ROADMAP decisions: Python pools only).
"""

from tpulab_torch.memory.literals import KiB, MiB, GiB, bytes_to_string, string_to_bytes
from tpulab_torch.memory.memory_type import (
    MemoryType,
    HostMemory,
    AnyMemory,
    DLDeviceType,
    is_memory_type,
    is_host_accessible,
)
from tpulab_torch.memory.descriptor import Descriptor, IAllocator
from tpulab_torch.memory.raw_allocators import (
    MallocAllocator,
    AlignedAllocator,
    HugePageAllocator,
)
from tpulab_torch.memory.block import (
    MemoryBlock,
    SingleBlockAllocator,
    FixedSizeBlockAllocator,
    GrowingBlockAllocator,
    CountLimitedBlockAllocator,
    SizeLimitedBlockAllocator,
    is_block_allocator,
)
from tpulab_torch.memory.arena import BlockArena, BlockStack, BlockManager
from tpulab_torch.memory.allocator import make_allocator, AllocatorImpl
from tpulab_torch.memory.memory_pool import MemoryPool
from tpulab_torch.memory.transactional import TransactionalAllocator, make_transactional_allocator
from tpulab_torch.memory.bfit import BFitAllocator
from tpulab_torch.memory.trackers import SizeTracker, TrackedBlockAllocator
from tpulab_torch.memory.raii import RaiiAllocator
from tpulab_torch.memory.debugging import (
    set_leak_handler,
    get_leak_handler,
    OutOfMemory,
    BadAllocationSize,
    LeakError,
)

__all__ = [
    "KiB", "MiB", "GiB", "bytes_to_string", "string_to_bytes",
    "MemoryType", "HostMemory", "AnyMemory", "DLDeviceType",
    "is_memory_type", "is_host_accessible",
    "Descriptor", "IAllocator",
    "MallocAllocator", "AlignedAllocator", "HugePageAllocator",
    "MemoryBlock", "SingleBlockAllocator", "FixedSizeBlockAllocator",
    "GrowingBlockAllocator", "CountLimitedBlockAllocator",
    "SizeLimitedBlockAllocator", "is_block_allocator",
    "BlockArena", "BlockStack", "BlockManager",
    "make_allocator", "AllocatorImpl",
    "MemoryPool",
    "TransactionalAllocator", "make_transactional_allocator",
    "BFitAllocator",
    "SizeTracker", "TrackedBlockAllocator",
    "RaiiAllocator",
    "set_leak_handler", "get_leak_handler",
    "OutOfMemory", "BadAllocationSize", "LeakError",
]
