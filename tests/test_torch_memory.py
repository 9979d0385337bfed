"""The port's memory framework (``tpulab_torch.memory``) held against
tpulab's (``tpulab.memory``) on the same operations.

Every case of ``tests/test_memory.py`` is a scenario here, run on both
packages: its assertions hold for each, and the two traces it records
must be equal.  Addresses differ between the packages, so a trace holds
offsets from a block's base, sizes, counts, exception class names and
leak reports, never an address.
"""

import gc
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest

import tpulab.memory as jm
import tpulab.memory.block as jm_block
import tpulab.memory.raw_allocators as jm_raw
import tpulab.memory.shm as jm_shm
import tpulab_torch.memory as tm
import tpulab_torch.memory.block as tm_block
import tpulab_torch.memory.raw_allocators as tm_raw
import tpulab_torch.memory.shm as tm_shm

ROOT = Path(__file__).resolve().parents[1]


def _pkg(mem, block, raw, shm, name):
    ns = types.SimpleNamespace(**{k: getattr(mem, k) for k in mem.__all__})
    ns.MemoryBlock = block.MemoryBlock
    ns.FirstTouchAllocator = raw.FirstTouchAllocator
    ns.SharedMemoryAllocator = shm.SharedMemoryAllocator
    ns.name = name
    return ns


PKGS = {"tpulab": _pkg(jm, jm_block, jm_raw, jm_shm, "tpulab.memory"),
        "port": _pkg(tm, tm_block, tm_raw, tm_shm, "tpulab_torch.memory")}


def _raises(fn):
    """The class name of what ``fn()`` raises (None when it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is the observation
        return type(e).__name__
    return None


# --------------------------------------------------------------- scenarios --
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def literals(m, out):
    assert m.KiB == 1024 and m.MiB == 1024 ** 2 and m.GiB == 1024 ** 3
    out += [m.KiB, m.MiB, m.GiB]


@scenario
def string_to_bytes(m, out):
    for s in ("10MiB", "1.5KiB", "2gb", "128", 4096, "7 B", "3 tib"):
        out.append(m.string_to_bytes(s))
    assert out[:6] == [10 * m.MiB, 1536, 2 * 10 ** 9, 128, 4096, 7]
    out.append(_raises(lambda: m.string_to_bytes("ten megs")))
    out.append(_raises(lambda: m.string_to_bytes("4 parsecs")))
    assert out[-2:] == ["ValueError", "ValueError"]


@scenario
def bytes_to_string(m, out):
    out += [m.bytes_to_string(n) for n in (512, 10 * m.MiB, 1536, 3 << 40)]
    assert out[:2] == ["512 B", "10.00 MiB"]


@scenario
def memory_type_traits(m, out):
    assert m.is_memory_type(m.HostMemory) and not m.is_memory_type(object())
    assert m.is_host_accessible(m.HostMemory)
    out += [m.HostMemory.min_allocation_alignment, m.HostMemory.name,
            int(m.HostMemory.device_type), m.AnyMemory.access_alignment,
            sorted((d.name, int(d)) for d in m.DLDeviceType)]


@scenario
def raw_allocator_concept(m, out):
    raw = m.MallocAllocator()
    assert raw.memory_type is m.HostMemory
    addr = raw.allocate_node(128, 64)
    out += [addr % 64, raw.live_allocations]
    raw.deallocate_node(addr, 128, 64)
    out.append(raw.live_allocations)
    out.append(_raises(lambda: raw.allocate_node(0)))
    assert out == [0, 1, 0, "OutOfMemory"]


@scenario
def aligned_allocator(m, out):
    raw = m.AlignedAllocator(4096)
    addr = raw.allocate_node(100)
    out.append(addr % 4096)
    raw.deallocate_node(addr, 100)
    out.append(_raises(lambda: m.AlignedAllocator(48)))
    big = m.AlignedAllocator(1 << 16)
    addr = big.allocate_node(10)
    out.append(addr % (1 << 16))
    big.deallocate_node(addr, 10)
    assert out == [0, "ValueError", 0]


@scenario
def huge_page_allocator(m, out):
    raw = m.HugePageAllocator()
    addr = raw.allocate_node(100)
    out += [addr % m.HugePageAllocator.HUGE_PAGE_SIZE,
            m.HugePageAllocator.HUGE_PAGE_SIZE]
    raw.deallocate_node(addr, 100)
    assert out[0] == 0


@scenario
def first_touch_allocator(m, out):
    raw = m.FirstTouchAllocator(fill=0)
    addr = raw.allocate_node(4096)
    out.append(bytes(raw.view(addr, 4096)[:16]))
    raw.deallocate_node(addr, 4096)
    filled = m.FirstTouchAllocator(fill=7)
    addr = filled.allocate_node(4096)
    out.append(bytes(filled.view(addr, 4096)[4090:4096]))
    filled.deallocate_node(addr, 4096)
    assert out[0] == b"\x00" * 16


@scenario
def invalid_free_raises(m, out):
    raw = m.MallocAllocator()
    out.append(_raises(lambda: raw.deallocate_node(0xdead, 8)))
    assert out == ["InvalidPointer"]


@scenario
def single_block_allocator(m, out):
    raw = m.MallocAllocator()
    ba = m.SingleBlockAllocator(raw, 4096)
    assert m.is_block_allocator(ba)
    b = ba.allocate_block()
    out += [b.size, _raises(ba.allocate_block)]
    ba.deallocate_block(b)
    b2 = ba.allocate_block()
    out.append(b2.size)
    ba.deallocate_block(b2)
    out.append(raw.live_allocations)
    assert out == [4096, "OutOfMemory", 4096, 0]


@scenario
def fixed_size_block_allocator(m, out):
    raw = m.MallocAllocator()
    ba = m.FixedSizeBlockAllocator(raw, 1024)
    blocks = [ba.allocate_block() for _ in range(4)]
    out += [b.size for b in blocks] + [raw.live_allocations]
    for b in blocks:
        ba.deallocate_block(b)
    out.append(raw.live_allocations)
    out.append(_raises(lambda: m.FixedSizeBlockAllocator(raw, 0)))
    assert out == [1024] * 4 + [4, 0, "ValueError"]


@scenario
def growing_block_allocator(m, out):
    ba = m.GrowingBlockAllocator(m.MallocAllocator(), 1024, growth_factor=2.0)
    blocks = [ba.allocate_block() for _ in range(3)]
    out += [b.size for b in blocks] + [ba.next_block_size]
    for b in blocks:
        ba.deallocate_block(b)
    out.append(_raises(lambda: m.GrowingBlockAllocator(
        m.MallocAllocator(), 1024, growth_factor=0.5)))
    assert out[:3] == [1024, 2048, 4096]


@scenario
def count_limited_block_allocator(m, out):
    ba = m.CountLimitedBlockAllocator(
        m.FixedSizeBlockAllocator(m.MallocAllocator(), 1024), max_blocks=2)
    b1, b2 = ba.allocate_block(), ba.allocate_block()
    out += [ba.block_count, _raises(ba.allocate_block)]
    ba.deallocate_block(b1)
    b3 = ba.allocate_block()
    ba.deallocate_block(b2)
    ba.deallocate_block(b3)
    out.append(ba.block_count)
    assert out == [2, "OutOfMemory", 0]


@scenario
def size_limited_block_allocator(m, out):
    ba = m.SizeLimitedBlockAllocator(
        m.FixedSizeBlockAllocator(m.MallocAllocator(), 1024), max_bytes=2048)
    b1, b2 = ba.allocate_block(), ba.allocate_block()
    out += [_raises(ba.allocate_block), ba.allocated_bytes]
    ba.deallocate_block(b1)
    ba.deallocate_block(b2)
    out.append(ba.allocated_bytes)
    assert out == ["OutOfMemory", 2048, 0]


@scenario
def descriptor_lifecycle(m, out):
    alloc = m.make_allocator(m.MallocAllocator())
    d = alloc.allocate_descriptor(256, 64)
    out += [d.size, d.addr % 64, d.alignment, d.memory_type.name]
    view = d.memoryview()
    view[:4] = b"abcd"
    out.append(d.numpy(np.uint8)[:4].tobytes())
    d.release()
    out.append(_raises(lambda: d.addr))
    d.release()                                  # idempotent
    assert out[-2:] == [b"abcd", "InvalidPointer"]


@scenario
def descriptor_context_manager_and_gc(m, out):
    raw = m.MallocAllocator()
    alloc = m.make_allocator(raw)
    with alloc.allocate_descriptor(64) as d:
        out.append(len(d))
    out.append(raw.live_allocations)
    d2 = alloc.allocate_descriptor(64)
    out.append(raw.live_allocations)
    del d2
    gc.collect()
    out.append(raw.live_allocations)
    assert out == [64, 0, 1, 0]


@scenario
def descriptor_numpy_shape(m, out):
    alloc = m.make_allocator(m.MallocAllocator())
    with alloc.allocate_descriptor(4 * 6) as d:
        arr = d.numpy(np.float32, (2, 3))
        arr[:] = 7.0
        out.append(float(d.numpy(np.float32, (6,)).sum()))
        out.append(d.numpy(np.int16).shape)
    assert out[0] == pytest.approx(42.0)


@scenario
def shared_descriptor_refcount(m, out):
    raw = m.MallocAllocator()
    alloc = m.make_allocator(raw)
    d = alloc.allocate_descriptor(64)
    s = d.share()
    s2 = s.ref()
    out.append(s2.size)                          # forwarded attribute
    s.unref()
    out.append(raw.live_allocations)
    s2.unref()
    out.append(raw.live_allocations)
    assert out == [64, 1, 0]


@scenario
def cached_arena_recycles_blocks(m, out):
    raw = m.MallocAllocator()
    arena = m.BlockArena(m.FixedSizeBlockAllocator(raw, 4096), cached=True)
    b = arena.allocate_block()
    arena.deallocate_block(b)
    out.append(arena.cached_blocks)
    b2 = arena.allocate_block()
    out += [b2.addr == b.addr, arena.live_blocks]
    arena.deallocate_block(b2)
    out.append(raw.live_allocations)
    out.append(arena.shrink_to_fit())
    out.append(raw.live_allocations)
    out.append(_raises(lambda: m.BlockArena(raw)))
    assert out == [1, True, 1, 1, 4096, 0, "TypeError"]


@scenario
def uncached_arena_passes_through(m, out):
    raw = m.MallocAllocator()
    arena = m.BlockArena(m.FixedSizeBlockAllocator(raw, 4096), cached=False)
    b = arena.allocate_block()
    arena.deallocate_block(b)
    out += [arena.cached_blocks, raw.live_allocations]
    assert out == [0, 0]


@scenario
def block_stack_carving(m, out):
    arena = m.BlockArena(m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096))
    stack = m.BlockStack(arena)
    a1 = stack.allocate(1000, 256)
    base = stack.top.addr
    a2 = stack.allocate(1000, 256)
    out += [a1 - base, a2 - base, stack.depth, stack.available_in_top]
    a3 = stack.allocate(3000, 256)               # forces a second block
    out += [a3 - stack.top.addr, stack.depth, stack.available_in_top]
    stack.reset()
    out += [stack.depth, arena.cached_blocks, stack.available_in_top]
    assert out[2] == 1 and out[5] == 2 and out[7] == 0


@scenario
def block_stack_oversize_rejected(m, out):
    arena = m.BlockArena(m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096))
    stack = m.BlockStack(arena)
    out += [_raises(lambda: stack.allocate(8192)),
            _raises(lambda: stack.allocate(0)), _raises(stack.pop)]
    assert out[0] == "OutOfMemory"


@scenario
def block_manager_lookup(m, out):
    mgr = m.BlockManager()
    mgr.add_block(m.MemoryBlock(0x1000, 0x100))
    mgr.add_block(m.MemoryBlock(0x3000, 0x100))
    out += [mgr.find_block(0x1080).addr, mgr.find_block(0x2000),
            mgr.owns(0x30ff), mgr.owns(0x3100), mgr.find_block(0x10),
            _raises(lambda: mgr.add_block(m.MemoryBlock(0x1000, 8)))]
    mgr.drop_block(0x1000)
    out += [mgr.find_block(0x1080), mgr.size,
            [b.addr for b in mgr.blocks()],
            _raises(lambda: mgr.drop_block(0x1000))]
    assert out[:4] == [0x1000, None, True, False]


@scenario
def transactional_bump_and_rotate(m, out):
    arena = m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096)
    t = m.make_transactional_allocator(arena)
    a1 = t.allocate_node(1024)
    a2 = t.allocate_node(1024)
    out.append(a2 - a1)
    a3 = t.allocate_node(3000)                  # forces rotation
    out.append(t.live_stacks)
    t.deallocate_node(a1)
    t.deallocate_node(a2)
    out.append(t.live_stacks)
    t.deallocate_node(a3)
    out += [t.live_stacks, t.max_node_size()]
    assert out[:3] == [1024, 2, 1]


@scenario
def transactional_whole_stack_release(m, out):
    raw = m.MallocAllocator()
    t = m.TransactionalAllocator(m.FixedSizeBlockAllocator(raw, 4096))
    addrs = [t.allocate_node(512) for _ in range(8)]
    out += [a - addrs[0] for a in addrs] + [t.live_stacks]
    for a in addrs[:-1]:
        t.deallocate_node(a)
    out.append(t.live_stacks)
    t.allocate_node(4096)
    t.deallocate_node(addrs[-1])
    out += [t.live_stacks, raw.live_allocations]
    assert out[-3:-1] == [1, 1]


@scenario
def transactional_oversize(m, out):
    t = m.TransactionalAllocator(
        m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096))
    out += [_raises(lambda: t.allocate_node(8192)),
            _raises(lambda: t.deallocate_node(0x10))]
    assert out == ["BadAllocationSize", "InvalidPointer"]


@scenario
def transactional_descriptors(m, out):
    t = m.TransactionalAllocator(
        m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096))
    with t.allocate_descriptor(256) as d:
        d.memoryview()[:3] = b"tpu"
        out += [d.size, bytes(d.memoryview()[:3])]
    out.append(t.live_stacks)
    out.append(t.shrink_to_fit())
    assert out[2] == 1


@scenario
def transactional_thread_safety(m, out):
    t = m.TransactionalAllocator(
        m.FixedSizeBlockAllocator(m.MallocAllocator(), 1 << 16))
    errors = []

    def worker():
        try:
            for _ in range(200):
                a = t.allocate_node(64)
                t.deallocate_node(a)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    [th.start() for th in threads]
    [th.join() for th in threads]
    out += [len(errors), t.live_stacks <= 1]
    assert out == [0, True]


@scenario
def memory_pool_basics(m, out):
    pool = m.MemoryPool(256, m.FixedSizeBlockAllocator(m.MallocAllocator(),
                                                       4096))
    a = pool.allocate_node()
    b = pool.allocate_node()
    out += [a != b, pool.node_size, pool.capacity, pool.free_nodes]
    pool.deallocate_node(a)
    c = pool.allocate_node()
    out.append(c == a)                           # LIFO free list
    out += [_raises(lambda: pool.allocate_node(512)),
            _raises(lambda: pool.deallocate_node(0x10))]
    pool.deallocate_node(b)
    pool.deallocate_node(c)
    pool.close()
    assert out[0] and out[4]


@scenario
def memory_pool_array(m, out):
    pool = m.MemoryPool(256, m.FixedSizeBlockAllocator(m.MallocAllocator(),
                                                       4096))
    addr = pool.allocate_array(4)
    out.append(pool.free_nodes)
    pool.deallocate_array(addr, 4)
    out += [pool.free_nodes, _raises(lambda: pool.allocate_array(0)),
            _raises(lambda: pool.allocate_array(64))]
    pool.close()


@scenario
def memory_pool_leak_report(m, out):
    leaks = []
    old = m.set_leak_handler(lambda name, n: leaks.append((name, n)))
    try:
        pool = m.MemoryPool(256, m.FixedSizeBlockAllocator(
            m.MallocAllocator(), 4096))
        pool.allocate_node()
        pool.close()
    finally:
        m.set_leak_handler(old)
    out += leaks
    assert leaks and leaks[0][1] == 256


@scenario
def bfit_best_fit_and_coalesce(m, out):
    bf = m.BFitAllocator(m.FixedSizeBlockAllocator(m.MallocAllocator(),
                                                   1 << 16))
    a = bf.allocate_node(1000)
    b = bf.allocate_node(2000)
    c = bf.allocate_node(500)
    out += [b - a, c - a, bf.live_allocations]
    bf.deallocate_node(b)
    d = bf.allocate_node(1500)
    out.append(d - a)
    for x in (a, c, d):
        bf.deallocate_node(x)
    out += [bf.free_bytes, len(bf._free_by_addr)]
    assert out[3] == out[0] and out[-2:] == [1 << 16, 1]


@scenario
def bfit_alignment(m, out):
    bf = m.BFitAllocator(m.FixedSizeBlockAllocator(m.MallocAllocator(),
                                                   1 << 16))
    a = bf.allocate_node(100, alignment=4096)
    out += [a % 4096, len(bf._free_by_addr)]
    bf.deallocate_node(a)
    out += [bf.free_bytes, _raises(lambda: bf.deallocate_node(a))]
    assert out[0] == 0


@scenario
def bfit_no_grow_exhaustion(m, out):
    bf = m.BFitAllocator(
        m.SingleBlockAllocator(m.MallocAllocator(), 4096), grow_on_demand=True)
    a = bf.allocate_node(4096)
    out.append(_raises(lambda: bf.allocate_node(1)))
    bf.deallocate_node(a)
    still = m.BFitAllocator(m.FixedSizeBlockAllocator(m.MallocAllocator(),
                                                      4096),
                            grow_on_demand=False)
    out.append(_raises(lambda: still.allocate_node(16)))
    assert out == ["OutOfMemory", "OutOfMemory"]


@scenario
def size_tracker(m, out):
    raw = m.SizeTracker(m.MallocAllocator())
    alloc = m.make_allocator(raw)
    d1 = alloc.allocate_descriptor(1000)
    d2 = alloc.allocate_descriptor(500)
    out += [raw.bytes_in_use, raw.peak_bytes]
    d1.release()
    out.append(raw.bytes_in_use)
    d2.release()
    out += [raw.bytes_in_use, raw.total_allocations, raw.total_bytes,
            raw.max_node_size()]
    assert out[:5] == [1500, 1500, 500, 0, 2]


@scenario
def tracked_block_allocator(m, out):
    events = []
    ba = m.TrackedBlockAllocator(
        m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096),
        on_allocate=lambda b: events.append(("+", b.size)),
        on_deallocate=lambda b: events.append(("-", b.size)))
    b = ba.allocate_block()
    ba.deallocate_block(b)
    out += events + [ba.bytes_in_use, ba.blocks_allocated,
                     ba.blocks_deallocated]
    assert events == [("+", 4096), ("-", 4096)] and ba.bytes_in_use == 0


@scenario
def make_allocator_is_idempotent(m, out):
    alloc = m.make_allocator(m.MallocAllocator())
    out += [m.make_allocator(alloc) is alloc,
            _raises(lambda: m.AllocatorImpl(object()))]
    assert out == [True, "TypeError"]


@scenario
def iallocator_device_context(m, out):
    alloc = m.make_allocator(m.MallocAllocator())
    dev_type, dev_id = alloc.device_context()
    out += [int(dev_type), dev_id, alloc.max_alignment()]
    assert out[:2] == [1, 0]


@scenario
def raii_allocator_reclaims(m, out):
    raw = m.MallocAllocator()
    leaks = []
    old = m.set_leak_handler(lambda name, n: leaks.append((name, n)))
    try:
        with m.RaiiAllocator(m.make_allocator(raw)) as ra:
            a = ra.allocate(128)
            ra.allocate(128)
            ra.allocate(64)
            ra.deallocate(a, 128)
            out.append(ra.live_allocations)
        out.append(raw.live_allocations)
    finally:
        m.set_leak_handler(old)
    out += leaks
    assert out == [2, 0, ("raii", 192)]


@scenario
def block_stack_pop_preserves_lower_cursor(m, out):
    arena = m.BlockArena(m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096))
    stack = m.BlockStack(arena)
    a1 = stack.allocate(1000)
    base = stack.top.addr
    stack.allocate(3500)                         # pushes block B
    stack.pop()                                  # drops B
    a2 = stack.allocate(100)
    out += [a1 - base, a2 - base]
    stack.reset()
    assert out[1] >= out[0] + 1000


@scenario
def transactional_max_stacks_enforced(m, out):
    t = m.TransactionalAllocator(
        m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096), max_stacks=2)
    held = [t.allocate_node(4096), t.allocate_node(4096)]
    out.append(_raises(lambda: t.allocate_node(4096)))
    for a in held:
        t.deallocate_node(a)
    out.append(t.live_stacks)
    assert out[0] == "OutOfMemory"


@scenario
def transactional_rejects_zero_size(m, out):
    t = m.TransactionalAllocator(
        m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096))
    out += [_raises(lambda: t.allocate_node(0)),
            _raises(lambda: t.allocate_node(-8))]
    assert out == ["BadAllocationSize", "BadAllocationSize"]


@scenario
def cached_arena_respects_growing_block_size(m, out):
    raw = m.MallocAllocator()
    arena = m.BlockArena(m.GrowingBlockAllocator(raw, 4096, growth_factor=2.0),
                         cached=True)
    b1 = arena.allocate_block()                  # 4096; next is 8192
    arena.deallocate_block(b1)
    b2 = arena.allocate_block()                  # needs >= 8192 now
    out += [b1.size, b2.size, arena.cached_blocks]
    arena.deallocate_block(b2)
    out.append(arena.shrink_to_fit())
    out.append(raw.live_allocations)
    assert out[1] >= 8192 and out[-1] == 0


@scenario
def bfit_single_grow_satisfies(m, out):
    bf = m.BFitAllocator(m.FixedSizeBlockAllocator(m.MallocAllocator(), 4096))
    a = bf.allocate_node(4096)                   # grows once, satisfied
    b = bf.allocate_node(4096)                   # grows again, satisfied
    out += [bf.live_allocations, bf.free_bytes]
    bf.deallocate_node(a)
    bf.deallocate_node(b)
    out.append(bf.free_bytes)


@scenario
def detach_after_release_raises(m, out):
    raw = m.MallocAllocator()
    alloc = m.make_allocator(raw)
    d = alloc.allocate_descriptor(64)
    d.release()
    out.append(_raises(d.detach))
    kept = alloc.allocate_descriptor(64)
    addr, size = kept.detach()
    del kept
    gc.collect()
    out += [size, raw.live_allocations]          # detached: not freed
    raw.deallocate_node(addr, size)
    assert out == ["InvalidPointer", 64, 1]


@scenario
def leak_handler_swaps_and_errors(m, out):
    first = m.get_leak_handler()
    seen = []
    old = m.set_leak_handler(lambda name, n: seen.append(n))
    out.append(old is first)
    m.set_leak_handler(None)                     # back to the default
    out.append(m.get_leak_handler() is first)
    err = m.OutOfMemory("A", 12, "(detail)")
    bad = m.BadAllocationSize("B", 9, 8)
    out += [str(err), err.size, str(bad), bad.supported,
            issubclass(m.LeakError, Exception)]


@scenario
def shared_memory_attach_and_descriptors(m, out):
    alloc_raw = m.SharedMemoryAllocator()
    alloc = m.make_allocator(alloc_raw)
    d = alloc.allocate_descriptor(1024)
    out.append(d.memory_type.name)
    arr = d.numpy(np.float32, (256,))
    arr[:] = 2.5
    with m.SharedMemoryAllocator.attach(alloc_raw.segment_name(d.addr)) as seg:
        peer = seg.numpy(np.float32, (256,))
        out += [float(peer.sum()), seg.size >= 1024]
    d.release()
    out.append(_raises(lambda: alloc_raw.deallocate_node(0x1234)))
    alloc_raw.close()
    assert out[1:] == [640.0, True, "InvalidPointer"]


def _trace(pkg, name):
    out = []
    SCENARIOS[name](PKGS[pkg], out)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_matches_tpulab(name):
    """Each scenario's assertions hold in both packages and their traces
    are equal."""
    assert _trace("port", name) == _trace("tpulab", name)


@pytest.mark.parametrize("pkg", ["tpulab", "port"])
def test_shared_memory_cross_process(pkg):
    """A producer process fills a named segment; the owner reads it
    zero-copy (reference SysV shm ingress, examples/02 server.cc:110-137);
    both packages' segments, attached by the same package in the peer."""
    shm = PKGS[pkg].SharedMemoryAllocator
    alloc = shm()
    addr = alloc.allocate_node(4096)
    name = alloc.segment_name(addr)
    mod = PKGS[pkg].name + ".shm"
    code = (f"from {mod} import SharedMemoryAllocator;"
            f"seg = SharedMemoryAllocator.attach('{name}');"
            "seg.numpy()[:8] = list(range(8)); seg.close()")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60,
                   cwd=ROOT)
    assert bytes(alloc.view(addr, 4096)[:8]) == bytes(range(8))
    alloc.deallocate_node(addr)


def test_public_surface_matches_tpulab():
    """``tpulab_torch.memory`` exports tpulab.memory's names, no rename."""
    assert tm.__all__ == jm.__all__
    assert set(PKGS["port"].__dict__) == set(PKGS["tpulab"].__dict__)
