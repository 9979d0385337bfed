"""Tracked allocators: device memory (the port's counterpart of
``tpulab/tpu/allocators.py``'s ``TpuRawAllocator``) and host memory (of
``tpulab/memory``'s ``MallocAllocator`` behind ``make_allocator``, as the
host KV tier uses it).

The KV page store is a block owned by :class:`DeviceRawAllocator`, and so
is a compiled model's weight tree (``allocate_tree``, one block for the
whole tree, as tpulab's weight capture):
``allocate_array`` hands out a zeroed tensor under a synthetic address,
every live byte is counted (``bytes_in_use`` is the gauge), and
``replace`` swaps a block's tensor for its successor when the pool grows
or shrinks — so ``PagedKVPool.hbm_bytes`` reads the allocator's count
exactly as it does in tpulab.  It also satisfies the framework's
RawAllocator concept (``allocate_node`` hands out a zeroed uint8 block,
``deallocate_node``, ``memory_type = CudaMemory``), so the block arenas,
the transactional and the best-fit allocators of
:mod:`tpulab_torch.memory` compose over device blocks unchanged; the
address keys the block and :meth:`~DeviceRawAllocator.buffer` (or a
device descriptor's ``device_buffer``) gives its tensor.
:func:`make_cuda_allocator` is tpulab's ``make_tpu_allocator``.
:class:`HostRawAllocator` hands out the
host tier's blocks the same way: page-locked when they feed a CUDA pool
(so a copy to or from the card runs asynchronously), plain otherwise
(a CPU-only PyTorch refuses ``pin_memory``).  The addresses are keys,
not pointers: PyTorch's caching allocators own the real memory, and a
pinned block handed back keeps living until every copy recorded against
it has completed.

:class:`PinnedStagingAllocator` (``make_staging_allocator``) is the
staging allocator of tpulab's Buffers and workspaces: page-aligned,
first-touched host memory from ``mmap`` that is also page-locked for the
card (``cudaHostRegister`` at allocation, ``cudaHostUnregister`` before
the unmap).  A registration that fails raises; with ``device="cpu"`` the
memory is plain first-touched memory.
"""

from __future__ import annotations

import itertools
import logging
import threading
import weakref
from typing import Dict, Set, Tuple

import torch

from tpulab_torch.cuda.memory_types import CudaMemory, HostPinnedMemory
from tpulab_torch.cuda.platform import resolve_device
from tpulab_torch.memory.debugging import InvalidPointer, OutOfMemory
from tpulab_torch.memory.memory_type import MemoryType
from tpulab_torch.memory.raw_allocators import FirstTouchAllocator

log = logging.getLogger("tpulab_torch.cuda")

# synthetic block addresses (the tpulab convention: a high base and a
# wide stride so an address names its block unambiguously)
_ADDR_BASE = 1 << 60
_ADDR_STRIDE = 1 << 40


def _nbytes(t) -> int:
    """Bytes of a tensor, or of every tensor leaf of a (nested) dict,
    list or tuple."""
    if isinstance(t, dict):
        return sum(_nbytes(v) for v in t.values())
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(v) for v in t)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def place_tree(tree, device):
    """``tree`` (nested dicts, lists and tuples) with every tensor on
    ``device``: a leaf already there as it is, a host leaf copied on the
    caller's current stream with its dense strides kept (asynchronously
    from page-locked memory); other leaves pass through."""
    if isinstance(tree, dict):
        return {k: place_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=tree.is_pinned())
    return tree


class _TrackedAllocator:
    """Blocks under synthetic addresses, every live byte counted."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = itertools.count()
        self._buffers: Dict[int, torch.Tensor] = {}
        self._sizes: Dict[int, int] = {}

    def _new(self, shape, dtype) -> torch.Tensor:
        raise NotImplementedError

    def _register(self, value) -> int:
        with self._lock:
            addr = _ADDR_BASE + next(self._next) * _ADDR_STRIDE
            self._buffers[addr] = value
            self._sizes[addr] = _nbytes(value)
        return addr

    def allocate_array(self, shape, dtype) -> Tuple[int, torch.Tensor]:
        """A tensor owned by this allocator, under a new address."""
        buf = self._new(tuple(shape), dtype)
        return self._register(buf), buf

    def adopt(self, value) -> int:
        """Register a tensor (or tree) the caller hands over as a block of
        this allocator, without copying it; returns its address."""
        return self._register(value)

    def replace(self, addr: int, new_value):
        """Give block ``addr`` a new tensor (pool grow/shrink); its byte
        count follows the successor."""
        with self._lock:
            if addr not in self._buffers:
                raise InvalidPointer(f"0x{addr:x} is not a block of this "
                                     "allocator")
            self._buffers[addr] = new_value
            self._sizes[addr] = _nbytes(new_value)
        return new_value

    def buffer(self, addr: int):
        """The tensor (or tree) of the live block holding ``addr`` (an
        offset inside a block names that block)."""
        base = _ADDR_BASE + (addr - _ADDR_BASE) // _ADDR_STRIDE * _ADDR_STRIDE
        with self._lock:
            buf = self._buffers.get(base)
        if buf is None:
            raise InvalidPointer(f"0x{addr:x} is not in any live block of "
                                 "this allocator")
        return buf

    def node_size(self, addr: int) -> int:
        """Tracked bytes of one live block (0 for unknown/freed)."""
        with self._lock:
            return self._sizes.get(addr, 0)

    def deallocate_node(self, addr: int, size: int = 0, alignment: int = 0):
        """Free one block (its bytes leave the gauge).  Returns its tensor,
        which a caller may keep using: the memory itself goes back to
        PyTorch once the last reference dies."""
        with self._lock:
            buf = self._buffers.pop(addr, None)
            self._sizes.pop(addr, None)
        if buf is None:
            raise InvalidPointer(f"0x{addr:x} is not a block of this "
                                 "allocator")
        return buf

    @property
    def bytes_in_use(self) -> int:
        """Every live tracked byte (the device-memory gauge)."""
        with self._lock:
            return sum(self._sizes.values())

    @property
    def live_allocations(self) -> int:
        with self._lock:
            return len(self._buffers)

    def max_node_size(self) -> int:
        return _ADDR_STRIDE


#: every live device allocator, for process-wide device-memory accounting
_live_device_allocators: "weakref.WeakSet[DeviceRawAllocator]" = \
    weakref.WeakSet()


class DeviceRawAllocator(_TrackedAllocator):
    """Tracked raw allocator over one device's memory (blocks zeroed)."""

    is_stateful = True
    memory_type: MemoryType = CudaMemory

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = torch.device(device)
        _live_device_allocators.add(self)

    def _new(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    # RawAllocator concept --------------------------------------------------
    def allocate_node(self, size: int, alignment: int = 0) -> int:
        """A zeroed uint8 block of ``size`` bytes on this device."""
        if size <= 0:
            raise OutOfMemory(type(self).__name__, size, "(non-positive size)")
        try:
            buf = self._new((size,), torch.uint8)
        except torch.OutOfMemoryError as e:
            raise OutOfMemory(type(self).__name__, size, str(e)) from e
        return self._register(buf)

    def max_alignment(self) -> int:
        return CudaMemory.access_alignment

    @staticmethod
    def total_bytes_in_use() -> int:
        """Every byte the live device allocators of this process track."""
        return sum(a.bytes_in_use for a in list(_live_device_allocators))

    def allocate_tree(self, tree) -> Tuple[int, dict]:
        """Weight capture (tpulab's ``allocate_tree``): a tree (nested
        dicts, lists and tuples) of tensors placed on this device as ONE
        tracked block, its bytes the sum of its tensor leaves.  Leaves
        already on the device are taken as they are (no copy); host leaves
        copy on the caller's current stream, keeping a dense layout's
        strides (asynchronously from page-locked memory).  Returns the
        block's address and the device tree."""
        dev = place_tree(tree, self.device)
        return self._register(dev), dev


class HostRawAllocator(_TrackedAllocator):
    """Tracked raw allocator over host memory (blocks uninitialised);
    ``pinned`` blocks are page-locked, for asynchronous copies to and
    from a CUDA device."""

    def __init__(self, pinned: bool = False):
        super().__init__()
        self.pinned = bool(pinned)

    def _new(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.pinned)

    def allocate_like(self, src: torch.Tensor) -> Tuple[int, torch.Tensor]:
        """A block of ``src``'s shape and dtype (and strides, for a dense
        layout), under a new address."""
        from tpulab_torch.cuda.transfer import host_like
        buf = host_like(src, self.pinned)
        return self._register(buf), buf


def make_cuda_allocator(device=None) -> DeviceRawAllocator:
    """Reference ``make_cuda_allocator(device_id)`` (tpulab's
    ``make_tpu_allocator``): ``None`` = the CUDA card."""
    return DeviceRawAllocator(resolve_device(device))


def _check(cudart, rc, what: str, size: int) -> None:
    if int(rc) != 0:
        raise OutOfMemory("PinnedStagingAllocator", size,
                          f"({what} failed: {cudart.cudaGetErrorString(rc)})")


def _unregister_all(cudart, registered: Set[int], maps) -> None:
    """Unpin what is still registered before its mappings close (runs
    when the allocator is collected; ``maps`` keeps them mapped until
    then)."""
    for addr in list(registered):
        rc = cudart.cudaHostUnregister(addr)
        if int(rc) != 0:
            log.warning("cudaHostUnregister(0x%x): %s", addr,
                        cudart.cudaGetErrorString(rc))
    registered.clear()


class PinnedStagingAllocator(FirstTouchAllocator):
    """Pinned-host staging allocator (reference cuda_malloc_host):
    page-aligned mmap, first-touch fill and, for a CUDA device,
    page-locked through ``cudaHostRegister``."""

    def __init__(self, device=None):
        super().__init__(fill=0)
        self.memory_type = HostPinnedMemory
        self.device = resolve_device(device)
        self._cudart = (torch.cuda.cudart() if self.device.type == "cuda"
                        else None)
        self._registered: Set[int] = set()
        if self._cudart is not None:
            weakref.finalize(self, _unregister_all, self._cudart,
                             self._registered, self._maps)

    def allocate_node(self, size: int, alignment: int = 0) -> int:
        addr = super().allocate_node(
            size, max(alignment, HostPinnedMemory.min_allocation_alignment))
        if self._cudart is not None:
            with torch.cuda.device(self.device):
                rc = self._cudart.cudaHostRegister(addr, size, 0)
            if int(rc) != 0:
                super().deallocate_node(addr, size)
                _check(self._cudart, rc, "cudaHostRegister", size)
            self._registered.add(addr)
        return addr

    def deallocate_node(self, addr: int, size: int = 0,
                        alignment: int = 0) -> None:
        if addr in self._registered:
            self._registered.discard(addr)
            _check(self._cudart, self._cudart.cudaHostUnregister(addr),
                   "cudaHostUnregister", size)
        super().deallocate_node(addr, size, alignment)


def make_staging_allocator(device=None) -> PinnedStagingAllocator:
    """The staging allocator for ``device`` (``None`` = the CUDA card:
    page-locked; ``"cpu"``: plain first-touched memory)."""
    return PinnedStagingAllocator(device)
