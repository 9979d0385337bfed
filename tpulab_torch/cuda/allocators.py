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
exactly as it does in tpulab.  :class:`HostRawAllocator` hands out the
host tier's blocks the same way: page-locked when they feed a CUDA pool
(so a copy to or from the card runs asynchronously), plain otherwise
(a CPU-only PyTorch refuses ``pin_memory``).  The addresses are keys,
not pointers: PyTorch's caching allocators own the real memory, and a
pinned block handed back keeps living until every copy recorded against
it has completed.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Tuple

import torch

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
                raise KeyError(f"0x{addr:x} is not a block of this allocator")
            self._buffers[addr] = new_value
            self._sizes[addr] = _nbytes(new_value)
        return new_value

    def buffer(self, addr: int):
        """The tensor (or tree) of a live block."""
        with self._lock:
            buf = self._buffers.get(addr)
        if buf is None:
            raise KeyError(f"0x{addr:x} is not a block of this allocator")
        return buf

    def node_size(self, addr: int) -> int:
        """Tracked bytes of one live block (0 for unknown/freed)."""
        with self._lock:
            return self._sizes.get(addr, 0)

    def deallocate_node(self, addr: int):
        """Free one block (its bytes leave the gauge).  Returns its tensor,
        which a caller may keep using: the memory itself goes back to
        PyTorch once the last reference dies."""
        with self._lock:
            buf = self._buffers.pop(addr, None)
            self._sizes.pop(addr, None)
        if buf is None:
            raise KeyError(f"0x{addr:x} is not a block of this allocator")
        return buf

    @property
    def bytes_in_use(self) -> int:
        """Every live tracked byte (the device-memory gauge)."""
        with self._lock:
            return sum(self._sizes.values())


class DeviceRawAllocator(_TrackedAllocator):
    """Tracked raw allocator over one device's memory (blocks zeroed)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = torch.device(device)

    def _new(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

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
