"""Tracked device allocator (the port's counterpart of
``tpulab/tpu/allocators.py``'s ``TpuRawAllocator``).

The KV page store is a block owned by this allocator: ``allocate_array``
hands out a zeroed tensor under a synthetic address, every live byte is
counted (``bytes_in_use`` is the gauge), and ``replace`` swaps a block's
tensor for its successor when the pool grows or shrinks — so
``PagedKVPool.hbm_bytes`` reads the allocator's count exactly as it does
in tpulab.  The addresses are keys, not pointers: PyTorch's caching
allocator owns the real memory.
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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceRawAllocator:
    """Tracked raw allocator over one device's memory."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._next = itertools.count()
        self._buffers: Dict[int, torch.Tensor] = {}
        self._sizes: Dict[int, int] = {}

    def allocate_array(self, shape, dtype) -> Tuple[int, torch.Tensor]:
        """A zeroed device tensor owned by this allocator."""
        buf = torch.zeros(tuple(shape), dtype=dtype, device=self.device)
        with self._lock:
            addr = _ADDR_BASE + next(self._next) * _ADDR_STRIDE
            self._buffers[addr] = buf
            self._sizes[addr] = _nbytes(buf)
        return addr, buf

    def replace(self, addr: int, new_value: torch.Tensor) -> torch.Tensor:
        """Give block ``addr`` a new tensor (pool grow/shrink); its byte
        count follows the successor."""
        with self._lock:
            if addr not in self._buffers:
                raise KeyError(f"0x{addr:x} is not a block of this allocator")
            self._buffers[addr] = new_value
            self._sizes[addr] = _nbytes(new_value)
        return new_value

    def node_size(self, addr: int) -> int:
        """Tracked bytes of one live block (0 for unknown/freed)."""
        with self._lock:
            return self._sizes.get(addr, 0)

    def deallocate_node(self, addr: int) -> None:
        """Free one block (its bytes leave the gauge)."""
        with self._lock:
            buf = self._buffers.pop(addr, None)
            self._sizes.pop(addr, None)
        if buf is None:
            raise KeyError(f"0x{addr:x} is not a block of this allocator")

    @property
    def bytes_in_use(self) -> int:
        """Every live tracked byte (the device-memory gauge)."""
        with self._lock:
            return sum(self._sizes.values())
