"""Owning descriptors + the type-erased allocator interface.

- ``Descriptor``: a move-only owning handle {addr, size, alignment, memory_type}
  holding a reference to its ``IAllocator``; releases the memory back on
  ``release()``/``close()``/GC (reference descriptor.h:40-99, descriptor.cc).
- ``IAllocator``: the type-erased allocator interface every concrete allocator
  facade implements: allocate / deallocate / allocate_descriptor /
  max_alignment / device_context (reference descriptor.h:102-124).

Host-accessible descriptors expose zero-copy views: ``memoryview()`` and
``numpy(dtype, shape)`` aliasing the underlying storage — the staging-buffer
path the engine layer uses to avoid copies on host->device transfer.  Device
(CUDA memory) descriptors instead carry their ``device_buffer`` (a
``torch.Tensor`` on the card).
"""

from __future__ import annotations

import abc
import ctypes
import threading
import weakref
from typing import Any, Optional

import numpy as np

from tpulab_torch.memory.memory_type import AnyMemory, DLDeviceType, MemoryType
from tpulab_torch.memory.debugging import InvalidPointer


def host_view(addr: int, size: int) -> memoryview:
    """Zero-copy memoryview over raw host memory [addr, addr+size)."""
    return memoryview((ctypes.c_char * size).from_address(addr)).cast("B")


class IAllocator(abc.ABC):
    """Type-erased allocator interface (reference descriptor.h:102-124)."""

    #: MemoryType of allocations from this allocator.
    memory_type: MemoryType = AnyMemory

    @abc.abstractmethod
    def allocate(self, size: int, alignment: int = 0) -> int:
        """Allocate ``size`` bytes; returns an address (opaque int for device)."""

    @abc.abstractmethod
    def deallocate(self, addr: int, size: int, alignment: int = 0) -> None:
        """Return an allocation."""

    def allocate_descriptor(self, size: int, alignment: int = 0) -> "Descriptor":
        addr = self.allocate(size, alignment)
        return Descriptor(addr, size, self, alignment=alignment or self.max_alignment(),
                          device_buffer=self.device_buffer(addr))

    def device_buffer(self, addr: int) -> Any:
        """The tensor backing ``addr`` for device kinds (None for host kinds)."""
        return None

    def max_alignment(self) -> int:
        return self.memory_type.access_alignment

    def device_context(self) -> tuple[DLDeviceType, int]:
        """DLPack-style (device_type, device_id) (reference iallocator::device_context)."""
        return (self.memory_type.device_type, 0)

    # Host access -----------------------------------------------------------
    def view(self, addr: int, size: int) -> memoryview:
        """A zero-copy memoryview over [addr, addr+size) for host-accessible kinds."""
        if not self.memory_type.host_accessible:
            raise TypeError(f"{self.memory_type} is not host accessible")
        return host_view(addr, size)


class Descriptor:
    """Move-only owning memory handle (reference descriptor.h:40-99).

    The C++ original is move-only with a shared-ptr conversion; the Python
    equivalents: descriptors are not copyable, ``release()`` detaches and
    frees, ``share()`` converts to a refcounted shared handle, and an optional
    ``on_release`` callback lets pool/transactional allocators hook returns.
    """

    __slots__ = ("_addr", "_size", "_alignment", "_allocator", "_on_release",
                 "_released", "_device_buffer", "_finalized_evt", "__weakref__")

    def __init__(self, addr: int, size: int, allocator: Optional[IAllocator],
                 alignment: int = 8, on_release=None, device_buffer: Any = None):
        self._addr = addr
        self._size = size
        self._alignment = alignment
        self._allocator = allocator
        self._on_release = on_release
        self._released = False
        self._device_buffer = device_buffer
        if allocator is not None or on_release is not None:
            weakref.finalize(self, Descriptor._finalize, allocator, addr, size,
                             alignment, on_release,
                             finalized := threading.Event())
            self._finalized_evt = finalized

    # -- identity -----------------------------------------------------------
    @property
    def addr(self) -> int:
        self._check_live()
        return self._addr

    @property
    def size(self) -> int:
        return self._size

    @property
    def alignment(self) -> int:
        return self._alignment

    @property
    def memory_type(self) -> MemoryType:
        return self._allocator.memory_type if self._allocator else AnyMemory

    @property
    def device_buffer(self) -> Any:
        """The backing device object (a ``torch.Tensor``) for non-host kinds."""
        return self._device_buffer

    # -- lifetime -----------------------------------------------------------
    @staticmethod
    def _finalize(allocator, addr, size, alignment, on_release, evt) -> None:
        if evt.is_set():
            return
        evt.set()
        if on_release is not None:
            on_release(addr, size)
        elif allocator is not None:
            allocator.deallocate(addr, size, alignment)

    def release(self) -> None:
        """Free now (reference descriptor::release)."""
        if self._released:
            return
        self._released = True
        if hasattr(self, "_finalized_evt"):
            Descriptor._finalize(self._allocator, self._addr, self._size,
                                 self._alignment, self._on_release,
                                 self._finalized_evt)
        self._device_buffer = None

    close = release

    def detach(self) -> tuple[int, int]:
        """Give up ownership without freeing; returns (addr, size)."""
        self._check_live()
        self._released = True
        if hasattr(self, "_finalized_evt"):
            self._finalized_evt.set()
        return self._addr, self._size

    def share(self) -> "SharedDescriptor":
        """Convert to a refcounted shared handle (reference make_shared())."""
        shared = SharedDescriptor(self)
        return shared

    def _check_live(self) -> None:
        if self._released:
            raise InvalidPointer("descriptor already released")

    def __enter__(self) -> "Descriptor":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- host access --------------------------------------------------------
    def memoryview(self) -> memoryview:
        self._check_live()
        if self._allocator is None:
            return host_view(self._addr, self._size)
        return self._allocator.view(self._addr, self._size)

    def numpy(self, dtype=np.uint8, shape=None) -> np.ndarray:
        """Zero-copy numpy array aliasing this descriptor's memory."""
        arr = np.frombuffer(self.memoryview(), dtype=dtype)
        if shape is not None:
            arr = arr.reshape(shape)
        return arr

    def __len__(self) -> int:
        return self._size

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        state = "released" if self._released else f"addr=0x{self._addr:x}"
        return f"Descriptor({state}, size={self._size}, type={self.memory_type.name})"


class SharedDescriptor:
    """Refcounted wrapper over a Descriptor (reference descriptor::make_shared).

    Cheap to copy via ``ref()``; underlying memory is released when the last
    reference drops.
    """

    def __init__(self, descriptor: Descriptor):
        self._descriptor = descriptor
        self._lock = threading.Lock()
        self._refs = 1

    def ref(self) -> "SharedDescriptor":
        with self._lock:
            self._refs += 1
        return self

    def unref(self) -> None:
        with self._lock:
            self._refs -= 1
            last = self._refs == 0
        if last:
            self._descriptor.release()

    @property
    def descriptor(self) -> Descriptor:
        return self._descriptor

    def __getattr__(self, item):
        return getattr(self._descriptor, item)
