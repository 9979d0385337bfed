"""Shared-memory allocator: cross-process zero-copy ingress.

The reference's SysV shared-memory path (core sysv_allocator.cc:46-70
shmget/shmat; examples/02 server.cc:110-137 uses it so clients hand the
server tensor data without a socket copy).  The modern Linux equivalent used
here is POSIX shm via ``multiprocessing.shared_memory`` — same capability:
a producer process fills a named segment; the serving process maps it and
binds tensors over it zero-copy.

``SharedMemoryAllocator`` satisfies the RawAllocator concept (composes with
descriptors/arenas); ``attach()`` maps an existing segment by name.
"""

from __future__ import annotations

import ctypes
from multiprocessing import shared_memory
from typing import Dict, Optional, Tuple

import numpy as np

from tpulab_torch.memory.debugging import InvalidPointer, OutOfMemory
from tpulab_torch.memory.descriptor import Descriptor, host_view
from tpulab_torch.memory.memory_type import DLDeviceType, MemoryType

SharedHostMemory = MemoryType(
    name="host_shared",
    device_type=DLDeviceType.kDLCPU,
    min_allocation_alignment=4096,
    access_alignment=64,
    host_accessible=True,
)


def _export(shm: shared_memory.SharedMemory) -> Tuple[int, object]:
    """(address, holder) — the holder keeps the buffer export alive and must
    be dropped before the segment can close."""
    holder = ctypes.c_char.from_buffer(shm.buf)
    return ctypes.addressof(holder), holder


class SharedMemoryAllocator:
    """RawAllocator over named POSIX shm segments (reference sysv_allocator)."""

    is_stateful = True
    memory_type = SharedHostMemory

    def __init__(self, prefix: str = "tpulab"):
        self._prefix = prefix
        self._segments: Dict[int, Tuple[shared_memory.SharedMemory, object]] = {}
        self._count = 0

    # -- RawAllocator concept ----------------------------------------------
    def allocate_node(self, size: int, alignment: int = 0) -> int:
        if size <= 0:
            raise OutOfMemory("SharedMemoryAllocator", size)
        import os
        import uuid
        # pid+uuid: unique across forked children (id(self) is inherited)
        name = f"{self._prefix}_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        self._count += 1
        try:
            seg = shared_memory.SharedMemory(name=name, create=True, size=size)
        except OSError as e:
            raise OutOfMemory("SharedMemoryAllocator", size, str(e)) from e
        addr, holder = _export(seg)
        self._segments[addr] = (seg, holder)
        return addr

    def deallocate_node(self, addr: int, size: int = 0,
                        alignment: int = 0) -> None:
        entry = self._segments.pop(addr, None)
        if entry is None:
            raise InvalidPointer(f"0x{addr:x} is not a shm segment here")
        seg = entry[0]
        del entry  # drop the tuple -> the export holder frees -> unmap works
        import gc
        gc.collect()  # the ctypes<->memoryview holder pair is a cycle
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:  # a peer already unlinked it
            pass

    def view(self, addr: int, size: int):
        return host_view(addr, size)

    def segment_name(self, addr: int) -> str:
        """The name a peer process attaches with."""
        return self._segments[addr][0].name

    # -- cross-process attach ----------------------------------------------
    @staticmethod
    def attach(name: str) -> "AttachedSegment":
        return AttachedSegment(name)

    def close(self) -> None:
        for addr in list(self._segments):
            try:
                self.deallocate_node(addr)
            except Exception:  # pragma: no cover
                pass


class AttachedSegment:
    """A peer-process mapping of a named segment (reference shmat side)."""

    def __init__(self, name: str):
        import gc
        self._shm = shared_memory.SharedMemory(name=name)
        self.name = name
        # peers must NOT unlink on exit — the owner does (py3.12 has no
        # track=False; unregister from the resource tracker instead)
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(self._shm._name, "shared_memory")
        except Exception:  # pragma: no cover - tracker internals
            pass
        # capture the base address once, then release the export so views
        # built via from_address never block close() (raw-pointer contract,
        # same as everywhere else in the framework)
        addr, holder = _export(self._shm)
        self._addr = addr
        del holder
        gc.collect()

    @property
    def size(self) -> int:
        return self._shm.size

    def numpy(self, dtype=np.uint8, shape=None) -> np.ndarray:
        arr = np.frombuffer(host_view(self._addr, self._shm.size), dtype=dtype)
        return arr.reshape(shape) if shape is not None else arr

    def close(self) -> None:
        self._shm.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
