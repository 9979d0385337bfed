"""Memory *kinds*: device-typed tags carried by every allocator and descriptor.

Mirrors the reference's compile-time memory type system
(reference trtlab/memory/include/trtlab/memory/memory_type.h:93-129 and
detail:40-87): each memory kind declares its DLPack device type, minimum
allocation alignment, and access alignment.  Allocators are parameterized by a
memory type; descriptors report theirs; copies dispatch on (src kind, dst kind).

CUDA additions (the analog of trtlab/cuda/include/.../device_memory.h:36-84)
live in :mod:`tpulab_torch.cuda.memory_types`: ``CudaMemory`` (device memory
held by PyTorch tensors) and ``HostPinnedMemory`` (page-aligned, page-locked
staging memory for asynchronous host->device transfer).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class DLDeviceType(IntEnum):
    """DLPack device types (subset) + tpulab's private code 99.

    The members and values are tpulab's, so device contexts compare across
    the two packages.  kDLCPU/kDLCUDA/kDLCUDAHost values follow dlpack.h;
    no memory kind of this package uses the private code.
    """

    kDLCPU = 1
    kDLCUDA = 2
    kDLCUDAHost = 3
    kDLExtDev = 12
    kDLTPU = 99  # tpulab's private code (unused here)


@dataclass(frozen=True)
class MemoryType:
    """A memory kind: name + DLPack device type + alignment policy.

    ``min_allocation_alignment`` is the alignment every allocation of this kind
    is rounded up to; ``access_alignment`` is the guaranteed pointer alignment
    (reference memory_type.h: host_memory 8B; cuda device_memory 256B/64B).
    """

    name: str
    device_type: DLDeviceType
    min_allocation_alignment: int = 8
    access_alignment: int = 8
    host_accessible: bool = True

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"MemoryType({self.name})"


#: Plain host memory — 8-byte aligned, kDLCPU (reference memory_type.h:93-129).
HostMemory = MemoryType("host", DLDeviceType.kDLCPU, 8, 8, True)

#: Wildcard used by type-erased interfaces (reference any_memory).
AnyMemory = MemoryType("any", DLDeviceType.kDLCPU, 1, 1, True)


def is_memory_type(obj: object) -> bool:
    """Reference ``is_memory_type`` trait."""
    return isinstance(obj, MemoryType)


def is_host_accessible(mt: MemoryType) -> bool:
    """Can the host build a memoryview over this kind of memory?"""
    return mt.host_accessible
