"""Device memory kinds (reference cuda device_memory.h:36-84; the port's
counterpart of ``tpulab/tpu/memory_types.py``).

- ``CudaMemory`` — device memory on a CUDA card, held by PyTorch tensors.
  Not host accessible; cudaMalloc's 256-byte allocation and access
  alignment.
- ``HostPinnedMemory`` — page-aligned, page-locked host staging memory
  (cudaMallocHost's kind, kDLCUDAHost): a copy from or to it runs
  asynchronously on a CUDA stream.
"""

from __future__ import annotations

from tpulab_torch.memory.memory_type import DLDeviceType, MemoryType

#: CUDA device memory (reference device_memory: kDLCUDA, 256-byte alignment).
CudaMemory = MemoryType(
    name="cuda",
    device_type=DLDeviceType.kDLCUDA,
    min_allocation_alignment=256,
    access_alignment=256,
    host_accessible=False,
)

#: Page-locked staging host memory (reference host_pinned_memory).
HostPinnedMemory = MemoryType(
    name="host_pinned",
    device_type=DLDeviceType.kDLCUDAHost,
    min_allocation_alignment=4096,
    access_alignment=64,
    host_accessible=True,
)


def make_cuda_memory_type(device_id: int) -> MemoryType:
    """A per-device memory kind, for multi-card resource bundles."""
    return MemoryType(
        name=f"cuda:{device_id}",
        device_type=DLDeviceType.kDLCUDA,
        min_allocation_alignment=256,
        access_alignment=256,
        host_accessible=False,
    )
