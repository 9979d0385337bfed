"""tpulab_torch.cuda — the device layer (the port of ``tpulab/tpu``;
reference trtlab/cuda, §2.3 of SURVEY.md).

- :mod:`platform` — CUDA device handles; ``None`` means the card and the
  CPU is only ever asked for
- :mod:`device_info` — name, memory, PCI-local CPUs and peak rates
  (reference device_info.h NVML queries)
- :mod:`memory_types` — ``CudaMemory`` (device) and ``HostPinnedMemory``
  (page-locked staging) kinds (reference device_memory.h:36-84)
- :mod:`allocators` — tracked device and host allocators, the RawAllocator
  over device memory + ``make_cuda_allocator``, and the pinned staging
  allocator (reference cuda_allocators.h:44-183)
- :mod:`sync` — event sync: blocking for OS threads, yielding for
  event-loop handlers (reference sync.h:27-62 cuda_sync<ThreadType>), and
  the event poller of the infer pipeline
- :mod:`copy` — typed host<->device copies (reference src/copy.cc:41-70)
- :mod:`transfer` — side-stream transfer engine
- :mod:`cyclic_buffer` — device windowed stack (reference
  cuda/cyclic_windowed_buffer.h:27-44)

tpulab's names map to the port's: ``TpuMemory`` -> ``CudaMemory``,
``make_tpu_memory_type`` -> ``make_cuda_memory_type``, ``TpuRawAllocator``
-> ``DeviceRawAllocator``, ``make_tpu_allocator`` ->
``make_cuda_allocator``, ``tpu_sync_standard`` / ``tpu_sync_async`` /
``TpuSync`` -> ``cuda_sync_standard`` / ``cuda_sync_async`` /
``CudaSync``, ``is_tpu`` -> ``is_cuda``.
"""

from tpulab_torch.cuda.platform import (
    devices,
    local_device,
    device_count,
    platform_name,
    is_cuda,
)
from tpulab_torch.cuda.device_info import DeviceInfo
from tpulab_torch.cuda.memory_types import CudaMemory, HostPinnedMemory, make_cuda_memory_type
from tpulab_torch.cuda.allocators import (DeviceRawAllocator, make_cuda_allocator,
                                          make_staging_allocator)
from tpulab_torch.cuda.sync import cuda_sync_standard, cuda_sync_async, CudaSync
from tpulab_torch.cuda.copy import copy_to_device, copy_to_host, copy_device_to_device

__all__ = [
    "devices", "local_device", "device_count", "platform_name", "is_cuda",
    "DeviceInfo",
    "CudaMemory", "HostPinnedMemory", "make_cuda_memory_type",
    "DeviceRawAllocator", "make_cuda_allocator", "make_staging_allocator",
    "cuda_sync_standard", "cuda_sync_async", "CudaSync",
    "copy_to_device", "copy_to_host", "copy_device_to_device",
]
