"""Device introspection (reference device_info.h:35-57 — NVML affinity /
alignment / memory queries; the port's counterpart of
``tpulab/tpu/device_info.py``).

Every method takes ``index``: a CUDA device index (the card; raises
without one) or ``"cpu"``, the host, which answers as tpulab's CPU
backend does (no memory statistics, no peak rate, every CPU local).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from tpulab_torch.core.affinity import Affinity, CpuSet
from tpulab_torch.cuda.platform import device_count, resolve_device

Index = Union[int, str, torch.device]


@dataclass
class MemoryInfo:
    bytes_in_use: Optional[int]
    bytes_limit: Optional[int]
    peak_bytes_in_use: Optional[int]


def _cuda_index(index: Index) -> Optional[int]:
    """The CUDA device index ``index`` names, or None for the host."""
    if isinstance(index, int):
        index = torch.device("cuda", index)
    dev = resolve_device(index)
    return None if dev.type == "cpu" else dev.index


class DeviceInfo:
    """Per-device introspection (reference DeviceInfo static API)."""

    @staticmethod
    def count() -> int:
        """CUDA devices visible to this process."""
        return device_count()

    @staticmethod
    def device_kind(index: Index = 0) -> str:
        """The CUDA device name (``"cpu"`` for the host)."""
        i = _cuda_index(index)
        return "cpu" if i is None else torch.cuda.get_device_name(i)

    @staticmethod
    def coords(index: Index = 0) -> Optional[tuple]:
        """A card has no position in a chip torus: None."""
        _cuda_index(index)
        return None

    @staticmethod
    def core_on_chip(index: Index = 0) -> Optional[int]:
        _cuda_index(index)
        return None

    @staticmethod
    def memory_info(index: Index = 0) -> MemoryInfo:
        """Device memory (reference cudaMemGetInfo): the bytes the caching
        allocator holds for live tensors, the card's total, and the
        allocator's peak."""
        i = _cuda_index(index)
        if i is None:
            return MemoryInfo(None, None, None)
        _free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        return MemoryInfo(stats.get("allocated_bytes.all.current", 0), total,
                          stats.get("allocated_bytes.all.peak", 0))

    # Dense peak tensor-core rates (FLOP/s and int8 OP/s, no sparsity),
    # keyed by a substring of the CUDA device name.  Source: NVIDIA H100
    # Tensor Core GPU datasheet, H100 SXM5 column (BF16 1,979 and INT8
    # 3,958 with sparsity, halved).  Only the card this port runs on.
    _PEAK_FLOPS = (
        ("H100 80GB HBM3", {"bf16": 989.4e12, "int8": 1978.9e12}),
    )

    @staticmethod
    def peak_flops(dtype: str = "bf16", index: Index = 0) -> Optional[float]:
        """Peak rate for ``dtype`` ('bf16'|'int8') on the card, or None
        when its name is not in the table (and for the host)."""
        kind = DeviceInfo.device_kind(index)
        for marker, peaks in DeviceInfo._PEAK_FLOPS:
            if marker in kind:
                return peaks.get(dtype, peaks["bf16"])
        return None

    @staticmethod
    def alignment() -> int:
        """Minimum device allocation alignment (reference
        DeviceInfo::Alignment): cudaMalloc's 256 bytes."""
        return 256

    @staticmethod
    def _pci_bus_id(i: int) -> str:
        """The card's PCI address as sysfs names it (``0000:5d:00.0``)."""
        p = torch.cuda.get_device_properties(i)
        return (f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:"
                f"{p.pci_device_id:02x}.0")

    @staticmethod
    def cpu_affinity(index: Index = 0) -> CpuSet:
        """CPUs local to the card's PCI bus (read from sysfs), or every
        CPU where the bus publishes none (and for the host)."""
        i = _cuda_index(index)
        if i is not None:
            path = os.path.join("/sys/bus/pci/devices",
                                DeviceInfo._pci_bus_id(i), "local_cpulist")
            try:
                with open(path) as f:
                    cpus = CpuSet.from_string(f.read())
            except OSError:
                cpus = CpuSet()
            if cpus:
                return cpus
        return Affinity.all_cpus()

    @staticmethod
    def attributes(index: Index = 0) -> Dict[str, object]:
        i = _cuda_index(index)
        if i is None:
            return {"id": 0, "platform": "cpu", "device_kind": "cpu",
                    "process_index": 0}
        p = torch.cuda.get_device_properties(i)
        return {"id": i, "platform": "cuda", "device_kind": p.name,
                "process_index": 0,
                "compute_capability": (p.major, p.minor),
                "multi_processor_count": p.multi_processor_count,
                "pci_bus_id": DeviceInfo._pci_bus_id(i)}
