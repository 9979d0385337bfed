"""Typed host<->device copies (reference src/copy.cc:41-70 — Copy()
dispatching on memory kinds over cudaMemcpyDefault; the port's counterpart
of ``tpulab/tpu/copy.py``).

Host -> device copies are enqueued on the caller's current stream and
return at once when the host tensor is page-locked (staging views of
:class:`~tpulab_torch.cuda.allocators.PinnedStagingAllocator`); device ->
host copies block until the bytes have landed.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpulab_torch.cuda.platform import resolve_device


def copy_to_device(host: torch.Tensor, device=None,
                   non_blocking: bool = True) -> torch.Tensor:
    """Host -> device on the caller's current stream (tpulab's
    ``copy_to_device``): returns at once when ``host`` is page-locked."""
    return host.to(resolve_device(device), non_blocking=non_blocking)


def copy_to_host(tensor: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Device -> host, blocking; into ``out`` when given."""
    if out is None:
        return tensor.detach().to("cpu", copy=True)
    out.copy_(tensor)
    return out


def copy_device_to_device(tensor: torch.Tensor, device) -> torch.Tensor:
    """Device -> another device."""
    return tensor.to(resolve_device(device))
