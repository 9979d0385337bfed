"""CUDA device handles (the port's counterpart of ``tpulab/tpu/platform.py``).

Device identity is explicit: every entry point takes a ``device`` and
resolves it here.  ``default_device()`` is the CUDA card or an error —
the port never falls back to the CPU on its own; a caller that wants the
CPU passes ``device="cpu"``.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def device_count() -> int:
    """CUDA devices visible to this process (0 without a GPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    """The first CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: tpulab_torch entry points run on the GPU "
            "unless the caller passes device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` -> :func:`default_device`; anything else as given (a CUDA
    device is checked to exist)."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_name_and_power_limit(index: int = 0) -> str:
    """The card's name and power limit, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them for device ``index`` (e.g. ``NVIDIA H100 80GB HBM3,
    700.00 W``).  Raises when ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()
