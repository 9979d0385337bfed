"""Error taxonomy + debug handler hooks (reference debugging.h:17-97, error.h:25-267)."""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

log = logging.getLogger("tpulab_torch.memory")


class MemoryError_(Exception):
    """Base of the allocator error taxonomy (reference error.h)."""


class OutOfMemory(MemoryError_):
    """Allocator cannot satisfy the request (reference error.h out_of_memory)."""

    def __init__(self, allocator: str, size: int, detail: str = ""):
        self.allocator = allocator
        self.size = size
        super().__init__(f"{allocator}: out of memory allocating {size} bytes {detail}".rstrip())


class BadAllocationSize(MemoryError_):
    """Request exceeds what the allocator supports (reference bad_allocation_size)."""

    def __init__(self, allocator: str, size: int, supported: int):
        self.allocator = allocator
        self.size = size
        self.supported = supported
        super().__init__(
            f"{allocator}: bad allocation size {size} (max supported {supported})")


class LeakError(MemoryError_):
    """Raised by the default leak handler when leaks are fatal."""


class InvalidPointer(MemoryError_):
    """Deallocation of a pointer the allocator does not own."""


# ---------------------------------------------------------------------------
# Handler hooks (reference debugging.h leak/invalid-pointer handler functions).
# ---------------------------------------------------------------------------

LeakHandler = Callable[[str, int], None]

_handler_lock = threading.Lock()


def _default_leak_handler(allocator: str, leaked_bytes: int) -> None:
    log.error("LEAK: allocator %s leaked %d bytes", allocator, leaked_bytes)


_leak_handler: LeakHandler = _default_leak_handler


def set_leak_handler(handler: Optional[LeakHandler]) -> LeakHandler:
    """Install a leak handler; returns the previous one (reference set_leak_handler)."""
    global _leak_handler
    with _handler_lock:
        old = _leak_handler
        _leak_handler = handler or _default_leak_handler
        return old


def get_leak_handler() -> LeakHandler:
    with _handler_lock:
        return _leak_handler


def report_leak(allocator: str, leaked_bytes: int) -> None:
    get_leak_handler()(allocator, leaked_bytes)
