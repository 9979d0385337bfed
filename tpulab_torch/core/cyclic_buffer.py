"""Sliding-window streaming compute over a cyclic buffer
(reference cyclic_windowed_buffer.h:59-440: impl 136-244, executor 369-440,
reservation 287-365; v1 cyclic_buffer.h subsumed).

A buffer is divided into ``window_count`` windows of ``window_size`` bytes,
each overlapping its predecessor by ``overlap`` bytes (stride =
window_size - overlap; buffer size = count*stride + overlap).  Appending data
fills windows in sequence; each filled window fires a compute callback whose
future becomes the window's *sync function*; reusing a window slot (wrap
around) blocks on its previous sync — bounded memory over an unbounded stream
with natural backpressure.  On wrap, the trailing ``overlap`` bytes are
replicated to the buffer head so every window sees its carried-over context.

This is the framework's sequence-window component: for streaming/long-context
inference, window = sequence chunk and overlap = context carry-over (the
honest trtlab-equivalent slot for blockwise long-context; see SURVEY §2.8).
The CUDA specialization, whose windows are copied to the card and computed
there, lives in :mod:`tpulab_torch.cuda.cyclic_buffer` (reference
cuda/cyclic_windowed_buffer.h).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

from tpulab_torch.memory.descriptor import Descriptor


class CyclicWindowedStack:
    """Cursor/sync state machine (reference cyclic_windowed_stack_impl:136-244).

    Subclasses (or users via ``on_window``) provide the per-window compute.
    ``append`` is single-producer; sync waits provide backpressure.
    """

    def __init__(self, buffer: Descriptor, window_count: int, window_size: int,
                 overlap: int = 0,
                 on_window: Optional[Callable[[int, memoryview], Optional[Future]]] = None):
        if overlap * 2 > window_size:
            # The slot-sync scheme is only sound when a window's carried-over
            # region fits inside one neighbor slot (overlap <= stride).
            raise ValueError("overlap must be <= window_size/2")
        if window_count < 2 and overlap:
            raise ValueError("overlap requires at least two windows")
        self.window_count = window_count
        self.window_size = window_size
        self.overlap = overlap
        self.stride = window_size - overlap
        required = window_count * self.stride + overlap
        if buffer.size < required:
            raise ValueError(f"buffer of {buffer.size} B too small; "
                             f"need {required} B for {window_count} windows")
        self._buffer = buffer
        self._view = buffer.memoryview()
        self._sync: List[Optional[Future]] = [None] * window_count
        self._cursor = 0          # absolute write offset in buffer
        self._win_id = 0          # global window counter
        self._on_window = on_window

    # -- geometry -----------------------------------------------------------
    def _slot(self, win_id: int) -> int:
        return win_id % self.window_count

    def _slot_offset(self, slot: int) -> int:
        return slot * self.stride

    @property
    def current_window(self) -> int:
        return self._win_id

    @property
    def bytes_in_current_window(self) -> int:
        return self._cursor - self._slot_offset(self._slot(self._win_id))

    # -- sync ---------------------------------------------------------------
    def _wait_slot(self, slot: int) -> None:
        fut = self._sync[slot]
        if fut is not None:
            fut.result()  # propagate compute errors; backpressure point
            self._sync[slot] = None

    def sync_all(self) -> None:
        """Wait for every in-flight window compute."""
        for slot in range(self.window_count):
            self._wait_slot(slot)

    # -- data path ----------------------------------------------------------
    def _write(self, offset: int, data: memoryview) -> None:
        """Host copy into the staging buffer (the device copy is per window)."""
        self._view[offset:offset + len(data)] = data

    def _replicate_overlap(self) -> None:
        """Copy buffer tail overlap to the head (wrap-around carry-over)."""
        end = self.window_count * self.stride + self.overlap
        self._write(0, self._view[end - self.overlap:end])

    def append(self, data) -> None:
        """Append bytes; fires window computes as windows fill. MAY BLOCK."""
        mv = memoryview(data).cast("B") if not isinstance(data, memoryview) else data.cast("B")
        pos = 0
        while pos < len(mv):
            slot = self._slot(self._win_id)
            win_end = self._slot_offset(slot) + self.window_size
            n = min(win_end - self._cursor, len(mv) - pos)
            self._wait_touched_slots(self._cursor, n)
            self._write(self._cursor, mv[pos:pos + n])
            self._cursor += n
            pos += n
            if self._cursor == win_end:
                self._complete_window()

    def _wait_touched_slots(self, offset: int, n: int) -> None:
        first = offset // self.stride
        last = min((offset + n - 1) // self.stride, self.window_count - 1)
        for s in range(first, last + 1):
            self._wait_slot(s)  # no-op when the slot's compute already landed

    def _complete_window(self) -> None:
        slot = self._slot(self._win_id)
        start = self._slot_offset(slot)
        window_view = self._view[start:start + self.window_size]
        if self._on_window is not None:
            fut = self._on_window(self._win_id, window_view)
            if fut is not None:
                self._sync[slot] = fut
        self._win_id += 1
        if self._slot(self._win_id) == 0:  # wrapped
            if self.overlap:
                self._wait_slot(0)
                self._replicate_overlap()
            self._cursor = self.overlap
        # else: cursor already sits `overlap` bytes into the next window

    def release(self) -> None:
        self.sync_all()
        self._view.release()
        self._buffer.release()


class CyclicWindowedTaskExecutor(CyclicWindowedStack):
    """Fires a compute task per filled window and records its future as the
    window's sync fn (reference cyclic_windowed_task_executor:369-440)."""

    def __init__(self, buffer: Descriptor, window_count: int, window_size: int,
                 overlap: int = 0,
                 compute_fn: Optional[Callable[[int, memoryview], object]] = None,
                 executor=None):
        super().__init__(buffer, window_count, window_size, overlap,
                         on_window=self._launch)
        self._compute_fn = compute_fn
        self._executor = executor  # ThreadPool-like with .enqueue

    def _launch(self, win_id: int, view: memoryview) -> Optional[Future]:
        if self._compute_fn is None:
            return None
        if self._executor is not None:
            return self._executor.enqueue(self._compute_fn, win_id, view)
        fut: Future = Future()
        try:
            fut.set_result(self._compute_fn(win_id, view))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)
        return fut


class CyclicWindowedReservedStack(CyclicWindowedStack):
    """Hands out one reserved window at a time for direct (zero-copy) filling
    (reference cyclic_windowed_reserved_stack:287-365)."""

    def __init__(self, buffer: Descriptor, window_count: int, window_size: int,
                 overlap: int = 0):
        super().__init__(buffer, window_count, window_size, overlap)
        self._reserved = False

    def reserve_window(self) -> Tuple[int, memoryview]:
        """Returns (window_id, writable view). Blocks if the slot is in flight."""
        if self._reserved:
            raise RuntimeError("a window is already reserved")
        slot = self._slot(self._win_id)
        self._wait_slot(slot)
        if self.overlap:
            # the window's tail extends `overlap` bytes into the next slot's
            # region — that slot's previous-cycle compute must have landed
            # before the caller writes through the view
            self._wait_slot((slot + 1) % self.window_count)
            if slot == 0 and self._win_id > 0:
                self._replicate_overlap()
        start = self._slot_offset(slot)
        self._reserved = True
        return self._win_id, self._view[start:start + self.window_size]

    def release_window(self, sync: Optional[Future] = None) -> None:
        """Mark the reserved window filled; ``sync`` is its compute future."""
        if not self._reserved:
            raise RuntimeError("no window reserved")
        slot = self._slot(self._win_id)
        if sync is not None:
            self._sync[slot] = sync
        self._win_id += 1
        self._cursor = self._slot_offset(self._slot(self._win_id)) + self.overlap
        self._reserved = False
