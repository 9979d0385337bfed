"""Device synchronization (the port of ``tpulab/tpu/sync.py``).

- :func:`cuda_sync_standard` blocks until a CUDA event (or the work
  behind a tree of tensors) has completed: tpulab's ``tpu_sync_standard``.
- :class:`EventPoller` is one thread watching many in-flight CUDA events;
  ``watch(event, callback)`` fires ``callback()`` once the event has
  completed.  The infer pipeline uses it to return an execution token the
  moment *compute* is done, independent of the slower device-to-host
  copy.  ``event=None`` (work that ran on the CPU, already complete)
  fires at once on the poller thread.  Each round fires every event that
  ``query()`` finds complete, then blocks in ``synchronize()`` on the
  oldest one still pending — which releases the interpreter lock — so the
  thread never spins in Python against the threads that launch the work
  (tpulab polls every 0.5 ms; a Python poll loop takes the lock each
  time).

Callbacks run on the poller thread and must be tiny (pool pushes).
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Any, Callable, Optional

import torch

log = logging.getLogger("tpulab_torch.cuda")


def cuda_sync_standard(x: Any) -> Any:
    """Block until ``x`` is ready: a ``torch.cuda.Event`` is synchronized;
    for tensors (a tensor or a dict of them), every CUDA device they live
    on is.  Returns ``x``."""
    if isinstance(x, torch.cuda.Event):
        x.synchronize()
        return x
    leaves = x.values() if isinstance(x, dict) else [x]
    for dev in {t.device for t in leaves if isinstance(t, torch.Tensor)
                and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


class EventPoller:
    """Central completion watcher: one thread, many events."""

    def __init__(self, name: str = "event-poller"):
        self._entries: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._shutdown = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def watch(self, event: Optional["torch.cuda.Event"],
              callback: Callable[[], None]) -> None:
        """Fire ``callback()`` once ``event`` has completed."""
        with self._cv:
            if self._shutdown:
                raise RuntimeError("EventPoller is shut down")
            self._entries.append((event, callback))
            self._cv.notify()

    @staticmethod
    def _ready(event) -> bool:
        if event is None:
            return True
        try:
            return event.query()
        except RuntimeError:
            return True     # a failed device counts as done: free the slot

    @staticmethod
    def _wait(event) -> None:
        try:
            event.synchronize()
        except RuntimeError:
            pass            # _ready reports it done next round

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._entries and not self._shutdown:
                    self._cv.wait()
                entries = list(self._entries)
                self._entries.clear()
                stopping = self._shutdown
            if stopping:
                for _event, cb in entries:      # drain on shutdown
                    self._fire(cb)
                return
            waiting = []
            for event, cb in entries:
                if self._ready(event):
                    self._fire(cb)
                else:
                    waiting.append((event, cb))
            if waiting:
                with self._cv:
                    self._entries.extendleft(reversed(waiting))
                self._wait(waiting[0][0])

    @staticmethod
    def _fire(cb) -> None:
        try:
            cb()
        except Exception:  # the poller must live
            log.exception("EventPoller callback failed")

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify()
        self._thread.join(timeout=10)
