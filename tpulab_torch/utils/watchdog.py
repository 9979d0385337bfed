"""Device watchdog: in-process wedge detection (the port of
``tpulab/utils/watchdog.py``).

Health probes (the Health RPC) need an in-process detector for the
failure where the process is alive but the device no longer completes
work.  :class:`DeviceWatchdog` runs a small canary product on the card
every ``period_s`` on a CUDA stream of its own, records an event behind
it and waits for that event on a probe thread; the watchdog thread keeps
the deadline.  A canary that misses ``deadline_s``, counted from the
time it fell due, flips ``healthy`` false (the Health RPC then reports
not-ready) until one completes again, so a wedge shows within
``period_s + deadline_s``.

The watchdog never synchronizes the device and never touches the default
stream: the only wait is on the canary stream's own event, so a serving
batcher's kernels are neither blocked nor fenced by it.  A canary still
outstanding at the next period is not stacked on (the wedged probe keeps
the watchdog unhealthy instead).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("tpulab_torch.utils")


def _canary(a):
    return (a @ a).sum()


class DeviceWatchdog:
    """Periodic canary dispatch with a completion deadline.

    ``device`` defaults to ``cuda:0`` (raises without a CUDA device);
    tests pass ``device="cpu"``, where the canary runs on the host.  The
    ``(fn, x)`` pair in ``_canary`` may be swapped while the watchdog
    runs (each probe reads it afresh); ``fn(x)`` is issued on the canary
    stream, and a result with a ``synchronize()`` method is also waited
    on (a canary may bring its own completion)."""

    def __init__(self, device=None, period_s: float = 10.0,
                 deadline_s: float = 30.0,
                 on_unhealthy: Optional[Callable[[str], None]] = None):
        self.period_s = period_s
        self.deadline_s = deadline_s
        self._on_unhealthy = on_unhealthy
        self._device = device
        self._healthy = True
        self._last_ok: Optional[float] = None
        self._reason = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._canary = None
        self._stream = None
        #: canaries completed within the deadline, and the last one's
        #: latency (issue -> event complete), seconds
        self.canaries = 0
        self.last_canary_s: Optional[float] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "DeviceWatchdog":
        import torch
        device = torch.device(self._device if self._device is not None
                              else "cuda:0")
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("DeviceWatchdog: no CUDA device (pass "
                                   "device='cpu' to watch the host)")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device)
        self._device = device
        with self._stream_ctx():
            x = torch.ones((8, 8), dtype=torch.float32, device=device)
        self._canary = (_canary, x)
        self._thread = threading.Thread(target=self._run, name="watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- state --------------------------------------------------------------
    @property
    def healthy(self) -> bool:
        return self._healthy

    @property
    def reason(self) -> str:
        return self._reason

    @property
    def seconds_since_ok(self) -> Optional[float]:
        return (None if self._last_ok is None
                else time.monotonic() - self._last_ok)

    # -- loop ---------------------------------------------------------------
    def _stream_ctx(self):
        import contextlib

        import torch
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _probe(self, fn, x) -> None:
        """Issue one canary on the canary stream and wait for ITS event
        (this thread only; nothing else is fenced)."""
        import torch
        with self._stream_ctx():
            out = fn(x)
            ev = None
            if self._stream is not None:
                ev = torch.cuda.Event()
                ev.record(self._stream)
        if ev is not None:
            ev.synchronize()
        wait = getattr(out, "synchronize", None)
        if callable(wait):
            wait()

    def _run(self) -> None:
        if self._stream is not None:
            import torch
            torch.cuda.set_device(self._device)
        due = time.monotonic()
        while True:
            # canaries fall due every period_s and each deadline counts
            # from its due time, so a slow earlier canary or a late probe
            # thread start does not stretch the time to detect a wedge
            # past period_s + deadline_s
            due = max(due + self.period_s, time.monotonic())
            if self._stop.wait(max(due - time.monotonic(), 0.0)):
                break
            # a still-running probe means the device is still wedged: do
            # NOT stack another thread on it
            if (self._probe_thread is not None
                    and self._probe_thread.is_alive()):
                self._mark_unhealthy(
                    f"canary still outstanding after {self.deadline_s}s+")
                continue
            fn, x = self._canary  # re-read: canaries are hot-swappable
            done = threading.Event()
            err = []

            def canary():
                try:
                    if self._stream is not None:
                        import torch
                        torch.cuda.set_device(self._device)
                    self._probe(fn, x)
                except Exception as e:  # noqa: BLE001
                    err.append(e)
                done.set()

            t0 = time.perf_counter()
            t = threading.Thread(target=canary, name="watchdog-canary",
                                 daemon=True)
            self._probe_thread = t
            t.start()
            left = due + self.deadline_s - time.monotonic()
            if not done.wait(max(left, 0.0)) or err:
                self._mark_unhealthy(
                    f"canary error: {err[0]}" if err else
                    f"canary exceeded {self.deadline_s}s deadline")
            else:
                self.last_canary_s = time.perf_counter() - t0
                self.canaries += 1
                if not self._healthy:
                    log.warning("device recovered")
                self._healthy = True
                self._reason = ""
                self._last_ok = time.monotonic()

    def _mark_unhealthy(self, reason: str) -> None:
        self._reason = reason
        if self._healthy:
            log.error("device unhealthy: %s", reason)
            self._healthy = False
            if self._on_unhealthy is not None:
                try:
                    self._on_unhealthy(reason)
                except Exception:  # noqa: BLE001 - a hook must not kill us
                    log.exception("on_unhealthy hook failed")
