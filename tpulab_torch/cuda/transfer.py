"""Device<->host transfers on a side CUDA stream (the port of
``tpulab/tpu/transfer.py`` and ``tpulab/tpu/copy.py``).

:class:`TransferEngine` runs the write-behind copies of the host KV
tier.  ``fetch(tensor)`` is called on the thread that produced
``tensor`` (the batcher's scheduler thread): it records an event on that
thread's current stream, makes a side stream wait on it, and enqueues
the device-to-host copy there into page-locked memory — so the copy
starts only after the work that produced the tensor, and the producer's
stream never waits for it.  A collector thread waits on each copy's
completion event and settles its future with the host tensor.  The
source tensor stays referenced until that event has completed, so the
caching allocator cannot hand its memory to later work first.
``put(tensor, device)`` is the same in the other direction.  A CPU
tensor needs no stream: its future settles with a copy.

Current streams are per thread, which is why the event is recorded by
the caller and never by the collector: an event on the collector's own
current stream would order nothing.

tpulab's ``"stack"`` mode (stacking same-shape leaves on the device to
fetch them in one PjRt round trip) answers a cost of TPU runtimes that
CUDA copies do not have, and is not carried; neither are pytrees (each
call moves one tensor).
"""

from __future__ import annotations

import collections
import logging
import threading
from concurrent.futures import Future
from typing import Deque, Dict, Optional, Tuple

import torch

from tpulab_torch.cuda.platform import resolve_device

log = logging.getLogger("tpulab_torch.cuda")


class TransferEngine:
    """Asynchronous device<->host copies settled by a collector thread."""

    def __init__(self, name: str = "d2h"):
        #: entries: (completion event or None, source, destination, future)
        self._queue: Deque[Tuple] = collections.deque()
        self._cv = threading.Condition()
        self._shutdown = False
        self._streams: Dict[int, "torch.cuda.Stream"] = {}
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # -- public API ---------------------------------------------------------
    def fetch(self, tensor: torch.Tensor) -> Future:
        """Device -> host: the future settles with a host tensor (pinned
        for a CUDA source) once the copy has completed."""
        self._check_open()
        if not tensor.is_cuda:
            return self._enqueue(None, tensor, None)
        side = self._side_stream(tensor.device)
        side.wait_event(torch.cuda.current_stream(tensor.device)
                        .record_event())
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            host.copy_(tensor, non_blocking=True)
        return self._enqueue(side.record_event(), tensor, host)

    def put(self, tensor: torch.Tensor, device=None) -> Future:
        """Host -> ``device`` (default: the CUDA card): the future settles
        with the device tensor once the copy has completed.  The result
        is allocated on the caller's current stream."""
        self._check_open()
        dev = resolve_device(device)
        if dev.type != "cuda":
            return self._enqueue(None, tensor, None, dev)
        out = torch.empty(tensor.shape, dtype=tensor.dtype, device=dev)
        side = self._side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out.copy_(tensor, non_blocking=True)
        return self._enqueue(side.record_event(), tensor, out)

    @property
    def backlog(self) -> int:
        """Copies enqueued and not yet settled."""
        with self._cv:
            return len(self._queue)

    def shutdown(self) -> None:
        """Settle what is queued, then stop the collector."""
        with self._cv:
            self._shutdown = True
            self._cv.notify()
        self._thread.join(timeout=10)

    # -- internals ------------------------------------------------------------
    def _check_open(self) -> None:
        with self._cv:
            if self._shutdown:
                raise RuntimeError("TransferEngine is shut down")

    def _side_stream(self, device: torch.device) -> "torch.cuda.Stream":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        with self._cv:
            stream = self._streams.get(index)
            if stream is None:
                stream = torch.cuda.Stream(device=index)
                self._streams[index] = stream
            return stream

    def _enqueue(self, done, src, dst, cpu_target=None) -> Future:
        fut: Future = Future()
        with self._cv:
            self._queue.append((done, src, dst if dst is not None
                                else cpu_target, fut))
            self._cv.notify()
        return fut

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._cv.wait()
                if not self._queue:
                    return
                done, src, dst, fut = self._queue.popleft()
            value = None
            try:
                if done is not None:
                    done.synchronize()
                    value = dst
                elif dst is None:          # a CPU fetch
                    value = src.detach().clone()
                else:                      # a put to a CPU device
                    value = src.detach().to(dst, copy=True)
            except Exception as e:  # noqa: BLE001 - the collector must live
                log.exception("transfer failed")
                fut.set_exception(e)
            else:
                fut.set_result(value)
            # the source may be reused only now: its copy has completed
            src = dst = value = None


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
