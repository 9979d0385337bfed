"""Device<->host transfers on a side CUDA stream (the port of
``tpulab/tpu/transfer.py``; the plain copies of ``tpulab/tpu/copy.py``
live in :mod:`tpulab_torch.cuda.copy` and are re-exported here).

:class:`TransferEngine` runs the write-behind copies of the host KV tier
and the device-to-host copies of the infer pipeline.  ``fetch(tree)`` is
called on the thread that produced the tree's tensors, with the stream
that produced them current (the batcher's scheduler thread; an execution
context's stream on the infer path): it records an event on that
stream, makes a side stream wait on it, and enqueues the device-to-host
copies there into page-locked memory (or into ``out``, host tensors the
caller owns, such as a staging block) — so the copies start only after
the work that produced the tensors, and the producer's stream never
waits for them.  A collector thread waits on the copies' completion
event and settles the future with the same tree of host tensors.  The
source tensors stay referenced until that event has completed, so the
caching allocator cannot hand their memory to later work first.
``put(tree, device)`` is the same in the other direction.  CPU tensors
need no stream: the collector copies them.  A tree is a tensor or a
(nested) dict of tensors.

Current streams are per thread, which is why the event is recorded by
the caller and never by the collector: an event on the collector's own
current stream would order nothing.

tpulab's ``"stack"`` mode (stacking same-shape leaves on the device to
fetch them in one PjRt round trip) and its coalesced puts (one
``device_put`` per collector cycle) answer costs of TPU runtimes that
CUDA copies do not have, and are not carried (ROADMAP decisions).
"""

from __future__ import annotations

import collections
import logging
import threading
from concurrent.futures import Future
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch

from tpulab_torch.cuda.copy import (  # noqa: F401 (re-exported)
    copy_device_to_device, copy_to_device, copy_to_host)
from tpulab_torch.cuda.platform import resolve_device

log = logging.getLogger("tpulab_torch.cuda")


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable]:
    """A tree's tensor leaves and the function that rebuilds the tree
    from a list of new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if not isinstance(tree, dict):
        raise TypeError(f"not a tensor tree: {type(tree).__name__}")
    leaves: List[torch.Tensor] = []
    parts = []          # (key, leaf count, rebuild): never the leaves
    for k, v in tree.items():
        sub, fn = _flatten(v)
        leaves += sub
        parts.append((k, len(sub), fn))

    def rebuild(new: List[Any]) -> Dict[str, Any]:
        out, i = {}, 0
        for k, n, fn in parts:
            out[k] = fn(new[i:i + n])
            i += n
        return out

    return leaves, rebuild


def _dense(t: torch.Tensor) -> bool:
    """A layout a copy can keep: contiguous, or channels-last (the
    compiled models' convolution kernels)."""
    return t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))


def host_like(src: torch.Tensor, pinned: bool) -> torch.Tensor:
    """An uninitialised host tensor of ``src``'s shape and dtype, with
    its strides when its layout is dense (a channels-last weight stays
    channels-last through a round trip), page-locked when ``pinned``."""
    if _dense(src):
        return torch.empty_strided(src.shape, src.stride(), dtype=src.dtype,
                                   pin_memory=pinned)
    return torch.empty(src.shape, dtype=src.dtype, pin_memory=pinned)


class TransferEngine:
    """Asynchronous device<->host copies settled by a collector thread."""

    def __init__(self, name: str = "d2h"):
        #: entries: (completion event or None, [(source, destination or
        #: None, copied on a stream)], rebuild, future)
        self._queue: Deque[Tuple] = collections.deque()
        self._cv = threading.Condition()
        self._shutdown = False
        self._streams: Dict[int, "torch.cuda.Stream"] = {}
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # -- public API ---------------------------------------------------------
    def fetch(self, tree: Any, out: Any = None) -> Future:
        """Device -> host: the future settles with the same tree of host
        tensors (pinned for CUDA sources, or ``out``'s tensors, a tree of
        the same structure) once every copy has completed."""
        self._check_open()
        leaves, rebuild = _flatten(tree)
        outs = _flatten(out)[0] if out is not None else [None] * len(leaves)
        pairs, done = [], None
        cuda = [t for t in leaves if t.is_cuda]
        if cuda:
            side = self._side_stream(cuda[0].device)
            side.wait_event(torch.cuda.current_stream(cuda[0].device)
                            .record_event())
        for src, dst in zip(leaves, outs):
            if not src.is_cuda:
                pairs.append((src, dst, False))  # the collector copies it
                continue
            if dst is None:
                dst = host_like(src, pinned=True)
            with torch.cuda.stream(side):
                dst.copy_(src, non_blocking=True)
            pairs.append((src, dst, True))
        if cuda:
            done = side.record_event()
        return self._enqueue(done, pairs, rebuild)

    def fetch_sync(self, tree: Any, timeout: Optional[float] = None) -> Any:
        """:meth:`fetch` and wait for its result."""
        return self.fetch(tree).result(timeout)

    def put(self, tree: Any, device=None) -> Future:
        """Host -> ``device`` (default: the CUDA card): the future settles
        with the device tree once every copy has completed.  The results
        are allocated on the caller's current stream."""
        self._check_open()
        dev = resolve_device(device)
        leaves, rebuild = _flatten(tree)
        if dev.type != "cuda":          # the CPU: the collector copies
            return self._enqueue(None, [(t, None, False) for t in leaves],
                                 rebuild)
        outs = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                for t in leaves]
        side = self._side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for src, dst in zip(leaves, outs):
                dst.copy_(src, non_blocking=True)
        return self._enqueue(side.record_event(),
                             [(s, d, True) for s, d in zip(leaves, outs)],
                             rebuild)

    @property
    def backlog(self) -> int:
        """Transfers enqueued and not yet settled."""
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

    def _enqueue(self, done, pairs, rebuild) -> Future:
        fut: Future = Future()
        with self._cv:
            self._queue.append((done, pairs, rebuild, fut))
            self._cv.notify()
        return fut

    @staticmethod
    def _settle_pair(src, dst, copied):
        if copied:                   # on the side stream, now complete
            return dst
        if dst is None:              # a CPU fetch or a put to the CPU
            return src.detach().clone()
        return dst.copy_(src)        # a CPU fetch into ``out``

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._cv.wait()
                if not self._queue:
                    return
                done, pairs, rebuild, fut = self._queue.popleft()
            try:
                if done is not None:
                    done.synchronize()
                value = rebuild([self._settle_pair(*p) for p in pairs])
            except Exception as e:  # noqa: BLE001 - the collector must live
                log.exception("transfer failed")
                pairs = None
                fut.set_exception(e)
            else:
                # the sources may be reused only now (their copies
                # completed): drop them before the future settles, so a
                # callback that releases their accounting finds them freed
                pairs = None
                fut.set_result(value)
            value = rebuild = None
