"""Multi-device serving dispatch: one manager per device, round robin or
least loaded (the port of ``tpulab/parallel/dispatch.py``).

Each device gets its own :class:`~tpulab_torch.engine.inference_manager.
InferenceManager` (its own weight copy and pools); the dispatcher routes
each request to one of them.  Two entries may name the same card: two
managers then share it.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future
from typing import Callable, Optional, Sequence


class MultiDeviceDispatcher:
    """Round-robin / least-loaded request router over per-device
    managers."""

    def __init__(self, managers: Sequence, policy: str = "round_robin"):
        if not managers:
            raise ValueError("need at least one manager")
        if policy not in ("round_robin", "least_loaded"):
            raise ValueError(f"unknown policy {policy!r}")
        self._managers = list(managers)
        self._policy = policy
        self._rr = itertools.cycle(range(len(self._managers)))
        self._inflight = [0] * len(self._managers)
        self._lock = threading.Lock()

    @classmethod
    def create(cls, model_builder: Callable[[], object], model_name: str,
               devices: Optional[Sequence] = None, max_executions: int = 2,
               policy: str = "round_robin") -> "MultiDeviceDispatcher":
        """One manager per entry of ``devices`` (default: every CUDA
        card; raises without one), each registering ``model_builder()``."""
        from tpulab_torch.cuda.platform import default_device, device_count
        from tpulab_torch.engine.inference_manager import InferenceManager

        if devices is None:
            default_device()
            devices = [f"cuda:{i}" for i in range(device_count())]
        managers = []
        try:
            for d in devices:
                mgr = InferenceManager(max_executions=max_executions,
                                       device=d)
                managers.append(mgr)
                mgr.register_model(model_name, model_builder())
                mgr.update_resources()
        except BaseException:
            for m in managers:
                m.shutdown()
            raise
        return cls(managers, policy)

    @property
    def device_count(self) -> int:
        return len(self._managers)

    def _pick(self) -> int:
        with self._lock:
            if self._policy == "least_loaded":
                return min(range(len(self._managers)),
                           key=lambda i: self._inflight[i])
            return next(self._rr)

    def inflight(self):
        """Requests in flight per manager."""
        with self._lock:
            return list(self._inflight)

    def infer(self, model_name: str, **arrays) -> Future:
        """Route one request to a device; returns the request future."""
        i = self._pick()
        with self._lock:
            self._inflight[i] += 1
        try:
            fut = self._managers[i].infer_runner(model_name).infer(**arrays)
        except BaseException:
            with self._lock:
                self._inflight[i] -= 1
            raise

        def _done(_f):
            with self._lock:
                self._inflight[i] -= 1
        fut.add_done_callback(_done)
        return fut

    def manager(self, i: int):
        return self._managers[i]

    def shutdown(self) -> None:
        for m in self._managers:
            m.shutdown()
