"""InferBench: saturating throughput and closed-loop latency (the port of
``tpulab/engine/infer_bench.py``; the same metric maps)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np


class InferBench:
    """Timed benchmark loops over a registered model."""

    def __init__(self, manager):
        self._mgr = manager

    def run(self, model_name: str, batch_size: int = 1,
            seconds: float = 5.0, warmup: int = 8,
            depth: Optional[int] = None) -> Dict[str, float]:
        """Keep ``depth`` requests in flight (default: the buffers pool's
        size) for ``seconds``; returns batch_size, max_concurrency,
        batches_computed, walltime_s, batches_per_second,
        inferences_per_second and execution_time_per_batch_ms."""
        runner = self._mgr.infer_runner(model_name)
        model = self._mgr.model(model_name)
        inputs = {
            s.name: np.random.default_rng(0).standard_normal(
                s.batched_shape(batch_size)).astype(s.np_dtype)
            for s in model.inputs
        }
        # a full pipeline of slow batches (CPU runs) can take minutes to
        # drain: scale the per-future timeout with the run
        timeout_s = max(300.0, 60.0 * seconds)
        for _ in range(warmup):
            runner.infer(**inputs).result(timeout=timeout_s)

        inflight: List = []
        max_inflight = depth or self._mgr.max_buffers
        batches = 0
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            while len(inflight) >= max_inflight:
                inflight.pop(0).result(timeout=timeout_s)
                batches += 1
            inflight.append(runner.infer(**inputs))
        for f in inflight:
            f.result(timeout=timeout_s)
            batches += 1
        walltime = time.perf_counter() - start

        batches_per_sec = batches / walltime
        return {
            "batch_size": batch_size,
            "max_concurrency": float(max_inflight),
            "batches_computed": float(batches),
            "walltime_s": walltime,
            "batches_per_second": batches_per_sec,
            "inferences_per_second": batches_per_sec * batch_size,
            "execution_time_per_batch_ms": 1000.0 / batches_per_sec,
        }

    def latency(self, model_name: str, batch_size: int = 1,
                iterations: int = 100) -> Dict[str, float]:
        """Closed-loop latency percentiles: one request at a time, submit
        to result; returns batch_size, iterations, p50_ms, p90_ms, p99_ms
        and mean_ms."""
        runner = self._mgr.infer_runner(model_name)
        model = self._mgr.model(model_name)
        inputs = {
            s.name: np.zeros(s.batched_shape(batch_size), s.np_dtype)
            for s in model.inputs
        }
        for _ in range(8):
            runner.infer(**inputs).result(timeout=120)
        lats = []
        for _ in range(iterations):
            t0 = time.perf_counter()
            runner.infer(**inputs).result(timeout=120)
            lats.append((time.perf_counter() - t0) * 1000.0)
        arr = np.asarray(lats)
        return {
            "batch_size": batch_size,
            "iterations": iterations,
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "p99_ms": float(np.percentile(arr, 99)),
            "mean_ms": float(arr.mean()),
        }
