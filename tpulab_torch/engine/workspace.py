"""Workspaces: pre-bound single-model execution (the port of
``tpulab/engine/workspace.py``).

- :class:`StaticSingleModelGraphWorkspace` — one bucket's inputs bound to
  fixed device buffers and its forward warmed.  On the card the forward
  is captured into a ``torch.cuda.CUDAGraph`` after a warm-up on a side
  stream (the reference captures ``enqueueV2`` into a cudaGraph, so each
  ``enqueue`` is one graph launch); the device inputs are the graph's
  static buffers, so new inputs are copied INTO them (tpulab rebinds the
  names to new arrays, which a graph cannot follow), and every replay
  writes the same output buffers.  A capture that fails raises: there is
  no eager fallback.  On the CPU ``enqueue`` runs the bucket's program.
- :class:`BenchmarkWorkspace` — adds page-locked host mirrors from the
  port's staging allocator and the copies between them and the bound
  buffers.
- :class:`TimedBenchmarkWorkspace` — per-stage times of one run: CUDA
  events on the card (the reference's cudaEvent timing), the host clock
  around each blocking stage on the CPU.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from tpulab_torch.cuda.allocators import HostRawAllocator
from tpulab_torch.cuda.sync import cuda_sync_standard
from tpulab_torch.engine.model import Model
from tpulab_torch.engine.runtime import (CompiledModel, Runtime, torch_dtype,
                                         zero_inputs)

#: forwards run on the side stream before the capture (the allocator's
#: and the libraries' first-call work happens there, not in the graph)
WARMUP_RUNS = 2


class StaticSingleModelGraphWorkspace:
    """Pre-bound, warmed, fixed-batch workspace; on the card one CUDA
    graph replay per :meth:`enqueue`."""

    def __init__(self, model: Model, batch_size: int = 0, device=None,
                 compiled: Optional[CompiledModel] = None):
        self.batch_size = batch_size or model.max_batch_size
        self.bucket = model.pick_bucket(self.batch_size)
        self.model = model
        self._compiled = compiled or Runtime(device).compile_model(
            model, buckets=[self.bucket])
        self.device = self._compiled.device
        #: the bound device inputs (the graph's static input buffers)
        self.device_inputs: Dict[str, torch.Tensor] = zero_inputs(
            model, self.bucket, self.device)
        self.device_outputs: Dict[str, torch.Tensor] = {}
        #: the captured forward (None on the CPU)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self._graph_outputs: Dict[str, torch.Tensor] = {}
        self.warmup()

    def _forward(self) -> Dict[str, torch.Tensor]:
        return self._compiled(self.bucket, self.device_inputs)

    def warmup(self) -> None:
        """On the card: forwards on a side stream, then the capture of one
        into :attr:`graph` (its outputs become the workspace's output
        buffers).  On the CPU: one forward."""
        if self.device.type != "cuda":
            self._forward()
            return
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    self._forward()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._graph_outputs = self._forward()
            self.graph = graph

    def enqueue(self) -> Dict[str, torch.Tensor]:
        """One launch over the bound inputs on the current stream (the
        graphLaunch analog); returns the output buffers, which the next
        launch overwrites."""
        if self.graph is None:
            self.device_outputs = self._forward()
        else:
            self.graph.replay()
            self.device_outputs = self._graph_outputs
        return self.device_outputs

    def synchronize(self) -> None:
        cuda_sync_standard(self.device_outputs)


class BenchmarkWorkspace(StaticSingleModelGraphWorkspace):
    """Adds page-locked host mirrors and the copies to and from the bound
    buffers."""

    def __init__(self, model: Model, batch_size: int = 0, device=None,
                 compiled: Optional[CompiledModel] = None):
        super().__init__(model, batch_size, device, compiled)
        #: the staging allocator that owns the host mirrors
        self.host_allocator = HostRawAllocator(
            pinned=self.device.type == "cuda")
        self.host_input_tensors: Dict[str, torch.Tensor] = {}
        self.host_output_tensors: Dict[str, torch.Tensor] = {}
        for specs, views in ((model.inputs, self.host_input_tensors),
                             (model.outputs, self.host_output_tensors)):
            for s in specs:
                _, views[s.name] = self.host_allocator.allocate_array(
                    s.batched_shape(self.bucket), torch_dtype(s.np_dtype))
        #: numpy views of the host mirrors (the caller's side)
        self.host_inputs: Dict[str, np.ndarray] = {
            n: t.numpy() for n, t in self.host_input_tensors.items()}
        self.host_outputs: Dict[str, np.ndarray] = {
            n: t.numpy() for n, t in self.host_output_tensors.items()}

    def async_h2d(self) -> None:
        """Host mirrors -> the bound device inputs, in place, on the
        current stream."""
        for name, host in self.host_input_tensors.items():
            self.device_inputs[name].copy_(host, non_blocking=True)

    def _copy_out(self) -> None:
        for name, dev in self.device_outputs.items():
            if name in self.host_output_tensors:
                self.host_output_tensors[name].copy_(dev, non_blocking=True)

    def async_d2h(self) -> None:
        """Device outputs -> host mirrors on the current stream; returns
        once they have landed (tpulab's ``copy_to_host`` blocks)."""
        self._copy_out()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def run(self) -> None:
        self.async_h2d()
        self.enqueue()
        self.async_d2h()


class TimedBenchmarkWorkspace(BenchmarkWorkspace):
    """Per-stage timings of one run (tpulab's keys)."""

    def timed_run(self) -> Dict[str, float]:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            self.async_h2d()
            t1 = time.perf_counter()
            self.enqueue()
            t2 = time.perf_counter()
            self.async_d2h()
            t3 = time.perf_counter()
            return {"h2d_ms": (t1 - t0) * 1e3,
                    "compute_ms": (t2 - t1) * 1e3,
                    "d2h_ms": (t3 - t2) * 1e3,
                    "total_ms": (t3 - t0) * 1e3}
        with torch.cuda.device(self.device):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            self.async_h2d()
            ev[1].record()
            self.enqueue()
            ev[2].record()
            self._copy_out()
            ev[3].record()
            ev[3].synchronize()
        return {"h2d_ms": ev[0].elapsed_time(ev[1]),
                "compute_ms": ev[1].elapsed_time(ev[2]),
                "d2h_ms": ev[2].elapsed_time(ev[3]),
                "total_ms": ev[0].elapsed_time(ev[3])}
