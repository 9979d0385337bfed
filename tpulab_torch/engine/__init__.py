"""Serving engines of the port: the paged KV pool, paged programs and
``ContinuousBatcher`` (``paged``); the compiled-model path (``model``,
``runtime``, ``execution_context``, ``buffers``, ``inference_manager``,
``infer_runner``, ``batched_runner``, ``infer_bench``, ``workspace``),
whose names this package exports as tpulab's ``engine`` does."""

from tpulab_torch.engine.model import IOSpec, Model, default_batch_buckets
from tpulab_torch.engine.runtime import CompiledModel, Runtime
from tpulab_torch.engine.execution_context import ExecutionContext
from tpulab_torch.engine.buffers import Bindings, Buffers
from tpulab_torch.engine.inference_manager import InferenceManager
from tpulab_torch.engine.infer_runner import InferRunner
from tpulab_torch.engine.infer_bench import InferBench
from tpulab_torch.engine.workspace import (BenchmarkWorkspace,
                                           StaticSingleModelGraphWorkspace,
                                           TimedBenchmarkWorkspace)

__all__ = [
    "IOSpec", "Model", "default_batch_buckets",
    "Runtime", "CompiledModel",
    "ExecutionContext",
    "Buffers", "Bindings",
    "InferenceManager", "InferRunner", "InferBench",
    "StaticSingleModelGraphWorkspace", "BenchmarkWorkspace",
    "TimedBenchmarkWorkspace",
]
