"""tpulab_torch — the PyTorch/CUDA port of :mod:`tpulab` for NVIDIA Hopper.

The JAX package ``tpulab`` stays the reference; this package is its port,
module for module, with every Pallas TPU kernel on the ported path
replaced by a CUDA C++ kernel written for ``sm_90a``.  It imports
``torch`` and never ``jax`` or ``tpulab`` (``tests/test_torch_isolation.py``
holds that rule).

Layer map (mirrors tpulab's)::

    tpulab_torch.memory   the allocator framework (memory kinds,
                          descriptors, raw / block / arena / transactional /
                          best-fit allocators, trackers, shared memory)
    tpulab_torch.core     host runtime (pools, thread pools, batchers,
                          affinity, thread policies, dtypes, deadlines,
                          cyclic windowed streams)
    tpulab_torch.cuda     device layer (platform, DeviceInfo, memory kinds,
                          allocators and pinned staging, sync, copies,
                          transfers, the device windowed stack)
    tpulab_torch.models   transformer, ResNet, ViT, MNIST, the registry and
                          the weight bridge from tpulab trees
    tpulab_torch.ops      hand-written CUDA kernels and their plain versions
    tpulab_torch.engine   paged KV pool, paged programs, ContinuousBatcher;
                          the compiled-model path (Runtime, InferenceManager,
                          Buffers / Bindings, InferRunner, BatchedInferRunner,
                          InferBench)
    tpulab_torch.kvcache  the host KV tier (HostKVStore, KVOffloadManager)
    tpulab_torch.disagg   KV over the wire (KVShipper)
    tpulab_torch.hbm      the device-memory economy (DeviceHBMLedger,
                          HBMArbiter, MeasuredJit)
    tpulab_torch.modelstore  weight multiplexing (HostParamStore,
                          WeightMultiplexer and its adapters)
    tpulab_torch.engine.generation  the dense GenerationEngine (sessions)
    tpulab_torch.rpc      the RPC framework (Server, contexts, executors,
                          clients) and the inference service
                          (Status / Infer / StreamInfer / Health /
                          Generate), protobuf-free messages; grpc is the
                          transport only, imported when a server starts
    tpulab_torch.serving  admission control, the per-tenant fair queue
    tpulab_torch.utils    request tracing (torch.profiler, NVTX, Chrome
                          traces)
    tpulab_torch.tools    python -m tpulab_torch.tools.onnx_summary /
                          .build_engine (the import preflight, artifacts)

Top-level serving API (tpulab's quickstart)::

    manager = tpulab_torch.InferenceManager(max_exec_concurrency=4)
    manager.register_model("rn50", build_model(
        "resnet50", max_batch_size=128, input_dtype=np.uint8))
    manager.update_resources()
    logits = manager.infer_runner("rn50").infer(input=images).result()
    manager.serve(port=50051, batching=True)          # needs grpc
    remote = tpulab_torch.RemoteInferenceManager("localhost:50051")

Without grpc, ``serve`` raises the ImportError that
names it once the service is built; ``manager.server.invoke`` /
``invoke_stream`` then serve serialized requests in process.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU and no ``device="cpu"`` they raise.
The package import itself is lazy and loads nothing heavy.
"""

__version__ = "0.1.0"

_API_NAMES = ("InferenceManager", "RemoteInferenceManager", "serve")


def __getattr__(name):
    # lazy, so that importing a subpackage loads no engine
    if name in _API_NAMES:
        from tpulab_torch import _api
        return getattr(_api, name)
    raise AttributeError(f"module 'tpulab_torch' has no attribute {name!r}")
