"""tpulab_torch — the PyTorch/CUDA port of :mod:`tpulab` for NVIDIA Hopper.

The JAX package ``tpulab`` stays the reference; this package is its port,
module for module, with every Pallas TPU kernel on the ported path
replaced by a CUDA C++ kernel written for ``sm_90a``.  It imports
``torch`` and never ``jax`` or ``tpulab`` (``tests/test_torch_isolation.py``
holds that rule).

Layer map (mirrors tpulab's)::

    tpulab_torch.core     host utilities (deadlines, pools, thread pools)
    tpulab_torch.cuda     device layer (platform, allocators, sync, transfers)
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

Top-level serving API (tpulab's quickstart)::

    manager = tpulab_torch.InferenceManager(max_exec_concurrency=4)
    manager.register_model("rn50", build_model(
        "resnet50", max_batch_size=128, input_dtype=np.uint8))
    manager.update_resources()
    logits = manager.infer_runner("rn50").infer(input=images).result()

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
