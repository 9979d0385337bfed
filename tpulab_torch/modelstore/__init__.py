"""tpulab_torch.modelstore — multi-model serving: weight multiplexing over
the host tier (the port of ``tpulab/modelstore``).

N registered models (the LLM behind a paged batcher, ResNet and ViT
compiled models, int8 variants) share one card's memory: cold weights sit
in the budgeted host tier (:class:`HostParamStore`, page-locked blocks of
the tracked host allocator, like the KV tier's), and hot models are
swapped in and out by :class:`WeightMultiplexer` over the same
write-behind :class:`~tpulab_torch.cuda.transfer.TransferEngine` the KV
offload manager uses.  With an :class:`~tpulab_torch.hbm.HBMArbiter` the
multiplexer is the economy's weights tenant.  tpulab's
``benchmark_multi_model`` waits for the port's bench (ROADMAP queue 1,
item 4).
"""

from tpulab_torch.modelstore.host_store import (  # noqa: F401
    DEFAULT_HOST_BUDGET, HostParamStore, tree_nbytes)
from tpulab_torch.modelstore.multiplexer import (  # noqa: F401
    BatcherAdapter, CompiledModelAdapter, ModelLease, WeightMultiplexer)

__all__ = [
    "DEFAULT_HOST_BUDGET",
    "HostParamStore",
    "tree_nbytes",
    "BatcherAdapter",
    "CompiledModelAdapter",
    "ModelLease",
    "WeightMultiplexer",
]
