"""tpulab_torch.kvcache — tiered KV cache: the host-memory offload tier
(the port of ``tpulab/kvcache``).

Pool pressure used to destroy state (preempted requests re-prefilled,
evicted prefix-cache entries vanished); this package demotes that state
to a budgeted host-RAM tier and promotes it back — recompute-free
preemption and a spill-backed prefix cache.

- :class:`HostKVStore` — budgeted LRU host tier on the tracked host
  allocator (page-locked blocks in front of a CUDA pool).
- :class:`KVOffloadManager` — asynchronous device<->host swap policy
  over a :class:`~tpulab_torch.engine.paged.PagedKVPool`, riding the
  :class:`~tpulab_torch.cuda.transfer.TransferEngine` (write-behind
  swap-out on a side stream).

Wire-up: ``ContinuousBatcher(..., kv_offload=...)`` (True / budget bytes
/ a manager instance).  The bench row: :func:`benchmark_kv_offload`
(``tpulab_torch/kvcache/offload.py``), host tier on against off under
~2x KV oversubscription.
"""

from tpulab_torch.kvcache.host_store import HostKVStore  # noqa: F401
from tpulab_torch.kvcache.offload import (DEFAULT_HOST_BUDGET,  # noqa: F401
                                          KVOffloadManager, SwapHandle,
                                          benchmark_kv_offload)

__all__ = ["HostKVStore", "KVOffloadManager", "SwapHandle",
           "DEFAULT_HOST_BUDGET", "benchmark_kv_offload"]
