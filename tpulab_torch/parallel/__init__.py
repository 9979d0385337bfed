"""tpulab_torch.parallel — meshes, shardings and multi-device execution on
``torch.distributed`` (the port of :mod:`tpulab.parallel`).

tpulab's meshes are JAX device grids and its bodies ``shard_map`` s that
XLA schedules; the port's meshes are ``DeviceMesh`` es over process-group
ranks (NCCL on the card, gloo when a caller asks for the CPU), its
layouts DTensor placements, and its per-rank bodies call c10d
collectives themselves:

- :mod:`mesh` — meshes over the ranks (``data`` / ``model`` by default)
- :mod:`sharding` — placements from PartitionSpec-like tuples, the
  Megatron rules for transformer params, sharding a full tensor
- :mod:`dispatch` — one manager per device, round-robin / least-loaded
- :mod:`ring_attention` — ring and Ulysses sequence parallelism
- :mod:`training` — the sharded train step (dp batch x tp params)
- :mod:`moe` — MoE FFN + expert parallelism (``all_reduce`` combine)
- :mod:`pipeline` — GPipe microbatch streaming
- :mod:`multihost` — process-group bootstrap, global meshes, barriers,
  local launches
- :mod:`checkpoint` — train-state checkpoint / resume on DCP (sharded,
  async, cross-mesh restore)
- :mod:`dryrun` — ``python -m tpulab_torch.parallel.dryrun --nproc N``
"""

from tpulab_torch.parallel import multihost
from tpulab_torch.parallel.checkpoint import TrainCheckpointer, abstract_like
from tpulab_torch.parallel.dispatch import MultiDeviceDispatcher
from tpulab_torch.parallel.mesh import default_mesh, make_mesh
from tpulab_torch.parallel.moe import make_expert_parallel_ffn
from tpulab_torch.parallel.pipeline import make_pipeline
from tpulab_torch.parallel.ring_attention import (ring_attention,
                                                  ulysses_attention)
from tpulab_torch.parallel.sharding import (kv_pool_sharding, named_sharding,
                                            replicate, shard_batch,
                                            transformer_param_shardings)
from tpulab_torch.parallel.training import make_sharded_train_step

__all__ = [
    "make_mesh", "default_mesh",
    "named_sharding", "replicate", "shard_batch",
    "kv_pool_sharding", "transformer_param_shardings",
    "MultiDeviceDispatcher",
    "TrainCheckpointer", "abstract_like",
    "ring_attention", "ulysses_attention", "make_expert_parallel_ffn",
    "make_pipeline", "make_sharded_train_step", "multihost",
]
