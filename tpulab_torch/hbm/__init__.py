"""tpulab_torch.hbm — the device-memory economy (the port of
``tpulab/hbm``).

Three tenants rent one card's memory: the
:class:`~tpulab_torch.engine.paged.PagedKVPool` pages (the KV tenant,
elastic under an arbiter), the
:class:`~tpulab_torch.modelstore.WeightMultiplexer`'s hot weights (the
weights tenant) and the serving programs' scratch.  This package is
their common ground:

- :class:`DeviceHBMLedger` — a byte-accurate ledger of ``(tenant, tag)``
  claims, each mirroring a tracked allocation, verifiable against the
  tenants' gauges at any time.
- :class:`HBMArbiter` — the pressure protocol: a hot model needing
  residency can force idle KV to demote to the host tier, a KV burst can
  evict a cold unleased model, and an admission frontend reads ONE
  headroom number.
- :class:`MeasuredJit` — per-program scratch, measured on the CUDA
  allocator at a shape key's first call; a :class:`ScratchGroup` (one
  batcher's programs) claims the largest of its keys, not their sum.

Wire-up: ``ContinuousBatcher(..., hbm=arb)`` (the KV tenant) and
``WeightMultiplexer(..., hbm=arb)`` (the weights tenant).  The bench
row: :func:`benchmark_hbm_arbiter` (``tpulab_torch/hbm/arbiter.py``),
arbiter on against a static split.  tpulab's ``scratch_bytes_of`` (an
XLA executable's compile-time temp bytes) has no eager counterpart.
"""

from tpulab_torch.hbm.arbiter import (KV_TENANT, SCRATCH_TENANT,  # noqa: F401
                                      WEIGHTS_TENANT, HBMArbiter,
                                      benchmark_hbm_arbiter)
from tpulab_torch.hbm.ledger import DeviceHBMLedger  # noqa: F401
from tpulab_torch.hbm.scratch import MeasuredJit, ScratchGroup  # noqa: F401

__all__ = ["DeviceHBMLedger", "HBMArbiter", "MeasuredJit", "ScratchGroup",
           "KV_TENANT", "WEIGHTS_TENANT", "SCRATCH_TENANT",
           "benchmark_hbm_arbiter"]
