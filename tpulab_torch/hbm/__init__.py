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
- :class:`MeasuredJit` — per-program scratch claims, measured on the
  CUDA allocator at a shape key's first call.

Wire-up: ``ContinuousBatcher(..., hbm=arb)`` (the KV tenant) and
``WeightMultiplexer(..., hbm=arb)`` (the weights tenant).  tpulab's
``benchmark_hbm_arbiter`` and ``scratch_bytes_of`` (an XLA executable's
compile-time temp bytes) are not ported: the first waits for the port's
bench (ROADMAP queue 1, item 4), the second has no eager counterpart.
"""

from tpulab_torch.hbm.arbiter import (KV_TENANT, SCRATCH_TENANT,  # noqa: F401
                                      WEIGHTS_TENANT, HBMArbiter)
from tpulab_torch.hbm.ledger import DeviceHBMLedger  # noqa: F401
from tpulab_torch.hbm.scratch import MeasuredJit  # noqa: F401

__all__ = ["DeviceHBMLedger", "HBMArbiter", "MeasuredJit",
           "KV_TENANT", "WEIGHTS_TENANT", "SCRATCH_TENANT"]
