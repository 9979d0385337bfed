"""tpulab_torch.obs — per-request wide events and live engine
introspection (the port of ``tpulab/obs``).

- :class:`FlightRecorder` (flight.py): ONE structured wide event per
  request, tail-sampled — errors, deadline / overload outcomes, stalls,
  chaos-hit requests and the rolling slowest-p99 exemplars always survive
  the bounded ring; healthy traffic is uniformly sampled.
- :func:`debug_snapshot` (debugz.py): the live "what is the engine
  holding right now" document — lanes, the pool's size ladder, HBM
  ledger claims and verify, modelstore leases, admission queue depths,
  chaos armament, flight exemplar pointers — served over the ``Debug``
  RPC with an on-demand ``torch.profiler`` capture (:func:`arm_profile`).
- :class:`SLOTracker` (slo.py): per-tenant availability / latency error
  budgets over fast and slow burn-rate windows, fed from the flight-event
  stream (``flight.add_tap``).
- :func:`benchmark_obs_overhead` (bench.py): what arming all of it costs.

tpulab's ``EventJournal`` (the fleet control plane's decision log) comes
with the fleet (ROADMAP queue 1, item 5).
"""

from tpulab_torch.obs.bench import benchmark_obs_overhead  # noqa: F401
from tpulab_torch.obs.debugz import arm_profile, debug_snapshot  # noqa: F401
from tpulab_torch.obs.flight import KEEP_REASONS, FlightRecorder  # noqa: F401
from tpulab_torch.obs.slo import SLOTracker  # noqa: F401

__all__ = ["FlightRecorder", "KEEP_REASONS", "debug_snapshot",
           "arm_profile", "benchmark_obs_overhead", "SLOTracker"]
