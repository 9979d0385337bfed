"""Fleet layer: prefix-affinity routing, queue-wait-driven autoscaling
and the process-boundary control plane — the scheduling layer ABOVE the
replica sets (the port of ``tpulab/fleet``).

- :mod:`tpulab_torch.fleet.router` — rendezvous (HRW) hashing over the
  prompt-prefix digest with load-aware spill-over: the fleet behaves
  like one large prefix cache, and membership changes move only ~1/N of
  digests (measured: ``ring_moves``).
- :mod:`tpulab_torch.fleet.autoscaler` — scale-up on admission
  queue-wait EWMA / overload fast-fails, scale-down by drain-before-
  retire over a pluggable :class:`ReplicaProvider`, batch work drained
  first (``batch_drain``).
- :mod:`tpulab_torch.fleet.process` + :mod:`tpulab_torch.fleet.replica_main`
  — replicas as REAL processes: spawn gated on the first successful
  Status RPC, drain as preStop (SIGUSR1 → ``InferenceManager.drain``),
  retire as SIGTERM→grace→SIGKILL.
- :mod:`tpulab_torch.fleet.supervisor` — self-healing membership:
  drain-vs-death classification, exponential-backoff respawn,
  crash-loop quarantine.
- :mod:`tpulab_torch.fleet.election` + :mod:`tpulab_torch.fleet.control`
  — lease-based leader election with fencing tokens so N concurrent
  routers share one membership view and exactly ONE runs the
  supervisor/autoscaler; followers converge on the leader's published
  snapshot and take over within one lease TTL.
- :mod:`tpulab_torch.fleet.observer` — telemetry federation: the
  :class:`FleetObserver` assembles ONE fleet snapshot (``fleetz``) over
  the Status/Debug RPCs, refreshes the replica-labeled ``_fed_*``
  gauges, and merges per-replica Chrome traces / flight dumps onto one
  wall-clock timeline.  Control-plane decisions journal through
  :class:`tpulab_torch.obs.EventJournal` (pass ``journal=`` to the
  supervisor/elector/autoscaler/controller).

Consumed by :class:`tpulab_torch.rpc.replica.GenerationReplicaSet`
(``prefix_affinity=True`` routes through the HRW router; the set's
``add_replica`` / ``set_draining`` / ``retire_replica`` membership
surface is what the autoscaler, supervisor and followers drive).
docs/SERVING.md "Fleet routing & autoscaling" + "Running a real fleet".
"""

from tpulab_torch.fleet.autoscaler import (FleetAutoscaler,  # noqa: F401
                                           InProcessReplicaProvider,
                                           ReplicaProvider, spawn_with_retry)
from tpulab_torch.fleet.bench import (benchmark_fleet_obs,  # noqa: F401
                                      benchmark_prefix_affinity)
from tpulab_torch.fleet.control import FleetController  # noqa: F401
from tpulab_torch.fleet.election import (FileLeaseBackend,  # noqa: F401
                                         LeaderElector, LeaseBackend,
                                         StaleLeaderError, apply_membership,
                                         membership_snapshot)
from tpulab_torch.fleet.observer import FleetObserver  # noqa: F401
from tpulab_torch.fleet.process import SubprocessReplicaProvider  # noqa: F401
from tpulab_torch.fleet.router import (PrefixAffinityRouter,  # noqa: F401
                                       prefix_digest)
from tpulab_torch.fleet.supervisor import FleetSupervisor  # noqa: F401

__all__ = ["PrefixAffinityRouter", "prefix_digest", "FleetAutoscaler",
           "ReplicaProvider", "InProcessReplicaProvider",
           "SubprocessReplicaProvider", "FleetSupervisor",
           "LeaseBackend", "FileLeaseBackend", "LeaderElector",
           "StaleLeaderError", "FleetController", "FleetObserver",
           "membership_snapshot", "apply_membership", "spawn_with_retry",
           "benchmark_prefix_affinity", "benchmark_fleet_obs"]
