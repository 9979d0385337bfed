"""Offline batch lane: preemptible bulk inference that soaks idle
capacity (the port of ``tpulab/batch``; docs/SERVING.md "Offline batch
lane").

Fleets are paid for 24/7 but online traffic is diurnal — the
adaptive-orchestration line in PAPERS.md frames cost/performance/
resilience as one scheduling problem, and this package is the repo's
answer: a second request class (bulk scoring, evals, distillation
traces) that runs ONLY from spare capacity and is always the first
preemption victim.  The expensive primitives already exist elsewhere —
tiered-KV preempt/resume (tpulab_torch.kvcache) makes eviction nearly free,
delivered-token resume (the ``resume_length`` discipline,
docs/ROBUSTNESS.md "Stream failover semantics") restarts a killed job
without re-decoding, and the HBM arbiter (tpulab_torch.hbm) knows the real
headroom — so the lane is composition:

- :class:`BatchJob` — the manifest: prompts + sampling config + steps.
- :class:`JSONLResultSink` — the durable result/checkpoint file: tokens
  append as they are delivered, so a killed job resumes from delivered
  tokens instead of restarting.
- :class:`BatchScheduler` — feeds job items into a
  :class:`~tpulab_torch.engine.paged.ContinuousBatcher` only while spare
  capacity exists (idle lanes + free KV pages + arbiter headroom above
  a floor — the same unified headroom admission uses), tagged
  ``request_class="batch"`` so the engine preempts them first and the
  admission frontend keeps them strictly below any online priority.
"""

from tpulab_torch.batch.bench import benchmark_batch_soak  # noqa: F401
from tpulab_torch.batch.job import BatchJob, JSONLResultSink  # noqa: F401
from tpulab_torch.batch.scheduler import BatchScheduler  # noqa: F401

__all__ = ["BatchJob", "JSONLResultSink", "BatchScheduler",
           "benchmark_batch_soak"]
