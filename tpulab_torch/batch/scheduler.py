"""BatchScheduler: feed offline jobs into spare serving capacity
(tpulab_torch.batch, the port of ``tpulab/batch/scheduler.py``;
docs/SERVING.md "Offline batch lane").

The scheduler is deliberately a FEEDER, not a second engine: it walks a
:class:`~tpulab_torch.batch.job.BatchJob`'s items and submits each into the
:class:`~tpulab_torch.engine.paged.ContinuousBatcher` with
``request_class="batch"`` — the engine then owns preemption (batch
lanes are the first victims of any online arrival) and the admission
frontend, when armed, keeps batch strictly below every online priority.
The feeder's own job is the SPARE-CAPACITY gate: an item is submitted
only while

- the engine has an idle lane and an empty queue (batch must never
  delay an online admit inside the engine),
- the unified headroom covers the item's cost — via
  :meth:`~tpulab_torch.serving.admission.AdmissionController.headroom_ok`
  when an admission controller is attached (the SAME number online
  admission uses: free pages + demotable KV + arbiter reclaimable),
  else the pool's free pages directly,
- with an HBM arbiter armed, ``free_hbm_bytes`` sits at or above
  ``min_free_hbm_bytes``.

Progress checkpoints to the :class:`~tpulab_torch.batch.job.JSONLResultSink`
as tokens are delivered, so a preempted/killed run RESUMES: an item
with N delivered tokens resubmits ``prompt + delivered`` and decodes
only the remaining ``steps - N`` — one chunked prefill, zero re-decode
of delivered tokens, bit-exact for greedy and device-sampled jobs (the
``resume_length`` discipline of docs/ROBUSTNESS.md applied to the
offline lane).  Host-sampled items restart from scratch (draw-order
PRNG does not survive) behind an explicit ``reset`` checkpoint record.

The ``batch.run`` chaos trip point (tpulab_torch.chaos) sits at the feed
site: ``error`` kills the run mid-feed (in-flight items are cancelled,
their delivered tokens stay durable), ``drop`` black-holes the feeder
the same way with distinct evidence — both model a batch runner dying,
and the next :meth:`BatchScheduler.run` resumes from the checkpoint.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import numpy as np

from tpulab_torch import chaos
from tpulab_torch.batch.job import BatchJob, ItemProgress, JSONLResultSink

log = logging.getLogger("tpulab_torch.batch")


class BatchScheduler:
    """Feed batch jobs into a ContinuousBatcher's spare capacity.

    ``engine`` is the batcher; ``sink`` the durable result/checkpoint
    file (None = results kept in memory only, no resume across runs);
    ``admission`` an optional
    :class:`~tpulab_torch.serving.admission.AdmissionController` — armed, each
    item holds a batch-class admission ticket while in flight and the
    spare probe consults the controller's unified headroom;
    ``metrics`` an optional
    :class:`~tpulab_torch.utils.metrics.BatchMetrics`.  ``max_inflight``
    bounds concurrently submitted items (default 1: the lane soaks idle
    capacity one lane at a time and yields instantly under preemption).
    """

    def __init__(self, engine, sink: Optional[JSONLResultSink] = None,
                 admission=None, tenant: str = "batch",
                 max_inflight: int = 1, min_free_hbm_bytes: int = 0,
                 poll_s: float = 0.002, metrics=None):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.engine = engine
        self.sink = sink
        self.admission = admission
        self.tenant = tenant
        self.max_inflight = int(max_inflight)
        self.min_free_hbm_bytes = int(min_free_hbm_bytes)
        self.poll_s = float(poll_s)
        self.metrics = metrics
        self._paused = threading.Event()
        #: live in-flight map future -> (item, ticket); guarded by _lock
        self._inflight: Dict[object, tuple] = {}
        self._lock = threading.Lock()
        # -- counters (test-assertable; BatchMetrics.poll mirrors them) -----
        self.jobs_run = 0
        self.jobs_running = 0
        self.jobs_done = 0
        self.items_done = 0
        self.tokens_delivered = 0
        #: delivered tokens a resume did NOT re-decode (the replay-
        #: avoided figure: prompt+delivered rides one chunked prefill)
        self.tokens_resume_skipped = 0
        #: delivered tokens a non-resumable (host-sampled) restart threw
        #: away — the price of draw-order PRNG, kept visible
        self.tokens_restart_lost = 0
        self.interrupted_runs = 0
        self.spare_denials = 0  # feed attempts deferred by the gate

    # -- drain hook (fleet scale-down: batch drains FIRST) -------------------
    def pause(self) -> None:
        """Stop feeding new items (in-flight items finish or are
        preempted/cancelled by their owner); :meth:`resume_feeding`
        re-arms."""
        self._paused.set()

    def resume_feeding(self) -> None:
        self._paused.clear()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def drain(self, address: Optional[str] = None) -> None:
        """Fleet scale-down hook (docs/SERVING.md "Fleet routing &
        autoscaling"): batch work drains FIRST — stop feeding and cancel
        every in-flight item NOW (delivered tokens are already durable
        in the sink; the next run resumes them), so the replica's drain
        only waits on online streams.  ``address`` is accepted for the
        autoscaler's ``batch_drain(victim)`` calling convention and
        ignored here: an in-process scheduler feeds one engine."""
        self.pause()
        with self._lock:
            futs = list(self._inflight)
        for fut in futs:
            try:
                self.engine.cancel(fut)
            except Exception:  # pragma: no cover - engine torn down
                log.exception("batch drain: cancel failed")
        if self.sink is not None:
            self.sink.flush()

    # -- the spare-capacity gate ---------------------------------------------
    def spare_capacity(self, cost: int) -> bool:
        """May one more batch item enter the engine RIGHT NOW?  (module
        docstring) — idle lane + empty engine queue + unified headroom +
        arbiter floor.  Never raises: a torn-down engine reads False."""
        eng = self.engine
        try:
            lanes = int(getattr(eng, "lanes", 0) or 0)
            if lanes and int(eng.active_lanes) >= lanes:
                return False
            if int(getattr(eng, "queued_requests", 0)) > 0:
                return False
            if self.admission is not None:
                if not self.admission.headroom_ok(cost):
                    return False
            else:
                pool = getattr(eng, "pool", None)
                if pool is not None:
                    page_size = int(getattr(eng, "page_size", 1) or 1)
                    if int(pool.free_pages) * page_size < cost:
                        return False
            hbm = getattr(eng, "hbm", None)
            if hbm is not None and self.min_free_hbm_bytes > 0:
                if int(hbm.free_hbm_bytes) < self.min_free_hbm_bytes:
                    return False
        except Exception:  # noqa: BLE001 - a dying engine is not spare
            return False
        return True

    # -- the run loop ---------------------------------------------------------
    def run(self, job: BatchJob, timeout_s: Optional[float] = None) -> dict:
        """Run (or RESUME) ``job`` to completion from spare capacity.

        Returns a report dict: ``items_done``/``items_total``,
        ``tokens_delivered`` (this run), ``tokens_resume_skipped``
        (delivered tokens this run did not re-decode),
        ``batch_preemptions`` (engine evictions of this run's lanes),
        ``interrupted`` (None, or the chaos action that killed the
        feeder — the next ``run`` resumes from the checkpoint), and
        ``results``: item -> token list for every item COMPLETED as of
        this run.  Idempotent: items already done in the sink are
        skipped, partial items resume from their delivered prefix."""
        t0 = time.perf_counter()
        self.jobs_run += 1
        self.jobs_running += 1
        try:
            return self._run(job, t0, timeout_s)
        finally:
            self.jobs_running -= 1

    def _run(self, job: BatchJob, t0: float,
             timeout_s: Optional[float]) -> dict:
        progress = (self.sink.load_progress(job.job_id)
                    if self.sink is not None else {})
        results: Dict[int, list] = {}
        pending = []
        for i in range(len(job)):
            p = progress.get(i)
            if p is not None and p.done:
                results[i] = list(p.tokens)
                continue
            # a partial whose delivered prefix already ends the item
            # (stop token, or the full step budget) just needs its done
            # record — nothing left to decode
            if p is not None and p.tokens and (
                    len(p.tokens) >= job.steps
                    or p.tokens[-1] in job.stop_tokens):
                results[i] = list(p.tokens)
                self.items_done += 1
                self._finish_item(job, i, p.tokens)
                continue
            pending.append(i)
        preempt0 = int(getattr(self.engine, "batch_preemptions", 0))
        tokens0 = self.tokens_delivered
        skipped0 = self.tokens_resume_skipped
        interrupted: Optional[str] = None
        end = None if timeout_s is None else time.monotonic() + timeout_s
        pending.reverse()  # pop() from the front, cheaply
        while pending or self._inflight:
            # chaos: the batch runner's fault site — tripped once per
            # scheduler pass, so a rule can kill the run at ANY point
            # (feeding or waiting on in-flight decodes).  error/drop
            # both kill the runner mid-job: in-flight work is cancelled,
            # delivered tokens stay durable in the sink, and the next
            # run() resumes from the checkpoint with zero re-decode
            try:
                if chaos.trip("batch.run") == "drop":
                    interrupted = "drop"
                    self._cancel_inflight()
                    break
            except chaos.ChaosError:
                interrupted = "error"
                self._cancel_inflight()
                break
            if end is not None and time.monotonic() > end:
                interrupted = "timeout"
                self._cancel_inflight()
                break
            if not pending or self.paused:
                # in-flight items complete via their done-callbacks;
                # nothing to feed — just wait for slots/completions
                time.sleep(self.poll_s)
                continue
            with self._lock:
                slots = self.max_inflight - len(self._inflight)
            if slots <= 0:
                time.sleep(self.poll_s)
                continue
            item = pending[-1]
            delivered = list(progress.get(item, ItemProgress()).tokens)
            cost = int(len(job.prompts[item]) + job.steps)
            if not self.spare_capacity(cost):
                self.spare_denials += 1
                time.sleep(self.poll_s)
                continue
            pending.pop()
            try:
                self._submit_item(job, item, delivered, results)
            except Exception:  # noqa: BLE001 - keep the job going
                log.exception("batch item %d submit failed; re-queued",
                              item)
                pending.insert(0, item)
                time.sleep(self.poll_s)
        if interrupted is not None:
            self.interrupted_runs += 1
        if self.sink is not None:
            self.sink.flush()  # interruption or completion: land deltas
        done = len(results)
        if done == len(job) and interrupted is None:
            self.jobs_done += 1
        report = {
            "job_id": job.job_id, "items_total": len(job),
            "items_done": done,
            "tokens_delivered": self.tokens_delivered - tokens0,
            "tokens_resume_skipped":
                self.tokens_resume_skipped - skipped0,
            "batch_preemptions":
                int(getattr(self.engine, "batch_preemptions", 0))
                - preempt0,
            "interrupted": interrupted,
            "wall_s": round(time.perf_counter() - t0, 6),
            "results": results,
        }
        return report

    # -- internals ------------------------------------------------------------
    def _cancel_inflight(self) -> None:
        with self._lock:
            futs = list(self._inflight)
        for fut in futs:
            try:
                self.engine.cancel(fut)
            except Exception:  # pragma: no cover
                log.exception("batch cancel failed")
        # settle: cancelled lanes free at the next tick boundary; the
        # report must not race its own done-callbacks
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight:
                    return
            time.sleep(self.poll_s)

    def _admit_ticket(self, job: BatchJob, cost: int):
        if self.admission is None:
            return None
        from tpulab_torch.serving.admission import REQUEST_CLASS_BATCH
        return self.admission.admit(tenant=self.tenant, cost=cost,
                                    priority=job.priority,
                                    request_class=REQUEST_CLASS_BATCH)

    def _submit_item(self, job: BatchJob, item: int, delivered: list,
                     results: Dict[int, list]) -> None:
        prompt = job.prompts[item]
        start = 0
        if delivered:
            if job.resumable:
                # delivered-token resume: the prompt already contains the
                # delivered prefix, so it rides ONE chunked prefill and
                # only the remaining steps decode — zero re-decode,
                # bit-exact ((seed, position)-keyed streams)
                start = len(delivered)
                prompt = np.concatenate(
                    [prompt, np.asarray(delivered, np.int32)])
                self.tokens_resume_skipped += start
            else:
                # host-sampled: draw-order PRNG does not survive the
                # restart — void the prefix behind an explicit checkpoint
                # record and start the item over
                self.tokens_restart_lost += len(delivered)
                if self.sink is not None:
                    self.sink.mark_reset(job.job_id, item)
                delivered = []
        steps = job.steps - start
        collected: list = list(delivered)
        sink = self.sink

        def on_token(tok, i, logprob=None):
            collected.append(int(tok))
            self.tokens_delivered += 1
            if sink is not None:
                sink.append_token(job.job_id, item, start + i, int(tok))

        cost = int(len(prompt) + steps)
        ticket = self._admit_ticket(job, cost)
        try:
            fut = self.engine.submit(
                prompt, steps, on_token=on_token,
                sampling=job.sampling(), priority=job.priority,
                stop_tokens=job.stop_tokens, tenant=self.tenant,
                request_class="batch")
        except Exception:
            if ticket is not None:
                ticket.release()
            raise
        with self._lock:
            self._inflight[fut] = (item, ticket)

        def _done(f):
            with self._lock:
                entry = self._inflight.pop(f, None)
            if entry is None:  # pragma: no cover - double callback
                return
            _item, tk = entry
            if tk is not None:
                tk.release()
            err = None
            try:
                if not f.cancelled():
                    err = f.exception()
            except Exception as e:  # pragma: no cover
                err = e
            if f.cancelled() or err is not None:
                # preempted runs resume in-engine; only a CANCELLED or
                # failed item lands here — its delivered tokens are
                # already durable, the next run() resumes them
                if err is not None:
                    log.warning("batch item %d failed: %r", _item, err)
                return
            self.items_done += 1
            results[_item] = list(collected)
            self._finish_item(job, _item, collected)

        fut.add_done_callback(_done)

    def _finish_item(self, job: BatchJob, item: int,
                     tokens: list) -> None:
        if self.sink is not None:
            self.sink.mark_done(job.job_id, item, len(tokens))

    @property
    def soak_utilization(self) -> float:
        """Fraction of engine lanes the batch lane occupies RIGHT NOW
        (the utilization-soak gauge BatchMetrics exports): near 1 on an
        idle fleet, near 0 under online load — both are the lane
        working as designed."""
        lanes = int(getattr(self.engine, "lanes", 0) or 0)
        if lanes <= 0:
            return 0.0
        with self._lock:
            return min(1.0, len(self._inflight) / lanes)
