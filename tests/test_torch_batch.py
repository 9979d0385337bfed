"""The port's offline batch lane against tpulab's, on the CPU at f32.

tpulab's ``tests/test_batch.py`` scenarios run through both packages on
the same weights (bridged with ``params_from_numpy``):

- manifests and the JSONL sink (checkpoint, overlap, reset, torn write)
  give equal documents and equal progress;
- a job's tokens and the sink's file equal tpulab's, line for line (the
  records carry no timestamps), and a rerun decodes nothing;
- the spare-capacity gate decides as tpulab's on the same engine states,
  and defers to online work on a live batcher;
- an online arrival preempts the batch lane and not the online one:
  ``batch_preemptions`` and ``preemptions`` equal tpulab's;
- a ``batch.run`` kill (error and drop) resumes from the checkpoint with
  zero re-decode and tpulab's tokens; from one scripted checkpoint both
  packages write the same records;
- a host-sampled item restarts behind a ``reset`` record;
- the ``_pick_block_k`` rule for batch and online lanes equals tpulab's;
- admission keeps batch below online and out of the queue-wait EWMA;
- the autoscaler's ``batch_drain`` hook fires before the provider drain;
- ``BatchMetrics`` after a job reads as tpulab's;
- Generate with ``request_class="batch"`` across the wire, both ways;
- the ``batch_soak`` row on the CPU.

Token and count comparisons are exact.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import prometheus_client
import pytest
import torch

import tpulab
import tpulab.batch as jbatch
import tpulab.chaos as jchaos
import tpulab.engine.paged as jpaged
import tpulab.fleet as jfleet
import tpulab.rpc.infer_service as jsvc
import tpulab.serving.admission as jadm
import tpulab.utils.metrics as jmetrics
import tpulab_torch
import tpulab_torch.batch as tbatch
import tpulab_torch.chaos as tchaos
import tpulab_torch.engine.paged as tpaged
import tpulab_torch.fleet as tfleet
import tpulab_torch.rpc.infer_service as tsvc
import tpulab_torch.serving.admission as tadm
import tpulab_torch.utils.metrics as tmetrics
from tpulab.models.mnist import make_mnist as jax_make_mnist
from tpulab.models.transformer import init_transformer_params
from tpulab_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

CFG = dict(n_heads=2, n_layers=2, max_len=96, page_size=8)


class _Pkg:
    """One package's batch-lane surface."""

    def __init__(self, name, paged, batch, chaos, adm, fleet, metrics,
                 params, **batcher_kw):
        self.name, self.paged, self.batch, self.chaos = (name, paged, batch,
                                                         chaos)
        self.adm, self.fleet, self.metrics = adm, fleet, metrics
        self.params, self.batcher_kw = params, batcher_kw

    def batcher(self, lanes=2, **kw):
        return self.paged.ContinuousBatcher(self.params, lanes=lanes,
                                            **CFG, **self.batcher_kw, **kw)


@pytest.fixture(scope="module")
def pkgs():
    p = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu",
                           n_heads=2)
    return (_Pkg("tpulab", jpaged, jbatch, jchaos, jadm, jfleet, jmetrics,
                 p, compute_dtype=jnp.float32),
            _Pkg("port", tpaged, tbatch, tchaos, tadm, tfleet, tmetrics,
                 tp, compute_dtype=torch.float32, device="cpu"))


def _prompts(n, rng_seed=0, length=6):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, 64, (length,), np.int32) for _ in range(n)]


def _lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _home(cb, timeout=10.0):
    want = cb.pool.n_pages - 1
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if (cb.active_lanes == 0 and cb.queued_requests == 0
                and cb.pool.free_pages == want):
            return True
        time.sleep(0.005)
    return False


# -- manifest + sink ----------------------------------------------------------
def test_batch_job_validation_and_manifest_roundtrip(pkgs):
    docs = []
    for pk in pkgs:
        job = pk.batch.BatchJob("j", [[1, 2], [3]], steps=4, temperature=0.5,
                                device_sampling=True, seed=7,
                                stop_tokens=(9,), priority=2,
                                metadata={"kind": "eval"})
        doc = job.to_manifest()
        back = pk.batch.BatchJob.from_manifest(doc)
        assert back.to_manifest() == doc and back.resumable
        assert not pk.batch.BatchJob("h", [[1]], steps=2,
                                     temperature=0.5).resumable
        sp = job.sampling()
        docs.append((doc, (sp.temperature, sp.top_k, sp.top_p, sp.seed,
                           sp.device)))
        for args in (("", [[1]], 1), ("j", [], 1), ("j", [[]], 1),
                     ("j", [[1]], 0)):
            with pytest.raises(ValueError):
                pk.batch.BatchJob(*args)
        with pytest.raises(ValueError):
            pk.batch.BatchJob("j", [[1]], steps=1, temperature=-1.0)
        assert pk.batch.BatchJob("g", [[1]], steps=1).sampling() is None
    assert docs[0] == docs[1]


def test_jsonl_sink_checkpoint_resume_and_reset(pkgs, tmp_path):
    got = []
    for pk in pkgs:
        path = str(tmp_path / f"{pk.name}.jsonl")
        sink = pk.batch.JSONLResultSink(path, flush_every=2)
        for i, t in enumerate([5, 6, 7]):
            sink.append_token("j", 0, i, t)
        sink.flush()
        p = sink.load_progress("j")
        assert p[0].tokens == [5, 6, 7] and not p[0].done
        sink.append_token("j", 0, 2, 7)   # replayed flush overlap
        sink.append_token("j", 0, 3, 8)
        sink.mark_done("j", 0, 4)
        p = sink.load_progress("j")
        assert p[0].tokens == [5, 6, 7, 8] and p[0].done
        sink.append_token("j", 1, 0, 1)
        sink.flush()
        sink.mark_reset("j", 1)
        sink.append_token("j", 1, 0, 2)
        sink.flush()
        p = sink.load_progress("j")
        assert p[1].tokens == [2] and not p[1].done
        with open(path, "a") as f:        # torn trailing write
            f.write('{"job": "j", "item": 0, "tok')
        p = sink.load_progress("j")
        assert p[0].tokens == [5, 6, 7, 8] and p[0].done
        assert sink.load_progress("other") == {}
        with open(path) as f:
            got.append(f.read())
    assert got[0] == got[1]


# -- scheduler: run / resume / gating ----------------------------------------
def test_scheduler_runs_job_bit_exact_and_idempotent(pkgs, tmp_path):
    """One job of three greedy items: tpulab's tokens and tpulab's sink
    file, line for line; a rerun decodes nothing."""
    prompts = _prompts(3, rng_seed=1)
    got = {}
    for pk in pkgs:
        cb = pk.batcher()
        try:
            ref = [cb.submit(p, 5).result(timeout=120) for p in prompts]
            path = str(tmp_path / f"{pk.name}.jsonl")
            sink = pk.batch.JSONLResultSink(path, flush_every=2)
            sched = pk.batch.BatchScheduler(cb, sink=sink)
            rep = sched.run(pk.batch.BatchJob("j", prompts, steps=5),
                            timeout_s=120)
            assert rep["interrupted"] is None and rep["items_done"] == 3
            results = [rep["results"][i] for i in range(3)]
            assert results == ref
            tg0 = cb.tokens_generated
            rep2 = sched.run(pk.batch.BatchJob("j", prompts, steps=5),
                             timeout_s=120)
            assert rep2["items_done"] == 3 and cb.tokens_generated == tg0
            assert sched.jobs_done == 2
            got[pk.name] = (results, _lines(path), rep["tokens_delivered"],
                            sched.items_done)
        finally:
            cb.shutdown()
    assert got["port"] == got["tpulab"]


class _State:
    """A scripted engine state for the spare-capacity gate."""

    def __init__(self, lanes, active, queued, free_pages, page_size=8,
                 hbm_free=None):
        self.lanes, self.active_lanes = lanes, active
        self.queued_requests, self.page_size = queued, page_size
        self.pool = type("P", (), {"free_pages": free_pages})()
        self.hbm = (None if hbm_free is None else
                    type("H", (), {"free_hbm_bytes": hbm_free})())


SPARE_CASES = [
    (_State(2, 0, 0, 10), 40, 0), (_State(2, 2, 0, 10), 8, 0),
    (_State(2, 1, 1, 10), 8, 0), (_State(2, 1, 0, 4), 40, 0),
    (_State(2, 1, 0, 5), 40, 0), (_State(0, 0, 0, 1), 8, 0),
    (_State(2, 0, 0, 10, hbm_free=100), 8, 200),
    (_State(2, 0, 0, 10, hbm_free=300), 8, 200),
    (_State(2, 0, 0, 10, hbm_free=100), 8, 0),
]


def test_spare_capacity_decisions_match_tpulab(pkgs):
    """The gate's decision on scripted engine states (idle lanes, queued
    work, free pages against the item's cost, the arbiter floor), then
    on a live idle batcher, equals tpulab's."""
    decisions = {}
    for pk in pkgs:
        out = []
        for state, cost, floor in SPARE_CASES:
            sched = pk.batch.BatchScheduler(state, min_free_hbm_bytes=floor)
            out.append(sched.spare_capacity(cost))
        cb = pk.batcher(lanes=1)
        try:
            sched = pk.batch.BatchScheduler(cb)
            out += [sched.spare_capacity(c) for c in (8, 96, 10_000)]
        finally:
            cb.shutdown()
        decisions[pk.name] = out
    assert decisions["port"] == decisions["tpulab"]
    assert True in decisions["port"] and False in decisions["port"]


def test_spare_capacity_gate_defers_to_online(pkgs):
    """With the only lane held by online work nothing is fed
    (``spare_denials`` grows) until the lane idles; the items then
    decode tpulab's tokens."""
    prompts = _prompts(2, rng_seed=2)
    got = {}
    for pk in pkgs:
        cb = pk.batcher(lanes=1)
        try:
            ref = [cb.submit(p, 4).result(timeout=120) for p in prompts]
            sched = pk.batch.BatchScheduler(cb, poll_s=0.001)
            online = cb.submit(prompts[0], 48, on_token=lambda *a: None)
            while cb.active_lanes == 0:
                time.sleep(0.001)
            res = {}
            th = threading.Thread(
                target=lambda: res.update(sched.run(
                    pk.batch.BatchJob("g", prompts, steps=4),
                    timeout_s=120)), daemon=True)
            th.start()
            time.sleep(0.05)
            assert online.done() or sched.tokens_delivered == 0
            assert sched.spare_denials > 0
            online.result(timeout=120)
            th.join(timeout=120)
            assert not th.is_alive() and res["items_done"] == 2
            got[pk.name] = [res["results"][i] for i in range(2)]
            assert got[pk.name] == ref
        finally:
            cb.shutdown()
    assert got["port"] == got["tpulab"]


def _wait(pred, timeout=60.0):
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise TimeoutError("condition not reached")
        time.sleep(0.001)


def test_online_arrival_preempts_batch_lane_first(pkgs):
    """Two lanes: a batch lane mid-decode and an online one; a third
    (online) arrival evicts the batch lane, never the online lane.  The
    counts (``preemptions``, ``batch_preemptions``) and every stream's
    tokens equal tpulab's; the batch item resumes exactly."""
    prompts = _prompts(3, rng_seed=3)
    got = {}
    for pk in pkgs:
        cb = pk.batcher(lanes=2)
        try:
            ref_b = cb.submit(prompts[0], 40).result(timeout=120)
            ref_o2 = cb.submit(prompts[2], 4).result(timeout=120)
            sched = pk.batch.BatchScheduler(cb, poll_s=0.001)
            res = {}
            th = threading.Thread(
                target=lambda: res.update(sched.run(
                    pk.batch.BatchJob("p", [prompts[0]], steps=40),
                    timeout_s=120)), daemon=True)
            th.start()
            _wait(lambda: sched.tokens_delivered >= 3)
            o1 = cb.submit(prompts[1], 40, on_token=lambda *a: None)
            _wait(lambda: cb.active_lanes >= 2)
            p0, bp0 = cb.preemptions, cb.batch_preemptions
            got_o2 = cb.submit(prompts[2], 4).result(timeout=120)
            o1_toks = o1.result(timeout=120)
            th.join(timeout=120)
            assert not th.is_alive() and res["interrupted"] is None
            assert got_o2 == ref_o2 and res["results"][0] == ref_b
            got[pk.name] = (cb.preemptions - p0, cb.batch_preemptions - bp0,
                            res["batch_preemptions"], got_o2, o1_toks,
                            res["results"][0])
            assert _home(cb)
        finally:
            cb.shutdown()
    n, nb, rep_nb = got["port"][:3]
    assert n == nb == rep_nb == 1
    assert got["port"] == got["tpulab"]


@pytest.mark.parametrize("action", ["error", "drop"])
def test_chaos_batch_run_kill_resumes_from_checkpoint(pkgs, tmp_path,
                                                      action):
    """A ``batch.run`` kill mid-decode ends the run with the delivered
    tokens durable; the next run resumes from the checkpoint with zero
    re-decode and tpulab's device-sampled tokens."""
    prompt = _prompts(1, rng_seed=4)[0]
    steps = 40
    job_kw = dict(steps=steps, temperature=0.8, device_sampling=True,
                  seed=99)
    got = {}
    for pk in pkgs:
        cb = pk.batcher(lanes=1, decode_block=2)
        try:
            ref = cb.submit(prompt, steps, sampling=pk.batch.BatchJob(
                "r", [prompt], **job_kw).sampling()).result(timeout=120)
            sink = pk.batch.JSONLResultSink(str(tmp_path / f"{pk.name}.j"),
                                            flush_every=1)
            sched = pk.batch.BatchScheduler(cb, sink=sink, poll_s=0.001)
            res = {}
            th = threading.Thread(
                target=lambda: res.update(sched.run(
                    pk.batch.BatchJob("k", [prompt], **job_kw),
                    timeout_s=120)), daemon=True)
            th.start()
            _wait(lambda: sched.tokens_delivered >= 5)
            with pk.chaos.inject(f"batch.run={action}") as sc:
                th.join(timeout=120)
                assert sc.fired("batch.run") >= 1
            assert res["interrupted"] == action
            assert sched.interrupted_runs == 1
            prog = sink.load_progress("k")
            n_part = len(prog[0].tokens)
            assert 0 < n_part < steps and not prog[0].done
            assert prog[0].tokens == ref[:n_part]
            tg0 = cb.tokens_generated
            rep2 = sched.run(pk.batch.BatchJob("k", [prompt], **job_kw),
                             timeout_s=120)
            assert rep2["interrupted"] is None
            assert rep2["results"][0] == ref
            assert rep2["tokens_resume_skipped"] == n_part
            assert cb.tokens_generated - tg0 == steps - n_part
            assert _home(cb)
            got[pk.name] = ref
        finally:
            cb.shutdown()
    assert got["port"] == got["tpulab"]


@pytest.mark.parametrize("mode", ["greedy", "device", "host"])
def test_resume_from_scripted_checkpoint_writes_tpulabs_records(
        pkgs, tmp_path, mode):
    """From the same checkpoint (the first 7 tokens of each item
    delivered, item 1 already done) both packages resume to tpulab's
    tokens and append the same records: resumable items decode only
    ``steps - 7`` tokens; a host-sampled item restarts behind ``reset``."""
    prompts = _prompts(3, rng_seed=9)
    steps, part = 16, 7
    job_kw = {"greedy": dict(), "device": dict(temperature=0.8, seed=5,
                                               device_sampling=True),
              "host": dict(temperature=0.9, top_k=4, seed=5)}[mode]
    got = {}
    for pk in pkgs:
        cb = pk.batcher(lanes=1)
        try:
            job = pk.batch.BatchJob("s", prompts, steps=steps, **job_kw)
            refs = [cb.submit(p, steps, sampling=job.sampling())
                    .result(timeout=120) for p in prompts]
            path = str(tmp_path / f"{pk.name}.jsonl")
            sink = pk.batch.JSONLResultSink(path, flush_every=4)
            for item, ref in enumerate(refs):
                for i, t in enumerate(ref[:part]):
                    sink.append_token("s", item, i, t)
            sink.flush()
            sink.mark_done("s", 1, part)
            n0 = len(_lines(path))
            sched = pk.batch.BatchScheduler(cb, sink=sink)
            tg0 = cb.tokens_generated
            rep = sched.run(job, timeout_s=120)
            assert rep["interrupted"] is None and rep["items_done"] == 3
            decoded = cb.tokens_generated - tg0
            results = [rep["results"][i] for i in range(3)]
            assert results[1] == refs[1][:part]      # done: not rerun
            if mode == "host":
                assert decoded == 2 * steps
                assert sched.tokens_restart_lost == 2 * part
                assert rep["tokens_resume_skipped"] == 0
                assert [len(r) for r in results] == [steps, part, steps]
            else:
                assert decoded == 2 * (steps - part)
                assert rep["tokens_resume_skipped"] == 2 * part
                assert results == [refs[0], refs[1][:part], refs[2]]
            got[pk.name] = (results, _lines(path)[n0:], decoded)
        finally:
            cb.shutdown()
    if mode != "host":
        assert got["port"] == got["tpulab"]
    else:
        # host draws differ between the packages' PRNGs; the record
        # shapes (resets, deltas, done) do not
        def shape(recs):
            return [{k: (len(v) if k == "tokens" else v)
                     for k, v in r.items()} for r in recs]
        assert shape(got["port"][1]) == shape(got["tpulab"][1])
        assert any(r.get("reset") for r in got["port"][1])


def test_host_sampled_interrupt_restarts_behind_reset(pkgs, tmp_path):
    """A host-sampled item interrupted by ``batch.run=drop`` restarts from
    scratch behind a ``reset`` record, in both packages."""
    prompt = _prompts(1, rng_seed=5)[0]
    steps = 32
    job_kw = dict(steps=steps, temperature=0.9, top_k=4, seed=7)
    for pk in pkgs:
        cb = pk.batcher(lanes=1, decode_block=2)
        try:
            sink = pk.batch.JSONLResultSink(str(tmp_path / f"{pk.name}.h"),
                                            flush_every=1)
            sched = pk.batch.BatchScheduler(cb, sink=sink, poll_s=0.001)
            res = {}
            th = threading.Thread(
                target=lambda: res.update(sched.run(
                    pk.batch.BatchJob("h", [prompt], **job_kw),
                    timeout_s=120)), daemon=True)
            th.start()
            _wait(lambda: sched.tokens_delivered >= 4)
            with pk.chaos.inject("batch.run=drop"):
                th.join(timeout=120)
            assert res["interrupted"] == "drop"
            lost = len(sink.load_progress("h")[0].tokens)
            assert lost > 0
            rep2 = sched.run(pk.batch.BatchJob("h", [prompt], **job_kw),
                             timeout_s=120)
            assert rep2["interrupted"] is None
            assert len(rep2["results"][0]) == steps
            assert rep2["tokens_resume_skipped"] == 0
            assert sched.tokens_restart_lost == lost
            assert sink.load_progress("h")[0].done
            assert any(r.get("reset") for r in _lines(sink.path))
        finally:
            cb.shutdown()


def test_pick_block_k_batch_lane_never_streaming_clamped(pkgs):
    """A batch lane's on_token hook is a checkpoint sink: it never drags
    the fused block to the K<=2 streaming clamp; an online streaming
    lane does.  Every case picks tpulab's K."""
    got = {}
    for pk in pkgs:
        cb = pk.batcher(decode_block=8)
        try:
            def mk(batch, steps=16, on_token=lambda *a: None):
                r = pk.paged._PagedRequest(np.asarray([1], np.int32), steps,
                                           on_token=on_token, batch=batch)
                r.tokens_out = [1]
                return r
            got[pk.name] = [
                cb._pick_block_k([(0, mk(False))]),
                cb._pick_block_k([(0, mk(True))]),
                cb._pick_block_k([(0, mk(True)), (1, mk(False))]),
                cb._pick_block_k([(0, mk(True, steps=4))]),
                cb._pick_block_k([(0, mk(False, on_token=None))])]
        finally:
            cb.shutdown()
    assert got["port"][:2] == [2, 8]
    assert got["port"] == got["tpulab"]


def test_submit_request_class_validation_and_rank(pkgs):
    """``submit(request_class=)`` validates as tpulab's, and the queue
    ranks online before batch at any priority."""
    for pk in pkgs:
        cb = pk.batcher(lanes=1)
        try:
            with pytest.raises(ValueError, match="request_class"):
                cb.submit([1, 2], 2, request_class="bulk")
            with cb._cv:        # all queued in one pass
                futs = [cb.submit([1, 2], 2, request_class="batch",
                                  priority=5),
                        cb.submit([3, 4], 2),
                        cb.submit([5, 6], 2, request_class="")]
                order = [(q.batch, q.priority) for q in cb._queue]
            assert order == [(False, 0), (False, 0), (True, 5)]
            for f in futs:
                f.result(timeout=60)
        finally:
            cb.shutdown()


# -- admission-class semantics ------------------------------------------------
def test_admission_batch_strictly_below_online_and_drr_exempt(pkgs):
    for pk in pkgs:
        ctrl = pk.adm.AdmissionController(pk.adm.AdmissionConfig(
            max_inflight=1, admit_wait_s=10.0))
        order = []
        first = ctrl.admit("a")

        def take(tag, **kw):
            with ctrl.admit(**kw):
                order.append(tag)
                time.sleep(0.02)

        tb = threading.Thread(target=take, args=("batch",), kwargs=dict(
            tenant="bulk", request_class="batch"), daemon=True)
        tb.start()
        _wait(lambda: ctrl.batch_queue_depth == 1, 10)
        to = threading.Thread(target=take, args=("online",),
                              kwargs=dict(tenant="a"), daemon=True)
        to.start()
        _wait(lambda: ctrl.queue_depth == 1, 10)
        depths = ctrl.queue_depths()
        assert depths.get("batch:bulk") == 1 and depths.get("a") == 1
        assert ctrl._queue.deficit_of("bulk") == 0.0
        first.release()
        to.join(timeout=10)
        tb.join(timeout=10)
        assert order == ["online", "batch"], pk.name
        assert ctrl.batch_admitted_total == 1


class _FakeSet:
    addresses = ["a"]
    overloads = 0
    active_count = 1

    @property
    def inflight(self):
        return [0]

    def active_addresses(self):
        return ["a"]

    def load_hints(self):
        return {"a": 0}

    def add_replica(self, addr):
        raise AssertionError("scaled up on batch pressure")


def test_admission_queue_wait_ewma_excludes_batch_and_autoscaler_holds(
        pkgs):
    """Batch-class admissions never move ``queue_wait_ewma_s``, so the
    autoscaler does not scale up under a pure batch flood; the same wait
    pattern online-class moves it."""
    for pk in pkgs:
        ctrl = pk.adm.AdmissionController(pk.adm.AdmissionConfig(
            max_inflight=1, admit_wait_s=10.0))
        waited = {}

        def queued_admit(request_class):
            first = ctrl.admit("a")
            done = threading.Event()

            def second():
                with ctrl.admit("b", request_class=request_class) as t:
                    waited[request_class] = t.queue_wait_s
                done.set()

            threading.Thread(target=second, daemon=True).start()
            _wait(lambda: ctrl.batch_queue_depth + ctrl.queue_depth == 1,
                  10)
            time.sleep(0.03)
            first.release()
            assert done.wait(timeout=10)

        queued_admit("batch")
        assert waited["batch"] > 0.0 and ctrl.queue_wait_ewma_s == 0.0
        asc = pk.fleet.FleetAutoscaler(
            _FakeSet(), pk.fleet.ReplicaProvider(),
            wait_signal=lambda: ctrl.queue_wait_ewma_s, up_wait_s=0.01,
            hold=1, min_replicas=1, max_replicas=4)
        assert asc.evaluate() == "" and asc.scale_ups == 0
        queued_admit("online")
        assert ctrl.queue_wait_ewma_s > 0.0, pk.name


# -- fleet: batch drains first ------------------------------------------------
def test_autoscaler_batch_drain_hook_fires_before_provider_drain(pkgs):
    for pk in pkgs:
        events = []

        class FakeSet:
            def __init__(self):
                self.addresses = ["a", "b"]
                self.overloads = 0
                self.active = 2

            @property
            def active_count(self):
                return self.active

            @property
            def inflight(self):
                return [0, 0]

            def active_addresses(self):
                return list(self.addresses)

            def load_hints(self):
                return {a: 0 for a in self.addresses}

            def set_draining(self, addr, flag=True):
                events.append(("draining", addr))

            def retire_replica(self, addr):
                self.active -= 1

        class FakeProvider(pk.fleet.ReplicaProvider):
            def drain(self, addr, timeout_s=30.0):
                events.append(("provider_drain", addr))
                return True

            def retire(self, addr):
                events.append(("retire", addr))

        cb = pk.batcher(lanes=1)
        try:
            sched = pk.batch.BatchScheduler(cb, poll_s=0.001)
            res = {}
            th = threading.Thread(
                target=lambda: res.update(sched.run(
                    pk.batch.BatchJob("d", _prompts(1, rng_seed=6),
                                      steps=64), timeout_s=120)),
                daemon=True)
            th.start()
            _wait(lambda: sched.tokens_delivered >= 2)

            def batch_drain(addr):
                events.append(("batch_drain", addr))
                sched.drain(addr)

            asc = pk.fleet.FleetAutoscaler(
                FakeSet(), FakeProvider(), wait_signal=lambda: 0.0, hold=1,
                min_replicas=1, max_replicas=2, batch_drain=batch_drain)
            assert asc.evaluate() == "drain_started"
            assert asc.wait_for_drain(10.0)
            th.join(timeout=30)
            assert not th.is_alive()
            assert [k for k, _ in events] == ["draining", "batch_drain",
                                              "provider_drain", "retire"]
            assert res["items_done"] == 0 and sched.paused
            assert _home(cb)
        finally:
            cb.shutdown()


# -- metrics ------------------------------------------------------------------
def test_batch_metrics_poll_matches_tpulab(pkgs, tmp_path):
    """After the same job, the port's BatchMetrics exposition parses to
    tpulab's samples."""
    from prometheus_client.parser import text_string_to_metric_families

    def samples(text):
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                      for fam in text_string_to_metric_families(text)
                      for s in fam.samples if not s.name.endswith("_created"))

    got = {}
    for pk in pkgs:
        cb = pk.batcher()
        try:
            sink = pk.batch.JSONLResultSink(str(tmp_path / f"{pk.name}.m"))
            sched = pk.batch.BatchScheduler(cb, sink=sink)
            if pk.name == "tpulab":
                m = pk.metrics.BatchMetrics(
                    registry=prometheus_client.CollectorRegistry())
                expo = prometheus_client.generate_latest
            else:
                m = pk.metrics.BatchMetrics()
                expo = pk.metrics.generate_latest
            sched.run(pk.batch.BatchJob("m", _prompts(2, rng_seed=7),
                                        steps=4), timeout_s=120)
            m.poll(sched)
            got[pk.name] = samples(expo(m.registry).decode())
        finally:
            cb.shutdown()
    assert got["port"] == got["tpulab"]
    assert ("tpulab_batch_tokens_delivered_total", (), 8.0) in got["port"]


# -- RPC: request_class end to end --------------------------------------------
def test_rpc_generate_request_class_end_to_end(pkgs):
    """Each package serves a batcher behind admission; ``request_class=
    "batch"`` streams from both servers through both clients the tokens
    of a direct submit, counts one batch admission per stream, and the
    unknown class and the class x disagg hop are rejected."""
    prompt = _prompts(1, rng_seed=8)[0]
    servers = []
    try:
        for pk in pkgs:
            cb = pk.batcher()
            adm = pk.adm.AdmissionController(pk.adm.AdmissionConfig(
                max_inflight=4), load=cb)
            if pk.name == "tpulab":
                mgr = tpulab.InferenceManager(max_exec_concurrency=1)
                mgr.register_model("mnist", jax_make_mnist(max_batch_size=1))
                mgr.update_resources()
            else:
                mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                                    device="cpu")
            mgr.serve(port=0, generation_engines={"lm": cb}, admission=adm)
            servers.append((pk, mgr, cb, adm))
        want = servers[0][2].submit(prompt, 5).result(timeout=120)
        for _pk, mgr, cb, adm in servers:
            assert cb.submit(prompt, 5).result(timeout=120) == want
            for svc in (jsvc, tsvc):
                remote = svc.RemoteInferenceManager(
                    f"127.0.0.1:{mgr.server.bound_port}")
                try:
                    gc = svc.GenerateStreamClient(remote, "lm")
                    n0 = adm.batch_admitted_total
                    got = list(gc.generate(prompt, 5, request_class="batch"))
                    assert got == want
                    assert adm.batch_admitted_total == n0 + 1
                    with pytest.raises(svc.GenerationRejected):
                        list(gc.generate(prompt, 5, request_class="bulk"))
                    with pytest.raises(svc.GenerationRejected):
                        list(gc.generate(prompt, 5, request_class="batch",
                                         prefill_only=True))
                finally:
                    remote.close()
            assert _home(cb)
    finally:
        for _pk, mgr, cb, _adm in servers:
            mgr.shutdown()
            cb.shutdown()


def test_benchmark_batch_soak_row():
    """The ``batch_soak`` row on the CPU: tpulab's fields, every batch
    item done, the preempted job's output equal to its uncontended run
    and the online first tokens unchanged by the lane."""
    row = tbatch.benchmark_batch_soak(n_cycles=2, n_batch_items=6,
                                      idle_s=0.2, device="cpu")
    assert set(row) == {"lanes", "steps", "n_cycles", "idle_s",
                        "n_batch_items", "batch_preemptions",
                        "batch_items_done", "batch_parity", "online_parity",
                        "lane_off", "lane_on", "tokens_s_lift"}
    assert row["batch_items_done"] == 6
    assert row["batch_parity"] and row["online_parity"]
    assert row["lane_on"]["batch_tokens_in_window"] >= 0
    assert set(row["lane_on"]) == set(row["lane_off"]) | {
        "batch_tokens_in_window"}
