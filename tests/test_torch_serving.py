"""The port's admission control and fair queue against tpulab's, on the
same scripted sequences: ``DeficitRoundRobinQueue`` op for op (pops,
deficits, shed candidates), ``TokenBucket`` refills, and
``AdmissionController`` decisions under one fake clock — verdicts,
rejection reasons, ``retry_after_ms``, which queued requests each release
dispatches (with their queue waits and DRR deficits), with and without a
load source and an ``hbm=`` arbiter, for online and batch classes; then
the public ``admit`` path (model costs and priorities, the capacity
terms, the ``serving.admission`` chaos site).

tpulab reads ``time`` from its module; the test swaps that for the fake
clock (and its TokenBucket's default clock), the port takes ``clock=``."""

import types

import numpy as np
import pytest

import tpulab.chaos as jchaos
import tpulab.serving.admission as jadm
import tpulab.serving.fair_queue as jfq
import tpulab_torch.chaos as tchaos
import tpulab_torch.serving.admission as tadm
import tpulab_torch.serving.fair_queue as tfq
from tpulab.core.deadline import Deadline as JDeadline
from tpulab_torch.core.deadline import Deadline as TDeadline


class _Item:
    def __init__(self, tenant, cost, priority, seq):
        self.tenant, self.cost, self.priority, self.seq = (tenant, cost,
                                                           priority, seq)


def _drr_trace(mod, seed):
    rng = np.random.default_rng(seed)
    q = mod.DeficitRoundRobinQueue(quantum=int(rng.integers(1, 200)))
    items, popped, out = [], [], []
    for seq in range(300):
        op = rng.random()
        if op < 0.5 or not len(q):
            it = _Item(f"t{int(rng.integers(0, 4))}",
                       int(rng.integers(1, 400)), int(rng.integers(0, 3)),
                       seq)
            items.append(it)
            q.push(it)
            out.append(("push", it.seq))
        elif op < 0.75:
            it = q.pop()
            popped.append(it)
            out.append(("pop", it.seq))
        elif op < 0.85 and popped:
            it = popped.pop()
            refund = float(rng.integers(0, 100))
            q.requeue_front(it, refund=refund)
            out.append(("requeue", it.seq, refund))
        elif op < 0.95:
            it = items[int(rng.integers(0, len(items)))]
            out.append(("remove", it.seq, q.remove(it)))
        else:
            v = q.peek_lowest_priority()
            out.append(("peek", v.seq if v is not None else None))
        out.append((len(q), q.tenants(), q.depths(),
                    {t: q.deficit_of(t) for t in ("t0", "t1", "t2", "t3")}))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fair_queue_same_order_and_deficits(seed):
    assert _drr_trace(jfq, seed) == _drr_trace(tfq, seed)


def test_token_bucket_same_refills_and_hints():
    for rate, burst in ((2.0, 0.0), (0.5, 3.0), (10.0, 1.0)):
        clk = [0.0]
        jb = jadm.TokenBucket(rate, burst, clock=lambda: clk[0])
        tb = tadm.TokenBucket(rate, burst, clock=lambda: clk[0])
        rng = np.random.default_rng(int(rate * 10))
        for _ in range(50):
            clk[0] += float(rng.random()) * 0.7
            n = float(rng.integers(1, 3))
            assert jb.try_take(n) == tb.try_take(n)
            assert jb.retry_after_s(n) == tb.retry_after_s(n)
    with pytest.raises(ValueError):
        tadm.TokenBucket(0.0)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _Load:
    """ContinuousBatcher's admission surface (mutable between ops)."""

    def __init__(self):
        self.lanes = 2
        self.active_lanes = 0
        self.queued_requests = 0
        self.page_size = 16
        self.admission_cost_factor = 1.0
        self.pool = types.SimpleNamespace(free_pages=12, page_nbytes=4096)


class _Arb:
    """HBMArbiter's admission surface."""

    def __init__(self):
        self.free_hbm_bytes = 8192
        self.reclaim = 4096

    def reclaimable_bytes(self, exclude=None):
        assert exclude == "kv"
        return self.reclaim


SCENARIOS = {
    "plain": dict(cfg=dict(max_inflight=3, max_queue_depth=4,
                           drr_quantum=64)),
    "rates": dict(cfg=dict(max_inflight=4, max_queue_depth=3,
                           global_rate=3.0, tenant_rate=1.5,
                           tenant_burst=2.0, drr_quantum=32)),
    "load": dict(cfg=dict(max_inflight=4, max_queue_depth=5,
                          drr_quantum=128), load=True),
    # few free pages: the arbiter's free + reclaimable bytes decide
    "load+hbm": dict(cfg=dict(max_inflight=4, max_queue_depth=5,
                              drr_quantum=128,
                              batch_min_free_hbm_bytes=2048),
                     load=True, hbm=True, pages=6),
    "batch": dict(cfg=dict(max_inflight=3, max_queue_depth=3,
                           max_batch_queue_depth=2, drr_quantum=64),
                  load=True, batch=True),
}


def _admission_trace(mod, dl_cls, scenario, seed, clk, load, arb):
    spec = SCENARIOS[scenario]
    ctrl_kw = dict(load=load if spec.get("load") else None,
                   hbm=arb if spec.get("hbm") else None)
    arb = arb or _Arb()
    if mod is tadm:
        ctrl_kw["clock"] = clk
    ctrl = mod.AdmissionController(mod.AdmissionConfig(**spec["cfg"]),
                                   **ctrl_kw)
    rng = np.random.default_rng(seed)
    tickets, waiters, out = [], [], []

    def settle():
        """Record waiters the last step dispatched or shed."""
        for i, w in enumerate(waiters):
            if w is None:
                continue
            if w.ticket is not None:
                t = w.ticket
                out.append(("dispatched", i, t.cost, t.tenant,
                            round(t.queue_wait_s, 9), t.drr_deficit,
                            t.request_class))
                tickets.append(t)
                waiters[i] = None
            elif w.reject is not None:
                out.append(("shed", i, w.reject.reason,
                            w.reject.retry_after_ms))
                waiters[i] = None

    for step in range(160):
        op = rng.random()
        if op < 0.6:
            tenant = f"t{int(rng.integers(0, 3))}"
            cost = int(rng.integers(1, 200))
            prio = int(rng.integers(0, 3))
            klass = ("batch" if spec.get("batch") and rng.random() < 0.4
                     else "online")
            dl = [None, 0.0, 1e6][int(rng.integers(0, 3))]
            deadline = None if dl is None else dl_cls.after(dl)
            try:
                t, w = ctrl._admit_or_enqueue(tenant, cost, prio, deadline,
                                              "", klass)
            except mod.AdmissionRejected as e:
                out.append(("reject", e.reason, e.retry_after_ms))
            else:
                if t is not None:
                    tickets.append(t)
                    out.append(("admit", t.cost, t.request_class))
                else:
                    waiters.append(w)
                    out.append(("queued", len(waiters) - 1))
        elif op < 0.85 and tickets:
            t = tickets.pop(int(rng.integers(0, len(tickets))))
            t.release()
            out.append(("release",))
        elif op < 0.93:
            clk.t += float(rng.random()) * 0.8
            out.append(("tick",))
        else:
            load.pool.free_pages = int(rng.integers(0, spec.get("pages",
                                                                20)))
            load.active_lanes = int(rng.integers(0, 3))
            load.queued_requests = int(rng.integers(0, 3))
            arb.free_hbm_bytes = int(rng.integers(-4096, 65536))
            arb.reclaim = int(rng.integers(0, 16384))
            with ctrl._lock:
                ctrl._dispatch_locked()
            out.append(("load",))
        settle()
        with ctrl._lock:
            hint = ctrl._retry_hint_ms_locked()
        out.append((ctrl.queue_depth, ctrl.batch_queue_depth, ctrl.inflight,
                    ctrl.queue_depths(), dict(ctrl.model_inflight),
                    ctrl.peak_queue_depth, hint,
                    round(ctrl.queue_wait_ewma_s, 9)))
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_admission_same_verdicts_on_scripted_sequences(scenario,
                                                       monkeypatch):
    traces = []
    for mod, dl_cls in ((jadm, JDeadline), (tadm, TDeadline)):
        clk, load, arb = _Clock(), _Load(), _Arb()
        if mod is jadm:
            monkeypatch.setattr(mod, "time", types.SimpleNamespace(
                monotonic=clk, perf_counter=clk))
            monkeypatch.setattr(mod.TokenBucket.__init__, "__defaults__",
                                (0.0, clk))
        traces.append(_admission_trace(mod, dl_cls, scenario, 7, clk, load,
                                       arb))
        monkeypatch.undo()
    jt, tt = traces
    assert len(jt) == len(tt)
    for i, (a, b) in enumerate(zip(jt, tt)):
        assert a == b, (i, a, b)
    kinds = {x[0] for x in jt if isinstance(x[0], str)}
    assert {"admit", "reject"} <= kinds
    assert "dispatched" in kinds or scenario == "rates"
    if scenario == "load+hbm":
        # the arbiter's numbers changed decisions: without it the same
        # script runs differently
        clk, load, arb = _Clock(), _Load(), _Arb()
        plain = _admission_trace(tadm, TDeadline, "load+hbm", 7, clk, load,
                                 None)
        assert plain != tt


def _public_admits(mod, chaos, dl_cls):
    cfg = mod.AdmissionConfig(max_inflight=2, max_queue_depth=0,
                              model_costs={"big": 3.0},
                              model_priorities={"vip": 5},
                              min_retry_after_ms=40)
    load = _Load()
    load.pool.free_pages = 4                      # 64 tokens of pages
    ctrl = mod.AdmissionController(cfg, load=load)
    out = []

    def admit(**kw):
        try:
            t = ctrl.admit(**kw)
        except mod.AdmissionRejected as e:
            out.append(("reject", e.reason, e.retry_after_ms, str(e)))
            return None
        out.append(("admit", t.tenant, t.cost, t.model, t.request_class,
                    t.queue_wait_s, t.drr_deficit))
        return t

    a = admit(tenant="", cost=30, model="small")
    admit(tenant="x", cost=30, model="big")       # 90 > 64: queue_full
    b = admit(tenant="x", cost=10, model="vip", priority=1)
    admit(tenant="y", cost=1)                     # inflight cap
    a.release()
    with chaos.inject("serving.admission=error+1"):
        admit(tenant="z", cost=1)
    with chaos.inject("serving.admission=drop+1"):
        admit(tenant="z", cost=1)
    c = admit(tenant="z", cost=1, deadline=dl_cls.after(5.0))
    out.append((ctrl.headroom_ok(64), ctrl.headroom_ok(65),
                ctrl.admitted_total, ctrl.rejected_total,
                dict(ctrl.rejected_by_reason), dict(ctrl.model_inflight)))
    b.release()
    c.release()
    with pytest.raises(ValueError):
        ctrl.admit(request_class="bulk")
    out.append((ctrl.inflight, dict(ctrl.model_inflight)))
    return out


def test_public_admit_same_outcomes():
    j = _public_admits(jadm, jchaos, JDeadline)
    t = _public_admits(tadm, tchaos, TDeadline)
    assert j == t
    assert ("reject", "chaos", 40) == t[4][:3] == t[5][:3]


def test_tenant_of_request_and_keys():
    req = types.SimpleNamespace(tenant_id="")

    class Ctx:
        def invocation_metadata(self):
            return (("tpulab-trace-id", "ab"), ("tpulab-tenant", "acme"))
    for mod in (jadm, tadm):
        assert mod.tenant_of_request(req, Ctx()) == "acme"
        assert mod.tenant_of_request(req) == mod.DEFAULT_TENANT
        assert mod.tenant_of_request(types.SimpleNamespace(
            tenant_id="t9"), Ctx()) == "t9"
    assert (tadm.TENANT_METADATA_KEY, tadm.REJECT_REASONS,
            tadm.REQUEST_CLASSES) == (jadm.TENANT_METADATA_KEY,
                                      jadm.REJECT_REASONS,
                                      jadm.REQUEST_CLASSES)
