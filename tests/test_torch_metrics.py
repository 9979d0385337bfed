"""The port's Prometheus metrics (``tpulab_torch.utils.metrics``, no
prometheus_client) against tpulab's (prometheus_client), on the CPU.

Each ported class is built on both sides and fed the same observations
(event hooks and ``poll`` over the same stand-in subsystems).  tpulab's
registry is read through ``prometheus_client.generate_latest``, the
port's through its own ``generate_latest``, and BOTH texts are parsed by
``prometheus_client.parser.text_string_to_metric_families``.  Families,
types, help strings, sample names, labels and values must be equal.
Two differences are ignored, by design: the ``_created`` series
prometheus_client adds to counters and histograms (the port emits none),
and the spelling of a float (``1.0`` against ``1``, ``+Inf``), which the
parser normalizes.  Values are compared exactly (the same float
arithmetic on both sides).

Also: the family inventory of the ported classes equals tpulab's and the
families are pairwise disjoint (one scrape endpoint for all of them);
one ``start_metrics_server`` scrape over HTTP; ChaosMetrics installed as
the fire observer; GenerationMetrics fed by a live port batcher.
"""

import urllib.request

import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry as PromRegistry
from prometheus_client import generate_latest as prom_latest
from prometheus_client.parser import text_string_to_metric_families

import tpulab.utils.metrics as J
import tpulab_torch.utils.metrics as T

PORTED = ("InferenceMetrics", "GenerationMetrics", "KVTierMetrics",
          "ModelStoreMetrics", "HBMMetrics", "AdmissionMetrics",
          "ChaosMetrics", "SLOMetrics", "ReplicaSetMetrics", "FleetMetrics",
          "BatchMetrics", "KVFabricMetrics", "FederationMetrics")


def _families(text):
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.endswith("_created"):
            continue
        samples = sorted(
            (s.name, tuple(sorted(s.labels.items())), s.value)
            for s in fam.samples if not s.name.endswith("_created"))
        out[fam.name] = (fam.type, fam.documentation, samples)
    return out


def _pair(name):
    return (getattr(J, name)(registry=PromRegistry()),
            getattr(T, name)(registry=T.CollectorRegistry()))


def _exposed(j, t):
    return (_families(prom_latest(j.registry).decode()),
            _families(T.generate_latest(t.registry).decode()))


# -- stand-in subsystems for poll() -------------------------------------------
class _Obj:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Store(_Obj):
    def __len__(self):
        return self.n


def _batcher(step):
    pc = _Obj(hits=3 * step, misses=2 * step + 1)
    return _Obj(active_lanes=step % 3, queued_requests=step,
                pool=_Obj(free_pages=100 - step), tokens_generated=40 * step,
                completed_requests=3 * step, preemptions=step // 2,
                decode_dispatches=7 * step, decode_host_syncs=5 * step,
                ragged_dispatches=6 * step,
                dispatch_kinds={"decode": 4 * step, "verify": step,
                                "mixed": 2 * step},
                spec_tokens_drafted=10 * step, spec_tokens_accepted=7 * step,
                spec_fallbacks=step, spec_probes=step // 2,
                spec_probe_recoveries=step // 3, prefix_cache=pc)


def _kv_manager(step):
    return _Obj(swap_out_bytes=4096 * step, swap_in_bytes=2048 * step,
                swap_outs=step, swap_ins=step - 1 if step else 0,
                demotions=2 * step, promotions=step, swap_failures=step // 2,
                swap_drops=step // 3, recompute_tokens_saved=100 * step,
                store=_Store(drops=step, evictions=2 * step,
                             bytes_used=1000 * step, n=step + 1))


def _mux(step):
    return _Obj(swap_ins=step, swap_outs=step + 1, swap_in_bytes=10 * step,
                swap_out_bytes=11 * step, evictions=step // 2,
                cold_rebuilds=step // 3, swap_failures=0, swap_drops=step,
                store=_Obj(evictions=step, bytes_used=5 << 20),
                resident_models=lambda: ["a", "b"][:step % 3],
                host_models=lambda: ["c"] * (step % 2),
                hbm_bytes_in_use=123456 * step)


class _Ledger:
    def __init__(self, step):
        self.step = step

    def tenants(self):
        return ["weights", "kv", "scratch"]

    def tenant_bytes(self, t):
        return {"weights": 1 << 30, "kv": self.step << 20,
                "scratch": 4096}[t]

    def tenant_claims(self, t):
        return {"weights": 2, "kv": 1, "scratch": self.step}[t]


def _arbiter(step):
    return _Obj(capacity_bytes=80 << 30, free_hbm_bytes=(1 << 30) - step,
                ledger=_Ledger(step), pressure_events=step, grants=3 * step,
                demotions_forced=step // 2, evictions_forced=step // 3,
                denials=step // 4)


def _scheduler(step):
    return _Obj(jobs_running=step % 2, soak_utilization=step / 8,
                jobs_done=step // 3, interrupted_runs=step // 4,
                items_done=3 * step, tokens_delivered=40 * step,
                tokens_resume_skipped=7 * step, spare_denials=step * step,
                engine=_Obj(batch_preemptions=step // 2))


def _feed(name, m):
    """The same observation sequence for either package's instance."""
    rng = np.random.default_rng(0)
    xs = [float(v) for v in rng.exponential(0.05, 40)]
    if name == "InferenceMetrics":
        for i, x in enumerate(xs):
            m.observe_request(x + 0.01, x, model="rn50" if i % 2 else None)
            if i % 3 == 0:
                m.inc_queue_depth()
            if i % 5 == 0:
                m.dec_queue_depth()
        m.refresh_quantiles()
        m.hbm_bytes_in_use.set(3 << 30)
        m.framework_hbm_bytes.set(2 << 30)
    elif name == "GenerationMetrics":
        for x in xs:
            m.observe_queue_wait(x)
            m.observe_ttft(2 * x)
            m.observe_itl(x / 10)
            m.observe_e2e(20 * x)
        m.note_deadline_expired()
        m.note_resume(5)
        m.note_resume(0)
        for step in (1, 2, 5, 5, 9):
            m.poll(_batcher(step))
        assert m.ttft_quantiles()["p50"] > 0
    elif name == "KVTierMetrics":
        for x in xs:
            m.observe_swap_out(x, 4096)
            m.observe_swap_in(x / 2, 4096)
        for step in (1, 3, 3, 7):
            m.poll(_kv_manager(step))
    elif name == "ModelStoreMetrics":
        for x in xs:
            m.observe_swap_in(x, 1)
            m.observe_swap_out(3 * x, 1)
        for step in (1, 2, 4):
            m.poll(_mux(step))
    elif name == "HBMMetrics":
        for step in (1, 4, 4, 6):
            m.poll(_arbiter(step))
    elif name == "AdmissionMetrics":
        for i, x in enumerate(xs):
            m.note_admitted(f"t{i % 3}", x)
            if i % 4 == 0:
                m.note_rejected(("shed", "queue_full", "tenant_rate")[i % 3],
                                f"t{i % 2}")
        m.set_pressure(7, 3)
        assert m.queue_wait_quantiles()["p99"] > 0
    elif name == "ChaosMetrics":
        for i in range(10):
            m.observe(("engine.step", "rpc.stream")[i % 2],
                      ("error", "delay", "drop")[i % 3])
    elif name == "ReplicaSetMetrics":
        reps = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
        for a in reps:
            m.set_breaker_state(a, "closed")
        for i, x in enumerate(xs):
            a = reps[i % 3]
            m.requests.labels(replica=a).inc()
            m.inflight.labels(replica=a).set(i % 4)
            m.note_attempt(("OK", "UNAVAILABLE", "STALLED")[i % 3])
            m.observe_deadline(i % 5 != 0, x)
            m.note_affinity(hit=i % 4 != 0)
            m.note_hedge(won=i % 6 == 0)
        m.failovers.inc(3)
        m.live.labels(replica=reps[0]).set(1)
        m.live.labels(replica=reps[1]).set(0)
        for to in ("open", "probing", "open", "probing", "closed"):
            m.note_breaker_transition(reps[1], to)
        m.note_breaker_transition(reps[2], "open")
        m.note_stall()
        m.note_resume()
        m.note_resume_fallback()
        m.note_tokens_replayed(5)
        m.note_tokens_replayed(0)
        m.note_ring_moves(7)
        m.prefix_hits.labels(replica=reps[0]).set(12)
        m.prefix_lookups.labels(replica=reps[0]).set(20)
        for fam in (m.requests, m.inflight):    # a retired replica
            fam.remove(reps[2])
        for st in ("closed", "open", "probing"):
            m.breaker_state.remove(reps[2], st)
            m.breaker_transitions.remove(reps[2], st)
    elif name == "FleetMetrics":
        for up in (True, True, False):
            m.note_scale(up=up)
        m.note_drain()
        m.set_replicas(3)
        m.set_queue_wait(0.125)
        m.set_queue_wait(-1.0)
        m.note_death()
        m.note_respawn()
        m.note_crash_loop()
        for lead in (True, True, False, True):
            m.set_leader(lead)
    elif name == "BatchMetrics":
        for step in (1, 3, 3, 8, 5, 9):
            m.poll(_scheduler(step))
    elif name == "KVFabricMetrics":
        for x in xs:
            m.observe_pull(x, 4096)
        for step in (1, 2, 2, 6):
            m.poll(_Obj(pulls=3 * step, pull_bytes=4096 * step,
                        coalesced=step // 2, cost_gate_skips=step % 3,
                        degrades=step - 1, recompute_tokens_saved=64 * step))
    elif name == "FederationMetrics":
        reps = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
        for i, x in enumerate(xs[:6]):
            keep = reps[:1 + i % 3]
            for j, a in enumerate(keep):
                m.set_replica(a, up=(i + j) % 4 != 0, inflight=i + j,
                              queued=i % 3, free_hbm_bytes=(j + 1) << 30,
                              free_kv_pages=100 - i, draining=j == 2,
                              prefix_hits=2 * i, prefix_lookups=3 * i,
                              resident_models=j)
            m.prune(keep)
            m.observe_scrape(x, len(keep))
    elif name == "SLOMetrics":
        for i in range(30):
            m.note_request(f"t{i % 3}", "batch" if i % 4 == 0 else "online",
                           error=i % 5 == 0, breach=i % 7 == 0)
        m.set_burn("t0", "online", "fast", 2.5, 0.0)
        m.set_burn("t1", "batch", "slow", 0.125, 14.0)


@pytest.mark.parametrize("name", PORTED)
def test_exposition_matches_prometheus_client(name):
    j, t = _pair(name)
    before = _exposed(j, t)
    assert before[1] == before[0]          # the empty exposition too
    _feed(name, j)
    _feed(name, t)
    want, got = _exposed(j, t)
    assert got == want
    assert any(s for _typ, _doc, s in got.values())


def test_inventory_equals_tpulab_and_is_disjoint():
    """The ported classes export tpulab's family names (with a counter's
    exported ``_total``), pairwise disjoint; every tpulab set is
    ported."""
    names = {n for n in dir(J) if n.endswith("Metrics")}
    assert names == set(PORTED)
    owned = {}
    for name in PORTED:
        j, t = _pair(name)
        fams = []
        for reg, latest in ((j.registry, prom_latest),
                            (t.registry, T.generate_latest)):
            fams.append({f.name + ("_total" if f.type == "counter" else "")
                         for f in text_string_to_metric_families(
                             latest(reg).decode())
                         if not f.name.endswith("_created")})
        assert fams[1] == fams[0] and fams[1], name
        owned[name] = fams[1]
    for a in PORTED:
        for b in PORTED:
            if a < b:
                assert not owned[a] & owned[b], (a, b)
    for const in ("TTFT_BUCKETS", "ITL_BUCKETS", "E2E_BUCKETS",
                  "SLACK_BUCKETS", "LOAD_RATIO_BUCKETS", "SWAP_BUCKETS",
                  "BREAKER_STATES"):
        assert getattr(T, const) == getattr(J, const), const


def test_registry_rules():
    reg = T.CollectorRegistry()
    T.Counter("x_total", "x", registry=reg)
    with pytest.raises(ValueError, match="Duplicated"):
        T.Gauge("x", "again", registry=reg)
    c = T.Counter("y", "y", ["a"], registry=reg)
    with pytest.raises(ValueError):
        c.inc()
    with pytest.raises(ValueError):
        c.labels(b="1")
    with pytest.raises(ValueError):
        c.labels(a="1").inc(-1)
    with pytest.raises(ValueError, match="le"):
        T.Histogram("h", "h", ["le"])
    c.labels(a='q"\n\\').inc(2)
    text = T.generate_latest(reg).decode()
    assert 'y_total{a="q\\"\\n\\\\"} 2.0' in text
    fams = _families(text)
    assert fams["y"][2] == [("y_total", (("a", "1"),), 0.0),
                            ("y_total", (("a", 'q"\n\\'),), 2.0)]


def test_metrics_server_scrape():
    """``start_metrics_server(port=0)`` on the loopback: one scrape
    returns every set passed in, in the text format the parser reads."""
    g = T.GenerationMetrics()
    a = T.AdmissionMetrics()
    g.observe_ttft(0.02)
    a.note_admitted("t", 0.001)
    server, thread = T.start_metrics_server([g, a], port=0,
                                            addr="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{server.server_port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            ctype = r.headers["Content-Type"]
            text = r.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert ctype == T.CONTENT_TYPE_LATEST
    fams = _families(text)
    ttft = dict((s[0], s[2]) for s in fams["tpulab_llm_ttft_seconds"][2])
    assert ttft["tpulab_llm_ttft_seconds_count"] == 1.0
    assert fams["tpulab_admission_admitted"][2] == [
        ("tpulab_admission_admitted_total", (("tenant", "t"),), 1.0)]
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_chaos_metrics_count_trips():
    from tpulab_torch import chaos
    m = T.ChaosMetrics().install()
    try:
        with chaos.inject("engine.step=delay:0+2;rpc.stream=error@1"):
            for _ in range(3):
                chaos.trip("engine.step")
            assert chaos.trip("rpc.stream") is None     # @1: skipped
            with pytest.raises(chaos.ChaosError):
                chaos.trip("rpc.stream")
    finally:
        m.uninstall()
    assert chaos._OBSERVER is None
    got = {s[1]: s[2] for s in _families(T.generate_latest(
        m.registry).decode())["tpulab_chaos_injections"][2]}
    assert got == {(("action", "delay"), ("point", "engine.step")): 2.0,
                   (("action", "error"), ("point", "rpc.stream")): 1.0}


def test_generation_metrics_on_a_live_batcher():
    """A port batcher with ``metrics=GenerationMetrics()``: one TTFT per
    request, one inter-token sample per later token, one e2e per
    completion; ``poll`` mirrors the batcher's counters."""
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import init_transformer_params

    torch.set_num_threads(2)
    m = T.GenerationMetrics(model="lm")
    p = init_transformer_params(64, 32, 2, 2, 64, seed=0, device="cpu")
    cb = ContinuousBatcher(p, n_heads=2, n_layers=2, lanes=2, max_len=64,
                           page_size=8, compute_dtype=torch.float32,
                           device="cpu", metrics=m)
    try:
        for f in [cb.submit(np.arange(4) + i, 6) for i in range(3)]:
            f.result(timeout=120)
        m.poll(cb)
    finally:
        cb.shutdown()
    fams = _families(T.generate_latest(m.registry).decode())

    def val(fam, sample):
        return dict((s[0], s[2]) for s in fams[fam][2])[sample]

    assert val("tpulab_llm_ttft_seconds", "tpulab_llm_ttft_seconds_count") \
        == 3.0
    assert val("tpulab_llm_inter_token_seconds",
               "tpulab_llm_inter_token_seconds_count") == 15.0
    assert val("tpulab_llm_e2e_seconds", "tpulab_llm_e2e_seconds_count") \
        == 3.0
    assert val("tpulab_llm_tokens", "tpulab_llm_tokens_total") == \
        cb.tokens_generated == 18
    assert val("tpulab_llm_requests_completed",
               "tpulab_llm_requests_completed_total") == 3.0
    assert val("tpulab_llm_decode_dispatches",
               "tpulab_llm_decode_dispatches_total") == cb.decode_dispatches


def test_poll_device_without_cuda():
    """On a host without CUDA ``poll_device`` leaves the memory gauges
    and refreshes the quantiles (a CUDA run reads the caching
    allocator: chip_smoke.py phase 9)."""
    m = T.InferenceMetrics()
    m.observe_request(0.02, 0.01)
    m.observe_request(0.04, 0.03)
    m.poll_device()
    fams = _families(T.generate_latest(m.registry).decode())
    q = dict((dict(s[1])["quantile"], s[2])
             for s in fams["tpulab_request_duration_seconds"][2])
    assert q["0.5"] == pytest.approx(0.03)
    if not torch.cuda.is_available():
        assert fams["tpulab_hbm_bytes_in_use"][2][0][2] == 0.0
