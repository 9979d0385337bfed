"""tpulab_torch.obs against tpulab.obs, on the CPU.

- the flight recorder's retention policy and its JSONL / Chrome dumps:
  tpulab's cases (``tests/test_obs.py``) run on both recorders with
  identical events; records, keeps and counters equal exactly
  (``wall_time`` is the clock's and is left out);
- the batcher's wide events on one scripted f32 trace (two requests
  admitted together, a priority arrival preempting one of them through
  the host KV tier, a request expiring in the queue, a chaos rule firing
  during the first): the deterministic fields — lane, pages, pages_peak,
  block_ks, tokens, preempts, swap_outs / swap_ins, chaos_trips,
  outcome, keep (under a ``p99_min_n`` no run reaches) — equal tpulab's
  exactly; the recorder armed changes no token;
- ``SLOTracker`` against tpulab's under one fake clock: equal burn-rate
  documents, scale signal and snapshot;
- ``debug_snapshot`` over the same subsystems: the same section keys
  (the port's batcher lacks three of tpulab's fields and adds one, named
  below);
- the Debug RPC cross-wire both ways over the gRPC loopback (the port's
  server with tpulab's client, tpulab's server with the port's client):
  the live lane mid-stream, UNKNOWN_MODEL, INVALID_ARGUMENT, and
  ``profile_ticks`` through the CPU profiler (``trace.json`` written, the
  forward steps of the capture counted, a second capture refused);
- the service's wide events (chaos-hit, deadline, slowest exemplar);
- ``benchmark_obs_overhead`` at tpulab's default size: token parity and
  tpulab's row fields.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulab
import tpulab.rpc.infer_service as jsvc
import tpulab_torch
import tpulab_torch.rpc.infer_service as tsvc
from tpulab import chaos as jchaos
from tpulab.engine.generation import GenerationEngine as JDense
from tpulab.engine.paged import ContinuousBatcher as JBatcher
from tpulab.engine.paged import SamplingParams as JSampling
from tpulab.hbm import HBMArbiter as JArb
from tpulab.models.transformer import init_transformer_params
from tpulab.obs import FlightRecorder as JFlight
from tpulab.obs import SLOTracker as JSLO
from tpulab.obs import debug_snapshot as jdebug
from tpulab.serving import AdmissionConfig as JAdmCfg
from tpulab.serving import AdmissionController as JAdm
from tpulab_torch import chaos as tchaos
from tpulab_torch.engine.generation import GenerationEngine as TDense
from tpulab_torch.engine.paged import ContinuousBatcher as TBatcher
from tpulab_torch.engine.paged import SamplingParams as TSampling
from tpulab_torch.hbm import HBMArbiter as TArb
from tpulab_torch.models.convert import params_from_numpy
from tpulab_torch.obs import FlightRecorder as TFlight
from tpulab_torch.obs import SLOTracker as TSLO
from tpulab_torch.obs import debug_snapshot as tdebug
from tpulab_torch.serving import AdmissionConfig as TAdmCfg
from tpulab_torch.serving import AdmissionController as TAdm
from tpulab_torch.utils import tracing

torch.set_num_threads(2)

V, D, H, L, F = 64, 32, 2, 2, 64
CFG = dict(n_heads=H, n_layers=L, lanes=2, max_len=96, page_size=8,
           decode_block=4)


@pytest.fixture(scope="module")
def lm():
    p = init_transformer_params(vocab=V, d_model=D, n_heads=H, n_layers=L,
                                d_ff=F)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu", n_heads=H)


def _jb(lm, **kw):
    return JBatcher(lm[0], compute_dtype=jnp.float32, use_kernel=False,
                    **dict(CFG, **kw))


def _tb(lm, **kw):
    return TBatcher(lm[1], compute_dtype=torch.float32, device="cpu",
                    **dict(CFG, **kw))


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "wall_time"} for r in recs]


# -- the recorder alone ------------------------------------------------------
def _retention_events():
    evs = [{"outcome": "SUCCESS", "e2e_s": 0.010, "i": i}
           for i in range(24)]
    evs += [{"outcome": "DEADLINE_EXCEEDED", "e2e_s": 0.5},
            {"outcome": "RESOURCE_EXHAUSTED"},
            {"outcome": "INTERNAL", "e2e_s": 0.02},
            {"outcome": "SUCCESS", "stalled": True},
            {"outcome": "SUCCESS", "chaos_trips": {"rpc.stream": 1}},
            {"outcome": "SUCCESS", "e2e_s": 9.0}]
    return evs


def _policy_view(fr, ids):
    return dict(ids=ids, kept=dict(fr.kept_by_reason),
                dropped=fr.dropped_total, observed=fr.observed_total,
                exemplars=fr.exemplar_ids(), n=len(fr),
                records=_strip(fr.records()),
                sampled=_strip(fr.records(keep="sampled")))


def test_tail_retention_policy_matches_tpulab():
    """tpulab's retention case on both recorders: a ring sized to drop
    uniform traffic keeps every always-keep class, samples healthy
    traffic 1 in 4, and retains the same ids."""
    views = []
    for cls in (JFlight, TFlight):
        fr = cls(tail_capacity=16, uniform_capacity=2, sample_every=4,
                 p99_min_n=8)
        ids = [fr.observe(dict(e)) for e in _retention_events()]
        views.append(_policy_view(fr, ids))
    want, got = views
    assert got == want
    assert got["kept"] == {"sampled": 6, "deadline": 1, "overload": 1,
                           "error": 1, "stall": 1, "chaos": 1, "slow": 1}
    assert got["dropped"] == 22 and got["exemplars"][-1] == 30


def test_flight_jsonl_and_chrome_roundtrip_matches_tpulab(tmp_path):
    t0 = time.perf_counter()
    events = [
        {"outcome": "SUCCESS", "tenant": "a", "model": "lm",
         "t_submit": t0, "t_prefill0": t0 + 0.01, "t_first": t0 + 0.02,
         "t_last": t0 + 0.05, "e2e_s": 0.06, "tokens": 4},
        {"outcome": "DEADLINE_EXCEEDED", "tenant": "b", "t_submit": t0,
         "t_prefill0": t0 + 0.001, "e2e_s": 0.2}]
    out = {}
    for name, cls in (("tpulab", JFlight), ("port", TFlight)):
        fr = cls(sample_every=1)
        for e in events:
            fr.observe(dict(e))
        p = str(tmp_path / f"{name}.jsonl")
        n = fr.dump_jsonl(p)
        lines = _strip([json.loads(ln) for ln in open(p)])
        ct = str(tmp_path / f"{name}.json")
        m = fr.save_chrome_trace(ct)
        doc = json.load(open(ct))
        spans = sorted((e["name"], e["ph"], e.get("tid"), e.get("dur"),
                        json.dumps(e.get("args"), sort_keys=True))
                       for e in doc["traceEvents"] if e["ph"] == "X")
        out[name] = (n, lines, m, spans)
    assert out["port"] == out["tpulab"]
    n, lines, m, spans = out["port"]
    assert n == m == 2 and lines[1]["keep"] == "deadline"
    assert {"queue_wait", "prefill", "decode", "request"} <= {
        s[0] for s in spans}


# -- the batcher's wide events -------------------------------------------------
FIELDS = ("outcome", "lane", "pages", "pages_peak", "block_ks", "tokens",
          "preempts", "swap_outs", "swap_ins", "chaos_trips", "keep",
          "prompt_tokens", "steps", "priority", "request_class", "kind",
          "spec_drafted", "spec_accepted", "spec_acceptance")


def _scripted(cb, chaos, fr):
    """A and B admitted in one pass; A's fourth token submits C
    (priority 10, preempting B through the host tier) and D (a 1 ms
    budget that expires in the queue); the first decode tick trips a
    zero-delay chaos rule while A and B are in flight."""
    rng = np.random.default_rng(3)
    pa, pb, pc, pd = (rng.integers(0, V, (n,), np.int32)
                      for n in (6, 9, 5, 4))
    held = {}

    def hook(tok, i):
        if i == 3 and "c" not in held:
            held["c"] = cb.submit(pc, 6, priority=10, tenant="C")
            held["d"] = cb.submit(pd, 4, deadline=0.001, tenant="D")

    with chaos.inject("engine.step=delay:0+1"):
        with cb._cv:
            fa = cb.submit(pa, 20, on_token=hook, tenant="A")
            fb = cb.submit(pb, 20, tenant="B")
        toks = [fa.result(timeout=120), fb.result(timeout=120),
                held["c"].result(timeout=120)]
        with pytest.raises(Exception, match="deadline"):
            held["d"].result(timeout=120)
    deadline = time.monotonic() + 10
    while fr.observed_total < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    recs = {r["tenant"]: {k: r.get(k) for k in FIELDS}
            for r in fr.records()}
    return [list(map(int, t)) for t in toks], recs


def test_batcher_flight_events_match_tpulab(lm):
    """The scripted trace on tpulab's batcher and the port's (ragged
    plan, host KV tier on): every deterministic field of the four wide
    events is equal."""
    out = {}
    for name, make, chaos, flight in (("tpulab", _jb, jchaos, JFlight),
                                      ("port", _tb, tchaos, TFlight)):
        fr = flight(sample_every=1, p99_min_n=10_000)
        cb = make(lm, ragged=True, kv_offload=True, flight=fr)
        try:
            out[name] = _scripted(cb, chaos, fr)
            out[name] += (cb.preemptions, cb.kv_offload.swap_outs,
                          cb.kv_offload.swap_ins)
        finally:
            cb.shutdown()
    toks, recs, preempts, outs, ins = out["port"]
    assert preempts == 1 and outs == ins == 1
    assert recs["B"]["preempts"] == 1 and recs["B"]["swap_outs"] == 1
    assert recs["B"]["swap_ins"] == 1
    assert recs["A"]["chaos_trips"] == {"engine.step": 1}
    assert recs["A"]["keep"] == "chaos" and recs["C"]["keep"] == "sampled"
    assert recs["D"]["outcome"] == "DEADLINE_EXCEEDED"
    assert recs["D"]["keep"] == "deadline" and recs["D"]["lane"] == -1
    assert [len(t) for t in toks] == [20, 20, 6]
    assert recs == out["tpulab"][1]
    assert out["port"][2:] == out["tpulab"][2:]


@pytest.mark.parametrize("plan", ("ragged", "split"))
def test_flight_armed_changes_no_tokens(lm, plan):
    """The recorder and a trace recorder observe, never steer: greedy
    and seeded device-sampled streams are bit-identical armed vs bare,
    and engine-level completions record themselves."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, V, (6,), np.int32) for _ in range(3)]

    def run(flight, trace):
        cb = _tb(lm, ragged=plan == "ragged", flight=flight, trace=trace)
        try:
            futs = [cb.submit(p, 10) for p in prompts]
            futs.append(cb.submit(prompts[0], 10, sampling=TSampling(
                temperature=0.8, seed=42, device=True)))
            return [list(f.result(timeout=120)) for f in futs]
        finally:
            cb.shutdown()

    fr = TFlight(sample_every=1)
    rec = tracing.ChromeTraceRecorder()
    assert run(None, None) == run(fr, rec)
    assert fr.observed_total == 4
    assert all(r["kind"] == "paged" and r["outcome"] == "SUCCESS"
               for r in fr.records())
    assert len(rec) > 0


# -- the SLO tracker -------------------------------------------------------------
def test_slo_tracker_matches_tpulab():
    """The same event stream under one fake clock: equal burn-rate
    documents (both windows), scale signal and snapshot."""
    rng = np.random.default_rng(1)
    outcomes = ("SUCCESS",) * 6 + ("INTERNAL", "DEADLINE_EXCEEDED",
                                   "CANCELLED")
    events = [{"tenant": f"t{int(rng.integers(0, 3))}",
               "request_class": ("batch" if rng.random() < 0.2
                                 else "online"),
               "outcome": outcomes[int(rng.integers(0, len(outcomes)))],
               "e2e_s": float(rng.exponential(1.5))} for _ in range(300)]
    docs = []
    for cls in (JSLO, TSLO):
        clock = [1000.0]
        tr = cls(fast_window_s=60.0, slow_window_s=600.0, max_tenants=2,
                 clock=lambda: clock[0])
        trail = []
        for i, e in enumerate(events):
            tr.observe(dict(e))
            clock[0] += 3.0
            if i % 50 == 49:
                trail.append((tr.burn_rates(), tr.scale_signal()))
        docs.append((trail, tr.snapshot(), tr.export()))
    assert docs[1] == docs[0]
    snap = docs[1][1]
    assert snap["tenants_dropped"] > 0 and snap["observed_total"] > 0


# -- debugz ---------------------------------------------------------------------
#: fields tpulab's batcher reports that the port's has no counterpart for
#: (no sharded pool, no XLA-gather escape hatch)
PORT_LACKS = {"pool": {"n_shards"}, "dispatch": {"use_kernel"}}
#: and the ones the port adds: the arbiter's pressure rounds (which
#: tpulab reports in its flight events only), the forward-step counters
#: and the CUDA kernels' launch counters, which a parent reads from a
#: replica process to hold its kernel launches against its forwards
PORT_ADDS = {"engine": {"hbm_pressure_events"},
             "dispatch": {"forward_steps", "draft_forward_steps"},
             "top": {"kernels"}}


def _snapshot_keys(snap):
    eng = snap["engines"]["lm"]
    busy = [r for r in eng["lanes"] if r["state"] != "idle"]
    return dict(top=set(snap), engine=set(eng), pool=set(eng["pool"]),
                dispatch=set(eng["dispatch"]),
                lane=set(busy[0]) if busy else set(),
                queue=set(eng["queue_head"][0]) if eng["queue_head"]
                else set(),
                admission=set(snap["admission"]), hbm=set(snap["hbm"]),
                chaos=set(snap["chaos"]), flight=set(snap["flight"]),
                watchdog=set(snap["watchdog"]))


def test_debug_snapshot_keys_match_tpulab(lm):
    """Both packages' snapshots over the same subsystems (a batcher under
    an arbiter with one lane busy and one request queued, admission, a
    flight recorder, armed chaos, a watchdog): the same sections and
    keys, but for PORT_LACKS and PORT_ADDS."""
    class Wd:
        healthy = True

    keys = {}
    for name, make, arb_cls, adm_cls, cfg_cls, fl_cls, chaos, debug in (
            ("tpulab", _jb, JArb, JAdm, JAdmCfg, JFlight, jchaos, jdebug),
            ("port", _tb, TArb, TAdm, TAdmCfg, TFlight, tchaos, tdebug)):
        arb = arb_cls(64 << 20, measure_scratch=False)
        cb = make(lm, ragged=True, hbm=arb, lanes=1)
        adm = adm_cls(cfg_cls(max_inflight=4), load=cb)
        fr = fl_cls()
        gate = threading.Event()
        try:
            with chaos.inject("engine.step=delay:0.01"):
                f1 = cb.submit([1, 2, 3], 40, tenant="x", trace_id="a" * 16,
                               on_token=lambda t, i: i == 2 and gate.set())
                f2 = cb.submit([4, 5], 4, tenant="y")
                assert gate.wait(60)
                snap = debug(generation_engines={"lm": cb}, admission=adm,
                             hbm=arb, flight=fr, watchdog=Wd())
                f1.result(timeout=120)
                f2.result(timeout=120)
            keys[name] = _snapshot_keys(snap)
            json.dumps(snap, default=str)
        finally:
            cb.shutdown()
    want = dict(keys["tpulab"])
    for section, missing in PORT_LACKS.items():
        assert missing <= want[section]
        want[section] = want[section] - missing
    for section, added in PORT_ADDS.items():
        assert not added & want[section]
        want[section] = want[section] | added
    assert keys["port"] == want
    assert {"tenant", "trace_id", "request_class"} <= keys["port"]["lane"]


# -- the Debug RPC over the loopback, both ways -----------------------------------
@pytest.fixture(scope="module")
def servers(lm):
    """tpulab's service and the port's, each with a paged batcher ("lm",
    with a flight recorder) and a dense engine ("dense")."""
    jfr, tfr = JFlight(p99_min_n=10_000), TFlight(p99_min_n=10_000)
    jcb, tcb = _jb(lm, ragged=True), _tb(lm, ragged=True)
    jd = JDense(lm[0], n_heads=H, n_layers=L, max_len=64, max_sessions=1,
                compute_dtype=jnp.float32)
    td = TDense(lm[1], n_heads=H, n_layers=L, max_len=64, max_sessions=1,
                compute_dtype=torch.float32, device="cpu")
    jm = tpulab.InferenceManager(max_exec_concurrency=1)
    jm.serve(port=0, generation_engines={"lm": jcb, "dense": jd},
             flight=jfr)
    tm = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                       device="cpu")
    tm.serve(port=0, generation_engines={"lm": tcb, "dense": td},
             flight=tfr)
    yield dict(jm=jm, tm=tm, jcb=jcb, tcb=tcb, jfr=jfr, tfr=tfr)
    for x in (jm, tm, jcb, tcb):
        x.shutdown()


def _remote(svc, mgr):
    return svc.RemoteInferenceManager(f"127.0.0.1:{mgr.server.bound_port}")


WIRES = {"port server, tpulab client": ("tm", "tcb", jsvc, jchaos),
         "tpulab server, port client": ("jm", "jcb", tsvc, tchaos)}


@pytest.mark.parametrize("wire", list(WIRES))
def test_debug_rpc_cross_wire(servers, wire):
    """Mid-stream, the snapshot over the wire shows the live lane (tenant,
    trace id, decode state, pages); an unknown model is UNKNOWN_MODEL and
    profile_ticks on the dense engine INVALID_ARGUMENT, on either side."""
    mgr_key, cb_key, svc, chaos = WIRES[wire]
    server_chaos = tchaos if mgr_key == "tm" else jchaos
    rm = _remote(svc, servers[mgr_key])
    done = threading.Event()

    def run():
        with server_chaos.inject("engine.step=delay:0.02"):
            list(svc.GenerateStreamClient(rm, "lm").generate(
                [5, 6, 7, 8], 40, tenant_id="midstream",
                trace_id="f" * 16))
        done.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    row, snap = None, None
    deadline = time.monotonic() + 60
    try:
        while time.monotonic() < deadline and not done.is_set():
            snap = rm.debugz()
            rows = [r for r in snap["engines"]["lm"]["lanes"]
                    if r.get("tenant") == "midstream"
                    and r["state"] == "decode" and r["tokens"] > 0]
            if rows:
                row = rows[0]
                break
            time.sleep(0.01)
        th.join(timeout=120)
        assert row is not None, "never caught the request mid-stream"
        assert row["trace_id"] == "f" * 16 and row["pages"] >= 1
        assert 0 < row["tokens"] < 40 and row["steps"] == 40
        assert snap["chaos"]["armed"] is True
        assert snap["flight"]["observed_total"] >= 0
        assert snap["server_version"] and "stage_profile" in snap
        raw = rm.debugz_raw()
        assert raw.status.code == svc.pb.SUCCESS
        with pytest.raises(RuntimeError, match="UNKNOWN_MODEL"):
            rm.debugz(model_name="nope")
        with pytest.raises(RuntimeError, match="INVALID_ARGUMENT"):
            rm.debugz(model_name="dense", profile_ticks=2)
    finally:
        rm.close()


def test_debug_rpc_profile_ticks_capture(servers, tmp_path):
    """profile_ticks over the wire (tpulab's client, the port's server)
    arms torch.profiler on the batcher's scheduler thread; traffic then
    fills ``trace.json``; the capture's forward steps are counted; a
    second arm while one is pending reports "already armed" and still
    returns the snapshot; an outer profiler session refuses a capture."""
    cb = servers["tcb"]
    rm = _remote(jsvc, servers["tm"])
    try:
        snap = rm.debugz(model_name="lm", profile_ticks=2,
                         profile_dir=str(tmp_path))
        assert snap["profile_dir"] == str(tmp_path)
        assert snap["engines"]["lm"]["profile_armed"] is True
        again = rm.debugz(model_name="lm", profile_ticks=2)
        assert "already armed" in again["debug_message"]
        assert "engines" in again
        deadline = time.monotonic() + 60
        while cb._profile is not None and time.monotonic() < deadline:
            list(jsvc.GenerateStreamClient(rm, "lm").generate(
                [9, 10, 11], 6, tenant_id="prof"))
        assert cb._profile is None
        prof = cb.last_profile
        assert "error" not in prof and prof["forward_steps"] > 0
        trace = json.load(open(os.path.join(str(tmp_path), "trace.json")))
        assert trace["traceEvents"]
    finally:
        rm.close()
    with tracing.profiler_session():
        with pytest.raises(RuntimeError, match="already armed"):
            cb.arm_profile(2)
        assert cb._profile is None



def test_debug_rpc_refused_under_a_session_on_another_thread(servers):
    """A bare ``torch.profiler`` session on one thread, Debug with
    ``profile_ticks`` from another (the server's handler thread arms):
    "already armed", no capture pending, and the session is left as it
    was."""
    from torch.profiler import ProfilerActivity, profile

    cb = servers["tcb"]
    rm = _remote(jsvc, servers["tm"])
    opened, close, out = threading.Event(), threading.Event(), {}

    def bare():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            opened.set()
            close.wait(60)
            torch.ones(4) + 1
        out["events"] = len(prof.events())

    th = threading.Thread(target=bare)
    th.start()
    try:
        assert opened.wait(30)
        snap = rm.debugz(model_name="lm", profile_ticks=2)
        assert "already armed" in snap["debug_message"]
        assert "engines" in snap and cb._profile is None
    finally:
        close.set()
        th.join(60)
        rm.close()
    assert out["events"] > 0 and cb._profile is None

# -- the service's wide events ----------------------------------------------------
def test_service_wide_events_tail_retention(lm):
    """Through the port's serving path: a chaos-hit stream is kept as
    ``chaos`` (``engine.step`` fired once), a stream over its deadline as
    ``deadline``, the slowest as a ``slow`` exemplar; the engine and
    admission halves land in the merged event, and Infer-less uniform
    traffic is squeezed out of the 2-slot sampled ring."""
    from tpulab_torch.rpc.infer_service import GenerateContext
    from tpulab_torch.rpc.protos import inference_pb2 as pb

    cb = _tb(lm, ragged=True)
    fr = TFlight(tail_capacity=32, uniform_capacity=2, sample_every=4,
                 p99_min_n=64)
    adm = TAdm(TAdmCfg(max_inflight=8, max_queue_depth=16), load=cb)
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        device="cpu")
    mgr.update_resources(allow_empty=True)
    server = tsvc.build_infer_service(mgr, generation_engines={"lm": cb},
                                      flight=fr, admission=adm)
    res = server._infer_resources

    def gen(prompt, steps, **kw):
        ctx = GenerateContext(res)
        out = []
        ctx.write = out.append
        ctx._run(pb.GenerateRequest(model_name="lm",
                                    prompt=list(map(int, prompt)),
                                    steps=steps, **kw))
        return out

    try:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, V, (4,), np.int32) for _ in range(10)]
        for i, p in enumerate(prompts):
            assert len(gen(p, 2, tenant_id="uniform")) == 3
        with tchaos.inject("engine.step=delay:0+1"):
            gen(prompts[0], 2, tenant_id="chaos-t", trace_id="c" * 16)
        with tchaos.inject("engine.step=delay:0.02+999"):
            out = gen(prompts[1], 64, deadline_ms=150, tenant_id="late-t")
        assert out[-1].final and out[-1].status.code == pb.DEADLINE_EXCEEDED
        with fr._lock:
            fr._e2e.clear()
            fr._e2e.extend([0.001] * fr.p99_min_n)
        gen(prompts[2], 24, tenant_id="slow-t")
        by = {}
        for r in fr.records():
            by.setdefault(r.get("tenant"), []).append(r)
        assert by["chaos-t"][0]["keep"] == "chaos"
        assert by["chaos-t"][0]["chaos_trips"] == {"engine.step": 1}
        late = by["late-t"][0]
        assert late["keep"] == "deadline"
        assert late["tokens_delivered"] < 64
        slow = by["slow-t"][0]
        assert slow["keep"] == "slow" and slow["outcome"] == "SUCCESS"
        assert len(by.get("uniform", [])) <= 2 and fr.dropped_total > 0
        assert slow["lane"] in (0, 1) and slow["block_ks"]
        assert slow["admission"]["verdict"] == "admit"
        assert slow["tokens_delivered"] == 24 and slow["itl_ms"]["n"] == 23
        assert slow["kind"] == "generate" and slow["model"] == "lm"
    finally:
        server.shutdown()
        cb.shutdown()
        mgr.shutdown()


# -- the overhead row ----------------------------------------------------------------
def test_benchmark_obs_overhead_parity():
    """tpulab's default small size: tokens bit-identical armed vs bare,
    tpulab's row fields all present, the plane visibly armed."""
    from tpulab.obs.bench import benchmark_obs_overhead as jbench
    from tpulab_torch.obs import benchmark_obs_overhead as tbench

    want = jbench(n_requests=4, steps=8)
    got = tbench(n_requests=4, steps=8, device="cpu")
    assert got["parity"] is True and want["parity"] is True
    assert set(want) <= set(got)
    assert got["records_observed"] == want["records_observed"] == 5
    assert got["debug_polls"] >= 1 and got["trace_events"] > 0
    assert got["canaries"] >= 0 and got["watchdog_healthy"] is True
    assert all(p["parity"] for p in got["pairs"])
