"""The port's replica sets against tpulab's, across the wire, on the CPU at
f32.

Two tpulab servers and two port servers, each a paged ``ContinuousBatcher``
("lm") and MNIST on the same weights (bridged with ``params_from_numpy``),
serve tpulab's ``tests/test_replica.py`` and ``tests/test_durable_streams.py``
scenarios through tpulab's set over port servers, the port's set over
tpulab's servers and the port's set over port servers:

- least-loaded picks and round-robin rotation equal tpulab's;
- streams through the set equal the server package's direct stream;
- a mid-stream kill (``rpc.stream=error``) fails over exactly once: the
  consumer gets the uninterrupted stream bit for bit, with resume (zero
  tokens replayed) and without (the delivered prefix replayed);
- breaker transition sequences, per-attempt codes, deadline outcomes,
  seed injection, rejection handling and the affinity home equal
  tpulab's;
- hedging, the disaggregated prefill -> decode route and
  ``benchmark_failover_recovery`` run over port servers;
- one real-process failover: two ``tpulab_torch.fleet.replica_main``
  processes (``--device cpu``), one SIGKILLed mid-stream.
"""

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulab
import tpulab.chaos as jchaos
import tpulab.rpc.infer_service as jsvc
import tpulab.rpc.replica as jrep
import tpulab.utils.metrics as jmetrics
import tpulab_torch
import tpulab_torch.chaos as tchaos
import tpulab_torch.rpc.infer_service as tsvc
import tpulab_torch.rpc.replica as trep
import tpulab_torch.utils.metrics as tmetrics
from tests.conftest import free_port
from tpulab.engine.paged import ContinuousBatcher as JBatcher
from tpulab.models.mnist import make_mnist as jax_make_mnist
from tpulab.models.transformer import init_transformer_params
from tpulab_torch.engine.paged import ContinuousBatcher as TBatcher
from tpulab_torch.engine.paged import SamplingParams as TSampling
from tpulab_torch.models.convert import params_from_numpy, tree_from_numpy
from tpulab_torch.models.mnist import make_mnist

torch.set_num_threads(2)

CFG = dict(n_heads=2, n_layers=2, lanes=2, max_len=64, page_size=8)
PROMPT = np.random.default_rng(42).integers(0, 64, (10,)).astype(np.int32)
STEPS = 16
X = np.zeros((1, 28, 28, 1), np.float32)


class _Side:
    """Two servers of one package and that package's modules."""

    def __init__(self, name, svc, rep, chaos, metrics, servers):
        self.name, self.svc, self.rep = name, svc, rep
        self.chaos, self.metrics = chaos, metrics
        self.mgrs = [m for m, _ in servers]
        self.engines = [cb for _, cb in servers]
        self.addrs = [f"127.0.0.1:{m.server.bound_port}" for m in self.mgrs]


@pytest.fixture(scope="module")
def sides():
    p = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu",
                           n_heads=2)
    jmnist = jax_make_mnist(max_batch_size=2, seed=3)
    tmnist_params = tree_from_numpy(
        jax.tree_util.tree_map(np.asarray, jmnist.params), "cpu")
    jservers, tservers = [], []
    for _ in range(2):
        cb = JBatcher(p, compute_dtype=jnp.float32, **CFG)
        mgr = tpulab.InferenceManager(max_exec_concurrency=1)
        mgr.register_model("mnist", jmnist)
        mgr.serve(port=0, generation_engines={"lm": cb})
        jservers.append((mgr, cb))
        cb = TBatcher(tp, compute_dtype=torch.float32, device="cpu", **CFG)
        mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                            device="cpu")
        mgr.register_model("mnist", make_mnist(max_batch_size=2,
                                               params=tmnist_params))
        mgr.serve(port=0, generation_engines={"lm": cb})
        tservers.append((mgr, cb))
    out = (_Side("tpulab", jsvc, jrep, jchaos, jmetrics, jservers),
           _Side("port", tsvc, trep, tchaos, tmetrics, tservers))
    for side in out:                       # warm every stream shape
        for cb in side.engines:
            cb.submit(PROMPT, 4, on_token=lambda *a: None).result(timeout=300)
    yield out
    for side in out:
        for m in side.mgrs:
            try:
                m.shutdown()
            except Exception:  # noqa: BLE001 - a test stopped it already
                pass
        for cb in side.engines:
            cb.shutdown()


def _combos(sides):
    """(label, client side, server side): every pairing but tpulab's own."""
    j, t = sides
    return [("tpulab set -> port servers", j, t),
            ("port set -> tpulab servers", t, j),
            ("port set -> port servers", t, t)]


def _direct(side, prompt=PROMPT, steps=STEPS, **kw):
    return [int(t) for t in side.engines[0].submit(
        prompt, steps, **kw).result(timeout=120)]


def _home(cb, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cb.active_lanes == 0 and cb.queued_requests == 0:
            return True
        time.sleep(0.01)
    return False


# -- routing ------------------------------------------------------------------
def test_least_loaded_pick_and_inflight_accounting(sides):
    got = {}
    for side in sides:
        a = side.addrs[0]
        rs = side.rep.ReplicaSet([a, a, a], "mnist")
        try:
            rs._inflight = [3, 1, 2]
            seq = [rs._pick(frozenset()), list(rs.inflight),
                   rs._pick(frozenset({1})), list(rs.inflight),
                   rs._pick(frozenset({0, 1, 2}))]
            rs._inflight = [0, 0, 0]
            seq.append([rs._pick(frozenset()) for _ in range(5)])
        finally:
            rs.close()
        got[side.name] = seq
    assert got["port"][:5] == [1, [3, 2, 2], 2, [3, 2, 3], None]
    assert got["port"] == got["tpulab"]


def test_unary_traffic_spreads_and_health_reports_live(sides):
    for label, client, server in _combos(sides):
        rs = client.rep.ReplicaSet(server.addrs, "mnist")
        try:
            health = rs.health()
            assert all(h["live"] and h["ready"] for h in health.values())
            futs = [rs.infer(Input3=X) for _ in range(8)]
            outs = [f.result(timeout=60) for f in futs]
            assert all(o["Plus214_Output_0"].shape == (1, 10) for o in outs)
            assert sum(rs.served) == 8 and all(s > 0 for s in rs.served)
            assert rs.inflight == [0, 0], label
        finally:
            rs.close()


@pytest.mark.parametrize("mode", ["greedy", "device"])
def test_generation_set_routes_and_matches_direct(sides, mode):
    """Sequential streams rotate over both replicas and equal the server
    package's direct stream, in every pairing."""
    kw = {} if mode == "greedy" else dict(temperature=0.8, seed=5,
                                          device_sampling=True)
    for label, client, server in _combos(sides):
        direct = _direct(server, sampling=None if mode == "greedy" else
                         (TSampling(temperature=0.8, seed=5, device=True)
                          if server.name == "port" else
                          jax_sampling(temperature=0.8, seed=5)))
        grs = client.rep.GenerationReplicaSet(server.addrs, "lm")
        try:
            for _ in range(2):
                assert [int(t) for t in grs.generate(
                    PROMPT, STEPS, **kw)] == direct, label
            assert grs.served == [1, 1] and grs.inflight == [0, 0]
        finally:
            grs.close()


def jax_sampling(**kw):
    from tpulab.engine.paged import SamplingParams
    return SamplingParams(device=True, **kw)


@pytest.mark.parametrize("resume", [True, False])
def test_mid_stream_failover_exactly_once(sides, resume):
    """A replica's stream dies at token 5 (``rpc.stream=error`` in the
    server's package); the set fails over and the consumer sees the
    uninterrupted stream exactly once.  The failover counters (resumes,
    replayed tokens, served) equal tpulab's own set over tpulab's
    servers."""
    def run(client, server):
        want = _direct(server)
        grs = client.rep.GenerationReplicaSet(server.addrs, "lm",
                                              resume_failover=resume)
        try:
            with server.chaos.inject("rpc.stream=error@5+1") as sc:
                got = [int(t) for t in grs.generate(PROMPT, STEPS)]
                fired = sc.fired("rpc.stream")
            assert got == want and fired == 1
            return (got, grs.resumes, grs.tokens_replayed,
                    sorted(grs.served), grs.inflight)
        finally:
            grs.close()

    j, _ = sides
    want = run(j, j)
    assert want[1:3] == ((1, 0) if resume else (0, 5))
    for label, client, server in _combos(sides):
        assert run(client, server) == want, label
        assert all(_home(cb) for cb in server.engines)


def _recorder(side):
    """The side's ReplicaSetMetrics, recording the breaker and attempt
    hooks in ``.calls`` as it passes them on."""
    if side.name == "tpulab":
        import prometheus_client
        m = side.metrics.ReplicaSetMetrics(
            registry=prometheus_client.CollectorRegistry())
    else:
        m = side.metrics.ReplicaSetMetrics()
    m.calls = []
    transition, attempt = m.note_breaker_transition, m.note_attempt

    def note_breaker_transition(replica, to):
        m.calls.append(("breaker", replica, to))
        transition(replica, to)

    def note_attempt(code):
        m.calls.append(("attempt", code))
        attempt(code)

    m.note_breaker_transition = note_breaker_transition
    m.note_attempt = note_attempt
    return m


def test_breaker_sequence_matches_tpulab(sides):
    """One injected unary fault (the client package's chaos) ejects a
    replica at threshold 1, the request fails over, the background probe
    restores it: the transition and attempt sequence equals tpulab's."""
    got = {}
    for label, client, server in [("tpulab", sides[0], sides[0])] + \
            _combos(sides):
        rec = _recorder(client)
        rs = client.rep.ReplicaSet(server.addrs, "mnist", metrics=rec,
                                   breaker_threshold=1,
                                   probe_backoff_s=0.05,
                                   probe_backoff_cap_s=0.2)
        try:
            with client.chaos.inject("rpc.client.unary=error+1") as sc:
                rs.infer(Input3=X).result(timeout=60)
                assert sc.fired("rpc.client.unary") == 1
            ejected = [c[1] for c in rec.calls if c[:1] == ("breaker",)][0]
            end = time.monotonic() + 30
            while rs.breaker_states()[ejected] != "closed":
                assert time.monotonic() < end, "breaker never closed"
                time.sleep(0.02)
        finally:
            rs.close()
        # the probe thread runs beside the failover: each kind's own
        # sequence is deterministic, their interleaving is not
        got[label] = ([c[1] for c in rec.calls if c[0] == "attempt"],
                      [c[2] for c in rec.calls if c[0] == "breaker"])
        assert rs.ejections == 1
    want = got.pop("tpulab")
    assert want == (["ChaosError", "OK"], ["open", "probing", "closed"])
    for label, seq in got.items():
        assert seq == want, label


def test_dead_replica_breaker_and_failover(sides):
    """A dead first replica: the stream replays on the live one, the dead
    one's breaker opens at threshold 1, and the attempt codes equal
    tpulab's."""
    dead = f"127.0.0.1:{free_port()}"
    got = {}
    for label, client, server in [("tpulab", sides[0], sides[0])] + \
            _combos(sides):
        rec = _recorder(client)
        grs = client.rep.GenerationReplicaSet(
            [dead, server.addrs[0]], "lm", metrics=rec, breaker_threshold=1,
            probe_backoff_s=30.0)
        try:
            toks = [int(t) for t in grs.generate(PROMPT, 6)]
            assert toks == _direct(server, steps=6)
            got[label] = (grs.served, grs.breaker_states()[dead],
                          [c for c in rec.calls if c[0] == "attempt"],
                          [c[2] for c in rec.calls if c[0] == "breaker"])
        finally:
            grs.close()
    want = got.pop("tpulab")
    assert want[:2] == ([0, 1], "open")
    for label, g in got.items():
        assert g == want, label


def test_deadline_outcomes_and_seed_injection_match_tpulab(sides):
    """Deadline-bounded requests (generous and spent budgets, both
    request kinds) give tpulab's outcomes and deadline samples; sampling
    without a seed gets one injected, greedy and seeded requests pass
    through."""
    from prometheus_client.parser import text_string_to_metric_families
    import prometheus_client

    def deadline_samples(m, expo):
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                      for f in text_string_to_metric_families(
                          expo(m.registry).decode())
                      for s in f.samples
                      if s.name in ("tpulab_deadline_outcomes_total",
                                    "tpulab_deadline_slack_seconds_count"))

    got = {}
    for label, client, server in [("tpulab", sides[0], sides[0])] + \
            _combos(sides):
        if client.name == "tpulab":
            m = jmetrics.ReplicaSetMetrics(
                registry=prometheus_client.CollectorRegistry())
            expo = prometheus_client.generate_latest
        else:
            m = tmetrics.ReplicaSetMetrics()
            expo = tmetrics.generate_latest
        addr = server.addrs[0]
        grs = client.rep.GenerationReplicaSet([addr], "lm", metrics=m)
        rs = client.rep.ReplicaSet([addr], "mnist", metrics=m)
        outcomes = []
        try:
            list(grs.generate(PROMPT, 4, deadline_s=60.0))
            rs.infer(deadline_s=60.0, Input3=X).result(timeout=60)
            for call in (lambda: rs.infer(deadline_s=0.0,
                                          Input3=X).result(timeout=60),
                         lambda: list(grs.generate(PROMPT, 4,
                                                   deadline_s=0.0))):
                try:
                    call()
                    outcomes.append("ok")
                except Exception as e:  # noqa: BLE001 - the outcome
                    outcomes.append(type(e).__name__)
            rs.infer(Input3=X).result(timeout=60)   # unbounded: no sample
            seen = []
            grs._generate_iter = lambda p, s, t, kw: iter([seen.append(kw)])
            list(grs.generate([1, 2], 4, temperature=0.7))
            list(grs.generate([1, 2], 4, temperature=0.7, seed=123))
            list(grs.generate([1, 2], 4))
            seeds = (seen[0].get("seed") is not None, seen[1]["seed"],
                     "seed" in seen[2])
        finally:
            grs.close()
            rs.close()
        got[label] = (outcomes, deadline_samples(m, expo), seeds)
    want = got.pop("tpulab")
    assert want[0] == ["DeadlineExceeded"] * 2
    assert want[2] == (True, 123, False)
    for label, g in got.items():
        assert g == want, label


def test_rejection_does_not_fail_over(sides):
    for label, client, server in _combos(sides):
        grs = client.rep.GenerationReplicaSet(server.addrs, "nope")
        try:
            with pytest.raises(client.svc.GenerationRejected,
                               match="no generation engine"):
                list(grs.generate([1, 2, 3], 4))
            assert grs._rr == 1 and grs.inflight == [0, 0], label
        finally:
            grs.close()


def test_prefix_affinity_home_and_spill_match_tpulab(sides):
    """Same addresses, same prompts: the affinity home is tpulab's,
    repeats stay home, a prompt differing past the window keeps it, an
    overloaded home spills to the other replica."""
    got = {}
    for label, client, server in [("tpulab", sides[0], sides[0])] + \
            _combos(sides):
        grs = client.rep.GenerationReplicaSet(
            server.addrs, "lm", prefix_affinity=True, affinity_tokens=4,
            affinity_slack=1)
        try:
            homes = [grs._preferred(list(np.arange(k, k + 6)))
                     for k in range(12)]
            p1 = np.arange(6, dtype=np.int32)
            home = grs._preferred(list(p1))
            want = _direct(server, prompt=p1, steps=5)
            for _ in range(3):
                assert [int(t) for t in grs.generate(p1, 5)] == want
            assert grs.served[home] == 3 and grs.served[1 - home] == 0
            same = np.concatenate([p1[:4], [9, 9]]).astype(np.int32)
            assert grs._preferred(list(same)) == home
            grs._inflight[home] += 3
            spill = grs._pick_affine(list(p1), frozenset())
            grs._inflight[spill] -= 1
            grs._inflight[home] -= 3
            got[label] = (homes, spill == 1 - home,
                          grs.router.snapshot()["affinity_spills"])
        finally:
            grs.close()
    # server addresses differ between packages: compare each pairing with
    # tpulab's set over the same addresses
    for label, client, server in _combos(sides):
        ref = jrep.GenerationReplicaSet(server.addrs, "lm",
                                        prefix_affinity=True,
                                        affinity_tokens=4)
        try:
            assert got[label][0] == [ref._preferred(list(np.arange(k, k + 6)))
                                     for k in range(12)]
        finally:
            ref.close()
        assert got[label][1:] == (True, 1)


def test_hedged_first_token_over_port_servers(sides):
    """The primary's stream wedges before its first token (``rpc.stream=
    drop``); after the hedge delay one duplicate launches on the other
    port replica and wins: the stream is exact and the loser's lane
    frees.  Both packages' sets, the same counts."""
    _, t = sides
    want = _direct(t)
    for client in sides:
        rs = client.rep.GenerationReplicaSet(t.addrs, "lm",
                                             hedge_delay_s=0.3)
        try:
            assert rs._hedge_eligible({}) is True
            assert rs._hedge_eligible({"temperature": 0.5}) is False
            with tchaos.inject("rpc.stream=drop@0+1"):
                got = [int(x) for x in rs.generate(PROMPT, STEPS)]
            assert got == want
            assert (rs.hedges, rs.hedge_wins, sum(rs.served)) == (1, 1, 1)
            assert all(_home(cb, 15) for cb in t.engines), client.name
        finally:
            rs.close()


def test_disaggregated_route_over_port_servers(sides):
    """A prefill-role and a decode-role port server (host KV tier on):
    both packages' ``disaggregate=True`` sets stream the unified tokens
    through the prefill -> kv_shipment -> decode hop."""
    _, t = sides
    p = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu",
                           n_heads=2)
    servers = []
    try:
        for role in ("prefill", "decode"):
            cb = TBatcher(tp, compute_dtype=torch.float32, device="cpu",
                          kv_offload=True, **CFG)
            mgr = tpulab_torch.InferenceManager(device="cpu")
            mgr.serve(port=0, generation_engines={"lm": cb}, role=role)
            servers.append((mgr, cb))
        addrs = [f"127.0.0.1:{m.server.bound_port}" for m, _ in servers]
        want = _direct(t)
        for client in sides:
            fills = servers[1][1].prompt_fills
            grs = client.rep.GenerationReplicaSet(addrs, "lm",
                                                  disaggregate=True)
            try:
                got = [int(x) for x in grs.generate(PROMPT, STEPS)]
                assert got == want, client.name
                assert (grs.disagg_handoffs, grs.disagg_fallbacks) == (1, 0)
                assert servers[1][1].prompt_fills == fills
            finally:
                grs.close()
    finally:
        for m, cb in servers:
            m.shutdown()
            cb.shutdown()


def test_benchmark_failover_recovery_row():
    """The ``failover_recovery`` row on the CPU: resume keeps parity and
    replays nothing; full replay keeps parity and replays the prefix."""
    row = trep.benchmark_failover_recovery(prompt_len=8, steps=12,
                                           kill_at=4, device="cpu")
    on, off = row["resume_on"], row["resume_off"]
    assert on["parity"] and off["parity"]
    assert (on["tokens_replayed"], on["resumes"]) == (0, 1)
    assert off["tokens_replayed"] == 4 and off["resumes"] == 0


def test_generation_failover_across_real_processes():
    """Two ``tpulab_torch.fleet.replica_main`` processes (``--device
    cpu``, paced emission); SIGKILL the one serving a stream mid-flight:
    both packages' sets replay on the survivor with resume and the
    consumer sees the uninterrupted greedy stream exactly once."""
    from tpulab_torch.fleet import SubprocessReplicaProvider
    from tpulab_torch.models.transformer import init_transformer_params \
        as tinit

    prov = SubprocessReplicaProvider(replica_args=(
        "--device", "cpu", "--delay-ms", "40", "--lanes", "2"),
        ready_timeout_s=120.0, term_grace_s=2.0)
    try:
        addrs = [prov.spawn() for _ in range(4)]
        params = tinit(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                       seed=0, device="cpu")
        cb = TBatcher(params, n_heads=2, n_layers=2, lanes=2, max_len=64,
                      page_size=8, prefix_cache=True,
                      compute_dtype=torch.float32, device="cpu")
        prompt = np.arange(5, dtype=np.int32)
        want = [int(t) for t in cb.submit(prompt, 20).result(timeout=60)]
        cb.shutdown()
        for rep, pair in ((jrep, addrs[:2]), (trep, addrs[2:])):
            grs = rep.GenerationReplicaSet(pair, "lm")
            try:
                it = grs.generate(prompt, 20)
                got = [int(next(it)) for _ in range(3)]
                active = grs.inflight.index(1)
                os.kill(prov.pid_of(pair[active]), signal.SIGKILL)
                got += [int(t) for t in it]
                assert got == want, rep.__name__
                assert grs.served[1 - active] == 1 and grs.resumes == 1
            finally:
                grs.close()
            assert prov.is_alive(pair[active]) is False
            assert prov.exit_code(pair[active]) == -signal.SIGKILL
    finally:
        prov.close()
