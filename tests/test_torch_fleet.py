"""The port's fleet routing and autoscaling against tpulab's, on the CPU.

- the router: prefix digests, HRW rankings, ``ranked``, ``ring_moves``
  and the spill gauges equal tpulab's for the same digests and members,
  exactly;
- over three port replicas (paged batchers with the prefix cache on,
  f32): a shared prefix converges on its HRW home (the home's prefix
  hits grow), a zipfian mix stays balanced, both packages' sets route
  the same sequential traffic to the same replicas;
- ``fleet.route`` chaos (error, drop) degrades to the load pick;
- draining replicas (local flag and server-reported) leave the ring;
- the autoscaler under a fake clock: the decision sequence and the
  journal records equal tpulab's on a scripted signal sequence; the
  floors, ceilings and overload trigger; scale-up then a drain that an
  in-flight stream survives bit for bit, over port replicas;
- ``add_replica`` / ``retire_replica`` keep indices and drop the
  retired replica's metric children;
- the ``prefix_affinity`` row on the CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tpulab.fleet as jfleet
import tpulab.fleet.autoscaler as jauto
import tpulab.obs.journal as jjournal
import tpulab.rpc.replica as jrep
import tpulab_torch
import tpulab_torch.chaos as tchaos
import tpulab_torch.fleet as tfleet
import tpulab_torch.fleet.autoscaler as tauto
import tpulab_torch.obs.journal as tjournal
import tpulab_torch.rpc.infer_service as tsvc
import tpulab_torch.rpc.replica as trep
import tpulab_torch.utils.metrics as tmetrics
from tpulab_torch.engine.paged import ContinuousBatcher
from tpulab_torch.models.transformer import init_transformer_params

torch.set_num_threads(2)

PROMPT_LEN = 16
STEPS = 5
PKGS = [("tpulab", jfleet, jrep), ("port", tfleet, trep)]


def _params():
    return init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, device="cpu")


def _serve(params, slow_s=0.0):
    class _Paced(ContinuousBatcher):
        def submit(self, prompt, steps, on_token=None, **kw):
            if slow_s and on_token is not None:
                inner = on_token

                def paced(*a, **k):
                    time.sleep(slow_s)
                    return inner(*a, **k)
                on_token = paced
            return super().submit(prompt, steps, on_token=on_token, **kw)

    cb = (_Paced if slow_s else ContinuousBatcher)(
        params, n_heads=2, n_layers=2, lanes=2, max_len=64, page_size=8,
        prefix_cache=True, compute_dtype=torch.float32, device="cpu")
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        device="cpu")
    mgr.serve(port=0, generation_engines={"lm": cb})
    return mgr, cb


@pytest.fixture(scope="module")
def fleet3():
    params = _params()
    fleet = [_serve(params) for _ in range(3)]
    warm = np.arange(PROMPT_LEN + 2, dtype=np.int32)
    for _, cb in fleet:
        cb.submit(warm, 4, on_token=lambda *a: None).result(timeout=300)
    yield fleet
    for mgr, cb in fleet:
        mgr.shutdown()
        cb.shutdown()


def _addrs(fleet):
    return [f"127.0.0.1:{m.server.bound_port}" for m, _ in fleet]


def _set(rep, fleet, **kw):
    kw.setdefault("prefix_affinity", True)
    kw.setdefault("affinity_tokens", PROMPT_LEN)
    return rep.GenerationReplicaSet(_addrs(fleet), "lm", **kw)


# -- the router ---------------------------------------------------------------
def test_digests_rankings_and_ring_moves_equal_tpulab():
    """Same prompts, members and membership changes: equal digests, HRW
    rankings (``rank`` and ``ranked`` in any member order), ring moves
    at every change and router counters."""
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, 128256, (rng.integers(1, 40),)))
               for _ in range(200)] + [[-5, 7], [2 ** 31 - 1]]
    changes = [[f"10.0.0.{i}:50051" for i in range(4)],
               [f"10.0.0.{i}:50051" for i in range(3)],
               [f"10.0.0.{i}:50051" for i in range(5)],
               ["127.0.0.1:40001", "127.0.0.1:40002"]]
    got = {}
    for name, fleet, _ in PKGS:
        r = fleet.PrefixAffinityRouter(affinity_tokens=8)
        digs = [fleet.prefix_digest(p, 8) for p in prompts]
        out = {"digests": digs,
               "rank": [r.rank(d, changes[0]) for d in digs],
               "ranked": [r.ranked(d, list(reversed(changes[2])))
                          for d in digs],
               "moves": []}
        for members in changes:
            out["moves"].append(r.note_membership(members))
            for d in digs[:150]:
                home = r.ranked(d)[0]
                r.note_routed(d, home, home, False)
        r.note_routed(digs[0], "x", "y", True)
        out["snapshot"] = r.snapshot()
        got[name] = out
    assert got["port"] == got["tpulab"]
    moves = got["port"]["moves"]
    assert moves[0] == 0 and 0 < moves[1] < 150 * 0.45 and moves[2] > 0


def test_spill_policy_gauges_equal_tpulab():
    cases = [(2, 0, 0, None), (3, 0, 0, None), (0, 0, 4, None),
             (0, 0, 0, 999), (0, 0, 3, 1000), (0, 0, 0, None),
             (5, 4, 10 ** 6, 1)]
    got = {}
    for name, fleet, _ in PKGS:
        r = fleet.PrefixAffinityRouter(inflight_slack=2, spill_queue_depth=4,
                                       min_free_hbm_bytes=1000)
        r2 = fleet.PrefixAffinityRouter()
        got[name] = ([r.should_spill(*c) for c in cases],
                     [r2.should_spill(*c) for c in cases])
    assert got["port"][0] == [False, True, True, True, False, False, True]
    assert got["port"] == got["tpulab"]


# -- affinity over port replicas ----------------------------------------------
def test_same_prefix_converges_and_zipf_mix_stays_balanced(fleet3):
    """Six clients on one hot prefix land on its HRW home, whose
    server-reported prefix hits grow; a 24-request zipfian mix keeps two
    or more replicas in rotation.  tpulab's set over the same replicas
    routes the same sequential traffic to the same homes."""
    rng = np.random.default_rng(7)
    hot = rng.integers(0, 64, (PROMPT_LEN,), np.int32)
    prefixes = [rng.integers(0, 64, (PROMPT_LEN,), np.int32)
                for _ in range(12)]
    w = np.array([1 / (k + 1) ** 1.1 for k in range(12)])
    mix = [np.concatenate([prefixes[k], rng.integers(0, 64, (2,), np.int32)])
           .astype(np.int32) for k in rng.choice(12, size=24, p=w / w.sum())]
    routes = {}
    for name, _, rep in PKGS:
        rs = _set(rep, fleet3)
        try:
            home = rs._preferred(list(hot))
            hits0 = {a: v.get("prefix_hits", 0)
                     for a, v in rs.poll_load().items()}
            for i in range(6):
                p = np.concatenate([hot, [i, (i * 3) % 64]]).astype(np.int32)
                assert len(list(rs.generate(p, STEPS))) == STEPS
            assert rs.served[home] == 6 and rs.router.affinity_hits == 6
            hits = {a: v.get("prefix_hits", 0) - hits0[a]
                    for a, v in rs.poll_load().items()}
            assert hits[rs.addresses[home]] > 0
            assert hits[rs.addresses[home]] == max(hits.values())
            served0 = list(rs.served)
            for p in mix:
                assert len(list(rs.generate(p, STEPS))) == STEPS
            delta = [b - a for a, b in zip(served0, rs.served)]
            assert sum(delta) == 24 and max(delta) < 24
            assert sum(1 for d in delta if d > 0) >= 2, delta
            routes[name] = (home, delta)
        finally:
            rs.close()
    assert routes["port"] == routes["tpulab"]


@pytest.mark.parametrize("action", ["error", "drop"])
def test_fleet_route_chaos_degrades_to_load_pick(fleet3, action):
    cb_a = fleet3[0][1]
    prompt = np.arange(PROMPT_LEN, dtype=np.int32)
    expected = [int(t) for t in cb_a.submit(prompt, STEPS).result(timeout=60)]
    rs = _set(trep, fleet3)
    try:
        hits0 = rs.router.affinity_hits
        with tchaos.inject(f"fleet.route={action}+1") as sched:
            got = [int(t) for t in rs.generate(prompt, STEPS)]
            assert sched.fired("fleet.route") == 1
        assert got == expected and rs.router.affinity_hits == hits0
        assert [int(t) for t in rs.generate(prompt, STEPS)] == expected
        assert rs.router.affinity_hits == hits0 + 1
    finally:
        rs.close()


def test_draining_replica_gains_no_new_work_and_leaves_ring(fleet3):
    prompt = np.arange(PROMPT_LEN, dtype=np.int32)
    rs = _set(trep, fleet3)
    try:
        home = rs._preferred(list(prompt))
        assert len(list(rs.generate(prompt, STEPS))) == STEPS
        assert rs.served[home] == 1
        moves0 = rs.router.ring_moves
        rs.set_draining(rs.addresses[home], True)
        assert rs.breaker_states()[rs.addresses[home]] == "draining"
        new_home = rs._preferred(list(prompt))
        assert new_home != home
        assert len(list(rs.generate(prompt, STEPS))) == STEPS
        assert rs.served[home] == 1 and rs.served[new_home] >= 1
        assert rs.router.ring_moves > moves0
        rs.set_draining(rs.addresses[home], False)
        mgr, _ = fleet3[home]
        mgr.server._infer_resources.draining = True
        try:
            remote = tsvc.RemoteInferenceManager(rs.addresses[home])
            assert remote.server_status().draining is True
            remote.close()
            rs.poll_load()
            assert rs.breaker_states()[rs.addresses[home]] == "draining"
            assert rs._preferred(list(prompt)) != home
        finally:
            mgr.server._infer_resources.draining = False
            rs.set_draining(rs.addresses[home], False)
    finally:
        rs.close()


# -- the autoscaler -------------------------------------------------------------
class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += s


class _FakeSet:
    def __init__(self, n=2):
        self.addresses = [f"r{i}" for i in range(n)]
        self.overloads = 0
        self._state = {a: "closed" for a in self.addresses}
        self.log = []

    @property
    def active_count(self):
        return len(self.active_addresses())

    @property
    def inflight(self):
        return [i % 2 for i in range(len(self.addresses))]

    def active_addresses(self):
        return [a for a in self.addresses if self._state[a] == "closed"]

    def load_hints(self):
        return {a: 0 for a in self.addresses}

    def add_replica(self, addr):
        self.addresses.append(addr)
        self._state[addr] = "closed"
        self.log.append(("add", addr))

    def set_draining(self, addr, flag=True):
        self._state[addr] = "draining" if flag else "closed"
        self.log.append(("draining", addr))

    def retire_replica(self, addr):
        self._state[addr] = "retired"
        self.log.append(("retire", addr))


def _fake_provider(base):
    class Prov(base):
        def __init__(self):
            self.n = 0
            self.log = []
            self.drain_ok = [False, True]

        def spawn(self):
            self.n += 1
            return f"spawn{self.n}"

        def drain(self, addr, timeout_s=30.0):
            ok = self.drain_ok.pop(0) if self.drain_ok else True
            self.log.append(("drain", addr, ok))
            return ok

        def retire(self, addr):
            self.log.append(("retire", addr))
    return Prov()


# (queue-wait EWMA, replica-set overload count, SLO burn, seconds to advance)
SCRIPT = ([(0.9, 0, 0.0, 1.0)] * 3 + [(0.9, 0, 0.0, 0.2)] * 2
          + [(0.3, 3, 0.0, 1.0)] * 2 + [(0.0, 3, 0.0, 1.0)] * 6
          + [(0.01, 3, 12.0, 1.0)] * 3 + [(0.0, 3, 0.0, 1.0)] * 8)


def test_autoscaler_decisions_and_journal_equal_tpulab(monkeypatch,
                                                       tmp_path):
    """A scripted signal sequence (queue-wait EWMA breaches, an overload
    burst, an SLO burn, idle stretches; one drain that times out and is
    retried) under a fake clock: the decision sequence, the membership
    and provider calls and the journal's records equal tpulab's."""
    got = {}
    for name, auto, journal in (("tpulab", jauto, jjournal),
                                ("port", tauto, tjournal)):
        clk = _Clock()
        monkeypatch.setattr(auto, "time", clk)
        rs, prov = _FakeSet(), _fake_provider(auto.ReplicaProvider)
        jr = journal.EventJournal(str(tmp_path / f"{name}.jsonl"),
                                  node="ctl", clock=clk.time)
        sig = {"wait": 0.0, "burn": 0.0}
        asc = auto.FleetAutoscaler(
            rs, prov, wait_signal=lambda: sig["wait"], up_wait_s=0.5,
            down_wait_s=0.05, up_overloads=2, min_replicas=1,
            max_replicas=4, hold=2, cooldown_s=1.5, drain_timeout_s=7.0,
            journal=jr, slo_signal=lambda: sig["burn"], slo_scale_up=True,
            up_slo_burn=10.0)
        decisions = []
        for wait, overloads, burn, dt in SCRIPT:
            sig["wait"], sig["burn"] = wait, burn
            rs.overloads = overloads
            decisions.append(asc.evaluate())
            asc._drain_done.wait(5.0) if asc._drain_addr else None
            clk.t += dt
        asc.wait_for_drain(5.0)
        monkeypatch.undo()
        records = [{k: v for k, v in e.items()} for e in jr.events()]
        jr.close()
        got[name] = (decisions, rs.log, prov.log, records, asc.snapshot())
    decisions = got["port"][0]
    assert {"scale_up", "drain_started", "scale_down"} <= set(decisions)
    assert "draining" in decisions
    assert got["port"] == got["tpulab"]


def test_autoscaler_floors_ceilings_and_overload_trigger():
    got = {}
    for name, fleet, _ in PKGS:
        rs, prov = _FakeSet(), _fake_provider(fleet.ReplicaProvider)
        prov.drain_ok = []
        asc = fleet.FleetAutoscaler(rs, prov, wait_signal=None,
                                    up_overloads=2, hold=1, min_replicas=2,
                                    max_replicas=3)
        seq = [asc.evaluate()]
        for ov in (1, 5, 20, 20):
            rs.overloads = ov
            seq.append(asc.evaluate())
        assert asc.wait_for_drain(5.0)
        seq.append(asc.evaluate())
        got[name] = (seq, rs.log, prov.log,
                     (asc.scale_ups, asc.scale_downs, asc.drains))
        with pytest.raises(ValueError):
            fleet.FleetAutoscaler(rs, prov, min_replicas=0)
        with pytest.raises(ValueError):
            fleet.FleetAutoscaler(rs, prov, min_replicas=3, max_replicas=2)
    assert got["port"][0] == ["", "", "scale_up", "", "drain_started", ""]
    assert got["port"] == got["tpulab"]


def test_autoscaler_scales_up_and_drains_under_a_live_stream(fleet3):
    """Over port replicas: a held queue-wait breach spawns a (paced)
    replica; a held idle signal drains it while a stream pinned on it is
    in flight — the stream finishes bit for bit, nothing new lands on
    the victim, and it retires only once drained."""
    params = _params()
    cb_a = fleet3[0][1]
    prompt = np.arange(PROMPT_LEN, dtype=np.int32)
    expected = [int(t) for t in cb_a.submit(prompt, 20).result(timeout=60)]
    slow = _serve(params, slow_s=0.05)
    slow[1].submit(np.arange(PROMPT_LEN + 2, dtype=np.int32), 4,
                   on_token=lambda *a: None).result(timeout=60)
    rs = _set(trep, fleet3, prefix_affinity=False)
    provider = tfleet.InProcessReplicaProvider(lambda: slow)
    wait = {"v": 1.0}
    m = tmetrics.FleetMetrics()
    asc = tfleet.FleetAutoscaler(rs, provider, wait_signal=lambda: wait["v"],
                                 up_wait_s=0.5, down_wait_s=0.05, hold=2,
                                 min_replicas=3, max_replicas=4,
                                 drain_timeout_s=60.0, metrics=m)
    try:
        assert [asc.evaluate(), asc.evaluate()] == ["", "scale_up"]
        assert rs.active_count == 4
        victim = rs.addresses[3]
        assert victim == f"127.0.0.1:{slow[0].server.bound_port}"
        it = rs._clients[3].generate(list(prompt), 20, timeout=300)
        got = [next(it) for _ in range(3)]
        wait["v"] = 0.0
        assert [asc.evaluate(), asc.evaluate()] == ["", "drain_started"]
        assert rs.breaker_states()[victim] == "draining"
        served3 = rs.served[3]
        assert len(list(rs.generate(prompt, STEPS))) == STEPS
        assert rs.served[3] == served3
        got += list(it)
        assert [int(t) for t in got] == expected
        assert asc.wait_for_drain(timeout_s=60.0)
        assert asc.scale_downs == 1 and rs.active_count == 3
        assert rs.breaker_states()[victim] == "retired"
        assert [int(t) for t in rs.generate(prompt, STEPS)] \
            == expected[:STEPS]
        text = tmetrics.generate_latest(m.registry).decode()
        assert "tpulab_fleet_scale_ups_total 1.0" in text
        assert "tpulab_fleet_scale_downs_total 1.0" in text
        assert "tpulab_fleet_replicas 3.0" in text
    finally:
        asc.wait_for_drain(timeout_s=5.0)
        rs.close()
        provider.close()


def test_add_and_retire_replica_keep_indices_and_drop_metric_children(
        fleet3):
    m = tmetrics.ReplicaSetMetrics()
    addrs = _addrs(fleet3)
    rs = trep.GenerationReplicaSet(addrs[:1], "lm", prefix_affinity=True,
                                   metrics=m)
    try:
        assert rs.add_replica(addrs[1]) == 1
        assert len(rs._clients) == 2 and rs.active_count == 2
        prompt = np.arange(6, dtype=np.int32)
        out = list(rs.generate(prompt, 4))
        rs.poll_load()
        rs.health()
        text = tmetrics.generate_latest(m.registry).decode()
        assert f'replica="{addrs[1]}"' in text
        rs.retire_replica(addrs[1])
        assert rs.active_count == 1 and rs.addresses == addrs[:2]
        assert rs.breaker_states()[addrs[1]] == "retired"
        text = tmetrics.generate_latest(m.registry).decode()
        assert f'replica="{addrs[1]}"' not in text
        assert list(rs.generate(prompt, 4)) == out
    finally:
        rs.close()


def test_queue_wait_ewma_export_drives_the_wait_trigger():
    """The port's admission EWMA is 0 on the fast path and positive once
    requests queue, and the autoscaler reads it as its wait signal."""
    from tpulab_torch.serving.admission import (AdmissionConfig,
                                                AdmissionController)
    ctrl = AdmissionController(AdmissionConfig(max_inflight=1,
                                               admit_wait_s=5.0))
    t1 = ctrl.admit("a")
    assert ctrl.queue_wait_ewma_s == 0.0
    th = threading.Thread(target=lambda: ctrl.admit("b").release())
    th.start()
    time.sleep(0.15)
    t1.release()
    th.join(timeout=10)
    assert not th.is_alive() and ctrl.queue_wait_ewma_s > 0
    rs, prov = _FakeSet(), _fake_provider(tfleet.ReplicaProvider)
    asc = tfleet.FleetAutoscaler(rs, prov,
                                 wait_signal=lambda: ctrl.queue_wait_ewma_s,
                                 up_wait_s=0.01, hold=1, max_replicas=4)
    assert asc.evaluate() == "scale_up" and rs.log == [("add", "spawn1")]


def test_benchmark_prefix_affinity_row():
    """The ``prefix_affinity`` row on the CPU over three port replicas:
    tpulab's fields, every request served in both modes, routing parity,
    and a fleet hit rate with affinity at least the one without."""
    row = tfleet.benchmark_prefix_affinity(n_requests=12, device="cpu")
    on, off = row["affinity_on"], row["affinity_off"]
    assert set(row) == {"n_replicas", "n_requests", "n_prefixes",
                        "prefix_len", "steps", "zipf_top_share",
                        "affinity_off", "affinity_on", "hit_rate_gain"}
    assert on["complete"] and off["complete"]
    assert on["parity"] and off["parity"]
    assert set(on) == set(off) | {"affinity_hits", "affinity_spills"}
    assert on["hit_rate"] >= off["hit_rate"]
