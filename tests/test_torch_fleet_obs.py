"""The port's fleet observability (``tpulab_torch.fleet.observer``,
``FederationMetrics``, the election's journaling, debugz's ``fleet``
section) against tpulab's, on the CPU.

- tpulab's cases (``tests/test_fleet_obs.py``): election transitions
  journaled with their fencing tokens (the same records as tpulab's); a
  SIGKILLed leader PROCESS (the port's ``election.py`` and ``journal.py``
  loaded by path) whose successor's journal reconstructs the takeover
  with rising tokens and no sequence gap; ``fleetz`` federating a real
  ``tpulab_torch.fleet.replica_main`` process and an in-process replica,
  agreeing with each replica's own Status / Debug view, and merging the
  evidence onto one timeline; a dead replica reported as data; the
  federation gauges pruning a replica that left; debugz's ``fleet``
  membership agreeing across a leader transition;
- ``FederationMetrics`` expositions equal to tpulab's through
  prometheus_client's parser (the port emits without prometheus_client);
- ``benchmark_fleet_obs`` at a tiny size: tpulab's row keys.

Everything compared here is exact: no tolerance.
"""

import json
import os
import select
import subprocess
import sys
import time

import jax
import numpy as np
import torch
from prometheus_client import generate_latest as prom_latest
from prometheus_client.parser import text_string_to_metric_families

import tpulab.fleet as jfleet
import tpulab.obs as jobs
import tpulab.utils.metrics as JM
import tpulab_torch
import tpulab_torch.utils.metrics as TM
from tpulab_torch.fleet import (FileLeaseBackend, FleetAutoscaler,
                                FleetController, FleetObserver,
                                FleetSupervisor, LeaderElector,
                                ReplicaProvider, SubprocessReplicaProvider)
from tpulab_torch.obs import (EventJournal, FlightRecorder, SLOTracker,
                              replay_journal, sequence_gaps)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeSet:
    """The replica-set membership surface the control plane (and the
    observer) drives."""

    def __init__(self, addrs):
        self.addresses = list(addrs)
        self.overloads = 0
        self._state = {a: "closed" for a in addrs}
        self.added = []

    @property
    def active_count(self):
        return len(self.active_addresses())

    @property
    def inflight(self):
        return [0] * len(self.addresses)

    def active_addresses(self):
        return [a for a in self.addresses if self._state[a] == "closed"]

    def draining_addresses(self):
        return [a for a, s in self._state.items() if s == "draining"]

    def breaker_states(self):
        return dict(self._state)

    def load_hints(self):
        return {a: 0 for a in self.addresses}

    def add_replica(self, addr):
        self.addresses.append(addr)
        self._state[addr] = "closed"
        self.added.append(addr)
        return len(self.addresses) - 1

    def set_draining(self, addr, draining=True):
        self._state[addr] = "draining" if draining else "closed"

    def retire_replica(self, addr):
        self._state[addr] = "retired"

    def health(self, timeout=5.0):
        return {a: {"live": True, "ready": True}
                for a, s in self._state.items() if s != "retired"}


class FakeProvider(ReplicaProvider):
    def __init__(self):
        self.n = 0
        self.alive = {}

    def spawn(self):
        self.n += 1
        addr = f"10.0.1.{self.n}:50051"
        self.alive[addr] = True
        return addr

    def drain(self, address, timeout_s=30.0):
        return True

    def retire(self, address):
        self.alive.pop(address, None)

    def is_alive(self, address):
        return self.alive.get(address)


def _strip(events):
    """Journal records without their wall time: what must equal
    tpulab's."""
    return [{k: v for k, v in e.items() if k != "wall_time"}
            for e in events]


# -- election journaling ----------------------------------------------------------
def test_election_journals_transitions_with_tokens(tmp_path):
    recs = {}
    for name, F, O in (("tpulab", jfleet, jobs),
                       ("port", tpulab_torch.fleet, tpulab_torch.obs)):
        d = tmp_path / name
        be = F.FileLeaseBackend(str(d / "lease"))
        ja = O.EventJournal(str(d / "a.jsonl"), node="a")
        jb = O.EventJournal(str(d / "b.jsonl"), node="b")
        a = F.LeaderElector(be, node_id="a", ttl_s=60.0, journal=ja,
                            journal_renew_every=1)
        b = F.LeaderElector(be, node_id="b", ttl_s=60.0, journal=jb)
        assert a.tick() is True
        (acq,) = ja.events(kind="elect_acquire")
        assert acq["token"] == 1 and acq["node_id"] == "a"
        assert a.tick() is True              # renew journals when opted in
        (ren,) = ja.events(kind="elect_renew")
        assert ren["token"] == 1
        assert b.tick() is False and jb.events() == []
        a.resign()
        (res,) = ja.events(kind="elect_resign")
        assert res["token"] == 1
        assert b.tick() is True
        (acq_b,) = jb.events(kind="elect_acquire")
        assert acq_b["token"] == 2 > acq["token"]  # fenced past a's reign
        recs[name] = (_strip(ja.events()), _strip(jb.events()))
        ja.close()
        jb.close()
    assert recs["port"] == recs["tpulab"]


_CHILD_LEADER = """
import importlib.util, sys, time

def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

election = load("election_child", sys.argv[1])
journal = load("journal_child", sys.argv[2])
j = journal.EventJournal(sys.argv[4], node="child-leader")
el = election.LeaderElector(election.FileLeaseBackend(sys.argv[3]),
                            node_id="child-leader",
                            ttl_s=float(sys.argv[5]), journal=j)
print("LEADER" if el.tick() else "FOLLOWER", flush=True)
while True:
    time.sleep(0.05)
    el.tick()
"""


def test_killed_leader_takeover_reconstructs_from_journals(tmp_path):
    """SIGKILL the leader PROCESS while a successor runs a full control
    plane (supervisor + autoscaler) with its own journal.  Replaying both
    journals reconstructs the takeover — the child's acquire, the
    successor's acquire with a STRICTLY greater fencing token, the death
    with its evidence, the respawn and the autoscaler's action — with
    zero per-node sequence gaps."""
    ttl = 0.75
    lease_dir = str(tmp_path / "lease")
    child_journal = str(tmp_path / "child.jsonl")
    parent_journal = str(tmp_path / "parent.jsonl")
    script = tmp_path / "child_leader.py"
    script.write_text(_CHILD_LEADER)
    proc = subprocess.Popen(
        [sys.executable, str(script),
         os.path.join(REPO, "tpulab_torch", "fleet", "election.py"),
         os.path.join(REPO, "tpulab_torch", "obs", "journal.py"),
         lease_dir, child_journal, str(ttl)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    j = EventJournal(parent_journal, node="parent")
    try:
        role = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and role is None:
            ready, _, _ = select.select([proc.stdout], [], [], 0.5)
            if ready:
                role = proc.stdout.readline().strip()
            elif proc.poll() is not None:
                break
        assert role == "LEADER", (role, proc.stderr.read()[-1500:])

        rs = FakeSet(["10.0.0.9:50051"])
        prov = FakeProvider()
        prov.alive = {"10.0.0.9:50051": False}   # died with its leader
        ctl = FleetController(
            rs,
            LeaderElector(FileLeaseBackend(lease_dir), node_id="parent",
                          ttl_s=ttl, journal=j),
            supervisor=FleetSupervisor(rs, prov, respawn_backoff_s=0.0,
                                       journal=j),
            autoscaler=FleetAutoscaler(rs, prov,
                                       wait_signal=lambda: 10.0,
                                       hold=1, max_replicas=4,
                                       journal=j),
            journal=j)
        assert ctl.tick()["leader"] is False     # the child renews

        proc.kill()                              # no release, no goodbye
        proc.wait(timeout=10)
        t0 = time.monotonic()
        while not ctl.tick()["leader"]:
            assert time.monotonic() - t0 < 5.0, "takeover never happened"
            time.sleep(0.02)
        assert time.monotonic() - t0 <= ttl + 1.0
        ctl.tick()                               # heal + publish again

        child_evs = replay_journal(child_journal)
        parent_evs = replay_journal(parent_journal)
        assert sequence_gaps(child_evs) == []
        assert sequence_gaps(parent_evs) == []
        assert sequence_gaps(child_evs + parent_evs) == []
        (child_acq,) = [e for e in child_evs
                        if e["kind"] == "elect_acquire"]
        (parent_acq,) = [e for e in parent_evs
                         if e["kind"] == "elect_acquire"]
        assert parent_acq["token"] > child_acq["token"]
        acquires = sorted(
            [e for e in child_evs + parent_evs
             if e["kind"] == "elect_acquire"],
            key=lambda e: e["wall_time"])
        tokens = [e["token"] for e in acquires]
        assert tokens == sorted(set(tokens))
        kinds = [e["kind"] for e in parent_evs]
        assert "membership_publish" in kinds     # the successor's view
        pub = next(e for e in parent_evs
                   if e["kind"] == "membership_publish")
        assert pub["token"] == parent_acq["token"]
        death = next(e for e in parent_evs
                     if e["kind"] == "replica_death")
        assert death["evidence"] == "exit"       # positive evidence
        assert "replica_respawn" in kinds        # ...and the healing
        up = next(e for e in parent_evs if e["kind"] == "scale_up")
        assert up["wait_ewma_s"] == 10.0         # evidence-stamped
        # tpulab's replay reads the port's journals the same way
        assert jobs.replay_journal(parent_journal) == parent_evs
        assert jobs.sequence_gaps(child_evs + parent_evs) == []
    finally:
        j.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)


# -- federation -------------------------------------------------------------------
def _lm_params():
    from tpulab.models.transformer import init_transformer_params

    from tpulab_torch.models.convert import params_from_numpy
    p = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64)
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu",
                             n_heads=2)


def test_fleetz_federates_real_process_and_merges_evidence(tmp_path):
    """One replica is a REAL ``replica_main`` process (evidence paths by
    env, the provider's per-spawn ``extra_env``), one is in-process;
    fleetz agrees with each replica's own Status / Debug view, the
    ``_fed_*`` gauges carry the per-replica children, and the merged
    Chrome trace spans both processes on one timeline."""
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.mnist import make_mnist
    from tpulab_torch.rpc.infer_service import RemoteInferenceManager
    from tpulab_torch.rpc.replica import GenerationReplicaSet
    from tpulab_torch.utils.metrics import FederationMetrics
    from tpulab_torch.utils.tracing import ChromeTraceRecorder

    sub_trace = str(tmp_path / "sub_trace.json")
    sub_flight = str(tmp_path / "sub_flight.jsonl")
    prov = SubprocessReplicaProvider(replica_args=("--device", "cpu",
                                                   "--delay-ms", "5"))
    sub_addr = prov.spawn(extra_env={"TPULAB_TRACE_PATH": sub_trace,
                                     "TPULAB_FLIGHT_PATH": sub_flight})
    cb = ContinuousBatcher(_lm_params(), n_heads=2, n_layers=2, lanes=2,
                           max_len=64, page_size=8,
                           compute_dtype=torch.float32, device="cpu")
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=1, device="cpu"))
    mgr.update_resources()
    mgr.serve(port=0, generation_engines={"lm": cb},
              flight=FlightRecorder())
    in_addr = f"127.0.0.1:{mgr.server.bound_port}"

    client_trace = ChromeTraceRecorder(process_name="observer")
    rs = GenerationReplicaSet([sub_addr, in_addr], "lm")
    fed = FederationMetrics()
    slo = SLOTracker()
    obs = FleetObserver(rs, slo=slo, metrics=fed)
    rs_sub = GenerationReplicaSet([sub_addr], "lm", trace=client_trace)
    rs_in = GenerationReplicaSet([in_addr], "lm")
    try:
        for one in (rs_sub, rs_in):
            for _ in range(2):
                assert len(list(one.generate(
                    np.arange(5, dtype=np.int32), 6, timeout=120))) == 6
        snap = obs.fleetz()
        assert set(snap["replicas"]) == {sub_addr, in_addr}
        assert snap["scrape_s"] > 0 and obs.scrapes == 1
        assert snap["slo"] == slo.snapshot()     # the SLO document
        for addr in (sub_addr, in_addr):
            doc = snap["replicas"][addr]
            assert doc["up"] is True, doc
            cli = RemoteInferenceManager(addr)
            try:
                st = cli.server_status()
                dbg = cli.debugz()
            finally:
                cli.close()
            assert doc["inflight"] == int(st.inflight_requests) == 0
            assert doc["queued"] == int(st.queued_requests)
            assert doc["free_kv_pages"] == int(st.free_kv_pages)
            assert doc["resident_models"] == \
                [str(m) for m in st.resident_models]
            assert doc["draining"] is False
            assert doc["lanes"]["lm"] == len(dbg["engines"]["lm"]["lanes"])
            assert isinstance(doc["flight_exemplars"], list)
            # the port's own section rides along
            assert set(doc["kernels"]) == set(dbg["kernels"])
        fams = {f.name: f for f in text_string_to_metric_families(
            TM.generate_latest(fed.registry).decode())}
        ups = {s.labels["replica"]: s.value
               for s in fams["tpulab_fed_replica_up"].samples}
        assert ups == {sub_addr: 1.0, in_addr: 1.0}
        assert [s.value for s in fams["tpulab_fed_replicas"].samples] \
            == [2.0]

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if os.path.exists(sub_trace) and os.path.exists(sub_flight):
                try:
                    names = {e["name"] for e in
                             json.load(open(sub_trace))["traceEvents"]}
                    if {"prefill", "decode"} <= names:
                        break
                except ValueError:
                    pass
            time.sleep(0.1)
        client_path = client_trace.save(str(tmp_path / "client.json"))
        merged = FleetObserver.merge_traces(
            str(tmp_path / "merged.json"), client_path, sub_trace)
        doc = json.load(open(merged))
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert len({e["pid"] for e in spans}) >= 2  # two REAL processes
        names = {e["name"] for e in spans}
        assert "attempt" in names and "decode" in names

        flights = FleetObserver.collect_flight(
            sub_flight, str(tmp_path / "missing.jsonl"))
        assert flights and all(f["source"] == sub_flight for f in flights)
        assert [f["wall_time"] for f in flights] == \
            sorted(f["wall_time"] for f in flights)
    finally:
        obs.close()
        for one in (rs, rs_sub, rs_in):
            one.close()
        prov.retire(sub_addr)
        for closer in (mgr.shutdown, cb.shutdown):
            try:
                closer()
            except Exception:
                pass


def test_fleetz_reports_dead_replica_as_data():
    """tpulab's observer and the port's over a member nothing listens on:
    the same document, the dead replica as data."""
    docs = []
    for F in (jfleet, tpulab_torch.fleet):
        obs = F.FleetObserver(FakeSet(["127.0.0.1:1"]), timeout_s=2.0)
        try:
            snap = obs.fleetz()
            doc = snap["replicas"]["127.0.0.1:1"]
            assert doc["up"] is False and "error" in doc
            assert snap["breaker_states"] == {"127.0.0.1:1": "closed"}
            docs.append((sorted(doc), snap["breaker_states"],
                         snap["load_hints"], obs.scrape_errors))
        finally:
            obs.close()
    assert docs[1] == docs[0]


# -- federation metrics -----------------------------------------------------------
def _families(text):
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.endswith("_created"):
            continue
        out[fam.name] = (fam.type, fam.documentation, sorted(
            (s.name, tuple(sorted(s.labels.items())), s.value)
            for s in fam.samples if not s.name.endswith("_created")))
    return out


def _same_exposition(j, t):
    want = _families(prom_latest(j.registry).decode())
    got = _families(TM.generate_latest(t.registry).decode())
    assert got == want
    return got


def test_federation_metrics_prune_stale_replica_children():
    j, t = JM.FederationMetrics(), TM.FederationMetrics()
    for fed in (j, t):
        fed.set_replica("a:1", up=True, inflight=2)
        fed.set_replica("b:2", up=True, inflight=0)
    _same_exposition(j, t)
    for fed in (j, t):
        fed.prune(keep=["b:2"])              # a:1 left the snapshot
        fed.observe_scrape(0.01, 1)
    got = _same_exposition(j, t)
    labeled = {(s[0], dict(s[1]).get("replica"))
               for _t, _d, ss in got.values() for s in ss if s[1]}
    assert not any(r == "a:1" for _, r in labeled), labeled
    assert ("tpulab_fed_replica_up", "b:2") in labeled


# -- debugz fleet section across a transition -------------------------------------
def test_debugz_fleet_membership_agrees_across_leader_transition(
        tmp_path):
    """Leader and follower controllers served over the port's Debug RPC
    report the SAME membership document (token + store seq + members)
    before AND after a leader transition; a fleet handle whose snapshot
    raises reports the error as data."""
    from tpulab_torch.models.mnist import make_mnist
    from tpulab_torch.rpc.infer_service import RemoteInferenceManager

    be = FileLeaseBackend(str(tmp_path / "lease"))
    rs_a, rs_b = FakeSet(["10.0.0.1:50051"]), FakeSet(["10.0.0.1:50051"])
    el_a = LeaderElector(be, node_id="router-a", ttl_s=60.0)
    el_b = LeaderElector(be, node_id="router-b", ttl_s=60.0)
    ctl_a = FleetController(rs_a, el_a)
    ctl_b = FleetController(rs_b, el_b)
    assert ctl_a.tick()["leader"] is True
    assert ctl_b.tick()["leader"] is False

    class Broken:
        def snapshot(self):
            raise RuntimeError("control plane unreachable")

    mgrs, clients = [], []
    try:
        for ctl in (ctl_a, ctl_b, Broken()):
            mgr = tpulab_torch.InferenceManager(device="cpu")
            mgr.register_model("mnist", make_mnist(max_batch_size=1,
                                                   device="cpu"))
            mgr.update_resources()
            mgr.serve(port=0, fleet=ctl)
            mgrs.append(mgr)
            clients.append(RemoteInferenceManager(
                f"127.0.0.1:{mgr.server.bound_port}"))

        def fleet_docs():
            return [c.debugz()["fleet"] for c in clients]

        doc_a, doc_b, broken = fleet_docs()
        assert broken == {"error": "RuntimeError: control plane "
                                   "unreachable"}
        assert doc_a["election"]["is_leader"] is True
        assert doc_b["election"]["is_leader"] is False
        for key in ("token", "seq", "members"):
            assert doc_a["membership"][key] == doc_b["membership"][key]
        assert doc_a["membership"]["token"] == 1

        el_a.resign()                    # the transition
        assert ctl_b.tick()["leader"] is True
        assert ctl_a.tick()["leader"] is False

        doc_a, doc_b, _ = fleet_docs()
        assert doc_a["election"]["is_leader"] is False
        assert doc_b["election"]["is_leader"] is True
        assert doc_b["membership"]["token"] == 2
        for key in ("token", "seq", "members"):
            assert doc_a["membership"][key] == doc_b["membership"][key]
    finally:
        for c in clients:
            c.close()
        for mgr in mgrs:
            try:
                mgr.shutdown()
            except Exception:
                pass


# -- the bench row ----------------------------------------------------------------
def _keys(row):
    return {k: (_keys(v) if isinstance(v, dict) else type(v).__name__)
            for k, v in row.items()}


def test_benchmark_fleet_obs_row_has_tpulabs_keys():
    """The ``fleet_obs`` row at a tiny size: tpulab's keys and value
    types, every request complete in both modes, scrapes taken."""
    kw = dict(n_replicas=2, n_requests=4, steps=2, concurrency=2)
    want = jfleet.benchmark_fleet_obs(**kw)
    got = tpulab_torch.fleet.benchmark_fleet_obs(device="cpu", **kw)
    assert _keys(got) == _keys(want)
    assert got["off"]["complete"] and got["armed"]["complete"]
    assert got["armed"]["scrapes"] >= 5
    assert got["armed"]["journal_events"] == got["armed"]["scrapes"]
