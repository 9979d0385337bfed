"""The port's process-boundary control plane against tpulab's: the
non-election cases of tpulab's ``tests/test_fleet_process.py``.

- the supervisor (fake clock, fake replica set and provider): respawn
  under exponential backoff, crash-loop quarantine and unquarantine, a
  draining member is never a death, the unreachable-probe streak, a
  failed respawn backing off — every tick's actions, the snapshot and
  the journal's records equal tpulab's;
- ``fleet.probe`` chaos forgoes evidence and ``fleet.spawn`` chaos
  retries with backoff, with tpulab's counts;
- the provider drain contract (``timeout_s`` a hard cap, the in-flight
  stream finishes, a drained replica reports True) against the
  in-process provider and a ``tpulab_torch.fleet.replica_main`` process
  (``--device cpu``), which retires with exit code 0;
- (slow, as tpulab's) a chaos-killed replica process under live
  traffic, its respawn and a drain-retire with no dropped stream.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tpulab.chaos as jchaos
import tpulab.fleet as jfleet
import tpulab.obs.journal as jjournal
import tpulab_torch
import tpulab_torch.chaos as tchaos
import tpulab_torch.fleet as tfleet
import tpulab_torch.obs.journal as tjournal
from tpulab_torch.engine.paged import ContinuousBatcher
from tpulab_torch.models.transformer import init_transformer_params
from tpulab_torch.obs import replay_journal, sequence_gaps
from tpulab_torch.rpc.replica import GenerationReplicaSet

torch.set_num_threads(2)

PKGS = [("tpulab", jfleet, jchaos, jjournal),
        ("port", tfleet, tchaos, tjournal)]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeSet:
    """The replica-set membership surface the supervisor drives."""

    def __init__(self, addrs):
        self.addresses = list(addrs)
        self.overloads = 0
        self._state = {a: "closed" for a in addrs}
        self.health_results = {}
        self.added, self.retired = [], []

    @property
    def active_count(self):
        return len(self.active_addresses())

    @property
    def inflight(self):
        return [0] * len(self.addresses)

    def active_addresses(self):
        return [a for a in self.addresses if self._state[a] == "closed"]

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
        self.retired.append(addr)

    def health(self, timeout=5.0):
        return {a: dict(self.health_results.get(
                    a, {"live": True, "ready": True}))
                for a, s in self._state.items() if s != "retired"}


def _provider(fleet):
    class FakeProvider(fleet.ReplicaProvider):
        def __init__(self):
            self.n = 0
            self.alive = {}
            self.spawn_dead = False
            self.spawn_fails = 0
            self.retired = []

        def spawn(self):
            if self.spawn_fails > 0:
                self.spawn_fails -= 1
                raise RuntimeError("injected spawn failure")
            self.n += 1
            addr = f"10.0.0.{self.n}:50051"
            self.alive[addr] = not self.spawn_dead
            return addr

        def drain(self, address, timeout_s=30.0):
            return True

        def retire(self, address):
            self.alive.pop(address, None)
            self.retired.append(address)

        def is_alive(self, address):
            return self.alive.get(address)

        def exit_code(self, address):
            return None if self.alive.get(address) else 86
    return FakeProvider()


def _both(tmp_path, scenario):
    """Run ``scenario(fleet, chaos, sup_factory)`` in both packages: the
    returned trace, the supervisor's snapshot and its journal records
    must be equal."""
    got = {}
    for name, fleet, chaos, journal in PKGS:
        clk = FakeClock()
        jr = journal.EventJournal(str(tmp_path / f"{name}.jsonl"),
                                  node="sup", clock=clk)
        made = []

        def make(rs, prov, **kw):
            sup = fleet.FleetSupervisor(rs, prov, clock=clk, journal=jr,
                                        **kw)
            made.append(sup)
            return sup

        trace = scenario(fleet, chaos, make, clk)
        got[name] = (trace, made[0].snapshot(), jr.events())
        jr.close()
        assert sequence_gaps(replay_journal(jr.path)) == []
    assert got["port"] == got["tpulab"]
    return got["port"]


def test_supervisor_respawns_dead_replica_under_backoff(tmp_path):
    def scenario(fleet, chaos, make, clk):
        rs, prov = FakeSet(["a:1", "b:2"]), _provider(fleet)
        prov.alive = {"a:1": True, "b:2": True}
        sup = make(rs, prov, respawn_backoff_s=1.0)
        trace = [sup.probe()]
        prov.alive["a:1"] = False
        trace.append(sup.probe())
        assert rs.breaker_states()["a:1"] == "retired"
        assert "a:1" in prov.retired
        for t in (0.5, 1.5, 2.0):
            clk.t = t
            trace.append(sup.probe())
        assert rs.active_count == 2 and sup.respawns == 1
        return trace, rs.added, prov.retired

    (trace, added, _), snap, events = _both(tmp_path, scenario)
    assert trace[1]["deaths"] == ["a:1"] and trace[2]["respawns"] == []
    assert trace[3]["respawns"] == added
    assert [e["kind"] for e in events] == ["replica_death",
                                           "replica_respawn"]
    assert events[0]["evidence"] == "exit" and events[0]["exit_code"] == 86


def test_supervisor_crash_loop_quarantine_and_unquarantine(tmp_path):
    def scenario(fleet, chaos, make, clk):
        rs, prov = FakeSet(["a:1"]), _provider(fleet)
        prov.alive = {"a:1": False}
        prov.spawn_dead = True
        sup = make(rs, prov, respawn_backoff_s=0.0, crash_loop_deaths=3,
                   crash_loop_window_s=100.0)
        trace = [sup.probe() for _ in range(5)]
        spawned = prov.n
        q = trace[2]["quarantined"][0]
        prov.spawn_dead = False
        trace.append(sup.unquarantine(q))
        trace += [sup.probe(), sup.probe()]
        return trace, spawned

    (trace, spawned), snap, events = _both(tmp_path, scenario)
    assert len(trace[2]["quarantined"]) == 1 and spawned == 2
    assert trace[5] is True and len(trace[6]["respawns"]) == 1
    assert trace[7]["deaths"] == [] and snap["crash_loops"] == 1
    assert "replica_quarantine" in [e["kind"] for e in events]


def test_supervisor_never_kills_draining_member(tmp_path):
    def scenario(fleet, chaos, make, clk):
        rs, prov = FakeSet(["a:1", "b:2"]), _provider(fleet)
        prov.alive = {"a:1": False, "b:2": False}
        rs.set_draining("a:1")
        rs.health_results["a:1"] = {"live": False, "ready": False}
        sup = make(rs, prov, respawn_backoff_s=10.0)
        return [sup.probe(), rs.breaker_states()["a:1"], list(prov.retired)]

    trace, _, _ = _both(tmp_path, scenario)
    assert trace[0]["deaths"] == ["b:2"] and trace[1] == "draining"
    assert "a:1" not in trace[2]


def test_supervisor_unreachable_streak_requires_consecutive_failures(
        tmp_path):
    def scenario(fleet, chaos, make, clk):
        rs, prov = FakeSet(["a:1"]), _provider(fleet)
        sup = make(rs, prov, unreachable_probes=3, respawn_backoff_s=10.0)
        dead = {"live": False, "ready": False}
        trace = []
        for blip in (dead, dead, None, dead, dead, dead):
            if blip is None:
                rs.health_results.pop("a:1")
            else:
                rs.health_results["a:1"] = blip
            trace.append(sup.probe()["deaths"])
        return trace

    trace, _, events = _both(tmp_path, scenario)
    assert trace == [[], [], [], [], [], ["a:1"]]
    assert events[0]["evidence"] == "probe_streak"


@pytest.mark.parametrize("action", ["error", "drop"])
def test_probe_chaos_forgoes_evidence_never_spurious_death(tmp_path,
                                                           action):
    def scenario(fleet, chaos, make, clk):
        rs, prov = FakeSet(["a:1"]), _provider(fleet)
        prov.alive = {"a:1": False}
        sup = make(rs, prov, respawn_backoff_s=10.0)
        with chaos.inject(f"fleet.probe={action}+1") as sched:
            trace = [sup.probe()["deaths"], sched.fired("fleet.probe"),
                     sup.probes_forgone, rs.breaker_states()["a:1"],
                     sup.probe()["deaths"], sched.occurrences("fleet.probe")]
        return trace

    trace, _, _ = _both(tmp_path, scenario)
    assert trace == [[], 1, 1, "closed", ["a:1"], 2]


def test_supervisor_spawn_failure_backs_off(tmp_path):
    def scenario(fleet, chaos, make, clk):
        rs, prov = FakeSet(["a:1"]), _provider(fleet)
        prov.alive = {"a:1": False}
        sup = make(rs, prov, respawn_backoff_s=0.0)
        prov.spawn_fails = 1
        trace = [sup.probe()]
        trace.append(sup.snapshot()["lineages"]["a:1"]["spawn_failures"])
        clk.t = 10.0
        trace.append(sup.probe())
        return trace

    trace, _, events = _both(tmp_path, scenario)
    assert trace[0]["deaths"] == ["a:1"] and trace[1] == 1
    assert len(trace[2]["respawns"]) == 1
    assert [e["kind"] for e in events] == ["replica_death", "spawn_failure",
                                           "replica_respawn"]


@pytest.mark.parametrize("action", ["error", "drop"])
def test_spawn_chaos_retries_with_backoff(action):
    class _Mgr:
        server = type("S", (), {"bound_port": 50123})()

        def shutdown(self):
            pass

    got = {}
    for name, fleet, chaos, _ in PKGS:
        prov = fleet.InProcessReplicaProvider(lambda: _Mgr())
        with chaos.inject(f"fleet.spawn={action}+1") as sched:
            addr = prov.spawn()
        got[name] = (addr, sched.fired("fleet.spawn"),
                     sched.occurrences("fleet.spawn"), prov.is_alive(addr),
                     prov.is_alive("10.9.9.9:1"))
        prov.close()
    assert got["port"] == ("127.0.0.1:50123", 1, 2, True, None)
    assert got["port"] == got["tpulab"]


def test_spawn_chaos_exhaustion_propagates():
    got = {}
    for name, fleet, chaos, _ in PKGS:
        with chaos.inject("fleet.spawn=error+10") as sched:
            with pytest.raises(chaos.ChaosError):
                fleet.spawn_with_retry(lambda: "never", attempts=3,
                                       backoff_s=0.01)
        got[name] = sched.fired("fleet.spawn")
    assert got == {"tpulab": 3, "port": 3}


# -- provider drain conformance -------------------------------------------------
def _params():
    return init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, seed=0,
                                   device="cpu")


def _serve_paced(slow_s):
    class _Paced(ContinuousBatcher):
        def submit(self, prompt, steps, on_token=None, **kw):
            if on_token is not None:
                inner = on_token

                def paced(*a, **k):
                    time.sleep(slow_s)
                    return inner(*a, **k)
                on_token = paced
            return super().submit(prompt, steps, on_token=on_token, **kw)

    cb = _Paced(_params(), n_heads=2, n_layers=2, lanes=2, max_len=64,
                page_size=8, prefix_cache=True, compute_dtype=torch.float32,
                device="cpu")
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        device="cpu")
    mgr.serve(port=0, generation_engines={"lm": cb})
    return mgr, cb


def _stream_through(rs, prompt, steps):
    first = threading.Event()
    out = {}

    def run():
        toks = []
        for t in rs.generate(prompt, steps, timeout=120):
            toks.append(int(t))
            first.set()
        out["toks"] = toks

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def wait_fn():
        th.join(timeout=120)
        assert not th.is_alive()
        return out["toks"]
    return first, wait_fn


@pytest.mark.parametrize("kind", ["inprocess", "subprocess"])
def test_provider_drain_conformance(kind):
    """Unknown address drains trivially; ``timeout_s`` is a hard cap (the
    in-process leg's settle window is far above the budget); the stream
    the drain found in flight completes; a drained replica reports True
    within budget; the subprocess replica retires with exit code 0."""
    mgr = cb = None
    if kind == "inprocess":
        mgr, cb = _serve_paced(0.15)
        addr = f"127.0.0.1:{mgr.server.bound_port}"
        prov = tfleet.InProcessReplicaProvider(lambda: mgr, settle_s=10.0)
        prov.adopt(addr, mgr, None)
    else:
        prov = tfleet.SubprocessReplicaProvider(replica_args=(
            "--device", "cpu", "--delay-ms", "150"))
        addr = prov.spawn()
    rs = GenerationReplicaSet([addr], "lm")
    try:
        assert prov.drain("127.0.0.1:1") is True
        first, wait_fn = _stream_through(rs, np.arange(5, dtype=np.int32),
                                         24)
        assert first.wait(60), "stream never started"
        t0 = time.monotonic()
        assert prov.drain(addr, timeout_s=1.0) is False
        assert time.monotonic() - t0 < 4.0
        assert len(wait_fn()) == 24
        t0 = time.monotonic()
        assert prov.drain(addr, timeout_s=3.0) is True
        assert time.monotonic() - t0 < 6.0
    finally:
        rs.close()
        if kind == "subprocess":
            prov.retire(addr)
            assert prov.exit_code(addr) == 0
            assert prov.is_alive(addr) is None
            prov.close()
        else:
            prov.retire(addr)
            assert prov.is_alive(addr) is None
            cb.shutdown()


# -- slow acceptance ------------------------------------------------------------
@pytest.mark.slow
def test_subprocess_fleet_kill_resume_respawn_and_scaledown(tmp_path):
    """Real port replica processes (``--device cpu``): a replica armed
    with ``TPULAB_CHAOS=rpc.stream=kill@4`` dies mid-stream (exit 86) and
    the stream completes bit for bit on the survivor; the supervisor
    classifies the death, respawns the lineage and journals it gap-free;
    a scale-down drains a replica under a live stream (no stream
    dropped) and retires it with exit 0."""
    prompt = np.arange(5, dtype=np.int32)
    steps = 12
    oracle = ContinuousBatcher(_params(), n_heads=2, n_layers=2, lanes=2,
                               max_len=64, page_size=8, prefix_cache=True,
                               compute_dtype=torch.float32, device="cpu")
    expected = [int(t) for t in oracle.submit(prompt, steps).result(60)]
    expected_hold = [int(t) for t in oracle.submit(prompt, 50).result(60)]
    oracle.shutdown()
    prov = tfleet.SubprocessReplicaProvider(replica_args=(
        "--device", "cpu", "--delay-ms", "40"))
    journal = tjournal.EventJournal(str(tmp_path / "j.jsonl"), node="sup")
    rs = None
    try:
        victim = prov.spawn(extra_env={"TPULAB_CHAOS": "rpc.stream=kill@4"})
        survivor = prov.spawn()
        rs = GenerationReplicaSet([victim, survivor], "lm")
        sup = tfleet.FleetSupervisor(rs, prov, respawn_backoff_s=0.1,
                                     probe_timeout_s=5.0, journal=journal)
        sup.probe()
        got = [int(t) for t in rs.generate(prompt, steps, timeout=120)]
        assert got == expected
        deadline = time.monotonic() + 60
        while prov.is_alive(victim) is not False:
            assert time.monotonic() < deadline, "victim never died"
            time.sleep(0.1)
        acts = sup.probe()
        assert victim in acts["deaths"]
        assert prov.exit_code(victim) == tchaos.KILL_EXIT_CODE
        deadline = time.monotonic() + 240
        respawned = []
        while not respawned:
            assert time.monotonic() < deadline, "respawn never happened"
            time.sleep(0.1)
            respawned = sup.probe()["respawns"]
        assert rs.active_count == 2
        assert [int(t) for t in rs.generate(prompt, steps)] == expected
        asc = tfleet.FleetAutoscaler(rs, prov, wait_signal=lambda: 0.0,
                                     min_replicas=1, hold=1,
                                     drain_timeout_s=120.0,
                                     journal=journal)
        waits = []
        for _ in range(2):
            first, wait_fn = _stream_through(rs, prompt, 50)
            assert first.wait(60)
            waits.append(wait_fn)
        assert asc.evaluate() == "drain_started"
        assert sup.probe()["deaths"] == []
        assert asc.wait_for_drain(120.0) and asc.scale_downs == 1
        for wait_fn in waits:
            assert wait_fn() == expected_hold
        clean = [a for a in [victim, survivor] + respawned
                 if prov.exit_code(a) == 0]
        assert len(clean) == 1
        assert sequence_gaps(replay_journal(journal.path)) == []
    finally:
        if rs is not None:
            rs.close()
        prov.close()
        journal.close()
