"""The port's leader election and fleet controller
(``tpulab_torch.fleet.election`` / ``.control``) against tpulab's, on the
CPU.

- tpulab's election cases (``tests/test_fleet_process.py``): acquire /
  renew / expiry / takeover on an injected clock, resign handing off at
  once, the fencing token rejecting a stale publish, membership snapshot
  and apply (one-way), exactly one autoscaler under two controllers with
  a TTL takeover, and a killed leader PROCESS handing off within one
  TTL.  Each scenario runs on both packages; the port's record of every
  tick, snapshot and store document equals tpulab's.
- interoperation: a tpulab and a port ``LeaderElector`` (and
  ``FleetController``) over one ``FileLeaseBackend`` directory —
  leadership alternates, tokens rise across both, a stale publish from
  either package is fenced, and each package reads the other's
  ``lease.json`` / ``membership.json``; a killed leader process of one
  package hands off to the other within one TTL.

Everything here is exact (integers, strings, booleans): no tolerance.
"""

import os
import select
import subprocess
import sys
import time

import pytest

import tpulab.fleet as jfleet
import tpulab_torch.fleet as tfleet
from tpulab_torch.utils.metrics import FleetMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"tpulab": jfleet, "port": tfleet}
ELECTION_PY = {name: os.path.join(REPO, pkg, "fleet", "election.py")
               for name, pkg in (("tpulab", "tpulab"),
                                 ("port", "tpulab_torch"))}


class FakeClock:
    """Injectable time for sleepless lease-expiry tests."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class FakeSet:
    """The replica-set membership surface the control plane drives."""

    def __init__(self, addrs):
        self.addresses = list(addrs)
        self._state = {a: "closed" for a in addrs}

    def active_addresses(self):
        return [a for a in self.addresses if self._state[a] == "closed"]

    def draining_addresses(self):
        return [a for a, s in self._state.items() if s == "draining"]

    def breaker_states(self):
        return dict(self._state)

    def add_replica(self, addr):
        self.addresses.append(addr)
        self._state[addr] = "closed"
        return len(self.addresses) - 1

    def set_draining(self, addr, draining=True):
        self._state[addr] = "draining" if draining else "closed"

    def retire_replica(self, addr):
        self._state[addr] = "retired"


class CountingAutoscaler:
    """Stands in for FleetAutoscaler: the only thing under test is WHO
    gets to call evaluate()."""

    def __init__(self):
        self.evals = 0

    def evaluate(self):
        self.evals += 1
        return ""

    def snapshot(self):
        return {"evals": self.evals}


def _both(scenario, tmp_path):
    """Run ``scenario(pkg, dir)`` on tpulab and on the port; their records
    must be equal.  Returns the port's record."""
    recs = {name: scenario(pkg, str(tmp_path / name))
            for name, pkg in PKGS.items()}
    assert recs["port"] == recs["tpulab"]
    return recs["port"]


# -- lease + fencing ------------------------------------------------------------
def test_lease_acquire_renew_expiry_takeover(tmp_path):
    def scenario(F, d):
        clk = FakeClock()
        be = F.FileLeaseBackend(d, clock=clk)
        a = F.LeaderElector(be, node_id="A", ttl_s=2.0)
        b = F.LeaderElector(be, node_id="B", ttl_s=2.0)
        rec = []
        assert a.tick() is True and a.is_leader and a.fencing_token == 1
        assert b.tick() is False and not b.is_leader
        clk.t += 1.5
        assert a.tick() is True            # renew inside the TTL
        clk.t += 1.5
        assert b.tick() is False           # renewed lease still valid
        clk.t += 2.5                       # past the renewed expiry
        assert b.tick() is True            # takeover on the next tick
        assert b.fencing_token == 2        # acquisition bumps the token
        assert be.holder() == ("B", 2)
        # the old leader discovers the loss on its next tick, not before
        assert a.tick() is False
        assert not a.is_leader and a.losses == 1
        rec += [a.snapshot(), b.snapshot(), be.holder()]
        return rec

    _both(scenario, tmp_path)


def test_lease_resign_hands_off_immediately(tmp_path):
    def scenario(F, d):
        clk = FakeClock()
        be = F.FileLeaseBackend(d, clock=clk)
        a = F.LeaderElector(be, node_id="A", ttl_s=30.0)
        b = F.LeaderElector(be, node_id="B", ttl_s=30.0)
        assert a.tick() and not b.tick()
        a.resign()                         # clean shutdown: no TTL wait
        assert not a.is_leader
        assert b.tick() is True            # same fake instant
        assert b.fencing_token == 2        # release preserved the counter
        return [a.snapshot(), b.snapshot(), be.holder()]

    _both(scenario, tmp_path)


def test_fencing_token_rejects_stale_publish(tmp_path):
    def scenario(F, d):
        clk = FakeClock()
        be = F.FileLeaseBackend(d, clock=clk)
        a = F.LeaderElector(be, node_id="A", ttl_s=2.0)
        b = F.LeaderElector(be, node_id="B", ttl_s=2.0)
        assert a.tick()
        first = be.publish_membership({"members": ["x:1"]},
                                      a.fencing_token)
        clk.t += 5.0                       # A pauses past its TTL (GC, stall)
        assert b.tick() and b.fencing_token == 2
        # the woken stale leader's write is REJECTED, and its renew fails
        with pytest.raises(F.StaleLeaderError, match="stale"):
            be.publish_membership({"members": []}, 1)
        assert be.renew("A", 1, 2.0) is False
        # the current leader's write lands, seq advancing
        be.publish_membership({"members": ["x:1", "y:2"]}, 2)
        snap = be.read_membership()
        assert snap["token"] == 2 and snap["seq"] == 2
        assert snap["members"] == ["x:1", "y:2"]
        return [first, snap]

    _both(scenario, tmp_path)


def test_membership_snapshot_apply_one_way(tmp_path):
    def scenario(F, d):
        lead = FakeSet(["a:1", "b:2", "c:3"])
        lead.set_draining("b:2")
        lead.retire_replica("c:3")
        snap = F.membership_snapshot(lead)
        assert snap == {"members": ["a:1"], "draining": ["b:2"],
                        "retired": ["c:3"]}
        fol = FakeSet(["a:1", "b:2", "c:3"])
        rec = [F.apply_membership(fol, snap)]
        assert rec[0] == {"added": 0, "drained": 1, "retired": 1}
        assert fol.breaker_states() == {"a:1": "closed", "b:2": "draining",
                                        "c:3": "retired"}
        # idempotent re-apply
        rec.append(F.apply_membership(fol, snap))
        assert rec[-1] == {"added": 0, "drained": 0, "retired": 0}
        # a lagging snapshot that lists b:2 active must NOT un-drain it
        F.apply_membership(fol, {"members": ["a:1", "b:2"], "draining": [],
                                 "retired": []})
        assert fol.breaker_states()["b:2"] == "draining"
        # unknown members are adopted
        rec.append(F.apply_membership(fol, {"members": ["a:1", "d:4"]}))
        assert rec[-1]["added"] == 1 and "d:4" in fol.addresses
        return rec + [fol.breaker_states()]

    _both(scenario, tmp_path)


# -- controller + election ------------------------------------------------------
def test_controller_exactly_one_autoscaler_and_ttl_takeover(tmp_path):
    """Two routers, one lease: only the leader's autoscaler ever runs;
    when the leader stops ticking, the follower takes over within one TTL
    and the follower's replica set has already converged on the leader's
    published membership.  The port's controller also feeds its
    FleetMetrics leader gauge."""
    def scenario(F, d):
        clk = FakeClock()
        be = F.FileLeaseBackend(d, clock=clk)
        rs_a = FakeSet(["a:1", "b:2"])
        rs_b = FakeSet(["a:1"])            # follower starts with a stale view
        asc_a, asc_b = CountingAutoscaler(), CountingAutoscaler()
        ctl_a = F.FleetController(rs_a, F.LeaderElector(be, "A", ttl_s=2.0),
                                  autoscaler=asc_a)
        ctl_b = F.FleetController(rs_b, F.LeaderElector(be, "B", ttl_s=2.0),
                                  autoscaler=asc_b)
        rec = []
        for _ in range(3):
            out_a = ctl_a.tick()
            out_b = ctl_b.tick()
            assert out_a["leader"] and out_a["published"]
            assert not out_b["leader"]
            rec += [out_a, out_b]
            clk.t += 0.5
        assert asc_a.evals == 3 and asc_b.evals == 0   # exactly one acts
        assert "b:2" in rs_b.addresses                 # follower converged
        assert ctl_b.snapshots_applied >= 1
        # leader dies (stops ticking); B takes over within one TTL
        clk.t += 2.5
        out = ctl_b.tick()
        assert out["leader"] and asc_b.evals == 1
        assert ctl_b.elector.fencing_token == 2
        # the stale ex-leader comes back: renew fails, it follows, and its
        # autoscaler never runs again
        out2 = ctl_a.tick()
        assert out2["leader"] is False
        assert asc_a.evals == 3
        snap = ctl_a.snapshot()
        assert snap["election"]["is_leader"] is False
        assert snap["leader_ticks"] == 3 and snap["follower_ticks"] == 1
        return rec + [out, out2, snap, ctl_b.snapshot()]

    _both(scenario, tmp_path)


def test_controller_feeds_the_port_fleet_metrics(tmp_path):
    be = tfleet.FileLeaseBackend(str(tmp_path), clock=FakeClock())
    m = FleetMetrics()
    ctl = tfleet.FleetController(
        FakeSet(["a:1"]), tfleet.LeaderElector(be, "A", ttl_s=2.0,
                                               metrics=m), metrics=m)
    ctl.tick()
    assert m.is_leader._one()._value.get() == 1
    ctl.elector.resign()
    ctl.tick()                             # re-acquires: a second gain
    assert m.leader_transitions._one()._value.get() == 2


def test_controller_fenced_mid_tick_resigns(tmp_path):
    """A publish rejected by the fencing check (leadership lost between
    the renew and the publish) resigns and journals ``elect_fenced``:
    none of that node's membership writes land."""
    from tpulab_torch.obs import EventJournal

    clk = FakeClock()
    be = tfleet.FileLeaseBackend(str(tmp_path / "lease"), clock=clk)
    j = EventJournal(str(tmp_path / "a.jsonl"), node="A")
    ctl = tfleet.FleetController(
        FakeSet(["a:1"]), tfleet.LeaderElector(be, "A", ttl_s=2.0,
                                               journal=j), journal=j)
    assert ctl.tick()["leader"]

    class Fencing:
        """B takes the lease the moment A's renew has succeeded."""

        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def renew(self, node_id, token, ttl_s):
            ok = self.inner.renew(node_id, token, ttl_s)
            clk.t += 5.0
            assert self.inner.try_acquire("B", 2.0) == 2
            return ok

    ctl.elector.backend = Fencing(be)
    out = ctl.tick()
    assert out == {"leader": False, "fenced": True}
    assert not ctl.elector.is_leader
    assert [e["kind"] for e in j.events()][-2:] == ["elect_fenced",
                                                    "elect_resign"]
    assert be.read_membership()["token"] == 1      # nothing of A landed
    j.close()


_CHILD_LEADER = """
import importlib.util, sys, time
spec = importlib.util.spec_from_file_location("election_child", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
be = mod.FileLeaseBackend(sys.argv[2])
el = mod.LeaderElector(be, node_id="child", ttl_s=float(sys.argv[3]))
print("LEADER" if el.tick() else "FOLLOWER", flush=True)
while True:
    time.sleep(0.05)
    el.tick()
"""


@pytest.mark.parametrize("child,parent", [("port", "port"),
                                          ("tpulab", "port"),
                                          ("port", "tpulab")])
def test_killed_leader_process_hands_off_within_one_ttl(tmp_path, child,
                                                        parent):
    """The leader is a separate PROCESS holding the lease on disk (it
    loads ``election.py`` by path: the module is stdlib-only); SIGKILL it
    and the local elector must acquire within one TTL — within a package
    and across them."""
    ttl = 0.75
    lease_dir = str(tmp_path / "lease")
    script = tmp_path / "child_leader.py"
    script.write_text(_CHILD_LEADER)
    proc = subprocess.Popen(
        [sys.executable, str(script), ELECTION_PY[child], lease_dir,
         str(ttl)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
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
        F = PKGS[parent]
        me = F.LeaderElector(F.FileLeaseBackend(lease_dir),
                             node_id="parent", ttl_s=ttl)
        # the child renews every 50ms: the parent cannot acquire
        for _ in range(3):
            assert me.tick() is False
            time.sleep(0.1)
        proc.kill()                    # SIGKILL: no release, no goodbye
        proc.wait(timeout=10)
        t0 = time.monotonic()
        while not me.tick():
            assert time.monotonic() - t0 < 5.0, "takeover never happened"
            time.sleep(0.02)
        took = time.monotonic() - t0
        assert took <= ttl + 1.0, f"takeover took {took:.2f}s > one TTL"
        assert me.fencing_token == 2
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)


# -- interoperation over one lease directory ------------------------------------
def test_lease_files_interoperate_across_packages(tmp_path):
    """A tpulab and a port elector over one lease directory: leadership
    alternates (resign, then expiry), the fencing token rises across
    both, a stale publish from either package is fenced, and each
    package's backend reads the other's lease and membership files."""
    clk = FakeClock()
    jbe = jfleet.FileLeaseBackend(str(tmp_path), clock=clk)
    tbe = tfleet.FileLeaseBackend(str(tmp_path), clock=clk)
    j = jfleet.LeaderElector(jbe, node_id="jax-router", ttl_s=2.0)
    t = tfleet.LeaderElector(tbe, node_id="port-router", ttl_s=2.0)
    tokens = []

    assert j.tick() and not t.tick()
    tokens.append(j.fencing_token)
    doc = jbe.publish_membership({"members": ["a:1"]}, j.fencing_token)
    assert tbe.holder() == ("jax-router", 1)       # the port reads tpulab's
    assert tbe.read_membership() == doc
    j.resign()                                     # hand-off by release
    assert t.tick() and t.fencing_token == 2
    tokens.append(t.fencing_token)
    with pytest.raises(tfleet.StaleLeaderError):   # tpulab's stale token,
        tbe.publish_membership({"members": []}, 1)  # the port's store
    doc2 = tbe.publish_membership({"members": ["a:1", "b:2"]}, 2)
    assert jbe.holder() == ("port-router", 2)      # tpulab reads the port's
    assert jbe.read_membership() == doc2 and doc2["seq"] == 2
    clk.t += 5.0                                   # the port's lease expires
    assert j.tick() and j.fencing_token == 3       # hand-off by expiry
    tokens.append(j.fencing_token)
    assert t.tick() is False and not t.is_leader   # the port sees the loss
    with pytest.raises(jfleet.StaleLeaderError):   # the port's stale token,
        jbe.publish_membership({"members": []}, 2)  # tpulab's store
    with pytest.raises(tfleet.StaleLeaderError):
        tbe.publish_membership({"members": []}, 2)
    clk.t += 5.0
    assert t.tick() and t.fencing_token == 4
    tokens.append(t.fencing_token)
    assert tokens == [1, 2, 3, 4]
    assert jbe.holder() == tbe.holder() == ("port-router", 4)


def test_controllers_of_both_packages_share_one_lease(tmp_path):
    """A tpulab and a port FleetController over one lease: exactly one
    autoscaler runs at a time, the follower converges on the leader's
    membership whichever package leads, and a TTL takeover moves the
    autoscaling to the other package's controller."""
    clk = FakeClock()
    rs_j, rs_t = FakeSet(["a:1", "b:2"]), FakeSet(["a:1"])
    asc_j, asc_t = CountingAutoscaler(), CountingAutoscaler()
    cj = jfleet.FleetController(
        rs_j, jfleet.LeaderElector(jfleet.FileLeaseBackend(
            str(tmp_path), clock=clk), "jax-router", ttl_s=2.0),
        autoscaler=asc_j)
    ct = tfleet.FleetController(
        rs_t, tfleet.LeaderElector(tfleet.FileLeaseBackend(
            str(tmp_path), clock=clk), "port-router", ttl_s=2.0),
        autoscaler=asc_t)
    for _ in range(3):
        assert cj.tick()["leader"] and not ct.tick()["leader"]
        clk.t += 0.5
    assert (asc_j.evals, asc_t.evals) == (3, 0)
    assert "b:2" in rs_t.addresses                 # the port followed
    rs_t.set_draining("a:1")                       # the port's own view
    clk.t += 2.5                                   # tpulab stops ticking
    assert ct.tick()["leader"] and ct.elector.fencing_token == 2
    assert cj.tick()["leader"] is False
    assert (asc_j.evals, asc_t.evals) == (3, 1)
    assert "a:1" in rs_j.draining_addresses()      # tpulab followed
    assert (ct.snapshot()["membership"]["token"]
            == cj.snapshot()["membership"]["token"] == 2)
