"""The port's DeviceWatchdog against tpulab's, and wired into Health
(after tpulab's ``tests/test_serving_extras.py`` watchdog cases).

On the CPU the canary runs on the host (``device="cpu"``); the wedge is
simulated as in tpulab, by swapping in a canary whose completion never
arrives.  Both watchdogs go healthy, then unhealthy within the deadline
with the same reasons and one hook call, never stack probe threads, and
(the port's) recover when the canary is restored.  The Health RPC reports
not-ready while the watchdog is unhealthy, through the port's server in
process and over the gRPC loopback to tpulab's client.  The card-only
case shows the canary runs on its own stream: it completes while the
default stream is busy.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tpulab_torch.utils.watchdog import DeviceWatchdog


class _Never:
    """A canary result whose completion arrives only when released."""

    def __init__(self, gate):
        self.gate = gate

    def synchronize(self):            # the port's completion protocol
        self.gate.wait(30)

    def block_until_ready(self):      # tpulab's
        self.gate.wait(30)


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _wedge(wd, gate):
    """tpulab's wedge simulation on either watchdog: healthy first, then a
    never-completing canary and a short deadline."""
    events = []
    wd._on_unhealthy = events.append
    assert _wait_for(lambda: wd.seconds_since_ok is not None)
    healthy0 = wd.healthy
    wd._canary = (lambda x: _Never(gate), wd._canary[1])
    wd.deadline_s = 0.1
    assert _wait_for(lambda: not wd.healthy)
    time.sleep(0.3)                   # more periods pass while wedged
    return (healthy0, wd.healthy, len(events),
            "deadline" in wd.reason or "outstanding" in wd.reason)


def test_wedge_detection_matches_tpulab():
    from tpulab.utils.watchdog import DeviceWatchdog as JWatchdog

    out = {}
    for name, cls, kw in (("tpulab", JWatchdog, {}),
                          ("port", DeviceWatchdog, {"device": "cpu"})):
        gate = threading.Event()
        wd = cls(period_s=0.05, deadline_s=5.0, **kw).start()
        try:
            out[name] = _wedge(wd, gate)
        finally:
            gate.set()
            wd.stop()
    assert out["port"] == out["tpulab"] == (True, False, 1, True)


def test_wedge_never_stacks_probes_and_recovers():
    gate = threading.Event()
    wd = DeviceWatchdog(device="cpu", period_s=0.05, deadline_s=5.0).start()
    try:
        assert _wait_for(lambda: wd.canaries >= 3)
        assert wd.healthy and wd.last_canary_s is not None
        canary = wd._canary
        wd._canary = (lambda x: _Never(gate), canary[1])
        wd.deadline_s = 0.1
        assert _wait_for(lambda: not wd.healthy)
        time.sleep(0.4)
        probes = [t for t in threading.enumerate()
                  if t.name == "watchdog-canary" and t.is_alive()]
        assert len(probes) == 1                    # one wedged probe only
        assert "outstanding" in wd.reason
        n = wd.canaries
        wd._canary = canary                         # restore the canary
        gate.set()                                  # the wedge clears
        assert _wait_for(lambda: wd.healthy and wd.canaries > n)
        assert wd.reason == ""
    finally:
        gate.set()
        wd.stop()


def test_canary_error_is_unhealthy():
    wd = DeviceWatchdog(device="cpu", period_s=0.05, deadline_s=1.0).start()
    try:
        assert _wait_for(lambda: wd.canaries >= 1)

        def broken(x):
            raise RuntimeError("device lost")
        wd._canary = (broken, wd._canary[1])
        assert _wait_for(lambda: not wd.healthy)
        assert "device lost" in wd.reason
    finally:
        wd.stop()


def test_default_device_is_the_card():
    """No device named: ``cuda:0``; without CUDA that raises (a CPU
    watchdog must be asked for)."""
    wd = DeviceWatchdog(period_s=0.05)
    if torch.cuda.is_available():
        wd.start()
        try:
            assert wd._device.type == "cuda"
        finally:
            wd.stop()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            wd.start()


@pytest.fixture(scope="module")
def mnist_mgr():
    import tpulab_torch
    from tpulab_torch.models import build_model

    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        device="cpu")
    mgr.register_model("mnist", build_model("mnist", max_batch_size=1,
                                            device="cpu"))
    mgr.update_resources()
    yield mgr
    mgr.shutdown()


def test_watchdog_wired_into_health_rpc(mnist_mgr):
    """tpulab's case on the port's server, over the loopback to tpulab's
    client: an unhealthy watchdog turns readiness off, liveness stays."""
    import tpulab.rpc.infer_service as jsvc

    class FakeWatchdog:
        healthy = True

    wd = FakeWatchdog()
    mnist_mgr.serve(port=0, watchdog=wd)
    rm = jsvc.RemoteInferenceManager(
        f"127.0.0.1:{mnist_mgr.server.bound_port}")
    try:
        assert rm.health().ready
        wd.healthy = False
        h = rm.health()
        assert h.live and not h.ready
    finally:
        rm.close()
        mnist_mgr.server.shutdown()


def test_real_watchdog_turns_health_off_and_on(mnist_mgr):
    """A running DeviceWatchdog behind Health (in process): a canary that
    never completes turns readiness off within deadline + period, and
    restoring it turns readiness back on."""
    from tpulab_torch.rpc.infer_service import (SERVICE_NAME,
                                                build_infer_service)
    from tpulab_torch.rpc.protos import inference_pb2 as pb

    gate = threading.Event()
    wd = DeviceWatchdog(device="cpu", period_s=0.05, deadline_s=0.2).start()
    server = build_infer_service(mnist_mgr, watchdog=wd)

    def ready():
        return pb.HealthResponse.FromString(server.invoke(
            f"/{SERVICE_NAME}/Health", b"")).ready

    try:
        assert _wait_for(lambda: wd.canaries >= 3) and ready()
        canary = wd._canary
        wd._canary = (lambda x: _Never(gate), canary[1])
        t0 = time.monotonic()
        assert _wait_for(lambda: not ready(), timeout=5)
        assert time.monotonic() - t0 <= wd.deadline_s + 2 * wd.period_s + 0.5
        wd._canary = canary
        gate.set()
        assert _wait_for(ready, timeout=5)
    finally:
        gate.set()
        wd.stop()
        server.shutdown()


@pytest.mark.cuda
def test_canary_runs_on_its_own_stream():
    """On the card: while the default stream is busy with a long spin,
    the canary (its own stream, its own event) still completes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wd = DeviceWatchdog(period_s=0.02, deadline_s=2.0).start()
    try:
        assert _wait_for(lambda: wd.canaries >= 1)
        n = wd.canaries
        torch.cuda._sleep(int(2e9))       # ~1 s of spinning, default stream
        assert _wait_for(lambda: wd.canaries >= n + 3, timeout=0.8)
        assert wd.healthy
        torch.cuda.synchronize()
    finally:
        wd.stop()
    assert np.isfinite(wd.last_canary_s)
