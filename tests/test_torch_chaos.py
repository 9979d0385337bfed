"""The port's chaos module and the batcher's fault sites against tpulab's,
on the CPU.

- tpulab's batcher scenarios (``tests/test_chaos.py``: an ``engine.step``
  error fails the in-flight request and the batcher recovers; a deadline
  storm under slowed steps frees every lane and page) run on tpulab's
  ``ContinuousBatcher`` and on the port's, f32, under both dispatch
  plans, and must give the same outcomes and page counts;
- ``engine.prefill=error`` fails the prefilling request and recovers, on
  both plans;
- the same request sequences reach ``engine.step`` and ``engine.prefill``
  the same number of times in both packages (tpulab's five sites: the
  split prefill, the ragged prefill start, a mixed round carrying decode
  lanes, each tick of a K-block, the K=1 tick);
- ``FaultSchedule.fired_snapshot`` / ``seen_snapshot``, the module's
  ``fired_snapshot`` and the fire observer agree with tpulab's on the
  same specs and seeds.

Every comparison is exact (counts, outcomes, page numbers).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab import chaos as jchaos
from tpulab.core.deadline import DeadlineExceeded as JaxDeadline
from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.engine.paged import SamplingParams as JaxSampling
from tpulab.models.transformer import init_transformer_params
from tpulab_torch import chaos as tchaos
from tpulab_torch.core.deadline import DeadlineExceeded as TorchDeadline
from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
from tpulab_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

PLANS = ("ragged", "split")
CFG = dict(n_heads=2, n_layers=2, lanes=2, max_len=64, page_size=8)


@pytest.fixture(scope="module")
def lm():
    p = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu", n_heads=2)


def _pair(lm, plan, **kw):
    """(package name, batcher, its chaos module, its DeadlineExceeded,
    its SamplingParams) for tpulab and the port, same config."""
    ragged = plan == "ragged"
    j = JaxBatcher(lm[0], compute_dtype=jnp.float32, use_kernel=False,
                   ragged=ragged, **CFG, **kw)
    t = ContinuousBatcher(lm[1], compute_dtype=torch.float32, device="cpu",
                          ragged=ragged, **CFG, **kw)
    return [("tpulab", j, jchaos, JaxDeadline, JaxSampling),
            ("port", t, tchaos, TorchDeadline, SamplingParams)]


def _settle(cb, free0, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and (
            cb.active_lanes or cb.queued_requests
            or cb.pool.free_pages != free0):
        time.sleep(0.01)
    return cb.active_lanes, cb.queued_requests, cb.pool.free_pages


def _fault_then_recover(cb, chaos, spec, prompt):
    """A request under ``spec`` (its outcome), then a plain one."""
    free0 = cb.pool.free_pages
    with chaos.inject(spec) as sched:
        fut = cb.submit(prompt, 8)
        try:
            fut.result(timeout=120)
            outcome = "ok"
        except chaos.ChaosError:
            outcome = "ChaosError"
        fired = sched.fired_snapshot()
    after = len(cb.submit(prompt, 5).result(timeout=120))
    return outcome, fired, after, free0, _settle(cb, free0)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("spec,point", [
    ("engine.step=error@1+1", "engine.step"),
    ("engine.prefill=error+1", "engine.prefill")])
def test_engine_fault_fails_inflight_and_recovers(lm, plan, spec, point):
    """tpulab's transient-fault scenario: the fault fails the in-flight
    request, the pool resets and the next request is served; both
    packages give the same outcome, fired counts and page counts (on the
    parent the port's batcher had no such site and served the request)."""
    prompt = np.arange(4, dtype=np.int32)
    got = {}
    for name, cb, chaos, _dl, _sp in _pair(lm, plan):
        try:
            assert len(cb.submit(prompt, 3).result(timeout=120)) == 3
            got[name] = _fault_then_recover(cb, chaos, spec, prompt)
        finally:
            cb.shutdown()
    outcome, fired, after, free0, settled = got["port"]
    assert outcome == "ChaosError" and fired == {point: 1}
    assert after == 5 and settled == (0, 0, free0)
    assert got["port"] == got["tpulab"]


@pytest.mark.parametrize("plan", PLANS)
def test_deadline_storm_frees_lanes_and_pages(lm, plan):
    """tpulab's deadline storm: six requests whose budgets are far below
    their decode time on slowed steps all fail DeadlineExceeded, every
    lane and page returns, and the batcher keeps serving — in both
    packages, with the same page counts."""
    prompt = np.arange(4, dtype=np.int32)
    got = {}
    for name, cb, chaos, deadline_exc, _sp in _pair(lm, plan):
        try:
            assert len(cb.submit(prompt, 3).result(timeout=120)) == 3
            free0 = cb.pool.free_pages
            with chaos.inject("engine.step=delay:0.05") as sched:
                futs = [cb.submit(prompt, 50, deadline=0.2)
                        for _ in range(6)]
                outcomes = []
                for f in futs:
                    try:
                        f.result(timeout=60)
                        outcomes.append("ok")
                    except deadline_exc:
                        outcomes.append("DeadlineExceeded")
                delayed = sched.fired("engine.step") > 0
            settled = _settle(cb, free0)
            after = len(cb.submit(prompt, 4).result(timeout=120))
            got[name] = (outcomes, delayed, free0, settled, after)
        finally:
            cb.shutdown()
    outcomes, delayed, free0, settled, after = got["port"]
    assert outcomes == ["DeadlineExceeded"] * 6 and delayed
    assert settled == (0, 0, free0) and after == 4
    assert got["port"] == got["tpulab"]


@pytest.mark.parametrize("plan", PLANS)
def test_fault_sites_reached_as_in_tpulab(lm, plan):
    """One request sequence, a schedule whose only rule never fires: both
    packages reach ``engine.prefill`` and ``engine.step`` equally often.
    The sequence covers every site: two requests admitted in one pass
    (a 5-token prompt decodes while a 30-token prompt prefills in
    16-token chunks: a mixed round carrying a decode lane under the
    ragged plan), fused K-blocks, and a host-sampled request (K=1
    ticks)."""
    rng = np.random.default_rng(0)
    short, long_ = (rng.integers(0, 64, (n,), np.int32) for n in (5, 30))
    got = {}
    for name, cb, chaos, _dl, sampling in _pair(lm, plan, decode_block=4,
                                                 prefill_chunk=16):
        try:
            with chaos.inject("engine.none=delay:0") as sched:
                with cb._cv:      # both admitted in the same pass
                    futs = [cb.submit(short, 12), cb.submit(long_, 6)]
                lens = [len(f.result(timeout=120)) for f in futs]
                lens.append(len(cb.submit(short, 6, sampling=sampling(
                    temperature=0.9, top_k=5, seed=7)).result(timeout=120)))
                got[name] = (lens, sched.seen_snapshot(),
                             cb.pool.free_pages)
        finally:
            cb.shutdown()
    lens, seen, _free = got["port"]
    assert lens == [12, 6, 6]
    assert seen["engine.prefill"] == 3 and seen["engine.step"] > 0
    assert got["port"] == got["tpulab"]


SPECS = [
    ("engine.step=delay:0@2+3;rpc.stream=error%0.5", 7),
    ("kvcache.swap=drop+2;engine.step=error@5;engine.prefill=delay:0%0.3",
     3),
    ("a=error%0.25;a=delay:0%0.5;b=drop@1+4", 11),
]


@pytest.mark.parametrize("spec,seed", SPECS)
def test_snapshots_and_observer_match_tpulab(spec, seed):
    """The same spec, seed and sequence of trips: equal fired / seen
    snapshots (schedule and module level) and the same observer calls.
    The parent's port had none of these functions."""
    points = ["engine.step", "rpc.stream", "kvcache.swap", "engine.prefill",
              "a", "b"] * 12

    def drive(chaos):
        calls = []
        chaos.set_observer(lambda p, a: calls.append((p, a)))
        outcomes = []
        try:
            with chaos.inject(spec, seed=seed) as sched:
                assert chaos.fired_snapshot() == {}
                for p in points:
                    try:
                        outcomes.append(chaos.trip(p))
                    except chaos.ChaosError:
                        outcomes.append("error")
                module_fired = chaos.fired_snapshot()
            disarmed = chaos.fired_snapshot()
        finally:
            chaos.set_observer(None)
        return (outcomes, calls, sched.fired_snapshot(),
                sched.seen_snapshot(), module_fired, disarmed)

    want, got = drive(jchaos), drive(tchaos)
    assert got == want
    outcomes, calls, fired, seen, module_fired, disarmed = got
    assert module_fired == fired and disarmed == {}
    assert sum(fired.values()) == len(calls) > 0
    assert seen == {p: 12 for p in set(points)}


def test_observer_failure_does_not_change_injection():
    """A raising observer is swallowed: the rule still fires (tpulab's
    contract)."""
    def bad(point, action):
        raise RuntimeError("observer broke")

    tchaos.set_observer(bad)
    try:
        with tchaos.inject("x=error+1") as sched:
            with pytest.raises(tchaos.ChaosError):
                tchaos.trip("x")
            assert tchaos.trip("x") is None
        assert sched.fired("x") == 1 and sched.occurrences("x") == 2
    finally:
        tchaos.set_observer(None)
