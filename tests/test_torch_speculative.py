"""tpulab_torch speculative decoding vs tpulab's, on the CPU.

The model: vocab 64, d_model 32, 2 heads, 2 layers, f32, with layer 1's
``wo`` / ``w2`` scaled by 0.05 — tpulab's trained-model emulation, so the
1-layer early-exit draft actually agrees with the target (random tails
pin acceptance near 0).  Weights are built by tpulab and bridged bit for
bit (``params_from_numpy``); the draft is ``early_exit_draft`` on each
side.

Tolerances: tokens, emitted masks, lengths, live masks, step budgets,
drafted and accepted counts are EXACT; log-probabilities, written pool
rows and logits agree within 1e-5 (f32 on both sides, different
summation orders: ~1e-6 apart); the dense SpeculativeGenerator's tokens,
``rounds`` and ``accepted`` are exact.

- ``paged_speculative_block`` against tpulab's (``use_kernel=False``) on
  the same pool, tables and inputs;
- the port's speculating batcher against tpulab's, and against the
  port's own plain blocks and dense greedy reference;
- port-side counterparts of ``tests/test_speculative_block.py`` (sync
  budget, fallbacks, chaos verify trip, page reservation, pool pressure,
  preemption, streaming, accounting, probes, admission cost);
- the dense primitives and ``SpeculativeGenerator`` / the session
  engine against ``tests/test_serving_extras.py``'s cases.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.engine import paged as jp
from tpulab.engine.speculative import SpeculativeGenerator as JaxSpecGen
from tpulab.models import transformer as jt
from tpulab_torch import chaos
from tpulab_torch.core.deadline import Deadline, DeadlineExceeded
from tpulab_torch.engine import paged as tp
from tpulab_torch.engine.speculative import (SpeculativeGenerator,
                                             SpeculativeSessionEngine)
from tpulab_torch.models import transformer as tt
from tpulab_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF = 64, 32, 2, 2, 64
PAGE = 8
LP_TOL = 1e-5


def _bridge(pj, n_heads, n_kv_heads=None, rope_theta=None):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu",
                             n_heads=n_heads, n_kv_heads=n_kv_heads,
                             rope_theta=rope_theta)


@pytest.fixture(scope="module")
def lm():
    p = jt.init_transformer_params(vocab=VOCAB, d_model=D_MODEL,
                                   n_heads=N_HEADS, n_layers=N_LAYERS,
                                   d_ff=D_FF)
    for w in ("wo", "w2"):   # trained-model emulation (see module doc)
        p["layer1"][w] = p["layer1"][w] * 0.05
    return p, _bridge(p, N_HEADS)


@pytest.fixture(scope="module")
def dense(lm):
    """The port's dense greedy reference (held against tpulab's below)."""
    gen = tt.make_generate_fn(lm[1], n_heads=N_HEADS, n_layers=N_LAYERS,
                              max_len=128, compute_dtype=torch.float32)
    return lambda p, s: gen(p[None, :], s)[0].tolist()


def _batcher(model, draft="early_exit", k=8, **kw):
    """draft: None = plain; "early_exit" = the 1-layer early-exit draft;
    "self" = the target itself (acceptance 1); or a tree (then
    draft_n_layers in kw)."""
    kw.setdefault("lanes", 2)
    kw.setdefault("max_len", 96)
    # two tables per lane want about double the plain pool
    kw.setdefault("n_pages", 2 * kw["lanes"] * ((kw["max_len"] + 7) // 8)
                  + 1)
    if draft == "early_exit":
        draft, kw["draft_n_layers"] = tt.early_exit_draft(model, 1), 1
    elif draft == "self":
        draft, kw["draft_n_layers"] = model, N_LAYERS
    return tp.ContinuousBatcher(model, n_heads=N_HEADS, n_layers=N_LAYERS,
                                page_size=PAGE, compute_dtype=torch.float32,
                                decode_block=k, draft_params=draft,
                                device="cpu", **kw)


def _argmin_draft(model):
    """The target with a NEGATED vocab head: it proposes the argmin, so it
    never agrees with the target (an adversarial draft)."""
    bad = dict(tt.early_exit_draft(model, N_LAYERS))
    bad["lm_head"] = -model.params["embed"].T.contiguous()
    return bad


def _home(cb):
    assert cb.pool.free_pages == cb.pool.n_pages - 1


# ------------------------------------------------- paged_speculative_block --
@pytest.mark.parametrize("rope", [None, 10000.0])
def test_speculative_block_matches_tpulab(lm, rope):
    """One speculative block on both sides: a lane whose block crosses a
    page, one with steps_rem < K+1, one with a stop id mid-block, a dead
    lane and a device-sampled lane.  Draft and target share the pool
    through two tables."""
    pj, _ = lm
    model = _bridge(pj, N_HEADS, rope_theta=rope)
    k, b, mp = 4, 5, 4
    n_pages = 1 + 2 * b * mp
    rng = np.random.default_rng(0)
    shape = (N_LAYERS, n_pages, 2, PAGE, N_HEADS, D_MODEL // N_HEADS)
    pool = rng.standard_normal(shape).astype(np.float32)
    ids = rng.permutation(n_pages - 1) + 1
    tables = ids[:b * mp].reshape(b, mp).astype(np.int32)
    dtables = ids[b * mp:].reshape(b, mp).astype(np.int32)
    lengths = np.array([6, 12, 9, 3, 14])          # lane 0: 6..10 crosses
    tokens = rng.integers(0, VOCAB, b)
    active = np.array([True, True, True, False, True])
    temps = np.array([0, 0, 0, 0, 0.8], np.float32)
    seeds = np.array([[0, 0]] * 4 + [[1234, 5]], np.int64)
    rem = np.array([20, 2, 20, 20, 20])
    kw = dict(n_heads=N_HEADS, n_layers=N_LAYERS, draft_n_heads=N_HEADS,
              draft_n_layers=1, k=k, rope_theta=rope)
    draft_j = jt.early_exit_draft(pj, 1)
    draft_t = tt.early_exit_draft(model, 1)

    def run_jax(stops):
        return jp.paged_speculative_block(
            pj, draft_j, jnp.asarray(pool), jnp.asarray(tables),
            jnp.asarray(dtables), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(tokens, jnp.int32), jnp.asarray(active),
            jnp.asarray(temps), jnp.asarray(seeds, jnp.uint32),
            jnp.asarray(rem, jnp.int32), jnp.asarray(stops, jnp.int32),
            compute_dtype=jnp.float32, use_kernel=False, **kw)

    # the stop id: lane 2's third target choice of an unstopped block
    stops = np.full((b, 2), -1)
    stops[2, 0] = int(np.asarray(run_jax(stops)[0])[2, 2])
    out_j = run_jax(stops)
    kv_t = torch.from_numpy(pool.copy())
    out_t = tp.paged_speculative_block(
        model.params, draft_t, kv_t, torch.from_numpy(tables),
        torch.from_numpy(dtables), torch.from_numpy(lengths),
        torch.from_numpy(tokens), torch.from_numpy(active),
        torch.from_numpy(temps), torch.from_numpy(seeds),
        torch.from_numpy(rem), torch.from_numpy(stops),
        compute_dtype=torch.float32, **kw)
    cand_j, lps_j = np.asarray(out_j[0]), np.asarray(out_j[1])
    # token rows past a lane's verify window (q_lens) come from logits of
    # rows the forward never wrote: compared only where they are real
    q_lens = np.where(active, np.minimum(k + 1, rem), 0)
    valid = np.arange(k + 1)[None, :] < q_lens[:, None]
    assert (out_t[0].numpy()[valid] == cand_j[valid]).all()
    np.testing.assert_allclose(out_t[1].numpy()[valid], lps_j[valid],
                               rtol=LP_TOL, atol=LP_TOL)
    names = ("emitted", "lengths", "tokens", "live", "steps_rem", "drafted",
             "accepted")
    for name, got, want in zip(names, out_t[2:], out_j[2:9]):
        assert got.tolist() == np.asarray(want).tolist(), name
    np.testing.assert_allclose(kv_t[:, 1:].numpy(),
                               np.asarray(out_j[9])[:, 1:],
                               rtol=LP_TOL, atol=LP_TOL)
    em = out_t[2].numpy()
    # the cases really occur: a crossing, a budget cut, a stop, a dead
    # lane emitting nothing and speculation accepting something
    assert em[0].sum() >= 3 and em[1].sum() <= 2 and em[3].sum() == 0
    assert out_t[0][2, em[2].sum() - 1] == stops[2, 0]
    assert not out_t[5][2] and out_t[8].sum() > 0


# ----------------------------------------------- batcher vs tpulab batcher --
def _spec_mix(cb, sampling_cls):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, (n,), np.int32)
               for n in (5, 8, 13, 1, 4)]
    out = {}
    # page crossings: writes start mid-page and cross inside blocks
    for i, (p, s) in enumerate(zip(prompts[:4], (20, 17, 30, 9))):
        out[f"greedy{i}"] = list(cb.submit(p, s).result(timeout=300))
    out["steps5"] = list(cb.submit(prompts[4], 5).result(timeout=300))
    stop = out["greedy0"][6]
    out["eos"] = list(cb.submit(prompts[0], 20,
                                stop_tokens=[stop]).result(timeout=300))
    out["device"] = list(cb.submit(prompts[1], 20, sampling=sampling_cls(
        temperature=0.9, seed=1234, device=True)).result(timeout=300))
    toks, lps = cb.submit(prompts[2], 12, logprobs=True).result(timeout=300)
    out["logprobs"] = (list(toks), list(lps))
    out["spec_dispatches"] = cb.spec_dispatches
    return out


@pytest.fixture(scope="module")
def served(lm):
    pj, model = lm
    ref = jp.ContinuousBatcher(
        pj, n_heads=N_HEADS, n_layers=N_LAYERS, page_size=PAGE,
        compute_dtype=jnp.float32, decode_block=8, use_kernel=False,
        ragged=True, lanes=2, max_len=96, n_pages=2 * 2 * 12 + 1,
        draft_params=jt.early_exit_draft(pj, 1), draft_n_layers=1)
    try:
        want = _spec_mix(ref, jp.SamplingParams)
    finally:
        ref.shutdown()
    cb = _batcher(model)
    try:
        got = _spec_mix(cb, tp.SamplingParams)
    finally:
        cb.shutdown()
    _home(cb)
    return want, got


@pytest.mark.parametrize("case", ["greedy0", "greedy1", "greedy2", "greedy3",
                                  "steps5", "eos", "device"])
def test_batcher_streams_match_tpulab(served, case):
    want, got = served
    assert got[case] == want[case]
    assert got["spec_dispatches"] > 0 and want["spec_dispatches"] > 0


def test_batcher_logprobs_match_tpulab(served):
    want, got = served
    assert got["logprobs"][0] == want["logprobs"][0]
    np.testing.assert_allclose(got["logprobs"][1], want["logprobs"][1],
                               rtol=LP_TOL, atol=LP_TOL)


def test_batcher_streams_match_plain_and_dense(lm, served, dense):
    """Speculation is a dispatch-shape change only: the port's plain
    blocks and its dense greedy reference give the same streams."""
    _, got = served
    cb = _batcher(lm[1], draft=None)
    try:
        plain = _spec_mix(cb, tp.SamplingParams)
    finally:
        cb.shutdown()
    assert plain["spec_dispatches"] == 0
    for case in ("greedy0", "greedy1", "greedy2", "greedy3", "steps5",
                 "eos", "device"):
        assert got[case] == plain[case], case
    assert got["logprobs"][0] == plain["logprobs"][0]
    np.testing.assert_allclose(got["logprobs"][1], plain["logprobs"][1],
                               rtol=LP_TOL, atol=LP_TOL)
    rng = np.random.default_rng(5)
    p0 = rng.integers(0, VOCAB, (5,), np.int32)
    assert got["greedy0"] == dense(p0, 20)
    stop = got["greedy0"][6]
    assert got["eos"] == got["greedy0"][:got["greedy0"].index(stop) + 1]


# ------------------------------------------------- port-side policy cases --
def test_host_syncs_strictly_decrease(lm):
    """At acceptance > 0 one blocking fetch covers up to K+1 tokens: a
    speculating request's decode syncs undercut plain K-blocks."""
    p = np.random.default_rng(7).integers(0, VOCAB, (5,), np.int32)
    res = {}
    for mode in (None, "self"):
        cb = _batcher(lm[1], draft=mode, lanes=1)
        try:
            out = list(cb.submit(p, 80).result(timeout=300))
            res[mode] = (cb.decode_host_syncs, cb.tokens_generated, out)
        finally:
            cb.shutdown()
        _home(cb)
    assert res["self"][2] == res[None][2]
    assert res["self"][1] == res[None][1] == 80    # accepted-only counting
    assert res["self"][0] < res[None][0], (res["self"][0], res[None][0])


def test_device_sampled_and_logprobs_parity_self_draft(lm):
    """Seeded device-sampled streams and logprobs are those of plain
    blocks; a perfect draft reaches full acceptance under sampling."""
    p = np.random.default_rng(6).integers(0, VOCAB, (5,), np.int32)
    sp = dict(temperature=0.9, seed=1234, device=True)
    outs = {}
    for mode in (None, "self"):
        cb = _batcher(lm[1], draft=mode, lanes=1)
        try:
            outs[mode] = (
                list(cb.submit(p, 20, sampling=tp.SamplingParams(
                    **sp)).result(timeout=300)),
                cb.submit(p, 12, logprobs=True).result(timeout=300))
            if mode == "self":
                assert cb.spec_dispatches > 0 and cb.spec_acceptance > 0.9
        finally:
            cb.shutdown()
    assert outs["self"][0] == outs[None][0] and len(outs[None][0]) == 20
    assert list(outs["self"][1][0]) == list(outs[None][1][0])
    np.testing.assert_allclose(outs["self"][1][1], outs[None][1][1],
                               rtol=LP_TOL, atol=LP_TOL)


def test_adversarial_draft_falls_back(lm, dense):
    """An argmin draft: the acceptance EWMA falls through the floor, the
    lane degrades (draft pages returned), output stays greedy and most
    dispatches run plain."""
    p = np.random.default_rng(4).integers(0, VOCAB, (5,), np.int32)
    cb = _batcher(lm[1], draft=_argmin_draft(lm[1]), draft_n_layers=2,
                  lanes=1)
    try:
        assert list(cb.submit(p, 40).result(timeout=300)) == dense(p, 40)
        assert cb.spec_fallbacks >= 1
        assert cb.spec_acceptance < 0.3
        assert cb.decode_dispatches > cb.spec_dispatches
    finally:
        cb.shutdown()
    _home(cb)


def test_host_sampled_lane_never_speculates(lm):
    ph = np.random.default_rng(2).integers(0, VOCAB, (4,), np.int32)
    sp = dict(temperature=0.8, top_k=8, seed=55)
    cb1 = _batcher(lm[1], draft=None, k=1, lanes=1)
    try:
        want = list(cb1.submit(ph, 10, sampling=tp.SamplingParams(
            **sp)).result(timeout=300))
    finally:
        cb1.shutdown()
    cb = _batcher(lm[1], draft="self", lanes=2)
    try:
        got = list(cb.submit(ph, 10, sampling=tp.SamplingParams(
            **sp)).result(timeout=300))
        assert got == want
        assert cb.spec_dispatches == 0 and cb.spec_tokens_drafted == 0
    finally:
        cb.shutdown()


@pytest.mark.chaos
@pytest.mark.parametrize("spec", ["engine.verify=error+1",
                                  "engine.verify=drop+1"])
def test_chaos_verify_trip_degrades_lane(lm, dense, spec):
    """A tripped verify (error or drop) degrades the lane before anything
    is dispatched: the output is exactly greedy, the draft pages come
    home, and the next request speculates again."""
    p = np.random.default_rng(31).integers(0, VOCAB, (5,), np.int32)
    cb = _batcher(lm[1], draft="self", lanes=1)
    try:
        with chaos.inject(spec) as sched:
            assert list(cb.submit(p, 20).result(timeout=300)) == dense(p, 20)
            assert sched.fired("engine.verify") == 1
        assert cb.spec_fallbacks >= 1 and cb.spec_dispatches == 0
        assert list(cb.submit(p, 20).result(timeout=300)) == dense(p, 20)
        assert cb.spec_dispatches > 0
    finally:
        cb.shutdown()
    _home(cb)


def test_reserve_shrinks_draft_k_before_target_pages(lm):
    cb = _batcher(lm[1], draft="self", lanes=1, max_len=64, n_pages=4)
    try:
        free0 = cb.pool.free_pages            # 3 usable pages
        req = tp._PagedRequest(np.ones(4, np.int32), 40)
        req.tokens_out, req.length = [1], 4
        kd, parts = cb._reserve_spec_pages([(0, req)], 8)
        # 9 appends want 2 target pages, but 1 page is left for the draft:
        # cov_d = 4 -> kd 2, and the surplus target page goes back
        assert kd == 2 and len(parts) == 1
        assert len(req.pages) == 1 and len(req.draft_pages) == 1
        assert cb.pool.free_pages == free0 - 2
        cb._degrade_spec(req)
        assert req.draft_pages == [] and req.draft_len == 0
        assert cb.pool.free_pages == free0 - 1
        cb.pool.release_pages(req.pages)
        # a pool that cannot cover ONE draft append refuses speculation
        # and keeps the target reservation for the plain path
        grab = [cb.pool.allocate_page() for _ in range(free0 - 1)]
        req2 = tp._PagedRequest(np.ones(4, np.int32), 40)
        req2.tokens_out, req2.length = [1], 4
        assert cb._reserve_spec_pages([(0, req2)], 8) == (0, [])
        assert len(req2.pages) == 1 and req2.draft_pages == []
        cb.pool.release_pages(req2.pages + grab)
        assert cb.pool.free_pages == free0
    finally:
        cb.shutdown()


def test_pool_pressure_completes(lm, dense):
    cb = _batcher(lm[1], lanes=2, max_len=48, n_pages=9)   # 8 usable
    try:
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, VOCAB, (6,), np.int32) for _ in range(4)]
        futs = [cb.submit(p, 16) for p in prompts]
        for p, f in zip(prompts, futs):
            assert list(f.result(timeout=300)) == dense(p, 16)
    finally:
        cb.shutdown()
    _home(cb)


def test_preempt_resume_regenerates_exactly(lm, dense):
    """The draft table is released at eviction and regenerated by the
    resume's warm-up: both requests equal the dense reference."""
    p_low = np.random.default_rng(31).integers(0, VOCAB, (6,), np.int32)
    p_hi = np.random.default_rng(32).integers(0, VOCAB, (5,), np.int32)
    cb = _batcher(lm[1], draft="self", lanes=1, max_len=64, n_pages=17)
    try:
        late = {}

        def arrive(tok, i):          # on the scheduler thread: no race
            if i == 3:
                late["f"] = cb.submit(p_hi, 4, priority=10)

        got_low = list(cb.submit(p_low, 24, on_token=arrive).result(
            timeout=300))
        got_hi = list(late["f"].result(timeout=300))
        assert cb.preemptions >= 1
        assert cb.spec_draft_prefills >= 2   # first warm-up + re-warm
        assert got_low == dense(p_low, 24) and got_hi == dense(p_hi, 4)
    finally:
        cb.shutdown()
    _home(cb)


def test_streaming_callbacks_in_order(lm):
    cb = _batcher(lm[1], lanes=1)
    try:
        streamed = []
        p = np.random.default_rng(4).integers(0, VOCAB, (4,), np.int32)
        final = cb.submit(p, 13, on_token=lambda tok, i: streamed.append(
            (i, tok))).result(timeout=300)
        assert [i for i, _t in streamed] == list(range(13))
        assert [t for _i, t in streamed] == list(final)
        assert cb.spec_dispatches > 0
    finally:
        cb.shutdown()


def test_accounting_counts_accepted_tokens_only(lm):
    """Rejected proposals appear in spec_tokens_drafted only: tokens
    generated are the output, and the dispatch and forward counters add
    up (one target forward a speculative dispatch, K+1 draft forwards
    plus one per warm-up)."""
    cb = _batcher(lm[1], draft=_argmin_draft(lm[1]), draft_n_layers=2,
                  lanes=1)
    try:
        p = np.random.default_rng(3).integers(0, VOCAB, (5,), np.int32)
        out = list(cb.submit(p, 24).result(timeout=300))
        assert 0 <= cb.spec_tokens_accepted <= cb.spec_tokens_drafted
        assert cb.spec_tokens_drafted > 0
        assert cb.tokens_generated == len(out) == 24
        assert cb.dispatch_kinds["verify"] == cb.spec_dispatches
        assert cb.spec_acceptance == pytest.approx(
            cb.spec_tokens_accepted / cb.spec_tokens_drafted)
    finally:
        cb.shutdown()
    cb = _batcher(lm[1], draft="self", lanes=1)
    try:
        out = list(cb.submit(p, 30).result(timeout=300))
        k_sum = cb.spec_tokens_drafted    # one K per dispatch, one lane
        assert cb.draft_forward_steps == (k_sum + cb.spec_dispatches
                                          + cb.spec_draft_prefills)
        assert cb.tokens_generated == 30
    finally:
        cb.shutdown()


def test_probe_state_machine(lm):
    cb = _batcher(lm[1], draft="self", lanes=1)
    try:
        req = tp._PagedRequest(np.ones(4, np.int32), 40)
        req.tokens_out = [1]
        cb._degrade_spec(req, probe=True)
        assert not req.spec_enabled
        assert req.spec_probe_in == cb.SPEC_PROBE_INTERVAL == 4
        for i in range(cb.SPEC_PROBE_INTERVAL - 1):
            cb._probe_countdown_locked(req)
            assert not req.spec_enabled, i
        cb._probe_countdown_locked(req)
        assert req.spec_enabled and req.spec_probing
        assert req.spec_ewma == cb.spec_accept_floor == 0.35
        assert req.spec_probe_in is None and cb.spec_probes == 1
        req2 = tp._PagedRequest(np.ones(4, np.int32), 40)
        req2.tokens_out = [1]
        cb._degrade_spec(req2)          # a verify trip: never probes
        assert req2.spec_probe_in is None
        for _ in range(3 * cb.SPEC_PROBE_INTERVAL):
            cb._probe_countdown_locked(req2)
        assert not req2.spec_enabled and not req2.spec_probing
    finally:
        cb.shutdown()


def test_probe_recovers_after_transient_degrade(lm, dense):
    """A forced EWMA-style degrade runs plain blocks for the probe
    interval, then a probe whose acceptance re-enables speculation; the
    stream stays exactly greedy."""
    p = np.random.default_rng(17).integers(0, VOCAB, (5,), np.int32)
    cb = _batcher(lm[1], draft="self", lanes=1, max_len=96)
    try:
        mark = {}

        def degrade(tok, i):         # on the scheduler thread
            if i == 1:
                req = next(r for r in cb._active if r is not None)
                with cb._cv:
                    cb._degrade_spec(req, probe=True)
                mark["spec"] = cb.spec_dispatches

        got = list(cb.submit(p, 60, on_token=degrade).result(timeout=300))
        assert got == dense(p, 60)
        assert cb.spec_probes >= 1 and cb.spec_probe_recoveries >= 1
        assert cb.spec_dispatches > mark["spec"]
    finally:
        cb.shutdown()
    _home(cb)


def test_admission_cost_factor(lm):
    spec = _batcher(lm[1], draft="self", lanes=1, max_len=48)
    plain = _batcher(lm[1], draft=None, lanes=1, max_len=48)
    try:
        assert spec.admission_cost_factor == 2.0
        assert plain.admission_cost_factor == 1.0
    finally:
        spec.shutdown()
        plain.shutdown()


def test_draft_pages_come_home_on_cancel_and_release(lm):
    """A lane released mid-request (cancel) returns its draft table too."""
    p = np.random.default_rng(9).integers(0, VOCAB, (5,), np.int32)
    cb = _batcher(lm[1], draft="self", lanes=1)
    try:
        started = threading.Event()
        fut = cb.submit(p, 80, on_token=lambda t, i: (
            started.set(), time.sleep(0.02)))
        assert started.wait(timeout=120)
        deadline = time.monotonic() + 60
        while cb.spec_dispatches == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert cb.spec_dispatches > 0
        cb.cancel(fut)
        deadline = time.monotonic() + 60
        while cb.active_lanes and time.monotonic() < deadline:
            time.sleep(0.005)
        _home(cb)
        assert len(cb.submit(p, 6).result(timeout=300)) == 6
    finally:
        cb.shutdown()
    _home(cb)


@pytest.mark.parametrize("kw,match", [
    (dict(draft_n_heads=1), "KV geometry"),
    (dict(draft_n_layers=3), "draft_n_layers"),
])
def test_constructor_refuses_bad_draft(lm, kw, match):
    with pytest.raises(ValueError, match=match):
        tp.ContinuousBatcher(lm[1], n_heads=N_HEADS, n_layers=N_LAYERS,
                             compute_dtype=torch.float32, device="cpu",
                             draft_params=lm[1], **kw)


@pytest.mark.parametrize("as_module", [True, False])
def test_early_exit_draft_shares_storage(lm, as_module):
    model = lm[1]
    draft = tt.early_exit_draft(model if as_module else model.params, 1)
    assert set(draft) == {"embed", "final_norm", "layer0"}
    tree = model.params
    assert draft["embed"].data_ptr() == tree["embed"].data_ptr()
    for name in ("wqkv", "wo", "w1", "w2"):
        assert (draft["layer0"][name].data_ptr()
                == tree["layer0"][name].data_ptr())


# -------------------------------------------------- dense decode primitives
DENSE_CFGS = {
    "mha": dict(n_heads=2, n_kv_heads=None, rope_theta=None, ffn="gelu",
                d_model=32),
    "gqa_rope": dict(n_heads=4, n_kv_heads=2, rope_theta=10000.0,
                     ffn="swiglu", d_model=64),
}


def _dense_pair(name, seed=0):
    c = DENSE_CFGS[name]
    pj = jt.init_transformer_params(vocab=VOCAB, d_model=c["d_model"],
                                    n_heads=c["n_heads"], n_layers=2,
                                    d_ff=96, n_kv_heads=c["n_kv_heads"],
                                    ffn=c["ffn"], seed=seed)
    kw = dict(n_heads=c["n_heads"], n_layers=2, n_kv_heads=c["n_kv_heads"],
              rope_theta=c["rope_theta"])
    return pj, _bridge(pj, c["n_heads"], c["n_kv_heads"], c["rope_theta"]), kw


@pytest.mark.parametrize("name", sorted(DENSE_CFGS))
def test_chunk_and_decode_step_match_tpulab(name):
    """A 6-token chunk at 0, a 3-token chunk at 6, one decode step at 9:
    logits and every written cache row within 1e-5."""
    pj, model, kw = _dense_pair(name)
    hd = pj["embed"].shape[1] // kw["n_heads"]
    n_kv = kw["n_kv_heads"] or kw["n_heads"]
    cj = jt.init_kv_cache(1, 16, 2, n_kv, hd, jnp.float32)
    ct = tt.init_kv_cache(1, 16, 2, n_kv, hd, torch.float32, "cpu")
    toks = np.random.default_rng(1).integers(0, VOCAB, (1, 10))
    for lo, hi in ((0, 6), (6, 9)):
        lj, cj = jt.transformer_chunk_step(
            pj, cj, jnp.asarray(toks[:, lo:hi], jnp.int32), jnp.int32(lo),
            compute_dtype=jnp.float32, **kw)
        lt, ct = tt.transformer_chunk_step(
            model, ct, torch.from_numpy(toks[:, lo:hi]), lo,
            compute_dtype=torch.float32, **kw)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                                   atol=1e-5)
    lj, cj = jt.transformer_decode_step(
        pj, cj, jnp.asarray(toks[:, 9], jnp.int32), jnp.int32(9),
        compute_dtype=jnp.float32, **kw)
    lt, ct = tt.transformer_decode_step(model, ct,
                                        torch.from_numpy(toks[:, 9]), 9,
                                        compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)
    for layer in cj:
        for kv in ("k", "v"):
            np.testing.assert_allclose(ct[layer][kv].numpy(),
                                       np.asarray(cj[layer][kv]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(DENSE_CFGS))
def test_make_generate_fn_matches_tpulab(name):
    pj, model, kw = _dense_pair(name)
    prompt = np.random.default_rng(2).integers(0, VOCAB, (2, 5), np.int32)
    want = np.asarray(jt.make_generate_fn(
        pj, max_len=32, compute_dtype=jnp.float32, **kw)(
            jnp.asarray(prompt), 9))
    got = tt.make_generate_fn(model, max_len=32,
                              compute_dtype=torch.float32, **kw)(prompt, 9)
    assert got.tolist() == want.tolist()


def test_chunk_step_refuses_a_chunk_past_the_cache():
    _, model, kw = _dense_pair("mha")
    cache = tt.init_kv_cache(1, 8, 2, 2, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        tt.transformer_chunk_step(model, cache, torch.zeros(1, 4).long(), 6,
                                  compute_dtype=torch.float32, **kw)


# ----------------------------------------------- dense SpeculativeGenerator --
def _spec_pair(case):
    """(tpulab generator, port generator) of one tests/test_serving_extras
    case: a perfect draft, the same at x8 weight scale, and a mismatched
    draft of another architecture."""
    pj, model, kw = _dense_pair("gqa_rope")
    common = dict(n_heads=4, n_layers=2, k=3, max_len=96,
                  n_kv_heads=2, rope_theta=10000.0)
    if case == "self":
        tj, dj, tm, dm, extra = pj, pj, model, model, {}
    elif case == "big":
        tj = jax.tree_util.tree_map(lambda x: x * 8.0, pj)
        tm = _bridge(tj, 4, 2, 10000.0)
        dj, dm, extra = tj, tm, {}
    else:
        dj = jt.init_transformer_params(vocab=VOCAB, d_model=32, n_heads=2,
                                        n_layers=1, d_ff=48, n_kv_heads=2,
                                        ffn="swiglu", seed=9)
        tj, tm, dm = pj, model, _bridge(dj, 2, 2, 10000.0)
        extra = dict(draft_n_heads=2, draft_n_layers=1, draft_n_kv_heads=2)
    gj = JaxSpecGen(tj, dj, compute_dtype=jnp.float32, **common, **extra)
    gt = SpeculativeGenerator(tm, dm, compute_dtype=torch.float32,
                              device="cpu", **common, **extra)
    return gj, gt, pj, model


@pytest.mark.parametrize("case", ["self", "big", "mixed"])
def test_speculative_generator_matches_tpulab(case):
    gj, gt, _, model = _spec_pair(case)
    prompt = np.random.default_rng(0).integers(0, VOCAB, (6,), np.int32)
    want = gj.generate(prompt, 12)
    got = gt.generate(prompt, 12)
    assert got == want
    assert (gt.rounds, gt.accepted) == (gj.rounds, gj.accepted)
    if case != "mixed":
        assert gt.accepted == gt.rounds * 3       # full acceptance
    if case == "self":
        dense = tt.make_generate_fn(model, n_heads=4, n_layers=2, max_len=96,
                                    compute_dtype=torch.float32,
                                    n_kv_heads=2, rope_theta=10000.0)
        assert got == dense(prompt[None], 12)[0].tolist()


def test_speculative_generator_validates_eagerly():
    _, model, kw = _dense_pair("mha")
    gen = SpeculativeGenerator(model, model, n_heads=2, n_layers=2, k=2,
                               max_len=32, compute_dtype=torch.float32,
                               device="cpu")
    with pytest.raises(ValueError, match=r"outside \[0, 64\)"):
        gen.stream(np.array([0, 64], np.int32), 2)
    with pytest.raises(ValueError, match="max_len"):
        gen.stream(np.array([1, 2, 3], np.int32), 30)
    assert gen.generate([1, 2, 3], 0) == []


@pytest.fixture
def engine():
    _, model, _ = _dense_pair("mha")
    gen = SpeculativeGenerator(model, model, n_heads=2, n_layers=2, k=2,
                               max_len=32, compute_dtype=torch.float32,
                               device="cpu")
    return SpeculativeSessionEngine(gen, max_sessions=1)


def test_session_contract(engine):
    """Direct use + close(), context-manager use, admission release on
    both, use-after-close rejection."""
    s = engine.start_session(timeout=5)
    s.prefill([1, 2, 3])
    toks = list(s.stream(4))
    assert len(toks) == 4 and engine.rounds > 0
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.prefill([1])
    with engine.start_session(timeout=5) as s2:
        s2.prefill([1, 2, 3])
        assert list(s2.stream(4)) == toks      # deterministic greedy
    with engine.start_session(timeout=5):
        pass
    with engine.start_session(timeout=5):
        with pytest.raises(TimeoutError):
            engine.start_session(timeout=0.01)


def test_session_completion_accounting(engine):
    """Exhausted and early-closed streams count; errored ones do not."""
    with engine.start_session(timeout=5) as s:
        s.prefill([1, 2, 3])
        assert len(list(s.stream(4))) == 4
    assert engine.completed_requests == 1
    with engine.start_session(timeout=5) as s:
        s.prefill([1, 2, 3])
        it = s.stream(6)
        next(it)
        it.close()
    assert engine.completed_requests == 2
    with engine.start_session(timeout=5) as s:
        s.prefill([1, 2, 3])
        with pytest.raises(ValueError, match="max_len"):
            next(s.stream(30))
    assert engine.completed_requests == 2
    with engine.start_session(timeout=5) as s:
        s.prefill([1, 2, 3])
        with pytest.raises(DeadlineExceeded):
            list(s.stream(4, deadline=Deadline(time.monotonic() - 1)))
    assert engine.completed_requests == 2
