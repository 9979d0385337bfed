"""tpulab_torch ContinuousBatcher vs tpulab's, on the CPU.

The port's batcher (``device="cpu"``: attention through the kernels'
plain versions) and tpulab's serve the same requests on the same weights
(bridged bit for bit), f32 compute, under both dispatch plans:

- ragged: tpulab's ``ContinuousBatcher(use_kernel=False, ragged=True)``
  — the same ragged plan, which tpulab's own tests hold token-exact to
  its kernel path;
- split: the port's ``ragged=False, prefill_flash=True`` against
  tpulab's ``use_kernel=False, prefill_flash=True`` (its legacy split
  dispatch, flash prefill in Pallas interpret mode).

Greedy streams must match.  Where one diverges, the test accepts it only
if tpulab's own top-1 margin at the divergent step is below
``MARGIN_TOL`` (1e-3: a gap the two backends' f32 summation orders, ~1e-5
apart in logits, could close) — and asserts that.  Device-sampled
streams use the same threefry bits (tests/test_torch_prng.py), host
sampling the same numpy stream.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.engine.paged import SamplingParams as JaxSampling
from tpulab.models.transformer import (init_transformer_params,
                                       transformer_apply)
from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
from tpulab_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

VOCAB, D_MODEL, N_HEADS, N_KV, N_LAYERS, D_FF = 64, 32, 4, 2, 2, 64
ROPE = 10000.0
MARGIN_TOL = 1e-3
CFG = dict(n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=N_KV,
           rope_theta=ROPE, lanes=2, max_len=64, page_size=8,
           decode_block=4, prefill_chunk=16, prefix_cache=True)


@pytest.fixture(scope="module")
def lm():
    p = init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                seed=11, n_kv_heads=N_KV, ffn="swiglu",
                                tie_embeddings=False)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                "cpu", n_heads=N_HEADS, n_kv_heads=N_KV,
                                rope_theta=ROPE)


def _prompts():
    rng = np.random.default_rng(0)
    return {n: rng.integers(0, VOCAB, (n,), np.int32) for n in (5, 9, 30)}


def _serve(cb, sampling_cls):
    """Greedy / device-sampled / logprobs / host-sampled / stop-token /
    multi-chunk prefill / prefix-cache-hit requests, one at a time."""
    p = _prompts()
    out = {}
    out["greedy5"] = list(cb.submit(p[5], 12).result(timeout=300))
    out["greedy9"] = list(cb.submit(p[9], 8).result(timeout=300))
    out["device"] = list(cb.submit(p[5], 8, sampling=sampling_cls(
        temperature=0.8, seed=42, device=True)).result(timeout=300))
    toks, lps = cb.submit(p[9], 6, logprobs=True).result(timeout=300)
    out["logprobs"] = (list(toks), list(lps))
    out["host"] = list(cb.submit(p[9], 6, sampling=sampling_cls(
        temperature=0.9, top_k=5, seed=7)).result(timeout=300))
    stop = out["greedy5"][3]
    out["stop"] = list(cb.submit(p[5], 12,
                                 stop_tokens=[stop]).result(timeout=300))
    # 30 tokens with prefill_chunk=16: two mixed rounds; the second
    # submit shares its first three full pages through the prefix cache
    out["chunked"] = list(cb.submit(p[30], 10).result(timeout=300))
    out["cached"] = list(cb.submit(p[30], 10).result(timeout=300))
    return out


@pytest.fixture(scope="module")
def served(lm):
    pj, model = lm
    ref = JaxBatcher(pj, use_kernel=False, ragged=True,
                     compute_dtype=jnp.float32, **CFG)
    try:
        want = _serve(ref, JaxSampling)
    finally:
        ref.shutdown()
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           **CFG)
    try:
        got = _serve(cb, SamplingParams)
        stats = dict(hits=cb.prefix_cache.hits,
                     kinds=dict(cb.dispatch_kinds),
                     prefill_dispatches=cb.prefill_dispatches)
    finally:
        cb.shutdown()
    return want, got, stats


def _margin_at(pj, prompt, toks, i):
    """tpulab's top-1 minus top-2 logit before emitting token i."""
    seq = np.concatenate([prompt, np.asarray(toks[:i], np.int32)])[None]
    logits = np.asarray(transformer_apply(
        pj, {"tokens": jnp.asarray(seq)}, n_heads=N_HEADS,
        n_layers=N_LAYERS, compute_dtype=jnp.float32, n_kv_heads=N_KV,
        rope_theta=ROPE)["logits"])[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _same_greedy(pj, prompt, want, got):
    if got == want:
        return
    i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    margin = _margin_at(pj, prompt, want, i)
    assert margin < MARGIN_TOL, (i, margin, want, got)


@pytest.mark.parametrize("case,prompt_len", [
    ("greedy5", 5), ("greedy9", 9), ("stop", 5), ("chunked", 30),
    ("cached", 30)])
def test_greedy_streams_match_tpulab(lm, served, case, prompt_len):
    want, got, _ = served
    assert len(got[case]) == len(want[case])
    _same_greedy(lm[0], _prompts()[prompt_len], want[case], got[case])


def test_stop_token_ends_the_stream(served):
    _, got, _ = served
    stop = got["greedy5"][3]
    cut = got["greedy5"].index(stop) + 1
    assert got["stop"] == got["greedy5"][:cut]


def test_sampled_streams_match_tpulab(served):
    want, got, _ = served
    assert got["device"] == want["device"]
    assert got["host"] == want["host"]


def test_logprobs_match_tpulab(served):
    """Chosen-token log-probabilities, f32 on both sides (1e-4)."""
    want, got, _ = served
    assert got["logprobs"][0] == want["logprobs"][0]
    np.testing.assert_allclose(got["logprobs"][1], want["logprobs"][1],
                               rtol=1e-4, atol=1e-4)
    assert all(math.isfinite(x) and x <= 0 for x in got["logprobs"][1])


def test_prefix_cache_hit_and_ragged_plan(served):
    _, got, stats = served
    assert got["cached"] == got["chunked"]
    assert stats["hits"] >= 3
    assert stats["prefill_dispatches"] == 0
    assert stats["kinds"]["mixed"] > 0 and stats["kinds"]["decode"] > 0


def test_priority_preemption_resumes_exactly(lm):
    """A higher-priority arrival evicts the only lane; the victim resumes
    by re-prefilling and its greedy stream equals an uninterrupted run
    (and tpulab's)."""
    pj, model = lm
    p = _prompts()
    cfg = dict(CFG, lanes=1, decode_block=2)
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           **cfg)
    try:
        alone = list(cb.submit(p[5], 20).result(timeout=300))
        late = {}

        def arrive(tok, i):            # on the scheduler thread: no race
            if i == 3:
                late["f"] = cb.submit(p[9], 4, priority=5)

        f_low = cb.submit(p[5], 20, priority=0, on_token=arrive)
        low = list(f_low.result(timeout=300))
        high = list(late["f"].result(timeout=300))
        assert cb.preemptions >= 1
    finally:
        cb.shutdown()
    assert low == alone and len(high) == 4
    ref = JaxBatcher(pj, use_kernel=False, ragged=True,
                     compute_dtype=jnp.float32, **cfg)
    try:
        want = list(ref.submit(p[5], 20).result(timeout=300))
    finally:
        ref.shutdown()
    _same_greedy(pj, p[5], want, low)


def test_host_sync_budget_per_request(lm):
    """One blocking fetch per K-token block plus one per mixed round: a
    greedy request's syncs stay within ceil(steps / K) + 1."""
    _, model = lm
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           **dict(CFG, lanes=1, decode_block=8,
                                  prefix_cache=False))
    try:
        p = _prompts()[5]
        cb.submit(p, 17).result(timeout=300)
        s0, d0, t0 = (cb.decode_host_syncs, cb.decode_dispatches,
                      cb.tokens_generated)
        assert len(cb.submit(p, 17).result(timeout=300)) == 17
        syncs = cb.decode_host_syncs - s0
        budget = math.ceil(16 / cb.decode_block) + 1   # + the mixed round
        assert syncs <= budget, (syncs, budget)
        assert cb.decode_dispatches - d0 == syncs
        assert (cb.tokens_generated - t0) == 17 and syncs / 17 < 0.25
    finally:
        cb.shutdown()


def test_cancel_and_deadline(lm):
    from tpulab_torch.core.deadline import DeadlineExceeded
    _, model = lm
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           **dict(CFG, lanes=1))
    try:
        p = _prompts()[5]
        started = threading.Event()
        f1 = cb.submit(p, 50, on_token=lambda t, i: started.set())
        f2 = cb.submit(p, 10)
        cb.cancel(f2)                    # still queued: cancelled at once
        assert f2.cancelled()
        assert started.wait(60)
        cb.cancel(f1)
        with pytest.raises(Exception):
            f1.result(timeout=60)
        f3 = cb.submit(p, 50, deadline=0.0)
        with pytest.raises(DeadlineExceeded):
            f3.result(timeout=60)
        assert cb.active_lanes == 0 and cb.queued_requests == 0
        assert cb.pool.free_pages == cb.pool.n_pages - 1
    finally:
        cb.shutdown()


# -- the split plan --------------------------------------------------------
SPLIT = dict(ragged=False, prefill_flash=True)


@pytest.fixture(scope="module")
def served_split(lm):
    pj, model = lm
    ref = JaxBatcher(pj, use_kernel=False, prefill_flash=True,
                     compute_dtype=jnp.float32, **CFG)
    try:
        want = _serve(ref, JaxSampling)
    finally:
        ref.shutdown()
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           **SPLIT, **CFG)
    try:
        got = _serve(cb, SamplingParams)
        stats = dict(hits=cb.prefix_cache.hits,
                     kinds=dict(cb.dispatch_kinds),
                     prefill_dispatches=cb.prefill_dispatches,
                     prefill_forwards=cb.prefill_forwards,
                     prefill_flash=cb.prefill_flash)
    finally:
        cb.shutdown()
    return want, got, stats


@pytest.mark.parametrize("case,prompt_len", [
    ("greedy5", 5), ("greedy9", 9), ("stop", 5), ("chunked", 30),
    ("cached", 30)])
def test_split_plan_greedy_streams_match_tpulab(lm, served_split, case,
                                                prompt_len):
    want, got, _ = served_split
    assert len(got[case]) == len(want[case])
    _same_greedy(lm[0], _prompts()[prompt_len], want[case], got[case])


def test_split_plan_sampled_streams_and_logprobs_match_tpulab(served_split):
    """Device- and host-sampled streams exact; chosen-token logprobs
    within 1e-4 (the first one comes from the prefill's logits row)."""
    want, got, _ = served_split
    assert got["device"] == want["device"]
    assert got["host"] == want["host"]
    assert got["logprobs"][0] == want["logprobs"][0]
    np.testing.assert_allclose(got["logprobs"][1], want["logprobs"][1],
                               rtol=1e-4, atol=1e-4)


def test_split_plan_prefills_without_mixed_rounds(served_split):
    """Every prompt fills through a prefill dispatch, the short ones as
    one full-prompt forward (flash), the 30-token ones as chunks and
    prefix-cache tails; no mixed round runs."""
    _, got, stats = served_split
    assert stats["prefill_dispatches"] == len(got)
    assert 0 < stats["prefill_forwards"] < stats["prefill_dispatches"]
    assert stats["prefill_flash"] is True
    assert stats["kinds"]["mixed"] == 0 and stats["kinds"]["decode"] > 0
    assert got["cached"] == got["chunked"] and stats["hits"] >= 3


def test_split_and_ragged_plans_agree(lm, served, served_split):
    """On the port, the two plans emit the same streams (tpulab documents
    them token-exact); logprobs within 1e-5."""
    _, ragged, _ = served
    _, split, _ = served_split
    for case, n in (("greedy5", 5), ("greedy9", 9), ("stop", 5),
                    ("chunked", 30), ("cached", 30)):
        _same_greedy(lm[0], _prompts()[n], ragged[case], split[case])
    assert split["device"] == ragged["device"]
    assert split["host"] == ragged["host"]
    assert split["logprobs"][0] == ragged["logprobs"][0]
    np.testing.assert_allclose(split["logprobs"][1], ragged["logprobs"][1],
                               rtol=1e-5, atol=1e-5)


def test_split_plan_preemption_resumes_exactly(lm):
    """A higher-priority arrival evicts the only lane; the victim resumes
    by re-prefilling through the split plan, and its greedy stream equals
    an uninterrupted run (and tpulab's split dispatch)."""
    pj, model = lm
    p = _prompts()
    cfg = dict(CFG, lanes=1, decode_block=2)
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           **SPLIT, **cfg)
    try:
        alone = list(cb.submit(p[5], 20).result(timeout=300))
        d0 = cb.prefill_dispatches
        late = {}

        def arrive(tok, i):            # on the scheduler thread: no race
            if i == 3:
                late["f"] = cb.submit(p[9], 4, priority=5)

        low = list(cb.submit(p[5], 20, on_token=arrive).result(timeout=300))
        high = list(late["f"].result(timeout=300))
        assert cb.preemptions >= 1
        assert cb.prefill_dispatches - d0 == 3   # low, high, low's resume
    finally:
        cb.shutdown()
    assert low == alone and len(high) == 4
    ref = JaxBatcher(pj, use_kernel=False, prefill_flash=True,
                     compute_dtype=jnp.float32, **cfg)
    try:
        want = list(ref.submit(p[5], 20).result(timeout=300))
    finally:
        ref.shutdown()
    _same_greedy(pj, p[5], want, low)


def test_failing_prefill_fails_the_request_and_keeps_flash(lm, monkeypatch):
    """A prefill whose flash attention raises goes to the scheduler's
    recovery path: the request fails, the pool resets, ``prefill_flash``
    stays on (no degrade to dense attention), and the next prompt's
    forward attends through flash again, once per layer."""
    import importlib
    # the module, not the function of the same name tpulab_torch.ops exports
    fa = importlib.import_module("tpulab_torch.ops.flash_attention")
    real = fa.flash_attention
    calls, fault = [0], [True]

    def counted(q, k, v, **kw):
        calls[0] += 1
        if fault[0]:
            raise RuntimeError("planted prefill fault")
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", counted)
    _, model = lm
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           **SPLIT, **dict(CFG, lanes=1, prefix_cache=False))
    try:
        prefill = cb._prefill
        with pytest.raises(RuntimeError, match="planted prefill fault"):
            cb.submit(_prompts()[5], 4).result(timeout=60)
        assert calls[0] == 1
        assert cb.prefill_flash is True and cb._prefill is prefill
        fault[0] = False
        assert len(cb.submit(_prompts()[5], 4).result(timeout=60)) == 4
        assert calls[0] == 1 + N_LAYERS
        assert cb.pool.free_pages == cb.pool.n_pages - 1
    finally:
        cb.shutdown()


def test_dense_prefill_refused_on_cuda(lm):
    """``prefill_flash=False`` would put the split plan's prompt
    attention on plain math on the card: a CUDA batcher refuses it
    before it allocates anything (a stand-in pool names the device)."""
    import types
    with pytest.raises(NotImplementedError, match="prefill_flash=False"):
        ContinuousBatcher(lm[1], n_heads=N_HEADS, n_layers=N_LAYERS,
                          pool=types.SimpleNamespace(
                              device=torch.device("cuda", 0)),
                          ragged=False, prefill_flash=False)


def test_split_plan_defaults(lm):
    """``ragged=False`` alone selects the split plan; ``prefill_flash``
    defaults to the flash kernel on CUDA and to dense attention on the
    CPU (tpulab's default off the TPU)."""
    cb = ContinuousBatcher(lm[1], n_heads=N_HEADS, n_layers=N_LAYERS,
                           n_kv_heads=N_KV, compute_dtype=torch.float32,
                           device="cpu", ragged=False)
    try:
        assert cb.ragged is False and cb.prefill_flash is False
    finally:
        cb.shutdown()


@pytest.mark.parametrize("kw,item", [
    (dict(use_kernel=False), "split dispatch"),
    (dict(hbm=object(), mesh=object()), "HBM economy"),
    (dict(kv_dtype=torch.float8_e5m2), "fp8 KV"),
    (dict(kv_dtype=torch.float16), "float16 KV"),
], ids=["kw0-split dispatch", "kw4-HBM economy", "kw5-fp8 KV",
        "kw7-float16 KV"])
def test_unported_arguments_raise(lm, kw, item):
    _, model = lm
    with pytest.raises(NotImplementedError, match=item):
        ContinuousBatcher(model, n_heads=N_HEADS, n_layers=N_LAYERS,
                          compute_dtype=torch.float32, device="cpu", **kw)


def test_kv_publish_needs_the_host_tier(lm):
    """``kv_publish`` (the fleet KV fabric's owner side) builds over a
    host tier and raises tpulab's ValueError without one."""
    _, model = lm
    kw = dict(n_heads=N_HEADS, n_layers=N_LAYERS,
              compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="kv_publish requires kv_offload"):
        ContinuousBatcher(model, kv_publish=True, **kw)
    cb = ContinuousBatcher(model, kv_offload=True, kv_publish=True, **kw)
    try:
        assert cb.kv_publish and cb.kv_publishes == 0
    finally:
        cb.shutdown()


def test_int8_weights_raise(lm):
    """Weight-only int8 trees no longer raise: the batcher takes them and
    holds the int8 payloads as they are (the streams are held against
    tpulab in tests/test_torch_quantization.py)."""
    from tpulab_torch.models.quantization import quantize_transformer_params

    tree = quantize_transformer_params(lm[1])
    cb = ContinuousBatcher(tree, n_heads=N_HEADS, n_layers=N_LAYERS,
                           n_kv_heads=N_KV, compute_dtype=torch.float32,
                           device="cpu")
    try:
        w1 = cb.params["layer0"]["w1"]
        assert w1["w_int8"].dtype == torch.int8
        assert torch.equal(w1["w_int8"], tree["layer0"]["w1"]["w_int8"])
    finally:
        cb.shutdown()


def test_no_device_means_cuda_or_raise(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(lm[1], n_heads=N_HEADS, n_layers=N_LAYERS)
