"""tpulab_torch.kvcache against tpulab.kvcache, on the CPU.

- the host store's semantics (LRU, budget, copies, ``peek``), as
  tpulab's own store tests state them;
- the snapshot layout: the same pool contents (numpy, from a seed) in a
  tpulab pool and a port pool give the same host payload for the same
  pages (f32 exactly, bf16 by its 16-bit patterns);
- the round trip, the drop / failure split and the transfer engine;
- preempt/resume on both plans, greedy and device-sampled, against
  tpulab's batcher with ``kv_offload`` on the same weights: the same
  tokens (greedy under the repo's margin rule), a restore and no
  re-prefill, pages balanced;
- the spill-backed prefix cache and the ``kvcache.swap`` fault site.

The victim's ``on_token`` callback runs on the scheduler thread and
submits the outranking request itself, so the preemption always lands
while the victim decodes (no race with the victim finishing first).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.engine.paged import PagedKVPool as JaxPool
from tpulab.engine.paged import SamplingParams as JaxSampling
from tpulab.kvcache import KVOffloadManager as JaxManager
from tpulab.models.transformer import (init_transformer_params,
                                       make_generate_fn, transformer_apply)
from tpulab_torch import chaos
from tpulab_torch.cuda.transfer import (TransferEngine, copy_device_to_device,
                                        copy_to_device, copy_to_host)
from tpulab_torch.engine.paged import (ContinuousBatcher, PagedKVPool,
                                       SamplingParams)
from tpulab_torch.kvcache import HostKVStore, KVOffloadManager
from tpulab_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

VOCAB, D_MODEL, N_LAYERS, D_FF, PAGE = 64, 32, 2, 64, 8
MARGIN_TOL = 1e-3
BUDGET = 32 << 20


def _model(n_heads, n_kv, seed):
    pj = init_transformer_params(VOCAB, D_MODEL, n_heads, N_LAYERS, D_FF,
                                 seed=seed, n_kv_heads=n_kv, ffn="swiglu",
                                 tie_embeddings=False)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu",
                              n_heads=n_heads, n_kv_heads=n_kv)
    return pj, model, dict(n_heads=n_heads, n_kv_heads=n_kv)


@pytest.fixture(scope="module")
def lm():
    """2 heads (MHA)."""
    return _model(2, 2, seed=5)


@pytest.fixture(scope="module")
def lm_gqa():
    """4 query heads over 2 KV heads."""
    return _model(4, 2, seed=11)


def _margin_at(pj, heads, prompt, toks, i):
    """tpulab's top-1 minus top-2 logit before emitting token i."""
    seq = np.concatenate([prompt, np.asarray(toks[:i], np.int32)])[None]
    logits = np.asarray(transformer_apply(
        pj, {"tokens": jnp.asarray(seq)}, n_layers=N_LAYERS,
        compute_dtype=jnp.float32, **heads)["logits"])[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _same_tokens(pj, heads, prompt, want, got, greedy=True):
    """Equal, or (greedy) first differing where tpulab's own top-1 margin
    is under MARGIN_TOL: a gap the backends' f32 summation orders could
    close."""
    assert len(got) == len(want)
    if got == want:
        return
    assert greedy, (want, got)
    i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
    assert _margin_at(pj, heads, prompt, want, i) < MARGIN_TOL, (i, want, got)


# -- the host store ------------------------------------------------------------
def _item(n=1024, fill=0.0):
    return torch.full((n,), fill, dtype=torch.float32)      # 4 KiB


def _store_roundtrip():
    store = HostKVStore(1 << 20)
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 4)).astype(np.float32))
    assert store.put("a", a)
    got = store.get("a")
    assert torch.equal(got, a)
    got.add_(1.0)                                 # a copy, never the block
    assert torch.equal(store.get("a"), a)
    assert torch.equal(store.pop("a"), a)
    assert store.get("a") is None
    assert len(store) == 0 and store.bytes_used == 0
    assert store.hits == 3 and store.misses == 1


def _store_budget_lru():
    item = _item()
    store = HostKVStore(3 * 4096)
    for k in "abc":
        assert store.put(k, item)
    store.get("a")                                # "b" is now the coldest
    assert store.put("d", item)
    assert "b" not in store and all(k in store for k in "acd")
    assert store.evictions == 1
    assert not store.put("big", _item(4096))      # larger than the budget
    assert store.drops == 1
    assert store.bytes_used <= store.budget_bytes
    store.clear()
    assert store.headroom_bytes == store.budget_bytes


def _store_peek_no_lru_touch():
    store = HostKVStore(3 * 4096)
    for k in "abc":
        assert store.put(k, _item(fill=ord(k)))
    hits0, misses0 = store.hits, store.misses
    for _ in range(5):
        assert torch.equal(store.peek("a"), _item(fill=ord("a")))
    assert store.peeks == 5
    assert store.hits == hits0 and store.misses == misses0
    assert store.peek("nope") is None and store.peeks == 5
    assert store.put("d", _item())                # "a" stayed the coldest
    assert "a" not in store and all(k in store for k in "bcd")
    store.get("b")                                # get DOES touch
    assert store.put("e", _item())
    assert "c" not in store and "b" in store


def _store_get_survives_eviction():
    item = torch.arange(1024, dtype=torch.float32)
    store = HostKVStore(2 * 4096)
    assert store.put("a", item)
    held = store.get("a")
    assert store.put("b", item + 1) and store.put("c", item + 2)
    assert "a" not in store and store.evictions >= 1
    assert torch.equal(held, item)
    store.clear()


def _store_oversize_put_evicts_nothing():
    store = HostKVStore(3 * 4096)
    for k in "abc":
        assert store.put(k, _item())
    before = store.bytes_used
    assert not store.put("huge", _item(4096))
    assert store.drops == 1 and store.evictions == 0
    assert all(k in store for k in "abc") and store.bytes_used == before


def _store_bf16_payload():
    bits = np.random.default_rng(1).integers(-2**15, 2**15, (4, 8),
                                             dtype=np.int16)
    t = torch.from_numpy(bits).view(torch.bfloat16)
    store = HostKVStore(1 << 20)
    assert store.put("bf", t)
    got = store.pop("bf")
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), bits)


STORE_CASES = {f.__name__[len("_store_"):]: f for f in (
    _store_roundtrip, _store_budget_lru, _store_peek_no_lru_touch,
    _store_get_survives_eviction, _store_oversize_put_evicts_nothing,
    _store_bf16_payload)}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_host_store(case):
    STORE_CASES[case]()


def test_host_store_counts_allocator_bytes():
    store = HostKVStore(1 << 20)
    assert store.put("a", _item()) and store.put("b", _item(512))
    assert store._alloc.bytes_in_use == 4096 + 2048 == store.bytes_used
    store.remove("a")
    assert store._alloc.bytes_in_use == 2048
    store.clear()
    assert store._alloc.bytes_in_use == 0


# -- snapshot layout against tpulab ---------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_layout_matches_tpulab(dtype):
    """The same pool contents and pages give the same host payload (three
    pages: tpulab pads the index to four onto scratch page 0 and strips
    the pad; the port gathers exactly three)."""
    shape = (2, 10, 2, 4, 2, 8)          # (L, P, 2, S, Hkv, D)
    data = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jpool = JaxPool(10, 4, 2, 2, 8, jdt)
    jpool.kv = jnp.asarray(data, jdt)
    tpool = PagedKVPool(10, 4, 2, 2, 8, getattr(torch, dtype), "cpu")
    want_np = np.asarray(jnp.asarray(data, jdt))
    tpool.kv.copy_(torch.from_numpy(data).to(tpool.dtype))
    pages = [7, 2, 5]
    jm, tm = JaxManager(jpool, 8 << 20), KVOffloadManager(tpool, 8 << 20)
    try:
        jh = jm.swap_out(pages, 11, jpool.kv)
        th = tm.swap_out(pages, 11, tpool.kv)
        assert jh.wait(30) and th.wait(30)
        want = np.asarray(jm.store.pop(jh.key))
        got = tm.store.pop(th.key)
    finally:
        jm.close()
        tm.close()
    assert tuple(got.shape) == want.shape == (2, 3, 2, 4, 2, 8)
    if dtype == "float32":
        assert np.array_equal(got.numpy(), want)
    else:
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))
    assert np.array_equal(want, want_np[:, pages])


# -- round trip, drops and failures ----------------------------------------------
def test_swap_round_trip_bit_exact():
    """Pages -> host -> OTHER pages is the identity on the payload, and
    no other page (scratch page 0 included) is written."""
    pool = PagedKVPool(10, 4, 2, 2, 8, torch.float32, "cpu")
    pool.kv.copy_(torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(pool.kv.shape)).astype(np.float32)))
    mgr = KVOffloadManager(pool, 8 << 20)
    try:
        src = [pool.allocate_page() for _ in range(3)]
        snap = pool.kv[:, src].clone()
        h = mgr.swap_out(src, length=12, kv=pool.kv)
        assert h is not None and h.wait(30)
        pool.release_pages(src)
        others = [pool.allocate_page() for _ in range(3)]   # recycled ids
        dst = [pool.allocate_page() for _ in range(3)]
        assert not set(dst) & set(src)
        before = pool.kv.clone()
        assert mgr.restore(h, dst, pool.kv) is pool.kv       # in place
        assert torch.equal(pool.kv[:, dst], snap)
        rest = [p for p in range(10) if p not in dst]
        assert torch.equal(pool.kv[:, rest], before[:, rest])
        assert mgr.swap_outs == mgr.swap_ins == 1
        assert mgr.swap_out_bytes == mgr.swap_in_bytes == 3 * mgr.page_nbytes
        assert mgr.recompute_tokens_saved == 12
        assert len(mgr.store) == 0                            # one-shot pop
        assert mgr.restore(h, dst, pool.kv) is None           # popped
        assert mgr.swap_failures == 1 and mgr.swap_drops == 0
        assert others
    finally:
        mgr.close()


def test_swap_drop_counted_apart_from_failures():
    """A budget-refused snapshot is a swap_DROP; the restore that then
    finds nothing is a swap_failure, and leaves the pool untouched."""
    pool = PagedKVPool(6, 4, 2, 2, 8, torch.float32, "cpu")
    seen = []

    class Observer:
        def observe_swap_out(self, s, n):
            seen.append(("out", n))

        def observe_swap_in(self, s, n):
            seen.append(("in", n))

    mgr = KVOffloadManager(pool, host_budget_bytes=16, metrics=Observer())
    try:
        src = [pool.allocate_page()]
        h = mgr.swap_out(src, length=4, kv=pool.kv)
        assert h is not None and not h.wait(30)
        assert mgr.swap_drops == 1 and mgr.swap_failures == 0
        pool.release_pages(src)
        before = pool.kv.clone()
        assert mgr.restore(h, [pool.allocate_page()], pool.kv) is None
        assert mgr.swap_failures == 1 and torch.equal(pool.kv, before)
        assert seen == [] and mgr.drain(5)
    finally:
        mgr.close()


def test_demote_promote_and_headroom():
    pool = PagedKVPool(6, 4, 2, 2, 8, torch.float32, "cpu")
    pool.kv.normal_()
    mgr = KVOffloadManager(pool, 3 * 2 * 2 * 4 * 2 * 8 * 4)   # three pages
    try:
        assert mgr.headroom_pages() == 3
        page = pool.allocate_page()
        want = pool.kv[:, page].clone()
        mgr.demote(b"d" * 16, page, pool.kv)
        assert mgr.drain(30) and mgr.has_prefix(b"d" * 16)
        assert mgr.demotions == 1 and mgr.headroom_pages() == 2
        assert mgr.demotable_pages([1, 2, 3, 4]) == 2
        pool.kv[:, page] = 0
        assert mgr.promote(b"d" * 16, page, pool.kv) is pool.kv
        assert torch.equal(pool.kv[:, page], want)
        assert mgr.promotions == 1 and not mgr.has_prefix(b"d" * 16)
        assert mgr.promote(b"x" * 16, page, pool.kv) is None     # a miss
    finally:
        mgr.close()


def test_transfer_engine_and_copies_on_cpu():
    eng = TransferEngine(name="t")
    try:
        t = torch.arange(6.0).reshape(2, 3)
        got = eng.fetch(t).result(10)
        assert torch.equal(got, t) and got.data_ptr() != t.data_ptr()
        assert torch.equal(eng.put(t, "cpu").result(10), t)
        assert eng.backlog == 0
    finally:
        eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.fetch(t)
    out = torch.empty(2, 3)
    assert copy_to_host(t, out) is out and torch.equal(out, t)
    assert torch.equal(copy_to_device(t, "cpu"), t)
    assert torch.equal(copy_device_to_device(t, "cpu"), t)


# -- preempt / resume against tpulab's batcher ------------------------------------
P_LOW = np.random.default_rng(21).integers(0, VOCAB, (12,), np.int32)
P_HI = np.random.default_rng(22).integers(0, VOCAB, (5,), np.int32)
STEPS_LOW, STEPS_HI = 12, 4
CFG = dict(n_layers=N_LAYERS, lanes=1, max_len=64, page_size=PAGE,
           decode_block=2)
PLANS = {"ragged": dict(ragged=True), "split": dict(ragged=False)}
JAX_PLANS = {"ragged": dict(use_kernel=False, ragged=True),
             "split": dict(use_kernel=False)}


def _device_sampling(cls):
    return cls(temperature=0.8, seed=1234, device=True)


def _preempted(cb, sampling=None):
    """The victim, preempted at its 4th token by a submit from its own
    on_token (the scheduler thread); returns (low, high) streams."""
    late = {}

    def arrive(tok, i):
        if i == 3 and "f" not in late:
            late["f"] = cb.submit(P_HI, STEPS_HI, priority=10)

    low = cb.submit(P_LOW, STEPS_LOW, on_token=arrive, sampling=sampling)
    low = [int(t) for t in low.result(timeout=300)]
    return low, [int(t) for t in late["f"].result(timeout=300)]


def _serve_preempted(cb, sampling_cls):
    out = {}
    for mode in ("greedy", "device"):
        sp = _device_sampling(sampling_cls) if mode == "device" else None
        out[mode] = _preempted(cb, sp)
    return out


@pytest.fixture(scope="module", params=sorted(PLANS))
def preempt_runs(request, lm):
    plan = request.param
    pj, model, heads = lm
    ref = JaxBatcher(pj, compute_dtype=jnp.float32, kv_offload=BUDGET,
                     **heads, **CFG, **JAX_PLANS[plan])
    try:
        want = _serve_preempted(ref, JaxSampling)
        want_swaps = ref.kv_offload.swap_ins
    finally:
        ref.shutdown()
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           kv_offload=BUDGET, **heads, **CFG, **PLANS[plan])
    try:
        got = _serve_preempted(cb, SamplingParams)
        mgr = cb.kv_offload
        stats = dict(preemptions=cb.preemptions, swap_outs=mgr.swap_outs,
                     swap_ins=mgr.swap_ins, fills=cb.prompt_fills,
                     prefill_dispatches=cb.prefill_dispatches,
                     saved=mgr.recompute_tokens_saved,
                     failures=mgr.swap_failures, drops=mgr.swap_drops,
                     stored=len(mgr.store))
    finally:
        cb.shutdown()
    stats["free"] = cb.pool.free_pages
    stats["n_pages"] = cb.pool.n_pages
    return plan, want, got, stats, want_swaps


@pytest.mark.parametrize("mode", ["greedy", "device"])
def test_preempt_resume_matches_tpulab(lm, preempt_runs, mode):
    pj, _, heads = lm
    _, want, got, _, want_swaps = preempt_runs
    assert want_swaps == 2                     # tpulab restored both runs
    (wl, wh), (gl, gh) = want[mode], got[mode]
    greedy = mode == "greedy"
    _same_tokens(pj, heads, P_LOW, wl, gl, greedy)
    _same_tokens(pj, heads, P_HI, wh, gh, greedy)


def test_preempt_resume_restores_without_reprefill(preempt_runs):
    plan, _, _, st, _ = preempt_runs
    # two runs, one preemption each, both restored from the host tier
    assert st["preemptions"] == st["swap_outs"] == st["swap_ins"] == 2
    assert st["failures"] == st["drops"] == 0 and st["stored"] == 0
    # one prompt fill per request: the resumes ran no prefill
    assert st["fills"] == 4
    assert st["prefill_dispatches"] == (4 if plan == "split" else 0)
    assert st["saved"] >= 2 * (len(P_LOW) + 3)
    assert st["free"] == st["n_pages"] - 1


def test_preempt_resume_gqa_matches_dense(lm_gqa):
    """GQA (4 heads over 2 KV heads), ragged plan: the preempted greedy
    victim equals tpulab's dense generator."""
    pj, model, heads = lm_gqa
    dense = make_generate_fn(pj, n_layers=N_LAYERS, max_len=64,
                             compute_dtype=jnp.float32, **heads)
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           kv_offload=BUDGET, **heads, **CFG)
    try:
        low, high = _preempted(cb)
        assert cb.kv_offload.swap_ins == 1 and cb.prompt_fills == 2
    finally:
        cb.shutdown()
    for p, steps, got in ((P_LOW, STEPS_LOW, low), (P_HI, STEPS_HI, high)):
        want = [int(t) for t in np.asarray(dense(p[None], steps)[0])]
        _same_tokens(pj, heads, p, want, got)
    assert cb.pool.free_pages == cb.pool.n_pages - 1


def test_queued_snapshot_dropped_on_cancel(lm):
    """A preempted request cancelled while queued frees its snapshot."""
    _, model, heads = lm
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           kv_offload=BUDGET, **heads, **CFG)
    try:
        release, queued, state = threading.Event(), threading.Event(), {}

        def arrive(tok, i):
            if i == 3 and "hi" not in state:
                state["hi"] = cb.submit(P_HI, 40, priority=10,
                                        on_token=hold)

        def hold(tok, i):       # the victim waits in the queue meanwhile
            if i == 0:
                queued.set()
                release.wait(60)

        low = cb.submit(P_LOW, STEPS_LOW, on_token=arrive)
        assert queued.wait(60)
        assert cb.kv_offload.drain(30) and len(cb.kv_offload.store) == 1
        cb.cancel(low)
        assert len(cb.kv_offload.store) == 0 and low.cancelled()
        release.set()
        assert len(state["hi"].result(timeout=300)) == 40
    finally:
        release.set()
        cb.shutdown()
    assert cb.pool.free_pages == cb.pool.n_pages - 1


# -- spill-backed prefix cache ------------------------------------------------------
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_demoted_prefix_promoted_on_lookup(lm, plan):
    pj, model, heads = lm
    prompt = np.random.default_rng(5).integers(0, VOCAB, (20,), np.int32)
    dense = make_generate_fn(pj, n_layers=N_LAYERS, max_len=64,
                             compute_dtype=jnp.float32, **heads)
    want = [int(t) for t in np.asarray(dense(prompt[None], 5)[0])]
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           prefix_cache=True, kv_offload=BUDGET, **heads,
                           **CFG, **PLANS[plan])
    try:
        got1 = [int(t) for t in cb.submit(prompt, 5).result(timeout=300)]
        pc, mgr = cb.prefix_cache, cb.kv_offload
        assert len(pc) == 2                      # two full prompt pages
        while pc.evict_for_alloc():              # the pressure path
            pass
        assert mgr.drain(30) and mgr.demotions == 2
        got2 = [int(t) for t in cb.submit(prompt, 5).result(timeout=300)]
        assert mgr.promotions == 2 and pc.host_promotions == 2
        assert pc.hits >= 2
    finally:
        cb.shutdown()
    _same_tokens(pj, heads, prompt, want, got1)
    assert got2 == got1
    assert cb.pool.free_pages == cb.pool.n_pages - 1


# -- the kvcache.swap fault site -------------------------------------------------------
@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("spec", ["kvcache.swap=error+1",      # swap-out
                                  "kvcache.swap=drop@1+1"])    # swap-in
def test_chaos_swap_degrades_to_reprefill(lm, plan, spec):
    """A tripped swap falls back to the exact re-prefill: tokens equal the
    unpreempted stream, the failure is counted, nothing is restored."""
    _, model, heads = lm
    cb = ContinuousBatcher(model, compute_dtype=torch.float32, device="cpu",
                           kv_offload=BUDGET, **heads, **CFG, **PLANS[plan])
    try:
        alone = [int(t) for t in
                 cb.submit(P_LOW, STEPS_LOW).result(timeout=300)]
        fills = cb.prompt_fills
        with chaos.inject(spec) as sched:
            low, high = _preempted(cb)
            assert sched.fired("kvcache.swap") == 1
        mgr = cb.kv_offload
        assert cb.preemptions == 1 and mgr.swap_failures == 1
        assert mgr.swap_ins == 0 and len(mgr.store) == 0
        assert cb.prompt_fills - fills == 3        # low, high, the resume
    finally:
        cb.shutdown()
    assert low == alone and len(high) == STEPS_HI
    assert cb.pool.free_pages == cb.pool.n_pages - 1


def test_kv_offload_options(lm):
    """True = the default budget; an int = budget bytes; a manager = bring
    your own (not closed by the batcher); kv_publish still raises."""
    _, model, heads = lm
    kw = dict(compute_dtype=torch.float32, device="cpu", **heads, **CFG)
    from tpulab_torch.kvcache import DEFAULT_HOST_BUDGET
    for opt, budget in ((True, DEFAULT_HOST_BUDGET), (12345, 12345)):
        cb = ContinuousBatcher(model, kv_offload=opt, **kw)
        assert cb.kv_offload.store.budget_bytes == budget
        cb.shutdown()
    cb = ContinuousBatcher(model, kv_offload=False, **kw)
    assert cb.kv_offload is None
    with pytest.raises(ValueError, match="kv_offload"):
        cb.submit(P_LOW, 2, export_digest=b"x")
    cb.shutdown()
    pool = PagedKVPool(9, PAGE, N_LAYERS, 2, D_MODEL // 2, torch.float32,
                       "cpu")
    mgr = KVOffloadManager(pool, BUDGET)
    cb = ContinuousBatcher(model, pool=pool, kv_offload=mgr, **kw)
    assert cb.kv_offload is mgr
    cb.shutdown()
    assert mgr.store.budget_bytes == BUDGET and mgr._transfer._thread.is_alive()
    mgr.close()
    with pytest.raises(NotImplementedError, match="fabric"):
        ContinuousBatcher(model, kv_publish=True, **kw)
