"""tpulab_torch.hbm against tpulab.hbm, on the CPU.

The same operation sequences run through both packages and their state is
compared exactly (byte counts and counters are integers):

- the ledger's claims, resize, release, headroom and ``verify``;
- the arbiter with scripted tenants: grants, pressure rounds, forced
  demotions and evictions, denials (the no-livelock bound included),
  probes, and the ``hbm.pressure`` fault site;
- the elastic pool's grow / shrink and ``prefer_low_pages``;
- the batcher as the KV tenant under an arbiter, on tpulab's two traces
  (``tests/test_hbm.py``): a model acquire demotes a live-but-idle lane
  whose stream then resumes from the host tier, and a KV burst evicts a
  cold model that swaps back bit-exact.  Greedy tokens equal tpulab's
  (f32, under the repo's margin rule: first differing only where tpulab's
  own top-1 margin is under ``MARGIN_TOL`` = 1e-3) and the port's own
  no-arbiter run exactly; after ``drain()`` the ledger's claims equal
  tpulab's tenant by tenant (scratch excluded: ``measure_scratch=False``
  on both sides, as tpulab's tests run); the pool's size and tracked
  bytes after each grow and shrink equal tpulab's.  The model is 4
  layers at d_model 64, so a slip along the store's layer axis shows;
- ``chip_smoke.py``'s ``PageBytesCheck`` (the card phase's exact KV
  check) on direction 1, and that it catches a broken restore or grow.

Per-program scratch measuring records 0 bytes on the CPU (no allocator
statistics), so it is checked by its keys here and by ``chip_smoke.py``'s
"hbm" phase on the card.  One ``cuda`` test grows and shrinks a pool on
the card (``python -m pytest --noconftest -m cuda tests/test_torch_hbm.py``
on the card's machine).
"""

import threading
import time

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax
    import jax.numpy as jnp

    from tpulab import chaos as jchaos
    from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
    from tpulab.engine.paged import PagedKVPool as JaxPool
    from tpulab.hbm import DeviceHBMLedger as JaxLedger
    from tpulab.hbm import HBMArbiter as JaxArbiter
    from tpulab.models.transformer import (init_transformer_params,
                                           transformer_apply)
    from tpulab.modelstore import WeightMultiplexer as JaxMux
except ImportError:
    jax = None
from tpulab_torch import chaos
from tpulab_torch.engine.paged import ContinuousBatcher, PagedKVPool
from tpulab_torch.hbm import (KV_TENANT, SCRATCH_TENANT, WEIGHTS_TENANT,
                              DeviceHBMLedger, HBMArbiter, MeasuredJit,
                              ScratchGroup)
from tpulab_torch.models.convert import params_from_numpy
from tpulab_torch.modelstore import WeightMultiplexer

torch.set_num_threads(2)

#: the batcher traces' model: 4 layers, d_model 64, two heads, f32
LAYERS, D_MODEL = 4, 64
#: one page of that model's pool (page_size=8, n_kv=2, head_dim=32, f32):
#: every sizing of the batcher traces is phrased in pages of this
PN = LAYERS * 2 * 8 * 2 * (D_MODEL // 2) * 4
MARGIN_TOL = 1e-3
HEADS = dict(n_heads=2, n_kv_heads=2)
needs_ref = pytest.mark.skipif(jax is None, reason="needs tpulab (JAX)")


# -- the ledger ---------------------------------------------------------------
def _ledger_trace(cls):
    out = []
    led = cls(1000)
    led.claim("kv", "pool", 600)
    try:
        led.claim("kv", "pool", 1)            # a double claim is the bug
    except ValueError:
        out.append("double-claim refused")
    led.claim("weights", "m1", 300)
    out.append((led.total_claimed, led.headroom_bytes,
                led.tenant_bytes("kv"), led.tenant_claims("kv")))
    led.resize("kv", "pool", 500)             # the elastic pool shrank
    out.append(led.headroom_bytes)
    out.append((led.release("weights", "m1"), led.release("weights", "m1")))
    out.append((led.verify({"kv": 500}), led.verify({"kv": 499})))
    led.claim("scratch", ("jit", 0), 700)     # honest over-commit
    led.resize("kv", "grow", 0)               # a zero resize is no claim
    out.append((led.headroom_bytes, sorted(led.claims(), key=repr),
                led.tenants()))
    for bad in (lambda: led.claim("x", 1, -1), lambda: led.resize("x", 1, -1),
                lambda: cls(0)):
        try:
            bad()
        except ValueError:
            out.append("refused")
    return out


@needs_ref
def test_ledger_matches_tpulab():
    want, got = _ledger_trace(JaxLedger), _ledger_trace(DeviceHBMLedger)
    assert got == want
    assert got[-4][0] == -200


def test_ledger_invariant_against_tracked_allocators():
    """After every arbiter operation the per-tenant claims sum exactly to
    the tracked device allocator backing each tenant (tpulab's
    acceptance invariant), through claim, request with pressure, denial
    and release."""
    from tpulab_torch.cuda.allocators import DeviceRawAllocator
    akv, aw = DeviceRawAllocator("cpu"), DeviceRawAllocator("cpu")
    arb = HBMArbiter(64 * 1024, measure_scratch=False)
    state = {}

    def kv_reclaim(nbytes):
        addr, size = state["kv"]
        akv.deallocate_node(addr)
        new = size // 2
        addr2, _ = akv.allocate_array((new,), torch.uint8)
        state["kv"] = (addr2, new)
        arb.mirror_claim("kv", "pool", akv.bytes_in_use)
        return size - new

    arb.register("kv", reclaim=kv_reclaim, gauge=lambda: akv.bytes_in_use)
    arb.register("weights", gauge=lambda: aw.bytes_in_use)

    def check():
        assert arb.verify() == {}
        assert (arb.ledger.total_claimed
                == akv.bytes_in_use + aw.bytes_in_use)

    addr, _ = akv.allocate_array((48 * 1024,), torch.uint8)
    state["kv"] = (addr, 48 * 1024)
    arb.claim("kv", "pool", akv.bytes_in_use)
    check()
    assert arb.request("weights", "m1", 8 * 1024, timeout=1.0)
    aw.allocate_array((8 * 1024,), torch.uint8)
    check()
    assert arb.request("weights", "m2", 16 * 1024, timeout=5.0)
    aw.allocate_array((16 * 1024,), torch.uint8)
    check()
    assert arb.demotions_forced >= 1
    assert not arb.request("weights", "m3", 64 * 1024, timeout=0.5)
    assert arb.denials == 1
    assert arb.ledger.tenant_claims("weights") == 2
    check()
    for a_addr in list(aw._buffers):
        aw.deallocate_node(a_addr)
    arb.release("weights", "m1")
    arb.release("weights", "m2")
    check()


# -- the arbiter with scripted tenants ---------------------------------------
class _Tenant:
    """A tenant holding ``held`` bytes that frees up to ``can_free`` on a
    reclaim, synchronously (its claim shrinks before the hook returns)."""

    def __init__(self, arb, name, held, can_free):
        self.arb, self.name = arb, name
        self.held, self.can_free = held, can_free
        arb.register(name, reclaim=self.reclaim,
                     reclaimable=lambda: self.can_free,
                     gauge=lambda: self.held)
        arb.mirror_claim(name, "pool", held)

    def reclaim(self, nbytes):
        got = min(int(nbytes), self.can_free)
        self.can_free -= got
        self.held -= got
        self.arb.mirror_claim(self.name, "pool", self.held)
        return got


CASES = {
    # (capacity, {tenant: (held, can_free)}, requester, bytes, probe)
    "grant": (1000, {"kv": (400, 0)}, "weights", 500, False),
    "demote_kv": (1000, {"kv": (800, 600)}, "weights", 500, False),
    "evict_model": (1000, {"weights": (900, 900)}, "kv", 700, False),
    "both_press": (1000, {"kv": (500, 100), "weights": (500, 500)},
                   "scratch", 400, False),
    "no_livelock": (1024, {"kv": (1024, 0)}, "weights", 512, False),
    "probe_barren": (1000, {"kv": (900, 0)}, "weights", 500, True),
    "probe_grant": (1000, {"kv": (900, 900)}, "weights", 500, True),
    "unfillable": (1000, {"kv": (600, 200)}, "weights", 900, False),
}


def _arbiter_trace(arb_cls, ch, case, chaos_spec=None):
    cap, tenants, who, nbytes, probe = CASES[case]
    arb = arb_cls(cap, measure_scratch=False)
    ts = {n: _Tenant(arb, n, h, f) for n, (h, f) in tenants.items()}
    before = (arb.free_hbm_bytes, arb.reclaimable_bytes(exclude=who))
    t0 = time.monotonic()
    if chaos_spec:
        with ch.inject(chaos_spec) as sched:
            ok = arb.request(who, "x", nbytes, timeout=30.0, probe=probe)
        fired = sched.fired("hbm.pressure")
    else:
        ok = arb.request(who, "x", nbytes, timeout=30.0, probe=probe)
        fired = None
    took = time.monotonic() - t0
    return dict(
        ok=ok, fired=fired, before=before, fast=took < 5.0,
        counters=(arb.grants, arb.pressure_events, arb.demotions_forced,
                  arb.evictions_forced, arb.denials,
                  dict(arb.reclaims_by_tenant)),
        claims=sorted(arb.ledger.claims(), key=repr),
        free=arb.free_hbm_bytes, verify=arb.verify(),
        held={n: t.held for n, t in ts.items()},
        reservations=arb.reservations())


@needs_ref
@pytest.mark.parametrize("case", sorted(CASES))
def test_arbiter_matches_tpulab(case):
    want = _arbiter_trace(JaxArbiter, jchaos, case)
    got = _arbiter_trace(HBMArbiter, chaos, case)
    assert got == want
    assert got["verify"] == {} and got["reservations"] == [] and got["fast"]
    expect_ok = case not in ("no_livelock", "probe_barren", "unfillable")
    assert got["ok"] is expect_ok
    if case == "no_livelock":
        # two barren rounds, then the denial: never the 30 s timeout
        assert got["counters"][1:5] == (2, 0, 0, 1)
        assert got["claims"] == [("kv", "pool", 1024)]
    if case == "probe_barren":
        assert got["counters"][4] == 0        # a probe is not a denial


@needs_ref
@pytest.mark.chaos
@pytest.mark.parametrize("action", ["error", "drop"])
def test_chaos_pressure_matches_tpulab(action):
    """``hbm.pressure`` suppresses every press and trips at the denial:
    the request degrades to a denial, the ledger is untouched, and the
    counters and trips equal tpulab's."""
    spec = f"hbm.pressure={action}"
    want = _arbiter_trace(JaxArbiter, jchaos, "demote_kv", spec)
    got = _arbiter_trace(HBMArbiter, chaos, "demote_kv", spec)
    assert got == want
    assert got["ok"] is False and got["held"] == {"kv": 800}
    assert got["fired"] >= 3                  # two presses + the denial


def test_arbiter_reservation_holds_freed_bytes_for_the_waiter():
    """Bytes freed under pressure are reserved for the blocked requester:
    another tenant's claim cannot take them while the reclaim lands."""
    arb = HBMArbiter(1000, measure_scratch=False)
    landed = threading.Event()

    def slow_reclaim(nbytes):
        def land():
            time.sleep(0.05)
            arb.mirror_claim("kv", "pool", 200)
            landed.set()
        threading.Thread(target=land, daemon=True).start()
        return 600

    arb.register("kv", reclaim=slow_reclaim, gauge=lambda: 0)
    arb.mirror_claim("kv", "pool", 800)
    res = {}
    t = threading.Thread(target=lambda: res.setdefault(
        "ok", arb.request("weights", "m", 700, timeout=10)))
    t.start()
    assert landed.wait(10)
    # the freed bytes are spoken for: a third tenant's request is refused
    # while the waiter's reservation stands
    thief = arb.request("scratch", "s", 300, timeout=0.0, probe=True)
    t.join(10)
    assert res["ok"] and not thief
    assert arb.ledger.tenant_bytes("weights") == 700
    assert arb.reservations() == []


# -- the elastic pool ---------------------------------------------------------
def _pool_trace(pool_cls, dtype):
    pool = pool_cls(4, 8, 1, 2, 16, dtype, "cpu") if pool_cls is PagedKVPool \
        else pool_cls(4, 8, 1, 2, 16, dtype)
    pool.prefer_low_pages = True
    out = [pool.hbm_bytes, pool.page_nbytes]
    a, b = pool.allocate_page(), pool.allocate_page()
    out += [(a, b), pool.shrinkable_pages(), pool.grow(4), pool.n_pages,
            pool.hbm_bytes, pool.free_pages, pool.shrink(8), pool.n_pages,
            pool.hbm_bytes, pool.refcount(a), pool.shrink(8)]
    pool.release_pages([a, b])
    out += [pool.shrink(8), pool.n_pages, pool.free_pages]
    pool.close()
    out.append(pool.hbm_bytes)
    return out


@needs_ref
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_grow_shrink_matches_tpulab(dtype):
    want = _pool_trace(JaxPool, getattr(jnp, dtype))
    got = _pool_trace(PagedKVPool, getattr(torch, dtype))
    assert got == want
    assert got[2:4] == [(1, 2), 1]


def test_pool_grow_keeps_pages_and_zeroes_new_ones():
    """Grow keeps every live page's bytes (e4m3 included) and appends
    zeroed pages; shrink keeps the bottom."""
    for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
        pool = PagedKVPool(4, 8, 2, 2, 16, dt, "cpu")
        raw = pool.kv.view(torch.uint8)
        raw.copy_(torch.randint(0, 120, raw.shape, dtype=torch.uint8))
        before = pool.kv.view(torch.uint8).clone()
        assert pool.grow(4) == 4 and pool.n_pages == 8
        after = pool.kv.view(torch.uint8)
        assert torch.equal(after[:, :4], before)
        assert not after[:, 4:].any()
        assert pool.hbm_bytes == pool._alloc.node_size(pool._kv_addr)
        assert pool.shrink(6) == 6 and pool.n_pages == 2
        assert torch.equal(pool.kv.view(torch.uint8)[:, :pool.n_pages],
                           before[:, :pool.n_pages])
        pool.close()


# -- the batcher as the KV tenant: tpulab's traces -------------------------
@pytest.fixture(scope="module")
def lm():
    pj = init_transformer_params(vocab=64, d_model=D_MODEL, n_heads=2,
                                 n_layers=LAYERS, d_ff=2 * D_MODEL)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu",
                              **HEADS)
    return pj, model


def _margin_at(pj, prompt, toks, i):
    seq = np.concatenate([prompt, np.asarray(toks[:i], np.int32)])[None]
    logits = np.asarray(transformer_apply(
        pj, {"tokens": jnp.asarray(seq)}, n_layers=LAYERS,
        compute_dtype=jnp.float32, **HEADS)["logits"])[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _same_tokens(pj, prompt, want, got):
    """Equal, or first differing where tpulab's own top-1 margin is under
    MARGIN_TOL (a gap the backends' f32 summation orders could close)."""
    assert len(got) == len(want)
    if got != want:
        i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
        assert _margin_at(pj, prompt, want, i) < MARGIN_TOL, (i, want, got)


class _Servable:
    """Byte-sized dense servable: ``words`` f32 weights 0, 1, 2, ..."""

    def __init__(self, words, resident, jax_side):
        self._words, self._jax = words, jax_side
        self.device_params = self.rebuild() if resident else None

    def rebuild(self):
        if self._jax:
            return {"w": jnp.arange(self._words, dtype=jnp.float32)}
        return {"w": torch.arange(self._words, dtype=torch.float32)}

    def resident(self):
        return self.device_params is not None

    def param_bytes(self):
        return self._words * 4

    def busy(self):
        return False

    def detach(self):
        dev, self.device_params = self.device_params, None
        return dev

    def on_detached(self):
        pass

    def attach(self, host_tree):
        self.device_params = (jax.device_put(host_tree) if self._jax
                              else {"w": host_tree["w"].clone()})

    def out(self):
        w = self.device_params["w"]
        return float(np.asarray((w * 3.0).sum()))


def _side(jax_side, lm):
    pj, model = lm
    if jax_side:
        return (JaxBatcher, JaxArbiter, JaxMux, pj,
                dict(compute_dtype=jnp.float32, use_kernel=False,
                     ragged=True))
    return (ContinuousBatcher, HBMArbiter, WeightMultiplexer, model,
            dict(compute_dtype=torch.float32, device="cpu"))


def _record_resizes(pool):
    """The pool's (op, n_pages, hbm_bytes) after every grow and shrink."""
    seq = []
    for name in ("grow", "shrink"):
        fn = getattr(pool, name)

        def wrapped(n, fn=fn, name=name):
            k = fn(n)
            if k:
                seq.append((name, pool.n_pages, pool.hbm_bytes))
            return k
        setattr(pool, name, wrapped)
    return seq


def _reference_tokens(lm, jax_side, prompts, steps, lanes, max_len, n_pages):
    batcher, _, _, params, kw = _side(jax_side, lm)
    cb = batcher(params, n_layers=LAYERS, lanes=lanes, max_len=max_len,
                 page_size=8, n_pages=n_pages, **HEADS, **kw)
    try:
        return [[int(t) for t in cb.submit(p, steps).result(timeout=120)]
                for p in prompts]
    finally:
        cb.shutdown()


def _acquire_trace(lm, jax_side, prepare=None):
    """tpulab's direction 1 (``tests/test_hbm.py:187``), gated instead of
    timed: the stream's 4th token holds the scheduler until the model's
    acquire has pressed the KV tenant, so the squeeze always catches the
    lane live between ticks.  ``prepare(cb)`` runs on the new batcher
    before the trace."""
    batcher, arb_cls, mux_cls, params, kw = _side(jax_side, lm)
    prompt = np.arange(4, 12, dtype=np.int32)
    steps = 48                                # outgrows the 5-page base
    b = _Servable(12 * PN // 4, False, jax_side)
    arb = arb_cls(13 * PN, measure_scratch=False)
    cb = batcher(params, n_layers=LAYERS, lanes=1, max_len=56, page_size=8,
                 n_pages=5, kv_offload=True, hbm=arb, decode_block=1,
                 **HEADS, **kw)
    resizes = _record_resizes(cb.pool)
    if prepare is not None:
        prepare(cb)
    mux = mux_cls(b.param_bytes(), hbm=arb)
    mux.register("b", b, params=b.rebuild())
    try:
        decoding, toks = threading.Event(), []

        def on_tok(t, i):
            toks.append(t)
            if i == 3:
                decoding.set()
                end = time.monotonic() + 30
                while (not cb._hbm_reclaim_bytes
                       and time.monotonic() < end):
                    time.sleep(0.001)

        fut = cb.submit(prompt, steps, on_token=on_tok)
        assert decoding.wait(60)
        grown = cb.pool.n_pages
        lease = mux.acquire("b", timeout=60)  # squeezes the KV tenant
        mid = dict(state=mux.state_of("b"), n_pages=cb.pool.n_pages,
                   demotions=cb.hbm_demotions, verify=arb.verify())
        lease.release()
        got = [int(t) for t in fut.result(timeout=120)]
        assert mux.drain()
        cb.kv_offload.drain()
        st = dict(grown=grown, mid=mid, resizes=resizes,
                  swaps=cb.kv_offload.swap_outs,
                  grows=cb.hbm_grows, shrinks=cb.hbm_shrinks,
                  demotions=cb.hbm_demotions, evictions=mux.evictions,
                  swap_ins=mux.swap_ins, fills=getattr(cb, "prompt_fills",
                                                        None),
                  kv=arb.ledger.tenant_bytes(KV_TENANT),
                  weights=arb.ledger.tenant_bytes(WEIGHTS_TENANT),
                  verify=arb.verify(), state=mux.state_of("b"))
        return prompt, got, toks, st
    finally:
        cb.shutdown()
        mux.close()


@needs_ref
def test_model_acquire_demotes_live_idle_kv_matches_tpulab(lm):
    """Direction 1: the acquire demotes the live lane to the host tier
    and shrinks the pool; the lease released, the pool regrows (evicting
    the model) and the resumed stream is exact."""
    pj, _ = lm
    prompt, want, _, wst = _acquire_trace(lm, True)
    _, got, streamed, st = _acquire_trace(lm, False)
    ref = _reference_tokens(lm, False, [prompt], 48, 1, 56, 12)[0]
    assert got == ref == streamed             # exact within the port
    _same_tokens(pj, prompt, want, got)
    assert st["mid"]["state"] == "hot" and st["mid"]["verify"] == {}
    assert st["mid"]["n_pages"] < st["grown"] and st["grown"] > 5
    assert st["mid"]["demotions"] >= 1 and st["swaps"] >= 1
    assert st["evictions"] >= 1 and st["verify"] == {}
    assert st["fills"] == 1                   # resumed with no re-prefill
    for k in ("grown", "resizes", "grows", "shrinks", "demotions",
              "evictions", "swap_ins", "swaps", "kv", "weights", "state",
              "mid"):
        assert st[k] == wst[k], k


def _burst_trace(lm, jax_side):
    """tpulab's direction 2 (``tests/test_hbm.py:249``)."""
    batcher, arb_cls, mux_cls, params, kw = _side(jax_side, lm)
    b = _Servable(4 * PN // 4, True, jax_side)
    ref_out = b.out()
    arb = arb_cls(8 * PN + PN // 2, measure_scratch=False)
    cb = batcher(params, n_layers=LAYERS, lanes=2, max_len=24, page_size=8,
                 n_pages=4, kv_offload=True, hbm=arb, **HEADS, **kw)
    resizes = _record_resizes(cb.pool)
    mux = mux_cls(b.param_bytes(), hbm=arb)
    mux.register("b", b)
    try:
        futs = [cb.submit(p, 16) for p in BURST]
        got = [[int(t) for t in f.result(timeout=120)] for f in futs]
        assert mux.drain()
        after_burst = dict(
            state=mux.state_of("b"), host=mux.host_models(),
            n_pages=cb.pool.n_pages, grows=cb.hbm_grows,
            evictions=mux.evictions, forced=arb.evictions_forced,
            kv=arb.ledger.tenant_bytes(KV_TENANT),
            weights=arb.ledger.tenant_bytes(WEIGHTS_TENANT),
            verify=arb.verify())
        lease = mux.acquire("b", timeout=60)  # squeeze KV, promote B
        try:
            out = b.out()
            mid = dict(swap_ins=mux.swap_ins, rebuilds=mux.cold_rebuilds,
                       verify=arb.verify(), n_pages=cb.pool.n_pages)
        finally:
            lease.release()
        return got, out == ref_out, after_burst, mid, resizes
    finally:
        cb.shutdown()
        mux.close()


BURST = [np.arange(8, dtype=np.int32) % 64,
         (np.arange(8, dtype=np.int32) * 5) % 64]


@needs_ref
def test_kv_burst_evicts_cold_model_matches_tpulab(lm):
    """Direction 2: the burst grows the pool by evicting the cold model
    (write-behind) to the host tier; the model's next acquire squeezes KV
    back and is served the promoted bytes, bit-exact."""
    pj, _ = lm
    want = _burst_trace(lm, True)
    got = _burst_trace(lm, False)
    ref = _reference_tokens(lm, False, BURST, 16, 2, 24, 8)
    assert got[0] == ref                      # exact within the port
    for p, w, g in zip(BURST, want[0], got[0]):
        _same_tokens(pj, p, w, g)
    assert got[1] and want[1]                 # weights bit-exact after
    assert got[2:] == want[2:]                # states, bytes, resizes
    ab, mid, resizes = got[2:]
    assert ab["state"] == "cold" and ab["host"] == ["b"]
    assert ab["evictions"] >= 1 and ab["forced"] >= 1 and ab["grows"] >= 1
    assert ab["verify"] == {} and mid["verify"] == {}
    assert mid["swap_ins"] == 1 and mid["rebuilds"] == 0
    assert resizes == [("grow", 8, 8 * PN), ("shrink", 4, 4 * PN)]


def test_leased_and_pinned_models_never_victimized(lm):
    """A KV burst cannot evict a leased (or pinned) model: the grow
    probes find nothing reclaimable and the burst queues on its pool."""
    _, model = lm
    b = _Servable(4 * PN // 4, True, False)
    arb = HBMArbiter(8 * PN + PN // 2, measure_scratch=False)
    cb = ContinuousBatcher(model, n_layers=LAYERS, lanes=2, max_len=24,
                           page_size=8, n_pages=4, kv_offload=True, hbm=arb,
                           compute_dtype=torch.float32, device="cpu",
                           **HEADS)
    mux = WeightMultiplexer(b.param_bytes(), hbm=arb)
    mux.register("b", b)
    try:
        with mux.acquire("b", timeout=10):
            futs = [cb.submit((np.arange(8) * (i + 1) % 64).astype(
                np.int32), 12) for i in range(2)]
            for f in futs:
                f.result(timeout=120)
            assert mux.evictions == 0 and mux.state_of("b") == "hot"
            assert b.device_params is not None and cb.pool.n_pages == 4
        mux.pin("b")
        cb.submit(np.arange(8, dtype=np.int32), 12).result(timeout=120)
        assert mux.evictions == 0 and mux.state_of("b") == "hot"
        assert arb.verify() == {}
    finally:
        cb.shutdown()
        mux.close()


def _chaos_static_trace(lm, jax_side, action):
    batcher, arb_cls, mux_cls, params, kw = _side(jax_side, lm)
    ch = jchaos if jax_side else chaos
    b = _Servable(4 * PN // 4, False, jax_side)
    arb = arb_cls(5 * PN, measure_scratch=False)
    cb = batcher(params, n_layers=LAYERS, lanes=1, max_len=24, page_size=8,
                 n_pages=4, kv_offload=True, hbm=arb, **HEADS, **kw)
    mux = mux_cls(b.param_bytes(), hbm=arb)
    mux.register("b", b, params=b.rebuild())
    try:
        with ch.inject(f"hbm.pressure={action}") as sched:
            mux.acquire("b", timeout=20).release()
        return dict(fired=sched.fired("hbm.pressure") >= 1,
                    state=mux.state_of("b"), n_pages=cb.pool.n_pages,
                    shrinks=cb.hbm_shrinks, demotions=cb.hbm_demotions,
                    denials=arb.denials >= 1, verify=arb.verify(),
                    free=arb.free_hbm_bytes)
    finally:
        cb.shutdown()
        mux.close()


@needs_ref
@pytest.mark.chaos
@pytest.mark.parametrize("action", ["error", "drop"])
def test_chaos_pressure_degrades_to_static_budget(lm, action):
    """Chaos at the decision sites: the acquire falls back to the
    multiplexer's own budget, the pool is never squeezed, and the ledger
    mirrors the over-committed truth exactly, as in tpulab."""
    want = _chaos_static_trace(lm, True, action)
    got = _chaos_static_trace(lm, False, action)
    assert got == want
    assert got["fired"] and got["denials"] and got["state"] == "hot"
    assert got["n_pages"] == 4 and got["shrinks"] == got["demotions"] == 0
    assert got["verify"] == {} and got["free"] < 0


def _page_bytes_check(mutate):
    """A ``prepare`` hook for :func:`_acquire_trace` that installs
    ``chip_smoke.py``'s ``PageBytesCheck`` on the port's batcher (appended
    to the returned list); ``mutate`` first breaks the host tier's
    restore (the layer axis flipped) or the pool's grow (one layer's
    pages moved)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    checks = []

    def prepare(cb):
        if mutate == "restore":
            scatter = cb.kv_offload._scatter
            cb.kv_offload._scatter = lambda pages, data, kv: scatter(
                pages, data.flip(0), kv)
        elif mutate == "grow":
            grow = cb.pool.grow

            def moved(n):
                k = grow(n)
                cb.pool.kv[1:, 1:3] = cb.pool.kv[:-1, 1:3].clone()
                return k
            cb.pool.grow = moved
        checks.append(smoke.PageBytesCheck(torch, cb))
    return prepare, checks


@pytest.mark.parametrize("mutate", [None, "restore", "grow"])
def test_page_bytes_check_holds_kv_across_elastic_moves(lm, mutate):
    """The "hbm" phase's exact KV check: a demoted lane's pages after its
    host-tier restore, and every page in use across a grow or shrink,
    equal their bytes before, byte for byte; a restore that flips the
    layer axis, or a grow that moves one layer's pages, shows."""
    prepare, checks = _page_bytes_check(mutate)
    _, _, _, st = _acquire_trace(lm, False, prepare)
    check = checks[0]
    assert st["fills"] == 1     # every snapshot restored, none re-filled
    assert st["swaps"] >= 1 and check.restores == st["swaps"]
    assert check.resizes == st["grows"] + st["shrinks"] >= 2
    kinds = {bad[0] for bad in check.bad}
    assert kinds == ({"restore"} if mutate == "restore" else
                     {"grow"} if mutate == "grow" else set())


# -- scratch, registration, refusals -----------------------------------------
class _Recorder:
    def __init__(self):
        self.calls = []

    def record_scratch(self, tag, nbytes):
        self.calls.append((tag, nbytes))


def test_measured_program_records_once_per_shape_key():
    """One claim per (program, shape key): the skipped arguments (weights,
    page store) and repeat calls add none; another shape or K adds one;
    the CPU records 0 bytes; the call's result is the program's own."""
    rec = _Recorder()
    fn = MeasuredJit(lambda w, kv, x, k=1: x * k, rec, "prog", skip=(0, 1))
    x4, x8 = torch.ones(4), torch.ones(8)
    assert torch.equal(fn(None, torch.zeros(3), x4, k=2), x4 * 2)
    fn(torch.ones(9), torch.zeros(5), x4, k=2)     # pool grew: same key
    fn(None, None, x8, k=2)
    fn(None, None, x8, k=4)
    assert [n for _, n in rec.calls] == [0, 0, 0]
    assert len(rec.calls) == len(fn.keys) == 3
    assert all(tag[0] == "prog" for tag, _ in rec.calls)


def test_batcher_scratch_keys_and_registration(lm):
    """With ``measure_scratch`` every program the batcher runs is wrapped
    and keyed (0 bytes, so no scratch claim, on the CPU); the KV tenant
    registers with the pool's bytes, releases them at shutdown, and
    ``debug_state`` reports the elastic pool."""
    _, model = lm
    arb = HBMArbiter(1 << 30)
    cb = ContinuousBatcher(model, n_layers=LAYERS, lanes=1, max_len=24,
                           page_size=8, n_pages=4, hbm=arb,
                           compute_dtype=torch.float32, device="cpu",
                           **HEADS)
    try:
        assert arb.ledger.claims() == [(KV_TENANT, "pool", 4 * PN)]
        assert cb.pool.prefer_low_pages
        cb.submit(np.arange(8, dtype=np.int32), 8).result(timeout=120)
        assert isinstance(cb._mixed_step, MeasuredJit)
        assert cb._mixed_step.keys and cb._decode_block.keys
        assert arb.ledger.tenant_claims(SCRATCH_TENANT) == 0
        assert arb.verify() == {}
        ds = cb.debug_state()
        assert ds["pool"]["elastic"] and ds["pool"]["ladder_base"] == 4
        assert ds["hbm_pressure_events"] == arb.pressure_events
    finally:
        cb.shutdown()
    assert arb.ledger.total_claimed == 0
    plain = ContinuousBatcher(model, n_layers=LAYERS, lanes=1, max_len=24,
                              page_size=8, n_pages=4, device="cpu",
                              compute_dtype=torch.float32, **HEADS)
    try:
        assert not isinstance(plain._mixed_step, MeasuredJit)
        assert not plain.debug_state()["pool"]["elastic"]
    finally:
        plain.shutdown()


def _fake_allocator(monkeypatch, peaks):
    """The CUDA allocator's statistics, faked on the CPU: every measured
    call's peak over what stays allocated is the next value of ``peaks``
    (a program measured on "cuda:0")."""
    from tpulab_torch.hbm import scratch
    base = 1 << 32
    state = {"peak": base}
    it = iter(peaks)
    monkeypatch.setattr(scratch, "_device_of",
                        lambda args: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: base)

    def reset(*a, **k):
        state["peak"] = base + next(it)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: state["peak"])


# 13 keys of about 2.1 GB: what the Llama-3-8B-width batcher measured
# per (program, shape key), each carrying the f32 copy of the lm_head
SCRATCH_KEYS = [2_100_000_000 + 3_800_000 * i for i in range(13)]


def test_scratch_group_claims_the_largest_key_not_the_sum(monkeypatch):
    """Thirteen keys of about 2.1 GB over five programs of one group
    claim the largest key (one ledger claim), not the 27.6 GB sum that
    per-key claims add up to; ``free_hbm_bytes`` moves by the difference,
    and every per-key measurement stays readable."""
    sizes = list(np.random.default_rng(0).permutation(SCRATCH_KEYS))
    _fake_allocator(monkeypatch, sizes + sizes)
    cap = 64 << 30
    grouped, per_key = HBMArbiter(cap), HBMArbiter(cap)
    group = ScratchGroup(grouped, ("batcher", 0))
    names = ("_mixed_step", "_decode_block", "_decode_step", "_prefill",
             "_extend")
    progs = {arb: [MeasuredJit(lambda w, kv, x: x, arb, n, skip=(0, 1),
                               group=group if arb is grouped else None)
                   for n in names] for arb in (grouped, per_key)}
    for arb in (grouped, per_key):
        for i in range(13):
            progs[arb][i % 5](None, None, torch.zeros(i + 1))
            progs[arb][i % 5](None, None, torch.zeros(i + 1))  # no re-claim
    total, top = sum(SCRATCH_KEYS), max(SCRATCH_KEYS)
    assert 27.5e9 < total < 27.7e9
    assert [t for t, *_ in grouped.ledger.claims()] == [SCRATCH_TENANT]
    assert grouped.ledger.tenant_bytes(SCRATCH_TENANT) == top
    assert group.claim_bytes == top
    assert per_key.ledger.tenant_bytes(SCRATCH_TENANT) == total
    assert len(per_key.ledger.claims()) == 13
    assert grouped.free_hbm_bytes == cap - top
    assert grouped.free_hbm_bytes - per_key.free_hbm_bytes == total - top
    # every key readable, per program and in the group's table
    assert sorted(group.table.values()) == sorted(SCRATCH_KEYS)
    assert sum(len(p.keys) for p in progs[grouped]) == 13
    assert {(p._name, k): b for p in progs[grouped]
            for k, b in p.keys.items()} == group.table
    group.release()
    assert grouped.ledger.total_claimed == 0 and grouped.verify() == {}


def test_batcher_programs_share_one_scratch_claim(lm, monkeypatch):
    """A batcher's programs measure into its one ScratchGroup: one
    scratch claim, the largest key's, released at shutdown."""
    _, model = lm
    _fake_allocator(monkeypatch, (1000 + 17 * i for i in range(10_000)))
    arb = HBMArbiter(1 << 40)
    cb = ContinuousBatcher(model, n_layers=LAYERS, lanes=1, max_len=24,
                           page_size=8, n_pages=4, hbm=arb,
                           compute_dtype=torch.float32, device="cpu",
                           **HEADS)
    try:
        cb.submit(np.arange(8, dtype=np.int32), 8).result(timeout=120)
        table = cb.scratch.table
        assert len(table) >= 2
        assert sum(len(p.keys) for p in (
            cb._mixed_step, cb._decode_block, cb._decode_step, cb._prefill,
            cb._extend)) == len(table)
        scratch = [(tag, b) for t, tag, b in arb.ledger.claims()
                   if t == SCRATCH_TENANT]
        assert scratch == [(cb.scratch.tag, max(table.values()))]
        assert arb.free_hbm_bytes == (1 << 40) - cb.pool.hbm_bytes - max(
            table.values())
    finally:
        cb.shutdown()
    assert arb.ledger.total_claimed == 0


def test_arbiter_armed_batcher_rejects_mesh(lm):
    """``mesh=`` with ``hbm=`` raises before any registration (tpulab
    refuses an elastic pool under a mesh; the port has no mesh)."""
    _, model = lm
    arb = HBMArbiter(64 * PN, measure_scratch=False)
    with pytest.raises(NotImplementedError, match="mesh"):
        ContinuousBatcher(model, n_layers=LAYERS, lanes=2, max_len=24,
                          page_size=8, n_pages=4, hbm=arb, mesh=object(),
                          compute_dtype=torch.float32, device="cpu",
                          **HEADS)
    assert arb.ledger.total_claimed == 0 and arb.verify() == {}


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_cuda_pool_grow_shrink_tracks_bytes():
    """On the card the pool's tracked bytes equal the allocator's node
    size after every grow and shrink, live pages keep their bytes, and the
    CUDA allocator's live bytes follow the store (the freed store leaves
    ``memory_allocated``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pool = PagedKVPool(16, 16, 2, 8, 128, torch.bfloat16, "cuda")
    pool.prefer_low_pages = True
    page = pool.allocate_page()
    pool.kv[:, page].fill_(1.5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for op, n, want in (("grow", 16, 32), ("shrink", 64, 2),
                        ("grow", 14, 16)):
        getattr(pool, op)(n)
        torch.cuda.synchronize()
        assert pool.n_pages == want
        assert pool.hbm_bytes == pool._alloc.node_size(pool._kv_addr) \
            == want * pool.page_nbytes
        assert (torch.cuda.memory_allocated() - base
                == pool.hbm_bytes - 16 * pool.page_nbytes)
        assert bool((pool.kv[:, page] == 1.5).all())
    pool.close()
