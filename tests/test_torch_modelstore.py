"""tpulab_torch.modelstore against tpulab.modelstore, on the CPU.

The same operation sequences run through both packages, and their
observable state is compared: the host tier's contents (bit for bit),
LRU order, budget refusals and counters; the multiplexer's residency,
tiers, counters and byte accounting over swap round trips, leases and
pins, the cold-rebuild and lost paths, and the ``modelstore.swap`` fault
site.  Servables hold the same values on both sides (numpy from a seed,
or constants), so a promoted tree equals what left the device exactly
(no tolerance).  The compiled-model adapter swaps the port's MNIST
(tpulab's weights, bridged) out and back: its Infer outputs are
bit-identical across the swap and within ``TOL`` = 1e-5 of tpulab's (f32;
the backends sum in different orders).  The batcher adapter refuses to
detach while lanes are busy.

One ``cuda`` test swaps a compiled model's weights through the card and
back; it skips here (``python -m pytest --noconftest -m cuda
tests/test_torch_modelstore.py`` on the card's machine).
"""

import threading
import time

import numpy as np
import pytest
import torch

try:            # the reference; absent on the card's machine
    import jax

    from tpulab import chaos as jchaos
    from tpulab.engine import InferenceManager as JaxManager
    from tpulab.models.mnist import make_mnist as jax_make_mnist
    from tpulab.modelstore import HostParamStore as JaxStore
    from tpulab.modelstore import WeightMultiplexer as JaxMux
    from tpulab.modelstore import tree_nbytes as jax_nbytes
except ImportError:
    jax = None
from tpulab_torch import chaos
from tpulab_torch.engine.inference_manager import InferenceManager
from tpulab_torch.models.convert import tree_from_numpy
from tpulab_torch.models.mnist import make_mnist
from tpulab_torch.modelstore import (BatcherAdapter, CompiledModelAdapter,
                                     HostParamStore, WeightMultiplexer,
                                     tree_nbytes)

torch.set_num_threads(2)

TOL = 1e-5
OUT = "Plus214_Output_0"
needs_ref = pytest.mark.skipif(jax is None, reason="needs tpulab (JAX)")


# -- servables: the same trees on both sides ----------------------------------
def _np_tree(seed: float, n: int = 1024):
    return {"w": np.full((n,), float(seed), np.float32),
            "q": {"w_int8": np.full((n,), int(seed) % 127, np.int8),
                  "scale": np.ones((n,), np.float32)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


class _TorchServable:
    """The adapter protocol over a torch tree (tpulab's SimpleServable)."""

    def __init__(self, seed: float, n: int = 1024, resident: bool = True):
        self.seed, self.n = seed, n
        self.dev = _to_torch(_np_tree(seed, n)) if resident else None
        self._busy = False

    def resident(self):
        return self.dev is not None

    def param_bytes(self):
        return tree_nbytes(self.dev if self.dev is not None
                           else _to_torch(_np_tree(self.seed, self.n)))

    def busy(self):
        return self._busy

    def detach(self):
        dev, self.dev = self.dev, None
        return dev

    def on_detached(self):
        pass

    def attach(self, host_tree):
        self.dev = {"w": host_tree["w"].clone(),
                    "q": {k: v.clone() for k, v in host_tree["q"].items()}}

    def rebuild(self):
        return _to_torch(_np_tree(self.seed, self.n))

    def value(self):
        return float(self.dev["w"][0])


class _JaxServable(_TorchServable):
    def __init__(self, seed, n=1024, resident=True):
        self.seed, self.n = seed, n
        self.dev = jax.device_put(_np_tree(seed, n)) if resident else None
        self._busy = False

    def param_bytes(self):
        return jax_nbytes(self.dev if self.dev is not None
                          else _np_tree(self.seed, self.n))

    def attach(self, host_tree):
        self.dev = jax.device_put(host_tree)

    def rebuild(self):
        return _np_tree(self.seed, self.n)

    def value(self):
        return float(np.asarray(self.dev["w"])[0])


SIDES = {"tpulab": (lambda *a, **k: JaxMux(*a, **k), _JaxServable,
                    lambda: jchaos),
         "port": (WeightMultiplexer, _TorchServable, lambda: chaos)}


def _state(mux):
    """Everything a trace compares between the packages."""
    return dict(
        counters={k: getattr(mux, k) for k in (
            "swap_ins", "swap_outs", "swap_in_bytes", "swap_out_bytes",
            "evictions", "cold_rebuilds", "swap_failures", "swap_drops")},
        hbm=mux.hbm_bytes_in_use, resident=mux.resident_models(),
        host=mux.host_models(),
        states={n: mux.state_of(n) for n in mux.models()},
        leases=mux.lease_counts())


def _both(trace):
    """Run ``trace(mux_cls, servable_cls, chaos_module)`` through tpulab
    and the port; returns their results."""
    out = {}
    for side, (mux_cls, serv, ch) in SIDES.items():
        out[side] = trace(mux_cls, serv, ch())
    return out["tpulab"], out["port"]


# -- HostParamStore -----------------------------------------------------------
def _rich_tree():
    rng = np.random.default_rng(0)
    return {"layer0": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                       "q": {"w_int8": np.arange(-8, 8, dtype=np.int8),
                             "scale": np.linspace(0.1, 1, 16).astype(
                                 np.float32)}},
            "embed": np.arange(64, dtype=np.float32)}


@needs_ref
def test_host_param_store_roundtrip_bit_exact():
    """tpulab's round trip on both stores: get copies, pop removes, the
    int8 leaf keeps its dtype; the port's leaves equal tpulab's bit for
    bit and the counters match."""
    tree = _rich_tree()
    js, ts = JaxStore(1 << 20), HostParamStore(1 << 20)
    assert js.put("m", tree) and ts.put("m", _to_torch(tree))
    jg, tg = js.get("m"), ts.get("m")
    for path in (("layer0", "w"), ("layer0", "q", "w_int8"),
                 ("layer0", "q", "scale"), ("embed",)):
        j, t = jg, tg
        for k in path:
            j, t = j[k], t[k]
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)
    tg["embed"][0] = 999.0                    # copy-on-get, never the block
    assert float(ts.get("m")["embed"][0]) == 0.0
    popped = ts.pop("m")
    np.testing.assert_array_equal(popped["embed"].numpy(), tree["embed"])
    js.get("m")
    js.pop("m")
    for s in (js, ts):
        assert "m" not in s and s.bytes_used == 0 and s.get("m") is None
    assert ([getattr(ts, k) for k in ("puts", "hits", "misses")]
            == [getattr(js, k) for k in ("puts", "hits", "misses")])


@needs_ref
def test_host_param_store_budget_lru_and_oversize():
    """The same puts, touches and an oversize tree: the same survivors in
    the same LRU order, the same evictions and drops."""
    tree = _np_tree(1.0)
    nbytes = jax_nbytes(tree)
    assert tree_nbytes(_to_torch(tree)) == nbytes
    states = []
    for store, conv in ((JaxStore(3 * nbytes), lambda t: t),
                        (HostParamStore(3 * nbytes), _to_torch)):
        for k in "abc":
            assert store.put(k, conv(tree))
        store.get("a")                        # "b" is now the coldest
        assert store.put("d", conv(tree))
        assert not store.put("big", conv(_np_tree(1.0, 4 * 1024 * 1024)))
        states.append((store.keys(), store.evictions, store.drops,
                       store.bytes_used, store.headroom_bytes))
        store.clear()
        assert store.headroom_bytes == store.budget_bytes
    assert states[0] == states[1]
    assert states[1][0] == ["c", "a", "d"]


def test_host_param_store_adopts_and_keeps_strides():
    """``adopt=True`` takes the caller's tensors as the store's blocks
    (no second copy); a channels-last leaf comes back channels-last; the
    tracked host allocator counts every stored byte."""
    w = torch.randn(4, 3, 5, 5).contiguous(memory_format=torch.channels_last)
    tree = {"conv": {"w": w}, "stats": (torch.ones(3), torch.zeros(3))}
    store = HostParamStore(1 << 20)
    assert store.put("m", tree, adopt=True)
    assert store._alloc.bytes_in_use == store.bytes_used == tree_nbytes(tree)
    got = store.pop("m")
    assert got["conv"]["w"] is w              # the adopted block itself
    assert isinstance(got["stats"], tuple)
    assert store.put("m", tree)               # a copy, strides kept
    got = store.get("m")
    assert got["conv"]["w"].stride() == w.stride()
    assert torch.equal(got["conv"]["w"], w)
    assert store._alloc.bytes_in_use == store.bytes_used


# -- the multiplexer against tpulab's -----------------------------------------
@needs_ref
def test_swap_roundtrip_counters_and_bytes_match():
    """tpulab's swap round trip: a budget for one model, b registered
    last (a trimmed to the host tier), a acquired back: promoted bytes,
    bit-exact, and every counter and byte figure equal to tpulab's."""
    def trace(mux_cls, serv, _ch):
        a, b = serv(1), serv(2)
        nb = a.param_bytes()
        mux = mux_cls(nb + nb // 2)
        mux.register("a", a)
        mux.register("b", b)
        assert mux.drain()
        before = _state(mux)
        with mux.acquire("a"):
            val = a.value()
        assert mux.drain()
        st = _state(mux)
        mux.close()
        return before, st, val, nb

    want, got = _both(trace)
    assert got == want
    assert got[2] == 1.0
    assert got[1]["counters"]["swap_ins"] == 1
    assert got[1]["hbm"] == got[3]            # only "a" accounted


@needs_ref
@pytest.mark.parametrize("kind", ["lease", "pin"])
def test_leased_and_pinned_models_never_evicted(kind):
    """A leased (or pinned) model is never a victim: the other model's
    acquire times out while it holds, and proceeds once released; the
    states and counters follow tpulab's."""
    def trace(mux_cls, serv, _ch):
        a, b = serv(1), serv(2)
        nb = a.param_bytes()
        mux = mux_cls(nb + nb // 2)
        if kind == "pin":
            mux.register("a", a, pinned=True)
            mux.register("b", b, params=_np_tree(2) if serv is _JaxServable
                         else _to_torch(_np_tree(2)))
        else:
            mux.register("a", a)
            mux.register("b", b)
        mux.drain()
        hold = "a" if kind == "pin" else "b"
        lease = mux.acquire(hold) if kind == "lease" else None
        other = "b" if kind == "pin" else "a"
        with pytest.raises(TimeoutError):
            mux.acquire(other, timeout=0.3)
        untouched = (a if hold == "a" else b).dev is not None
        admit = mux.can_admit(other)
        if lease is not None:
            lease.release()
        else:
            mux.pin("a", on=False)
        with mux.acquire(other, timeout=30):
            val = (b if other == "b" else a).value()
        mux.drain()
        st = _state(mux)
        mux.close()
        return untouched, admit, val, st

    want, got = _both(trace)
    assert got == want
    assert got[0] and not got[1]


@needs_ref
def test_register_cold_and_lost_paths():
    """A non-resident model registered with its host tree enters COLD (its
    first acquire promotes it), without one LOST (its first acquire
    cold-rebuilds)."""
    def trace(mux_cls, serv, _ch):
        cold, lost = serv(5, resident=False), serv(7, resident=False)
        mux = mux_cls(1 << 20)
        tree = (_np_tree(5) if serv is _JaxServable
                else _to_torch(_np_tree(5)))
        mux.register("cold", cold, params=tree)
        mux.register("lost", lost)
        states = (mux.state_of("cold"), mux.state_of("lost"))
        with mux.acquire("cold"):
            v1 = cold.value()
        with mux.acquire("lost"):
            v2 = lost.value()
        st = _state(mux)
        mux.close()
        return states, v1, v2, st

    want, got = _both(trace)
    assert got == want
    assert got[:3] == (("cold", "lost"), 5.0, 7.0)
    assert got[3]["counters"]["cold_rebuilds"] == 1


@needs_ref
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("action", ["error", "drop"])
def test_chaos_swap_degrades_to_cold_rebuild(direction, action):
    """``modelstore.swap``: a tripped swap-OUT loses the snapshot (the
    model goes LOST, its next acquire rebuilds), a tripped swap-IN
    discards the host copy and rebuilds in the same acquire; every
    request completes with correct weights, as in tpulab."""
    def trace(mux_cls, serv, ch):
        a, b = serv(1), serv(2)
        nb = a.param_bytes()
        mux = mux_cls(nb + nb // 2)
        mux.register("a", a)
        mux.register("b", b)
        mux.drain()
        if direction == "out":
            with ch.inject(f"modelstore.swap={action}+1"):
                with mux.acquire("a"):            # evicting b trips
                    v1 = a.value()
            mux.drain()
            mid = mux.state_of("b")
            with mux.acquire("b"):
                v2 = b.value()
        else:
            with mux.acquire("a"):
                v1 = a.value()
            mux.drain()
            mid = mux.state_of("b")
            # @1 skips the eviction's swap-out; the swap-in trips
            with ch.inject(f"modelstore.swap={action}@1+1"):
                with mux.acquire("b", timeout=30):
                    v2 = b.value()
        mux.drain()
        st = _state(mux)
        in_store = "b" in mux.store
        mux.close()
        return mid, v1, v2, st, in_store

    want, got = _both(trace)
    assert got == want
    assert got[1:3] == (1.0, 2.0)
    assert got[0] == ("lost" if direction == "out" else "cold")
    assert got[3]["counters"]["swap_failures"] == 1
    assert got[3]["counters"]["cold_rebuilds"] == 1
    assert not got[4]


def test_swap_out_releases_every_device_reference():
    """Once a swap-out lands nothing holds the detached tree (on the card
    its memory is free when the accounting releases): neither the
    transfer engine nor the host tier's entry keeps a leaf alive; the
    promoted tree equals what left."""
    import gc
    import weakref

    a, b = _TorchServable(1), _TorchServable(2)
    nb = a.param_bytes()
    leaf = weakref.ref(a.dev["q"]["w_int8"])
    mux = WeightMultiplexer(nb + nb // 2)
    mux.register("a", a)
    mux.register("b", b)                      # trims "a" to the host tier
    assert mux.drain()
    gc.collect()
    assert mux.state_of("a") == "cold" and leaf() is None
    with mux.acquire("a"):
        assert torch.equal(a.dev["q"]["w_int8"],
                           torch.full((1024,), 1, dtype=torch.int8))
    mux.close()


def test_can_admit_and_lease_counts():
    a, b = _TorchServable(1), _TorchServable(2)
    nb = a.param_bytes()
    mux = WeightMultiplexer(nb + nb // 2)
    mux.register("a", a)
    mux.register("b", b)
    assert mux.drain()
    lease = mux.acquire("b")
    assert mux.lease_counts()["b"] == {"state": "hot", "refs": 1,
                                       "pinned": False, "bytes": nb}
    assert not mux.can_admit("a") and mux.can_admit("b")
    assert mux.can_admit("unmanaged")
    lease.release()
    lease.release()                           # idempotent
    assert mux.lease_counts()["b"]["refs"] == 0 and mux.can_admit("a")
    with pytest.raises(ValueError):
        mux.register("a", a)
    with pytest.raises(KeyError):
        mux.acquire("nope")
    mux.close()


# -- the compiled-model adapter over MNIST ------------------------------------
@pytest.fixture(scope="module")
def mnist_pair():
    """tpulab's MNIST manager and the port's, on one weight set."""
    jmodel = jax_make_mnist(max_batch_size=8, seed=3)
    jmgr = JaxManager(max_executions=2)
    jmgr.register_model("mnist", jmodel)
    jmgr.update_resources()
    tree = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jmodel.params),
                           "cpu")
    mgr = InferenceManager(max_executions=2, device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=8, params=tree))
    mgr.update_resources()
    yield jmgr, mgr
    mgr.shutdown()
    jmgr.shutdown()


@needs_ref
def test_compiled_model_swap_bit_exact(mnist_pair):
    """MNIST's placed weights swap out to the host tier (the tracked
    allocator's gauge drops to 0) and back (the gauge returns to the same
    bytes): the Infer outputs are bit-identical to the pre-swap serve,
    within TOL of tpulab's, and the host tier held the device form."""
    jmgr, mgr = mnist_pair
    x = np.random.default_rng(0).standard_normal(
        (3, 28, 28, 1)).astype(np.float32)
    want = jmgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
    ref = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
    np.testing.assert_allclose(ref, want, rtol=TOL, atol=TOL)
    c = mgr.compiled("mnist")
    alloc = c.allocator
    gauge0 = alloc.bytes_in_use
    nb = tree_nbytes(c.device_params)
    assert gauge0 == nb > 0
    placed = {k: {n: t.clone() for n, t in v.items()}
              for k, v in c.device_params.items()}
    mux = WeightMultiplexer(2 * nb)
    mux.register("mnist", CompiledModelAdapter(c))
    try:
        assert mux.hbm_bytes_in_use == nb
        with mux._cv:
            mux._swap_out_locked(mux._entries["mnist"])
        assert mux.drain()
        assert mux.state_of("mnist") == "cold"
        assert mux.host_models() == ["mnist"]
        assert c.device_params is None and alloc.bytes_in_use == 0
        assert mux.hbm_bytes_in_use == 0
        host = mux.store.get("mnist")         # the device form, as placed
        for k, v in placed.items():
            for n, t in v.items():
                assert torch.equal(host[k][n], t)
                assert host[k][n].stride() == t.stride()
        with mux.acquire("mnist"):
            got = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
        np.testing.assert_array_equal(got, ref)
        assert alloc.bytes_in_use == gauge0 and mux.hbm_bytes_in_use == nb
        assert mux.swap_ins == 1 and mux.cold_rebuilds == 0
        assert mux.swap_out_bytes == mux.swap_in_bytes == nb
    finally:
        mux.close()


def test_compiled_model_cold_rebuild_places_again():
    """A LOST compiled model rebuilds through the function it was given
    and its ``place_fn``: the same outputs as the original placement."""
    tree = make_mnist(max_batch_size=8, device="cpu").params
    mgr = InferenceManager(max_executions=1, device="cpu")
    mgr.register_model("mnist", make_mnist(max_batch_size=8, params=tree))
    mgr.update_resources()
    try:
        x = np.random.default_rng(4).standard_normal(
            (2, 28, 28, 1)).astype(np.float32)
        ref = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
        c = mgr.compiled("mnist")
        ad = CompiledModelAdapter(
            c, builder=lambda: make_mnist(max_batch_size=8, params=tree))
        assert c.model.params is None         # the tier is the host copy
        mux = WeightMultiplexer(1 << 30)
        mux.register("mnist", ad)
        with chaos.inject("modelstore.swap=drop+1"):
            with mux._cv:
                mux._swap_out_locked(mux._entries["mnist"])
        assert mux.state_of("mnist") == "lost"
        with mux.acquire("mnist"):
            got = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
        np.testing.assert_array_equal(got, ref)
        assert mux.cold_rebuilds == 1 and mux.swap_failures == 1
        mux.close()
    finally:
        mgr.shutdown()


# -- the batcher adapter ------------------------------------------------------
@pytest.fixture(scope="module")
def batcher():
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import init_transformer_params

    kw = dict(vocab=64, d_model=64, n_heads=2, n_layers=4, d_ff=128,
              device="cpu")
    cb = ContinuousBatcher(init_transformer_params(**kw), n_heads=2,
                           n_layers=4, lanes=2, max_len=64,
                           compute_dtype=torch.float32, device="cpu")
    yield cb, (lambda: init_transformer_params(**kw))
    cb.shutdown()


def test_batcher_adapter_refuses_busy_detach(batcher):
    """``detach`` refuses while the batcher has lanes or queued work (the
    floor under "a decoding model is never evicted"), so an eviction
    backs off and the model stays hot; idle, it swaps out and back with
    the same stream."""
    cb, draw = batcher
    prompt = np.arange(8, dtype=np.int32)
    ref = cb.submit(prompt, 12).result(timeout=120)
    ad = BatcherAdapter(cb, draw)
    gate, go = threading.Event(), threading.Event()

    def hold(tok, i):
        if i == 0:
            gate.set()
            go.wait(30)

    fut = cb.submit(prompt, 12, on_token=hold)
    assert gate.wait(60)
    assert ad.busy()
    with pytest.raises(RuntimeError, match="in-flight"):
        ad.detach()
    mux = WeightMultiplexer(1 << 30)
    mux.register("llm", ad)
    with mux._cv:
        assert not mux._swap_out_locked(mux._entries["llm"])
    assert mux.state_of("llm") == "hot" and cb.params is not None
    go.set()
    assert fut.result(timeout=120) == ref
    deadline = time.monotonic() + 30
    while ad.busy() and time.monotonic() < deadline:
        time.sleep(0.01)
    with mux._cv:
        assert mux._swap_out_locked(mux._entries["llm"])
    assert mux.drain() and cb.params is None
    with mux.acquire("llm"):
        assert cb.submit(prompt, 12).result(timeout=120) == ref
    assert mux.swap_ins == 1 and mux.swap_outs == 1
    mux._entries.clear()                      # the shared batcher outlives
    mux.close()


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_cuda_compiled_model_swap_bit_exact():
    """MNIST's weights swap from the card to page-locked host memory and
    back: the tracked gauge drops to 0 and returns, and the outputs on the
    card are bit-identical across the swap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mgr = InferenceManager(max_executions=2)
    mgr.register_model("mnist", make_mnist(max_batch_size=8, device="cpu"))
    mgr.update_resources()
    try:
        x = np.random.default_rng(1).standard_normal(
            (8, 28, 28, 1)).astype(np.float32)
        ref = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
        c = mgr.compiled("mnist")
        nb = c.allocator.bytes_in_use
        mux = WeightMultiplexer(2 * nb)
        mux.register("mnist", CompiledModelAdapter(c))
        with mux._cv:
            mux._swap_out_locked(mux._entries["mnist"])
        assert mux.drain() and c.allocator.bytes_in_use == 0
        with mux.acquire("mnist"):
            got = mgr.infer_runner("mnist").infer(Input3=x).result(60)[OUT]
        np.testing.assert_array_equal(got, ref)
        assert c.allocator.bytes_in_use == nb
        mux.close()
    finally:
        mgr.shutdown()
