"""The port's fleet KV fabric (``tpulab_torch.kvfabric``) against tpulab's,
on the CPU, f32, on one weight set (tpulab's fixture model bridged with
``params_from_numpy``).

- tpulab's ``tests/test_kvfabric.py`` cases run against the port: the
  owner's publish / export (write-behind honesty, the LRU cap), pull
  eligibility, the cost gate, single-flight, the first-token pick, the
  degrades (miss, corruption, geometry, ``fabric.pull`` chaos on both
  sides) and the zero-prefill token-parity contract.  Owners are
  split-plan batchers (``ragged=False``): the ragged plan publishes
  nothing, in tpulab as in the port.
- across packages: the export blob is tpulab's byte for byte for the
  same host-tier contents; a tpulab owner's blob pulls into the port's
  fetcher and the port's into tpulab's; the published pages and logits
  row of the two owners agree; a port pull's stream equals tpulab's
  local prefill's; ``KVFabricMetrics`` expositions are equal; and the
  two-replica gRPC loopback with owner death in both mixes (tpulab home
  with the port astray, and the reverse).

Tolerances: token streams identical (f32, device-sampled at T 0.8 where
the packages are compared: the greedy picks of the tiny fixture model
repeat); published pages and logits rows within 1e-5 (absolute) of
tpulab's; blob bytes and headers equal where the inputs are equal.
"""

import base64
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry as PromRegistry
from prometheus_client import generate_latest as prom_latest
from prometheus_client.parser import text_string_to_metric_families

import tpulab
import tpulab.fleet as jfleet
import tpulab.kvfabric as jfab
import tpulab.utils.metrics as JM
import tpulab_torch
import tpulab_torch.utils.metrics as TM
from tpulab.disagg import KVShipper as JShipper
from tpulab.disagg.wire import deserialize_snapshot as jdeserialize
from tpulab.engine.paged import ContinuousBatcher as JBatcher
from tpulab.engine.paged import SamplingParams as JSampling
from tpulab.models.transformer import init_transformer_params
from tpulab_torch import chaos
from tpulab_torch.disagg import KVShipper, WireFormatError, prompt_digest
from tpulab_torch.disagg.wire import deserialize_snapshot
from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
from tpulab_torch.fleet.router import PrefixAffinityRouter, prefix_digest
from tpulab_torch.kvfabric import KVFabric, fabric_export
from tpulab_torch.kvfabric.fabric import LOGITS_EXTRA
from tpulab_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    pj = init_transformer_params(vocab=64, d_model=32, n_heads=2,
                                 n_layers=2, d_ff=64)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 "cpu", n_heads=2)


def _batcher(lm, lanes=1, page_size=8, **kw):
    kw.setdefault("kv_offload", 32 << 20)
    kw.setdefault("kv_publish", True)
    return ContinuousBatcher(lm[1], n_heads=2, n_layers=2, lanes=lanes,
                             max_len=64, page_size=page_size, ragged=False,
                             compute_dtype=torch.float32, device="cpu", **kw)


def _jbatcher(lm, lanes=1, page_size=8, **kw):
    kw.setdefault("kv_offload", 32 << 20)
    kw.setdefault("kv_publish", True)
    return JBatcher(lm[0], n_heads=2, n_layers=2, lanes=lanes, max_len=64,
                    page_size=page_size, compute_dtype=jnp.float32, **kw)


def _sampling():
    """Device sampling: varied tokens (greedy on the tiny fixture model
    degenerates into repeats, which would vacuously pass parity)."""
    return SamplingParams(temperature=0.8, device=True, seed=1234)


def _jsampling():
    return JSampling(temperature=0.8, device=True, seed=1234)


def _wait_published(cb, digest, timeout=30.0):
    """Publish is write-behind: wait for the snapshot to land resident in
    the owner's host tier (the fablog row lands synchronously)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if ("fab", digest) in cb.kv_offload.store:
            return
        time.sleep(0.01)
    raise AssertionError("fabric publish never settled")


class _DirectClient:
    """``fetch_kv`` straight into an owner engine's export — the fabric
    exercised without a gRPC hop (the loopback test covers the wire).
    ``export`` picks the package whose ``fabric_export`` serves."""

    def __init__(self, owner_cb, mutate=None, export=fabric_export):
        self.owner = owner_cb
        self.mutate = mutate
        self.export = export
        self.calls = 0

    def fetch_kv(self, model_name, digest):
        self.calls += 1
        blob = self.export(self.owner, digest)
        return self.mutate(blob) if self.mutate is not None else blob


def _fabric(prompt, client, router=None, cls=KVFabric, **kw):
    """A two-member fabric whose home for ``prompt`` is the OTHER member
    (so a pull is eligible) and whose connect hands back ``client``."""
    router = router or PrefixAffinityRouter(affinity_tokens=8)
    members = ["replica-a", "replica-b"]
    rd = prefix_digest(prompt, router.affinity_tokens)
    home = router.ranked(rd, members)[0]
    self_key = members[1] if home == members[0] else members[0]
    return cls(self_key, members, lambda k: client, router, **kw)


@pytest.fixture(scope="module")
def owner(lm):
    """One publishing port owner with a settled snapshot: ``(cb, prompt,
    digest)``.  Read-only for the tests that share it."""
    cb = _batcher(lm)
    prompt = np.random.default_rng(11).integers(0, 64, (13,), np.int32)
    cb.submit(prompt, 2).result(timeout=120)
    digest = prompt_digest(prompt)
    _wait_published(cb, digest)
    yield cb, prompt, digest
    cb.shutdown()


@pytest.fixture(scope="module")
def jowner(lm, owner):
    """tpulab's owner of the same prompt (its CPU default is the split
    plan)."""
    _, prompt, digest = owner
    cb = _jbatcher(lm)
    cb.submit(prompt, 2).result(timeout=300)
    _wait_published(cb, digest)
    yield cb
    cb.shutdown()


# -- owner side: publish + export ---------------------------------------------
def test_publish_export_wire_roundtrip(owner):
    """A finished prefill publishes once; export wire-encodes it WITHOUT
    consuming the owner's copy (peek, not pop), carries the prefill
    logits row, and repeats."""
    cb, prompt, digest = owner
    assert cb.kv_publishes == 1
    assert ("fablog", digest) in cb.kv_offload.store
    blob = fabric_export(cb, digest)
    assert blob is not None
    arr, header = deserialize_snapshot(blob)
    assert header["digest"] == digest
    assert header["length"] == len(prompt)
    assert header["page_size"] == cb.page_size
    assert LOGITS_EXTRA in header              # first-token parity input
    assert arr.shape[1] == -(-len(prompt) // cb.page_size)
    # the export did NOT evict/consume: both rows still resident
    assert ("fab", digest) in cb.kv_offload.store
    assert ("fablog", digest) in cb.kv_offload.store
    assert fabric_export(cb, digest) is not None   # repeatable
    assert fabric_export(cb, b"\x00" * 16) is None  # unknown digest: miss
    # a re-submit of the same prompt does not re-publish (digest dedup)
    cb.submit(prompt, 2).result(timeout=120)
    assert cb.kv_publishes == 1


def test_export_unarmed_or_untiered_engine_is_a_miss():
    assert fabric_export(SimpleNamespace(kv_offload=None), b"x" * 16) is None
    assert fabric_export(
        SimpleNamespace(kv_offload=object(), kv_publish=False),
        b"x" * 16) is None


def test_kv_publish_requires_kv_offload_and_ragged_publishes_nothing(lm):
    """tpulab's ValueError without a host tier; the ragged plan (the
    port's default) never publishes, as in tpulab."""
    with pytest.raises(ValueError, match="kv_publish requires kv_offload"):
        _batcher(lm, kv_offload=None)
    with pytest.raises(ValueError, match="kv_publish requires kv_offload"):
        _jbatcher(lm, kv_offload=None)
    cb = ContinuousBatcher(lm[1], n_heads=2, n_layers=2, lanes=1,
                           max_len=64, page_size=8, ragged=True,
                           kv_offload=32 << 20, kv_publish=True,
                           compute_dtype=torch.float32, device="cpu")
    try:
        cb.submit(np.arange(13, dtype=np.int32), 2).result(timeout=120)
        assert cb.kv_publishes == 0 and cb.prompt_fills == 1
        assert cb.prefill_ewma_tok_s == 0.0    # no split-plan prefill ran
    finally:
        cb.shutdown()


def test_export_write_behind_in_flight_is_honest_not_found(owner):
    """Bounded staleness: a registered digest whose snapshot has not
    landed in the host tier yet answers None (the fetcher prefills
    locally) — never a wait, never a partial payload."""
    cb, _, _ = owner
    ghost = b"\x7f" * 16
    with cb._fab_lock:
        cb._fab_handles[ghost] = SimpleNamespace(key=("fab", ghost),
                                                 length=8)
    try:
        assert fabric_export(cb, ghost) is None
    finally:
        with cb._fab_lock:
            cb._fab_handles.pop(ghost, None)


def test_publish_cap_evicts_oldest_with_its_store_rows(lm):
    """The publish registry is a small LRU, not a second cache tier:
    beyond the cap the oldest digest is forgotten AND its host-tier rows
    are removed."""
    cb = _batcher(lm)
    cb.FAB_PUBLISH_CAP = 2
    try:
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 64, (9 + 2 * i,), np.int32)
                   for i in range(3)]
        digs = [prompt_digest(p) for p in prompts]
        for p, d in zip(prompts, digs):
            cb.submit(p, 2).result(timeout=120)
            _wait_published(cb, d)
        assert cb.kv_publishes == 3
        assert cb.fab_handle(digs[0]) is None          # evicted
        assert ("fab", digs[0]) not in cb.kv_offload.store
        assert ("fablog", digs[0]) not in cb.kv_offload.store
        for d in digs[1:]:
            assert fabric_export(cb, d) is not None
        assert cb.prefill_ewma_tok_s > 0.0             # the gate's input
    finally:
        cb.shutdown()


# -- fetcher side: eligibility + cost gate ------------------------------------
def _stub_engine(page_size=8, prefix=None, ewma=0.0):
    return SimpleNamespace(
        kv_offload=SimpleNamespace(page_nbytes=1 << 20),
        prefix_cache=prefix, page_size=page_size,
        prefill_ewma_tok_s=ewma)


def test_would_pull_eligibility_gates():
    prompt = np.arange(12, dtype=np.int32)
    fab = _fabric(prompt, client=None)
    eng = _stub_engine()
    assert fab.would_pull(prompt, None, eng) is not None   # eligible
    assert fab.would_pull(prompt, None, None) is None      # no engine
    assert fab.would_pull(
        prompt, None, SimpleNamespace(kv_offload=None)) is None
    assert fab.would_pull(np.arange(1, dtype=np.int32), None, eng) is None
    # host-sampled streams don't survive the hop; device-sampled do
    host = SamplingParams(temperature=0.8, device=False, seed=1)
    assert fab.would_pull(prompt, host, eng) is None
    assert fab.would_pull(prompt, _sampling(), eng) is not None
    assert fab.would_pull(prompt, None, eng, logprobs=True) is None
    # a locally covered prefix never pulls (prefill is ~a tail extend)
    covered = _stub_engine(prefix=SimpleNamespace(
        coverage=lambda p, ps: 99))
    assert fab.would_pull(prompt, None, covered) is None
    # singleton fleet / self-is-home: local state is authoritative
    fab1 = KVFabric("only", ["only"], lambda k: None,
                    PrefixAffinityRouter(affinity_tokens=8))
    assert fab1.would_pull(prompt, None, eng) is None
    home_key = fab.home_of(prompt)
    fab2 = KVFabric(home_key, ["replica-a", "replica-b"],
                    lambda k: None, fab.router)
    assert fab2.would_pull(prompt, None, eng) is None
    # the home is tpulab's: the same member for the same prompt
    jfab_ = _fabric(prompt, None, router=jfleet.PrefixAffinityRouter(
        affinity_tokens=8), cls=jfab.KVFabric)
    assert jfab_.home_of(prompt) == home_key


def test_prefix_cache_coverage_equals_tpulab(lm):
    """``PrefixCache.coverage`` (the fabric's local-hit probe) counts what
    tpulab's counts, and touches nothing: no hit, no miss, no LRU move."""
    rng = np.random.default_rng(9)
    p = rng.integers(0, 64, (21,), np.int32)
    probes = [p, p[:17], p[:9], np.concatenate([p[:8], p[:8] + 1]),
              rng.integers(0, 64, (21,), np.int32), p[:5]]
    got = []
    for cb in (_jbatcher(lm, prefix_cache=True, kv_offload=None,
                         kv_publish=False),
               _batcher(lm, prefix_cache=True, kv_offload=None,
                        kv_publish=False)):
        try:
            cb.submit(p, 2).result(timeout=300)
            pc = cb.prefix_cache
            before = (pc.hits, pc.misses, list(pc._entries))
            got.append([pc.coverage(q, 8) for q in probes])
            assert (pc.hits, pc.misses, list(pc._entries)) == before
        finally:
            cb.shutdown()
    assert got[1] == got[0] and got[0][:3] == [2, 2, 1]


def test_cost_gate_skips_when_wire_is_slower_than_recompute():
    prompt = np.arange(16, dtype=np.int32)
    fab = _fabric(prompt, client=None)
    # unknown EWMAs: optimistic (the first pulls are the measurement)
    assert not fab._gate_skips(16, _stub_engine(ewma=0.0))
    fab.fetch_bytes_per_s = 1.0                     # 1 B/s: glacial wire
    assert not fab._gate_skips(16, _stub_engine(ewma=0.0))
    eng = _stub_engine(ewma=1e9)                    # prefill ~free
    assert fab._gate_skips(16, eng)
    fab.fetch_bytes_per_s = 1e15                    # wire ~free
    assert not fab._gate_skips(16, eng)
    # the pull path counts the skip and never dials out
    fab.fetch_bytes_per_s = 1.0
    assert fab.pull(prompt, None, eng, shipper=None) is None
    assert fab.snapshot()["cost_gate_skips"] == 1
    assert fab.snapshot()["degrades"] == 0
    fab2 = _fabric(prompt, client=None, cost_gate=False)
    fab2.fetch_bytes_per_s = 1.0
    assert not fab2._gate_skips(16, eng)            # gate disarmable


# -- fetcher side: pull, degradation, single-flight ---------------------------
def test_pull_adopts_and_note_degrade_refunds(lm, owner):
    """A successful pull adopts a host-tier copy; a later admission
    rejection hands its tokens back off the saved ledger."""
    cb_owner, prompt, _ = owner
    cbf = _batcher(lm)
    try:
        client = _DirectClient(cb_owner)
        fab = _fabric(prompt, client)
        shipper = KVShipper(cbf.kv_offload)
        pulled = fab.pull(prompt, None, cbf, shipper)
        assert pulled is not None and client.calls == 1
        assert pulled.length == len(prompt)
        assert not pulled.coalesced
        snap = fab.snapshot()
        assert snap["pulls"] == 1 and snap["degrades"] == 0
        assert snap["recompute_tokens_saved"] == len(prompt)
        assert snap["pull_bytes"] > 0
        assert fab.fetch_bytes_per_s > 0           # cost gate learned
        shipper.manager.discard(pulled.handle)
        fab.note_degrade(pulled)                   # admit rejected after all
        snap = fab.snapshot()
        assert snap["degrades"] == 1
        assert snap["recompute_tokens_saved"] == 0
    finally:
        cbf.shutdown()


def test_pull_degrades_on_miss_corruption_and_geometry(lm, owner):
    cb_owner, prompt, _ = owner
    cbf = _batcher(lm)
    cbf16 = _batcher(lm, page_size=16)             # mismatched geometry
    try:
        shipper = KVShipper(cbf.kv_offload)
        # honest NOT_FOUND (owner has nothing): degrade, no exception
        miss = _fabric(prompt, _DirectClient(cb_owner,
                                             mutate=lambda b: None))
        assert miss.pull(prompt, None, cbf, shipper) is None
        assert miss.snapshot()["degrades"] == 1

        def flip(blob):
            bad = bytearray(blob)
            bad[-1] ^= 0xFF
            return bytes(bad)
        corrupt = _fabric(prompt, _DirectClient(cb_owner, mutate=flip))
        assert corrupt.pull(prompt, None, cbf, shipper) is None
        assert corrupt.snapshot()["degrades"] == 1

        geo = _fabric(prompt, _DirectClient(cb_owner))
        assert geo.pull(prompt, None, cbf16,
                        KVShipper(cbf16.kv_offload)) is None
        assert geo.snapshot()["degrades"] == 1
        assert cbf.prefill_dispatches == 0         # nothing leaked a lane
    finally:
        cbf.shutdown()
        cbf16.shutdown()


@pytest.mark.parametrize("spec", ["fabric.pull=error+1",
                                  "fabric.pull=drop+1"])
def test_chaos_trips_degrade_both_sides(owner, spec):
    """``fabric.pull`` fires on the owner's export (honest miss) and the
    fetcher's pull (abandon): either side degrades to a local prefill,
    never a corrupt adoption."""
    cb_owner, prompt, digest = owner
    with chaos.inject(spec) as sched:              # owner side
        assert fabric_export(cb_owner, digest) is None
        assert sched.fired("fabric.pull") == 1
    assert fabric_export(cb_owner, digest) is not None  # chaos disarmed
    client = _DirectClient(cb_owner)
    fab = _fabric(prompt, client)
    eng = _stub_engine()
    with chaos.inject(spec) as sched:              # fetcher side
        assert fab.pull(prompt, None, eng, shipper=None) is None
        assert sched.fired("fabric.pull") == 1
    assert client.calls == 0                       # tripped before the dial
    assert fab.snapshot()["degrades"] == 1


def test_single_flight_one_fetch_for_concurrent_misses(lm, owner):
    """N concurrent same-digest misses issue exactly ONE FetchKV; every
    waiter shares the leader's snapshot and adopts its OWN copy."""
    cb_owner, prompt, _ = owner
    cbf = _batcher(lm)
    try:
        release, entered = threading.Event(), threading.Event()
        inner = _DirectClient(cb_owner)

        class Blocking:
            calls = 0

            def fetch_kv(self, model_name, digest):
                Blocking.calls += 1
                entered.set()
                assert release.wait(30)
                return inner.fetch_kv(model_name, digest)
        fab = _fabric(prompt, Blocking())
        shipper = KVShipper(cbf.kv_offload)
        results = [None] * 4

        def run(i):
            results[i] = fab.pull(prompt, None, cbf, shipper)
        ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        ts[0].start()
        assert entered.wait(30)                    # a leader is in flight
        for t in ts[1:]:
            t.start()
        deadline = time.monotonic() + 30
        while fab.snapshot()["coalesced"] < 3:
            assert time.monotonic() < deadline, "waiters never queued"
            time.sleep(0.01)
        release.set()
        for t in ts:
            t.join(timeout=60)
        assert Blocking.calls == 1                 # the headline
        assert all(r is not None for r in results)
        handles = {id(r.handle) for r in results}
        assert len(handles) == 4                   # own copy each
        snap = fab.snapshot()
        assert snap["pulls"] == 4 and snap["coalesced"] == 3
        assert sum(r.coalesced for r in results) == 3
        for r in results:
            shipper.manager.discard(r.handle)
    finally:
        cbf.shutdown()


def test_first_token_greedy_header_and_missing_logits_reject(owner):
    cb_owner, prompt, digest = owner
    _, header = deserialize_snapshot(fabric_export(cb_owner, digest))
    fab = _fabric(prompt, client=None)
    assert fab._first_token(header, None) == header["first_token"]
    stripped = {k: v for k, v in header.items() if k != LOGITS_EXTRA}
    with pytest.raises(WireFormatError, match="logits"):
        fab._first_token(stripped, _sampling())


def test_first_token_device_sampling_equals_tpulab(owner):
    """The device-sampled first-token replay on the shipped logits row is
    tpulab's ``_device_sample_token`` (threefry, bit for bit), for
    several seeds."""
    cb_owner, prompt, digest = owner
    _, header = deserialize_snapshot(fabric_export(cb_owner, digest))
    fab = _fabric(prompt, client=None)
    jf = _fabric(prompt, None, router=jfleet.PrefixAffinityRouter(
        affinity_tokens=8), cls=jfab.KVFabric)
    for seed in (0, 1234, 2 ** 40 + 7):
        got = fab._first_token(header, SamplingParams(
            temperature=0.8, device=True, seed=seed))
        want = jf._first_token(header, JSampling(temperature=0.8,
                                                 device=True, seed=seed))
        assert got == want, seed


# -- the acceptance contract: zero prefill dispatches + token parity ----------
def test_pull_zero_prefill_dispatches_token_parity(lm):
    """A routed-astray request that pulls decodes with ZERO local
    prefill dispatches and a token stream bit-identical to the local
    prefill it skipped — greedy AND device-sampled (the fetcher replays
    its own sampling on the shipped logits row)."""
    rng = np.random.default_rng(21)
    p_greedy = rng.integers(0, 64, (13,), np.int32)
    p_samp = rng.integers(0, 64, (11,), np.int32)
    cb_owner = _batcher(lm, lanes=2)
    cbf = _batcher(lm, lanes=2)
    try:
        want_g = cb_owner.submit(p_greedy, 8).result(timeout=120)
        want_s = cb_owner.submit(p_samp, 8, sampling=_sampling()).result(
            timeout=120)
        for p in (p_greedy, p_samp):
            _wait_published(cb_owner, prompt_digest(p))
        client = _DirectClient(cb_owner)
        shipper = KVShipper(cbf.kv_offload)
        for p, want, sp in ((p_greedy, want_g, None),
                            (p_samp, want_s, _sampling())):
            fab = _fabric(p, client)
            pulled = fab.pull(p, sp, cbf, shipper)
            assert pulled is not None
            got = list(cbf.submit_shipped(
                p, 8, pulled.first_token, pulled.handle,
                sampling=sp).result(timeout=120))
            assert got == want                     # bit-exact, index 0 on
            assert got[0] == pulled.first_token
        assert cbf.prefill_dispatches == 0         # the headline
        assert cbf.prompt_fills == 0
        assert cb_owner.prefill_dispatches == 2
    finally:
        cb_owner.shutdown()
        cbf.shutdown()


# -- across packages ------------------------------------------------------------
def test_export_blob_is_tpulabs_byte_for_byte():
    """The same host-tier contents (a page snapshot and a logits row)
    export to the same blob through either package's ``fabric_export``."""
    rng = np.random.default_rng(3)
    snap = rng.standard_normal((2, 2, 2, 8, 2, 16)).astype(np.float32)
    row = rng.standard_normal(64).astype(np.float32)
    digest = b"\x11" * 16

    def engine(store_rows):
        store = SimpleNamespace(peek=lambda k: store_rows.get(k))
        return SimpleNamespace(
            kv_publish=True,
            kv_offload=SimpleNamespace(store=store,
                                       pool=SimpleNamespace(page_size=8)),
            fab_handle=lambda d: SimpleNamespace(key=("fab", d), length=13))

    want = jfab.fabric_export(engine({("fab", digest): snap,
                                      ("fablog", digest): row}), digest)
    got = fabric_export(engine({("fab", digest): torch.from_numpy(snap),
                                ("fablog", digest): torch.from_numpy(row)}),
                        digest)
    assert want is not None and got == want


def _logits_of(header):
    return np.frombuffer(base64.b64decode(header[LOGITS_EXTRA]), np.float32)


def test_published_snapshots_agree_with_tpulab(owner, jowner):
    """The two owners' exports of one prompt: equal headers (digest,
    length, geometry, dtype, first token), pages and logits rows within
    1e-5."""
    cb, prompt, digest = owner
    arr_t, h_t = deserialize_snapshot(fabric_export(cb, digest))
    arr_j, h_j = jdeserialize(jfab.fabric_export(jowner, digest))
    for k in ("digest", "length", "page_size", "shape", "dtype",
              "first_token"):
        assert h_t[k] == h_j[k], k
    assert np.abs(arr_t.numpy() - arr_j).max() <= TOL
    assert np.abs(_logits_of(h_t) - _logits_of(h_j)).max() <= TOL


def test_blobs_pull_across_packages_both_ways(lm, owner, jowner):
    """A tpulab owner's blob pulls into the port's fetcher (the adopted
    host-tier rows are its bytes exactly, within 1e-5 of the port owner's
    own), and the port's blob into tpulab's fetcher; both streams equal
    the local prefill's (device-sampled)."""
    cb, prompt, digest = owner
    ref = _jbatcher(lm, kv_offload=None, kv_publish=False)
    try:
        want = [int(t) for t in ref.submit(
            prompt, 6, sampling=_jsampling()).result(timeout=300)]
    finally:
        ref.shutdown()
    # tpulab's blob -> the port's fetcher
    cbf = _batcher(lm)
    try:
        fab = _fabric(prompt, _DirectClient(jowner, export=jfab.fabric_export))
        pulled = fab.pull(prompt, _sampling(), cbf, KVShipper(cbf.kv_offload))
        assert pulled is not None
        adopted = cbf.kv_offload.store.peek(pulled.handle.key)
        arr_j, _ = jdeserialize(jfab.fabric_export(jowner, digest))
        own = cb.kv_offload.store.peek(("fab", digest))
        assert np.array_equal(adopted.numpy(), arr_j)
        assert (adopted - own).abs().max() <= TOL
        got = [int(t) for t in cbf.submit_shipped(
            prompt, 6, pulled.first_token, pulled.handle,
            sampling=_sampling()).result(timeout=120)]
        assert got == want and cbf.prefill_dispatches == 0
    finally:
        cbf.shutdown()
    # the port's blob -> tpulab's fetcher
    jbf = _jbatcher(lm)
    try:
        fab = _fabric(prompt, _DirectClient(cb),
                      router=jfleet.PrefixAffinityRouter(
                          affinity_tokens=8), cls=jfab.KVFabric)
        pulled = fab.pull(prompt, _jsampling(), jbf,
                          JShipper(jbf.kv_offload))
        assert pulled is not None
        got = [int(t) for t in jbf.submit_shipped(
            prompt, 6, pulled.first_token, pulled.handle,
            sampling=_jsampling()).result(timeout=300)]
        assert got == want and jbf.prefill_dispatches == 0
    finally:
        jbf.shutdown()


def test_port_pull_stream_equals_tpulab_local_prefill(lm):
    """Port owner -> port fetcher, device-sampled (T 0.8, a seed): the
    pulled stream is tpulab's local-prefill stream token for token."""
    p = np.random.default_rng(23).integers(0, 64, (19,), np.int32)
    ref = _jbatcher(lm, kv_offload=None, kv_publish=False)
    try:
        want = [int(t) for t in ref.submit(
            p, 10, sampling=_jsampling()).result(timeout=300)]
    finally:
        ref.shutdown()
    cb_owner, cbf = _batcher(lm), _batcher(lm)
    try:
        cb_owner.submit(p, 1).result(timeout=120)
        _wait_published(cb_owner, prompt_digest(p))
        fab = _fabric(p, _DirectClient(cb_owner))
        pulled = fab.pull(p, _sampling(), cbf, KVShipper(cbf.kv_offload))
        got = [int(t) for t in cbf.submit_shipped(
            p, 10, pulled.first_token, pulled.handle,
            sampling=_sampling()).result(timeout=120)]
        assert got == want
        assert cbf.prefill_dispatches == 0
    finally:
        cb_owner.shutdown()
        cbf.shutdown()


# -- metrics ------------------------------------------------------------------
def _families(text):
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name.endswith("_created"):
            continue
        out[fam.name] = (fam.type, fam.documentation, sorted(
            (s.name, tuple(sorted(s.labels.items())), s.value)
            for s in fam.samples if not s.name.endswith("_created")))
    return out


def test_kvfabric_metrics_poll_and_event_hook():
    """Idempotent poll deltas and the fetch-latency hook; the exposition
    equals tpulab's (prometheus_client) through prometheus_client's
    parser after every step."""
    j = JM.KVFabricMetrics(registry=PromRegistry())
    t = TM.KVFabricMetrics(registry=TM.CollectorRegistry())
    fab = SimpleNamespace(pulls=3, pull_bytes=4096, coalesced=2,
                          cost_gate_skips=1, degrades=5,
                          recompute_tokens_saved=640)

    def same():
        want = _families(prom_latest(j.registry).decode())
        got = _families(TM.generate_latest(t.registry).decode())
        assert got == want
        return {s[0]: s[2] for _t, _d, ss in got.values() for s in ss
                if not s[1]}
    for m in (j, t):
        m.poll(fab)
        m.poll(fab)                                # idempotent deltas
        m.observe_pull(0.25, 4096)
    val = same()
    assert val["tpulab_kvfabric_pulls_total"] == 3
    assert val["tpulab_kvfabric_pull_bytes_total"] == 4096
    assert val["tpulab_kvfabric_coalesced_total"] == 2
    assert val["tpulab_kvfabric_cost_gate_skips_total"] == 1
    assert val["tpulab_kvfabric_degrades_total"] == 5
    assert val["tpulab_kvfabric_recompute_tokens_saved_total"] == 640
    assert val["tpulab_kvfabric_pull_seconds_count"] == 1
    fab.pulls = 5
    for m in (j, t):
        m.poll(fab)
    assert same()["tpulab_kvfabric_pulls_total"] == 5


# -- the full wire: two served replicas, one of each package -------------------
def _serve_port(lm, members, router):
    from tpulab_torch.rpc.infer_service import RemoteInferenceManager
    cb = _batcher(lm, lanes=2)
    fab = KVFabric("pending", lambda: list(members),
                   lambda addr: RemoteInferenceManager(addr), router)
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                        device="cpu")
    mgr.serve(port=0, generation_engines={"lm": cb}, kvfabric=fab)
    addr = f"127.0.0.1:{mgr.server.bound_port}"
    fab.self_key = addr
    return mgr, cb, fab, addr


def _serve_jax(lm, members, router):
    from tpulab.rpc.infer_service import RemoteInferenceManager
    cb = _jbatcher(lm, lanes=2)
    fab = jfab.KVFabric("pending", lambda: list(members),
                        lambda addr: RemoteInferenceManager(addr), router)
    mgr = tpulab.InferenceManager(max_exec_concurrency=1)
    mgr.serve(port=0, generation_engines={"lm": cb}, kvfabric=fab)
    addr = f"127.0.0.1:{mgr.server.bound_port}"
    fab.self_key = addr
    return mgr, cb, fab, addr


@pytest.mark.parametrize("home_pkg", ["tpulab", "port"])
def test_rpc_fleet_pull_end_to_end_and_owner_death(lm, home_pkg):
    """One tpulab and one port replica over the gRPC loopback, each with
    its package's fabric: a request routed astray to the other package
    pulls over FetchKV (zero prefill dispatches there, the home's stream
    token for token), and with the owner shut down a second digest homed
    on it degrades to a local prefill without losing the stream."""
    from tpulab_torch.rpc.infer_service import (GenerateStreamClient,
                                                RemoteInferenceManager)
    router = PrefixAffinityRouter(affinity_tokens=8)
    members = []                                   # filled after binding
    j = _serve_jax(lm, members, jfleet.PrefixAffinityRouter(
        affinity_tokens=8))
    t = _serve_port(lm, members, router)
    members.extend([j[3], t[3]])
    home, astray = (j, t) if home_pkg == "tpulab" else (t, j)
    clients = {a: RemoteInferenceManager(a) for a in members}
    killed = False
    try:
        rng = np.random.default_rng(31)
        while True:                                # a prompt homed there
            prompt = rng.integers(0, 64, (14,), np.int32)
            if router.ranked(prefix_digest(prompt, 8), members)[0] == home[3]:
                break
        kw = dict(temperature=0.8, device_sampling=True, seed=1234)
        want = list(GenerateStreamClient(clients[home[3]], "lm").generate(
            prompt, 8, **kw))
        _wait_published(home[1], prompt_digest(prompt))
        got = list(GenerateStreamClient(clients[astray[3]], "lm").generate(
            prompt, 8, **kw))
        assert got == want
        assert astray[1].prefill_dispatches == 0   # the acceptance bar
        snap = astray[2].snapshot()
        assert snap["pulls"] == 1 and snap["degrades"] == 0
        assert snap["recompute_tokens_saved"] == len(prompt)
        while True:
            p2 = rng.integers(0, 64, (12,), np.int32)
            if router.ranked(prefix_digest(p2, 8), members)[0] == home[3]:
                break
        home[0].shutdown()
        home[1].shutdown()
        killed = True
        got2 = list(GenerateStreamClient(clients[astray[3]], "lm").generate(
            p2, 6, temperature=0.8, device_sampling=True, seed=77))
        assert len(got2) == 6                      # served, not stranded
        assert astray[1].prefill_dispatches == 1   # the local fallback ran
        assert astray[2].snapshot()["degrades"] == 1
    finally:
        for c in clients.values():
            c.close()
        for mgr, cb, fab, _ in (j, t):
            fab.close()
            if not (killed and mgr is home[0]):
                mgr.shutdown()
                cb.shutdown()


# -- the bench row ----------------------------------------------------------------
def _keys(row):
    return {k: (_keys(v) if isinstance(v, dict) else type(v).__name__)
            for k, v in row.items()}


def test_benchmark_kv_fabric_row_has_tpulabs_keys():
    """The ``kv_fabric`` row at a tiny size: tpulab's keys and value
    types; the fabric pulls, parity holds in both modes, and the
    effective hit rate with the fabric on is above the one without (the
    row's claim, on the same seeded trace)."""
    kw = dict(n_replicas=2, n_prefixes=2, n_requests=6, steps=2)
    want = jfab.benchmark_kv_fabric(**kw)
    got = tpulab_torch.kvfabric.benchmark_kv_fabric(device="cpu", **kw)
    assert _keys(got) == _keys(want)
    for mode in ("fabric_off", "fabric_on"):
        assert got[mode]["parity"], mode
    assert got["fabric_on"]["pulls"] == want["fabric_on"]["pulls"] > 0
    assert got["fabric_on"]["pull_degrades"] == 0
    assert (got["fabric_on"]["effective_hit_rate"]
            == want["fabric_on"]["effective_hit_rate"]
            > got["fabric_off"]["effective_hit_rate"])
