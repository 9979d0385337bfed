"""tpulab_torch's sharded serving against tpulab's on the CPU (the port of
``tests/test_sharded_decode.py``).

tpulab serves one program over a ``{"model": M}`` mesh of fake CPU
devices; the port serves M spawned gloo ranks, one batcher each, rank 0
the coordinator.  One module-scoped launch per world size (1, 2 and 4
ranks, started together, each joined within 120 s) runs every case of
that size and writes the coordinator's results to a file; meanwhile the
test process serves the same workloads through tpulab's batcher at
``mesh=None`` and at ``{"model": 2}`` on the same numpy weights
(tpulab's small transformer, f32, with 4 heads so that 4 ranks divide
them).  Each case is held against both:

- tokens (greedy, device-sampled, host-sampled, speculative, preempted
  and resumed through the host tier, prefix-cache hits and chunked
  prompts) equal tpulab's, under both of the port's plans;
- logprobs within 1e-5 (f32; two backends, two summation orders);
- within one world size, a second run bit-identical;
- the coordinator's host syncs and dispatches per workload equal the
  port's own ``mesh=None`` batcher's;
- a swap payload taken out of the pool at any M is the unsharded pages,
  and restores bit for bit at every M and at ``mesh=None``;
- a follower's failure inside a replicated operation fails the mesh:
  the coordinator's requests raise, none resolves with tokens; a rank's
  failure reaches every other rank through the channel's store.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.engine.paged import ContinuousBatcher as JaxBatcher
from tpulab.engine.paged import PagedKVPool as JaxPool
from tpulab.engine.paged import SamplingParams as JaxSampling
from tpulab.models.transformer import early_exit_draft as jax_draft
from tpulab.models.transformer import init_transformer_params as jax_init
from tpulab.parallel import make_mesh as jax_make_mesh
from tpulab_torch.parallel import multihost
from torch_sharded_ranks import (GEO, STEPS_TIMEOUT, _error, _main_workload,
                                 _preempt_workload, _prefix_workload,
                                 _prompts, rank_cases)

torch.set_num_threads(2)

WORLDS = (1, 2, 4)
LM = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
TOL = 1e-5
SCALE = 20.0


# ------------------------------------------------------------- workloads
def _lm_np():
    """tpulab's small transformer with its trained-model emulation (the
    1-layer early-exit draft agrees with the target sometimes), its
    matrices scaled up from N(0, 0.02) to N(0, 0.4): at init scale every
    greedy stream repeats one token off near-uniform logits, which would
    hold the port to little."""
    p = jax_init(vocab=LM["vocab"], d_model=LM["d_model"],
                 n_heads=LM["n_heads"], n_layers=LM["n_layers"],
                 d_ff=LM["d_ff"])
    p = jax.tree_util.tree_map(lambda x: x * SCALE if x.ndim == 2 else x, p)
    for w in ("wo", "w2"):
        p["layer1"][w] = p["layer1"][w] * 0.05
    return jax.tree_util.tree_map(np.asarray, p)


# ------------------------------------------------------------- tpulab
def _jax_mesh(m):
    return jax_make_mesh({"model": m}, jax.devices()[:m])


def _jax_serve(np_tree, mesh):
    """tpulab's results of every workload on one mesh (its default plan
    on the CPU)."""
    lm = jax.tree_util.tree_map(jnp.asarray, np_tree)
    pr = _prompts()
    out = {}

    def make(**kw):
        return JaxBatcher(lm, compute_dtype=jnp.float32, mesh=mesh,
                          **GEO, **kw)

    cb = make(lanes=2, max_len=64)
    try:
        out["main"] = _main_workload(cb, JaxSampling, pr)
    finally:
        cb.shutdown()
    cb = make(lanes=1, max_len=96, n_pages=25,
              draft_params=jax_draft(lm, 1), draft_n_layers=1)
    try:
        out["spec"] = [int(t) for t in cb.submit(pr["spec"], 24).result(
            timeout=300)]
    finally:
        cb.shutdown()
    cb = make(lanes=1, max_len=64, kv_offload=32 << 20)
    try:
        out["preempt"] = _preempt_workload(cb, pr)
    finally:
        cb.shutdown()
    cb = make(lanes=1, max_len=96, prefix_cache=True, prefill_chunk=16)
    try:
        out["prefix"] = _prefix_workload(cb, pr)
        out["prefix_hits"] = cb.prefix_cache.hits
    finally:
        cb.shutdown()
    return out


def _jax_errors():
    m2 = _jax_mesh(2)
    out = {}
    for key, fn in (
            ("err_no_model_axis", lambda: JaxPool(
                8, 8, 2, 2, 16, jnp.float32,
                mesh=jax_make_mesh({"data": 2}, jax.devices()[:2]))),
            ("err_geometry", lambda: JaxPool(8, 8, 2, 3, 16, jnp.float32,
                                             mesh=m2))):
        out[key] = _error(fn)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three launches (in threads) beside tpulab's two meshes."""
    np_tree = _lm_np()
    base = tmp_path_factory.mktemp("sharded")

    def launch(world):
        d = base / f"w{world}"
        d.mkdir()
        multihost.launch(rank_cases, world,
                         (world, str(d / "store"), str(d), np_tree),
                         timeout=STEPS_TIMEOUT)
        return [np.load(d / f"res{r}.npy", allow_pickle=True).item()
                for r in range(world)]

    with ThreadPoolExecutor(len(WORLDS) + 1) as ex:
        futs = {w: ex.submit(launch, w) for w in WORLDS}
        m2 = ex.submit(_jax_serve, np_tree, _jax_mesh(2))
        jax_out = {"none": _jax_serve(np_tree, None),
                   "errors": _jax_errors()}
        jax_out["m2"] = m2.result()
        port = {w: f.result() for w, f in futs.items()}
    return {"port": port, "jax": jax_out}


# ----------------------------------------------------------- the cases
MAIN = [(w, plan) for w in WORLDS for plan in ("ragged", "split")]
FULL = [(w, plan) for w, plan in MAIN if w < 4 or plan == "ragged"]
ids = [f"m{w}-{plan}" for w, plan in MAIN]
full_ids = [f"m{w}-{plan}" for w, plan in FULL]


def _coord(runs, w):
    return runs["port"][w][0]


def _refs(runs, key):
    """tpulab's result at mesh=None and at {"model": 2} (equal tokens)."""
    a, b = runs["jax"]["none"], runs["jax"]["m2"]
    return a["main"][key] if key in a["main"] else a[key], \
        b["main"][key] if key in b["main"] else b[key]


def _same_tokens(got, key, runs):
    for want in _refs(runs, key):
        assert got == want, (key, got, want)


@pytest.mark.parametrize("w", WORLDS)
def test_pool_and_params_are_actually_sharded(runs, w):
    """Each rank holds its KV heads of the pool (rank r: heads
    [r*H/M, (r+1)*H/M)) and its Megatron shards of the weights: wqkv and
    w1 by columns, wo by rows, embed by vocab rows, norms whole; the pool
    reports tpulab's placements, logical bytes and per-shard bytes;
    only the coordinator takes requests."""
    for rank, r in enumerate(runs["port"][w]):
        p = r["place"]
        assert p["kv"] == [2, 2 * 8 + 1, 2, 8, 4 // w, 8]
        assert p["n_shards"] == w
        assert p["per_shard"][0] == p["per_shard"][1] > 0
        assert p["sharding"][0] == p["sharding"][1]
        assert p["wqkv"] == [32, 96 // w] and p["wo"] == [32 // w, 32]
        assert p["w1"] == [32, 64 // w] and p["embed"] == [64 // w, 32]
        assert p["ln1"] == [32]
        assert p["coordinator"] == (rank == 0)
        if rank:
            assert "follower rank" in p["submit_err"]
        assert r["swap_pool_local"] == [2, 9, 2, 8, 4 // w, 16]


def test_pool_rejects_bad_mesh_geometry(runs):
    """A pool mesh without a ``model`` axis, and KV heads the axis does
    not divide: tpulab's errors, word for word."""
    r = _coord(runs, 2)
    for key in ("err_no_model_axis", "err_geometry"):
        assert r[key] == runs["jax"]["errors"][key]
        assert r[key].startswith("ValueError")


def test_batcher_refusals_under_a_mesh(runs):
    """tpulab's refusals (the single-device flash prefill, an elastic
    HBM pool, a pool built on another mesh, heads the axis does not
    divide: the kernel's message), each raised on every rank before any
    collective."""
    from tpulab.ops.ragged_attention import ragged_paged_attention as jrpa

    r = _coord(runs, 2)
    assert "ValueError" in r["err_flash"] and "single-device" in r[
        "err_flash"]
    assert ("NotImplementedError" in r["err_hbm"]
            and "HBM economy" in r["err_hbm"])
    assert ("ValueError" in r["err_foreign"]
            and "different mesh" in r["err_foreign"])
    q = jnp.zeros((1, 1, 3, 16), jnp.float32)
    pool = jnp.zeros((2, 2, 8, 3, 16), jnp.float32)
    ints = jnp.zeros((1,), jnp.int32)
    want = _error(lambda: jrpa(q, pool, jnp.zeros((1, 1), jnp.int32), ints,
                               ints, mesh=_jax_mesh(2)))
    assert r["err_heads"] == want


def test_cuda_split_plan_under_a_mesh_prefills_on_kernel_2():
    """On the card the split plan runs under a mesh, its prompt attention
    on the flash kernel over each rank's own query heads:
    ``prefill_flash=None`` selects it there (dense attention stays the
    CPU's default), ``False`` (plain math on the card) raises as it does
    at mesh=None, and ``True`` keeps tpulab's refusal; all decided before
    the mesh is touched."""
    from types import SimpleNamespace

    from tpulab_torch.engine.paged import (ContinuousBatcher,
                                           _prefill_attention)
    from tpulab_torch.models.convert import tree_from_numpy

    stub = SimpleNamespace(device_type="cuda", mesh_dim_names=("model",))
    params = tree_from_numpy(_lm_np(), "cpu")
    with pytest.raises(NotImplementedError, match="prefill_flash=False"):
        ContinuousBatcher(params, compute_dtype=torch.float32, mesh=stub,
                          ragged=False, prefill_flash=False, **GEO)
    with pytest.raises(ValueError, match="single-device"):
        ContinuousBatcher(params, compute_dtype=torch.float32, mesh=stub,
                          ragged=False, prefill_flash=True, **GEO)
    assert _prefill_attention(None, "cuda", stub) is True
    assert _prefill_attention(None, "cpu", SimpleNamespace(
        device_type="cpu")) is False


@pytest.mark.parametrize("w,plan", MAIN, ids=ids)
def test_sharded_greedy_parity_with_page_crossings(runs, w, plan):
    """Greedy streams (decode runs crossing page boundaries mid-block)
    equal tpulab's at mesh=None and at {"model": 2}; pages come home."""
    r = _coord(runs, w)
    for i in range(4):
        _same_tokens(r[f"mesh/{plan}/main_a"][f"greedy{i}"], f"greedy{i}",
                     runs)
    free, total = r[f"mesh/{plan}/main_a_free"]
    assert free == total


@pytest.mark.parametrize("w,plan", MAIN, ids=ids)
def test_sharded_device_sampled_parity(runs, w, plan):
    """The (seed, position)-keyed device sampling stream: every rank
    picks over the all-gathered vocab, the same token as tpulab."""
    got = _coord(runs, w)[f"mesh/{plan}/main_a"]["sampled"]
    assert len(got) == 20
    _same_tokens(got, "sampled", runs)


@pytest.mark.parametrize("w,plan", MAIN, ids=ids)
def test_sharded_logprobs_parity(runs, w, plan):
    r = _coord(runs, w)[f"mesh/{plan}/main_a"]
    _same_tokens(r["logprobs"], "logprobs", runs)
    for want in _refs(runs, "logprobs_lp"):
        np.testing.assert_allclose(r["logprobs_lp"], want, rtol=0, atol=TOL)


@pytest.mark.parametrize("w,plan", MAIN, ids=ids)
def test_sharded_host_sampled_stream_parity(runs, w, plan):
    """A host-sampled (top_k) lane's rows come off the coordinator's
    fetch of the gathered logits: tpulab's seeded host stream."""
    _same_tokens(_coord(runs, w)[f"mesh/{plan}/main_a"]["host"], "host",
                 runs)


@pytest.mark.parametrize("w,plan", MAIN, ids=ids)
def test_mesh_parity_matches_dryrun_contract(runs, w, plan):
    """The dry run's pair (greedy + seeded device-sampled on one
    batcher) equals tpulab's on both of its meshes."""
    r = _coord(runs, w)[f"mesh/{plan}/main_a"]
    _same_tokens(r["dry_greedy"], "dry_greedy", runs)
    _same_tokens(r["dry_sampled"], "dry_sampled", runs)


@pytest.mark.parametrize("w", WORLDS)
def test_two_runs_are_bit_identical(runs, w):
    """Within one world size a second batcher serves the same workload to
    the bit, logprobs included."""
    r = _coord(runs, w)
    assert r["mesh/ragged/main_a"] == r["mesh/ragged/main_b"]


@pytest.mark.parametrize("w,plan", FULL, ids=full_ids)
def test_sharded_host_sync_counts_preserved(runs, w, plan):
    """The coordinator's blocking fetches and dispatches for the same
    greedy request equal the port's mesh=None batcher's: the descriptors
    travel host to host and the collectives ride inside the programs."""
    got = _coord(runs, w)[f"mesh/{plan}/syncs"]
    want = _coord(runs, 1)[f"none/{plan}/syncs"]
    assert got == want and got[0] > 0


@pytest.mark.parametrize("w,plan", FULL, ids=full_ids)
def test_sharded_speculative_parity(runs, w, plan):
    """Speculative blocks (the draft's K+1 steps and the target's verify
    forward on every rank's heads) emit tpulab's stream; the draft's
    pages come home."""
    r = _coord(runs, w)
    _same_tokens(r[f"mesh/{plan}/spec"], "spec", runs)
    assert r[f"mesh/{plan}/spec_dispatches"] > 0
    free, total = r[f"mesh/{plan}/spec_free"]
    assert free == total


@pytest.mark.parametrize("w,plan", FULL, ids=full_ids)
def test_sharded_preempt_resume_through_host_tier(runs, w, plan):
    """A preempted lane's pages leave as one unsharded host snapshot
    (every rank's heads gathered to the coordinator) and come back
    scattered to their ranks: both streams are tpulab's, with no
    re-prefill (two prompt fills)."""
    r = _coord(runs, w)
    got = r[f"mesh/{plan}/preempt"]
    for want in _refs(runs, "preempt"):
        assert got == want
    preempts, outs, ins, fills = r[f"mesh/{plan}/preempt_counts"]
    assert preempts >= 1 and outs >= 1 and ins >= 1 and fills == 2


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_swap_payload_is_mesh_portable(runs, w):
    """The host tier holds UNSHARDED bytes: a page swapped out of an
    M-shard pool is the whole page, the same bits at M 1, 2 and 4 (so the
    payload taken out at M 2 is the one each pool restores); restored
    into its pool and into a mesh=None pool it is the same bits."""
    r = _coord(runs, w)
    payload = r["swap_payload"]
    assert r["swap_host"].shape == (2, 1, 2, 8, 4, 16)
    np.testing.assert_array_equal(r["swap_host"][:, 0], payload)
    np.testing.assert_array_equal(r["swap_host"],
                                  _coord(runs, 2)["swap_host"])
    np.testing.assert_array_equal(r["swap_restored"][:, 0], payload)
    np.testing.assert_array_equal(r["swap_single"], payload)


@pytest.mark.parametrize("w,when", [(2, "after"), (4, "before")])
def test_follower_failure_fails_the_mesh(runs, w, when):
    """A follower that raises inside a replicated decode block (after
    its collectives at M 2, before them at M 4) is fatal to the mesh:
    every request the coordinator held raises MeshFailure, none
    resolves with tokens, later submits raise, and every rank records
    the failure, the follower its own reason (no silent divergence, no
    hang)."""
    ranks = runs["port"][w]
    f = ranks[0]["fault"]
    assert len(f["futures"]) == 3
    for kind, msg in f["futures"]:
        assert kind == "MeshFailure", (kind, msg)
    assert f["submit_after"].startswith("MeshFailure")
    assert f["failure"] and all(r["fault"]["failure"] for r in ranks)
    assert any(f"follower rank {w - 1}: block failed: RuntimeError: "
               f"planted fault {when} the block" in r["fault"]["failure"]
               for r in ranks)


def test_a_rank_failure_reaches_every_rank_through_the_store(runs):
    """The last of four ranks fails a mesh channel while nothing is in
    flight: the coordinator's watcher reads its reason from the store,
    the coordinator publishes nothing more, and each follower asking for
    its next operation gets MeshFailure with that reason."""
    why = "planted failure of rank 3"
    ranks = [r["watch"] for r in runs["port"][4]]
    assert [r["failure"] for r in ranks] == [why] * 4
    assert ranks[0]["publish"] == f"MeshFailure: {why}"
    for r in ranks[1:3]:
        assert r["next"] == f"MeshFailure: {why}", r


@pytest.mark.parametrize("role", ["follower", "coordinator"])
def test_a_watcher_aborts_its_rank_on_another_ranks_failure(monkeypatch,
                                                             role):
    """Over NCCL a follower blocked in a collective learns nothing from
    the wire when another rank fails; its watcher reads the failure from
    the coordinator's store and aborts its own group, once.  The
    coordinator's watcher also publishes the abort every follower's
    replay reads next.  In process: a store, no process group."""
    import pickle
    import threading
    import types

    import torch.distributed as dist

    from tpulab_torch.engine import sharded

    aborted = []
    monkeypatch.setattr(sharded, "abort_group", aborted.append)
    server = dist.TCPStore("127.0.0.1", 0, None, True,
                           wait_for_workers=False)

    def client():
        return dist.TCPStore("127.0.0.1", server.port, None, False,
                             wait_for_workers=False)

    ch = sharded.MeshChannel.__new__(sharded.MeshChannel)
    coordinator = role == "coordinator"
    ch.__dict__.update(
        tp=types.SimpleNamespace(rank=0 if coordinator else 1, size=3,
                                 group="group"),
        coordinator=coordinator, n_followers=2, failure=None, _seq=0,
        _lock=threading.Lock(), _aborted=False, _closing=False,
        _store=server if coordinator else client())
    watcher = threading.Thread(target=ch._watch, args=(client(),))
    watcher.start()
    try:
        time.sleep(0.2)
        assert ch.failure is None and not aborted   # nothing failed yet
        why = "follower rank 2: block failed: RuntimeError: planted"
        client().set("failed", why)
        watcher.join(timeout=10)
        assert not watcher.is_alive()
        assert ch.failure == why and aborted == ["group"]
        ch.fail("a later reason")           # keeps the first, aborts once
        assert ch.failure == why and aborted == ["group"]
        if coordinator:
            for r in (1, 2):
                assert pickle.loads(server.get(f"{r}/1")) == (
                    "abort", (why,), {})
    finally:
        ch._closing = True
        watcher.join(timeout=5)


@pytest.mark.parametrize("w,plan", FULL, ids=full_ids)
def test_sharded_prefix_cache_and_chunked_prefill_parity(runs, w, plan):
    """Repeated, branched and chunk-prefilled prompts under the mesh:
    tpulab's tokens and hit count; pages balance."""
    r = _coord(runs, w)
    got = r[f"mesh/{plan}/prefix"]
    for want in _refs(runs, "prefix"):
        assert got == want
    hits = r[f"mesh/{plan}/prefix_hits"]
    assert hits == runs["jax"]["none"]["prefix_hits"] > 0
    assert hits == _coord(runs, 1)[f"none/{plan}/prefix_hits"]
    free, total = r[f"mesh/{plan}/prefix_free"]
    assert free == total


def test_benchmark_sharded_decode_row(runs):
    """The bench ``sharded_decode`` row at M 2: greedy and device-sampled
    parity with mesh=None, one blocking fetch per dispatch in both modes,
    tok/s present."""
    row = _coord(runs, 2)["bench"]
    assert row["parity"] is True
    assert row["sampled_parity"] is True
    assert row["one_sync_per_dispatch"] is True
    assert row["single"]["tok_s"] > 0 and row["sharded"]["tok_s"] > 0
    assert row["mesh"] == {"model": 2}
    assert row["sharded"]["busy"] is None       # not measured off the card
