"""The port's side of ``tests/test_torch_sharded_decode.py``: the
workloads both packages serve and the body each spawned gloo rank runs.
Kept apart from the test module so that a rank imports neither JAX nor
tpulab (every rank starts sooner)."""

import os
import threading

import numpy as np
import torch

from tpulab_torch.parallel import multihost

GEO = dict(n_heads=4, n_layers=2, page_size=8)
STEPS_TIMEOUT = 120


# ------------------------------------------------------------- workloads
def _prompts():
    rng = np.random.default_rng(5)
    greedy = [(rng.integers(0, 64, (n,), np.int32), s)
              for n, s in ((5, 20), (8, 17), (13, 30), (1, 9))]
    rng = np.random.default_rng(3)
    base = rng.integers(0, 64, (20,), np.int32)      # 2 full pages + 4
    branch = np.concatenate([base[:16], rng.integers(0, 64, (7,), np.int32)])
    long_p = rng.integers(0, 64, (37,), np.int32)    # 3 chunks of 16
    return {
        "greedy": greedy,
        "sampled": np.random.default_rng(6).integers(0, 64, (5,), np.int32),
        "logprobs": np.random.default_rng(12).integers(0, 64, (6,),
                                                       np.int32),
        "host": np.random.default_rng(2).integers(0, 64, (4,), np.int32),
        "dryrun": np.random.default_rng(0).integers(0, 64, (6,), np.int32),
        "spec": np.random.default_rng(4).integers(0, 64, (5,), np.int32),
        "low": np.random.default_rng(21).integers(0, 64, (12,), np.int32),
        "hi": np.random.default_rng(22).integers(0, 64, (5,), np.int32),
        "sync": np.random.default_rng(7).integers(0, 64, (5,), np.int32),
        "prefix": [(base, 16), (base, 16), (branch, 16), (long_p, 8)],
    }


def _main_workload(cb, sampling_cls, pr):
    """Greedy with page crossings, device-sampled, logprobs, host-sampled
    and the dry run's pair, queued whole before the scheduler takes its
    next pass: the batcher's condition (a re-entrant lock, in both
    packages) is held across the submits, so which requests share a
    round never depends on thread timing.  Tokens do not depend on the
    batch a request rides, but a logprob's last bits can (the CPU's
    matrix products round differently at another row count)."""
    with cb._cv:
        futs = {f"greedy{i}": cb.submit(p, s)
                for i, (p, s) in enumerate(pr["greedy"])}
        futs["sampled"] = cb.submit(pr["sampled"], 20, sampling=sampling_cls(
            temperature=0.9, seed=1234, device=True))
        futs["logprobs"] = cb.submit(pr["logprobs"], 12, logprobs=True)
        futs["host"] = cb.submit(pr["host"], 10, sampling=sampling_cls(
            temperature=0.8, top_k=8, seed=55))
        futs["dry_greedy"] = cb.submit(pr["dryrun"], 12)
        futs["dry_sampled"] = cb.submit(
            pr["dryrun"], 12, sampling=sampling_cls(
                temperature=0.8, seed=7, device=True))
    out = {}
    for k, f in futs.items():
        r = f.result(timeout=STEPS_TIMEOUT)
        if k == "logprobs":
            out[k] = [int(t) for t in r[0]]
            out["logprobs_lp"] = [float(x) for x in r[1]]
        else:
            out[k] = [int(t) for t in r]
    return out


def _preempt_workload(cb, pr):
    """A lane preempted to the host tier by a priority-10 arrival resumes
    with no re-prefill."""
    started = threading.Event()
    f_low = cb.submit(pr["low"], 10, on_token=lambda t, i: started.set())
    assert started.wait(timeout=STEPS_TIMEOUT)
    f_hi = cb.submit(pr["hi"], 4, priority=10)
    return {"hi": [int(t) for t in f_hi.result(timeout=STEPS_TIMEOUT)],
            "low": [int(t) for t in f_low.result(timeout=STEPS_TIMEOUT)]}


def _prefix_workload(cb, pr):
    return [[int(t) for t in cb.submit(p, s).result(timeout=STEPS_TIMEOUT)]
            for p, s in pr["prefix"]]


# ------------------------------------------------------ the port's ranks
def _tree(np_tree):
    from tpulab_torch.models.convert import tree_from_numpy
    return tree_from_numpy(np_tree, "cpu")


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError, RuntimeError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _serve_all(res, key, make, pr, plans, full_plans):
    """The main workload under ``plans`` (twice under the first), the
    others under ``full_plans``, on batchers ``make(**kw)`` (all ranks
    construct; the coordinator drives).  Keys ``{key}/{plan}/...``."""
    from tpulab_torch.engine.paged import SamplingParams
    from tpulab_torch.models.transformer import early_exit_draft

    for plan in plans:
        k = f"{key}/{plan}"
        ragged = plan == "ragged"
        for run in ("a", "b") if plan == plans[0] else ("a",):
            cb = make(ragged=ragged, lanes=2, max_len=64)
            try:
                if cb.is_coordinator:
                    res[f"{k}/main_{run}"] = _main_workload(
                        cb, SamplingParams, pr)
                    res[f"{k}/main_{run}_free"] = [cb.pool.free_pages,
                                                   cb.pool.n_pages - 1]
            finally:
                cb.shutdown()
        if plan not in full_plans:
            continue
        cb = make(ragged=ragged, lanes=1, max_len=96, n_pages=25,
                  draft_params=early_exit_draft(make.params, 1),
                  draft_n_layers=1)
        try:
            if cb.is_coordinator:
                res[f"{k}/spec"] = [int(t) for t in cb.submit(
                    pr["spec"], 24).result(timeout=STEPS_TIMEOUT)]
                res[f"{k}/spec_dispatches"] = cb.spec_dispatches
        finally:
            cb.shutdown()
        if cb.is_coordinator:
            res[f"{k}/spec_free"] = [cb.pool.free_pages, cb.pool.n_pages - 1]
        cb = make(ragged=ragged, lanes=1, max_len=64, kv_offload=32 << 20)
        try:
            if cb.is_coordinator:
                res[f"{k}/preempt"] = _preempt_workload(cb, pr)
                res[f"{k}/preempt_counts"] = [
                    cb.preemptions, cb.kv_offload.swap_outs,
                    cb.kv_offload.swap_ins, cb.prompt_fills]
        finally:
            cb.shutdown()
        cb = make(ragged=ragged, lanes=1, max_len=96, prefix_cache=True,
                  prefill_chunk=16)
        try:
            if cb.is_coordinator:
                res[f"{k}/prefix"] = _prefix_workload(cb, pr)
                res[f"{k}/prefix_hits"] = cb.prefix_cache.hits
        finally:
            cb.shutdown()
        if cb.is_coordinator:
            res[f"{k}/prefix_free"] = [cb.pool.free_pages,
                                       cb.pool.n_pages - 1]
        cb = make(ragged=ragged, lanes=1, max_len=64)
        try:
            if cb.is_coordinator:
                cb.submit(pr["sync"], 17).result(timeout=STEPS_TIMEOUT)
                s0, d0 = cb.decode_host_syncs, cb.decode_dispatches
                cb.submit(pr["sync"], 17).result(timeout=STEPS_TIMEOUT)
                res[f"{k}/syncs"] = [cb.decode_host_syncs - s0,
                                     cb.decode_dispatches - d0]
        finally:
            cb.shutdown()


class _Maker:
    """``ContinuousBatcher`` of the test's model on a mesh (or none)."""

    def __init__(self, params, mesh):
        self.params, self.mesh = params, mesh

    def __call__(self, **kw):
        from tpulab_torch.engine.paged import ContinuousBatcher
        return ContinuousBatcher(self.params, compute_dtype=torch.float32,
                                 device="cpu", mesh=self.mesh, **GEO, **kw)


def _swap_cases(mesh, res):
    """The mesh-portable swap payload: written into this launch's M-shard
    pool and swapped out (the host copy is the whole page: the same bytes
    at every M), then that host copy restored into another page of the
    pool and gathered back, and into a ``mesh=None`` pool."""
    from tpulab_torch.engine.paged import PagedKVPool
    from tpulab_torch.kvcache import HostKVStore, KVOffloadManager

    payload = np.random.default_rng(9).standard_normal(
        (2, 1, 2, 8, 4, 16)).astype(np.float32)
    pool = PagedKVPool(9, 8, 2, 4, 16, torch.float32, device="cpu",
                       mesh=mesh)
    local = list(pool.kv.shape)
    if not pool.coordinator:
        pool.follow()
        return local
    try:
        mgr = KVOffloadManager(pool, store=HostKVStore(32 << 20))
        page = pool.allocate_page()
        pool.scatter_pages([page], torch.from_numpy(payload))
        h = mgr.swap_out([page], 8, pool.kv)
        assert h is not None and mgr.drain()
        host = mgr.store.peek(h.key).clone()
        res["swap_host"] = host.numpy()
        back = mgr.adopt(("lane", 1), host.clone(), 8)
        page = pool.allocate_page()
        assert mgr.restore(back, [page], pool.kv) is not None
        res["swap_restored"] = pool.gather_pages([page]).numpy()
        mgr.close()
        # and into a pool with no mesh, on the coordinator alone
        single = PagedKVPool(9, 8, 2, 4, 16, torch.float32, device="cpu")
        mgr_b = KVOffloadManager(single, store=HostKVStore(32 << 20))
        h = mgr_b.adopt(("lane", 2), host.clone(), 8)
        page_b = single.allocate_page()
        assert mgr_b.restore(h, [page_b], single.kv) is not None
        res["swap_single"] = single.kv[:, page_b].numpy()
        mgr_b.close()
        res["swap_payload"] = payload[:, 0]
    finally:
        pool.stop_followers()
    return local


def _fault_case(rank, world, mesh, params, pr, when):
    """A fault planted in the last follower's first decode block,
    ``"after"`` its collectives or ``"before"`` them: the mesh fails,
    every request the coordinator holds raises (none resolves with
    tokens), and later submits raise.  Leaves the group aborted: the
    launch's last case."""
    from tpulab_torch.engine.paged import ContinuousBatcher

    if rank == world - 1:
        block = ContinuousBatcher._op_block

        def faulty(self, *a, **kw):
            if when == "after":
                block(self, *a, **kw)
            raise RuntimeError(f"planted fault {when} the block")
        ContinuousBatcher._op_block = faulty
    cb = _Maker(params, mesh)(ragged=True, lanes=2, max_len=64)
    out = {}
    try:
        if cb.is_coordinator:
            # two lanes busy and a third request queued behind them
            futs = [cb.submit(p, s) for p, s in pr["greedy"][:3]]
            got = []
            for f in futs:
                try:
                    got.append(["tokens", len(f.result(
                        timeout=STEPS_TIMEOUT))])
                except Exception as e:  # noqa: BLE001 - the outcome
                    got.append([type(e).__name__, str(e)])
            out["futures"] = got
            out["submit_after"] = _error(lambda: cb.submit(pr["sync"], 2))
    finally:
        cb.shutdown()
    out["failure"] = cb.mesh_failure
    return out


def _watch_case(rank, world):
    """The last rank fails a channel of its own group while no collective
    is in flight and nothing is published: the coordinator learns why
    from the channel's store (its watcher), refuses to publish, and each
    follower asking for its next operation gets the coordinator's abort.
    Aborts only that group."""
    import datetime
    import time
    import types

    import torch.distributed as dist

    from tpulab_torch.engine.sharded import MeshChannel

    group = dist.new_group(list(range(world)))
    ch = MeshChannel(types.SimpleNamespace(rank=rank, size=world,
                                           group=group))
    out = {"rank": rank}
    if rank == world - 1:
        ch.fail(f"planted failure of rank {rank}")
    elif rank == 0:
        t0 = time.monotonic()
        while ch.failure is None and time.monotonic() - t0 < 30:
            time.sleep(0.005)
        out["publish"] = _error(lambda: ch.publish("noop"))
    else:
        # the abort comes at once; never wait for it long
        ch._store.set_timeout(datetime.timedelta(seconds=30))
        out["next"] = _error(ch.next)
    out["failure"] = ch.failure
    dist.barrier()   # the coordinator's store outlives every read
    return out


def rank_cases(rank, world, store, out_dir, np_tree):
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    from tpulab_torch.engine.paged import (ContinuousBatcher, PagedKVPool,
                                           SamplingParams)
    from tpulab_torch.engine.sharded import benchmark_sharded_decode
    from tpulab_torch.hbm import HBMArbiter
    from tpulab_torch.parallel import make_mesh, named_sharding

    pr = _prompts()
    params = _tree(np_tree)
    mesh = make_mesh({"model": world})
    res = {}

    # placements: each rank's pool and weight shards
    cb = ContinuousBatcher(params, compute_dtype=torch.float32,
                           device="cpu", mesh=mesh, lanes=2, max_len=64,
                           **GEO)
    try:
        res["place"] = {
            "kv": list(cb.pool.kv.shape),
            "n_shards": cb.pool.n_shards,
            "per_shard": [cb.pool.hbm_bytes_per_shard,
                          cb.pool.hbm_bytes // world],
            "sharding": [repr(cb.pool.kv_sharding), repr(named_sharding(
                mesh, None, None, None, None, "model", None))],
            "wqkv": list(cb.params["layer0"]["wqkv"].shape),
            "wo": list(cb.params["layer0"]["wo"].shape),
            "w1": list(cb.params["layer0"]["w1"].shape),
            "embed": list(cb.params["embed"].shape),
            "ln1": list(cb.params["layer0"]["ln1"]["scale"].shape),
            "coordinator": cb.is_coordinator,
            "submit_err": (None if cb.is_coordinator else _error(
                lambda: cb.submit(pr["sync"], 2))),
        }
    finally:
        cb.shutdown()

    # refusals and bad geometry (raised before any collective)
    if world == 2:
        res["err_no_model_axis"] = _error(lambda: PagedKVPool(
            8, 8, 2, 2, 16, torch.float32, mesh=make_mesh({"data": 2})))
        res["err_geometry"] = _error(lambda: PagedKVPool(
            8, 8, 2, 3, 16, torch.float32, mesh=mesh))
        res["err_flash"] = _error(lambda: ContinuousBatcher(
            params, compute_dtype=torch.float32, mesh=mesh,
            prefill_flash=True, **GEO))
        res["err_hbm"] = _error(lambda: ContinuousBatcher(
            params, compute_dtype=torch.float32, mesh=mesh,
            hbm=HBMArbiter(1 << 30), **GEO))
        res["err_heads"] = _error(lambda: ContinuousBatcher(
            params, compute_dtype=torch.float32, mesh=mesh, n_heads=3,
            n_layers=2))
        other = PagedKVPool(17, 8, 2, 4, 8, torch.float32, mesh=mesh)
        res["err_foreign"] = _error(lambda: ContinuousBatcher(
            params, compute_dtype=torch.float32, pool=other, lanes=2,
            max_len=64, mesh=make_mesh({"model": 2}), **GEO))

    # every workload, sharded, under both plans; the port's own mesh=None
    # batcher on the coordinator as the host-sync baseline
    plans = ("ragged", "split")
    _serve_all(res, "mesh", _Maker(params, mesh), pr, plans,
               plans if world < 4 else plans[:1])
    if world == 1:
        _serve_all(res, "none", _Maker(params, None), pr, plans, plans)

    res["swap_pool_local"] = _swap_cases(mesh, res)

    if world == 2:
        row = benchmark_sharded_decode(model_shards=2, lanes=2, steps=16,
                                       prompt_len=6, d_model=32, n_heads=2,
                                       n_layers=2, vocab=64, mesh=mesh)
        if rank == 0:
            res["bench"] = row
    if world == 4:
        res["watch"] = _watch_case(rank, world)
    if world > 1:
        res["fault"] = _fault_case(rank, world, mesh, params, pr,
                                   "after" if world == 2 else "before")
    np.save(os.path.join(out_dir, f"res{rank}.npy"), res, allow_pickle=True)


# ------------------------------------------------- tests/test_torch_sharded_extras.py
PUB_STEPS = 8
SWAP_STEPS = 12


def extra_prompts():
    rng = np.random.default_rng(31)
    return {"pub": [rng.integers(0, 64, (n,), np.int32) for n in (13, 19)],
            "swap": rng.integers(0, 64, (9,), np.int32)}


def publish_workload(cb, prompts, digest_fn, timeout=STEPS_TIMEOUT):
    """Two distinct prompts and the first again on a publishing owner
    (greedy); returns the streams once every snapshot has landed."""
    import time

    toks = [[int(t) for t in cb.submit(p, PUB_STEPS).result(timeout=timeout)]
            for p in (prompts[0], prompts[1], prompts[0])]
    end = time.monotonic() + timeout
    for p in prompts:
        while ("fab", digest_fn(p)) not in cb.kv_offload.store:
            assert time.monotonic() < end, "a publish never landed"
            time.sleep(0.01)
    return toks


def swap_workload(mux, llm, other, serve, cold=None):
    """tpulab's multiplexer sequence over a batcher's adapter ``llm`` and a
    second servable of its size: the second's registration pushes the
    LLM out, an acquire brings it back (pushing the second out), and
    after the host tier loses the LLM's tree an acquire cold-rebuilds
    it.  Returns the states after each step, the LLM's streams before,
    after the swap and after the rebuild, and the counters."""
    out = {"tokens": [serve()], "states": []}

    def note():
        mux.drain()
        out["states"].append([mux.state_of(n) if n in mux else None
                              for n in ("llm", "other")])

    mux.register("llm", llm)
    out["param_bytes"] = llm.param_bytes()
    note()
    mux.register("other", other)
    note()
    out["resident_cold"] = llm.resident()
    if cold is not None:
        out["cold"] = cold()
    with mux.acquire("llm"):
        note()
        out["tokens"].append(serve())
    with mux.acquire("other"):
        note()
    mux.store.remove("llm")          # the host tier loses the tree
    with mux.acquire("llm"):
        note()
        out["tokens"].append(serve())
    out["counts"] = [mux.swap_outs, mux.swap_ins, mux.cold_rebuilds,
                     mux.evictions]
    return out


def _int8_shapes(params):
    return {k: {leaf: list(params["layer0"][k][leaf].shape)
                for leaf in ("w_int8", "scale")}
            for k in ("wqkv", "wo", "w1", "w2")}


def _int8_cases(res, world, mesh, params, qparams, pr, np_int8):
    """The int8 tree at ``{"model": world}`` under both plans, its shards'
    shapes, an int8 tree of replicated DTensors (tpulab's layout), and
    init_transformer_shards(quantize=True) against the whole tree
    quantized, then cut."""
    from tpulab_torch.engine.paged import SamplingParams
    from tpulab_torch.engine.sharded import (init_transformer_shards,
                                             local_params)
    from tpulab_torch.models.convert import shard_from_numpy
    from tpulab_torch.models.quantization import quantize_transformer_params
    from tpulab_torch.models.transformer import init_transformer_params
    from tpulab_torch.parallel import transformer_param_shardings

    make = _Maker(qparams, mesh)
    for plan in ("ragged", "split") if world < 4 else ("ragged",):
        cb = make(ragged=plan == "ragged", lanes=2, max_len=64)
        try:
            res["int8_shapes"] = _int8_shapes(cb.params)
            if cb.is_coordinator:
                res[f"int8/{plan}"] = _main_workload(cb, SamplingParams, pr)
                res[f"int8/{plan}/free"] = [cb.pool.free_pages,
                                            cb.pool.n_pages - 1]
        finally:
            cb.shutdown()
    if world == 4:
        return
    dt = shard_from_numpy(np_int8, mesh,
                          transformer_param_shardings(np_int8, mesh))
    cb = _Maker(dt, mesh)(lanes=2, max_len=64)
    try:
        same = all(torch.equal(cb.params["layer0"][k][leaf], want)
                   for k, sub in _int8_local(qparams, mesh).items()
                   for leaf, want in sub.items())
        res["int8_replicated_dtensor"] = [same, _int8_shapes(cb.params)]
        if cb.is_coordinator:
            res["int8_replicated_tokens"] = [int(t) for t in cb.submit(
                pr["greedy"][2][0], 20).result(timeout=STEPS_TIMEOUT)]
    finally:
        cb.shutdown()
    geo = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               seed=3, n_kv_heads=2, ffn="swiglu", tie_embeddings=False,
               dtype=torch.float32)
    drawn = init_transformer_shards(mesh, **geo, quantize=True)
    whole = quantize_transformer_params(init_transformer_params(
        **{k: v for k, v in geo.items() if k != "dtype"}, device="cpu",
        dtype=torch.float32))
    want = local_params(whole, mesh, "cpu")
    got = local_params(drawn, mesh, "cpu")
    flat = []
    _pairs(got, want, flat)
    res["int8_drawn_equal"] = [len(flat), all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in flat)]


def _int8_local(qparams, mesh):
    from tpulab_torch.engine.sharded import local_params
    layer = local_params(qparams, mesh, "cpu")["layer0"]
    return {k: layer[k] for k in ("wqkv", "wo", "w1", "w2")}


def _pairs(a, b, out):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _pairs(a[k], b[k], out)
    else:
        out.append((a, b))


def _publish_cases(res, world, mesh, params, pr_pub):
    """A ``{"model": world}`` split-plan owner publishes; its blobs pull
    into a mesh=None batcher on the coordinator; a mesh=None owner's
    blobs pull into a ``{"model": world}`` batcher."""
    from tpulab_torch.disagg import KVShipper
    from tpulab_torch.disagg.wire import deserialize_snapshot, prompt_digest
    from tpulab_torch.kvfabric import fabric_export

    def owner(m):
        return _Maker(params, m)(ragged=False, lanes=1, max_len=64,
                                 kv_offload=32 << 20, kv_publish=True)

    def pull(cb, blobs):
        streams = []
        for p, blob in zip(pr_pub, blobs):
            ship = KVShipper(cb.kv_offload).import_shipment(blob)
            assert ship is not None, "the shipment was refused"
            streams.append([int(t) for t in cb.submit_shipped(
                p, PUB_STEPS, ship.first_token, ship.handle).result(
                    timeout=STEPS_TIMEOUT)])
        return streams, cb.prefill_dispatches

    cb = owner(mesh)
    try:
        if cb.is_coordinator:
            res["pub/owner"] = publish_workload(cb, pr_pub, prompt_digest)
            res["pub/kv_publishes"] = cb.kv_publishes
            blobs = [fabric_export(cb, prompt_digest(p)) for p in pr_pub]
            snaps = [deserialize_snapshot(b) for b in blobs]
            res["pub/snap"] = [(arr.numpy(), header) for arr, header in snaps]
            res["pub/blob_len"] = [len(b) for b in blobs]
    finally:
        cb.shutdown()
    single_blobs = None
    if cb.is_coordinator:
        puller = _Maker(params, None)(lanes=1, max_len=64,
                                      kv_offload=32 << 20)
        try:
            res["pub/pull_single"] = pull(puller, blobs)
        finally:
            puller.shutdown()
        single = owner(None)
        try:
            publish_workload(single, pr_pub, prompt_digest)
            single_blobs = [fabric_export(single, prompt_digest(p))
                            for p in pr_pub]
        finally:
            single.shutdown()
    puller = _Maker(params, mesh)(lanes=1, max_len=64, kv_offload=32 << 20)
    try:
        if puller.is_coordinator:
            res["pub/pull_mesh"] = pull(puller, single_blobs)
    finally:
        puller.shutdown()


def _weight_swap_cases(res, world, mesh, params, np_tree, prompt):
    """swap_workload over a ``{"model": world}`` batcher and a mesh=None
    batcher of the same tree on the coordinator; every follower records
    its weights and host copy as it replays each swap."""
    import functools

    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.modelstore import BatcherAdapter, WeightMultiplexer

    seen = []
    orig_out = ContinuousBatcher._op_weights_out
    orig_in = ContinuousBatcher._op_weights_in

    def weights_out(self):
        orig_out(self)
        seen.append(["out", self.params is None,
                     self._host_params is not None])

    def weights_in(self, builder=None):
        orig_in(self, builder)
        seen.append(["in", self.params is not None,
                     self._host_params is None, builder is not None])

    ContinuousBatcher._op_weights_out = weights_out
    ContinuousBatcher._op_weights_in = weights_in
    builder = functools.partial(_tree, np_tree)
    cb = _Maker(params, mesh)(lanes=1, max_len=64)
    try:
        if cb.is_coordinator:
            other = _Maker(_tree(np_tree), None)(lanes=1, max_len=64)
            mux = WeightMultiplexer(cb.tree_bytes * 3 // 2)
            try:
                res["swap"] = swap_workload(
                    mux, BatcherAdapter(cb, builder),
                    BatcherAdapter(other, builder),
                    lambda: [int(t) for t in cb.submit(
                        prompt, SWAP_STEPS).result(timeout=STEPS_TIMEOUT)],
                    cold=lambda: cb.params is None)
                res["swap/lambda"] = _error(lambda: BatcherAdapter(
                    cb, lambda: np_tree))
            finally:
                mux.close()
                other.shutdown()
    finally:
        cb.shutdown()
        ContinuousBatcher._op_weights_out = orig_out
        ContinuousBatcher._op_weights_in = orig_in
    res["swap/follower"] = seen


def extras_cases(rank, world, store, out_dir, np_tree, np_int8):
    """One rank of ``tests/test_torch_sharded_extras.py``'s launch of
    ``world`` ranks: int8 trees, the fabric owner and pullers, and the
    weight swaps under ``{"model": world}``."""
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    from tpulab_torch.parallel import make_mesh

    mesh = make_mesh({"model": world})
    params, qparams = _tree(np_tree), _tree(np_int8)
    ex = extra_prompts()
    res = {}
    _int8_cases(res, world, mesh, params, qparams, _prompts(), np_int8)
    if world < 4:
        _publish_cases(res, world, mesh, params, ex["pub"])
        _weight_swap_cases(res, world, mesh, params, np_tree, ex["swap"])
    np.save(os.path.join(out_dir, f"res{rank}.npy"), res, allow_pickle=True)
