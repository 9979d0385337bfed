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
    except (ValueError, NotImplementedError, RuntimeError) as e:
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
        res["err_kv_publish"] = _error(lambda: ContinuousBatcher(
            params, compute_dtype=torch.float32, mesh=mesh, kv_offload=True,
            kv_publish=True, **GEO))
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
