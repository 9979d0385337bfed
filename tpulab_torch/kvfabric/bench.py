"""The ``kv_fabric`` row (the port of ``tpulab/kvfabric/bench.py``;
tpulab's row fields): fleet-effective prefix reuse with the KV fabric ON
vs OFF when routing accuracy is gone.

Three in-process loopback replicas (identical weights, prefix caches +
host KV tiers armed, publish on, the split plan — ``ragged=False``: the
ragged plan publishes nothing) serve a zipfian multi-tenant trace in
two phases.  Phase 1 — affinity still working — serves each hot prompt
once AT ITS HOME replica (the same HRW rank the router computes), which
publishes the finished prefill to the fabric.  Phase 2 — affinity
degraded — round-robins every returning request across the fleet, the
spill/hedge/re-home shape where routing-level affinity stops helping:
almost every request lands astray.

Fabric OFF is today's behavior: an astray repeat only reuses pages its
landing replica happens to hold, so the fleet re-pays each hot prefix
per replica.  Fabric ON, the astray replica pulls the prefix from its
home over FetchKV and admits it with zero local prefill dispatches.

The tracked claim: **fleet-effective hit rate** — shared-prefix pages
NOT recomputed over pages that could have been shared, counting a
pulled request's cacheable pages exactly as a fully-hit local lookup
would — is strictly higher with the fabric ON, and above the ~0.83
routing-level ceiling tpulab measured WITH affinity working (the fabric
recovers warmth routing can no longer deliver).  Token parity is
asserted between modes (pulled streams are bit-exact).  On the CPU the
hit/pull structure is the signal; on the card the TTFT gap is (a pull
replaces a whole prefill on the request path)."""

from __future__ import annotations

import time
from typing import List


def benchmark_kv_fabric(n_replicas: int = 3, n_prefixes: int = 5,
                        n_requests: int = 24, prefix_len: int = 16,
                        steps: int = 4, seed: int = 0,
                        device=None) -> dict:
    """The row at tpulab's small model (f32) on ``device`` (``None`` =
    the CUDA card)."""
    import numpy as np
    import torch

    import tpulab_torch
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.disagg import prompt_digest as content_digest
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.fleet.router import PrefixAffinityRouter, prefix_digest
    from tpulab_torch.kvfabric import KVFabric
    from tpulab_torch.models.transformer import init_transformer_params
    from tpulab_torch.rpc.infer_service import (GenerateStreamClient,
                                                RemoteInferenceManager)

    device = resolve_device(device)
    params = init_transformer_params(vocab=128, d_model=32, n_heads=2,
                                     n_layers=2, d_ff=64, device=device)
    page = 8
    rng = np.random.default_rng(seed)
    # exact-repeat prompts (the fabric keys on the full-prompt digest):
    # a hot prefix plus a FIXED per-tenant suffix, zipf popularity
    prompts = [np.concatenate([
        rng.integers(0, 128, (prefix_len,), np.int32),
        rng.integers(0, 128, (2,), np.int32)]).astype(np.int32)
        for _ in range(n_prefixes)]
    weights = np.array([1.0 / (k + 1) ** 1.1 for k in range(n_prefixes)])
    weights /= weights.sum()
    trace = [int(k) for k in rng.choice(n_prefixes, size=n_requests,
                                        p=weights)]
    cacheable = (len(prompts[0]) - 1) // page  # pages a full hit shares

    def run_mode(fabric_on: bool) -> dict:
        routers = [PrefixAffinityRouter(affinity_tokens=prefix_len)
                   for _ in range(n_replicas)]
        members: List[str] = []
        fleet = []
        for r in range(n_replicas):
            cb = ContinuousBatcher(
                params, n_heads=2, n_layers=2, lanes=2,
                max_len=max(64, prefix_len + steps + 16), page_size=page,
                prefix_cache=True, kv_offload=32 << 20, kv_publish=True,
                ragged=False, compute_dtype=torch.float32, device=device)
            fab = None
            if fabric_on:
                # cost_gate off: on the CPU fixture model recomputing an
                # 18-token prefill is genuinely cheaper than the wire, so
                # the gate (unit-tested separately) would hide the
                # warmth-recovery structure this row tracks
                fab = KVFabric("pending", lambda: list(members),
                               lambda a: RemoteInferenceManager(a),
                               routers[r], cost_gate=False)
            mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                                device=device)
            mgr.serve(port=0, generation_engines={"lm": cb}, kvfabric=fab)
            addr = f"127.0.0.1:{mgr.server.bound_port}"
            if fab is not None:
                fab.self_key = addr
            fleet.append((mgr, cb, fab, addr))
        members.extend(a for _, _, _, a in fleet)
        by_addr = {a: (mgr, cb, fab) for mgr, cb, fab, a in fleet}
        clients = {a: RemoteInferenceManager(a) for a in members}
        try:
            ranker = routers[0]
            homes = [ranker.ranked(prefix_digest(p, prefix_len),
                                   members)[0] for p in prompts]
            # phase 1: affinity working — each hot prompt serves once at
            # its home (prefills, publishes); reference streams for parity
            expected = []
            for p, home in zip(prompts, homes):
                expected.append(list(GenerateStreamClient(
                    clients[home], "lm").generate(p, steps)))
            if fabric_on:  # wait out the publish write-behind
                deadline = time.monotonic() + 30
                for p, home in zip(prompts, homes):
                    cb = by_addr[home][1]
                    while (("fab", content_digest(p))
                           not in cb.kv_offload.store):
                        if time.monotonic() > deadline:
                            raise RuntimeError("publish never settled")
                        time.sleep(0.01)
            h0 = [(cb.prefix_cache.hits, cb.prefix_cache.misses)
                  for _, cb, _, _ in fleet]
            pf0 = [cb.prefill_dispatches for _, cb, _, _ in fleet]
            # phase 2: affinity degraded — returning requests round-robin
            # the fleet (the spill/hedge/re-home shape), parity-checked
            parity = True
            ttfts: List[float] = []
            t_run = time.perf_counter()
            for i, k in enumerate(trace):
                addr = members[i % n_replicas]
                t0 = time.perf_counter()
                toks = []
                for tok in GenerateStreamClient(
                        clients[addr], "lm").generate(prompts[k], steps):
                    if not toks:
                        ttfts.append(time.perf_counter() - t0)
                    toks.append(int(tok))
                parity = parity and toks == expected[k]
            wall = time.perf_counter() - t_run
            hits = sum(cb.prefix_cache.hits - h[0]
                       for (_, cb, _, _), h in zip(fleet, h0))
            misses = sum(cb.prefix_cache.misses - h[1]
                         for (_, cb, _, _), h in zip(fleet, h0))
            pulls = sum(f.snapshot()["pulls"] for _, _, f, _ in fleet
                        if f is not None)
            degrades = sum(f.snapshot()["degrades"] for _, _, f, _ in fleet
                           if f is not None)
            pull_bytes = sum(f.snapshot()["pull_bytes"]
                             for _, _, f, _ in fleet if f is not None)
            # a pulled request shares its cacheable pages exactly as a
            # fully-hit local lookup would — the routing row's units
            shared = hits + pulls * cacheable
            total = hits + misses + pulls * cacheable
            arr = np.asarray(sorted(ttfts))
            return {
                "effective_hit_rate": round(shared / max(1, total), 3),
                "prefix_hits": int(hits), "prefix_misses": int(misses),
                "pulls": int(pulls), "pull_degrades": int(degrades),
                "pull_bytes": int(pull_bytes),
                "prefills_phase2": int(sum(
                    cb.prefill_dispatches - p0
                    for (_, cb, _, _), p0 in zip(fleet, pf0))),
                "ttft_ms_p50": round(float(np.quantile(arr, 0.5)) * 1e3, 2)
                if arr.size else 0.0,
                "ttft_ms_p99": round(float(np.quantile(arr, 0.99)) * 1e3, 2)
                if arr.size else 0.0,
                "req_s": round(n_requests / wall, 1),
                "parity": parity,
            }
        finally:
            for c in clients.values():
                c.close()
            for mgr, cb, fab, _ in fleet:
                if fab is not None:
                    fab.close()
                mgr.shutdown()
                cb.shutdown()

    out = {"n_replicas": n_replicas, "n_prefixes": n_prefixes,
           "n_requests": n_requests, "prompt_len": int(len(prompts[0])),
           "steps": steps, "cacheable_pages": int(cacheable),
           "zipf_top_share": round(float(weights[0]), 3),
           # tpulab's routing-level ceiling, measured WITH affinity on —
           # the bar the fabric clears with affinity degraded
           "routing_affinity_baseline_hit_rate": 0.83}
    out["fabric_off"] = run_mode(False)
    out["fabric_on"] = run_mode(True)
    out["hit_rate_gain"] = round(
        out["fabric_on"]["effective_hit_rate"]
        - out["fabric_off"]["effective_hit_rate"], 3)
    out["beats_routing_baseline"] = (
        out["fabric_on"]["effective_hit_rate"]
        > out["routing_affinity_baseline_hit_rate"])
    return out
