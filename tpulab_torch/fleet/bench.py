"""The ``prefix_affinity`` and ``fleet_obs`` rows (the port of
``tpulab/fleet/bench.py``; tpulab's row fields).

``prefix_affinity``: fleet-wide TTFT and prefix-cache hit rate under a
zipfian multi-tenant trace, affinity ON vs OFF.

Three in-process loopback replicas (identical weights, prefix caches
armed) serve the SAME seeded trace twice: a zipf-popular set of prompt
prefixes, each request a hot prefix plus a unique suffix, submitted by a
small client pool.  Affinity OFF is today's least-loaded + round-robin
routing — a returning prefix lands on a random replica, so every
replica pays its own prefill for every hot prefix before the fleet
warms.  Affinity ON rendezvous-routes each prefix to one home, so the
fleet pays ~one miss per prefix total.

On the CPU the structural counts are the signal: fleet hit rate
(Δhits/Δlookups summed over replicas, caches cleared between modes)
strictly higher with affinity ON, no replica starved under the zipf
mix, spills counted when the hot prefix's home saturates.  On the card
the TTFT quantiles are — a prefix-cache hit skips the shared-page
prefill compute on the request path.

``fleet_obs``: the observability plane's overhead claim
(docs/OBSERVABILITY.md "Fleet observability") — the SAME online trace
over the same 3-replica loopback fleet with the observability plane
armed (FleetObserver fleetz scrapes refreshing the federated ``_fed_*``
gauges + an EventJournal appending per scrape) vs off.  Tracked: online
p99 TTFT/ITL flat within noise armed-vs-off (the plane rides the
existing Status/Debug RPCs off the request path), the per-scrape
wall-clock cost, and the journal append p99.
"""

from __future__ import annotations

import threading
import time
from typing import List


def benchmark_prefix_affinity(n_replicas: int = 3, n_requests: int = 36,
                              n_prefixes: int = 6, prefix_len: int = 16,
                              steps: int = 6, concurrency: int = 3,
                              seed: int = 0, device=None) -> dict:
    """The row at tpulab's small model (f32) on ``device`` (``None`` =
    the CUDA card)."""
    import numpy as np
    import torch

    import tpulab_torch
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.mnist import make_mnist
    from tpulab_torch.models.transformer import init_transformer_params
    from tpulab_torch.rpc.replica import GenerationReplicaSet

    device = resolve_device(device)
    params = init_transformer_params(vocab=128, d_model=32, n_heads=2,
                                     n_layers=2, d_ff=64, device=device)
    page = 8  # prefix_len=16 -> two full shared pages per hot prefix

    def serve():
        cb = ContinuousBatcher(params, n_heads=2, n_layers=2, lanes=2,
                               max_len=max(64, prefix_len + steps + 16),
                               page_size=page, prefix_cache=True,
                               compute_dtype=torch.float32, device=device)
        mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                            device=device)
        mgr.register_model("mnist", make_mnist(max_batch_size=1,
                                               device=device))
        mgr.update_resources()
        mgr.serve(port=0, generation_engines={"lm": cb})
        return mgr, cb

    fleet = [serve() for _ in range(n_replicas)]
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 128, (prefix_len,), np.int32)
                for _ in range(n_prefixes)]
    # zipf popularity over the prefixes; one tenant per prefix (the
    # multi-tenant shape: each tenant keeps returning with its context)
    weights = np.array([1.0 / (k + 1) ** 1.1 for k in range(n_prefixes)])
    weights /= weights.sum()
    trace = [(int(k), np.concatenate([prefixes[k],
                                      rng.integers(0, 128, (2,), np.int32)])
              .astype(np.int32))
             for k in rng.choice(n_prefixes, size=n_requests, p=weights)]

    out = {"n_replicas": n_replicas, "n_requests": n_requests,
           "n_prefixes": n_prefixes, "prefix_len": prefix_len,
           "steps": steps, "zipf_top_share": round(float(weights[0]), 3)}
    try:
        # warm every replica (streaming consumers take the K<=2 blocks)
        # so TTFT measures routing, not first-call cost
        warm = np.concatenate([prefixes[0],
                               rng.integers(0, 128, (2,), np.int32)])
        for _, cb in fleet:
            cb.submit(warm.astype(np.int32), steps,
                      on_token=lambda *a: None).result(timeout=300)
        expected = [int(t) for t in
                    fleet[0][1].submit(trace[0][1], steps)
                    .result(timeout=300)]
        addrs = [f"127.0.0.1:{m.server.bound_port}" for m, _ in fleet]

        def run_mode(affinity: bool) -> dict:
            for _, cb in fleet:  # identical cold-cache start per mode
                cb.prefix_cache.clear()
            h0 = [(cb.prefix_cache.hits, cb.prefix_cache.misses)
                  for _, cb in fleet]
            rs = GenerationReplicaSet(addrs, "lm",
                                      prefix_affinity=affinity,
                                      affinity_tokens=prefix_len,
                                      affinity_slack=2)
            ttfts: List[float] = []
            tl = threading.Lock()
            it = iter(list(trace))
            parity_ok = [True]

            def worker():
                while True:
                    with tl:
                        item = next(it, None)
                    if item is None:
                        return
                    _, prompt = item
                    t0 = time.perf_counter()
                    toks = []
                    for tok in rs.generate(prompt, steps, timeout=300):
                        if not toks:
                            with tl:
                                ttfts.append(time.perf_counter() - t0)
                        toks.append(int(tok))
                    if len(toks) != steps:
                        parity_ok[0] = False

            try:
                threads = [threading.Thread(target=worker, daemon=True)
                           for _ in range(concurrency)]
                t_run = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                wall = time.perf_counter() - t_run
                hits = sum(cb.prefix_cache.hits - h[0]
                           for (_, cb), h in zip(fleet, h0))
                misses = sum(cb.prefix_cache.misses - h[1]
                             for (_, cb), h in zip(fleet, h0))
                arr = np.asarray(sorted(ttfts))
                served = list(rs.served)
                mode = {
                    "hit_rate": round(hits / max(1, hits + misses), 3),
                    "prefix_hits": int(hits),
                    "prefix_misses": int(misses),
                    "ttft_ms_p50": round(float(np.quantile(arr, 0.5))
                                         * 1e3, 2) if arr.size else 0.0,
                    "ttft_ms_p99": round(float(np.quantile(arr, 0.99))
                                         * 1e3, 2) if arr.size else 0.0,
                    "req_s": round(n_requests / wall, 1),
                    "served": served,
                    "max_replica_share": round(max(served)
                                               / max(1, sum(served)), 3),
                    "complete": parity_ok[0] and sum(served) == n_requests,
                }
                if affinity:
                    mode.update(affinity_hits=rs.router.affinity_hits,
                                affinity_spills=rs.router.affinity_spills)
                # routing parity: the trace's first prompt decodes the
                # same tokens through the set as locally
                got = [int(t) for t in rs.generate(trace[0][1], steps)]
                mode["parity"] = got == expected
                return mode
            finally:
                rs.close()

        out["affinity_off"] = run_mode(False)
        out["affinity_on"] = run_mode(True)
        out["hit_rate_gain"] = round(
            out["affinity_on"]["hit_rate"]
            - out["affinity_off"]["hit_rate"], 3)
    finally:
        for m, _ in fleet:
            m.shutdown()
        for _, cb in fleet:
            cb.shutdown()
    return out


def benchmark_fleet_obs(n_replicas: int = 3, n_requests: int = 24,
                        steps: int = 6, concurrency: int = 3,
                        scrape_interval_s: float = 0.05,
                        seed: int = 0, device=None) -> dict:
    """Module docstring ``fleet_obs`` row: online tail latency with the
    fleet observability plane armed vs off, plus the plane's own costs
    (per-scrape wall clock, journal append p99), at tpulab's small model
    (f32) on ``device`` (``None`` = the CUDA card)."""
    import os
    import tempfile

    import numpy as np
    import torch

    import tpulab_torch
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.mnist import make_mnist
    from tpulab_torch.models.transformer import init_transformer_params
    from tpulab_torch.rpc.replica import GenerationReplicaSet

    device = resolve_device(device)
    params = init_transformer_params(vocab=128, d_model=32, n_heads=2,
                                     n_layers=2, d_ff=64, device=device)

    def serve():
        cb = ContinuousBatcher(params, n_heads=2, n_layers=2, lanes=2,
                               max_len=max(64, steps + 24), page_size=8,
                               compute_dtype=torch.float32, device=device)
        mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1,
                                            device=device)
        mgr.register_model("mnist", make_mnist(max_batch_size=1,
                                               device=device))
        mgr.update_resources()
        mgr.serve(port=0, generation_engines={"lm": cb})
        return mgr, cb

    fleet = [serve() for _ in range(n_replicas)]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 128, (8,), np.int32)
               for _ in range(n_requests)]
    out = {"n_replicas": n_replicas, "n_requests": n_requests,
           "steps": steps, "scrape_interval_s": scrape_interval_s}
    try:
        # warm every replica so the quantiles measure serving + (maybe)
        # observation, never first-call cost
        for _, cb in fleet:
            cb.submit(prompts[0], steps,
                      on_token=lambda *a: None).result(timeout=300)
        addrs = [f"127.0.0.1:{m.server.bound_port}" for m, _ in fleet]

        def run_mode(armed: bool) -> dict:
            from tpulab_torch.fleet.observer import FleetObserver
            from tpulab_torch.obs.journal import EventJournal
            from tpulab_torch.utils.metrics import FederationMetrics

            rs = GenerationReplicaSet(addrs, "lm")
            obs = journal = None
            jpath = None
            scrape_s: List[float] = []
            done = threading.Event()

            def scraper() -> None:
                while not done.wait(scrape_interval_s):
                    try:
                        snap = obs.fleetz()
                        scrape_s.append(snap["scrape_s"])
                        journal.record(
                            "fleetz_scrape", replicas=len(snap["replicas"]),
                            scrape_s=snap["scrape_s"])
                    except Exception:  # noqa: BLE001 - bench must finish
                        pass

            ttfts: List[float] = []
            itls: List[float] = []
            tl = threading.Lock()
            it = iter(list(enumerate(prompts)))
            complete = [0]

            def worker() -> None:
                while True:
                    with tl:
                        item = next(it, None)
                    if item is None:
                        return
                    _, prompt = item
                    t0 = time.perf_counter()
                    t_prev = None
                    n_tok = 0
                    for _tok in rs.generate(prompt, steps, timeout=300):
                        now = time.perf_counter()
                        with tl:
                            if t_prev is None:
                                ttfts.append(now - t0)
                            else:
                                itls.append(now - t_prev)
                        t_prev = now
                        n_tok += 1
                    if n_tok == steps:
                        with tl:
                            complete[0] += 1

            try:
                if armed:
                    fd, jpath = tempfile.mkstemp(suffix=".journal.jsonl")
                    os.close(fd)
                    journal = EventJournal(jpath, node="bench-observer")
                    obs = FleetObserver(rs, metrics=FederationMetrics())
                    threading.Thread(target=scraper, name="fleet-obs-bench",
                                     daemon=True).start()
                threads = [threading.Thread(target=worker, daemon=True)
                           for _ in range(concurrency)]
                t_run = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                wall = time.perf_counter() - t_run
                ta = np.asarray(sorted(ttfts))
                ia = np.asarray(sorted(itls))

                def q(arr, p):
                    return (round(float(np.quantile(arr, p)) * 1e3, 2)
                            if arr.size else 0.0)

                mode = {"ttft_ms_p50": q(ta, 0.5), "ttft_ms_p99": q(ta, 0.99),
                        "itl_ms_p50": q(ia, 0.5), "itl_ms_p99": q(ia, 0.99),
                        "req_s": round(n_requests / max(1e-6, wall), 1),
                        "complete": complete[0] == n_requests}
                if armed:
                    done.set()
                    # the cost figures must not depend on how many scrape
                    # periods the (short) workload happened to span: take
                    # a few measured scrapes on the idle fleet too
                    for _ in range(5):
                        snap = obs.fleetz()
                        scrape_s.append(snap["scrape_s"])
                        journal.record("fleetz_scrape",
                                       replicas=len(snap["replicas"]),
                                       scrape_s=snap["scrape_s"])
                    qs = journal.append_quantiles()
                    mode.update(
                        scrapes=len(scrape_s),
                        scrape_ms_mean=round(
                            float(np.mean(scrape_s)) * 1e3, 2)
                        if scrape_s else 0.0,
                        journal_events=len(journal.events()),
                        journal_append_us_p50=round(qs["p50"] * 1e6, 1),
                        journal_append_us_p99=round(qs["p99"] * 1e6, 1))
                return mode
            finally:
                done.set()
                if obs is not None:
                    obs.close()
                if journal is not None:
                    journal.close()
                if jpath is not None:
                    try:
                        os.unlink(jpath)
                    except OSError:
                        pass
                rs.close()

        out["off"] = run_mode(False)
        out["armed"] = run_mode(True)
        out["ttft_p99_ratio"] = round(
            out["armed"]["ttft_ms_p99"]
            / max(1e-6, out["off"]["ttft_ms_p99"]), 3)
        out["itl_p99_ratio"] = round(
            out["armed"]["itl_ms_p99"]
            / max(1e-6, out["off"]["itl_ms_p99"]), 3)
    finally:
        for m, _ in fleet:
            m.shutdown()
        for _, cb in fleet:
            cb.shutdown()
    return out
