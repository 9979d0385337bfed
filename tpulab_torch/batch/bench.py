"""The ``batch_soak`` row: device-utilization lift from the offline batch
lane under a diurnal online trace, lane ON vs OFF (the port of
``tpulab/batch/bench.py``; tpulab's row fields).

One continuous batcher serves a seeded diurnal online trace — bursts of
concurrent streaming requests separated by idle valleys (the shape a
fleet paid for 24/7 actually sees).  Lane OFF is today's behavior: the
valleys are wasted capacity.  Lane ON runs a
:class:`~tpulab_torch.batch.BatchScheduler` soaking the valleys with a bulk
job; every burst preempts the batch lane (it is the first victim by
construction) and the valley resumes it.

The claims tracked: total tokens/s strictly higher with the lane ON
(the soak), online p99 TTFT/ITL flat within noise under the SAME online
trace (preemptible work must not tax the interactive path), batch
preemptions > 0 (the bursts really did evict the lane), and the
preempted job's output bit-exact vs an uncontended run of the same job
(in-engine preempt/resume is exact — tiered-KV swap or re-prefill).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List


def benchmark_batch_soak(lanes: int = 2, steps: int = 12,
                         n_cycles: int = 4, idle_s: float = 0.3,
                         n_batch_items: int = 24, prompt_len: int = 8,
                         seed: int = 0, device=None) -> dict:
    """The row at tpulab's small model (f32) on ``device`` (``None`` =
    the CUDA card)."""
    import numpy as np
    import torch

    from tpulab_torch.batch import BatchJob, BatchScheduler
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import init_transformer_params

    device = resolve_device(device)
    params = init_transformer_params(vocab=128, d_model=32, n_heads=2,
                                     n_layers=2, d_ff=64, device=device)
    rng = np.random.default_rng(seed)
    online_prompts = [rng.integers(0, 128, (prompt_len,), np.int32)
                      for _ in range(n_cycles * lanes)]
    batch_prompts = [rng.integers(0, 128, (prompt_len,), np.int32)
                     for _ in range(n_batch_items)]
    job_kw = dict(steps=steps, temperature=0.7, device_sampling=True,
                  seed=1234)

    def make_engine() -> ContinuousBatcher:
        return ContinuousBatcher(
            params, n_heads=2, n_layers=2, lanes=lanes,
            max_len=max(64, prompt_len + steps + 16), page_size=8,
            decode_block=8, compute_dtype=torch.float32, device=device)

    def warm(cb: ContinuousBatcher) -> None:
        # run every block size the trace dispatches once before the
        # measured window: streaming-only lanes take the K<=2 blocks (with
        # queue pressure the adaptive K would stay high), a lone
        # batch-class submit the K=8 block and its K=4 tail
        futs = [cb.submit(online_prompts[0], steps,
                          on_token=lambda *a: None) for _ in range(lanes)]
        for f in futs:
            f.result(timeout=600)
        cb.submit(batch_prompts[0], steps,
                  request_class="batch").result(timeout=600)

    def online_trace(cb: ContinuousBatcher) -> dict:
        """The diurnal trace: n_cycles bursts of ``lanes`` concurrent
        streaming requests, each followed by an idle valley."""
        ttfts: List[float] = []
        itls: List[float] = []
        tokens = [0]
        lock = threading.Lock()
        first_tokens: Dict[int, int] = {}

        def one(idx: int) -> None:
            t0 = time.perf_counter()
            last = [t0]
            got = []

            def on_token(tok, i):
                now = time.perf_counter()
                with lock:
                    if not got:
                        ttfts.append(now - t0)
                    else:
                        itls.append(now - last[0])
                    tokens[0] += 1
                got.append(int(tok))
                last[0] = now

            cb.submit(online_prompts[idx], steps,
                      on_token=on_token).result(timeout=600)
            with lock:
                first_tokens[idx] = got[0]

        t_run = time.perf_counter()
        for c in range(n_cycles):
            threads = [threading.Thread(
                target=one, args=(c * lanes + k,), daemon=True)
                for k in range(lanes)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            time.sleep(idle_s)  # the valley the lane exists to soak
        wall = time.perf_counter() - t_run
        arr = np.asarray(sorted(ttfts))
        iarr = np.asarray(sorted(itls))

        def q(a, p):
            return round(float(np.quantile(a, p)) * 1e3, 2) if a.size \
                else 0.0
        return {"wall_s": round(wall, 3), "online_tokens": tokens[0],
                "ttft_ms_p50": q(arr, 0.5), "ttft_ms_p99": q(arr, 0.99),
                "itl_ms_p50": q(iarr, 0.5), "itl_ms_p99": q(iarr, 0.99),
                "first_tokens": dict(first_tokens)}

    out = {"lanes": lanes, "steps": steps, "n_cycles": n_cycles,
           "idle_s": idle_s, "n_batch_items": n_batch_items}

    # -- lane OFF: the online trace alone (valleys wasted) -------------------
    cb = make_engine()
    try:
        warm(cb)
        off = online_trace(cb)
        off["total_tokens_s"] = round(off["online_tokens"]
                                      / off["wall_s"], 1)
    finally:
        cb.shutdown()

    # -- uncontended batch reference (parity target) -------------------------
    cb = make_engine()
    try:
        warm(cb)
        sched = BatchScheduler(cb)
        ref = sched.run(BatchJob("soak-ref", batch_prompts, **job_kw),
                        timeout_s=600)
        ref_results = ref["results"]
    finally:
        cb.shutdown()

    # -- lane ON: same online trace + the soak -------------------------------
    cb = make_engine()
    try:
        warm(cb)
        sched = BatchScheduler(cb)
        report = {}

        def soak() -> None:
            report.update(sched.run(
                BatchJob("soak", batch_prompts, **job_kw), timeout_s=600))

        worker = threading.Thread(target=soak, daemon=True)
        worker.start()
        on = online_trace(cb)
        batch_tokens_in_window = sched.tokens_delivered
        worker.join(timeout=600)  # the job drains in the trailing idle
        on["batch_tokens_in_window"] = int(batch_tokens_in_window)
        on["total_tokens_s"] = round(
            (on["online_tokens"] + batch_tokens_in_window)
            / on["wall_s"], 1)
        out["batch_preemptions"] = report.get("batch_preemptions", 0)
        out["batch_items_done"] = report.get("items_done", 0)
        # a preempted job's output is bit-exact vs the uncontended run
        out["batch_parity"] = (
            report.get("interrupted") is None
            and {k: v for k, v in report.get("results", {}).items()}
            == ref_results)
    finally:
        cb.shutdown()

    # the online stream itself is unchanged by the lane (greedy picks)
    out["online_parity"] = off["first_tokens"] == on["first_tokens"]
    off.pop("first_tokens")
    on.pop("first_tokens")
    out["lane_off"] = off
    out["lane_on"] = on
    out["tokens_s_lift"] = round(
        on["total_tokens_s"] / max(1e-9, off["total_tokens_s"]), 3)
    return out
