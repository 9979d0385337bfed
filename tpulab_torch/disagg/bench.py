"""The ``disagg`` row: ITL p99 and goodput under a prefill-heavy trace,
disaggregated prefill / decode against one unified pool (the port of
``tpulab/disagg/bench.py``; tpulab's row fields).

Prompts much longer than their decodes arrive while earlier requests are
still decoding.  Unified, every arrival's prefill runs on the scheduler
that owes the resident lanes their next token, so decode ticks stall
behind prompt-sized forwards.  Disaggregated, a prefill batcher absorbs
the prompt work and ships the finished KV in the host tier's wire form
(:class:`~tpulab_torch.disagg.shipper.KVShipper`); the decode batcher
admits by restoring the shipment (zero prefill dispatches), and its
decode cadence never queues behind a prefill.  Both batchers take the
split plan (``ragged=False``), tpulab's default at this max_len.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict

import numpy as np


def benchmark_disagg(lanes: int = 2, n_requests: int = 8,
                     prompt_len: int = 48, steps: int = 8,
                     page_size: int = 8, d_model: int = 64,
                     n_heads: int = 4, n_layers: int = 2,
                     vocab: int = 256, dtype=None, params=None,
                     device=None) -> Dict[str, Any]:
    """Run the prefill-heavy trace both ways on ``device`` (``None`` = the
    CUDA card) and report per mode ITL p50 / p99 (ms between consecutive
    streamed tokens of a request), goodput (requests/s) and dispatch
    accounting, plus cross-mode greedy token parity."""
    import torch

    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.disagg.shipper import KVShipper
    from tpulab_torch.disagg.wire import prompt_digest
    from tpulab_torch.engine.paged import ContinuousBatcher, _bench_tree

    dtype = dtype or torch.float32
    dev = resolve_device(device)
    max_len = prompt_len + steps + page_size
    params = _bench_tree(params, dev, vocab, d_model, n_heads, n_layers,
                         4 * d_model)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (prompt_len,), np.int32)
               for _ in range(n_requests)]
    warm = rng.integers(0, vocab, (prompt_len,), np.int32)

    def make_cb():
        return ContinuousBatcher(
            params, n_heads=n_heads, n_layers=n_layers, lanes=lanes,
            max_len=max_len, page_size=page_size, compute_dtype=dtype,
            ragged=False, device=dev, kv_offload=True)

    def run_trace(submit_one, warmup):
        """Drive every request concurrently; per-request token stamps feed
        the ITL distribution."""
        warmup()
        stamps = [[] for _ in prompts]
        tokens = [None] * len(prompts)
        threads = []
        t0 = time.perf_counter()

        def one(i):
            tokens[i] = submit_one(
                i, lambda _t, _j, i=i: stamps[i].append(
                    time.perf_counter()))

        for i in range(len(prompts)):
            threads.append(threading.Thread(target=one, args=(i,)))
            threads[-1].start()
        for th in threads:
            th.join(timeout=600)
        wall = max(1e-6, time.perf_counter() - t0)
        gaps = [b - a for ts in stamps for a, b in zip(ts, ts[1:])]
        entry = {
            "goodput_rps": len(prompts) / wall,
            "wall_s": wall,
            "itl_ms_p50": 1e3 * float(np.percentile(gaps, 50)),
            "itl_ms_p99": 1e3 * float(np.percentile(gaps, 99)),
        }
        return entry, tokens

    def unified():
        cb = make_cb()
        try:
            entry, tokens = run_trace(
                lambda i, cb_tok: list(cb.submit(
                    prompts[i], steps, on_token=cb_tok).result(timeout=600)),
                lambda: cb.submit(warm, steps).result(timeout=600))
            entry["prefill_dispatches"] = cb.prefill_dispatches
            return entry, tokens
        finally:
            cb.shutdown()

    def disagg():
        bp, bd = make_cb(), make_cb()
        ship_out, ship_in = KVShipper(bp.kv_offload), KVShipper(bd.kv_offload)
        try:
            pf0 = [0]

            def warmup():
                bp.submit(warm, 1).result(timeout=600)
                bd.submit(warm, steps).result(timeout=600)
                pf0[0] = bd.prefill_dispatches  # post-warm baseline

            def one(i, cb_tok):
                dig = prompt_digest(prompts[i])
                fut = bp.submit(prompts[i], 1, export_digest=dig)
                first = fut.result(timeout=600)[0]
                blob = ship_out.export(
                    getattr(fut, "_tpulab_kv_export", None),
                    digest=dig, first_token=first)
                ship = (ship_in.import_shipment(blob)
                        if blob is not None else None)
                if ship is not None:
                    f2 = bd.submit_shipped(prompts[i], steps, first,
                                           ship.handle, on_token=cb_tok)
                else:  # lost shipment: the decode side prefills locally
                    f2 = bd.submit(prompts[i], steps, on_token=cb_tok)
                return list(f2.result(timeout=600))

            entry, tokens = run_trace(one, warmup)
            entry.update(
                decode_prefill_dispatches=bd.prefill_dispatches - pf0[0],
                shipments=ship_out.exports,
                ship_failures=(ship_out.export_failures
                               + ship_in.import_failures),
                ship_mb=ship_out.bytes_out / 2**20)
            return entry, tokens
        finally:
            bp.shutdown()
            bd.shutdown()

    u_entry, u_tokens = unified()
    d_entry, d_tokens = disagg()
    return {
        "lanes": lanes, "n_requests": n_requests,
        "prompt_len": prompt_len, "steps": steps,
        "unified": u_entry, "disagg": d_entry,
        "token_parity": u_tokens == d_tokens,
    }
