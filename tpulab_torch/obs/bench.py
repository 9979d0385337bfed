"""The ``obs_overhead`` row: what does arming the observability plane cost
the serving hot path?  (The port of ``tpulab/obs/bench.py``; tpulab's
row fields.)

One burst of greedy requests runs through a fresh ``ContinuousBatcher``
per run on identical prompts, alternating bare and armed runs.  Armed
means the whole plane at once: a flight recorder on ``flight=``, a
``ChromeTraceRecorder`` on ``trace=``, a ``GenerationMetrics`` on
``metrics=`` polled, a debugz poller pulling live snapshots every
``debug_poll_s`` (an operator dashboard polling Debug while traffic
flows) and a running ``DeviceWatchdog``.  Reported: tok/s bare and armed
and the overhead per pair, token parity and whether the two runs
dispatched alike (``dispatch_kinds`` and ``forward_steps`` over the
burst; ``forward_steps_total`` counts every forward of every run), the
flight records observed and retained, the record-assembly cost, the
snapshot's time and its hold of the scheduler lock, and the watchdog's
canaries.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["benchmark_obs_overhead"]

#: the armed runs' watchdog canary period (seconds)
WATCHDOG_PERIOD_S = 0.05
#: the longest a request may take before the row fails
TIMEOUT_S = 300.0


def _q(vals: List[float]) -> Dict[str, float]:
    vals = sorted(vals)
    if not vals:
        return {"p50": 0.0, "p99": 0.0, "max": 0.0}
    return {"p50": vals[len(vals) // 2],
            "p99": vals[min(len(vals) - 1, int(0.99 * len(vals)))],
            "max": vals[-1]}


def benchmark_obs_overhead(n_requests: int = 16, steps: int = 32,
                           lanes: int = 4, prompt_len: int = 8,
                           vocab: int = 256, d_model: int = 64,
                           n_heads: int = 4, n_layers: int = 2,
                           d_ff: int = 256,
                           debug_poll_s: float = 0.02, *,
                           params=None, n_kv_heads: Optional[int] = None,
                           rope_theta: Optional[float] = None,
                           page_size: int = 8, pairs: int = 1,
                           device=None, dtype=None) -> Dict[str, Any]:
    """The row at tpulab's small default model, or at any width: pass
    ``params`` (a tree on ``device`` of ``vocab`` rows, ``n_layers`` /
    ``n_heads`` / ``n_kv_heads`` / ``rope_theta`` describing it) to
    serve an existing model.  ``device=None`` is the CUDA card;
    ``dtype`` (default f32) is the compute dtype.  ``pairs`` bare/armed
    pairs run in the order bare, armed, bare, armed, ..."""
    import numpy as np
    import torch

    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import init_transformer_params
    from tpulab_torch.obs.debugz import debug_snapshot
    from tpulab_torch.obs.flight import FlightRecorder
    from tpulab_torch.utils.metrics import GenerationMetrics
    from tpulab_torch.utils.tracing import ChromeTraceRecorder
    from tpulab_torch.utils.watchdog import DeviceWatchdog

    device = resolve_device(device)
    dtype = dtype or torch.float32
    if params is None:
        params = init_transformer_params(vocab=vocab, d_model=d_model,
                                         n_heads=n_heads, n_layers=n_layers,
                                         d_ff=d_ff, device=device,
                                         dtype=dtype)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (prompt_len,), np.int32)
               for _ in range(n_requests)]
    kw = dict(n_heads=n_heads, n_layers=n_layers, n_kv_heads=n_kv_heads,
              lanes=lanes, max_len=prompt_len + steps + 8,
              page_size=page_size, compute_dtype=dtype, device=device)
    if rope_theta is not None:
        kw["rope_theta"] = rope_theta

    def run(armed: bool) -> Dict[str, Any]:
        fr = FlightRecorder() if armed else None
        tr = ChromeTraceRecorder() if armed else None
        gm = GenerationMetrics() if armed else None
        cb = ContinuousBatcher(params, flight=fr, trace=tr, metrics=gm,
                               **kw)
        wd = None
        stop = threading.Event()
        polls: Dict[str, list] = {"snap": [], "lock": []}

        def poller():  # the operator-dashboard shape: Debug while serving
            while not stop.is_set():
                t0 = time.perf_counter()
                debug_snapshot(generation_engines={"llm": cb}, flight=fr,
                               watchdog=wd)
                polls["snap"].append(time.perf_counter() - t0)
                polls["lock"].append(cb.debug_lock_hold_s)
                gm.poll(cb)
                stop.wait(debug_poll_s)

        try:
            # warm every program shape OUT of the measured window
            cb.submit(prompts[0], steps).result(timeout=TIMEOUT_S)
            th = None
            if armed:
                wd = DeviceWatchdog(device=device,
                                    period_s=WATCHDOG_PERIOD_S,
                                    deadline_s=5.0).start()
                th = threading.Thread(target=poller, daemon=True)
                th.start()
            kinds0 = dict(cb.dispatch_kinds)
            fs0 = cb.forward_steps
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with cb._cv:   # one pass admits the burst: the same schedule
                futs = [cb.submit(p, steps) for p in prompts]
            toks = [f.result(timeout=TIMEOUT_S) for f in futs]
            wall = time.perf_counter() - t0
            if th is not None:
                stop.set()
                th.join(timeout=5)
            out = {"tok_s": n_requests * steps / wall, "wall_s": wall,
                   "tokens": toks,
                   "dispatch": ({k: cb.dispatch_kinds[k] - kinds0.get(k, 0)
                                 for k in cb.dispatch_kinds},
                                cb.forward_steps - fs0),
                   "debug_polls": len(polls["snap"]),
                   "forward_steps_total": cb.forward_steps}
            if armed:
                out.update(
                    records_observed=fr.observed_total,
                    records_retained=len(fr), assembly=list(fr._assembly_s),
                    snap=polls["snap"], lock=polls["lock"],
                    trace_events=len(tr), canaries=wd.canaries,
                    last_canary_s=wd.last_canary_s,
                    healthy=wd.healthy)
            return out
        finally:
            stop.set()
            if wd is not None:
                wd.stop()
            cb.shutdown()

    rows = []
    last_on = None
    forward_steps = 0
    assembly: List[float] = []
    snaps: List[float] = []
    locks: List[float] = []
    for _ in range(max(1, int(pairs))):
        off = run(False)
        on = last_on = run(True)
        forward_steps += (off["forward_steps_total"]
                          + on["forward_steps_total"])
        assembly += on["assembly"]
        snaps += on["snap"]
        locks += on["lock"]
        rows.append({
            "tok_s_off": round(off["tok_s"], 2),
            "tok_s_on": round(on["tok_s"], 2),
            "overhead_pct": round(
                100.0 * (off["tok_s"] - on["tok_s"]) / max(1e-9,
                                                           off["tok_s"]), 2),
            "parity": off["tokens"] == on["tokens"],
            "same_dispatch": off["dispatch"] == on["dispatch"],
            "dispatch_off": off["dispatch"], "dispatch_on": on["dispatch"],
            "tokens_off": off["tokens"], "tokens_on": on["tokens"]})
    tok_off = sum(r["tok_s_off"] for r in rows) / len(rows)
    tok_on = sum(r["tok_s_on"] for r in rows) / len(rows)
    aq, sq, lq = _q(assembly), _q(snaps), _q(locks)
    row = {"n_requests": n_requests, "steps": steps, "lanes": lanes,
           "tok_s_off": round(tok_off, 2), "tok_s_on": round(tok_on, 2),
           "overhead_pct": round(100.0 * (tok_off - tok_on)
                                 / max(1e-9, tok_off), 2),
           "parity": all(r["parity"] for r in rows),
           "debug_polls": last_on["debug_polls"],
           "records_observed": last_on["records_observed"],
           "records_retained": last_on["records_retained"],
           "assembly_ms_p50": round(aq["p50"] * 1e3, 4),
           "assembly_ms_p99": round(aq["p99"] * 1e3, 4),
           "snapshot_ms_p50": round(sq["p50"] * 1e3, 4),
           "snapshot_ms_p99": round(sq["p99"] * 1e3, 4),
           "lock_hold_ms_p50": round(lq["p50"] * 1e3, 4),
           "lock_hold_ms_p99": round(lq["p99"] * 1e3, 4),
           "lock_hold_ms_max": round(lq["max"] * 1e3, 4),
           "trace_events": last_on["trace_events"],
           "canaries": last_on["canaries"],
           "last_canary_ms": (None if last_on["last_canary_s"] is None
                              else round(last_on["last_canary_s"] * 1e3, 4)),
           "watchdog_healthy": last_on["healthy"],
           "forward_steps_total": forward_steps,
           "pairs": rows}
    if not row["parity"]:
        row["parity_note"] = "TOKEN MISMATCH armed vs off — investigate"
    return row
