#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpulab_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each reported on its own lines; any failure raises and the
script exits non-zero without printing a result:

1. device  — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.  TF32 is switched off for matmuls and cuDNN.
2. build   — the kernel source ``tpulab_torch/ops/csrc/ragged_attention.cu``
   compiled by ``nvcc``.
3. kernels — the kernel's wrapper on the card at the serving geometry
   (Hq 32, Hkv 8, D 128, page 16, 8 lanes x 128 pages) held against its
   plain PyTorch version, with the tolerance set by the output dtype
   (f32 rtol = atol = 1e-4; bf16 rtol 8e-3, one bf16 ulp, atol 4e-3).
   At 2048 context the same check must REJECT the plain version with
   one page skipped, so the tolerance is tight enough to catch that.
   Kernel, plain, bound and ``F.scaled_dot_product_attention`` (a
   labelled yardstick over the pre-gathered context; the port never
   calls it) times per case.
4. invariants — at full width with 2 layers: ``paged_decode_block(k=8)``
   equals 8 chained ``paged_decode_step`` calls bit for bit (tokens,
   logprobs, pool), and ``paged_mixed_step`` equals
   ``paged_ragged_forward`` + the device pick.
5. serve   — a ``ContinuousBatcher`` at the full width of
   Meta-Llama-3-8B (32 layers, random bf16 weights from a seed) serves
   greedy / stop-token / device-sampled / logprobs / host-sampled
   requests and one that arrives mid-stream; checks lengths, ranges,
   dispatch kinds, kernel launches == n_layers x forward steps, and that
   a second identical run gives identical greedy and device-sampled
   streams.  Prints tokens/s and time to first token.

The line before the last is the kernels JSON, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Meta-Llama-3-8B's config.json geometry (random weights)
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_heads=32, n_kv_heads=8,
                 d_ff=14336, n_layers=32, rope_theta=500000.0)
SERVE = dict(lanes=8, max_len=2048, page_size=16, decode_block=8,
             prefill_chunk=256)
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; f32 FMA
# (rtol, atol) by the OUTPUT dtype.  Both sides read the same K/V values
# and sum in f32; only the order differs (f32: ~1e-6 measured).  A bf16
# output is rounded at the end on both sides, so a last-place flip
# (2^-8 to 2^-7 relative) is the expected difference; rtol 8e-3 allows
# one and atol 4e-3 covers outputs near zero (1.95e-3 measured).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 4e-3)}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing
class Timer:
    """CUDA-event timing of single launches with the 50 MB L2 flushed in
    between (outside the timed span): each launch finds K/V cold, as a
    layer of a real step does.  A short device spin before the start
    event keeps the wrapper's host-side cost out of the measured span."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)    # ~0.5 ms: the host enqueues fn
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


# ---------------------------------------------------------------- phase 3
RA_GEOM = dict(hq=32, hkv=8, d=128, s=16, b=8, mp=128)


def ra_cases():
    """(name, q_lens, kv_lens) at 8 lanes, pages of 16, 128 pages a lane."""
    return [
        ("all_decode", [1] * 8, [1024] * 8),
        ("all_prefill", [256] * 8, [256] * 8),
        ("chunk_over_ctx", [256] * 8, [1024] * 8),
        ("mixed", [1, 256, 5, 0, 1, 100, 1, 17],
         [1024, 1280, 37, 0, 2000, 600, 16, 33]),
        ("verify", [5] * 8, [5, 21, 200, 512, 1024, 1500, 2000, 2048]),
        ("page_cross", [4, 4, 1, 1, 16, 16, 3, 2],
         [18, 32, 17, 16, 48, 16, 33, 64]),
        ("long_decode", [1] * 8, [2048] * 8),
    ]


def ra_bound(q_lens, kv_lens, m, q_es, kv_es, kind):
    """Least time for the work: K/V rows each lane's queries can see plus
    valid q rows read once, the whole output written once; operations
    4*D*Hq per (query, visible key) pair."""
    g = RA_GEOM
    kv_bytes = sum(kv if q else 0 for q, kv in zip(q_lens, kv_lens)) \
        * g["hkv"] * g["d"] * 2 * kv_es
    q_bytes = sum(q_lens) * g["hq"] * g["d"] * q_es
    out_bytes = g["b"] * m * g["hq"] * g["d"] * q_es
    meta = g["b"] * g["mp"] * 4 + 2 * g["b"] * 4
    nbytes = kv_bytes + q_bytes + out_bytes + meta
    pairs = sum(kv - q + j + 1 for q, kv in zip(q_lens, kv_lens)
                for j in range(q))
    ops = 4 * g["d"] * g["hq"] * pairs
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def phase_kernels(torch, timer):
    import numpy as np
    import torch.nn.functional as F

    from tpulab_torch.ops.ragged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)

    g = RA_GEOM
    rng = np.random.default_rng(0)
    n_pages = g["b"] * g["mp"] + 1
    pool32 = torch.from_numpy(rng.standard_normal(
        (n_pages, 2, g["s"], g["hkv"], g["d"])).astype(np.float32)).cuda()
    # scattered page ids, as a long-running pool hands them out
    tables = torch.from_numpy(
        (rng.permutation(n_pages - 1) + 1).astype(np.int32).reshape(
            g["b"], g["mp"])).cuda()
    rows = []
    for dname, q_dt, kv_dt in (("bf16/bf16", torch.bfloat16, torch.bfloat16),
                               ("f32/f32", torch.float32, torch.float32),
                               ("f32/bf16", torch.float32, torch.bfloat16)):
        pool = pool32.to(kv_dt)
        kind = "bf16" if (q_dt, kv_dt) == (torch.bfloat16,
                                           torch.bfloat16) else "f32"
        rtol, atol = TOL[str(q_dt).split(".")[-1]]
        for name, q_lens_l, kv_lens_l in ra_cases():
            m = max(q_lens_l)
            q = torch.from_numpy(rng.standard_normal(
                (g["b"], m, g["hq"], g["d"])).astype(np.float32)).cuda()
            q = q.to(q_dt)
            q_lens = torch.tensor(q_lens_l, dtype=torch.int32, device="cuda")
            kv_lens = torch.tensor(kv_lens_l, dtype=torch.int32,
                                   device="cuda")
            args = (q, pool, tables, q_lens, kv_lens)
            got = ragged_paged_attention(*args)
            torch.cuda.synchronize()
            want = ragged_paged_attention_reference(*args)
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                                atol=atol)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(
                    f"kernel != plain: {name} {dname} max_abs_err={err} "
                    f"rtol={rtol} atol={atol}")
            if name == "long_decode":
                planted_skip_rejected(torch, got, args, rtol, atol, dname)
            ms = timer(lambda: ragged_paged_attention(*args), iters=20)
            plain_ms = timer(lambda: ragged_paged_attention_reference(*args),
                             iters=3, warmup=1)
            # yardstick: SDPA over the pre-gathered, GQA-expanded context
            # with an additive causal/length mask (gather not timed)
            t = g["mp"] * g["s"]
            ctx = pool[tables.long()]
            kd = ctx[:, :, 0].reshape(g["b"], t, g["hkv"], g["d"])
            vd = ctx[:, :, 1].reshape(g["b"], t, g["hkv"], g["d"])
            rep = g["hq"] // g["hkv"]
            kd = kd.repeat_interleave(rep, 2).transpose(1, 2).to(q_dt)
            vd = vd.repeat_interleave(rep, 2).transpose(1, 2).to(q_dt)
            qd = q.transpose(1, 2)
            pos = (kv_lens - q_lens)[:, None] + torch.arange(m,
                                                             device="cuda")
            vis = ((torch.arange(t, device="cuda")[None, None] <= pos[..., None])
                   & (torch.arange(t, device="cuda")[None, None]
                      < kv_lens[:, None, None]))
            mask = torch.zeros(vis.shape, dtype=q_dt, device="cuda")
            mask = mask.masked_fill(~vis, -1e30)[:, None]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask), iters=5)
            del ctx, kd, vd, mask
            bound_ms, bound_by, nbytes, ops = ra_bound(
                q_lens_l, kv_lens_l, m, q.element_size(), pool.element_size(),
                kind)
            row = dict(case=name, dtypes=dname, max_abs_err=err,
                       rtol=rtol, atol=atol,
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms, bytes=nbytes,
                       ops=ops)
            rows.append(row)
            log(f"kernels: ragged_paged_attention {name:<15} {dname:<9} "
                f"err={err:.2e} (rtol {rtol:g} atol {atol:g}) "
                f"kernel={ms:.4f} ms "
                f"plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms "
                f"({bound_by}) | reference line, not used by the port: "
                f"sdpa_dense={lib_ms:.4f} ms")
        del pool
    return rows


def planted_skip_rejected(torch, got, args, rtol, atol, dname):
    """The comparison must fail for a kernel that skipped one page: the
    plain version over every lane's context with page 5 taken out of
    the table (and the length cut by a page) is what such a kernel would
    return at decode.  Raises if the tolerance would let it pass."""
    from tpulab_torch.ops.ragged_attention import \
        ragged_paged_attention_reference

    q, pool, tables, q_lens, kv_lens = args
    skip = torch.cat([tables[:, :5], tables[:, 6:], tables[:, :1]], 1)
    want = ragged_paged_attention_reference(q, pool, skip, q_lens,
                                            kv_lens - RA_GEOM["s"])
    shift = (got.float() - want.float()).abs().max().item()
    if torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{dname}: the tolerance passes a kernel that "
                             f"skips a page (max shift {shift:.2e})")
    log(f"kernels: planted skipped page at 2048 context, {dname}: max "
        f"shift {shift:.2e}, rejected at rtol {rtol:g} atol {atol:g}")


# ---------------------------------------------------------------- phase 4
def phase_invariants(torch):
    import numpy as np

    from tpulab_torch.engine.paged import (PagedKVPool, paged_decode_block,
                                           paged_decode_step,
                                           paged_mixed_step,
                                           paged_ragged_forward)
    from tpulab_torch.engine.prng import device_sample_tokens
    from tpulab_torch.models.transformer import init_transformer_params

    c = LLAMA3_8B
    n_layers = 2
    params = init_transformer_params(
        c["vocab"], c["d_model"], c["n_heads"], n_layers, c["d_ff"], seed=1,
        n_kv_heads=c["n_kv_heads"], ffn="swiglu", tie_embeddings=False,
        device="cuda", dtype=torch.bfloat16)
    kw = dict(n_heads=c["n_heads"], n_layers=n_layers,
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16)
    b, mp, s = 8, 128, 16
    pool = PagedKVPool(b * mp + 1, s, n_layers, c["n_kv_heads"],
                       c["d_model"] // c["n_heads"], torch.bfloat16, "cuda")
    rng = np.random.default_rng(2)
    tables = torch.arange(1, b * mp + 1, dtype=torch.int32,
                          device="cuda").reshape(b, mp)
    q_lens_l = [40, 200, 5, 256, 17, 90, 130, 64]
    seq = torch.from_numpy(rng.integers(0, c["vocab"], (b, 256))).cuda()
    q_lens = torch.tensor(q_lens_l, device="cuda")
    kv_lens = q_lens.clone()
    temps = torch.tensor([0, .8, 0, 1., 0, .7, 0, 0], device="cuda")
    seeds = torch.from_numpy(rng.integers(0, 2**32, (b, 2))).cuda()
    with torch.inference_mode():
        kv_c, kv_d = pool.kv, pool.kv.clone()
        nt, lp, last = paged_mixed_step(params, kv_c, tables, seq, q_lens,
                                        kv_lens, temps, seeds, **kw)
        last2 = paged_ragged_forward(params, kv_d, tables, seq, q_lens,
                                     kv_lens, last_only=True, **kw)
        nt2 = device_sample_tokens(last2, temps, seeds, kv_lens - 1)
        # page 0 is scratch: invalid positions of every lane collide
        # there in an unspecified order, so live pages are compared
        diff = [n for n, same in (
            ("logits", torch.equal(last, last2)),
            ("tokens", torch.equal(nt, nt2)),
            ("pool", torch.equal(kv_c[:, 1:], kv_d[:, 1:]))) if not same]
        if diff:
            raise AssertionError("paged_mixed_step != paged_ragged_forward "
                                 f"+ device pick: {diff}")
        del kv_d
        rem = torch.tensor([8, 3, 8, 8, 5, 8, 8, 8], device="cuda")
        stops = torch.full((b, 2), -1, dtype=torch.long, device="cuda")
        stops[2, 0] = int(nt[2])        # lane 2 stops when it repeats
        active = torch.ones(b, dtype=torch.bool, device="cuda")
        kv_a, kv_b = kv_c.clone(), kv_c.clone()
        blk = paged_decode_block(params, kv_a, tables, kv_lens, nt, active,
                                 temps, seeds, rem, stops, k=8, **kw)
        lens, toks, live, r = kv_lens.long(), nt.long(), active, rem.long()
        for j in range(8):
            t, lpj, _ = paged_decode_step(params, kv_b, tables, lens, toks,
                                          live, temps=temps, seeds=seeds,
                                          **kw)
            t = torch.where(live, t, toks)
            same = (torch.equal(blk[0][:, j], t)
                    and torch.equal(blk[1][:, j], lpj)
                    and torch.equal(blk[2][:, j], live))
            if not same:
                raise AssertionError(f"K-block != chained steps at step {j}")
            lens, r, toks = lens + live.long(), r - live.long(), t
            live = live & (r > 0) & ~(t[:, None] == stops).any(1)
        if not torch.equal(kv_a[:, 1:], kv_b[:, 1:]):
            raise AssertionError("K-block pool != chained-steps pool")
        if not (torch.isfinite(blk[1]).all() and (blk[1] <= 0).all()
                and (blk[0] >= 0).all() and (blk[0] < c["vocab"]).all()):
            raise AssertionError("decode block emitted invalid tokens")
    emitted = blk[2].sum(1).tolist()
    log(f"invariants: full width, {n_layers} layers: K-block(k=8) == 8 "
        f"chained steps bit for bit (emitted per lane {emitted}); "
        "mixed step == ragged forward + device pick")
    pool.close()
    del params, kv_a, kv_b, kv_c
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5
def device_breakdown(torch, prof, wall_s, card):
    """Device time by kernel (torch.profiler, CUDA activity) over one
    serve run: the classes attention / matmul / other, the top kernels,
    and the device's busy share of the run's wall time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) / 1e3
    classes = {"attention (ragged_attn_kernel)": 0.0, "matmul": 0.0,
               "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        cls = ("attention (ragged_attn_kernel)" if "ragged_attn" in n
               else "matmul" if any(w in n for w in (
                   "gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas"))
               else "other")
        classes[cls] += dev_ms(e)
    busy = sum(classes.values())
    top = sorted(kernels, key=dev_ms, reverse=True)[:10]
    out = dict(wall_ms=wall_s * 1e3, device_busy_ms=busy,
               busy_share=busy / (wall_s * 1e3), classes=classes,
               top=[(e.key[:90], e.count, dev_ms(e)) for e in top])
    log(f"profile: serve run 3 wall {wall_s * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * out['busy_share']:.1f}%) [{card}]")
    for cls, ms in classes.items():
        log(f"profile:   {cls:<32} {ms:10.1f} ms "
            f"({100 * ms / max(busy, 1e-9):.1f}% of device time)")
    for name, count, ms in out["top"]:
        log(f"profile:   {ms:10.1f} ms {count:6d}x {name}")
    return out


class Metrics:
    """The batcher's metrics hook: collects TTFT and end-to-end latency."""

    def __init__(self):
        self.ttft, self.e2e = [], []

    def observe_ttft(self, s):
        self.ttft.append(s)

    def observe_e2e(self, s):
        self.e2e.append(s)

    def observe_itl(self, s):
        pass

    def observe_queue_wait(self, s):
        pass

    def note_deadline_expired(self):
        pass


def serve_once(torch, cb, prompts, stop_token, ra):
    """Submit the request mix; returns (outputs dict, stats)."""
    from tpulab_torch.engine.paged import SamplingParams

    futs = {}
    late = {}

    def trigger(tok, i):            # runs on the scheduler thread
        if i == 0 and "late" not in late:
            late["late"] = cb.submit(prompts["late"], 48)

    specs = [
        ("greedy_stop", prompts[5], 40, dict(stop_tokens=(
            [stop_token] if stop_token is not None else None))),
        ("device_a", prompts[64], 48, dict(sampling=SamplingParams(
            temperature=0.8, seed=1234, device=True))),
        ("device_b", prompts[300], 48, dict(sampling=SamplingParams(
            temperature=0.8, seed=99, device=True))),
        ("stream_trigger", prompts[700], 32, dict(on_token=trigger)),
        ("host_topk", prompts[1000], 32, dict(sampling=SamplingParams(
            temperature=0.9, top_k=50, seed=5))),
        ("greedy_logprobs", prompts[1500], 40, dict(logprobs=True)),
    ]
    ra.launches = 0
    f0 = cb.forward_steps
    kinds0 = dict(cb.dispatch_kinds)
    tok0 = cb.tokens_generated
    t0 = time.perf_counter()
    # submit the mix atomically (the scheduler's lock is re-entrant), so
    # both runs schedule identical rounds
    with cb._cv:
        for name, prompt, steps, kw in specs:
            futs[name] = cb.submit(prompt, steps, **kw)
    outs = {name: f.result(timeout=900) for name, f in futs.items()}
    while "late" not in late:
        time.sleep(0.001)
    outs["late"] = late["late"].result(timeout=900)
    wall = time.perf_counter() - t0
    launches = ra.launches
    fwd = cb.forward_steps - f0
    kinds = {k: cb.dispatch_kinds[k] - kinds0[k] for k in kinds0}
    stats = dict(wall_s=wall, tokens=cb.tokens_generated - tok0,
                 launches=launches, forward_steps=fwd, kinds=kinds,
                 steps={name: s for name, _, s, _ in specs} | {"late": 48})
    return outs, stats


def phase_serve(torch, card, profile=False):
    import numpy as np

    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import Transformer, \
        init_transformer_params
    from tpulab_torch.ops import ragged_attention as ra_mod

    ra = ra_mod.ragged_paged_attention
    c = LLAMA3_8B
    t0 = time.perf_counter()
    model = Transformer(init_transformer_params(
        c["vocab"], c["d_model"], c["n_heads"], c["n_layers"], c["d_ff"],
        seed=0, n_kv_heads=c["n_kv_heads"], ffn="swiglu",
        tie_embeddings=False, device="cuda", dtype=torch.bfloat16),
        n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
        rope_theta=c["rope_theta"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: Llama-3-8B geometry, {n_params / 1e9:.3f} B params bf16, "
        f"random init {time.perf_counter() - t0:.1f} s")
    metrics = Metrics()
    cb = ContinuousBatcher(model, n_heads=c["n_heads"],
                           n_layers=c["n_layers"],
                           n_kv_heads=c["n_kv_heads"],
                           rope_theta=c["rope_theta"],
                           compute_dtype=torch.bfloat16, device="cuda",
                           metrics=metrics, **SERVE)
    log(f"serve: pool {cb.pool.n_pages} pages, "
        f"{cb.pool.hbm_bytes / 1e9:.3f} GB; weights "
        f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.3f} GB")
    rng = np.random.default_rng(7)
    prompts = {n: rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in (5, 64, 300, 700, 1000, 1500)}
    prompts["late"] = rng.integers(0, c["vocab"], (64,)).astype(np.int32)
    try:
        # run 1 picks the stop token: greedy_stop's 9th token
        out1, st1 = serve_once(torch, cb, prompts, None, ra)
        stop = out1["greedy_stop"][8]
        runs = []
        for i in range(2):
            metrics.ttft.clear()
            metrics.e2e.clear()
            torch.cuda.synchronize()
            if profile and i == 1:
                from torch.profiler import ProfilerActivity
                with torch.profiler.profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out, st = serve_once(torch, cb, prompts, stop, ra)
                device_breakdown(torch, prof, st["wall_s"], card)
            else:
                out, st = serve_once(torch, cb, prompts, stop, ra)
            st["ttft_s"] = sorted(metrics.ttft)
            runs.append((out, st))
    finally:
        cb.shutdown()
    (out2, st2), (out3, st3) = runs
    vocab = c["vocab"]
    for name, toks in out2.items():
        toks = toks[0] if isinstance(toks, tuple) else toks
        want = st2["steps"][name]
        if name == "greedy_stop":
            cut = out1[name].index(stop) + 1
            if toks != out1[name][:cut]:
                raise AssertionError("stop token did not end greedy_stop "
                                     "where the unstopped run emits it")
        elif len(toks) != want:
            raise AssertionError(f"{name}: {len(toks)} tokens, want {want}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{name}: token outside [0, vocab)")
    lps = out2["greedy_logprobs"][1]
    if not all(math.isfinite(x) and x <= 0 for x in lps):
        raise AssertionError("logprobs must be finite and <= 0")
    # runs 2 and 3 are the same requests scheduled into the same rounds;
    # run 1 (no stop token) schedules differently once greedy_stop would
    # have stopped, so only its prefix up to the stop is compared above
    for name in ("greedy_stop", "device_a", "device_b", "greedy_logprobs",
                 "stream_trigger", "late"):
        if out2[name] != out3[name]:
            raise AssertionError(f"{name}: the second run differs")
    for st in (st2, st3):
        if st["kinds"]["mixed"] <= 0 or st["kinds"]["decode"] <= 0:
            raise AssertionError(f"dispatch kinds {st['kinds']}")
        if st["launches"] != c["n_layers"] * st["forward_steps"]:
            raise AssertionError(
                f"kernel launches {st['launches']} != n_layers x forward "
                f"steps {c['n_layers']} x {st['forward_steps']}")
    tok_s = st2["tokens"] / st2["wall_s"]
    ttft = st2["ttft_s"]
    log(f"serve: {len(out2)} requests, {st2['tokens']} tokens in "
        f"{st2['wall_s']:.3f} s = {tok_s:.1f} tok/s; TTFT "
        f"min {ttft[0] * 1e3:.1f} / median {ttft[len(ttft) // 2] * 1e3:.1f} "
        f"/ max {ttft[-1] * 1e3:.1f} ms; dispatches {st2['kinds']}; "
        f"forward steps {st2['forward_steps']}; kernel launches "
        f"{st2['launches']} = {c['n_layers']} x {st2['forward_steps']} "
        f"[{card}]")
    log(f"serve: second identical run {st3['wall_s']:.3f} s, "
        f"{st3['tokens'] / st3['wall_s']:.1f} tok/s; greedy and "
        "device-sampled streams identical")
    return st2


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace serve run 3 with torch.profiler and print "
                         "device time by kernel class")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tpulab_torch.cuda.platform import card_name_and_power_limit
    from tpulab_torch.ops import _build

    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power_limit(0)
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, capability "
        f"{torch.cuda.get_device_capability(0)}; TF32 off for matmul and "
        "cuDNN")

    # phase 2: build the kernel
    path, secs, nvlog = _build.compile_library("ragged_attention")
    regs = [int(w) for line in nvlog.splitlines() if "registers" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt == "registers,"]
    spills = sum(1 for line in nvlog.splitlines()
                 if "spill" in line and not line.strip().startswith(
                     "0 bytes stack frame, 0 bytes spill stores, "
                     "0 bytes spill loads"))
    log(f"build: ragged_attention -> {os.path.relpath(path, HERE)} "
        f"({secs:.1f} s; {len(regs)} instantiations, registers "
        f"{min(regs, default=0)}-{max(regs, default=0)}, "
        f"{spills} with spills)")
    _build.load("ragged_attention")

    # phase 3: every kernel against its plain version
    timer = Timer(torch)
    t0 = time.perf_counter()
    rows = phase_kernels(torch, timer)
    log(f"kernels: phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_invariants(torch)
    log(f"invariants: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    st = phase_serve(torch, card, args.profile)
    log(f"serve: phase {time.perf_counter() - t0:.1f} s")

    main_case = next(r for r in rows if r["case"] == "all_decode"
                     and r["dtypes"] == "bf16/bf16")
    kernels = [dict(
        name="ragged_paged_attention", route="cuda",
        source="tpulab_torch/ops/csrc/ragged_attention.cu",
        replaces="tpulab/ops/ragged_attention.py:190",
        launches=st["launches"],
        max_abs_err=max(r["max_abs_err"] for r in rows
                        if r["dtypes"] == "bf16/bf16"),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"],
        case="all_decode bf16/bf16, 8 lanes x 1024 context")]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
