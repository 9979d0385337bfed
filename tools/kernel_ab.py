#!/usr/bin/env python3
"""Time kernels 1-3 of several checkouts on the same card, each run in a
fresh process, in the order given (for example A B B A), and hold their
outputs bit for bit.

    python3 tools/kernel_ab.py build/parent . . build/parent

Each run builds the kernels of its own checkout (``phase_build``: the
build seconds of each library are printed) and runs its ``chip_smoke.py``'s
``phase_ragged`` and ``phase_paged`` (CUDA events, L2 flushed), keeping
the rows of every dtype mix at all_decode, chunk_over_ctx, long_decode
and verify_k8 (kernel 1) and the bf16 rows of kernel 3; then, at every
head dim the kernels are compiled for exactly (D 16, 32, 64, 128 and
256) and at three padded ones (24 and 100 on the fma bodies' padded
widths, 96 on the 128-wide tensor-core tile in bf16 and f16 and on the
padded fma width in f32), kernel 1 at 8 lanes x 1024 decode, kernel 2 at T 2048 H 8
causal and kernel 3 at 8 x 1024, each in f32 and bf16 (kernel 1 and 3
also bf16 over e4m3 pages), timed the same way, and the SHA-256 of the
outputs of those calls and of smaller ones at ragged edges (f16 too).
Past 256: kernel 1 at 8 lanes x 1024 (decode, and a 256-row chunk where
the pair runs ``wgmma-wide``) at D 257 and 512 over f32/f32, bf16/f16,
bf16/bf16 and bf16/e4m3 pages with 8 query heads over one, and
DeepSeek-V4-Flash's and sarvam-105b's 64 heads over one at D 512 / 576
in bf16; kernel 3 at 8 x 1024 at D 257 and 512; kernel 2 at T 2048, H 8,
causal, at D 512 (bf16, f16, f32), 576 and 264 (bf16) and at H 64, D 512.
D 144-256 at Gemma-2-9B's head geometry (16 query heads over 8): kernel
1 at 8 lanes x 1024 decode at D 144, 160, 192, 208 and 256 in bf16 (at
D 256 also bf16 over e4m3, f16 and f16 over e5m2 pages, a 256-row chunk
and the K 8 verify rows), kernel 2 at T 2048, H 16, causal at those head
dims (D 256: f16, full, T 1024), each beside SDPA on the same inputs (a
yardstick: the same call in every checkout); kernel 2's ``fma-wide``
D 264 row beside SDPA too.
Outputs of the pairs the checkout runs on ``wgmma-wide`` are held against
the same checkout's first run (a parent runs them on ``fma-wide``), and
so are those of the 16-bit tensor-core pairs at D 144-256 (``wgmma`` in
this tree, ``fma`` in its parent); every other output against run 0's.
A checkout is a directory holding ``chip_smoke.py`` and ``tpulab_torch/``
(the parent commit unpacked with ``git archive``, or this one).  The
summary prints each row's milliseconds run by run, whether every run's
outputs equal the first's bit for bit, and the card's name and power
limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import io, json, sys, contextlib, hashlib
import numpy as np, torch
sys.path.insert(0, '.')
import chip_smoke as c
from tpulab_torch.ops.flash_attention import flash_attention
from tpulab_torch.ops.paged_attention import paged_decode_attention
from tpulab_torch.ops.ragged_attention import ragged_paged_attention
torch.backends.cuda.matmul.allow_tf32 = False
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    c.phase_build()
    t = c.Timer(torch)
    r = c.phase_ragged(torch, t)
    p = c.phase_paged(torch, t)
build = [line for line in buf.getvalue().splitlines()
         if line.startswith('build:')]
rows = {f"ragged {x['case']} {x['dtypes']}": x['ms'] for x in r
        if x['case'] in ('all_decode', 'verify_k8', 'chunk_over_ctx',
                         'long_decode')}
rows.update({f"paged {x['case']} {x['dtypes']}": x['ms'] for x in p
             if x['dtypes'] == 'bf16/bf16'})

digests = {}
def digest(key, out):
    torch.cuda.synchronize()
    raw = out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    digests[key] = hashlib.sha256(raw).hexdigest()[:16]

def lens(x):
    return torch.tensor(x, dtype=torch.int32, device='cuda')

def dtn(t):
    return str(t).split('.')[-1]

def mid(q_dt, kv_dt, d):
    # D 144-256 on the 16-bit pairs of the tensor-core body: "wgmma" in
    # this tree, "fma" in its parent (held against the checkout's own first
    # run, "changed:")
    tc = (q_dt in (torch.bfloat16, torch.float16)
          and kv_dt in (q_dt, torch.float8_e4m3fn, torch.float8_e5m2))
    return 'changed:' if tc and d % 16 == 0 and 144 <= d <= 256 else ''

MIXES = (('f32/f32', torch.float32, torch.float32),
         ('bf16/bf16', torch.bfloat16, torch.bfloat16),
         ('bf16/e4m3', torch.bfloat16, torch.float8_e4m3fn))
for d in (16, 24, 32, 64, 96, 100, 128, 256):
    rng = np.random.default_rng(d)
    g = dict(c.RA_GEOM, d=d)
    pool32, tables = c.serving_pool(torch, np, rng, g)
    q32 = torch.from_numpy(rng.standard_normal(
        (8, 9, g['hq'], d)).astype(np.float32)).cuda()
    for name, q_dt, kv_dt in MIXES + (('f16/f16', torch.float16,
                                       torch.float16),):
        pool, q = pool32.to(kv_dt), q32.to(q_dt)
        timed = name != 'f16/f16'
        for case, ql, kl in (('decode', [1] * 8, [1024] * 8),
                             ('edges', [9, 1, 3, 0, 9, 1, 2, 9],
                              [9, 17, 300, 0, 1033, 2048, 64, 100])):
            m = max(ql)
            args = (q[:, :m].contiguous(), pool, tables, lens(ql), lens(kl))
            digest(mid(q_dt, kv_dt, d) + f'ragged D{d} {case} {name}',
                   ragged_paged_attention(*args))
            if timed and case == 'decode':
                rows[f'ragged D{d} decode 8 x 1024 {name}'] = t(
                    lambda: ragged_paged_attention(*args), iters=20)
        for lanes, pos in ((8, 1023), (3, 100)):
            args = (q[:lanes, 0].contiguous(), pool, tables[:lanes],
                    lens([pos] * lanes))
            digest(f'paged D{d} {lanes} x {pos + 1} {name}',
                   paged_decode_attention(*args))
            if timed and lanes == 8:
                rows[f'paged D{d} 8 x 1024 {name}'] = t(
                    lambda: paged_decode_attention(*args), iters=20)
        del pool
    del pool32
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for tl, causal in ((2048, True), (200, False)):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (1, tl, 8, d)).astype(np.float32)).cuda().to(dt)
                for _ in range(3))
            name = str(dt).split('.')[-1]
            digest(mid(dt, dt, d) + f'flash D{d} T={tl} {name}',
                   flash_attention(q, k, v, causal=causal, block_q=tl,
                                   block_k=tl))
            if tl == 2048 and dt != torch.float16:
                rows[f'flash D{d} T=2048 H 8 causal {name}'] = t(
                    lambda: flash_attention(q, k, v, causal=True), iters=10)
    torch.cuda.empty_cache()

# D 144-256 at Gemma-2-9B's head geometry (16 query heads over 8): kernel
# 1 at 8 lanes x 1024 (decode; at D 256 also a 256-row chunk and the K 8
# verify rows, and f16 / fp8 pages), kernel 2 at T 2048, H 16, causal
# (D 256: f16, full, T 1024), each beside SDPA (a yardstick, the same
# call in every checkout)
for d in (144, 160, 192, 208, 256):
    rng = np.random.default_rng(1000 + d)
    g = dict(c.RA_GEOM, hq=16, hkv=8, d=d)
    pool32, tables = c.serving_pool(torch, np, rng, g)
    q32 = torch.from_numpy(rng.standard_normal(
        (8, 256, 16, d)).astype(np.float32)).cuda()
    mixes = (('bf16/bf16', torch.bfloat16, torch.bfloat16),)
    cases = (('decode', 1, 1024),)
    if d == 256:
        mixes += (('bf16/e4m3', torch.bfloat16, torch.float8_e4m3fn),
                  ('f16/f16', torch.float16, torch.float16),
                  ('f16/e5m2', torch.float16, torch.float8_e5m2))
        cases += (('chunk', 256, 1024), ('verify_k8', 9, 1033))
    for name, q_dt, kv_dt in mixes:
        pool, q = pool32.to(kv_dt), q32.to(q_dt)
        for case, m, kv in (cases if name == 'bf16/bf16' else cases[:1]):
            args = (q[:, :m].contiguous(), pool, tables, lens([m] * 8),
                    lens([kv] * 8))
            key = f'ragged mid D{d} Hq16/8 {case} {name}'
            digest(mid(q_dt, kv_dt, d) + key, ragged_paged_attention(*args))
            rows[key] = t(lambda: ragged_paged_attention(*args),
                          iters=5 if case == 'chunk' else 20)
            if q_dt == kv_dt:
                pos = torch.arange(m, device='cuda')[None] + (kv - m)
                vis = (torch.arange(g['mp'] * g['s'], device='cuda')[
                    None, None] <= pos[..., None]).expand(8, m, -1)
                rows['sdpa ' + key] = c.sdpa_decode_ms(
                    torch, t, args[0], pool, tables, vis, 2)
        del pool
    del pool32
    torch.cuda.empty_cache()
    flash = [(2048, True, torch.bfloat16)]
    if d == 256:
        flash += [(2048, True, torch.float16), (2048, False, torch.bfloat16),
                  (1024, True, torch.bfloat16)]
    for tl, causal, dt in flash:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, tl, 16, d)).astype(np.float32)).cuda().to(dt)
            for _ in range(3))
        key = (f"flash mid D{d} T={tl} H 16 {'causal' if causal else 'full'}"
               f" {dtn(dt)}")
        digest(mid(dt, dt, d) + key,
               flash_attention(q, k, v, causal=causal))
        rows[key] = t(lambda: flash_attention(q, k, v, causal=causal),
                      iters=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rows['sdpa ' + key] = t(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters=5)
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

# past 256: the forms the tensor-core wide form left alone (f32 and the
# mixed 16-bit pairs, D not a multiple of 16, kernel 3) must equal run 0's
# outputs bit for bit; the pairs it took ("changed:") equal those of the
# checkout's own first run, and are timed against the parent's fma-wide
def wide_body(q_name, kv_name, d):   # this tree's rule, for every checkout
    tc = (q_name in ('bfloat16', 'float16')
          and kv_name in (q_name, 'float8_e4m3fn', 'float8_e5m2'))
    return 'wgmma-wide' if tc and d % 16 == 0 else 'fma-wide'
for d, hq in ((257, 8), (512, 8), (512, 64), (576, 64)):
    rng = np.random.default_rng(d + hq)
    g = dict(c.RA_GEOM, hq=hq, hkv=1, d=d)
    pool32, tables = c.serving_pool(torch, np, rng, g)
    q32 = torch.from_numpy(rng.standard_normal(
        (8, 256, hq, d)).astype(np.float32)).cuda()
    mixes = ((torch.float32, torch.float32), (torch.bfloat16, torch.float16),
             (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float8_e4m3fn))
    if hq == 64:
        mixes = ((torch.bfloat16, torch.bfloat16),)
    for q_dt, kv_dt in mixes:
        pool, q = pool32.to(kv_dt), q32.to(q_dt)
        name = f'{dtn(q_dt)}/{dtn(kv_dt)}'
        changed = ('changed:' if wide_body(dtn(q_dt), dtn(kv_dt), d)
                   == 'wgmma-wide' else '')
        cases = (('decode', 1, 1024), ('chunk', 256, 1024))
        if hq == 8 and not changed:
            cases = cases[:1]
        for case, m, kv in cases:
            if hq == 64 and d == 576 and case == 'chunk':
                continue
            args = (q[:, :m].contiguous(), pool, tables, lens([m] * 8),
                    lens([kv] * 8))
            key = f'ragged wide D{d} Hq{hq} {case} {name}'
            digest(changed + key, ragged_paged_attention(*args))
            if changed or case == 'decode':
                rows[key] = t(lambda: ragged_paged_attention(*args),
                              iters=3 if case == 'chunk' else 20)
        if hq == 8 and q_dt == kv_dt:
            args = (q[:, 0].contiguous(), pool, tables, lens([1023] * 8))
            digest(f'paged wide D{d} 8 x 1024 {name}',
                   paged_decode_attention(*args))
            rows[f'paged wide D{d} 8 x 1024 {name}'] = t(
                lambda: paged_decode_attention(*args), iters=20)
        del pool
    del pool32
    torch.cuda.empty_cache()
for d, dt, h in ((512, torch.bfloat16, 8), (512, torch.float16, 8),
                 (576, torch.bfloat16, 8), (512, torch.bfloat16, 64),
                 (512, torch.float32, 8), (264, torch.bfloat16, 8)):
    rng = np.random.default_rng(d + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 2048, h, d)).astype(np.float32)).cuda().to(dt)
        for _ in range(3))
    changed = 'changed:' if wide_body(dtn(dt), dtn(dt), d) == \
        'wgmma-wide' else ''
    key = f'flash wide D{d} T=2048 H {h} causal {dtn(dt)}'
    digest(changed + key, flash_attention(q, k, v, causal=True))
    rows[key] = t(lambda: flash_attention(q, k, v, causal=True), iters=5)
    if d == 264:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rows['sdpa ' + key] = t(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters=5)
        del qt, kt, vt
    del q, k, v
    torch.cuda.empty_cache()
print('AB ' + json.dumps({'build': build, 'rows': rows, 'digests': digests}),
      flush=True)
"""


def main(argv=None) -> int:
    dirs = sys.argv[1:] if argv is None else argv
    if not dirs:
        raise SystemExit(__doc__)
    sys.path.insert(0, REPO)
    from tpulab_torch.cuda.platform import card_name_and_power_limit

    res = []
    for i, d in enumerate(dirs):
        out = subprocess.run([sys.executable, "-c", RUN], cwd=d,
                             capture_output=True, text=True, timeout=900)
        line = [x for x in out.stdout.splitlines() if x.startswith("AB ")]
        if out.returncode != 0 or not line:
            raise SystemExit(f"run {i} in {d} failed:\n{out.stderr[-3000:]}")
        rec = json.loads(line[0][3:])
        res.append((d, rec["rows"], rec["digests"]))
        print(f"run {i} {d}: " + "; ".join(rec["build"]), flush=True)
    for key in sorted(res[0][1]):
        print(f"{key}: " + " | ".join(f"{d} {rows[key]:.4f}"
                                      for d, rows, _ in res))
    # "changed:" outputs are held against the first run of the same
    # checkout, every other one against run 0
    first = res[0][2]
    own = {}
    for d, _, dig in res:
        own.setdefault(d, dig)
    differ = sorted({k for d, _, dig in res[1:] for k in dig
                     if dig[k] != (own[d] if k.startswith("changed:")
                                   else first).get(k)})
    n_same = sum(not k.startswith("changed:") for k in first)
    print(f"outputs: {len(first)} calls a run ({n_same} held against run "
          f"0, {len(first) - n_same} against the checkout's first run); "
          + (f"DIFFER at {differ}" if differ
             else "every run equal bit for bit"), flush=True)
    print(card_name_and_power_limit(0), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
