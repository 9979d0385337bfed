#!/usr/bin/env python3
"""Time variants of the port's paged decode kernel on one CUDA card.

    python3 tools/paged_decode_variants.py      # from the repository root

Builds four variants of ``tpulab_torch/ops/csrc/paged_attention.cu`` by
editing its text at fixed anchors (the script stops if one is missing):

- ``ring``: the kernel as it is;
- ``ring_nomath``: the consumers wait for each stage and release it
  without any math (what the copies alone cost);
- ``ring_nocopy``: the producer issues no copy and still completes each
  stage (what the math alone costs, on stale shared memory);
- ``bulk``: the producer copies each K and V row with one
  ``cp.async.bulk`` that completes on the stage's mbarrier, instead of
  16-byte ``cp.async`` chunks.

Each variant runs at chip_smoke.py's serving geometry (Hq 32, Hkv 8,
D 128, pages of 16, 128 pages a lane) over 8 lanes at positions 1023 and
2047 and one lane at 2047, bf16 and f32, at several forced split counts.
Times are CUDA events over single launches (kernel and merge), in µs, as
dirty / clean / warm: the L2 flushed by writing 64 MB, by reading 64 MB,
or not at all.  Variants that compute are held against the plain
version (max abs error printed).  Builds go to ``build/variants/``.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpulab_torch.ops import _build  # noqa: E402
from tpulab_torch.ops.paged_attention import \
    paged_decode_attention_reference  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
SRC = os.path.join(ROOT, "tpulab_torch", "ops", "csrc", "paged_attention.cu")

BULK_HELPER = '''// `bytes` contiguous bytes global -> shared; completion counts on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n" ::"r"(wg::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(wg::smem_u32(bar))
      : "memory");
}

'''
BULK_COPY = '''      if (lane == 0) wg::mbar_expect_tx(&full[slot], 2u * nv * Geo::ROW);
      __syncwarp();
      if (lane < nv) {
        bulk_copy(st + lane * LDB, row, Geo::ROW, &full[slot]);
        bulk_copy(st + (KT + lane) * LDB, row + v_off, Geo::ROW, &full[slot]);
      }
'''


def cut(s, start, end):
    """The text from anchor ``start`` up to anchor ``end``."""
    if s.count(start) != 1 or s.count(end) != 1:
        sys.exit(f"anchor not found once: {start!r} / {end!r}")
    return s[s.index(start):s.index(end)]


def variant(name: str) -> str:
    s = open(SRC).read()
    if name == "ring_nomath":
        body = cut(s, "    // scores: lane t against every head of the group",
                   "    __syncwarp();                       // every lane is "
                   "done with the slot")
        s = s.replace(body, "")
    elif name == "ring_nocopy":
        old = "        if (r < nv) {\n          cp_async16("
        if s.count(old) != 1:
            sys.exit("anchor not found: the producer's copy")
        s = s.replace(old, "        if (r < 0) {\n          cp_async16(")
    elif name == "bulk":
        loop = cut(s, "      // 32 / CPR rows a pass",
                   "      cp_async_arrive(&full[slot]);\n")
        s = s.replace(loop + "      cp_async_arrive(&full[slot]);\n",
                      BULK_COPY)
        s = s.replace("wg::mbar_init(&full[i], 32);",
                      "wg::mbar_init(&full[i], 1);")
        geo = "template <typename KVT, int D>\nstruct Geometry"
        s = s.replace(geo, BULK_HELPER + geo)
    path = os.path.join(OUT, f"paged_{name}.cu")
    with open(path, "w") as f:
        f.write(s)
    return path


NAMES = ("ring", "ring_nomath", "ring_nocopy", "bulk")


def build(name: str) -> str:
    src = variant(name)
    so = os.path.join(OUT, f"lib_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_decode_variants: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(NAMES)) as ex:
        libs = dict(zip(NAMES, ex.map(build, NAMES)))
    fns = {}
    for name, so in libs.items():
        f = ctypes.CDLL(so).tpulab_paged_decode_attention
        f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                      + [ctypes.c_float, ctypes.c_void_p])
        f.restype = ctypes.c_int
        fns[name] = f
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(out or torch.cuda.get_device_name(0))

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timeit(fn, mode, iters=20):
        for _ in range(2):
            fn()
        total = 0.0
        for _ in range(iters):
            if mode == "dirty":
                flush.zero_()
            elif mode == "clean":
                flush.sum(dtype=torch.int32)
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters * 1e3

    rng = np.random.default_rng(0)
    lanes8, mp, s, hkv, hq, d = 8, 128, 16, 8, 32, 128
    n_pages = lanes8 * mp + 1
    pool32 = torch.from_numpy(rng.standard_normal(
        (n_pages, 2, s, hkv, d)).astype(np.float32)).cuda()
    tables8 = torch.from_numpy((rng.permutation(n_pages - 1) + 1).astype(
        np.int32).reshape(lanes8, mp)).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    for dt in (torch.bfloat16, torch.float32):
        pool = pool32.to(dt)
        bf = int(dt == torch.bfloat16)
        for lanes, pos, splits in ((8, 1023, (1, 4, 8)), (8, 2047, (4,)),
                                   (1, 2047, (8, 16, 32))):
            tables = tables8[:lanes].contiguous()
            q = torch.from_numpy(rng.standard_normal(
                (lanes, hq, d)).astype(np.float32)).cuda().to(dt)
            lengths = torch.full((lanes,), pos, dtype=torch.int32,
                                 device="cuda")
            want = paged_decode_attention_reference(q, pool, tables, lengths)
            nbytes = lanes * (pos + 1) * hkv * d * 2 * pool.element_size()
            for ns in splits:
                o = torch.empty_like(q)
                scratch = torch.empty(ns * lanes * hq * (d + 2),
                                      dtype=torch.float32, device="cuda")
                cells = []
                for name, f in fns.items():
                    def call(f=f):
                        rc = f(q.data_ptr(), pool.data_ptr(),
                               tables.data_ptr(), lengths.data_ptr(),
                               o.data_ptr(), scratch.data_ptr(), lanes, hq,
                               hkv, d, n_pages, s, mp, ns, bf, bf,
                               1.0 / math.sqrt(d), stream)
                        if rc:
                            raise RuntimeError(f"{name}: launch failed {rc}")
                    call()
                    torch.cuda.synchronize()
                    t = "/".join(f"{timeit(call, m):.1f}"
                                 for m in ("dirty", "clean", "warm"))
                    if name in ("ring", "bulk"):
                        err = (o.float() - want.float()).abs().max().item()
                        t += f" err {err:.1e}"
                    cells.append(f"{name} {t}")
                print(f"{str(dt)[6:]:8} {lanes} x {pos + 1} x{ns:<2} bound "
                      f"{nbytes / 3.35e12 * 1e6:.1f} us | " + " | ".join(cells),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
