"""Paged single-query decode attention: the CUDA kernel and its plain
PyTorch version.

The port of ``tpulab/ops/paged_attention.py`` (the Pallas kernel
``_paged_attn``).  Each lane attends one query token against its own
block table over one layer's fused page pool (P, 2, S, Hkv, D), MHA or
grouped-query.  ``lengths`` is the lane's CURRENT POSITION, inclusive
(positions 0..lengths[b] are visible) — not a count, unlike the ragged
kernel's ``kv_lens``.  Tables are padded with the scratch page 0.

:func:`paged_decode_attention` launches the hand-written Hopper kernel
(``csrc/paged_attention.cu``) for CUDA tensors and takes the plain
version, :func:`paged_decode_attention_reference`, only for tensors on
the CPU.  A CUDA tensor never reaches the plain version: a build or
launch failure raises.  q is float32, bfloat16 or float16; the pool
float32, bfloat16, float16, float8_e4m3fn or float8_e5m2, upcast to f32
as the kernel reads it.  One body serves every dtype mix and head dim: a
producer warp fills a ring of 32-position stages with 16-byte async
copies tracked by mbarriers, and the consumer warps (one a ring slot)
run the online softmax on f32 FMAs.
Where the (KV head, lane) blocks do not fill the card, each lane's
context is split into :func:`paged_splits` parts (split-KV) whose f32
partials a second, small kernel merges in split order.
``paged_decode_attention.launches`` counts calls that launched (one per
call, merge included).  tpulab's ``g_pages`` / ``nbuf`` (pages per DMA
block and the pipeline depth in TPU VMEM) are not taken: the kernel
stages its own tiles in shared memory.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from tpulab_torch.ops.ragged_attention import (KV_CODE, Q_CODE, _sm_count,
                                               check_built, gather_pages)

#: head dims the kernel is built for
HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8
STAGE_POSITIONS = 32    # positions of a stage: one a consumer lane
ROUND_STAGES = 4        # stages a round (the ring's slots at bf16 D <= 128)
MAX_SPLITS = 16


def paged_splits(b: int, hkv: int, mp: int, page_size: int,
                 n_sm: int) -> int:
    """How many parts the kernel splits each lane's context into.

    A function of shapes and the SM count only, never of ``lengths`` or
    timing, so equal shapes give equal splits and bit-equal results.  One
    split when the (KV head, lane) blocks already fill the card;
    otherwise enough splits for about two blocks per SM (two fit at
    once), at most one per round of four 32-position stages over the
    table (``mp * page_size`` positions, 128 a round) and at most
    ``MAX_SPLITS``."""
    blocks = b * hkv
    if blocks >= n_sm:
        return 1
    rounds = -(-mp * page_size // (STAGE_POSITIONS * ROUND_STAGES))
    return max(1, min(2 * n_sm // blocks, rounds, MAX_SPLITS))


def paged_decode_attention_reference(q, kv_pool, tables, lengths):
    """Plain masked softmax in f32 over each lane's gathered context.

    q (B, Hq, D); kv_pool (P, 2, S, Hkv, D); tables (B, MP); lengths (B,)
    inclusive positions.  Returns (B, Hq, D) in q's dtype.  Positions past
    ``lengths[b]`` are zeroed before any sum, so a dead page's inf or NaN
    never reaches the output."""
    b, hq, d = q.shape
    n_pages, _, s, hkv, _ = kv_pool.shape
    mp = tables.shape[1]
    g = hq // hkv
    # (B, MP, 2, S, Hkv, D) in f32
    ctx = gather_pages(kv_pool, tables.long().clamp(0, n_pages - 1))
    k = ctx[:, :, 0].reshape(b, mp * s, hkv, d)
    v = ctx[:, :, 1].reshape(b, mp * s, hkv, d)
    live = (torch.arange(mp * s, device=q.device)[None, :]
            <= lengths.long().to(q.device)[:, None])       # (B, T)
    k = k.masked_fill(~live[:, :, None, None], 0.0)
    v = v.masked_fill(~live[:, :, None, None], 0.0)
    qf = q.float().reshape(b, hkv, g, d) * (1.0 / math.sqrt(d))
    scores = torch.einsum("bhgd,bthd->bhgt", qf, k)
    scores = scores.masked_fill(~live[:, None, None], float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True).clamp_min(-1e30))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgt,bthd->bhgd", p, v)
    return o.reshape(b, hq, d).to(q.dtype)


def _check(q, kv_pool, tables, lengths):
    if q.dim() != 3 or kv_pool.dim() != 5 or kv_pool.shape[1] != 2:
        raise ValueError("want q (B, Hq, D) and kv_pool (P, 2, S, Hkv, D);"
                         f" got {tuple(q.shape)} and {tuple(kv_pool.shape)}")
    b, hq, d = q.shape
    hkv = kv_pool.shape[3]
    if kv_pool.shape[4] != d or hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}, or "
                         f"head dims differ: q {tuple(q.shape)}, pool "
                         f"{tuple(kv_pool.shape)}")
    if hq // hkv > _MAX_GROUP:
        raise ValueError(f"group size {hq // hkv} not built (at most "
                         f"{_MAX_GROUP} query heads per KV head)")
    check_built(q.dtype, kv_pool.dtype, d, HEAD_DIMS)
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} for {b} lanes")
    for name, t in (("kv_pool", kv_pool), ("tables", tables),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if not (q.is_contiguous() and kv_pool.is_contiguous()):
        raise ValueError("q and kv_pool must be contiguous")
    if kv_pool.data_ptr() % 16:
        raise ValueError("kv_pool must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, its C functions typed."""
    from tpulab_torch.ops._build import load

    lib = load("paged_attention")
    f = lib.tpulab_paged_decode_attention
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                  + [ctypes.c_float, ctypes.c_void_p])
    f.restype = ctypes.c_int
    lib.tpulab_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpulab_cuda_error_string.restype = ctypes.c_char_p
    return lib


def paged_decode_attention(q, kv_pool, tables, lengths):
    """Single-query paged decode attention; (B, Hq, D) in q's dtype.

    CPU tensors take :func:`paged_decode_attention_reference`; CUDA
    tensors launch the kernel on the current stream or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, kv_pool, tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, kv_pool, tables, lengths)
    lib = _lib()
    b, hq, d = q.shape
    n_pages, _, s, hkv, _ = kv_pool.shape
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    mp = tables.shape[1]
    n_split = paged_splits(b, hkv, mp, s, _sm_count(q.device.index))
    out = torch.empty_like(q)
    # f32 partials of every split: O (b, hq, d), then (m, l) per row.
    # Freed on return: the caching allocator hands the block out again
    # only to later work on this stream, which runs after the merge.
    scratch = (torch.empty(n_split * b * hq * (d + 2), dtype=torch.float32,
                           device=q.device)
               if n_split > 1 else None)
    # the launch goes to the calling thread's current device
    same = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tpulab_paged_decode_attention(
            q.data_ptr(), kv_pool.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, hq, hkv, d,
            n_pages, s, mp, n_split, Q_CODE[q.dtype],
            KV_CODE[kv_pool.dtype], 1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.tpulab_cuda_error_string(rc).decode()
        raise RuntimeError(f"paged_decode_attention launch failed "
                           f"({n_split} splits): {msg}")
    paged_decode_attention.launches += 1
    return out

paged_decode_attention.launches = 0
