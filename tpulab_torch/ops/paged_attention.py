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
launch failure raises.  ``paged_decode_attention.launches`` counts kernel
launches.  tpulab's ``g_pages`` / ``nbuf`` (pages per DMA block and the
pipeline depth in TPU VMEM) are not taken: the kernel stages its own
tiles in shared memory.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

_FLOATS = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8


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
    ctx = kv_pool[tables.long().clamp(0, n_pages - 1)]   # (B, MP, 2, S, Hkv, D)
    k = ctx[:, :, 0].reshape(b, mp * s, hkv, d).float()
    v = ctx[:, :, 1].reshape(b, mp * s, hkv, d).float()
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
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built (want one of {_HEAD_DIMS})")
    if q.dtype not in _FLOATS or kv_pool.dtype not in _FLOATS:
        raise TypeError(f"q {q.dtype} / pool {kv_pool.dtype}: the kernel "
                        "takes float32 or bfloat16")
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
    f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
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
    out = torch.empty_like(q)
    # the launch goes to the calling thread's current device
    same = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tpulab_paged_decode_attention(
            q.data_ptr(), kv_pool.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, hq, hkv, d, n_pages, s,
            tables.shape[1], int(q.dtype == torch.bfloat16),
            int(kv_pool.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.tpulab_cuda_error_string(rc).decode()
        raise RuntimeError(f"paged_decode_attention launch failed: {msg}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
