"""Ragged paged attention: the CUDA kernel and its plain PyTorch version.

The port of ``tpulab/ops/ragged_attention.py`` (the Pallas kernel
``_ragged_attn``).  Lane b carries ``q_lens[b]`` left-packed query rows;
row j sits at position ``kv_lens[b] - q_lens[b] + j`` and attends every
position <= its own through the lane's block table over one layer's
fused page pool.  ``kv_lens`` is a COUNT (last position + 1): the decode
shape is ``q_lens == 1, kv_lens == position + 1``.

:func:`ragged_paged_attention` launches the hand-written Hopper kernel
(``csrc/ragged_attention.cu``) for CUDA tensors and takes the plain
version, :func:`ragged_paged_attention_reference`, only for tensors on
the CPU.  A CUDA tensor never reaches the plain version: a build or
launch failure raises.  q is float32 or bfloat16; the pool float32,
bfloat16 or float8_e4m3fn, whose pages the kernel upcasts as it reads
them (every e4m3 value is a bf16 value).  The kernel has two bodies,
chosen by :func:`ragged_body` from dtypes and head dim alone: ``"wgmma"``
(bf16 q over a bf16 or e4m3 pool on the bf16 tensor cores, D 64 or 128)
and ``"fma"`` (f32 FMAs on CUDA cores: every other mix, and D 256).  A
``"wgmma"`` launch whose tiles do not fill the card splits each lane's
context into :func:`ragged_splits` parts (split-KV) and merges them in a
second, small kernel.  ``ragged_paged_attention.launches`` counts calls that launched
(one per call, merge included) and
``ragged_paged_attention.launches_by_body`` splits them by body (the
plain version counts in neither).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

_FLOATS = (torch.float32, torch.bfloat16)
#: the pool dtypes and the C launcher's code for each
KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_HEAD_DIMS = (64, 128, 256)
_WGMMA_HEAD_DIMS = (64, 128)
_BODY_CODE = {"fma": 0, "wgmma": 1}     # the C launcher's `body` argument
TILE_ROWS = 64       # query rows (j, g) of one wgmma tile
STAGE_KEYS = 64      # key positions of one wgmma stage
MAX_SPLITS = 16


def ragged_body(q_dtype, kv_dtype, head_dim: int) -> str:
    """The kernel body a CUDA call runs: ``"wgmma"`` for bf16 q over a
    bf16 or e4m3 pool with D 64 or 128, else ``"fma"``.  A function of
    dtypes and head dim only."""
    if (q_dtype == torch.bfloat16
            and kv_dtype in (torch.bfloat16, torch.float8_e4m3fn)
            and head_dim in _WGMMA_HEAD_DIMS):
        return "wgmma"
    return "fma"


def ragged_splits(b: int, m: int, hq: int, hkv: int, mp: int,
                  page_size: int, n_sm: int, body: str = "wgmma") -> int:
    """How many parts the ``"wgmma"`` body splits each lane's context into.

    A function of shapes and the SM count only, never of ``kv_lens`` or
    timing, so equal shapes give equal splits and bit-equal results.  One
    split when the (tile, KV head, lane) blocks already fill the card, as a
    256-row mixed round does; otherwise enough splits for about two blocks
    per SM (two fit at once), at most one per 64-key stage of the longest
    context (``mp * page_size``) and at most ``MAX_SPLITS``."""
    if body != "wgmma":
        return 1
    tiles = -(-m * (hq // hkv) // TILE_ROWS)
    blocks = tiles * hkv * b
    if blocks >= n_sm:
        return 1
    stages = -(-mp * page_size // STAGE_KEYS)
    return max(1, min(2 * n_sm // blocks, stages, MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pool_bytes(kv: torch.Tensor) -> torch.Tensor:
    """A page store as the tensor its gathers and scatters index: a
    ``uint8`` view of an fp8 store (torch has no fp8 ``index_copy_`` or
    ``masked_fill`` on the CPU), else the store itself."""
    return kv.view(torch.uint8) if kv.element_size() == 1 else kv


def gather_pages(kv_pool, idx):
    """``kv_pool[idx]`` upcast to f32, gathered through
    :func:`pool_bytes`."""
    return pool_bytes(kv_pool)[idx].view(kv_pool.dtype).float()


def ragged_paged_attention_reference(q, kv_pool, tables, q_lens, kv_lens):
    """Plain per-lane masked softmax in f32 over the gathered context.

    q (B, M, Hq, D); kv_pool (P, 2, S, Hkv, D); tables (B, MP);
    q_lens, kv_lens (B,).  Returns (B, M, Hq, D) in q's dtype; rows
    ``j >= q_lens[b]`` are zeros, and positions ``>= kv_lens[b]`` are
    zeroed before any sum (so stale pool rows can never leak a NaN)."""
    b, m, hq, d = q.shape
    n_pages, _, s, hkv, _ = kv_pool.shape
    mp = tables.shape[1]
    g = hq // hkv
    dev = q.device
    # (B, MP, 2, S, Hkv, D) in f32
    ctx = gather_pages(kv_pool, tables.long().clamp(0, n_pages - 1))
    k = ctx[:, :, 0].reshape(b, mp * s, hkv, d)
    v = ctx[:, :, 1].reshape(b, mp * s, hkv, d)
    t = torch.arange(mp * s, device=dev)
    j = torch.arange(m, device=dev)
    q_lens = q_lens.long().to(dev)
    kv_lens = kv_lens.long().to(dev)
    live = t[None, :] < kv_lens[:, None]                      # (B, T)
    k = k.masked_fill(~live[:, :, None, None], 0.0)
    v = v.masked_fill(~live[:, :, None, None], 0.0)
    qpos = (kv_lens - q_lens)[:, None] + j[None, :]           # (B, M)
    row = j[None, :] < q_lens[:, None]                        # (B, M)
    vis = ((t[None, None, :] <= qpos[:, :, None]) & live[:, None, :]
           & row[:, :, None])                                 # (B, M, T)
    qf = q.float().reshape(b, m, hkv, g, d) * (1.0 / math.sqrt(d))
    scores = torch.einsum("bmhgd,bthd->bhgmt", qf, k)
    scores = scores.masked_fill(~vis[:, None, None], float("-inf"))
    mx = scores.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(scores - mx)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgmt,bthd->bmhgd", p / den, v)
    return o.reshape(b, m, hq, d).to(q.dtype)


def _check(q, kv_pool, tables, q_lens, kv_lens):
    if q.dim() != 4 or kv_pool.dim() != 5 or kv_pool.shape[1] != 2:
        raise ValueError("want q (B, M, Hq, D) and kv_pool (P, 2, S, Hkv, D);"
                         f" got {tuple(q.shape)} and {tuple(kv_pool.shape)}")
    b, m, hq, d = q.shape
    hkv = kv_pool.shape[3]
    if kv_pool.shape[4] != d or hq % hkv:
        raise ValueError(f"head geometry mismatch: q {tuple(q.shape)}, "
                         f"pool {tuple(kv_pool.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built (want one of {_HEAD_DIMS})")
    if q.dtype not in _FLOATS or kv_pool.dtype not in KV_CODE:
        raise TypeError(f"q {q.dtype} / pool {kv_pool.dtype}: the kernel "
                        "takes a float32 or bfloat16 q over a float32, "
                        "bfloat16 or float8_e4m3fn pool")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables {tuple(tables.shape)} for {b} lanes")
    if q_lens.shape != (b,) or kv_lens.shape != (b,):
        raise ValueError("q_lens and kv_lens must be (B,)")
    for name, t in (("q", q), ("kv_pool", kv_pool), ("tables", tables),
                    ("q_lens", q_lens), ("kv_lens", kv_lens)):
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

    lib = load("ragged_attention")
    f = lib.tpulab_ragged_paged_attention
    f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                  + [ctypes.c_float, ctypes.c_void_p])
    f.restype = ctypes.c_int
    lib.tpulab_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpulab_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ragged_paged_attention(q, kv_pool, tables, q_lens, kv_lens):
    """Ragged paged attention; (B, M, Hq, D) in q's dtype.

    CPU tensors take :func:`ragged_paged_attention_reference`; CUDA
    tensors launch the kernel on the current stream or raise."""
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(q, kv_pool, tables, q_lens,
                                                kv_lens)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, kv_pool, tables, q_lens, kv_lens)
    lib = _lib()
    b, m, hq, d = q.shape
    n_pages, _, s, hkv, _ = kv_pool.shape
    tables = tables.to(torch.int32).contiguous()
    q_lens = q_lens.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    mp = tables.shape[1]
    body = ragged_body(q.dtype, kv_pool.dtype, d)
    n_split = ragged_splits(b, m, hq, hkv, mp, s, _sm_count(q.device.index),
                            body)
    out = torch.empty_like(q)
    # f32 partials of every split: O (b, m, hq, d), then (m, l) per row.
    # Freed on return: the caching allocator hands the block out again
    # only to later work on this stream, which runs after the merge.
    scratch = (torch.empty(n_split * b * m * hq * (d + 2),
                           dtype=torch.float32, device=q.device)
               if n_split > 1 else None)
    # the launch goes to the calling thread's current device
    same = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tpulab_ragged_paged_attention(
            q.data_ptr(), kv_pool.data_ptr(), tables.data_ptr(),
            q_lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, m, hq, hkv, d, n_pages, s, mp,
            int(q.dtype == torch.bfloat16), KV_CODE[kv_pool.dtype],
            _BODY_CODE[body], n_split,
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.tpulab_cuda_error_string(rc).decode()
        raise RuntimeError(f"ragged_paged_attention launch failed ({body} "
                           f"body, {n_split} splits): {msg}")
    ragged_paged_attention.launches += 1
    ragged_paged_attention.launches_by_body[body] += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_by_body = dict.fromkeys(_BODY_CODE, 0)
