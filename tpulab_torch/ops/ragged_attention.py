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
launch failure raises.  q is float32, bfloat16 or float16; the pool
float32, bfloat16, float16, float8_e4m3fn or float8_e5m2, whose pages
the kernel upcasts as it reads them.  Every head dim from 1 up is built,
as tpulab's kernels take any.  The kernel has four bodies, chosen by
:func:`ragged_body` from dtypes and head dim alone: ``"wgmma"`` (the
tensor cores in q's 16-bit type, D of ``WGMMA_HEAD_DIMS``: 64 to 256 in
steps of 16, over pages whose upcast to that type is exact: bf16 q over
bf16, e4m3 or e5m2 pages, f16 q over f16, e4m3 or e5m2 pages), ``"fma"``
(f32 FMAs on CUDA cores: every other mix, and every other D up to
``FMA_WIDTH``, 256), ``"wgmma-wide"`` (the pairs of ``"wgmma"`` at every
D past 256 that is a multiple of 16: the tensor cores, 64 query rows and
up to 512 output columns a block, the scores computed once a block;
``csrc/wide_wgmma.cuh``) and ``"fma-wide"`` (every other mix and D past
256: the output's columns in slabs of ``WIDE_COLS``, each block
recomputing its rows' scores over the whole head dim;
``csrc/wide_attention.cuh``).  A ``"wgmma"``, ``"wgmma-wide"`` or
``"fma-wide"`` launch whose blocks do not fill the card splits each
lane's context into :func:`ragged_splits` parts (split-KV) and merges
them in a second, small kernel.
``ragged_paged_attention.launches`` counts calls that launched (one per
call, merge included) and ``ragged_paged_attention.launches_by_body``
splits them by body, ``ragged_paged_attention.launches_by_geom`` by
``"<body> x<splits>"`` and ``ragged_paged_attention.launches_by_form``
by ``"wgmma bf16"``, ``"wgmma f16"``, ``"fma"``, ``"fma-wide"``,
``"wgmma-wide bf16"`` or ``"wgmma-wide f16"``, and
``ragged_paged_attention.launches_by_head_dim`` by D (the plain version
counts in none).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

#: the q dtypes and the C launchers' code for each (kernels 1, 2 and 3)
Q_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the pool dtypes and the C launchers' code for each (kernels 1 and 3)
KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
           torch.float8_e5m2: 3, torch.float16: 4}
#: the widest of the fma bodies (kernels 1-3): every D from 1 to it runs
#: on them (D 16 is tpulab's own small model, d_model 32 over 2 heads; 80
#: Phi-2's, 96 Phi-3-mini's), every D past it on the wide form
FMA_WIDTH = 256
#: the C launchers take the head dim as a 32-bit int
MAX_ADDRESSABLE_HEAD_DIM = 2**31 - 1
#: the wide form's slab of output columns (and chunk of Q and K columns)
#: and its query rows a block
WIDE_COLS = 256
WIDE_ROWS = 32
#: the least key positions a wide-form split walks (four stages)
WIDE_SPLIT_POSITIONS = 128
#: the tensor-core wide form (kernels 1 and 2, D past ``FMA_WIDTH`` that
#: is a multiple of this): its query rows and key positions a block, its
#: output columns a block, and the shared-memory plan that
#: ``csrc/wide_wgmma.cuh`` (``make_plan``) computes, mirrored by
#: :func:`wgmma_wide_plan`
WGMMA_WIDE_ALIGN = 16
WGMMA_WIDE_ROWS = 64
WGMMA_WIDE_BLOCK_COLS = 512
WGMMA_WIDE_SMEM_LIMIT = 232448          # bytes a block can use (227 KB)
_WW_HALF = 64 * 128                     # a 64 x 64 16-bit tile
_WW_UNIT = 2 * _WW_HALF                 # a ring slot
_WW_LAG = 2                             # units in flight a consumer
_WW_RING = _WW_LAG + 2                  # slots a consumer (two consumers)
_WW_XBUF = 32 * 128 * 4                 # one consumer's partial scores
_WW_BARS = 128                          # kernel 2's mbarriers
#: head dims of the tensor-core bodies (kernels 1 and 2): every multiple
#: of 16 from 64 to 256, on tiles 64, 128, 192 or 256 wide (80-112 run
#: the 128-wide tile, 144-176 the 192-wide, 208-240 the 256-wide, with
#: their columns past D zero)
WGMMA_HEAD_DIMS = tuple(range(64, FMA_WIDTH + 1, 16))
#: past this width a tensor-core block of kernel 1 takes 120 or 160 KB of
#: shared memory (five 64-row tiles), so one fits an SM instead of two
WGMMA_TWO_BLOCKS_WIDTH = 128
#: the pages each 16-bit q type reads on its tensor cores: those whose
#: upcast to q's type is exact (e4m3 and e5m2 are bf16 and f16 values;
#: f16 -> bf16 loses range bits and bf16 -> f16 exponent range)
WGMMA_PAGES = {
    torch.bfloat16: (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2),
    torch.float16: (torch.float16, torch.float8_e4m3fn, torch.float8_e5m2),
}
# the C launcher's `body` argument
_BODY_CODE = {"fma": 0, "wgmma": 1, "fma-wide": 2, "wgmma-wide": 3}
TILE_ROWS = 64       # query rows (j, g) of one wgmma tile
STAGE_KEYS = 64      # key positions of one wgmma stage
MAX_SPLITS = 16


def ragged_body(q_dtype, kv_dtype, head_dim: int) -> str:
    """The kernel body a CUDA call runs: for a bf16 or f16 q over the
    pages of ``WGMMA_PAGES[q_dtype]``, ``"wgmma"`` with D of
    ``WGMMA_HEAD_DIMS`` and ``"wgmma-wide"`` with D past ``FMA_WIDTH``
    that is a multiple of ``WGMMA_WIDE_ALIGN``; ``"fma-wide"`` for every
    other D past ``FMA_WIDTH``, else ``"fma"``.  A function of dtypes and
    head dim only."""
    tensor_cores = kv_dtype in WGMMA_PAGES.get(q_dtype, ())
    if head_dim > FMA_WIDTH:
        return ("wgmma-wide" if tensor_cores
                and head_dim % WGMMA_WIDE_ALIGN == 0 else "fma-wide")
    return "wgmma" if tensor_cores and head_dim in WGMMA_HEAD_DIMS else "fma"


def head_dim_built(head_dim: int) -> bool:
    """Whether the three kernels take this head dim: any integer from 1
    up (to ``MAX_ADDRESSABLE_HEAD_DIM``, the C launchers' 32-bit int), as
    tpulab's kernels take any."""
    return 1 <= head_dim <= MAX_ADDRESSABLE_HEAD_DIM


def wide_slabs(head_dim: int) -> int:
    """Slabs of ``WIDE_COLS`` output columns the wide form's grid walks."""
    return -(-head_dim // WIDE_COLS)


def wgmma_wide_plan(head_dim: int) -> dict:
    """The tensor-core wide form's shared-memory plan at ``head_dim``, as
    ``make_plan`` in ``csrc/wide_wgmma.cuh`` computes it: 64-column
    chunks of the head dim (``nch``), whether Q's chunks stay resident
    (else each S unit carries its own), column blocks of the grid
    (``n_cb``) and the dynamic shared memory a block asks for
    (``bytes``: Q if resident, two rings of ``_WW_RING`` 16 KB slots, the
    16 KB score swap, 128 bytes of mbarriers, 1 KB of alignment)."""
    nch = -(-head_dim // 64)
    rest = 2 * _WW_RING * _WW_UNIT + _WW_XBUF + _WW_BARS + 1024
    resident = nch * _WW_HALF + rest <= WGMMA_WIDE_SMEM_LIMIT
    n_vu = -(-nch // 2)
    return dict(nch=nch, resident=resident,
                n_cb=-(-n_vu // (WGMMA_WIDE_BLOCK_COLS // 128)),
                bytes=(nch * _WW_HALF if resident else 0) + rest)


def wide_splits(blocks: int, positions: int, n_sm: int) -> int:
    """How many parts the wide form splits each lane's context into
    (kernels 1 and 3), ``blocks`` its (tile, slab, KV head, lane) blocks
    over a table of ``positions``: one split when the blocks already fill
    the card; otherwise enough for about two blocks per SM, at most one
    per ``WIDE_SPLIT_POSITIONS`` positions and at most ``MAX_SPLITS``.  A
    function of shapes and the SM count only."""
    if blocks >= n_sm:
        return 1
    return max(1, min(2 * n_sm // blocks,
                      -(-positions // WIDE_SPLIT_POSITIONS), MAX_SPLITS))


def check_built(q_dtype, kv_dtype, head_dim: int) -> None:
    """Raise unless the kernels are built for this q dtype, page dtype
    and head dim (every q of ``Q_CODE`` over every page of ``KV_CODE``,
    every D from 1 up, all three kernels alike): a CUDA batcher refuses
    at construction what its kernels would refuse at their first
    launch."""
    if q_dtype not in Q_CODE or kv_dtype not in KV_CODE:
        raise TypeError(f"q {q_dtype} / pool {kv_dtype}: the kernels take "
                        "a float32, bfloat16 or float16 q over a float32, "
                        "bfloat16, float16, float8_e4m3fn or float8_e5m2 "
                        "pool")
    if not head_dim_built(head_dim):
        raise ValueError(f"head dim {head_dim} not built (want 1 to "
                         f"{MAX_ADDRESSABLE_HEAD_DIM}: the C launchers "
                         "take it as a 32-bit int)")


def body_form(body: str, q_dtype) -> str:
    """``"wgmma bf16"`` / ``"wgmma f16"`` and ``"wgmma-wide bf16"`` /
    ``"wgmma-wide f16"`` (the tensor cores' input type), ``"fma"`` or
    ``"fma-wide"``: the key of a wrapper's ``launches_by_form``."""
    if body not in ("wgmma", "wgmma-wide"):
        return body
    return f"{body} {'f16' if q_dtype == torch.float16 else 'bf16'}"


def ragged_splits(b: int, m: int, hq: int, hkv: int, mp: int,
                  page_size: int, n_sm: int, body: str = "wgmma",
                  head_dim: int = 0) -> int:
    """How many parts the ``"wgmma"`` body splits each lane's context into
    (the ``"fma-wide"`` body: :func:`wide_splits` over its blocks at
    ``head_dim``; the ``"wgmma-wide"`` body: enough for about one block
    per SM, its blocks being (64-row tile, column block, KV head, lane)
    and one fitting an SM at once; the ``"fma"`` body: one).

    A function of shapes and the SM count only, never of ``kv_lens`` or
    timing, so equal shapes give equal splits and bit-equal results.  One
    split when the (tile, KV head, lane) blocks already fill the card, as a
    256-row mixed round does; otherwise enough splits for about two blocks
    per SM (two fit at once), at most one per 64-key stage of the longest
    context (``mp * page_size``) and at most ``MAX_SPLITS``.  Past
    ``WGMMA_TWO_BLOCKS_WIDTH`` (D 144-256) one ``"wgmma"`` block fits an
    SM, so the aim is one block per SM: at decode of 8 lanes over 8 KV
    heads, 2 splits (128 blocks, one wave) instead of 4 (256 blocks, two
    waves)."""
    if body == "fma-wide":
        tiles = -(-m * (hq // hkv) // WIDE_ROWS)
        return wide_splits(tiles * wide_slabs(head_dim) * hkv * b,
                           mp * page_size, n_sm)
    stages = -(-mp * page_size // STAGE_KEYS)
    if body == "wgmma-wide":
        tiles = -(-m * (hq // hkv) // WGMMA_WIDE_ROWS)
        blocks = tiles * wgmma_wide_plan(head_dim)["n_cb"] * hkv * b
        if blocks >= n_sm:
            return 1
        return max(1, min(-(-n_sm // blocks), stages, MAX_SPLITS))
    if body != "wgmma":
        return 1
    tiles = -(-m * (hq // hkv) // TILE_ROWS)
    blocks = tiles * hkv * b
    if blocks >= n_sm:
        return 1
    per_sm = 2 if head_dim <= WGMMA_TWO_BLOCKS_WIDTH else 1
    return max(1, min(per_sm * n_sm // blocks, stages, MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pool_bytes(kv: torch.Tensor) -> torch.Tensor:
    """A page store as the tensor its gathers and scatters index: a
    ``uint8`` view of an fp8 store, e4m3 or e5m2 (torch has no fp8
    ``index_copy_`` or ``masked_fill`` on the CPU), else the store
    itself."""
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
    check_built(q.dtype, kv_pool.dtype, d)
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
                            body, d)
    out = torch.empty_like(q)
    # f32 partials of every split: O (b, m, hq, d), then (m, l) per row at
    # an even offset (one float of padding after an odd count of O: the
    # wide form's odd head dims).  Freed on return: the caching allocator
    # hands the block out again only to later work on this stream, which
    # runs after the merge.
    n_o = n_split * b * m * hq * d
    scratch = (torch.empty(n_o + n_o % 2 + n_split * b * m * hq * 2,
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
            Q_CODE[q.dtype], KV_CODE[kv_pool.dtype],
            _BODY_CODE[body], n_split,
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.tpulab_cuda_error_string(rc).decode()
        raise RuntimeError(f"ragged_paged_attention launch failed ({body} "
                           f"body, {n_split} splits): {msg}")
    ragged_paged_attention.launches += 1
    ragged_paged_attention.launches_by_body[body] += 1
    ragged_paged_attention.launches_by_form[body_form(body, q.dtype)] += 1
    geom = f"{body} x{n_split}"
    by_geom = ragged_paged_attention.launches_by_geom
    by_geom[geom] = by_geom.get(geom, 0) + 1
    by_dim = ragged_paged_attention.launches_by_head_dim
    by_dim[d] = by_dim.get(d, 0) + 1
    return out


FORMS = ("fma", "wgmma bf16", "wgmma f16", "fma-wide", "wgmma-wide bf16",
         "wgmma-wide f16")
ragged_paged_attention.launches = 0
ragged_paged_attention.launches_by_body = dict.fromkeys(_BODY_CODE, 0)
ragged_paged_attention.launches_by_form = dict.fromkeys(FORMS, 0)
ragged_paged_attention.launches_by_geom = {}
ragged_paged_attention.launches_by_head_dim = {}
