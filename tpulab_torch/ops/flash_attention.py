"""Flash attention: the CUDA kernel, its plain PyTorch version and the
blockwise backward.

The port of ``tpulab/ops/flash_attention.py`` (the Pallas kernel
``_flash_bhd``).  :func:`flash_attention` takes (B, T, H, D) q, k, v with
the same head count (GQA callers repeat K/V first, as the transformer
does) and returns (B, T, H, D) in q's dtype, causal or not.

CUDA tensors launch the hand-written Hopper kernel
(``csrc/flash_attention.cu``); CPU tensors take the plain version,
:func:`flash_attention_reference`.  A CUDA tensor never reaches the plain
version: a build or launch failure raises.  The kernel has two bodies,
chosen by :func:`flash_body` from dtype and head dim alone: ``"wgmma"``
(bf16 on the tensor cores, D 64 or 128) and ``"fma"`` (f32 FMAs on CUDA
cores: f32, and bf16 with D 256).  ``flash_attention.launches`` counts
kernel launches and ``flash_attention.launches_by_body`` splits them by
body (the plain version counts in neither).

``block_q`` / ``block_k`` keep tpulab's contract (they clamp to ``T`` and
must divide it, else ``ValueError``) but do not shape the kernel, which
picks its own tiles; ``block_k`` sets the backward's key blocks, as in
tpulab.  The backward is tpulab's two-pass blockwise recompute
(``_flash_bwd_bhd``) in torch ops: tpulab's is plain XLA, not Pallas.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

_FLOATS = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128, 256)
_WGMMA_HEAD_DIMS = (64, 128)
_BODY_CODE = {"fma": 0, "wgmma": 1}     # the C launcher's `body` argument
_NEG = -1e30


def flash_attention_reference(q, k, v, causal: bool = True):
    """Plain masked softmax in f32; (B, T, H, D) in q's dtype."""
    t, d = q.shape[1], q.shape[3]
    qf = q.float() * (1.0 / math.sqrt(d))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("want q, k, v of one (B, T, H, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not built (want one of "
                         f"{_HEAD_DIMS})")
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype} / k {k.dtype} / v {v.dtype}: the "
                        "kernel takes one dtype, float32 or bfloat16")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")


def flash_body(dtype, head_dim: int) -> str:
    """The kernel body a CUDA call runs: ``"wgmma"`` for bf16 with D 64 or
    128, else ``"fma"``.  A function of dtype and head dim only."""
    if dtype == torch.bfloat16 and head_dim in _WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def _rows_aligned(x) -> bool:
    """Last dim contiguous, every row 16-byte aligned and every stride
    positive (cp.async; TMA's tensor map takes strides that are non-zero
    multiples of 16 bytes)."""
    epc = 16 // x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s % epc == 0 for s in x.stride()[:3]))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, its C functions typed."""
    from tpulab_torch.ops._build import load

    lib = load("flash_attention")
    f = lib.tpulab_flash_attention
    f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                  + [ctypes.c_float, ctypes.c_void_p])
    f.restype = ctypes.c_int
    lib.tpulab_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpulab_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _forward(q, k, v, causal: bool):
    """One forward: the plain version for CPU tensors, the kernel for CUDA
    tensors (or raise)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    q, k, v = (x if _rows_aligned(x) else x.contiguous() for x in (q, k, v))
    lib = _lib()
    b, t, h, d = q.shape
    body = flash_body(q.dtype, d)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    # the launch goes to the calling thread's current device
    same = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tpulab_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, h, d, *strides, int(causal),
            int(q.dtype == torch.bfloat16), _BODY_CODE[body],
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.tpulab_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed ({body} body): "
                           f"{msg}")
    flash_attention.launches += 1
    flash_attention.launches_by_body[body] += 1
    return out


def _flash_bwd(q, k, v, out, dout, causal: bool, block_k: int):
    """tpulab's ``_flash_bwd_bhd`` on (B, T, H, D): pass 1 rebuilds each
    row's log-sum-exp blockwise, pass 2 accumulates dq/dk/dv blockwise —
    O(T * block_k) live memory, never the (T, T) score matrix."""
    t, d = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    outf, doutf = out.float(), dout.float()
    kf, vf = k.float(), v.float()
    qpos = torch.arange(t, device=q.device)[:, None]

    def scores(j):
        kj = kf[:, j * block_k:(j + 1) * block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kj)
        if causal:
            kpos = j * block_k + torch.arange(block_k, device=q.device)
            s = s.masked_fill(~(qpos >= kpos[None, :]), _NEG)
        return s

    nb = t // block_k
    m = torch.full(q.shape[:1] + (q.shape[2], t), _NEG, device=q.device)
    l = torch.zeros_like(m)
    for j in range(nb):                       # pass 1: log-sum-exp
        s = scores(j)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            s - m_new[..., None]).sum(dim=-1)
        m = m_new
    lse = m + torch.log(l.clamp_min(1e-30))                # (B, H, T)
    delta = (doutf * outf).sum(dim=-1).transpose(1, 2)     # (B, H, T)
    dq = torch.zeros_like(qf)
    dk, dv = [], []
    for j in range(nb):                       # pass 2: gradients
        s = scores(j)
        p = torch.exp(s - lse[..., None])
        if causal:
            kpos = j * block_k + torch.arange(block_k, device=q.device)
            p = p.masked_fill(~(qpos >= kpos[None, :]), 0.0)
        kj = kf[:, j * block_k:(j + 1) * block_k]
        vj = vf[:, j * block_k:(j + 1) * block_k]
        dv.append(torch.einsum("bhqk,bqhd->bkhd", p, doutf))
        dp = torch.einsum("bqhd,bkhd->bhqk", doutf, vj)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kj)
        dk.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))   # qf is scaled
    return ((dq * scale).to(q.dtype), torch.cat(dk, 1).to(k.dtype),
            torch.cat(dv, 1).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_k):
        out = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.block_k = causal, block_k
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, dout, ctx.causal, ctx.block_k)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Flash attention over (B, T, H, D) q/k/v (the layout of
    :func:`tpulab_torch.models.transformer.dense_attention`), in q's
    dtype.  Differentiable: the backward is the blockwise recompute."""
    t = q.shape[1]
    block_q = min(block_q, t)
    block_k = min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"seq len {t} must divide block sizes "
                         f"({block_q}, {block_k})")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, block_k)
    return _forward(q, k, v, causal)


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(_BODY_CODE, 0)


def make_flash_attention_fn(causal: bool = True, block_q: int = 128,
                            block_k: int = 128):
    """Drop-in ``attention_fn`` for ``transformer_apply``."""
    def attn(q, k, v):
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)
    return attn
