"""Decoder-only transformer — the port of ``tpulab/models/transformer.py``.

The math is plain functions on tensors over a parameter *tree* with
tpulab's keys (``embed``, ``final_norm``, ``layer{i}.{ln1,ln2,wqkv,wo,w1,
w2,w3}``, ``lm_head``); :class:`Transformer` is the ``nn.Module`` that owns
those tensors and hands the tree out through :attr:`Transformer.params`.

Dtypes follow JAX's result type op by op, because ``torch.matmul``
refuses mixed operands where ``jnp`` promotes silently:

- ``_rmsnorm`` returns ``x.dtype`` and then multiplies by the scale, so an
  f32 scale under bf16 compute yields f32;
- ``h @ qmat(w, compute)`` runs in the promoted type of ``h`` and the
  compute dtype;
- ``_lm_head`` works in f32.

A weight matrix is a float tensor or tpulab's weight-only int8 entry
``{"w_int8": (I, O) int8, "scale": (O,) f32}``
(:func:`tpulab_torch.models.quantization.quantize_transformer_params`);
:func:`qmat` dequantizes it in plain PyTorch before each product, as
tpulab leaves it to XLA.  Float32 products use full f32 on the card:
callers keep ``torch.backends.cuda.matmul.allow_tf32`` False (its
default).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tree = Dict[str, Any]


def init_transformer_params(vocab: int = 32000, d_model: int = 512,
                            n_heads: int = 8, n_layers: int = 6,
                            d_ff: int = 2048, seed: int = 0,
                            n_kv_heads: Optional[int] = None,
                            ffn: str = "gelu",
                            tie_embeddings: bool = True,
                            device=None, dtype=torch.float32) -> Tree:
    """Random weights with tpulab's shapes and scale (N(0, 0.02), unit
    norms), drawn layer by layer from one seeded ``torch.Generator`` on
    ``device`` (``None`` = the CUDA card).  The draws differ from
    ``jax.random``'s; to compare with tpulab, build the weights there and
    bring them over with :func:`tpulab_torch.models.convert.params_from_numpy`."""
    from tpulab_torch.cuda.platform import resolve_device

    dev = resolve_device(device)
    n_kv = n_kv_heads or n_heads
    if n_heads % n_kv:
        raise ValueError(f"n_heads {n_heads} not divisible by "
                         f"n_kv_heads {n_kv}")
    if ffn not in ("gelu", "swiglu"):
        raise ValueError(f"unknown ffn {ffn!r}")
    head_dim = d_model // n_heads
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(*shape):
        w = torch.empty(shape, dtype=dtype, device=dev)
        return w.normal_(0.0, 0.02, generator=gen)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    params: Tree = {"embed": normal(vocab, d_model),
                    "final_norm": {"scale": ones(d_model)}}
    for i in range(n_layers):
        layer = {
            "ln1": {"scale": ones(d_model)},
            "ln2": {"scale": ones(d_model)},
            "wqkv": normal(d_model, (n_heads + 2 * n_kv) * head_dim),
            "wo": normal(d_model, d_model),
            "w1": normal(d_model, d_ff),
            "w2": normal(d_ff, d_model),
        }
        if ffn == "swiglu":
            layer["w3"] = normal(d_model, d_ff)
        params[f"layer{i}"] = layer
    if not tie_embeddings:
        params["lm_head"] = normal(d_model, vocab)
    return params


def _weight(w):
    """A weight leaf as a module attribute: a frozen parameter, or a
    ``ParameterDict`` of frozen parameters for an int8 entry."""
    if isinstance(w, dict):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in w.items()})
    return nn.Parameter(w, requires_grad=False)


def _leaf(w):
    """The tree form of a :func:`_weight` attribute."""
    return dict(w.items()) if isinstance(w, nn.ParameterDict) else w


class _Block(nn.Module):
    def __init__(self, p: Tree):
        super().__init__()
        self.ln1 = nn.Parameter(p["ln1"]["scale"], requires_grad=False)
        self.ln2 = nn.Parameter(p["ln2"]["scale"], requires_grad=False)
        for name in ("wqkv", "wo", "w1", "w2", "w3"):
            if name in p:
                setattr(self, name, _weight(p[name]))

    def tree(self) -> Tree:
        out: Tree = {"ln1": {"scale": self.ln1}, "ln2": {"scale": self.ln2}}
        for name in ("wqkv", "wo", "w1", "w2", "w3"):
            if hasattr(self, name):
                out[name] = _leaf(getattr(self, name))
        return out


class Transformer(nn.Module):
    """Owner of a transformer's weights (no copies: the tree's tensors
    become the module's parameters).  ``params`` rebuilds the tpulab-keyed
    tree the functional code takes."""

    def __init__(self, params: Tree, n_heads: int,
                 n_kv_heads: Optional[int] = None,
                 rope_theta: Optional[float] = None):
        super().__init__()
        n_layers = sum(1 for k in params if k.startswith("layer"))
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.n_layers = n_layers
        self.rope_theta = rope_theta
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(params["final_norm"]["scale"],
                                       requires_grad=False)
        self.layers = nn.ModuleList(_Block(params[f"layer{i}"])
                                    for i in range(n_layers))
        self.lm_head = (_weight(params["lm_head"])
                        if "lm_head" in params else None)

    @property
    def params(self) -> Tree:
        tree: Tree = {"embed": self.embed,
                      "final_norm": {"scale": self.final_norm}}
        for i, blk in enumerate(self.layers):
            tree[f"layer{i}"] = blk.tree()
        if self.lm_head is not None:
            tree["lm_head"] = _leaf(self.lm_head)
        return tree

    def forward(self, tokens: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
        """tokens (B, T) -> logits (B, T, vocab) f32 (causal)."""
        return transformer_apply(
            self.params, {"tokens": tokens}, n_heads=self.n_heads,
            n_layers=self.n_layers, compute_dtype=compute_dtype,
            n_kv_heads=self.n_kv_heads,
            rope_theta=self.rope_theta)["logits"]


def split_qkv(qkv, b, t, n_heads, n_kv_heads, head_dim):
    """Split a fused QKV projection into (q (B,T,Hq,D), k/v (B,T,Hkv,D))."""
    q_dim = n_heads * head_dim
    kv_dim = n_kv_heads * head_dim
    q = qkv[..., :q_dim].reshape(b, t, n_heads, head_dim)
    k = qkv[..., q_dim:q_dim + kv_dim].reshape(b, t, n_kv_heads, head_dim)
    v = qkv[..., q_dim + kv_dim:].reshape(b, t, n_kv_heads, head_dim)
    return q, k, v


def repeat_kv(kv, n_heads):
    """Broadcast (…, Hkv, D) K/V heads up to the query head count (GQA)."""
    hkv = kv.shape[-2]
    if hkv == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // hkv, dim=-2)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding (HF Llama rotate-half convention).

    x (..., T, H, D); positions (..., T) int.  Computed in f32, returned
    in ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv     # (..., T, half)
    cos = torch.cat([torch.cos(ang)] * 2, -1)[..., None, :]
    sin = torch.cat([torch.sin(ang)] * 2, -1)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def qmat(w, compute_dtype):
    """Weight matrix ready for matmul: a float tensor cast to the compute
    dtype, or an int8 entry dequantized as ``w_int8.to(c) * scale.to(c)``
    (the int8 cast is exact, so this is one rounding of an exact product,
    bit-equal to tpulab's ``qmat``).  Eager PyTorch materializes the
    dequantized matrix for every product."""
    if isinstance(w, dict) and "w_int8" in w:
        return (w["w_int8"].to(compute_dtype)
                * w["scale"].to(compute_dtype))
    return w.to(compute_dtype)


def weight_shape(w):
    """Shape of a (possibly weight-only-quantized) weight matrix."""
    return (w["w_int8"] if isinstance(w, dict) and "w_int8" in w
            else w).shape


def _mm(a, b):
    """``a @ b`` in JAX's promoted result type of the two operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _mul(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) * b.to(dt)


def _rmsnorm(x, scale):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return _mul((xf * torch.rsqrt(var + 1e-6)).to(x.dtype), scale)


def _add(x, y):
    """``x + y`` in JAX's promoted type (the attention residual: an f32
    ``attn @ wo`` lifts a bf16 residual stream to f32, as in tpulab)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt) + y.to(dt)


def dense_attention(q, k, v, causal: bool = True):
    """Single-device attention (B, T, H, D), optionally causal."""
    b, t, h, d = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d)
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None], scores,
                             torch.tensor(-1e30, dtype=scores.dtype,
                                          device=q.device))
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def causal_attention(q, k, v):
    """Default single-device causal attention (B, T, H, D)."""
    return dense_attention(q, k, v, causal=True)


def _dense_ffn(p, h, compute_dtype):
    """SwiGLU when the layer has a ``w3`` gate (Llama family), else
    w1/gelu(tanh)/w2 — ``jax.nn.gelu``'s default is the tanh form."""
    if "w3" in p:
        gate = F.silu(_mm(h, qmat(p["w1"], compute_dtype)))
        return _mm(gate * _mm(h, qmat(p["w3"], compute_dtype)),
                   qmat(p["w2"], compute_dtype))
    return _mm(F.gelu(_mm(h, qmat(p["w1"], compute_dtype)),
                      approximate="tanh"), qmat(p["w2"], compute_dtype))


def _lm_head(params, x):
    """Final projection in f32: untied ``lm_head`` when present, else tied
    to the embedding.  Under bf16 weights this casts the whole vocab
    matrix to f32 per call, as tpulab does (cost recorded in PERF.md)."""
    xf = x.to(torch.float32)
    if "lm_head" in params:
        return xf @ qmat(params["lm_head"], torch.float32)
    return xf @ params["embed"].to(torch.float32).T


def _embed(params, tokens, compute_dtype):
    """``embed.astype(compute)[tokens]`` — rows cast after the gather
    (the same values, without casting the whole table)."""
    return params["embed"][tokens].to(compute_dtype)


def _forward(params, tokens, n_heads, n_layers, compute_dtype, attention_fn,
             collect_kv: bool = False, ffn_fn=_dense_ffn,
             n_kv_heads: Optional[int] = None,
             rope_theta: Optional[float] = None, last_index=None,
             tensor_parallel=None):
    """Shared trunk: (B, T) tokens -> (logits, kvs or None); ``collect_kv``
    returns the compact (B, T, Hkv, D) K/V per layer.  ``last_index``
    (int or 0-d tensor) runs the final norm and vocab head on that one
    position only: logits (B, vocab) instead of (B, T, vocab).

    Rope rotates at positions ``offset + [0, T)``, where ``offset`` is
    ``attention_fn.sequence_offset(T)`` for a sequence-parallel
    ``attention_fn`` (``tokens`` is then this rank's shard of the
    sequence) and 0 otherwise.  ``tensor_parallel`` (a
    :class:`~tpulab_torch.parallel.tensor_parallel.TensorParallel`) runs
    the trunk on this rank's Megatron shards of ``params``; the logits
    are then this rank's vocab columns."""
    tp = tensor_parallel
    if tp is not None and ffn_fn is not _dense_ffn:
        raise NotImplementedError("tensor parallelism splits the dense FFN "
                                  "only; shard experts with "
                                  "make_expert_parallel_ffn")
    n_kv = n_kv_heads or n_heads
    x = (_embed(params, tokens, compute_dtype) if tp is None
         else tp.embed(params["embed"], tokens, compute_dtype))
    b, t, d_model = x.shape
    head_dim = d_model // n_heads
    kvs = [] if collect_kv else None
    offset = getattr(attention_fn, "sequence_offset", None)
    positions = (torch.arange(t, device=x.device) + (offset(t) if offset
                                                      else 0)
                 if rope_theta else None)
    for i in range(n_layers):
        p = params[f"layer{i}"]
        h = _rmsnorm(x, p["ln1"]["scale"])
        if tp is not None:
            h = tp.enter(h)
        qkv = _mm(h, qmat(p["wqkv"], compute_dtype))
        if tp is not None:
            qkv = tp.gather_last(qkv)
        q, k, v = split_qkv(qkv, b, t, n_heads, n_kv, head_dim)
        if rope_theta:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        if collect_kv:
            kvs.append((k, v))
        k, v = repeat_kv(k, n_heads), repeat_kv(v, n_heads)
        if tp is None:
            attn = attention_fn(q, k, v).reshape(b, t, d_model)
            x = _add(x, _mm(attn, qmat(p["wo"], compute_dtype)))
        else:
            attn = tp.attention_rows(attention_fn, q, k, v,
                                     weight_shape(p["wo"])[0])
            x = _add(x, tp.reduce(_mm(attn, qmat(p["wo"], compute_dtype))))
        h = _rmsnorm(x, p["ln2"]["scale"])
        if tp is None:
            x = x + ffn_fn(p, h, compute_dtype).to(x.dtype)
        else:
            x = x + tp.reduce(ffn_fn(p, tp.enter(h), compute_dtype)
                              ).to(x.dtype)
    if last_index is not None:
        idx = torch.as_tensor(last_index, device=x.device).reshape(1)
        x = x.index_select(1, idx.long())[:, 0]
    x = _rmsnorm(x, params["final_norm"]["scale"])
    return _lm_head(params, x if tp is None else tp.enter(x)), kvs


def transformer_apply(params: Tree, inputs: Dict[str, torch.Tensor],
                      n_heads: int = 8, n_layers: int = 6,
                      compute_dtype=torch.bfloat16,
                      attention_fn: Callable = causal_attention,
                      n_kv_heads: Optional[int] = None,
                      rope_theta: Optional[float] = None,
                      tensor_parallel=None) -> Dict[str, torch.Tensor]:
    """tokens (B, T) int -> logits (B, T, vocab) f32 (this rank's vocab
    columns under ``tensor_parallel``: see :func:`_forward`)."""
    logits, _ = _forward(params, inputs["tokens"], n_heads, n_layers,
                         compute_dtype, attention_fn,
                         n_kv_heads=n_kv_heads, rope_theta=rope_theta,
                         tensor_parallel=tensor_parallel)
    return {"logits": logits}


def transformer_forward_collect_kv(params: Tree, tokens: torch.Tensor,
                                   n_heads: int = 8, n_layers: int = 6,
                                   compute_dtype=torch.bfloat16,
                                   attention_fn: Callable = causal_attention,
                                   n_kv_heads: Optional[int] = None,
                                   rope_theta: Optional[float] = None,
                                   last_index=None, tensor_parallel=None):
    """Causal forward that also returns each layer's K/V (B, T, Hkv, Dh).
    ``last_index`` keeps the logits of that one position: (B, vocab).
    Under ``tensor_parallel`` the K/V hold every head and the logits this
    rank's vocab columns (see :func:`_forward`)."""
    return _forward(params, tokens, n_heads, n_layers, compute_dtype,
                    attention_fn, collect_kv=True, n_kv_heads=n_kv_heads,
                    rope_theta=rope_theta, last_index=last_index,
                    tensor_parallel=tensor_parallel)


def _tree(params) -> Tree:
    """The tpulab-keyed tree of a :class:`Transformer` or of a tree."""
    return params.params if isinstance(params, Transformer) else params


def early_exit_draft(target_params, draft_layers: int) -> Tree:
    """Self-speculative draft: the target's first ``draft_layers`` layers
    plus its embed, final norm and vocab head ('early-exit' drafting).

    ``target_params`` is a :class:`Transformer` or a tree.  The returned
    tree SHARES the target's tensors (no copy, no extra device memory)
    and so its head geometry, which the paged speculative path requires:
    the draft's KV rides the target's pool through a second page table
    (``ContinuousBatcher(draft_params=..., draft_n_layers=...)``).  The
    dense :class:`~tpulab_torch.engine.speculative.SpeculativeGenerator`
    takes the same tree."""
    tree = _tree(target_params)
    p = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if "lm_head" in tree:
        p["lm_head"] = tree["lm_head"]
    for i in range(draft_layers):
        p[f"layer{i}"] = tree[f"layer{i}"]
    return p


# ---------------------------------------------------------------------------
# KV-cache decode (dense, one max_len cache per sequence)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_layers: int, n_heads: int,
                  head_dim: int, dtype=torch.bfloat16, device=None) -> Tree:
    """Zeroed per-layer K/V caches (B, T_max, H, Dh) on ``device`` (``None``
    = the CUDA card) — pass the KV head count (``n_kv_heads`` under GQA)."""
    from tpulab_torch.cuda.platform import resolve_device

    dev = resolve_device(device)
    shape = (batch, max_len, n_heads, head_dim)
    return {f"layer{i}": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                          "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for i in range(n_layers)}


def transformer_chunk_step(params, cache: Tree, tokens: torch.Tensor,
                           pos0: int, n_heads: int = 8, n_layers: int = 6,
                           compute_dtype=torch.bfloat16,
                           n_kv_heads: Optional[int] = None,
                           rope_theta: Optional[float] = None):
    """Multi-token decode: M new tokens (B, M) from position ``pos0`` (an
    int) against the KV cache in ONE forward.

    Chunk token m attends every cache position <= pos0 + m.  The chunk's
    K/V are written into ``cache`` IN PLACE (JAX returns a new cache).
    Returns ``(logits (B, M, vocab) f32, cache)``.  This is the chunked
    prefill AND the speculative verify primitive: entries written past an
    eventual acceptance point are harmless, because positions only
    advance and stale slots are overwritten before they are attended."""
    params = _tree(params)
    n_kv = n_kv_heads or n_heads
    pos0 = int(pos0)
    x = _embed(params, tokens.long(), compute_dtype)           # (B, M, D)
    b, m, d_model = x.shape
    head_dim = d_model // n_heads
    max_len = next(iter(cache.values()))["k"].shape[1]
    if pos0 < 0 or pos0 + m > max_len:
        raise ValueError(f"chunk [{pos0}, {pos0 + m}) outside the cache's "
                         f"{max_len} positions")
    chunk_pos = pos0 + torch.arange(m, device=x.device)
    # chunk token m sees cache position j iff j <= pos0 + m
    vis = (torch.arange(max_len, device=x.device)[None, :]
           <= chunk_pos[:, None])                               # (M, T)
    g = n_heads // n_kv
    for i in range(n_layers):
        p = params[f"layer{i}"]
        h = _rmsnorm(x, p["ln1"]["scale"])
        qkv = _mm(h, qmat(p["wqkv"], compute_dtype))
        q, k, v = split_qkv(qkv, b, m, n_heads, n_kv, head_dim)
        if rope_theta:
            q = apply_rope(q, chunk_pos, rope_theta)
            k = apply_rope(k, chunk_pos, rope_theta)
        ck, cv = cache[f"layer{i}"]["k"], cache[f"layer{i}"]["v"]
        ck[:, pos0:pos0 + m] = k.to(ck.dtype)
        cv[:, pos0:pos0 + m] = v.to(cv.dtype)
        qg = q.reshape(b, m, n_kv, g, head_dim)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              ck.float()) / math.sqrt(head_dim)
        scores = torch.where(vis[None, None, None], scores,
                             torch.tensor(-1e30, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(compute_dtype)
        attn = torch.einsum("bhgqk,bkhd->bqhgd", probs,
                            cv.to(compute_dtype)).reshape(b, m, d_model)
        x = _add(x, _mm(attn, qmat(p["wo"], compute_dtype)))
        h2 = _rmsnorm(x, p["ln2"]["scale"])
        x = x + _dense_ffn(p, h2, compute_dtype).to(x.dtype)
    x = _rmsnorm(x, params["final_norm"]["scale"])
    return _lm_head(params, x), cache


def transformer_decode_step(params, cache: Tree, tokens: torch.Tensor,
                            pos: int, n_heads: int = 8, n_layers: int = 6,
                            compute_dtype=torch.bfloat16,
                            n_kv_heads: Optional[int] = None,
                            rope_theta: Optional[float] = None):
    """One decode step: tokens (B,) at position ``pos``; the M=1 case of
    :func:`transformer_chunk_step`.  Returns ``(logits (B, vocab) f32,
    cache)``."""
    logits, cache = transformer_chunk_step(
        params, cache, tokens[:, None], pos, n_heads=n_heads,
        n_layers=n_layers, compute_dtype=compute_dtype,
        n_kv_heads=n_kv_heads, rope_theta=rope_theta)
    return logits[:, 0], cache


def make_generate_fn(params, n_heads: int, n_layers: int, max_len: int,
                     compute_dtype=torch.bfloat16,
                     n_kv_heads: Optional[int] = None,
                     rope_theta: Optional[float] = None):
    """Greedy generation: ``generate(prompt (B, T_p), steps) -> (B, steps)``
    int64 on the weights' device.

    As tpulab: the prompt is replayed through single-token decode steps
    to fill the cache, then ``steps - 1`` cached decode steps follow the
    first greedy token (PyTorch runs eagerly; nothing is compiled)."""
    params = _tree(params)
    n_kv = n_kv_heads or n_heads
    kw = dict(n_heads=n_heads, n_layers=n_layers,
              compute_dtype=compute_dtype, n_kv_heads=n_kv,
              rope_theta=rope_theta)

    @torch.inference_mode()
    def generate(prompt, steps: int) -> torch.Tensor:
        dev = params["embed"].device
        prompt = torch.as_tensor(prompt, device=dev).long()
        b, t_p = prompt.shape
        head_dim = params["embed"].shape[1] // n_heads
        cache = init_kv_cache(b, max_len, n_layers, n_kv, head_dim,
                              compute_dtype, dev)
        for i in range(t_p):
            logits, cache = transformer_decode_step(params, cache,
                                                    prompt[:, i], i, **kw)
        tok = logits.argmax(-1)
        out = [tok]
        for i in range(steps - 1):
            logits, cache = transformer_decode_step(params, cache, tok,
                                                    t_p + i, **kw)
            tok = logits.argmax(-1)
            out.append(tok)
        return torch.stack(out, 1)

    return generate


def make_transformer(vocab: int = 32000, d_model: int = 512,
                     n_heads: int = 8, n_layers: int = 6, d_ff: int = 2048,
                     seq_len: int = 1024, max_batch_size: int = 4,
                     compute_dtype=torch.bfloat16, seed: int = 0,
                     attention_fn: Callable = causal_attention,
                     n_kv_heads: Optional[int] = None, device=None):
    """A servable transformer :class:`~tpulab_torch.engine.model.Model`
    (binding ``tokens`` (seq_len,) int32 -> ``logits`` (seq_len, vocab)
    f32), weights drawn on ``device`` (``None`` = the CUDA card)."""
    from tpulab_torch.engine.model import IOSpec, Model

    params = init_transformer_params(vocab, d_model, n_heads, n_layers, d_ff,
                                     seed, n_kv_heads=n_kv_heads,
                                     device=device)
    return Model(
        name="transformer",
        apply_fn=partial(transformer_apply, n_heads=n_heads,
                         n_layers=n_layers, compute_dtype=compute_dtype,
                         attention_fn=attention_fn, n_kv_heads=n_kv_heads),
        params=params,
        inputs=[IOSpec("tokens", (seq_len,), np.int32)],
        outputs=[IOSpec("logits", (seq_len, vocab), np.float32)],
        max_batch_size=max_batch_size,
    )


def make_moe_transformer(vocab: int = 32000, d_model: int = 512,
                         n_heads: int = 8, n_layers: int = 6,
                         d_ff: int = 2048, n_experts: int = 8,
                         top_k: int = 2, seq_len: int = 1024,
                         max_batch_size: int = 4,
                         compute_dtype=torch.bfloat16, seed: int = 0,
                         attention_fn: Callable = causal_attention,
                         device=None, params: Optional[Tree] = None):
    """Transformer with MoE FFN blocks (tpulab's ``make_moe_transformer``):
    per layer ``ln1`` / ``ln2``, ``wqkv`` (d, 3d), ``wo`` and an expert
    bank ``moe`` (``router`` (d, E), ``w1`` (E, d, f), ``w2`` (E, f, d)),
    computed densely by :func:`tpulab_torch.parallel.moe.moe_ffn` in
    place of the dense FFN; the same params run expert-parallel through
    :func:`~tpulab_torch.parallel.moe.make_expert_parallel_ffn`.

    f32 weights drawn on ``device`` (``None`` = the CUDA card) from seeded
    ``torch.Generator`` s, or ``params`` as given (a tpulab tree through
    the weight bridge).  Not in the registry, as in tpulab."""
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.engine.model import IOSpec, Model
    from tpulab_torch.parallel.moe import init_moe_params, moe_ffn

    if params is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def normal(*shape):
            return torch.empty(shape, device=dev).normal_(0.0, 0.02,
                                                          generator=gen)

        params = {"embed": normal(vocab, d_model),
                  "final_norm": {"scale": torch.ones(d_model, device=dev)}}
        for i in range(n_layers):
            params[f"layer{i}"] = {
                "ln1": {"scale": torch.ones(d_model, device=dev)},
                "ln2": {"scale": torch.ones(d_model, device=dev)},
                "wqkv": normal(d_model, 3 * d_model),
                "wo": normal(d_model, d_model),
                "moe": init_moe_params(d_model, d_ff, n_experts,
                                       seed=seed + i + 1, device=dev),
            }

    def moe_block(lp, h, cdtype):
        b, t, dm = h.shape
        return moe_ffn(lp["moe"], h.reshape(b * t, dm), top_k=top_k,
                       compute_dtype=cdtype).reshape(b, t, dm)

    def apply_fn(p, inputs):
        logits, _ = _forward(p, inputs["tokens"], n_heads, n_layers,
                             compute_dtype, attention_fn, ffn_fn=moe_block)
        return {"logits": logits}

    return Model(
        name="moe_transformer",
        apply_fn=apply_fn,
        params=params,
        inputs=[IOSpec("tokens", (seq_len,), np.int32)],
        outputs=[IOSpec("logits", (seq_len, vocab), np.float32)],
        max_batch_size=max_batch_size,
    )
