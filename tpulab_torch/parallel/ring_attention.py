"""Sequence-parallel attention: ring attention and Ulysses all-to-all (the
port of ``tpulab/parallel/ring_attention.py``).

tpulab writes both as ``shard_map`` bodies over a mesh axis.  The port's
are the same per-rank bodies with explicit collectives on the axis's
process group; each takes and returns this rank's sequence shard
(B, T/P, H, D) of global-layout q / k / v (rank i holds positions
[i T/P, (i+1) T/P)), so both are drop-in ``attention_fn`` s for
``transformer_apply`` run on each rank's token shard.  Each carries a
``sequence_offset(t_local)`` (the shard's first global position, i T/P),
which the transformer's trunk adds to its rope positions: rotary
embeddings see global positions, as under tpulab's ``shard_map``.

- :func:`ring_attention` — q stays, K/V blocks rotate one hop a step
  through ``batch_isend_irecv`` while an f32 online softmax accumulates;
  under ``causal`` a block wholly in this rank's future is skipped while
  the rotation goes on.  A rank never sends to itself: on an axis of one
  the rotation is the identity.
- :func:`ulysses_attention` — ``all_to_all_single`` from sequence to
  heads, full-sequence ``dense_attention`` on this rank's heads, and
  back.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tpulab_torch.parallel.mesh import axis_group, axis_index, axis_size

_NEG = -1e30


def _rotate(tensors, group, n: int, p: int):
    """Send each tensor to the next rank of the axis, receive the
    previous rank's."""
    nxt = dist.get_global_rank(group, (p + 1) % n)
    prv = dist.get_global_rank(group, (p - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _ring_attn_local(q, k, v, causal: bool, group=None):
    """Per-rank body: q fixed, k/v rotate; (B, T_local, H, D) in q's
    dtype.  ``group=None`` is the single-device form (one block)."""
    b, t_q, h, d = q.shape
    n = dist.get_world_size(group) if group is not None else 1
    p = dist.get_rank(group) if group is not None else 0
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32)
    q_pos = p * t_q + torch.arange(t_q, device=q.device)
    t_k = k.shape[1]
    m = torch.full((b, h, t_q), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t_q), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t_q, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k.contiguous(), v.contiguous()
    for s in range(n):
        src = (p - s) % n                 # owner of the block held now
        if not (causal and src > p):      # a future block adds nothing
            k_pos = src * t_k + torch.arange(t_k, device=q.device)
            scores = torch.einsum("bqhd,bkhd->bhqk", qf,
                                  k_blk.to(torch.float32)) * scale
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
                scores = torch.where(mask[None, None], scores,
                                     torch.full_like(scores, _NEG))
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            probs = torch.exp(scores - m_new[..., None])
            if causal:
                probs = probs * mask[None, None].to(torch.float32)
            l = l * alpha + probs.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", probs, v_blk.to(torch.float32))
            m = m_new
        if s < n - 1:
            k_blk, v_blk = _rotate((k_blk, v_blk), group, n, p)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return torch.einsum("bhqd->bqhd", out).to(q.dtype)


def ring_attention(mesh, axis_name: str = "model", causal: bool = True):
    """A sequence-parallel ``attention_fn`` over ``mesh[axis_name]``:
    ``attn(q, k, v)`` on this rank's (B, T/P, H, D) shards."""
    group = axis_group(mesh, axis_name)

    def attn(q, k, v):
        return _ring_attn_local(q, k, v, causal, group)
    attn.sequence_offset = _sequence_offset(mesh, axis_name)
    return attn


def _sequence_offset(mesh, axis_name: str):
    """``t_local -> first global position of this rank's shard``."""
    index = axis_index(mesh, axis_name)
    return lambda t_local: index * t_local


def _seq_to_heads(x, group, n: int):
    """(B, T/P, H, D) -> (B, T, H/P, D): head chunk j goes to rank j,
    sequence chunks arrive in rank order."""
    b, t, h, d = x.shape
    send = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)


def _heads_to_seq(x, group, n: int):
    """(B, T, H/P, D) -> (B, T/P, H, D), the inverse of
    :func:`_seq_to_heads`."""
    b, t, hl, d = x.shape
    send = x.reshape(b, n, t // n, hl, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hl, d)


def ulysses_attention(mesh, axis_name: str = "model", causal: bool = True):
    """Ulysses all-to-all sequence parallelism (heads % axis == 0):
    ``attn(q, k, v)`` on this rank's (B, T/P, H, D) shards."""
    from tpulab_torch.models.transformer import dense_attention

    group = axis_group(mesh, axis_name)
    n = axis_size(mesh, axis_name)

    def attn(q, k, v):
        if q.shape[2] % n:
            raise ValueError(f"heads {q.shape[2]} not divisible by axis "
                             f"{axis_name}={n}")
        qh, kh, vh = (_seq_to_heads(x, group, n) for x in (q, k, v))
        return _heads_to_seq(dense_attention(qh, kh, vh, causal=causal),
                             group, n)
    attn.sequence_offset = _sequence_offset(mesh, axis_name)
    return attn
