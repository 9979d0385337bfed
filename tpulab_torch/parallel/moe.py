"""Mixture-of-experts FFN + expert parallelism (the port of
``tpulab/parallel/moe.py``).

Experts partition over a mesh axis; each rank computes its local experts'
contribution for the whole token stream, and an ``all_reduce`` over the
axis combines them: exact MoE (no capacity truncation).  Router: top-k
softmax gating renormalized over the selected experts; ties go to the
lower expert index, as ``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpulab_torch.parallel.mesh import axis_group, axis_index
from tpulab_torch.parallel.sharding import _chunk, named_sharding, shard_tensor


def init_moe_params(d_model: int = 64, d_ff: int = 128, n_experts: int = 8,
                    seed: int = 0, device=None,
                    dtype=torch.float32) -> Dict[str, Any]:
    """Router (d, E), w1 (E, d, f), w2 (E, f, d), N(0, 0.05), drawn in
    that order from one ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``None`` = the CUDA card).  The draws differ from
    ``jax.random``'s: bring tpulab's over the weight bridge to compare."""
    from tpulab_torch.cuda.platform import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    s = 0.05

    def normal(*shape):
        return torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, s, generator=gen)

    return {"router": normal(d_model, n_experts),
            "w1": normal(n_experts, d_model, d_ff),
            "w2": normal(n_experts, d_ff, d_model)}


def _gates(params, x, top_k: int) -> torch.Tensor:
    """(N, D) tokens -> (N, E) f32 gate weights: softmax over exactly the
    top-k router logits (a stable sort keeps the lower index first among
    ties, so tied logits still activate exactly k experts, tpulab's)."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    n_experts = logits.shape[-1]
    if top_k >= n_experts:
        return torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(vals[:, :top_k], dim=-1)
    return torch.zeros_like(logits).scatter_(-1, idx[:, :top_k], weights)


def _experts(w1, w2, x, gates, compute_dtype) -> torch.Tensor:
    """The experts' outputs weighted by ``gates`` (N, E_local)."""
    h = torch.einsum("nd,edf->nef", x.to(compute_dtype),
                     w1.to(compute_dtype))
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("nef,efd->ned", h, w2.to(compute_dtype))
    return torch.einsum("ned,ne->nd", y, gates.to(compute_dtype))


def moe_ffn(params: Dict[str, Any], x: torch.Tensor, top_k: int = 2,
            compute_dtype=torch.float32) -> torch.Tensor:
    """Dense single-device MoE FFN reference ((N, D) -> (N, D))."""
    return _experts(params["w1"], params["w2"], x,
                    _gates(params, x, top_k), compute_dtype)


def make_expert_parallel_ffn(mesh, axis_name: str = "model", top_k: int = 2,
                             compute_dtype=torch.float32):
    """Expert-parallel MoE FFN: experts sharded on dim 0 over
    ``mesh[axis_name]``, outputs combined with an ``all_reduce``.  Exact
    against :func:`moe_ffn` up to the sum's order.

    Returns ``(ffn_fn, shard_params_fn)``: every rank shards the full
    params once with ``shard_params_fn`` (router replicated, ``w1`` /
    ``w2`` DTensors sharded on the expert dim), then calls
    ``ffn_fn(sharded_params, x)`` with the same tokens ``x`` (N, D); every
    rank gets the whole output."""
    sub = mesh[axis_name]
    expert = named_sharding(sub, axis_name)
    specs = {"router": named_sharding(sub), "w1": expert, "w2": expert}
    group = axis_group(mesh, axis_name)

    def shard_params(params):
        return {k: shard_tensor(params[k], sub, specs[k]) for k in specs}

    def ffn(sharded_params, x):
        n_experts = sharded_params["w1"].shape[0]
        lo, hi = _chunk(n_experts, sub.size(), axis_index(mesh, axis_name))
        # the router is replicated: GLOBAL top-k gates, local columns
        gates = _gates({"router": sharded_params["router"].to_local()}, x,
                       top_k)[:, lo:hi]
        out = _experts(sharded_params["w1"].to_local(),
                       sharded_params["w2"].to_local(), x, gates,
                       compute_dtype)
        dist.all_reduce(out, group=group)
        return out

    return ffn, shard_params
