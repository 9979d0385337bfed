"""Megatron tensor parallelism over the mesh's ``model`` axis: the split of
the compute that tpulab leaves to XLA's partitioner.

:func:`~tpulab_torch.parallel.sharding.transformer_param_shardings` lays
the weights out (``wqkv`` / ``w1`` / ``w3`` / ``lm_head`` column-parallel,
``wo`` / ``w2`` row-parallel, ``embed`` on the vocab dim); a
:class:`TensorParallel` handed to ``transformer_apply(...,
tensor_parallel=)`` runs the trunk on this rank's local shards of those
weights, so no rank holds or multiplies a whole model-sharded matrix:

- :meth:`TensorParallel.enter` (Megatron's *f*) marks a replicated
  activation entering column-parallel products: the identity forward, its
  gradient summed over the axis;
- :meth:`TensorParallel.reduce` (*g*) sums the row-parallel partial
  products: an all-reduce forward, the identity backward;
- the fused ``wqkv`` columns are not head groups (tpulab shards the fused
  matrix on columns), so the projection's columns are all-gathered and
  each rank attends over the heads that cover its ``wo`` rows;
- :meth:`TensorParallel.embed` looks tokens up in this rank's vocab rows
  and sums over the axis; :meth:`TensorParallel.nll` is the cross entropy
  of vocab-sharded logits (max and normalizer over the axis).

Every collective runs on the axis's process group (NCCL on the card, gloo
under ``device="cpu"``).  A model-sharded dim must divide by the axis
size, so every rank's shard starts at ``rank * local size``
(:func:`check_divisible`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from tpulab_torch.parallel.mesh import axis_group, axis_index, axis_size


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the axis (each
    rank's column shard contributes a partial input gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """All-reduce forward (the row-parallel partial sums); the identity
    backward (the sum's gradient reaches every rank's partial)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dim in rank order; backward sums every
    rank's gradient of the whole and keeps this rank's columns."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[-1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(-1, ctx.rank * ctx.n, ctx.n), None, None, None


class TensorParallel:
    """This rank's place on the mesh axis ``axis`` and the Megatron
    operators over its process group."""

    def __init__(self, mesh, axis: str = "model"):
        self.group = axis_group(mesh, axis)
        self.size = axis_size(mesh, axis)
        self.rank = axis_index(mesh, axis)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self.group, self.size, self.rank)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor,
              dtype) -> torch.Tensor:
        """``embed[tokens].to(dtype)`` from this rank's vocab rows: the
        rows it holds, zeros elsewhere, summed over the axis (exact: one
        rank contributes each row)."""
        n = table.shape[0]
        local = tokens.long() - self.rank * n
        hit = (local >= 0) & (local < n)
        rows = table[local.clamp(0, max(n - 1, 0))]
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        return self.reduce(rows).to(dtype)

    def attention_rows(self, attention_fn, q, k, v,
                       n_rows: int) -> torch.Tensor:
        """The attention output's columns that meet this rank's ``n_rows``
        rows of ``wo``: attention over the heads covering them (a row
        shard need not be whole heads), flattened and cut to the rows.
        q / k / v are (B, T, H, D) with K/V already repeated to H."""
        b, t, _, d = q.shape
        lo = self.rank * n_rows
        h0, h1 = lo // d, -(-(lo + n_rows) // d)
        out = attention_fn(q[:, :, h0:h1], k[:, :, h0:h1],
                           v[:, :, h0:h1]).reshape(b, t, (h1 - h0) * d)
        return out[..., lo - h0 * d:lo - h0 * d + n_rows]

    def nll(self, logits: torch.Tensor, targets: torch.Tensor
            ) -> torch.Tensor:
        """Per-token ``-log_softmax(logits)[target]`` of logits whose last
        dim is this rank's vocab columns (f32)."""
        n = logits.shape[-1]
        peak = logits.detach().amax(dim=-1)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=self.group)
        norm = self.reduce(torch.exp(logits - peak[..., None]).sum(dim=-1))
        local = targets.long() - self.rank * n
        hit = (local >= 0) & (local < n)
        picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
        target = self.reduce(torch.where(hit, picked,
                                         torch.zeros_like(picked)))
        return torch.log(norm) + peak - target


def check_divisible(tree: Dict[str, Any], axis: str = "model") -> None:
    """Raise unless every dim that ``axis`` shards in ``tree`` (a tree of
    DTensors) divides by the axis size."""
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
            return
        if not isinstance(node, DTensor):
            return
        mesh = node.device_mesh
        i = mesh.mesh_dim_names.index(axis)
        p = node.placements[i]
        if isinstance(p, Shard) and node.shape[p.dim] % mesh.size(i):
            raise ValueError(
                f"{path}: dim {p.dim} of {tuple(node.shape)} does not divide "
                f"by {axis}={mesh.size(i)} (tensor parallelism needs even "
                "shards)")
    walk(tree, "")
