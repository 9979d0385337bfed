"""Sharded training step, dp batch x tp parameters (the port of
``tpulab/parallel/training.py``).

tpulab jits one SGD step over a mesh and lets XLA partition it.  The port
runs the same step in every rank of the mesh:

- the parameters are DTensors laid out by
  :func:`~tpulab_torch.parallel.sharding.transformer_param_shardings`
  (a copy of the caller's tree, never an alias);
- ``apply_fn`` runs on the local shards as plain tensors, so an
  ``attention_fn`` that launches a CUDA kernel (the flash kernel, whose
  wrapper takes plain tensors) runs as it does on one card.  Over a
  ``model`` axis of more than one rank it gets
  ``tensor_parallel=TensorParallel(mesh)``
  (:mod:`~tpulab_torch.parallel.tensor_parallel`: Megatron's column- and
  row-parallel products, so a rank multiplies and differentiates only
  its own shards) and returns this rank's vocab columns, whose cross
  entropy is taken over the axis;
- the rank feeds its rows of the global batch
  (:func:`~tpulab_torch.parallel.multihost.local_data_slice`, uneven
  shards included), and its loss is its rows' NLL sum over the GLOBAL
  token count, so the all-reduce over ``data`` of the losses and of the
  gradients gives the global mean's;
- each rank applies SGD in place to its own shard of every parameter,
  rounding as tpulab's jitted ``(w - learning_rate * g).astype(w.dtype)``
  does (:func:`sgd_update_`).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from tpulab_torch.engine.model import tree_leaves
from tpulab_torch.parallel.mesh import axis_group, axis_size
from tpulab_torch.parallel.multihost import local_data_slice
from tpulab_torch.parallel.sharding import (map_tree, shard_tree,
                                            transformer_param_shardings)
from tpulab_torch.parallel.tensor_parallel import (TensorParallel,
                                                   check_divisible)


def _nll(apply_fn: Callable, params: Any, tokens, targets) -> torch.Tensor:
    """Per-token next-token NLL, log-softmax in f32."""
    logits = apply_fn(params, {"tokens": tokens})["logits"]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


def cross_entropy_loss(apply_fn: Callable, params: Any,
                       batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross entropy over the transformer's logits: the mean
    over every token of the batch."""
    return _nll(apply_fn, params, batch["tokens"], batch["targets"]).mean()


def sgd_update_(w: torch.Tensor, g: torch.Tensor,
                learning_rate: float) -> None:
    """``w <- (w - learning_rate * g).astype(w.dtype)`` in place, rounding
    as tpulab's jitted step does.  Under a 16-bit dtype JAX casts the
    Python ``learning_rate`` to it, rounds the product to it, then the
    difference (three roundings).  Under f32 XLA fuses the multiply and
    the subtraction into one FMA (one rounding), as ``add_`` with
    ``alpha`` computes it on the CPU (tests hold both bit for bit)."""
    if w.element_size() >= 4:
        w.add_(g.to(w.dtype), alpha=-learning_rate)
        return
    lr = torch.tensor(learning_rate, dtype=w.dtype, device=w.device)
    w.sub_(g.to(w.dtype) * lr)


def make_sharded_train_step(apply_fn: Callable, params: Any, mesh,
                            learning_rate: float = 1e-3):
    """Returns ``(step, sharded_params)``.

    ``step(params, batch) -> (params, loss)``: one SGD step on the
    sharded tree, updated in place; ``batch`` holds the GLOBAL
    ``tokens`` / ``targets`` (B, T) on every rank; ``loss`` is the global
    mean, a 0-d f32 tensor on the mesh's device, equal on every rank.
    ``params`` is a param tree or a
    :class:`~tpulab_torch.models.transformer.Transformer`; over a
    ``model`` axis of more than one rank ``apply_fn`` takes a
    ``tensor_parallel`` keyword (``transformer_apply`` does) and every
    model-sharded dim divides by the axis."""
    from tpulab_torch.models.transformer import _tree

    tree = _tree(params)
    placements = transformer_param_shardings(tree, mesh)
    sharded = shard_tree(tree, mesh, placements)
    data_group = axis_group(mesh, "data")     # the batch's rows shard here
    tp = None
    if axis_size(mesh, "model") > 1:
        check_divisible(sharded)
        tp = TensorParallel(mesh)
    run = apply_fn if tp is None else partial(apply_fn, tensor_parallel=tp)

    def step(p, batch):
        local = map_tree(
            lambda d: d.to_local().detach().requires_grad_(True), p)
        device = tree_leaves(local)[0].device
        tokens = torch.as_tensor(batch["tokens"])
        targets = torch.as_tensor(batch["targets"])
        lo, hi = local_data_slice(tokens.shape[0], mesh)
        rows = targets[lo:hi].to(device)
        if tp is None:
            nll = _nll(run, local, tokens[lo:hi].to(device), rows)
        else:
            logits = run(local, {"tokens": tokens[lo:hi].to(device)}
                         )["logits"]
            nll = tp.nll(logits.to(torch.float32), rows)
        total = nll.sum() / tokens.numel()
        total.backward()
        loss = total.detach().to(torch.float32)
        dist.all_reduce(loss, group=data_group)

        def update(d, w):
            if w.grad is None:      # unused by apply_fn: a zero gradient
                return
            dist.all_reduce(w.grad, group=data_group)
            sgd_update_(d.to_local(), w.grad, learning_rate)
            w.grad = None
        map_tree(update, p, local)
        return p, loss

    return step, sharded
